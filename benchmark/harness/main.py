"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. The run

1. refuses to start (exit 2, no result) without as many CUDA devices as
   the cell asks for;
2. makes the cell's inputs from ``--seed`` and builds the system under
   test through the driver its traffic mix names
   (``benchmark/drivers/<driver>.py``, :mod:`harness.driver`), warming
   up the window's shapes: all of it is ``setup_s``, from process start
   to the window's first call;
3. calls the driver until ``--seconds`` have passed; the window ends at
   that call's end, and the driver gives its end-to-end numbers, each
   the window's work over the window's time. With ``--trace 1`` the
   window runs under ``torch.profiler`` and the cell's per-layer metrics
   are read from the trace and the program's counters
   (:mod:`harness.trace`, ``benchmark/metrics/<name>.py``);
4. reads the peak device memory, frees the program's state, and
   compares a sample of the window's outputs, drawn from the seed, with
   the plain reference (the driver's ``check``);
5. exits 3 with no result if ``jax``, ``jaxlib``, ``flax`` or the JAX
   package is in ``sys.modules``;
6. prints the compared numbers and their limits last on stderr, and the
   result as the last line of stdout, the same numbers under
   ``checks`` last in it.

``--control int16`` puts the reference, at int16 precision, in the
program's place for the comparison (the control of ``correct``); the
benchmark's own runs never pass it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: top-level module names that must not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_oracle_search_tpu")

def process_start() -> float:
    """``time.time()`` of this process's start (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (default: the loaded modules)
    that are one of :data:`FORBIDDEN`, each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def read_counters(counters: dict) -> dict:
    """``{key: value}`` of the program's ``counters`` (``{key: (module,
    function, attribute)}``, the module under the port's package)."""
    import importlib

    out = {}
    for key, (mod, fn, attr) in counters.items():
        m = importlib.import_module(
            f"distributed_oracle_search_tpu_torch.{mod}")
        out[key] = getattr(getattr(m, fn), attr)
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("int16",), default=None)
    return ap.parse_args(argv)


def main(argv=None, *, root: str | None = None, device=None,
         t_start: float | None = None) -> int:
    """Run one cell; returns the exit code. ``device``: None takes the
    card (and checks for it); tests pass ``"cpu"``."""
    t_start = process_start() if t_start is None else t_start
    args = parse(argv)
    t_imports = time.time()
    import numpy as np
    import torch
    t_imports = time.time() - t_imports
    from . import spec, trace
    from .driver import subseed

    root = root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sp = spec.Spec(root)
    cell = sp.cell(args.workload)

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    on_card = torch.device(device).type == "cuda"
    t_context = time.time()
    if on_card:
        torch.zeros(1, device=device)
    pre_split = {"start": t_context - t_start - t_imports,
                 "torch import": t_imports,
                 "CUDA context": time.time() - t_context}
    config = sp.config(cell["config"])
    traffic = sp.traffic(cell["traffic"])
    drives = sp.driver(traffic["driver"])
    driver = drives.Driver(config, traffic, args.seed, device)
    driver.setup(trace=bool(args.trace))
    readers = ({m["name"]: sp.reader(m["name"])
                for m in sp.per_layer(cell["name"])} if args.trace else {})
    counted = {k: v for r in readers.values()
               for k, v in getattr(r, "COUNTERS", {}).items()}
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = read_counters(counted)
    from torch.profiler import record_function

    setup_s = time.time() - t_start
    with trace.profiled(bool(args.trace)) as prof:
        t0 = t_call = time.perf_counter()
        calls = []
        while True:
            with record_function("bench.call"):
                driver.call()
            now = time.perf_counter()
            calls.append(now - t_call)
            t_call = now
            if now - t0 >= args.seconds:
                break
        window_s = now - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    counters = {k: v - before[k] for k, v in read_counters(counted).items()}
    breakdown = None
    metrics = {}
    if args.trace:
        red = trace.reduce(prof)
        prof = None
        run = {"cell": cell["name"], "window_s": red["window_s"],
               "busy_s": red["busy_s"], "kernels": red["kernels"],
               "counters": counters, "work": dict(driver.work),
               "shapes": driver.shapes()}
        for m in sp.per_layer(cell["name"]):
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}
        dev_extra = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
    else:
        values = {"setup_s": setup_s, **driver.end_to_end(window_s)}
        for m in sp.end_to_end(cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        dev_extra = {}
    attempted, failed = driver.attempted()
    rng = np.random.default_rng(subseed(args.seed, "check"))
    out = driver.outputs(rng)
    driver.close()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    compared, what = drives.check(driver, out,
                                  control=args.control is not None)
    t_ref = time.perf_counter() - t_ref
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    result = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1 if on_card else 0,
                   "memory_peak_bytes": peak, **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    split = ", ".join(f"{k} {v:.3f} s" for k, v in
                      {**pre_split, **driver.split}.items())
    print(f"{cell['name']} seed {args.seed}: setup {setup_s:.3f} s "
          f"({split}; the rest the program's imports); "
          f"{len(calls)} calls in {window_s:.3f} s (min "
          f"{min(calls):.3f}, median {sorted(calls)[len(calls) // 2]:.3f}, "
          f"max {max(calls):.3f} s); {driver.note()}", file=sys.stderr)
    print(f"{cell['name']} seed {args.seed}: {what} compared "
          f"with the plain reference in {t_ref:.3f} s; the run took "
          f"{time.time() - t_start:.3f} s"
          + (f" (control: {args.control} in the program's place)"
             if args.control else ""), file=sys.stderr)
    for name, c in compared.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
