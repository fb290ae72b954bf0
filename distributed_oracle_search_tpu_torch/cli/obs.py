"""Fleet observability CLI (``dos-obs``).

Head-side tooling over the artifacts and endpoints the obs plane
produces (the merge/compare logic lives in :mod:`..obs.fleet`):

* ``dos-obs merge-metrics [-o fleet_metrics.json] SNAPSHOT...`` —
  merge per-worker ``obs_metrics.json`` snapshots (shipped over the
  NFS data plane by ``--metrics-dump`` / campaign artifact dirs) into
  one labeled fleet document: per-worker sections plus summed fleet
  counters/gauges/histograms. ``--label`` overrides the path-derived
  worker labels (repeatable, positional order).
* ``dos-obs merge-traces -o merged.json TRACE_OR_DIR...`` — merge a
  campaign head's ``--trace`` file with worker ``.trace`` span
  sidecars (directories are globbed for ``*.trace``) into ONE
  Perfetto-loadable timeline.
* ``dos-obs top --endpoints host:port[,host:port...]`` — poll each
  endpoint's ``/statusz`` and render the live fleet table (queue
  depths, open breakers, hedge rate, worker batches/failures);
  ``--watch N`` refreshes every N seconds until interrupted.
* ``dos-obs bench-diff [--dir .]`` — compare the newest
  ``BENCH_r*.json`` against the previous one with per-key tolerances
  (``--tolerance``, ``--key-tolerance key=frac``) and exit non-zero on
  regression — the bench trajectory as a CI gate instead of a log.
* ``dos-obs slo --endpoint host:port`` — fetch the head's ``/slo``
  burn-rate page and render each spec's fast/slow burn + alert state;
  exits non-zero while any spec is alerting (scriptable as a deploy
  gate).
* ``dos-obs record --dir TAPE`` — summarize a flight-recorder ring
  (segments, records, time span).
* ``dos-obs replay --dir TAPE [--trace DIR...]`` — reconstruct the
  incident timeline from the tape (events + ticks, optionally merged
  with Perfetto spans by trace id) in timestamp order.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..obs import fleet
from ..utils.log import get_logger, set_verbosity

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dos-obs", description=__doc__.splitlines()[0])
    p.add_argument("-v", "--verbose", action="count", default=0)
    sub = p.add_subparsers(dest="cmd", required=True)

    mm = sub.add_parser("merge-metrics",
                        help="merge per-worker obs_metrics.json "
                             "snapshots into fleet_metrics.json")
    mm.add_argument("snapshots", nargs="+", help="snapshot JSON paths")
    mm.add_argument("-o", "--output", default="fleet_metrics.json")
    mm.add_argument("--label", action="append", default=[],
                    help="worker label per positional snapshot "
                         "(default: derived from the path)")

    mt = sub.add_parser("merge-traces",
                        help="merge head trace + worker .trace "
                             "sidecars into one Perfetto timeline")
    mt.add_argument("traces", nargs="+",
                    help="trace files, sidecars, or dirs (globs "
                         "*.trace)")
    mt.add_argument("-o", "--output", required=True)

    tp = sub.add_parser("top", help="live fleet table from /statusz")
    tp.add_argument("--endpoints", required=True,
                    help="comma-separated host:port list")
    tp.add_argument("--watch", type=float, default=0.0,
                    help="refresh every N seconds (0 = once)")
    tp.add_argument("--timeout", type=float, default=3.0)

    bd = sub.add_parser("bench-diff",
                        help="gate the newest BENCH_r*.json against "
                             "the previous round")
    bd.add_argument("records", nargs="*",
                    help="explicit OLD NEW record paths (default: the "
                         "two newest in --dir)")
    bd.add_argument("--dir", default=".",
                    help="where BENCH_r*.json live")
    bd.add_argument("--tolerance", type=float,
                    default=fleet.DEFAULT_TOLERANCE,
                    help="allowed fractional slack per key")
    bd.add_argument("--key-tolerance", action="append", default=[],
                    metavar="KEY=FRAC",
                    help="per-key tolerance override (repeatable)")
    bd.add_argument("--waive", action="append", default=[],
                    metavar="KEY=ROUND",
                    help="record a per-key baseline waiver: accept "
                         "KEY's regression when the NEW record is "
                         "round ROUND (e.g. scale_build_rows_per_sec"
                         "=r05); written to BENCH_WAIVERS.json in "
                         "--dir so the acceptance is reviewed with "
                         "the diff (repeatable)")
    bd.add_argument("--waive-reason", default="",
                    help="why the waived regression is accepted "
                         "(recorded alongside --waive)")

    sl = sub.add_parser("slo", help="burn-rate page from the head's "
                                    "/slo endpoint")
    sl.add_argument("--endpoint", required=True, help="host:port")
    sl.add_argument("--watch", type=float, default=0.0,
                    help="refresh every N seconds (0 = once)")
    sl.add_argument("--timeout", type=float, default=3.0)

    rc = sub.add_parser("record", help="summarize a flight-recorder "
                                       "tape directory")
    rc.add_argument("--dir", required=True, help="tape directory")

    rp = sub.add_parser("replay", help="reconstruct an incident "
                                       "timeline from a tape")
    rp.add_argument("--dir", required=True, help="tape directory")
    rp.add_argument("--since", type=float, default=None,
                    help="drop records before this unix timestamp")
    rp.add_argument("--until", type=float, default=None,
                    help="drop records after this unix timestamp")
    rp.add_argument("--trace", action="append", default=[],
                    help="Perfetto trace file/dir to merge spans from "
                         "by trace id (repeatable)")
    rp.add_argument("--events-only", action="store_true",
                    help="hide telemetry ticks, show events only")
    return p


def _cmd_merge_metrics(args) -> int:
    inputs = fleet.load_snapshot_files(args.snapshots,
                                       labels=args.label)
    doc = fleet.merge_snapshots(inputs)
    from ..utils.atomicio import atomic_write_bytes
    atomic_write_bytes(args.output,
                       (json.dumps(doc, indent=1) + "\n").encode())
    print(f"merged {doc['n_workers']} snapshot(s) -> {args.output}")
    return 0


def _cmd_merge_traces(args) -> int:
    n = fleet.merge_traces(args.traces, args.output)
    print(f"merged {n} event(s) -> {args.output} "
          "(open at https://ui.perfetto.dev)")
    return 0


def _cmd_top(args) -> int:
    endpoints = [e.strip() for e in args.endpoints.split(",")
                 if e.strip()]
    try:
        while True:
            # Ctrl-C must exit cleanly from ANYWHERE in the refresh —
            # the polls themselves block up to timeout_s per
            # unreachable endpoint, not just the sleep
            statuses = {ep: fleet.fetch_statusz(ep,
                                                timeout_s=args.timeout)
                        for ep in endpoints}
            print(fleet.render_top(statuses))
            if args.watch <= 0:
                return 0
            time.sleep(args.watch)
            print()
    except KeyboardInterrupt:
        return 0


def _cmd_bench_diff(args) -> int:
    if args.records:
        if len(args.records) != 2:
            raise SystemExit("bench-diff takes exactly OLD NEW when "
                             "records are given explicitly")
        old_path, new_path = args.records
    else:
        records = fleet.find_bench_records(args.dir)
        if len(records) < 2:
            print(f"bench-diff: fewer than two BENCH_r*.json in "
                  f"{args.dir}; nothing to compare")
            return 0
        new_path = records[-1]
        # compare against the nearest PREVIOUS round that actually
        # carries numbers: an unparseable record (the r04 overflow
        # failure mode) must not mask a regression by matching nothing
        old_path = next(
            (p for p in reversed(records[:-1]) if fleet.bench_numbers(p)),
            records[-2])
    key_tol = {}
    for spec in args.key_tolerance:
        key, _, frac = spec.partition("=")
        try:
            key_tol[key] = float(frac)
        except ValueError:
            raise SystemExit(f"bad --key-tolerance {spec!r} "
                             "(want KEY=FRACTION)")
    # record any --waive KEY=ROUND pairs first, then gate with the full
    # recorded set: the waiver mechanism accepts a REVIEWED baseline
    # shift (the file lands in the repo diff) without deleting history
    old_nums = fleet.bench_numbers(old_path)
    new_nums = fleet.bench_numbers(new_path)
    new_round = fleet.bench_round(new_path)
    for spec in args.waive:
        key, _, rnd = spec.partition("=")
        if not key or not rnd:
            raise SystemExit(f"bad --waive {spec!r} (want KEY=ROUND, "
                             "e.g. scale_build_rows_per_sec=r05)")
        if rnd != new_round:
            # a waiver only fires when the NEWEST record is its round;
            # recording one that cannot apply would print 'recorded'
            # and then gate anyway — reject it up front
            raise SystemExit(
                f"--waive {spec!r} cannot apply: the newest record is "
                + (f"round {new_round!r}" if new_round else
                   f"{new_path!r} (not a canonical BENCH_rNN name, so "
                   "no waiver can match it)"))
        entry = {"reason": args.waive_reason}
        if key in old_nums:
            entry["old"] = old_nums[key]
        if key in new_nums:
            entry["new"] = new_nums[key]
        fleet.record_waiver(args.dir, key, rnd, entry)
        print(f"  recorded waiver {key}={rnd} in "
              f"{fleet.WAIVER_FILE}")
    out = fleet.compare_bench(old_path, new_path,
                              tolerance=args.tolerance,
                              key_tolerances=key_tol,
                              waivers=fleet.load_waivers(args.dir))
    print(f"bench-diff: {out['old']} -> {out['new']} "
          f"({out['checked']} shared keys)")
    for e in out["improved"]:
        print(f"  + {e['key']}: {e['old']:g} -> {e['new']:g} "
              f"(x{e['ratio']:.2f})")
    for e in out["waived"]:
        reason = e.get("waiver", {}).get("reason", "")
        print(f"  ~ WAIVED {e['key']}: {e['old']:g} -> {e['new']:g} "
              f"(x{e['ratio']:.2f}, recorded for "
              f"{e['waiver'].get('round', '?')}"
              + (f": {reason}" if reason else "") + ")")
    for e in out["regressions"]:
        print(f"  ! REGRESSION {e['key']}: {e['old']:g} -> "
              f"{e['new']:g} (x{e['ratio']:.2f}, "
              f"{e['direction']}-is-better, tol {e['tolerance']:.0%})")
    if out["regressions"]:
        return 1
    print("  no regressions")
    return 0


def _render_slo(payload: dict) -> tuple[str, bool]:
    """The ``/slo`` payload as a table; second value = any alert."""
    if "error" in payload and not any(
            isinstance(v, dict) for v in payload.values()):
        return f"slo: {payload['error']}", False
    hdr = (f"{'spec':24s} {'kind':12s} {'objective':>9s} "
           f"{'fast burn':>9s} {'slow burn':>9s}  state")
    lines = [hdr, "-" * len(hdr)]
    alerting = False
    for name, s in sorted(payload.items()):
        if not isinstance(s, dict):
            continue

        def _b(v):
            return f"{v:9.2f}" if isinstance(v, (int, float)) else (
                " " * 8 + "-")

        state = "ALERT" if s.get("alerting") else "ok"
        alerting = alerting or bool(s.get("alerting"))
        lines.append(
            f"{name:24s} {str(s.get('kind', '')):12s} "
            f"{s.get('objective', 0):9.4f} {_b(s.get('fast_burn'))} "
            f"{_b(s.get('slow_burn'))}  {state}")
    return "\n".join(lines), alerting


def _cmd_slo(args) -> int:
    try:
        while True:
            table, alerting = _render_slo(
                fleet.fetch_json(args.endpoint, "/slo",
                                 timeout_s=args.timeout))
            print(table)
            if args.watch <= 0:
                # scriptable: a deploy gate can `dos-obs slo && push`
                return 1 if alerting else 0
            time.sleep(args.watch)
            print()
    except KeyboardInterrupt:
        return 0


def _cmd_record(args) -> int:
    from ..obs import recorder as obs_recorder

    records = obs_recorder.replay(args.dir)
    segments = obs_recorder.segment_paths(args.dir)
    events = [r for r in records if r.get("rec") == "event"]
    ticks = [r for r in records if r.get("rec") == "tick"]
    print(f"tape {args.dir}: {len(segments)} segment(s), "
          f"{len(records)} record(s) ({len(events)} event(s), "
          f"{len(ticks)} tick(s))")
    if records:
        t0, t1 = records[0]["ts"], records[-1]["ts"]
        print(f"  span: {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(t0))}"
              f" .. {time.strftime('%H:%M:%S', time.localtime(t1))} "
              f"({t1 - t0:.1f}s)")
    kinds = {}
    for r in events:
        kinds[r.get("kind", "?")] = kinds.get(r.get("kind", "?"), 0) + 1
    for kind, n in sorted(kinds.items()):
        print(f"  {kind:20s} {n}")
    return 0


def _cmd_replay(args) -> int:
    from ..obs import recorder as obs_recorder

    records = obs_recorder.replay(args.dir, since=args.since,
                                  until=args.until)
    if args.events_only:
        records = [r for r in records if r.get("rec") != "tick"]
    print(obs_recorder.render_timeline(records,
                                       trace_paths=args.trace or None))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbosity(args.verbose)
    return {"merge-metrics": _cmd_merge_metrics,
            "merge-traces": _cmd_merge_traces,
            "top": _cmd_top,
            "bench-diff": _cmd_bench_diff,
            "slo": _cmd_slo,
            "record": _cmd_record,
            "replay": _cmd_replay}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
