"""Helpers of the PyTorch port's parity tests that run one case through
both packages: :class:`Pkg` names one package's modules, :func:`both`
runs a case per package and :func:`equal` asserts the two results are
equal. Imports both packages lazily by name."""

import importlib

NAMES = {"jax": "distributed_oracle_search_tpu",
         "torch": "distributed_oracle_search_tpu_torch"}


class Pkg:
    """One package's modules under the names the cases use; ``dev`` is
    the keyword the port's entry points need on the CPU (none for JAX)."""

    MODULES = {
        "fleet": "parallel.membership", "part": "parallel.partition",
        "cpd": "models.cpd", "server": "worker.server",
        "engine": "worker.engine", "wire": "transport.wire",
        "fifo": "transport.fifo", "rpc": "transport.rpc",
        "pq": "cli.process_query", "serving": "serving",
        "dispatch": "serving.dispatch", "cache": "serving.cache",
        "ingress": "serving.ingress", "traffic": "traffic",
        "segments": "traffic.segments", "stream": "traffic.stream",
        "epochs": "traffic.epochs", "families": "traffic.families",
        "scenarios": "traffic.scenarios", "faults": "testing.faults",
        "metrics": "obs.metrics", "config": "utils.config",
        "graph": "data.graph", "formats": "data.formats",
        "resilience": "transport.resilience",
        "integrity": "integrity", "fingerprint": "integrity.fingerprint",
        "scrub": "integrity.scrub", "audit": "integrity.audit",
        "control": "control", "policy": "control.policy",
        "signals": "control.signals", "slo": "obs.slo",
        "telemetry": "obs.telemetry", "timeseries": "obs.timeseries",
        "obsfleet": "obs.fleet", "recorder": "obs.recorder",
        "gateway": "gateway", "protocol": "gateway.protocol",
        "registry": "gateway.registry", "frames": "transport.frames",
        "request": "serving.request", "reference": "models.reference",
        "build": "worker.build", "obs_quantiles": "obs.quantiles",
        "analysis": "analysis", "dimacs": "data.dimacs",
        "obscli": "cli.obs", "supervisor": "worker.supervisor",
        "nativebin": "utils.nativebin", "make_cpds": "cli.make_cpds",
    }

    def __init__(self, name):
        self.name = name
        self.dev = {"device": "cpu"} if name == "torch" else {}

    def __getattr__(self, attr):
        mod = self.MODULES.get(attr)
        if mod is None:
            raise AttributeError(attr)
        m = importlib.import_module(f"{NAMES[self.name]}.{mod}")
        setattr(self, attr, m)
        return m

    def counter(self, name):
        # the port keeps the CPD's counts in models.cpd.COUNTERS (the
        # dumps mirror them into the registry), JAX in the registry
        counts = getattr(self.cpd, "COUNTERS", {})
        if name in counts:
            return counts[name]
        return self.metrics.REGISTRY.snapshot()["counters"].get(name, 0)

    def gauge(self, name):
        return self.metrics.REGISTRY.snapshot()["gauges"].get(name, 0)

    def fifo_server(self, conf, wid, fifo, **kw):
        return self.server.FifoServer(conf, wid, command_fifo=fifo,
                                      **self.dev, **kw)

    def controller(self, conf, dc, g):
        return self.fleet.MembershipController(conf, dc, graph=g,
                                               **self.dev)

    def dispatcher(self, conf, g, dc, **kw):
        return self.serving.EngineDispatcher(conf, graph=g, dc=dc,
                                             **self.dev, **kw)


PKGS = {name: Pkg(name) for name in NAMES}


def both(fn):
    """``fn(P)`` for each package: ``{"jax": ..., "torch": ...}``."""
    return {name: fn(P) for name, P in PKGS.items()}


def equal(fn):
    """Run ``fn`` through both packages, assert equal results, return
    the port's."""
    got = both(fn)
    assert got["torch"] == got["jax"]
    return got["torch"]


def outcome(fn):
    """``fn()``'s value, or ``("raise", type name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raise", type(e).__name__, str(e))
