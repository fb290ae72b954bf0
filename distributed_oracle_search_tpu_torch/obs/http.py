"""Live scrape endpoints: ``/metrics``, ``/healthz``, ``/statusz``.

PR 1 gave every process a metrics registry; until now the only way out
was dump-at-exit JSON — you could not ask a *running* deployment "what
is p99 right now, which breaker is open, which replica is absorbing
failover". This module is the answer: a stdlib-only
(``http.server.ThreadingHTTPServer``) scrape server any resident
process opts into with ``--obs-port N`` / ``DOS_OBS_PORT=N`` (``0`` =
OS-assigned ephemeral port, logged at startup; unset = off, exactly the
pre-PR behavior). Binds loopback unless ``DOS_OBS_HOST`` widens it —
the endpoints are unauthenticated and ``/statusz`` names FIFO paths
and topology, so exposure to a scraped network is an explicit operator
decision.

* ``GET /metrics`` — Prometheus text exposition 0.0.4: the cumulative
  registry (``obs.metrics.to_prometheus``, per-worker gauges folded
  into ``{worker="N"}`` labels) **plus** the live sliding-window
  quantile gauges with exemplar trace ids (``obs.quantiles``) and the
  per-compiled-program XLA cost gauges (``obs.device``);
* ``GET /healthz`` — liveness JSON with the supervisor's
  :class:`~..transport.wire.HealthStatus` semantics: HTTP 200 when the
  provider says ``ok``, 503 otherwise, so a k8s-style probe needs no
  JSON parsing;
* ``GET /statusz`` — one JSON object merging every registered status
  provider: breaker states, per-shard queue depths, the
  replica/failover map, hedge rates, build-ledger progress — whatever
  the hosting process wires in. A provider that raises reports its
  error under its own key instead of failing the whole page.

The server runs on a daemon thread named ``dos-obs-http`` and is joined
by :meth:`ObsServer.close` (the test suite's leak check holds every
``dos-*`` thread to that contract). Handlers are deliberately read-only
— scraping a production fleet must never mutate it.

A copy of the JAX package's ``obs/http.py``. ``dos-serve`` and
``dos-gateway`` pass their ``obs.slo.SLOEngine`` as ``slo_provider``
when ``DOS_SLO_SPECS`` names an objective, which serves ``/slo``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.env import env_cast, env_str
from ..utils.log import get_logger
from . import device as obs_device
from . import metrics as obs_metrics
from . import quantiles as obs_quantiles

log = get_logger(__name__)

M_SCRAPES = obs_metrics.counter(
    "obs_scrapes_total", "HTTP requests answered by the obs endpoints")


def resolve_obs_port(flag_value=None) -> tuple[int | None, str]:
    """``(port, source)`` the obs server should listen on: an explicit
    flag wins (source ``"flag"``), else ``DOS_OBS_PORT`` (source
    ``"env"``), else ``(None, "off")``. Negative values are off — the
    degrade-don't-crash policy of every ``DOS_*`` knob."""
    if flag_value is not None:
        return (None, "off") if flag_value < 0 else (int(flag_value),
                                                     "flag")
    port = env_cast("DOS_OBS_PORT", None, int)
    if port is None or port < 0:
        return None, "off"
    return int(port), "env"


class ObsServer:
    """One process's scrape server. ``health_fn() -> dict`` should
    return at least ``{"ok": bool}``; ``status_providers`` maps section
    name -> zero-arg callable returning a JSON-able object."""

    def __init__(self, port: int, health_fn=None,
                 status_providers: dict | None = None,
                 registry: obs_metrics.MetricsRegistry | None = None,
                 windows: obs_quantiles.QuantileWindows | None = None,
                 host: str | None = None, slo_provider=None):
        self.registry = registry or obs_metrics.REGISTRY
        self.windows = windows or obs_quantiles.WINDOWS
        self.health_fn = health_fn
        self.status_providers = dict(status_providers or {})
        #: zero-arg callable returning the ``/slo`` JSON payload (the
        #: SLO engine's fresh evaluation); absent = 404, pre-SLO shape
        self.slo_provider = slo_provider
        if host is None:
            # loopback by default: the endpoints are unauthenticated
            # and /statusz names FIFO paths and topology — widening to
            # a routable interface is an explicit operator decision
            # (DOS_OBS_HOST=0.0.0.0 for a scraped fleet)
            host = env_str("DOS_OBS_HOST", "127.0.0.1")
        self._httpd = ThreadingHTTPServer((host, int(port)),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="dos-obs-http")

    # --------------------------------------------------------- lifecycle
    def start(self) -> "ObsServer":
        self._thread.start()
        log.info("obs endpoints up on :%d (/metrics /healthz /statusz%s)",
                 self.port,
                 " /slo" if self.slo_provider is not None else "")
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def add_provider(self, name: str, fn) -> None:
        """Register/replace one ``/statusz`` section after start."""
        self.status_providers[name] = fn

    # ----------------------------------------------------------- payload
    def metrics_text(self) -> str:
        parts = [self.registry.to_prometheus(),
                 self.windows.to_prometheus(),
                 obs_device.to_prometheus()]
        return "".join(p for p in parts if p)

    def health(self) -> dict:
        if self.health_fn is None:
            return {"ok": True}
        try:
            return dict(self.health_fn())
        except Exception as e:  # noqa: BLE001 — a health-provider bug
            # must surface as unhealthy, never as a scrape crash
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def slo(self) -> dict:
        try:
            return dict(self.slo_provider())
        except Exception as e:  # noqa: BLE001 — a burn-eval bug must
            # not take down the page the operator is paged ON
            return {"error": f"{type(e).__name__}: {e}"}

    def statusz(self) -> dict:
        out = {}
        for name, fn in sorted(self.status_providers.items()):
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — one broken section
                # must not take down the page the operator is debugging
                # WITH
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # ----------------------------------------------------------- handler
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # quiet: obs, not access
                pass                             # logs

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                M_SCRAPES.inc()
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(
                            200, server.metrics_text().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/healthz":
                        h = server.health()
                        self._send(
                            200 if h.get("ok") else 503,
                            (json.dumps(h) + "\n").encode(),
                            "application/json")
                    elif path == "/statusz":
                        self._send(
                            200,
                            (json.dumps(server.statusz(), indent=1,
                                        default=str) + "\n").encode(),
                            "application/json")
                    elif (path == "/slo"
                          and server.slo_provider is not None):
                        self._send(
                            200,
                            (json.dumps(server.slo(), indent=1,
                                        default=str) + "\n").encode(),
                            "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except BrokenPipeError:
                    pass          # scraper went away mid-reply

        return Handler


def start_obs_server(port, health_fn=None, status_providers=None,
                     **kw) -> ObsServer | None:
    """Start an :class:`ObsServer` when ``port`` resolves to a port
    (see :func:`resolve_obs_port`); None otherwise. Callers own
    ``close()``.

    A bind failure on an ENV-derived port degrades to no-endpoints
    with a warning (the ``DOS_*`` knob policy — and the fleet case:
    ``DOS_OBS_PORT`` in a shared environment must not crash every
    process that inherits it onto one port). An explicit ``--obs-port``
    flag still raises: the operator asked for exactly that port."""
    resolved, source = resolve_obs_port(port)
    if resolved is None:
        return None
    try:
        srv = ObsServer(resolved, health_fn=health_fn,
                        status_providers=status_providers, **kw)
    except OSError as e:
        if source == "flag":
            raise
        log.warning("ignoring DOS_OBS_PORT=%d (cannot bind: %s); "
                    "obs endpoints disabled for this process",
                    resolved, e)
        return None
    return srv.start()
