"""Prometheus-style text exposition over stdlib ``http.server``, the
reference's ``obs/prom.py`` with its metric names.

No external client library: the text format (v0.0.4) is line-oriented
and trivial to emit — ``# HELP`` / ``# TYPE`` comments, then
``name{label="value"} number`` samples.  :func:`render_serve_metrics`
turns one :class:`~repro_torch.serve.metrics.ServeMetrics` into exposition
text (counters, gauges, per-tier dispatch slices, and the per-tier /
per-bucket latency histograms as cumulative ``_bucket{le=...}`` series);
:class:`MetricsServer` serves any number of registered metrics objects
at ``GET /metrics`` from a daemon thread — opt-in via
``python -m repro_torch.launch.serve --svd --metrics-port``.
"""

from __future__ import annotations

import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["render_serve_metrics", "render_fleet_metrics", "MetricsServer",
           "escape_label"]

_PREFIX = "repro_serve"
_FLEET = "repro_fleet"


def escape_label(v) -> str:
    """Escape a label value per the exposition format."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _fmt(value: float) -> str:
    if isinstance(value, float):
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
    return repr(float(value)) if isinstance(value, float) else str(value)


def _sample(name: str, labels: dict, value) -> str:
    if labels:
        body = ",".join(f'{k}="{escape_label(v)}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def _render_hist(lines: list[str], name: str, labels: dict, hist) -> None:
    """Emit one histogram: cumulative buckets + sum + count."""
    cum = hist.cumulative()
    edges = hist.upper_edges()
    prev = -1
    for edge, c in zip(edges, cum):
        if int(c) == prev:
            continue                     # sparse: skip repeated cumulatives
        prev = int(c)
        lines.append(_sample(f"{name}_bucket",
                             {**labels, "le": f"{edge:.6g}"}, int(c)))
    lines.append(_sample(f"{name}_bucket", {**labels, "le": "+Inf"},
                         int(hist.count)))
    lines.append(_sample(f"{name}_sum", labels, float(hist.sum)))
    lines.append(_sample(f"{name}_count", labels, int(hist.count)))


def render_serve_metrics(metrics, *, engine: str = "svd") -> str:
    """Exposition text for one ServeMetrics instance."""
    labels = {"engine": engine}
    snap = metrics.snapshot()
    lines: list[str] = []

    counters = [name for name in metrics._COUNTERS]
    lines.append(f"# HELP {_PREFIX}_requests_total "
                 "Monotonic serve counters by event.")
    lines.append(f"# TYPE {_PREFIX}_requests_total counter")
    for name in counters:
        lines.append(_sample(f"{_PREFIX}_requests_total",
                             {**labels, "event": name}, int(snap[name])))

    lines.append(f"# HELP {_PREFIX}_queue_depth "
                 "Requests admitted but not yet dispatched.")
    lines.append(f"# TYPE {_PREFIX}_queue_depth gauge")
    lines.append(_sample(f"{_PREFIX}_queue_depth", labels,
                         int(snap["queue_depth"])))

    lines.append(f"# HELP {_PREFIX}_tier_slots_total "
                 "Per-tier dispatch slot accounting.")
    lines.append(f"# TYPE {_PREFIX}_tier_slots_total counter")
    for tier, row in sorted(snap.get("tiers", {}).items()):
        for field in ("batches", "served_slots", "padded_slots"):
            lines.append(_sample(
                f"{_PREFIX}_tier_slots_total",
                {**labels, "tier": tier, "kind": field}, int(row[field])))

    hists = metrics.histograms()
    lines.append(f"# HELP {_PREFIX}_latency_seconds "
                 "Client-view request latency by execution tier.")
    lines.append(f"# TYPE {_PREFIX}_latency_seconds histogram")
    for tier, h in sorted(hists["tiers"].items()):
        _render_hist(lines, f"{_PREFIX}_latency_seconds",
                     {**labels, "tier": tier}, h)

    lines.append(f"# HELP {_PREFIX}_bucket_latency_seconds "
                 "Client-view request latency by bucket key.")
    lines.append(f"# TYPE {_PREFIX}_bucket_latency_seconds histogram")
    for key, h in sorted(hists["buckets"].items()):
        _render_hist(lines, f"{_PREFIX}_bucket_latency_seconds",
                     {**labels, "bucket": key}, h)

    lines.append(f"# HELP {_PREFIX}_queue_age_seconds "
                 "Age of requests at dispatch time (admission to launch).")
    lines.append(f"# TYPE {_PREFIX}_queue_age_seconds histogram")
    _render_hist(lines, f"{_PREFIX}_queue_age_seconds", labels,
                 hists["queue_age"])

    health = metrics.health()
    status_code = {"ok": 0, "degraded": 1, "failing": 2}.get(
        health["status"], 2)
    lines.append(f"# HELP {_PREFIX}_health_status "
                 "0=ok 1=degraded 2=failing.")
    lines.append(f"# TYPE {_PREFIX}_health_status gauge")
    lines.append(_sample(f"{_PREFIX}_health_status", labels, status_code))
    return "\n".join(lines) + "\n"


def render_fleet_metrics(fleet: dict) -> str:
    """Exposition text for a fleet view (a router's ``fleet()``): host
    liveness, per-host request attribution, and the per-host + merged
    client-view latency histograms.  Takes the plain
    dict — not the router — so a snapshot written to disk (the CI
    artifact) renders identically to a live scrape."""
    from repro_torch.obs.hist import StreamingHistogram

    lines: list[str] = []
    hosts = fleet.get("hosts", {})
    lines.append(f"# HELP {_FLEET}_hosts_alive Worker hosts currently alive.")
    lines.append(f"# TYPE {_FLEET}_hosts_alive gauge")
    lines.append(_sample(f"{_FLEET}_hosts_alive", {},
                         len(fleet.get("alive_hosts", []))))
    lines.append(f"# HELP {_FLEET}_host_up Per-host liveness (1=alive).")
    lines.append(f"# TYPE {_FLEET}_host_up gauge")
    for hid, row in sorted(hosts.items()):
        lines.append(_sample(f"{_FLEET}_host_up", {"host": hid},
                             int(bool(row.get("alive")))))
    lines.append(f"# HELP {_FLEET}_host_requests_total "
                 "Per-host dispatch/completion/requeue attribution.")
    lines.append(f"# TYPE {_FLEET}_host_requests_total counter")
    for hid, row in sorted(fleet.get("router", {}).get("hosts", {}).items()):
        for event, v in sorted(row.items()):
            lines.append(_sample(f"{_FLEET}_host_requests_total",
                                 {"host": hid, "event": event}, int(v)))
    lines.append(f"# HELP {_FLEET}_router_requests_total "
                 "Fleet-level client-view serve counters.")
    lines.append(f"# TYPE {_FLEET}_router_requests_total counter")
    router = fleet.get("router", {})
    for event in ("submitted", "completed", "failed", "timed_out",
                  "rejected", "retried", "quarantined", "bucket_hits"):
        if event in router:
            lines.append(_sample(f"{_FLEET}_router_requests_total",
                                 {"event": event}, int(router[event])))
    lat = fleet.get("latency", {})
    lines.append(f"# HELP {_FLEET}_latency_seconds "
                 "Client-view latency by host, plus the cross-host merge.")
    lines.append(f"# TYPE {_FLEET}_latency_seconds histogram")
    for hid, payload in sorted(lat.get("per_host", {}).items()):
        _render_hist(lines, f"{_FLEET}_latency_seconds", {"host": hid},
                     StreamingHistogram.from_dict(payload))
    if lat.get("merged"):
        _render_hist(lines, f"{_FLEET}_latency_seconds",
                     {"host": "_merged"},
                     StreamingHistogram.from_dict(lat["merged"]))
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Tiny /metrics endpoint on stdlib ``ThreadingHTTPServer``.

    ``port=0`` binds an ephemeral port (read back via ``.port`` — used by
    tests and the CI smoke, which scrape in-process).  ``register`` any
    number of (engine_name, ServeMetrics) pairs; every scrape re-renders
    from live metrics.  The server thread is a daemon: it never blocks
    interpreter exit, but call :meth:`stop` for deterministic shutdown.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1") -> None:
        self._registry: dict[str, object] = {}
        self._providers: dict[str, object] = {}
        self._reg_lock = threading.Lock()
        registry, providers = self._registry, self._providers
        reg_lock = self._reg_lock

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                with reg_lock:
                    items = list(registry.items())
                    provs = list(providers.items())
                body = "".join(render_serve_metrics(m, engine=name)
                               for name, m in items)
                for name, fn in provs:
                    try:
                        body += fn()
                    except Exception as exc:     # noqa: BLE001 — a broken
                        body += (f"# provider {name} failed: "
                                 f"{escape_label(exc)}\n")  # provider must
                if not items and not provs:      # not kill the scrape
                    body = "# no metrics registered\n"
                data = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a) -> None:   # keep scrapes quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-metrics",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def register(self, name: str, metrics) -> None:
        with self._reg_lock:
            self._registry[name] = metrics

    def register_provider(self, name: str, fn) -> None:
        """Register a callable returning ready-made exposition text —
        how the router's fleet view joins a scrape
        (``server.register_provider("fleet", lambda:
        render_fleet_metrics(router.fleet()))``).  Called per scrape; a
        raising provider degrades to a comment line."""
        with self._reg_lock:
            self._providers[name] = fn

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
