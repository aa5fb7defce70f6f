"""repro_torch.obs — the pipeline's observability, after the reference's
``obs/`` package.

Three pieces, importable from this package root:

* :class:`Tracer` / :class:`Span` — thread-safe structured span tracing,
  fenced by ``torch.cuda.synchronize`` on the tensors a span was handed,
  with the first dispatch's kernel builds as ``build`` spans
  (``trace.py``).  Ambient-tracer helpers: :func:`current`,
  :func:`activated`, :func:`install`, :func:`span`,
  :func:`traced_jit_call`.
* :class:`StreamingHistogram` — mergeable fixed-log-bucket latency
  histograms with bounded memory (``hist.py``).
* :class:`MetricsServer` / :func:`render_serve_metrics` — Prometheus
  text exposition over stdlib http.server (``prom.py``); JSONL span
  export and round trip in ``export.py``.
"""

from repro_torch.obs.export import JsonlExporter, SpanRecord, load_jsonl
from repro_torch.obs.hist import StreamingHistogram
from repro_torch.obs.prom import (MetricsServer, render_fleet_metrics,
                                  render_serve_metrics)
from repro_torch.obs.trace import (Span, Tracer, activated, current, install,
                                   span, traced_jit_call)

__all__ = [
    "JsonlExporter",
    "SpanRecord",
    "load_jsonl",
    "StreamingHistogram",
    "MetricsServer",
    "render_fleet_metrics",
    "render_serve_metrics",
    "Span",
    "Tracer",
    "activated",
    "current",
    "install",
    "span",
    "traced_jit_call",
]
