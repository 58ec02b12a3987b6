"""Observability of the port's serving stack (stdlib only):

- ``trace.py``  per-request trace spans: ``Tracer`` records submit ->
                queue -> gather -> dispatch -> scatter -> reply as cheap
                monotonic-clock pairs in a bounded ring;
- ``export.py`` metrics export: Prometheus text exposition, the JSONL
                ``EventLog``, and the ``MetricsServer`` stdlib HTTP
                endpoint (``--metrics-port`` on the online CLI).

The sampled telemetry time series lives with the counters in
``repro_torch.serving.telemetry`` (``Telemetry.history``).
"""

from repro_torch.obs.export import EventLog, MetricsServer, render_prometheus
from repro_torch.obs.trace import (FlushSpans, Span, Trace, Tracer,
                                   finish_all)

__all__ = [
    "EventLog",
    "FlushSpans",
    "MetricsServer",
    "Span",
    "Trace",
    "Tracer",
    "finish_all",
    "render_prometheus",
]
