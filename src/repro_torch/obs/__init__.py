"""repro_torch.obs — the port's telemetry: spans and metrics.

* :mod:`repro_torch.obs.trace` — structured spans with parent/child
  links; byte-stable JSONL, Chrome-trace and OTLP exports.
* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms in one process-global registry; Prometheus text exposition
  and a JSON snapshot.

Both are copies of the JAX package's modules and export byte-identical
text for the same events. The ``/metrics`` HTTP endpoint, drift
tracking, critical-path blame, tail sampling and SLOs come with the
serving and scheduler ports.
"""
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry, REGISTRY)
from repro_torch.obs.trace import (NULL_SPAN, Span, Tracer, VirtualClock,
                                   get_tracer, set_tracer, span,
                                   using_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_BUCKETS",
    "Span", "Tracer", "VirtualClock", "NULL_SPAN",
    "get_tracer", "set_tracer", "span", "using_tracer",
]
