"""repro_torch.obs — the port's telemetry: spans, metrics and drift.

* :mod:`repro_torch.obs.trace` — structured spans with parent/child
  links; byte-stable JSONL, Chrome-trace and OTLP exports.
* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms in one process-global registry; Prometheus text exposition
  and a JSON snapshot.

* :mod:`repro_torch.obs.drift` — modeled-vs-observed residual ratios
  per (fingerprint, bucket, dtype), ranked by where memhier is most
  wrong; fed by the scheduler's cost model.

All are copies of the JAX package's modules and export byte-identical
text for the same events. The ``/metrics`` HTTP endpoint, critical-path
blame, tail sampling and SLOs are not ported yet (the scheduler takes
the latter two by duck type).
"""
from repro_torch.obs.drift import DriftCell, DriftTracker, watch_programs
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
    "DriftCell", "DriftTracker", "watch_programs",
]
