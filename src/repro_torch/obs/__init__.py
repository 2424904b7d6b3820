"""repro_torch.obs — the port's telemetry and the analysis/action tier on
top of it.

Signal modules:

* :mod:`repro_torch.obs.trace` — structured spans with parent/child
  links; byte-stable JSONL and Chrome-trace exports; the same spans as
  ``torch.profiler`` ranges while the profiler records.
* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms in one process-global registry; Prometheus text exposition
  and a JSON snapshot, served over HTTP by :func:`start_http_server`
  (``launch/serve.py --metrics``).
* :mod:`repro_torch.obs.drift` — modeled-vs-observed residual ratios
  per (fingerprint, bucket, dtype), ranked by where memhier is most
  wrong; fed by the scheduler's cost model.

Analysis/action modules:

* :mod:`repro_torch.obs.critical` — per-request critical path and typed
  blame buckets (queue-wait / region-swap / coalesce /
  channel-contention / negotiate / pallas_build / compute),
  conservation-checked.
* :mod:`repro_torch.obs.tail` — tail-based sampling: keep every
  SLO-breaching, erroring or p99 tree even at a 1% baseline rate.
* :mod:`repro_torch.obs.slo` — per-tenant SLOs with multi-window burn
  rates and the admission shed/deprioritise hook ``RequestQueue``
  consults.

All are copies of the JAX package's modules and export byte-identical
text for the same events.
"""
from repro_torch.obs.critical import (Blame, attribute, blame_report,
                                      critical_path, export_jsonl as
                                      export_blame_jsonl, format_report,
                                      max_residual)
from repro_torch.obs.drift import DriftCell, DriftTracker, watch_programs
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry, REGISTRY,
                                     default_registry, start_http_server)
from repro_torch.obs.slo import Slo, SloMonitor, SloShedder
from repro_torch.obs.tail import TailSampler
from repro_torch.obs.trace import (NULL_SPAN, Span, Tracer, VirtualClock,
                                   get_tracer, set_tracer, span,
                                   using_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_BUCKETS", "default_registry", "start_http_server",
    "Span", "Tracer", "VirtualClock", "NULL_SPAN",
    "get_tracer", "set_tracer", "span", "using_tracer",
    "DriftCell", "DriftTracker", "watch_programs",
    "Blame", "attribute", "blame_report", "critical_path",
    "export_blame_jsonl", "format_report", "max_residual",
    "TailSampler", "Slo", "SloMonitor", "SloShedder",
]
