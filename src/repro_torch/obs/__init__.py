"""repro_torch.obs — unified telemetry plane (stdlib-only).

Three pieces, threaded through the whole serving stack:

* :mod:`repro_torch.obs.metrics` — ``MetricsRegistry`` of typed counters /
  gauges / fixed-bucket mergeable histograms with Prometheus-style text
  exposition and JSON snapshots; existing stat blocks register scrape
  collectors so they become views over one registry.
* :mod:`repro_torch.obs.trace` — ``Tracer`` producing per-request span trees
  (queue_wait → admission → retrieval → prefill → decode → harvest)
  with an injectable clock, bounded seeded sampling, and Chrome
  trace-event export.  ``NULL_TRACER`` is the zero-overhead disabled
  path.
* :mod:`repro_torch.obs.attribution` — per-request stage breakdowns whose
  top-level stages sum to end-to-end latency, aggregated so SLO
  burn-rate reports can name the dominant stage.
"""
from repro_torch.obs.attribution import (KINDS, STAGES, TOP_LEVEL,
                                   RequestBreakdown, StageAttribution)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS_MS, Counter, Gauge,
                               Histogram, MetricsRegistry)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "KINDS", "STAGES", "TOP_LEVEL", "RequestBreakdown",
    "StageAttribution", "DEFAULT_BUCKETS_MS", "Counter", "Gauge",
    "Histogram", "MetricsRegistry", "NULL_TRACER", "NullTracer",
    "Span", "Tracer",
]
