"""Observability for the serving stack (DESIGN.md §8): query-lifecycle
span tracing with Perfetto-loadable Chrome trace-event export, and a
Prometheus-shaped metrics registry with per-template / per-tenant SLO
histograms. Both are opt-in and allocation-light; the serving hot path
is untouched when they are off."""
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS,
                                     DEFAULT_SIZE_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     NULL_REGISTRY, NullRegistry, REGISTRY)
from repro_torch.obs.trace import (Span, Tracer, load_chrome,
                                   spans_from_stats, validate_events)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "REGISTRY", "NULL_REGISTRY", "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_SIZE_BUCKETS", "Span", "Tracer", "load_chrome",
    "spans_from_stats", "validate_events",
]
