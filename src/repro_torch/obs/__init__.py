"""Plane-wide observability: one clock, one metric registry, one tracer.

Public surface::

    from repro_torch.obs import (
        Clock, FakeClock,               # the plane's single time source
        Telemetry, get_telemetry,       # process-wide bundle
        set_telemetry, reset_telemetry, use_telemetry,
        MetricRegistry, Counter, Gauge, Histogram,
        Tracer, Span, fence,
    )
"""

from repro_torch.obs.telemetry import (
    DEFAULT_BUCKETS_S,
    Clock,
    Counter,
    FakeClock,
    Gauge,
    Histogram,
    MetricCardinalityError,
    MetricRegistry,
    Telemetry,
    get_telemetry,
    reset_telemetry,
    set_telemetry,
    use_telemetry,
)
from repro_torch.obs.tracing import Span, Tracer, fence

__all__ = [
    "DEFAULT_BUCKETS_S",
    "Clock",
    "Counter",
    "FakeClock",
    "Gauge",
    "Histogram",
    "MetricCardinalityError",
    "MetricRegistry",
    "Telemetry",
    "get_telemetry",
    "reset_telemetry",
    "set_telemetry",
    "use_telemetry",
    "Span",
    "Tracer",
    "fence",
]
