"""Telemetry the ported serve path records into: the metrics registry
and the flight recorder (copies of the JAX package's, numpy/stdlib only)."""

from .flightrec import (  # noqa: F401
    EVENT_KINDS,
    FlightRecorder,
    contains_in_order,
    default_recorder,
    validate_dump,
)
from .registry import (  # noqa: F401
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    log_buckets,
)
