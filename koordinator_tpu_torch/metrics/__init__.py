"""Prometheus-style metrics (counterpart of ``koordinator_tpu/metrics``,
cut to the series the ported modules emit): the registry primitives and
the scheduler's, descheduler's, device observatory's and koordlet's
registries."""

from koordinator_tpu_torch.metrics.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MergedGatherer,
    Registry,
)
from koordinator_tpu_torch.metrics.components import (  # noqa: F401
    DESCHEDULER_METRICS,
    DEVICE_METRICS,
    KOORDLET_EXTERNAL_METRICS,
    KOORDLET_INTERNAL_METRICS,
    SCHEDULER_METRICS,
)
