"""The collector framework (counterpart of
``koordinator_tpu/koordlet/metricsadvisor``)."""

from koordinator_tpu_torch.koordlet.metricsadvisor.framework import (
    Collector,
    CollectorContext,
    MetricsAdvisor,
    PodMeta,
)

__all__ = ["Collector", "CollectorContext", "MetricsAdvisor", "PodMeta"]
