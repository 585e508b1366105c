"""The node agent's time-series store (counterpart of
``koordinator_tpu/koordlet/metriccache``)."""

from koordinator_tpu_torch.koordlet.metriccache.metric_cache import (
    AggregationType,
    MetricCache,
    MetricKind,
)

__all__ = ["AggregationType", "MetricCache", "MetricKind"]
