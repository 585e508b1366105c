"""LoadAwareScheduling for the plugin chain (counterpart of
``koordinator_tpu/scheduler/plugins/loadaware.py``).

The host twin of ``ops/loadaware.py``; the estimation corrections (and,
in the aggregated mode, the percentile bases) come from the same
lowering the batched path uses (``lowering.node_view``).
"""

from __future__ import annotations

from koordinator_tpu_torch.apis.extension import PriorityClass
from koordinator_tpu_torch.apis.types import resources_to_vector
from koordinator_tpu_torch.oracle.scheduler import (
    loadaware_filter_node,
    loadaware_score_node,
)
from koordinator_tpu_torch.scheduler.framework import (
    CycleState,
    Plugin,
    Status,
)
from koordinator_tpu_torch.scheduler.plugins.lowering import node_view
from koordinator_tpu_torch.state.cluster import (
    DEFAULT_ESTIMATED_SCALING_FACTORS,
    DEFAULT_RESOURCE_WEIGHTS,
    DEFAULT_USAGE_THRESHOLDS,
    estimate_pod_used,
)


class LoadAwareScheduling(Plugin):
    name = "LoadAwareScheduling"

    def __init__(self, resource_weights=None, usage_thresholds=None,
                 prod_usage_thresholds=None, scaling_factors=None,
                 score_according_prod: bool = False, weight: int = 1):
        self.resource_weights = dict(resource_weights
                                     or DEFAULT_RESOURCE_WEIGHTS)
        self.weights_vec = resources_to_vector(self.resource_weights)
        self.thresholds = resources_to_vector(
            usage_thresholds or DEFAULT_USAGE_THRESHOLDS)
        self.prod_thresholds = resources_to_vector(prod_usage_thresholds
                                                   or {})
        self.scaling_factors = dict(scaling_factors
                                    or DEFAULT_ESTIMATED_SCALING_FACTORS)
        self.score_according_prod = score_according_prod
        self.weight = weight

    def score_weight(self) -> int:
        return self.weight

    def _pod_flags(self, pod):
        return pod.is_daemonset, pod.priority_class == PriorityClass.PROD

    def filter(self, state: CycleState, snapshot, pod, node) -> Status:
        view = node_view(state, snapshot)
        i = view.index[node.name]
        a = view.arrays
        is_ds, is_prod = self._pod_flags(pod)
        if loadaware_filter_node(
                a.alloc[i], a.usage[i], a.prod_usage[i],
                bool(a.metric_fresh[i]), self.thresholds,
                self.prod_thresholds, is_ds, is_prod):
            return Status.success()
        return Status.unschedulable_("node(s) usage exceed threshold")

    def score(self, state: CycleState, snapshot, pod, node) -> int:
        view = node_view(state, snapshot)
        i = view.index[node.name]
        a = view.arrays
        _, is_prod = self._pod_flags(pod)
        est = resources_to_vector(
            estimate_pod_used(pod, self.scaling_factors,
                              self.resource_weights))
        return loadaware_score_node(
            est, a.alloc[i], a.usage[i], a.est_extra[i], a.prod_base[i],
            bool(a.metric_fresh[i]), self.weights_vec, is_prod,
            self.score_according_prod)
