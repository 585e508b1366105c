"""NodeResourcesFit: the resource fit and LeastAllocated for the plugin
chain (counterpart of ``koordinator_tpu/scheduler/plugins/fit.py``).

The host twin of ``ops/fit.py``: node requested totals come from the
same lowering as the batched path (``lowering.node_view``).
"""

from __future__ import annotations

from koordinator_tpu_torch.apis.types import (
    resources_to_vector,
    selector_matches,
)
from koordinator_tpu_torch.oracle.scheduler import (
    fit_filter_node,
    least_allocated_score_node,
)
from koordinator_tpu_torch.scheduler.framework import (
    CycleState,
    Plugin,
    Status,
)
from koordinator_tpu_torch.scheduler.plugins.lowering import node_view
from koordinator_tpu_torch.state.cluster import DEFAULT_RESOURCE_WEIGHTS


class NodeResourcesFit(Plugin):
    name = "NodeResourcesFit"

    def __init__(self, weights=None, weight: int = 1):
        self.weights = resources_to_vector(weights or DEFAULT_RESOURCE_WEIGHTS)
        self.weight = weight

    def score_weight(self) -> int:
        return self.weight

    def filter(self, state: CycleState, snapshot, pod, node) -> Status:
        # the required node selector (spec.nodeSelector, the part of node
        # affinity the upstream NodeAffinity filter enforces)
        if pod.node_selector and not selector_matches(pod.node_selector,
                                                      node.labels):
            return Status.unschedulable_(
                "node(s) didn't match Pod's node selector")
        view = node_view(state, snapshot)
        i = view.index[node.name]
        req = resources_to_vector(pod.requests)
        used = view.arrays.used_req[i] + view.extra_used.get(node.name, 0)
        if fit_filter_node(req, view.arrays.alloc[i], used):
            return Status.success()
        return Status.unschedulable_("insufficient resources")

    def score(self, state: CycleState, snapshot, pod, node) -> int:
        view = node_view(state, snapshot)
        i = view.index[node.name]
        req = resources_to_vector(pod.requests)
        used = view.arrays.used_req[i] + view.extra_used.get(node.name, 0)
        return least_allocated_score_node(
            req, view.arrays.alloc[i], used, self.weights)
