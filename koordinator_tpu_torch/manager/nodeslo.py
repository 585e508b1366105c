"""The nodeslo controller: renders a NodeSLO spec per node from the
cluster configuration (counterpart of
``koordinator_tpu/manager/nodeslo.py``).

Upstream's nodeslo controller (pkg/slo-controller/nodeslo) merges the
cluster strategy ConfigMaps (threshold, QoS, CPU burst, system) with
node-selector overrides into one NodeSLO per node, and extender plugins
may add to it. ``client/wiring.ManagerLoop(nodeslo=...)`` publishes each
render on the bus.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

from koordinator_tpu_torch.apis.types import selector_matches
from koordinator_tpu_torch.manager.sloconfig import (
    NodeSLOSpec,
    NodeStrategySelector,
    default_node_slo_spec,
    merge_overrides,
)

#: an extender plugin: (node_name, node_labels, spec) -> None; it may
#: mutate ``spec.extensions`` (upstream's NodeSLOExtender)
NodeSLOExtender = Callable[[str, Dict[str, str], NodeSLOSpec], None]

#: a node-selector-scoped NodeSLO override: the selector and JSON merge
#: patch of the colocation node strategy
NodeSLOOverride = NodeStrategySelector


class NodeSLOController:
    """Renders NodeSLO specs: the cluster default, then every matching
    override in order, then the extender plugins."""

    def __init__(
        self,
        cluster_spec: Optional[NodeSLOSpec] = None,
        overrides: Optional[List[NodeSLOOverride]] = None,
        extenders: Optional[List[NodeSLOExtender]] = None,
    ):
        self.cluster_spec = cluster_spec or default_node_slo_spec()
        self.overrides = overrides or []
        self.extenders = extenders or []

    def render(self, node_name: str,
               node_labels: Dict[str, str]) -> NodeSLOSpec:
        spec = copy.deepcopy(self.cluster_spec)
        for ov in self.overrides:
            if selector_matches(ov.match_labels, node_labels):
                spec = merge_overrides(spec, ov.overrides)
        for ext in self.extenders:
            ext(node_name, node_labels, spec)
        return spec

    def reconcile_all(
        self, nodes: List[Tuple[str, Dict[str, str]]]
    ) -> Dict[str, NodeSLOSpec]:
        return {name: self.render(name, labels) for name, labels in nodes}
