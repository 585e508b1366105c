"""States informer: the node agent's view of node / pods / NodeSLO.

Reference: pkg/koordlet/statesinformer/impl/{states_informer.go,
registry.go, callback_runner.go} — a registry of informer plugins keeps
node, pod list, NodeSLO, NodeMetric policy in sync and fans callbacks out
to subscribers (qosmanager strategies re-arm on NodeSLO changes, the
metric reporter on collect-policy changes).

In this framework the control plane is in-process: setters stand in for
the apiserver watch; the callback fan-out and the typed getters keep the
same surface the subsystems program against.

Counterpart of
``koordinator_tpu/koordlet/statesinformer/states_informer.py``: host
work in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence

from koordinator_tpu_torch.apis.types import NodeSpec
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta
from koordinator_tpu_torch.manager.nodemetric import NodeMetricCollectPolicy
from koordinator_tpu_torch.manager.sloconfig import NodeSLOSpec


class StateKind(enum.Enum):
    NODE = "node"
    PODS = "pods"
    NODE_SLO = "nodeslo"
    COLLECT_POLICY = "collect_policy"
    PVCS = "pvcs"


Callback = Callable[[StateKind, object], None]


class StatesInformer:
    """Typed state + callback fan-out (reference: callback_runner.go)."""

    def __init__(self):
        self._node: Optional[NodeSpec] = None
        self._pods: List[PodMeta] = []
        self._node_slo: NodeSLOSpec = NodeSLOSpec()
        self._collect_policy: Optional[NodeMetricCollectPolicy] = None
        #: claim key ("namespace/name") -> bound PV name (reference:
        #: states_pvc.go volumeNameMap)
        self._volume_names: Dict[str, str] = {}
        self._callbacks: Dict[StateKind, List[Callback]] = {
            k: [] for k in StateKind
        }

    # -- subscribe ----------------------------------------------------------

    def register_callback(self, kind: StateKind, cb: Callback) -> None:
        self._callbacks[kind].append(cb)

    def _fire(self, kind: StateKind, value: object) -> None:
        for cb in self._callbacks[kind]:
            cb(kind, value)

    # -- setters (the "watch" side) -----------------------------------------

    def set_node(self, node: NodeSpec) -> None:
        self._node = node
        self._fire(StateKind.NODE, node)

    def set_pods(self, pods: Sequence[PodMeta]) -> None:
        self._pods = list(pods)
        self._fire(StateKind.PODS, self._pods)

    def set_node_slo(self, slo: NodeSLOSpec) -> None:
        self._node_slo = slo
        self._fire(StateKind.NODE_SLO, slo)

    def set_collect_policy(self, policy: NodeMetricCollectPolicy) -> None:
        self._collect_policy = policy
        self._fire(StateKind.COLLECT_POLICY, policy)

    def upsert_pvc(self, pvc) -> None:
        """PVC add/update (states_pvc.go updateVolumeNameMap)."""
        self._volume_names[pvc.name] = pvc.volume_name
        self._fire(StateKind.PVCS, dict(self._volume_names))

    def remove_pvc(self, claim_key: str) -> None:
        if self._volume_names.pop(claim_key, None) is not None:
            self._fire(StateKind.PVCS, dict(self._volume_names))

    # -- getters (what subsystems consume) ----------------------------------

    def get_node(self) -> Optional[NodeSpec]:
        return self._node

    def running_pods(self) -> List[PodMeta]:
        """PodProvider protocol for the advisor/qosmanager."""
        return self._pods

    def get_node_slo(self) -> NodeSLOSpec:
        return self._node_slo

    def get_collect_policy(self) -> Optional[NodeMetricCollectPolicy]:
        return self._collect_policy

    def get_volume_name(self, claim_key: str) -> str:
        """Bound PV for a "namespace/name" claim key; "" when unknown
        (reference: states_pvc.go GetVolumeName)."""
        return self._volume_names.get(claim_key, "")
