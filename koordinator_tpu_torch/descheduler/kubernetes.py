"""k8s-compat descheduler plugins (a copy of
``koordinator_tpu/descheduler/kubernetes.py``).

Reference: pkg/descheduler/framework/plugins/kubernetes/ — the upstream
sigs-descheduler strategies adapted into the koord descheduler framework
(plugin.go:85-120 registers RemoveDuplicates,
RemovePodsHavingTooManyRestarts, RemovePodsViolatingNodeAffinity via the
adaptor). Each is a Deschedule plugin: scan the snapshot, evict
violators through the shared evictor (which enforces limits and the
migration/direct mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.types import ClusterSnapshot, PodSpec, selector_matches
from koordinator_tpu_torch.descheduler.framework import DeschedulePlugin, Evictor


class RemovePodsViolatingNodeAffinity(DeschedulePlugin):
    """Evict pods whose required node selector no longer matches their
    node's labels (upstream removepodsviolatingnodeaffinity with
    requiredDuringSchedulingIgnoredDuringExecution)."""

    name = "RemovePodsViolatingNodeAffinity"

    def deschedule(self, snapshot: ClusterSnapshot, evictor: Evictor) -> None:
        nodes = {node.name: node for node in snapshot.nodes}
        for pod in list(snapshot.pods):
            if pod.node_name is None or not pod.node_selector:
                continue
            node = nodes.get(pod.node_name)
            if node is None:
                continue
            if not selector_matches(pod.node_selector, node.labels):
                evictor.evict(snapshot, pod, reason=self.name)


@dataclasses.dataclass
class RemovePodsHavingTooManyRestarts(DeschedulePlugin):
    """Evict pods whose summed container restarts exceed the threshold
    (upstream removepodshavingtoomanyrestarts; default 100)."""

    pod_restart_threshold: int = 100
    name = "RemovePodsHavingTooManyRestarts"

    def deschedule(self, snapshot: ClusterSnapshot, evictor: Evictor) -> None:
        for pod in list(snapshot.pods):
            if pod.node_name is None:
                continue
            if pod.restart_count >= self.pod_restart_threshold:
                evictor.evict(snapshot, pod, reason=self.name)


class RemoveDuplicates(DeschedulePlugin):
    """Evict excess same-owner replicas sharing one node, keeping one per
    (owner, node) (upstream removeduplicates: duplicates are pods of one
    controller colocated on a node)."""

    name = "RemoveDuplicates"

    def deschedule(self, snapshot: ClusterSnapshot, evictor: Evictor) -> None:
        groups: Dict[tuple, List[PodSpec]] = {}
        for pod in snapshot.pods:
            if pod.node_name is None or pod.owner is None:
                continue
            groups.setdefault((pod.owner, pod.node_name), []).append(pod)
        for (_owner, _node), pods in sorted(groups.items()):
            if len(pods) <= 1:
                continue
            # keep the first by name; evict the rest
            for pod in sorted(pods, key=lambda p: p.name)[1:]:
                evictor.evict(snapshot, pod, reason=self.name)
