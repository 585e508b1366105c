"""NodePorts: host-port conflict filtering.

Reference: the upstream k8s NodePorts plugin the reference vendors with
its scheduling framework (pinned k8s.io/kubernetes v1.24,
pkg/scheduler/framework/plugins/nodeports) and exercises in its e2e
suite (test/e2e/scheduling/hostport_predicates.go scope). A pod
requesting a host port is unschedulable on any node where an assigned
pod already holds the same (protocol, port).

``PodSpec.host_ports`` entries are ints (TCP implied) or
``"<proto>:<port>"`` strings; upstream's hostIP dimension is collapsed
(ports are node-global), which is the conservative direction — a
conflict upstream would allow on disjoint hostIPs is rejected here.

One instance serves both scheduling paths: the incremental framework
chain (filter/reserve/unreserve) and the batched propose→validate→
refine loop through FineGrained — transient ``_holds`` make
batch-internal conflicts visible before the next solve iteration, while
committed pods are counted from the snapshot (their ``node_name`` is
set), so holds are membership-idempotent with snapshot state.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

from koordinator_tpu_torch.scheduler.framework import CycleState, Plugin, Status

_STATE_KEY = "NodePorts/used"


def pod_host_ports(pod) -> FrozenSet[str]:
    """Normalized "proto:port" set for a pod (empty = no host ports)."""
    out = set()
    for entry in getattr(pod, "host_ports", None) or ():
        if isinstance(entry, int):
            out.add(f"tcp:{entry}")
        else:
            text = str(entry).lower()
            out.add(text if ":" in text else f"tcp:{text}")
    return frozenset(out)


class NodePortsPlugin(Plugin):
    name = "NodePorts"

    def __init__(self):
        #: pod uid -> (node_name, ports) reserved THIS solve (the
        #: validate-loop holds); pruned lazily against the snapshot
        self._holds: Dict[str, Tuple[str, FrozenSet[str]]] = {}

    # -- read side -----------------------------------------------------------

    def _snapshot_used(self, state: CycleState, snapshot,
                       node_name: str) -> FrozenSet[str]:
        """Ports held by assigned pods on the node. The whole
        node -> ports map is built in ONE O(pods) pass and cached per
        cycle — per-node snapshot scans would make a rows() computation
        O(nodes x pods)."""
        by_node = state.get(_STATE_KEY) if state is not None else None
        if by_node is None:
            by_node = {}
            for p in snapshot.pods:
                if p.node_name is not None:
                    ports = pod_host_ports(p)
                    if ports:
                        by_node.setdefault(p.node_name, set()).update(ports)
            if state is not None:
                state[_STATE_KEY] = by_node
        return frozenset(by_node.get(node_name, ()))

    def _held(self, state: CycleState, snapshot, node_name: str,
              skip_uid: str) -> FrozenSet[str]:
        """Live validate-loop holds on the node. Holds whose pod is gone
        from the snapshot entirely (deleted mid-flight) are pruned so a
        vanished pod can't phantom-block its port forever — ONCE per
        cycle, not per node (the live-uid set is O(pods))."""
        if not self._holds:
            return frozenset()
        pruned_key = "NodePorts/pruned"
        if state is None or not state.get(pruned_key):
            live = {p.uid for p in snapshot.pods}
            live.update(p.uid for p in snapshot.pending_pods)
            for uid in [u for u in self._holds if u not in live]:
                del self._holds[uid]
            if state is not None:
                state[pruned_key] = True
        out = set()
        for uid, (node, ports) in self._holds.items():
            if node == node_name and uid != skip_uid:
                out |= ports
        return frozenset(out)

    # -- framework stages ----------------------------------------------------

    def filter(self, state: CycleState, snapshot, pod, node) -> Status:
        want = pod_host_ports(pod)
        if not want:
            return Status.success()
        used = self._snapshot_used(state, snapshot, node.name)
        if want & used or want & self._held(state, snapshot, node.name,
                                            pod.uid):
            return Status.unschedulable_(
                "node(s) didn't have free ports for the requested pod ports"
            )
        return Status.success()

    def reserve(self, state: CycleState, snapshot, pod, node) -> Status:
        want = pod_host_ports(pod)
        if want:
            self._holds[pod.uid] = (node.name, want)
        return Status.success()

    def unreserve(self, state: CycleState, snapshot, pod, node) -> None:
        self._holds.pop(pod.uid, None)
