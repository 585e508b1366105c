"""Scheduler cache: the live cluster model with assume/forget semantics
(counterpart of ``koordinator_tpu/scheduler/cache.py``).

Mirrors the reference's scheduler cache + loadaware podAssignCache
(pkg/scheduler/plugins/loadaware/pod_assign_cache.go): assumed pods count
against node resources immediately (before the API server confirms the
bind), with their assign timestamps driving the loadaware estimation
staleness rules. ``snapshot()`` produces the consistent typed view each
scheduling cycle (and each batched solve) runs against.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    GangSpec,
    NodeMetric,
    NodeSpec,
    PodSpec,
    QuotaSpec,
    ReservationSpec,
)
from koordinator_tpu_torch.state.cluster import ClusterDeltaTracker


class SchedulerCache:
    """Every mutation marks the delta tracker with the node rows it
    touches (the informer/cache snapshot-diff idiom): snapshots carry
    the tracker, so the model's staging cache re-lowers only what
    actually changed between scheduling rounds. Gang/quota updates
    don't mark — they never enter the node arrays (lowered per solve).

    Concurrency: every mutable mapping below is read and written under
    ``_lock``.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.nodes: Dict[str, NodeSpec] = {}
        self.pods: Dict[str, PodSpec] = {}          # assigned (incl. assumed)
        self.pending: Dict[str, PodSpec] = {}
        self.assumed: Dict[str, float] = {}         # uid -> assume time
        self.node_metrics: Dict[str, NodeMetric] = {}
        self.gangs: Dict[str, GangSpec] = {}
        self.quotas: Dict[str, QuotaSpec] = {}
        self.reservations: Dict[str, ReservationSpec] = {}
        self.delta_tracker = ClusterDeltaTracker()

    # -- informer-style updates --------------------------------------------

    def add_node(self, node: NodeSpec) -> None:
        with self._lock:
            if node.name in self.nodes:
                # spec update in place: same node set/order, one dirty row
                self.delta_tracker.mark_node(node.name)
            else:
                self.delta_tracker.mark_structure()
            self.nodes[node.name] = node

    def remove_node(self, name: str) -> None:
        with self._lock:
            if self.nodes.pop(name, None) is not None:
                self.delta_tracker.mark_structure()

    def add_pod(self, pod: PodSpec) -> None:
        """A pod object appeared: pending if unassigned, else running."""
        with self._lock:
            if pod.node_name:
                self.pods[pod.uid] = pod
                self.delta_tracker.mark_node(pod.node_name)
            else:
                self.pending[pod.uid] = pod

    def remove_pod(self, uid: str) -> None:
        with self._lock:
            pod = self.pods.pop(uid, None)
            if pod is not None:
                self.delta_tracker.mark_node(pod.node_name)
            self.pending.pop(uid, None)
            self.assumed.pop(uid, None)

    def promote_assigned(self, pod: PodSpec) -> None:
        """A binding became visible through the bus (another scheduler's
        Bind, or in-place mutation on the in-process bus): move the pod
        from pending to assigned without touching assign bookkeeping."""
        with self._lock:
            self.pending.pop(pod.uid, None)
            prev = self.pods.get(pod.uid)
            if prev is not None and prev.node_name != pod.node_name:
                self.delta_tracker.mark_node(prev.node_name)
            self.pods[pod.uid] = pod
            self.delta_tracker.mark_node(pod.node_name)

    def replace_pod(self, pod: PodSpec) -> None:
        """A cached pod's object changed (a status refresh, a resize):
        swap the new object in. An assigned pod's requests, limits and
        priority feed its node's lowered row, so its node is marked (the
        old and the new one when they differ)."""
        with self._lock:
            prev = self.pods.get(pod.uid)
            if prev is None:
                self.pending[pod.uid] = pod
                return
            self.pods[pod.uid] = pod
            self.delta_tracker.mark_node(prev.node_name)
            if pod.node_name != prev.node_name:
                self.delta_tracker.mark_node(pod.node_name)

    def update_node_metric(self, metric: NodeMetric) -> None:
        with self._lock:
            self.node_metrics[metric.node_name] = metric
            self.delta_tracker.mark_node(metric.node_name)

    def update_gang(self, spec: GangSpec) -> None:
        with self._lock:
            self.gangs[spec.name] = spec

    def update_quota(self, spec: QuotaSpec) -> None:
        with self._lock:
            self.quotas[spec.name] = spec

    def update_reservation(self, spec: ReservationSpec) -> None:
        with self._lock:
            # stamp creation for TTL expiry (the CRD's creationTimestamp);
            # an unset create_time with a live TTL would expire immediately
            if spec.ttl and not spec.create_time:
                spec.create_time = time.time()
            prev = self.reservations.get(spec.name)
            if prev is not None and prev.node_name != spec.node_name:
                self.delta_tracker.mark_node(prev.node_name)
            self.reservations[spec.name] = spec
            self.delta_tracker.mark_node(spec.node_name)

    # -- assume / forget (reference: scheduler cache AssumePod) -------------

    def assume_pod(self, uid: str, node_name: str, now: Optional[float] = None) -> None:
        with self._lock:
            pod = self.pending.pop(uid, None)
            if pod is None:
                return
            pod.node_name = node_name
            pod.assign_time = now if now is not None else time.time()
            self.pods[uid] = pod
            self.assumed[uid] = pod.assign_time
            self.delta_tracker.mark_node(node_name)

    def forget_pod(self, uid: str) -> None:
        """Bind failed / gang rejected: back to pending."""
        with self._lock:
            pod = self.pods.pop(uid, None)
            self.assumed.pop(uid, None)
            if pod is not None:
                self.delta_tracker.mark_node(pod.node_name)
                pod.node_name = None
                pod.waiting_permit = False
                self.pending[pod.uid] = pod

    def open_permit(self, uid: str) -> None:
        """The Permit barrier opened: the pod becomes bindable. The
        assume entry is KEPT — only the publish confirmation
        (:meth:`finish_binding`) closes it, so a round that aborts
        after opening the barrier (FencingError) can still forget the
        never-published decision."""
        with self._lock:
            pod = self.pods.get(uid)
            if pod is not None:
                pod.waiting_permit = False

    def finish_binding(self, uid: str) -> None:
        with self._lock:
            self.assumed.pop(uid, None)
            pod = self.pods.get(uid)
            if pod is not None:
                pod.waiting_permit = False  # the Permit barrier opened

    # -- snapshot -----------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> ClusterSnapshot:
        with self._lock:
            return ClusterSnapshot(
                nodes=list(self.nodes.values()),
                pods=list(self.pods.values()),
                pending_pods=list(self.pending.values()),
                node_metrics=dict(self.node_metrics),
                gangs=dict(self.gangs),
                quotas=dict(self.quotas),
                reservations=list(self.reservations.values()),
                now=now if now is not None else time.time(),
                delta_tracker=self.delta_tracker,
                # captured under the lock: marks landing after this
                # point carry a later epoch and re-lower next tick
                delta_epoch=self.delta_tracker.epoch,
            )
