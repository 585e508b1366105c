"""PodMigrationJob controller + arbitrator: reservation-first migration
(a copy of ``koordinator_tpu/descheduler/migration.py``).

Semantics oracle: pkg/descheduler/controllers/migration/controller.go
(Reconcile :218, doMigrate :241, createReservation :763, evictPod :661 —
capacity is reserved on a destination node *before* the pod is evicted,
so migration never loses capacity) and controllers/migration/arbitrator/
{arbitrator.go, sort.go, filter.go} (candidate ordering + group limits).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    MigrationPhase,
    PodMigrationJob,
    PodSpec,
    ReservationSpec,
    ReservationState,
)


def _workload_of(pod: PodSpec) -> str:
    """Group key for per-workload limits (reference: arbitrator sort.go
    getJobControllerOfPod — the controller owner reference). Pods without
    an owner fall back to a label or the pod-name-stem heuristic."""
    if pod.owner:
        return pod.owner
    if "workload" in pod.labels:
        return pod.labels["workload"]
    base = pod.name.rsplit("-", 1)[0] if "-" in pod.name else pod.name
    return f"{pod.namespace}/{base}"


@dataclasses.dataclass
class Arbitrator:
    """Serializes + gates candidate migrations (reference:
    arbitrator.go:52 Arbitrator, :198 doOnceArbitrate)."""

    max_migrating_per_node: Optional[int] = None
    max_migrating_per_namespace: Optional[int] = None
    max_migrating_per_workload: Optional[int] = None

    def arbitrate(
        self,
        jobs: List[PodMigrationJob],
        snapshot: ClusterSnapshot,
        migrating: List[PodMigrationJob],
    ) -> List[PodMigrationJob]:
        """Order pending jobs and admit those within group limits.

        Sort: creation time, then fewest in-flight migrations of the same
        workload first, then workload grouping (reference: sort.go
        SortJobsByCreationTime/SortJobsByMigratingNum/SortJobsByController).
        """
        pods = {p.uid: p for p in snapshot.pods}
        in_flight_nodes: Dict[str, int] = {}
        in_flight_ns: Dict[str, int] = {}
        in_flight_workload: Dict[str, int] = {}
        for job in migrating:
            pod = pods.get(job.pod_uid)
            if pod is None:
                continue
            in_flight_nodes[pod.node_name or ""] = (
                in_flight_nodes.get(pod.node_name or "", 0) + 1
            )
            in_flight_ns[pod.namespace] = in_flight_ns.get(pod.namespace, 0) + 1
            in_flight_workload[_workload_of(pod)] = (
                in_flight_workload.get(_workload_of(pod), 0) + 1
            )

        def sort_key(job):
            pod = pods.get(job.pod_uid)
            workload = _workload_of(pod) if pod else ""
            return (
                job.create_time,
                in_flight_workload.get(workload, 0),
                workload,
                job.name,
            )

        admitted: List[PodMigrationJob] = []
        for job in sorted(jobs, key=sort_key):
            pod = pods.get(job.pod_uid)
            if pod is None:
                job.phase = MigrationPhase.FAILED
                job.reason = "pod not found"
                continue
            node = pod.node_name or ""
            ns = pod.namespace
            workload = _workload_of(pod)
            if (
                self.max_migrating_per_node is not None
                and in_flight_nodes.get(node, 0) >= self.max_migrating_per_node
            ):
                continue
            if (
                self.max_migrating_per_namespace is not None
                and in_flight_ns.get(ns, 0) >= self.max_migrating_per_namespace
            ):
                continue
            if (
                self.max_migrating_per_workload is not None
                and in_flight_workload.get(workload, 0)
                >= self.max_migrating_per_workload
            ):
                continue
            in_flight_nodes[node] = in_flight_nodes.get(node, 0) + 1
            in_flight_ns[ns] = in_flight_ns.get(ns, 0) + 1
            in_flight_workload[workload] = in_flight_workload.get(workload, 0) + 1
            admitted.append(job)
        return admitted


class MigrationController:
    """PodMigrationJob state machine (reference: migration/controller.go).

    Pending → (arbitrate) → create Reservation → wait bound → evict pod →
    Succeeded; TTL exceeded → Failed. ``place_reservation`` is the
    scheduler handoff: given the stand-in reservation spec, return the
    destination node (the reference creates a Reservation CR and lets
    koord-scheduler bind it, controller.go:763 + :587
    waitForPodBindReservation).
    """

    def __init__(
        self,
        place_reservation: Callable[
            [ClusterSnapshot, ReservationSpec], Optional[str]
        ],
        arbitrator: Optional[Arbitrator] = None,
    ):
        self.place_reservation = place_reservation
        self.arbitrator = arbitrator or Arbitrator()

    def reconcile(
        self, snapshot: ClusterSnapshot, jobs: List[PodMigrationJob]
    ) -> None:
        pods = {p.uid: p for p in snapshot.pods}

        # expire overdue jobs first (reference: controller.go job TTL)
        for job in jobs:
            if job.phase in (MigrationPhase.PENDING, MigrationPhase.RUNNING):
                if snapshot.now - job.create_time > job.ttl:
                    job.phase = MigrationPhase.FAILED
                    job.reason = "migration job timeout"
                    self._cleanup_reservation(snapshot, job)

        running = [j for j in jobs if j.phase == MigrationPhase.RUNNING]
        pending = [
            j for j in jobs if j.phase == MigrationPhase.PENDING and not j.paused
        ]
        for job in self.arbitrator.arbitrate(pending, snapshot, running):
            pod = pods[job.pod_uid]
            reservation = ReservationSpec(
                name=f"reserve-{job.name}",
                requests=dict(pod.requests),
                owner_pod_uids=[pod.uid],
                expiration_time=snapshot.now + job.ttl,
            )
            node = self.place_reservation(snapshot, reservation)
            if node is None:
                continue  # stays Pending; retried next reconcile
            reservation.node_name = node
            reservation.state = ReservationState.AVAILABLE
            snapshot.reservations.append(reservation)
            tracker = getattr(snapshot, "delta_tracker", None)
            if tracker is not None:
                tracker.mark_node(node)
            job.reservation_name = reservation.name
            job.phase = MigrationPhase.RUNNING

        for job in jobs:
            if job.phase != MigrationPhase.RUNNING:
                continue
            pod = pods.get(job.pod_uid)
            if pod is None:
                job.phase = MigrationPhase.FAILED
                job.reason = "pod disappeared"
                self._cleanup_reservation(snapshot, job)
                continue
            # capacity reserved → safe to evict (reference: evictPod :661)
            pod.node_name = None
            snapshot.pods[:] = [p for p in snapshot.pods if p is not pod]
            snapshot.pending_pods.append(pod)
            job.phase = MigrationPhase.SUCCEEDED

    def _cleanup_reservation(self, snapshot, job) -> None:
        if not job.reservation_name:
            return
        snapshot.reservations = [
            r for r in snapshot.reservations if r.name != job.reservation_name
        ]
