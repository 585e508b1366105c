"""Reservation lifecycle controller: expiration, status sync, GC
(counterpart of ``koordinator_tpu/scheduler/reservation_controller.py``).

Rebuild of the reference's reservation controller
(pkg/scheduler/plugins/reservation/controller/controller.go:186-266 and
garbage_collection.go:35-82):

- a reservation expires when it is neither Succeeded nor Failed and its
  ``expiration_time`` has passed, or its ``ttl`` (age since
  ``create_time``) has elapsed (ttl == 0 disables), or its bound node no
  longer exists;
- Expired/Succeeded reservations are garbage-collected ``gc_seconds``
  after the transition (default 24h, defaultGCDuration);
- status sync recomputes current owners + allocated from the live pods
  consuming the reservation, releasing capacity held by deleted pods
  (controller.go syncStatus).

Expired reservations stop holding node capacity automatically: the
snapshot lowering only encodes holds for Available reservations
(state/cluster.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from koordinator_tpu_torch.apis.types import (
    ReservationSpec,
    ReservationState,
    resources_to_vector,
    vector_to_resources,
)

DEFAULT_GC_SECONDS = 24 * 3600.0


class ReservationController:
    """Periodic reconciler over the scheduler cache's reservations."""

    def __init__(self, cache, gc_seconds: float = DEFAULT_GC_SECONDS):
        self.cache = cache
        self.gc_seconds = gc_seconds
        #: reservation name -> when it left the active states
        self._done_time: Dict[str, float] = {}

    def sync(self, now: float) -> None:
        """One reconcile pass: expire → sync status → GC."""
        tracker = getattr(self.cache, "delta_tracker", None)
        for resv in list(self.cache.reservations.values()):
            if self._needs_expiration(resv, now):
                resv.state = ReservationState.EXPIRED
                if tracker is not None:
                    # the node stops holding the remainder: re-lower it
                    tracker.mark_node(resv.node_name)
            if resv.state == ReservationState.AVAILABLE:
                self._sync_status(resv)
            if resv.state in (ReservationState.EXPIRED, ReservationState.FAILED,
                              ReservationState.SUCCEEDED):
                self._done_time.setdefault(resv.name, now)
            else:
                self._done_time.pop(resv.name, None)
        self._gc(now)

    # -- expiration (controller.go:255-266 isReservationNeedExpiration) ----

    def _needs_expiration(self, resv: ReservationSpec, now: float) -> bool:
        if resv.state in (
            ReservationState.FAILED,
            ReservationState.SUCCEEDED,
            ReservationState.EXPIRED,
        ):
            return False
        # bound to a node that no longer exists: expires unconditionally
        # (controller.go:190 — checked before the TTL gates)
        if (
            resv.node_name is not None
            and resv.node_name not in self.cache.nodes
        ):
            return True
        if resv.ttl is not None and resv.ttl == 0:
            return False
        if resv.expiration_time is not None and now >= resv.expiration_time:
            return True
        if resv.ttl is not None and (now - resv.create_time) >= resv.ttl:
            return True
        return False

    # -- status sync (controller.go:207-253 syncStatus) ---------------------

    def _sync_status(self, resv: ReservationSpec) -> None:
        if resv.node_name is None:
            return
        live = [uid for uid in resv.allocated_pod_uids if uid in self.cache.pods]
        if live == resv.allocated_pod_uids:
            return
        allocated = np.zeros_like(resources_to_vector({}))
        for uid in live:
            allocated = allocated + resources_to_vector(
                self.cache.pods[uid].requests
            )
        # mask to the reservation's allocatable dimensions + clamp
        alloc_vec = resources_to_vector(resv.allocatable or resv.requests)
        allocated = np.minimum(np.where(alloc_vec > 0, allocated, 0), alloc_vec)
        resv.allocated = vector_to_resources(allocated)
        resv.allocated_pod_uids = live
        tracker = getattr(self.cache, "delta_tracker", None)
        if tracker is not None:
            # released capacity changes the node's lowered hold
            tracker.mark_node(resv.node_name)

    # -- GC (garbage_collection.go:40-82) -----------------------------------

    def _gc(self, now: float) -> None:
        for name, done in list(self._done_time.items()):
            resv = self.cache.reservations.get(name)
            if resv is None:
                self._done_time.pop(name, None)
                continue
            if now - done >= self.gc_seconds:
                self.cache.reservations.pop(name, None)
                self._done_time.pop(name, None)
