"""Reservations: owner matching, the free remainder, and the plugin
chain's restore, match and allocate (counterpart of
``koordinator_tpu/scheduler/plugins/reservation.py``; reference
pkg/scheduler/plugins/reservation/transformer.go).

An Available reservation holds its unallocated remainder
``(allocatable - allocated)+`` on its node (``state/cluster.py`` adds it
into ``used_req``), so:

- unmatched pods see the remainder as held: nothing to do;
- matched pods get the remainder credited back for Filter/Score (the
  BeforePreFilter restore of :class:`ReservationPlugin`);
- Reserve allocates the pod onto the matched reservation with the most
  free capacity on the chosen node (ties: the first in snapshot order;
  the reference nominates by reservation score, a documented deviation
  in which reservation is consumed first).

The batched path does the same in the solve (``ops/binpack.py``
``ResvArrays``), with its host bookkeeping in ``models/placement.py``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from koordinator_tpu_torch.apis.types import (
    PodSpec,
    ReservationSpec,
    ReservationState,
    resources_to_vector,
    selector_matches,
    vector_to_resources,
)
from koordinator_tpu_torch.scheduler.framework import (
    CycleState,
    Plugin,
    Status,
)
from koordinator_tpu_torch.scheduler.plugins.lowering import node_view

_MATCH_KEY = "__resv_matched__"


def is_reserve_pod(pod: PodSpec) -> bool:
    """Placement probes for reservations themselves (the descheduler's
    migration probe): they never match a reservation, but still see
    reserved capacity as held."""
    return pod.uid.startswith("__resv__")


def reservation_matches_pod(resv: ReservationSpec, pod: PodSpec) -> bool:
    """Owner match of an Available, bound reservation: explicit pod-uid
    owners, else label owners (every owner label present on the pod)."""
    if is_reserve_pod(pod):
        return False
    if resv.state != ReservationState.AVAILABLE or resv.node_name is None:
        return False
    if resv.owner_pod_uids:
        return pod.uid in resv.owner_pod_uids
    if not resv.owner_labels:
        return False
    return selector_matches(resv.owner_labels, pod.labels)


def reservation_free(resv: ReservationSpec) -> np.ndarray:
    """The unallocated remainder, int64 ``[R]``, never negative."""
    alloc = resources_to_vector(resv.allocatable or resv.requests)
    used = resources_to_vector(resv.allocated)
    return np.maximum(alloc - used, 0)


class ReservationPlugin(Plugin):
    name = "Reservation"

    def before_pre_filter(self, state: CycleState, snapshot, pod) -> bool:
        """Credit matched reservations' free remainder back to their
        nodes for this pod's cycle (the BeforePreFilter restore)."""
        view = node_view(state, snapshot)
        matched: Dict[str, List[ReservationSpec]] = {}
        changed = False
        for resv in snapshot.reservations:
            if not reservation_matches_pod(resv, pod):
                continue
            free = reservation_free(resv)
            if not free.any():
                continue
            matched.setdefault(resv.node_name, []).append(resv)
            extra = view.extra_used.setdefault(resv.node_name,
                                               np.zeros_like(free))
            view.extra_used[resv.node_name] = extra - free
            changed = True
        state[_MATCH_KEY] = matched
        return changed

    def reserve(self, state: CycleState, snapshot, pod, node) -> Status:
        matched = state.get(_MATCH_KEY, {}).get(node.name, [])
        if not matched:
            return Status.success()
        # the most free capacity wins; ties go to the first in snapshot
        # order
        best = max(matched, key=lambda r: int(reservation_free(r).sum()))
        req = resources_to_vector(pod.requests)
        alloc_vec = resources_to_vector(best.allocatable or best.requests)
        old_allocated = resources_to_vector(best.allocated)
        new_allocated = np.minimum(old_allocated + req, alloc_vec)
        best.allocated = vector_to_resources(new_allocated)
        best.allocated_pod_uids.append(pod.uid)
        if best.allocate_once:
            best.state = ReservationState.SUCCEEDED
        tracker = getattr(snapshot, "delta_tracker", None)
        if tracker is not None:
            tracker.mark_node(best.node_name)
        state["reservation_allocated"] = best.name
        # the clamped delta actually added: Unreserve subtracts exactly
        # this, not the raw request
        state["reservation_allocated_delta"] = new_allocated - old_allocated
        return Status.success()

    def unreserve(self, state: CycleState, snapshot, pod, node) -> None:
        name = state.get("reservation_allocated")
        if not name:
            return
        delta = state.get("reservation_allocated_delta")
        for resv in snapshot.reservations:
            if resv.name != name:
                continue
            sub = (delta if delta is not None
                   else resources_to_vector(pod.requests))
            cur = resources_to_vector(resv.allocated)
            resv.allocated = vector_to_resources(np.maximum(cur - sub, 0))
            if pod.uid in resv.allocated_pod_uids:
                resv.allocated_pod_uids.remove(pod.uid)
            if (resv.state == ReservationState.SUCCEEDED
                    and resv.allocate_once):
                resv.state = ReservationState.AVAILABLE
            tracker = getattr(snapshot, "delta_tracker", None)
            if tracker is not None:
                tracker.mark_node(resv.node_name)
            break
