"""Reservation owner matching and free remainder (counterpart of
``koordinator_tpu/scheduler/plugins/reservation.py``, its module-level
helpers only: the batched solve needs no per-pod plugin cycle).

An Available reservation holds its unallocated remainder
``(allocatable - allocated)+`` on its node (``state/cluster.py`` adds it
into ``used_req``); pods that match it get that remainder credited back
for Filter/Score and consume it on the node they land on
(``ops/binpack.py`` ``ResvArrays``).
"""

from __future__ import annotations

import numpy as np

from koordinator_tpu_torch.apis.types import (
    PodSpec,
    ReservationSpec,
    ReservationState,
    resources_to_vector,
    selector_matches,
)


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
