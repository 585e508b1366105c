"""Host quota tree: request and used accounting and runtime refresh
(counterpart of ``koordinator_tpu/quota/core.py``, exact-rational mode).

The placement model computes each group's runtime once per solve here,
for trees of any depth, and ships it to the device as the precomputed
``QuotaState.runtime``; the scheduler keeps one manager per quota tree
for its request and used bookkeeping (``quota/trees.py``) and the plugin
chain's PreFilter admission (:meth:`GroupQuotaManager.can_admit`). The
weighted share rounds half up exactly, ``(2*w*T + W) // (2*W)``: the
semantics of the device path (ops/quota.py) and of the reference manager
with ``exact_rational=True``. (The reference scheduler's own managers run
the float64 share, which differs only on float rounding artifacts.)

Reference: pkg/scheduler/plugins/elasticquota/core/
runtime_quota_calculator.go:111-186 and group_quota_manager.go:184-328.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from koordinator_tpu_torch.apis.extension import NUM_RESOURCES
from koordinator_tpu_torch.apis.types import QuotaSpec, resources_to_vector

#: Well-known quota group names (reference: apis/extension/constants.go).
ROOT_QUOTA = "root"
SYSTEM_QUOTA = "system"
DEFAULT_QUOTA = "default"


def water_filling(
    total: int,
    request: Sequence[int],
    min_: Sequence[int],
    guarantee: Sequence[int],
    weight: Sequence[int],
    allow_lent: Sequence[bool],
) -> List[int]:
    """One resource dimension's runtime redistribution: each group gets
    ``min(max(min, guarantee), request)`` (non-lent groups keep the
    former), then the rest is shared among groups asking for more in
    proportion to weight, clamped at request, surplus re-pooled."""
    n = len(request)
    runtime = [0] * n
    adjustable = []
    total_weight = 0
    remaining = int(total)
    for i in range(n):
        auto_min = max(int(min_[i]), int(guarantee[i]))
        if request[i] > auto_min:
            adjustable.append(i)
            total_weight += int(weight[i])
            runtime[i] = auto_min
        elif allow_lent[i]:
            runtime[i] = int(request[i])
        else:
            runtime[i] = auto_min
        remaining -= runtime[i]

    while remaining > 0 and total_weight > 0 and adjustable:
        still = []
        still_weight = 0
        surplus = 0
        for i in adjustable:
            w = int(weight[i])
            runtime[i] += (2 * w * remaining + total_weight) // (2 * total_weight)
            if runtime[i] < request[i]:
                still.append(i)
                still_weight += w
            else:
                surplus += runtime[i] - int(request[i])
                runtime[i] = int(request[i])
        if surplus <= 0 or not still:
            break
        adjustable, total_weight, remaining = still, still_weight, surplus
    return runtime


@dataclasses.dataclass
class QuotaInfo:
    """One quota group's accounting state."""

    spec: QuotaSpec
    min: np.ndarray
    max: np.ndarray
    guaranteed: np.ndarray
    shared_weight: np.ndarray      # defaults to max
    request: np.ndarray            # own + child limited requests
    child_request: np.ndarray
    non_preemptible_request: np.ndarray
    used: np.ndarray
    non_preemptible_used: np.ndarray
    runtime: np.ndarray
    children: List[str]

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def parent(self) -> str:
        return self.spec.parent or ROOT_QUOTA

    @property
    def limited_request(self) -> np.ndarray:
        return np.minimum(self.request, self.max)


def _zeros() -> np.ndarray:
    return np.zeros(NUM_RESOURCES, dtype=np.int64)


class GroupQuotaManager:
    """The hierarchical quota tree: request and used accounting, and
    runtime refresh by a full root-to-leaf recomputation."""

    def __init__(self, cluster_total: Optional[Dict] = None):
        self.quotas: Dict[str, QuotaInfo] = {}
        self.cluster_total = resources_to_vector(cluster_total or {})
        self._insert(QuotaSpec(name=ROOT_QUOTA, parent=None, is_parent=True))

    def _insert(self, spec: QuotaSpec) -> QuotaInfo:
        mx = resources_to_vector(spec.max)
        info = QuotaInfo(
            spec=spec,
            min=resources_to_vector(spec.min),
            max=mx,
            guaranteed=resources_to_vector(spec.guaranteed),
            shared_weight=(
                resources_to_vector(spec.shared_weight)
                if spec.shared_weight is not None else mx.copy()
            ),
            request=_zeros(),
            child_request=_zeros(),
            non_preemptible_request=_zeros(),
            used=_zeros(),
            non_preemptible_used=_zeros(),
            runtime=_zeros(),
            children=[],
        )
        self.quotas[spec.name] = info
        return info

    def update_quota(self, spec: QuotaSpec) -> None:
        """Add a quota group to the tree, or reconfigure one (its
        accounting carries over)."""
        existing = self.quotas.get(spec.name)
        info = self._insert(spec)
        if existing is not None:
            for field in ("request", "child_request",
                          "non_preemptible_request", "used",
                          "non_preemptible_used", "children"):
                setattr(info, field, getattr(existing, field))
        self._rebuild_children()

    def _rebuild_children(self) -> None:
        for info in self.quotas.values():
            info.children = []
        for name, info in self.quotas.items():
            if name == ROOT_QUOTA:
                continue
            parent = self.quotas.get(info.parent)
            if parent is not None:
                parent.children.append(name)

    def _ancestry(self, name: str) -> List[QuotaInfo]:
        """[self, parent, ..., root]."""
        chain = []
        cur = self.quotas.get(name)
        while cur is not None:
            chain.append(cur)
            if cur.name == ROOT_QUOTA:
                break
            cur = self.quotas.get(cur.parent)
        return chain

    def add_request(self, name: str, delta: np.ndarray,
                    non_preemptible: bool = False) -> None:
        """Propagate a request delta up the tree: each level accumulates
        it into ``child_request``, rewrites ``request`` (floored at min
        for non-lent groups) and hands its parent the change in its
        max-limited request. A non-preemptible delta also adds unchanged
        into every level's ``non_preemptible_request``."""
        d = np.asarray(delta, dtype=np.int64)
        npd = d if non_preemptible else np.zeros_like(d)
        for info in self._ancestry(name):
            old_limited = info.limited_request
            info.non_preemptible_request = np.maximum(
                info.non_preemptible_request + npd, 0)
            if info.name == ROOT_QUOTA:
                info.request = np.maximum(info.request + d, 0)
                return
            info.child_request = np.maximum(info.child_request + d, 0)
            real = info.child_request.copy()
            if not info.spec.allow_lent_resource:
                real = np.maximum(real, info.min)
            info.request = real
            d = info.limited_request - old_limited

    def add_used(self, name: str, delta: np.ndarray,
                 non_preemptible: bool = False) -> None:
        """``used += delta`` (floored at 0) on the group and every
        ancestor, and on ``non_preemptible_used`` for a non-preemptible
        pod."""
        d = np.asarray(delta, dtype=np.int64)
        for info in self._ancestry(name):
            info.used = np.maximum(info.used + d, 0)
            if non_preemptible:
                info.non_preemptible_used = np.maximum(
                    info.non_preemptible_used + d, 0)

    def _available_total(self) -> np.ndarray:
        """The cluster total less what the system and default groups
        use."""
        total = self.cluster_total.copy()
        for special in (SYSTEM_QUOTA, DEFAULT_QUOTA):
            info = self.quotas.get(special)
            if info is not None:
                total = total - info.used
        return total

    def refresh_runtime(self, name: str) -> Optional[np.ndarray]:
        """Runtime of ``name`` after a root-to-leaf refresh along its
        ancestry, capped at its max."""
        info = self.quotas.get(name)
        if info is None:
            return None
        if name == ROOT_QUOTA:
            return self._available_total()
        if name in (SYSTEM_QUOTA, DEFAULT_QUOTA):
            return info.max.copy()
        total = self._available_total()
        for info in reversed(self._ancestry(name)):
            if info.name == ROOT_QUOTA:
                continue
            self._redistribute_children(self.quotas[info.parent], total)
            total = info.runtime
        return np.minimum(self.quotas[name].runtime, self.quotas[name].max)

    def _scaled_mins(self, children: List[QuotaInfo],
                     total: np.ndarray) -> np.ndarray:
        """``[C,R]`` per-child min, scaled down proportionally on the
        dimensions where the scaling-enabled siblings' mins oversubscribe
        ``total`` (scale_minquota_when_over_root_res.go:99-160)."""
        mins = np.stack([c.min for c in children])
        enable = np.array(
            [c.spec.enable_min_quota_scale for c in children], dtype=bool
        )
        if not enable.any():
            return mins
        enable_sum = mins[enable].sum(axis=0)
        disable_sum = (mins[~enable].sum(axis=0) if (~enable).any()
                       else np.zeros_like(total))
        over = (enable_sum + disable_sum) > total
        if not over.any():
            return mins
        scaled = mins.copy()
        avail = np.maximum(total - disable_sum, 0)
        for i in np.nonzero(enable)[0]:
            for r in np.nonzero(over)[0]:
                if avail[r] <= 0:
                    scaled[i, r] = 0
                elif enable_sum[r] > 0:
                    scaled[i, r] = int(
                        float(avail[r]) * float(mins[i, r]) / float(enable_sum[r])
                    )
        return scaled

    def _redistribute_children(self, parent: QuotaInfo,
                               total: np.ndarray) -> None:
        children = [
            self.quotas[c] for c in parent.children
            if c not in (SYSTEM_QUOTA, DEFAULT_QUOTA)
        ]
        if not children:
            return
        request = np.stack([c.limited_request for c in children])
        min_ = self._scaled_mins(children, total)
        guarantee = np.stack([c.guaranteed for c in children])
        weight = np.stack([c.shared_weight for c in children])
        allow = [c.spec.allow_lent_resource for c in children]
        for r in range(NUM_RESOURCES):
            runtimes = water_filling(
                int(total[r]), request[:, r], min_[:, r], guarantee[:, r],
                weight[:, r], allow,
            )
            for c, rt in zip(children, runtimes):
                c.runtime[r] = rt

    # -- admission ----------------------------------------------------------

    def can_admit(self, name: str, pod_request: np.ndarray,
                  non_preemptible: bool = False) -> bool:
        """PreFilter admission: ``used + podReq <= runtime`` on the pod's
        requested dimensions; a non-preemptible pod also against min
        (plugin.go:210-255). The pod's own group only."""
        info = self.quotas.get(name)
        if info is None:
            return True
        req = np.asarray(pod_request, dtype=np.int64)
        dims = req > 0
        runtime = self.refresh_runtime(name)
        if runtime is None:
            return True
        if np.any((info.used + req)[dims] > runtime[dims]):
            return False
        if non_preemptible and np.any(
                (info.non_preemptible_used + req)[dims] > info.min[dims]):
            return False
        return True
