"""The sequential scheduler, pod by pod over Python scalars (counterpart
of ``koordinator_tpu/oracle/placement.py``).

The reference's scheduleOne cycle (Filter over the nodes, Score, pick the
best, assume it into the cache) with the plugin combination of the
batched solver: the scalar oracle that the vectorized oracle
(``oracle/vectorized.py``), and through it the host route of
``models/placement.PlacementModel``, is held to in the tests.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from koordinator_tpu_torch.oracle.scheduler import (
    fit_filter_node,
    least_allocated_score_node,
    loadaware_filter_node,
    loadaware_score_node,
)
from koordinator_tpu_torch.quota.core import water_filling


def schedule_sequential(
    alloc: np.ndarray,          # [N,R]
    used_req: np.ndarray,       # [N,R] (copied, not mutated)
    usage: np.ndarray,          # [N,R]
    prod_usage: np.ndarray,     # [N,R]
    est_extra: np.ndarray,      # [N,R] (copied)
    prod_base: np.ndarray,      # [N,R] (copied)
    metric_fresh: Sequence[bool],
    schedulable: Sequence[bool],
    pod_req: np.ndarray,        # [P,R]
    pod_est: np.ndarray,        # [P,R]
    pod_is_prod: Sequence[bool],
    pod_is_daemonset: Sequence[bool],
    weights: Sequence[int],
    thresholds: Sequence[int],
    prod_thresholds: Sequence[int],
    fit_weight: int = 1,
    loadaware_weight: int = 1,
    score_according_prod: bool = False,
) -> List[int]:
    """The node index of each pod (-1 = unschedulable), lowest index on a
    tie, each pod seeing every earlier placement."""
    n = alloc.shape[0]
    used_req = used_req.copy()
    est_extra = est_extra.copy()
    prod_base = prod_base.copy()
    assignments: List[int] = []
    for p in range(pod_req.shape[0]):
        best_node, best_score = -1, -1
        for i in range(n):
            if not schedulable[i]:
                continue
            if not fit_filter_node(pod_req[p], alloc[i], used_req[i]):
                continue
            if not loadaware_filter_node(
                alloc[i], usage[i], prod_usage[i], bool(metric_fresh[i]),
                thresholds, prod_thresholds,
                bool(pod_is_daemonset[p]), bool(pod_is_prod[p]),
            ):
                continue
            score = fit_weight * least_allocated_score_node(
                pod_req[p], alloc[i], used_req[i], weights
            ) + loadaware_weight * loadaware_score_node(
                pod_est[p], alloc[i], usage[i], est_extra[i], prod_base[i],
                bool(metric_fresh[i]), weights,
                bool(pod_is_prod[p]), score_according_prod,
            )
            if score > best_score:
                best_node, best_score = i, score
        assignments.append(best_node)
        if best_node >= 0:
            used_req[best_node] += pod_req[p]
            est_extra[best_node] += pod_est[p]
            if pod_is_prod[p]:
                prod_base[best_node] += pod_est[p]
    return assignments


class SequentialQuota:
    """Single-level quota accounting for the scalar oracle, written apart
    from ``quota/core.GroupQuotaManager`` (the tests draw their authority
    from two realisations of the same semantics)."""

    def __init__(self, min_, max_, auto_min, weight, allow_lent, total):
        self.min = np.asarray(min_, dtype=np.int64)
        self.max = np.asarray(max_, dtype=np.int64)
        self.auto_min = np.asarray(auto_min, dtype=np.int64)
        self.weight = np.asarray(weight, dtype=np.int64)
        self.allow_lent = list(allow_lent)
        self.total = np.asarray(total, dtype=np.int64)
        q, r = self.min.shape
        self.child_request = np.zeros((q, r), dtype=np.int64)
        self.used = np.zeros((q, r), dtype=np.int64)
        self.np_used = np.zeros((q, r), dtype=np.int64)

    def register_requests(self, pod_req, quota_ids):
        """OnPodAdd: every pod's request registers with its quota at
        creation, before any scheduling."""
        for p in range(pod_req.shape[0]):
            q = int(quota_ids[p])
            if q >= 0:
                self.child_request[q] += pod_req[p]

    def limited_request(self):
        real = self.child_request.copy()
        for i, lent in enumerate(self.allow_lent):
            if not lent:
                real[i] = np.maximum(real[i], self.min[i])
        return np.minimum(real, self.max)

    def runtime(self):
        req = self.limited_request()
        q, r = req.shape
        runtime = np.zeros((q, r), dtype=np.int64)
        for d in range(r):
            runtime[:, d] = water_filling(
                int(self.total[d]),
                req[:, d],
                self.min[:, d],
                self.auto_min[:, d],
                self.weight[:, d],
                self.allow_lent,
            )
        return np.minimum(runtime, self.max)

    def admit(self, quota_id, pod_req, non_preemptible, runtime_all=None):
        if quota_id < 0:
            return True
        dims = pod_req > 0
        runtime = (
            runtime_all if runtime_all is not None else self.runtime()
        )[quota_id]
        if np.any((self.used[quota_id] + pod_req)[dims] > runtime[dims]):
            return False
        if non_preemptible and np.any(
            (self.np_used[quota_id] + pod_req)[dims] > self.min[quota_id][dims]
        ):
            return False
        return True

    def assume(self, quota_id, pod_req, non_preemptible):
        if quota_id < 0:
            return
        self.used[quota_id] += pod_req
        if non_preemptible:
            self.np_used[quota_id] += pod_req


def schedule_sequential_quota(
    alloc, used_req, usage, prod_usage, est_extra, prod_base,
    metric_fresh, schedulable,
    pod_req, pod_est, pod_is_prod, pod_is_daemonset,
    pod_quota_id, pod_non_preemptible,
    quota: SequentialQuota,
    weights, thresholds, prod_thresholds,
    fit_weight=1, loadaware_weight=1, score_according_prod=False,
) -> List[int]:
    """:func:`schedule_sequential` with the ElasticQuota PreFilter gate
    per pod."""
    n = alloc.shape[0]
    used_req = used_req.copy()
    est_extra = est_extra.copy()
    prod_base = prod_base.copy()
    quota.register_requests(pod_req, pod_quota_id)
    # requests are fixed within a solve: the water-filled runtime is
    # computed once, as the device path computes it once
    runtime_all = quota.runtime()
    assignments: List[int] = []
    for p in range(pod_req.shape[0]):
        if not quota.admit(
            int(pod_quota_id[p]), pod_req[p], bool(pod_non_preemptible[p]),
            runtime_all
        ):
            assignments.append(-1)
            continue
        best_node, best_score = -1, -1
        for i in range(n):
            if not schedulable[i]:
                continue
            if not fit_filter_node(pod_req[p], alloc[i], used_req[i]):
                continue
            if not loadaware_filter_node(
                alloc[i], usage[i], prod_usage[i], bool(metric_fresh[i]),
                thresholds, prod_thresholds,
                bool(pod_is_daemonset[p]), bool(pod_is_prod[p]),
            ):
                continue
            score = fit_weight * least_allocated_score_node(
                pod_req[p], alloc[i], used_req[i], weights
            ) + loadaware_weight * loadaware_score_node(
                pod_est[p], alloc[i], usage[i], est_extra[i], prod_base[i],
                bool(metric_fresh[i]), weights,
                bool(pod_is_prod[p]), score_according_prod,
            )
            if score > best_score:
                best_node, best_score = i, score
        assignments.append(best_node)
        if best_node >= 0:
            used_req[best_node] += pod_req[p]
            est_extra[best_node] += pod_est[p]
            if pod_is_prod[p]:
                prod_base[best_node] += pod_est[p]
            quota.assume(int(pod_quota_id[p]), pod_req[p],
                         bool(pod_non_preemptible[p]))
    return assignments
