"""The sequential scheduler with its node loop vectorized in numpy int64
(counterpart of ``koordinator_tpu/oracle/vectorized.py``).

The semantics of ``oracle/placement.py`` (pod by pod, each pod seeing
every earlier placement, lowest index on a tie) with the inner loop over
the nodes as int64 array arithmetic: exact integers, no float anywhere,
and no torch. ``models/placement.PlacementModel`` runs it as its host
route for tiny plain solves, and :func:`measure_host_fallback_cells
<koordinator_tpu_torch.models.placement.measure_host_fallback_cells>`
prices a cell with it. The tests hold it to the scalar oracle, to the
JAX package's oracles and to the kernel's plain twin.

The sums are int64 where the kernel's wrap in int32: the two agree while
every sum stays inside the int32 range, as the lowering's clipped inputs
keep it for real clusters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from koordinator_tpu_torch.quota.core import water_filling


def _i64(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _host(x) -> np.ndarray:
    """A tensor (one ``.cpu()``, on any device) or an array as numpy."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def oracle_args(state, pods, params) -> tuple:
    """The port's ``(NodeState, PodBatch, ScoreParams)`` as the positional
    numpy arguments of :func:`schedule_vectorized` and the scalar oracle,
    one ``.cpu()`` a field: the one adapter, so callers cannot drift."""
    return tuple(_host(x) for x in (
        state.alloc, state.used_req, state.usage, state.prod_usage,
        state.est_extra, state.prod_base, state.metric_fresh,
        state.schedulable, pods.req, pods.est, pods.is_prod,
        pods.is_daemonset, params.weights, params.thresholds,
        params.prod_thresholds,
    ))


def _percent_rounded(used: np.ndarray, total: np.ndarray) -> np.ndarray:
    """Exact-rational round(used/total*100), half away from zero
    (oracle/scheduler.py percent_rounded, vectorized)."""
    total_safe = np.maximum(total, 1)
    pct = (200 * used + total_safe) // (2 * total_safe)
    return np.where(total > 0, pct, 0)


def _least_requested(requested: np.ndarray, capacity: np.ndarray) -> np.ndarray:
    """(cap-req)*100//cap; 0 when cap==0 or req>cap (load_aware.go:388)."""
    cap_safe = np.maximum(capacity, 1)
    score = (capacity - requested) * 100 // cap_safe
    return np.where((capacity == 0) | (requested > capacity), 0, score)


class VectorQuota:
    """Single-level quota accounting over [Q,R] int64 arrays: the
    semantics of ``oracle/placement.SequentialQuota`` with the per-pod
    admit vectorized."""

    def __init__(self, min_, max_, auto_min, weight, allow_lent, total):
        self.min = _i64(min_)
        self.max = _i64(max_)
        self.auto_min = _i64(auto_min)
        self.weight = _i64(weight)
        self.allow_lent = np.asarray(allow_lent, dtype=bool)
        self.total = _i64(total)
        q, r = self.min.shape
        self.child_request = np.zeros((q, r), dtype=np.int64)
        self.used = np.zeros((q, r), dtype=np.int64)
        self.np_used = np.zeros((q, r), dtype=np.int64)

    def register_requests(self, pod_req, quota_ids):
        quota_ids = np.asarray(quota_ids)
        sel = quota_ids >= 0
        np.add.at(self.child_request, quota_ids[sel], _i64(pod_req)[sel])

    def runtime(self) -> np.ndarray:
        real = self.child_request.copy()
        real[~self.allow_lent] = np.maximum(
            real[~self.allow_lent], self.min[~self.allow_lent]
        )
        req = np.minimum(real, self.max)
        runtime = np.zeros_like(req)
        for d in range(req.shape[1]):
            runtime[:, d] = water_filling(
                int(self.total[d]),
                req[:, d],
                self.min[:, d],
                self.auto_min[:, d],
                self.weight[:, d],
                self.allow_lent,
            )
        return np.minimum(runtime, self.max)

    def admit(self, quota_id, pod_req, non_preemptible, runtime_all):
        if quota_id < 0:
            return True
        dims = pod_req > 0
        if np.any(
            (self.used[quota_id] + pod_req)[dims] > runtime_all[quota_id][dims]
        ):
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


def _numa_score_vec(cap, free, req, most_allocated: bool) -> np.ndarray:
    """[N] NUMA least/most-allocated score (ops/binpack.py
    numa_node_score, itself from nodenumaresource/scoring.go): per
    requested resource ``requested = cap - free + req``; least =
    ``(cap-requested)*100//cap`` (0 when cap==0 or requested>cap); mean
    over requested resources."""
    member = req > 0
    requested = cap - free + req[None, :]
    capq = np.maximum(cap, 1)
    least = (cap - requested) * 100 // capq
    most = requested * 100 // capq
    per = np.where(
        member[None, :] & (cap > 0) & (requested <= cap),
        most if most_allocated else least,
        0,
    )
    w = int(member.sum())
    if w == 0:
        return np.zeros(cap.shape[0], dtype=np.int64)
    return per.sum(axis=-1) // w


def schedule_vectorized(
    alloc,
    used_req,
    usage,
    prod_usage,
    est_extra,
    prod_base,
    metric_fresh,
    schedulable,
    pod_req,
    pod_est,
    pod_is_prod,
    pod_is_daemonset,
    weights,
    thresholds,
    prod_thresholds,
    fit_weight: int = 1,
    loadaware_weight: int = 1,
    score_according_prod: bool = False,
    pod_quota_id=None,
    pod_non_preemptible=None,
    quota: Optional[VectorQuota] = None,
    numa_cap=None,
    numa_free=None,
    pod_has_numa=None,
    numa_node_policy=None,
    numa_most_allocated: bool = False,
    resv_node=None,
    resv_free=None,
    resv_allocate_once=None,
    resv_match=None,
    details: Optional[dict] = None,
) -> np.ndarray:
    """[P] node index per pod (-1 = unschedulable) — identical output to
    oracle/placement.py schedule_sequential / schedule_sequential_quota.

    Optional feature arrays mirror ops/binpack.py solve_batch:

    - NUMA (``numa_cap``/``numa_free`` [N,R], ``pod_has_numa`` [P],
      ``numa_node_policy`` [N]): every pod's score adds the NUMA
      least/most-allocated term; a placed pod with a NUMA policy (its
      own or the node's) consumes ``numa_free`` on the chosen node.
    - Reservations (``resv_node`` [V], ``resv_free`` [V,R],
      ``resv_allocate_once`` [V], ``resv_match`` [P,V]): a pod's
      matched reservations credit their free remainder back on their
      nodes for its Filter/Score; on placement the matched reservation
      with the most free capacity on the chosen node is consumed
      (allocate-once releases its remainder), and only the net request
      lands on the node.

    When ``details`` is a dict, the mutated per-feature end states land
    in it (numa_free, resv_free, numa_consumed, resv_vstar, resv_delta,
    resv_rem) for bit-comparison against the device solver's outputs.
    """
    alloc = _i64(alloc)
    used_req = _i64(used_req).copy()
    usage = _i64(usage)
    prod_usage = _i64(prod_usage)
    est_extra = _i64(est_extra).copy()
    prod_base = _i64(prod_base).copy()
    metric_fresh = np.asarray(metric_fresh, dtype=bool)
    schedulable = np.asarray(schedulable, dtype=bool)
    pod_req = _i64(pod_req)
    pod_est = _i64(pod_est)
    pod_is_prod = np.asarray(pod_is_prod, dtype=bool)
    pod_is_daemonset = np.asarray(pod_is_daemonset, dtype=bool)
    weights = _i64(weights)
    thresholds = _i64(thresholds)
    prod_thresholds = _i64(prod_thresholds)

    use_numa = numa_cap is not None
    if use_numa:
        numa_cap = _i64(numa_cap)
        numa_free = _i64(numa_free).copy()
        pod_has_numa = np.asarray(pod_has_numa, dtype=bool)
        numa_node_policy = np.asarray(numa_node_policy, dtype=bool)
        numa_consumed = np.zeros(pod_req.shape[0], dtype=bool)
    use_resv = resv_node is not None
    if use_resv:
        resv_node = _i64(resv_node)
        resv_free = _i64(resv_free).copy()
        resv_allocate_once = np.asarray(resv_allocate_once, dtype=bool)
        resv_match = np.asarray(resv_match, dtype=bool)
        resv_vstar = np.full(pod_req.shape[0], -1, dtype=np.int64)
        resv_delta = np.zeros_like(_i64(pod_req))
        resv_rem = np.zeros_like(_i64(pod_req))

    # The LoadAware filter reads only static state (usage/prod_usage and
    # the reported allocatable), so the per-node violation masks for both
    # pod modes are computed once for the whole batch (A.1).
    usage_pct = _percent_rounded(usage, alloc)
    prod_pct = _percent_rounded(prod_usage, alloc)
    checkable = alloc > 0
    viol_nonprod = (
        checkable & (thresholds > 0) & (usage_pct >= thresholds)
    ).any(axis=1)
    viol_prod = (
        checkable & (prod_thresholds > 0) & (prod_pct >= prod_thresholds)
    ).any(axis=1)
    prod_cfg = bool((prod_thresholds > 0).any())

    weight_sum = max(int(weights.sum()), 1)
    n = alloc.shape[0]
    n_pods = pod_req.shape[0]
    assignments = np.full(n_pods, -1, dtype=np.int64)
    if n == 0:
        # empty cluster: nothing placeable (solve_batch's shape early-out)
        if quota is not None:
            quota.register_requests(pod_req, pod_quota_id)
        return assignments

    use_q = quota is not None
    runtime_all = None
    if use_q:
        quota.register_requests(pod_req, pod_quota_id)
        runtime_all = quota.runtime()

    def class_cand(req, est, is_prod, is_daemonset, match_row=None):
        """[N] packed candidate vector (score, -1 where infeasible) for
        one pod shape against the CURRENT node state — the same math as
        the per-pod dense pass, vectorized over nodes."""
        u = used_req
        if match_row is not None:
            # matched reservations credit their free remainder back on
            # their nodes for this pod's Filter/Score (fit path only)
            credit = np.zeros_like(used_req)
            sel = np.flatnonzero(match_row)
            np.add.at(credit, resv_node[sel], resv_free[sel])
            u = used_req - credit
        mask = schedulable & (
            (req == 0) | (u + req <= alloc)
        ).all(axis=1)
        if not is_daemonset:
            viol = viol_prod if (is_prod and prod_cfg) else viol_nonprod
            mask = mask & ~(metric_fresh & viol)
        fit_per = _least_requested(u + req, alloc)
        fit_score = (fit_per * weights).sum(axis=1) // weight_sum
        la_base = (
            prod_base
            if (score_according_prod and is_prod)
            else usage + est_extra
        )
        la_per = _least_requested(la_base + est, alloc)
        la_score = np.where(
            metric_fresh, (la_per * weights).sum(axis=1) // weight_sum, 0
        )
        score = fit_weight * fit_score + loadaware_weight * la_score
        if use_numa:
            score = score + _numa_score_vec(
                numa_cap, numa_free, req, numa_most_allocated
            )
        return np.where(mask, score, -1)

    def class_cand_row(i, req, est, is_prod, is_daemonset, match_row=None):
        """The single-node row of class_cand — identical integer math on
        the [R] slice, so a cached vector patched at row i equals a full
        recompute. (Every mutation a placement makes — used_req,
        est_extra, prod_base, numa_free on the chosen node, and
        resv_free of reservations living on that node — lands on a
        single node row, so the single-row patch invariant holds for
        all features.)"""
        a, u = alloc[i], used_req[i]
        if match_row is not None:
            sel = np.flatnonzero(match_row & (resv_node == i))
            if sel.size:
                u = u - resv_free[sel].sum(axis=0)
        ok = bool(schedulable[i]) and bool(
            ((req == 0) | (u + req <= a)).all()
        )
        if ok and not is_daemonset:
            viol = viol_prod if (is_prod and prod_cfg) else viol_nonprod
            ok = not (bool(metric_fresh[i]) and bool(viol[i]))
        if not ok:
            return -1
        fit_per = _least_requested(u + req, a)
        fit_score = int((fit_per * weights).sum()) // weight_sum
        base = (
            prod_base[i]
            if (score_according_prod and is_prod)
            else usage[i] + est_extra[i]
        )
        la_per = _least_requested(base + est, a)
        la_score = (
            int((la_per * weights).sum()) // weight_sum
            if metric_fresh[i]
            else 0
        )
        score = fit_weight * fit_score + loadaware_weight * la_score
        if use_numa:
            score += int(_numa_score_vec(
                numa_cap[i:i + 1], numa_free[i:i + 1], req,
                numa_most_allocated,
            )[0])
        return score

    # Pod-shape cache: a placement mutates exactly ONE node row (every
    # feature's mutations — used_req/est_extra/prod_base, numa_free, and
    # resv_free of reservations living there — land on the chosen node),
    # so a cached class vector stays valid once that row is recomputed.
    # Repair is LAZY: each entry remembers the placement-history index
    # of its last repair and, on reuse, recomputes only the rows placed
    # since — total repair work tracks actual interleaving instead of
    # paying O(cache_size) on every placement.
    CACHE_CAP = 192
    cache = {}
    placed_rows: list = []  # chosen node per placement, in order

    for p in range(n_pods):
        req = pod_req[p]
        est = pod_est[p]
        is_prod = bool(pod_is_prod[p])
        is_ds = bool(pod_is_daemonset[p])
        match_row = resv_match[p] if use_resv else None
        if use_q and not quota.admit(
            int(pod_quota_id[p]), req, bool(pod_non_preemptible[p]), runtime_all
        ):
            continue

        key = (req.tobytes(), est.tobytes(), is_prod, is_ds)
        if use_resv:
            key = key + (match_row.tobytes(),)
        entry = cache.get(key)
        if entry is None:
            cand = class_cand(req, est, is_prod, is_ds, match_row)
            if len(cache) < CACHE_CAP:
                cache[key] = [req, est, is_prod, is_ds, match_row, cand,
                              len(placed_rows)]
        else:
            cand = entry[5]
            for i in set(placed_rows[entry[6]:]):
                cand[i] = class_cand_row(
                    i, entry[0], entry[1], entry[2], entry[3], entry[4]
                )
            entry[6] = len(placed_rows)

        best = int(cand.argmax())  # lowest index among ties
        if cand[best] < 0:
            continue
        assignments[p] = best
        net_req = req
        if use_resv:
            # consume the matched reservation with the most free capacity
            # on the chosen node (first max ties the argmax); an
            # allocate-once reservation releases its remainder
            on_node = match_row & (resv_node == best)
            fsum = np.where(on_node, resv_free.sum(axis=-1), -1)
            v_raw = int(fsum.argmax())
            if fsum[v_raw] > 0:
                delta = np.minimum(resv_free[v_raw], req)
                if resv_allocate_once[v_raw]:
                    rem = resv_free[v_raw] - delta
                    resv_free[v_raw] = 0
                else:
                    rem = np.zeros_like(delta)
                    resv_free[v_raw] = resv_free[v_raw] - delta
                resv_vstar[p] = v_raw
                resv_delta[p] = delta
                resv_rem[p] = rem
                net_req = req - delta - rem
        used_req[best] += net_req
        est_extra[best] += est
        if is_prod:
            prod_base[best] += est
        if use_numa and (
            bool(pod_has_numa[p]) or bool(numa_node_policy[best])
        ):
            numa_free[best] -= req
            numa_consumed[p] = True
        if use_q:
            quota.assume(int(pod_quota_id[p]), req, bool(pod_non_preemptible[p]))
        placed_rows.append(best)
    if details is not None:
        details["used_req"] = used_req
        details["est_extra"] = est_extra
        details["prod_base"] = prod_base
        if use_numa:
            details["numa_free"] = numa_free
            details["numa_consumed"] = numa_consumed
        if use_resv:
            details["resv_free"] = resv_free
            details["resv_vstar"] = resv_vstar
            details["resv_delta"] = resv_delta
            details["resv_rem"] = resv_rem
    return assignments


def solve_full_vectorized(
    state,
    pods,
    params,
    quota: Optional[VectorQuota] = None,
    pod_quota_id=None,
    pod_non_preemptible=None,
    gang_id=None,
    gang_min_member=None,
    gang_bound_count=None,
    gang_strict=None,
    gang_group_id=None,
    numa_aux=None,
    resv=None,
    fit_weight: int = 1,
    loadaware_weight: int = 1,
    score_according_prod: bool = False,
    numa_most_allocated: bool = False,
) -> dict:
    """End-to-end oracle for ops/binpack.py solve_batch with EVERY
    feature enabled: the sequential pass (quota admission, reservation
    credit/consume, NUMA score/consume) followed by the batch-end gang
    resolution and the rejected-pods release of node, reservation, NUMA
    and quota accounting. Returns a dict with ``assign`` (post-gang) and
    the final mutated arrays for bit-comparison against SolveResult.

    ``state``/``pods``/``params`` are the port's structures (tensors on
    any device, one ``.cpu()`` a field); ``numa_aux``/``resv`` the
    solver's NumaAux/ResvArrays.
    """
    details: dict = {}
    kwargs = dict(
        fit_weight=fit_weight,
        loadaware_weight=loadaware_weight,
        score_according_prod=score_according_prod,
        pod_quota_id=pod_quota_id,
        pod_non_preemptible=pod_non_preemptible,
        quota=quota,
        details=details,
    )
    if numa_aux is not None:
        kwargs.update(
            numa_cap=_host(state.numa_cap),
            numa_free=_host(state.numa_free),
            pod_has_numa=_host(pods.has_numa_policy),
            numa_node_policy=_host(numa_aux.node_policy),
            numa_most_allocated=numa_most_allocated,
        )
    if resv is not None:
        kwargs.update(
            resv_node=_host(resv.node),
            resv_free=_host(resv.free),
            resv_allocate_once=_host(resv.allocate_once),
            resv_match=_host(resv.match),
        )
    raw = schedule_vectorized(*oracle_args(state, pods, params), **kwargs)
    out = {"raw_assign": raw, **details}
    if gang_id is None:
        out["assign"] = raw
        return out

    commit, waiting, rejected = gang_outcomes_np(
        raw, gang_id, gang_min_member, gang_bound_count, gang_strict,
        gang_group_id,
    )
    out["assign"] = np.where(commit | waiting, raw, -1)
    out["commit"], out["waiting"], out["rejected"] = commit, waiting, rejected

    # release the rejected Strict pods' holds (solve_batch epilogue)
    pod_req = _i64(_host(pods.req))
    pod_est = _i64(_host(pods.est))
    pod_is_prod = _host(pods.is_prod).astype(bool)
    rel_req = pod_req.copy()
    if resv is not None:
        rel_req = pod_req - details["resv_delta"] - details["resv_rem"]
    for p in np.flatnonzero(rejected):
        b = int(raw[p])
        out["used_req"][b] -= rel_req[p]
        out["est_extra"][b] -= pod_est[p]
        if pod_is_prod[p]:
            out["prod_base"][b] -= pod_est[p]
        if resv is not None and details["resv_vstar"][p] >= 0:
            out["resv_free"][int(details["resv_vstar"][p])] += (
                details["resv_delta"][p] + details["resv_rem"][p]
            )
        if numa_aux is not None and details["numa_consumed"][p]:
            out["numa_free"][b] += pod_req[p]
        if quota is not None and int(pod_quota_id[p]) >= 0:
            q = int(pod_quota_id[p])
            quota.used[q] -= pod_req[p]
            if bool(pod_non_preemptible[p]):
                quota.np_used[q] -= pod_req[p]
    return out


def gang_outcomes_np(
    assignments: np.ndarray,  # [P] raw sequential assignment
    gang_id: np.ndarray,      # [P] int, -1 = not gang-managed
    min_member: np.ndarray,   # [G]
    bound_count=None,         # [G]
    strict=None,              # [G] bool
    group_id=None,            # [G]
) -> tuple:
    """Numpy re-derivation of ``ops/gang.gang_outcomes`` (the batch-end
    resolution): (commit[P], waiting[P], rejected[P])."""
    assignments = np.asarray(assignments)
    gang_id = np.asarray(gang_id)
    min_member = _i64(min_member)
    g = min_member.shape[0]
    bound_count = (
        _i64(bound_count) if bound_count is not None else np.zeros(g, np.int64)
    )
    strict = (
        np.asarray(strict, bool) if strict is not None else np.ones(g, bool)
    )
    group_id = (
        np.asarray(group_id) if group_id is not None else np.arange(g)
    )
    placed = assignments >= 0
    member_placed = placed & (gang_id >= 0)
    placed_per_gang = np.bincount(
        gang_id[member_placed], minlength=g
    ).astype(np.int64)
    valid = (placed_per_gang + bound_count) >= min_member
    group_invalid = np.bincount(
        group_id, weights=(~valid).astype(np.int64), minlength=g
    )
    gang_ok = group_invalid[group_id] == 0
    gid = np.maximum(gang_id, 0)
    pod_gang_ok = gang_ok[gid]
    commit = placed & ((gang_id < 0) | pod_gang_ok)
    waiting = member_placed & ~pod_gang_ok & ~strict[gid]
    rejected = member_placed & ~pod_gang_ok & strict[gid]
    return commit, waiting, rejected
