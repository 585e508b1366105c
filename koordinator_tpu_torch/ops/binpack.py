"""Batched pod placement as a per-pod torch loop (counterpart of
``koordinator_tpu/ops/binpack.py``).

For each pending pod in schedule order, vectorized over the node axis:

    mask  = schedulable & fit_filter & loadaware_filter & admit   # [N]
    score = fit_weight * LeastAllocated + loadaware_weight * LoadAware
    node  = first argmax of where(mask, score, -1)
    state += pod (request into used_req, estimate into est_extra)

This is the reference's ``lax.scan`` solver written as a loop: the route
for configurations the hand-written kernel (ops/binpack_kernel.py) does
not take, and for solves that carry host ``Extras`` rows. Gangs resolve
at batch end (:func:`resolve_gangs`), shared with the kernel path.
Reservations and NUMA belong to a later slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from koordinator_tpu_torch.ops.common import I32
from koordinator_tpu_torch.ops.fit import fit_filter, least_allocated_score
from koordinator_tpu_torch.ops.gang import (
    gang_outcomes,
    release_rejected,
    segment_sum,
)
from koordinator_tpu_torch.ops.loadaware import loadaware_filter, loadaware_score


class SolverConfig(NamedTuple):
    """Static solver configuration."""

    fit_weight: int = 1          # NodeResourcesFit LeastAllocated weight
    loadaware_weight: int = 1    # LoadAwareScheduling weight
    score_according_prod: bool = False


class NodeState(NamedTuple):
    """Node-side solver state, ``[N, R]`` int32 and ``[N]`` bool."""

    alloc: torch.Tensor         # [N,R]
    used_req: torch.Tensor      # [N,R] assigned pod requests (updated)
    usage: torch.Tensor         # [N,R] reported usage
    prod_usage: torch.Tensor    # [N,R] prod Filter base
    est_extra: torch.Tensor     # [N,R] assigned-pod estimation correction
    prod_base: torch.Tensor     # [N,R] prod-mode score base
    metric_fresh: torch.Tensor  # [N] bool
    schedulable: torch.Tensor   # [N] bool


class PodBatch(NamedTuple):
    """Pending pods in schedule order."""

    req: torch.Tensor              # [P,R] int32
    est: torch.Tensor              # [P,R] int32
    is_prod: torch.Tensor          # [P] bool
    is_daemonset: torch.Tensor     # [P] bool
    quota_id: torch.Tensor         # [P] int32, -1 = not quota-managed
    non_preemptible: torch.Tensor  # [P] bool
    gang_id: torch.Tensor          # [P] int32, -1 = not gang-managed
    blocked: torch.Tensor          # [P] bool, host-side hard reject

    @classmethod
    def build(cls, req, est, is_prod, is_daemonset, quota_id=None,
              non_preemptible=None, gang_id=None, blocked=None) -> "PodBatch":
        p, dev = req.shape[0], req.device

        def minus_ones():
            return torch.full((p,), -1, dtype=I32, device=dev)

        def falses():
            return torch.zeros(p, dtype=torch.bool, device=dev)

        return cls(
            req=req, est=est, is_prod=is_prod, is_daemonset=is_daemonset,
            quota_id=quota_id if quota_id is not None else minus_ones(),
            non_preemptible=(non_preemptible if non_preemptible is not None
                             else falses()),
            gang_id=gang_id if gang_id is not None else minus_ones(),
            blocked=blocked if blocked is not None else falses(),
        )


class ScoreParams(NamedTuple):
    """Per-solve scoring parameters, ``[R]`` int32."""

    weights: torch.Tensor          # resource weights
    thresholds: torch.Tensor       # LoadAware usage thresholds (%)
    prod_thresholds: torch.Tensor  # LoadAware prod-usage thresholds (%)


class Extras(NamedTuple):
    """Host-computed per-pod x node feasibility and score rows."""

    mask: torch.Tensor   # [P,N] bool
    score: torch.Tensor  # [P,N] int32, added to feasible nodes' scores


class SolveResult(NamedTuple):
    """Everything one batched solve produces. ``assign`` is the node of
    each committed or waiting pod (-1 else); ``raw_assign`` the loop's
    placement before gang resolution."""

    node_state: NodeState
    quota_state: Optional[object]  # QuotaState when quotas are present
    assign: torch.Tensor           # [P] int32
    commit: torch.Tensor           # [P] bool
    waiting: torch.Tensor          # [P] bool
    rejected: torch.Tensor         # [P] bool
    raw_assign: torch.Tensor       # [P] int32


def score_one_pod(state: NodeState, req, est, is_prod, is_daemonset,
                  params: ScoreParams, config: SolverConfig) -> tuple:
    """``(mask[N], score[N])`` for one pod against every node."""
    mask = (
        state.schedulable
        & fit_filter(req, state.alloc, state.used_req)
        & loadaware_filter(
            state.alloc, state.usage, state.prod_usage, state.metric_fresh,
            params.thresholds, params.prod_thresholds, is_daemonset, is_prod,
        )
    )
    score = config.fit_weight * least_allocated_score(
        req, state.alloc, state.used_req, params.weights
    ) + config.loadaware_weight * loadaware_score(
        est, state.alloc, state.usage, state.est_extra, state.prod_base,
        state.metric_fresh, params.weights, is_prod,
        config.score_according_prod,
    )
    return mask, score


def resolve_gangs(node_state: NodeState, quota_state, assign, pods: PodBatch,
                  gang_state) -> SolveResult:
    """The batch-end tail shared by the loop and the kernel: gang
    outcomes, then release of rejected pods' node holds and quota usage.
    Without gangs every placed pod commits."""
    if gang_state is None:
        falses = torch.zeros_like(assign, dtype=torch.bool)
        return SolveResult(node_state, quota_state, assign, assign >= 0,
                           falses, falses, assign)
    commit, waiting, rejected = gang_outcomes(assign, pods.gang_id, gang_state)
    used_req, est_extra, prod_base = release_rejected(
        node_state.used_req, node_state.est_extra, node_state.prod_base,
        assign, rejected, pods.req, pods.est, pods.is_prod,
    )
    node_state = node_state._replace(
        used_req=used_req, est_extra=est_extra, prod_base=prod_base
    )
    out_assign = torch.where(commit | waiting, assign, -1)
    if quota_state is not None:
        q = quota_state.used.shape[0]
        take = rejected & (pods.quota_id >= 0)
        qidx = torch.where(take, pods.quota_id,
                           torch.full_like(pods.quota_id, q)).long()
        rel = torch.where(take[:, None], pods.req, 0)
        np_rel = torch.where(pods.non_preemptible[:, None], rel, 0)
        quota_state = quota_state._replace(
            used=quota_state.used - segment_sum(rel, qidx, q),
            np_used=quota_state.np_used - segment_sum(np_rel, qidx, q),
        )
    return SolveResult(node_state, quota_state, out_assign, commit, waiting,
                       rejected, assign)


def solve_batch(state: NodeState, pods: PodBatch, params: ScoreParams,
                config: SolverConfig = SolverConfig(), quota_state=None,
                gang_state=None, extras: Optional[Extras] = None, resv=None,
                numa=None) -> SolveResult:
    """Place a whole pending queue, pod by pod, with quota admission,
    host extras and batch-end gang resolution. Bit-identical to the
    reference's ``solve_batch`` on the same inputs."""
    if resv is not None or numa is not None:
        raise NotImplementedError(
            "reservations and NUMA are a later slice of the port "
            "(ops/binpack.py ResvArrays/NumaAux)"
        )
    n_pods = pods.req.shape[0]
    if state.alloc.shape[0] == 0:
        empty = torch.full((n_pods,), -1, dtype=I32, device=pods.req.device)
        falses = torch.zeros(n_pods, dtype=torch.bool, device=pods.req.device)
        return SolveResult(state, quota_state, empty, falses, falses, falses,
                           empty)
    runtime = None
    if quota_state is not None:
        from koordinator_tpu_torch.ops.quota import (
            quota_admit,
            quota_assume,
            quota_runtime,
        )

        runtime = quota_runtime(quota_state)
    ns, qs = state, quota_state
    nodes = []
    for i in range(n_pods):
        req, est, is_prod = pods.req[i], pods.est[i], pods.is_prod[i]
        mask, score = score_one_pod(ns, req, est, is_prod,
                                    pods.is_daemonset[i], params, config)
        if extras is not None:
            mask = mask & extras.mask[i]
            score = score + extras.score[i]
        admit = ~pods.blocked[i]
        if qs is not None:
            admit = admit & quota_admit(qs, runtime, pods.quota_id[i], req,
                                        pods.non_preemptible[i])
        masked = torch.where(mask & admit, score, -1)
        best = torch.argmax(masked).reshape(1)  # first max: smallest node
        ok = masked.max() >= 0
        node = torch.where(ok, best[0], -1).to(I32)
        add_req = torch.where(ok, req, 0)[None, :]
        add_est = torch.where(ok, est, 0)[None, :]
        add_prod = torch.where(is_prod, add_est, 0)
        ns = ns._replace(
            used_req=ns.used_req.index_add(0, best, add_req),
            est_extra=ns.est_extra.index_add(0, best, add_est),
            prod_base=ns.prod_base.index_add(0, best, add_prod),
        )
        if qs is not None:
            qs = quota_assume(qs, pods.quota_id[i], req,
                              pods.non_preemptible[i], node >= 0)
        nodes.append(node)
    assign = torch.stack(nodes) if nodes else torch.full(
        (0,), -1, dtype=I32, device=pods.req.device)
    return resolve_gangs(ns, qs, assign, pods, gang_state)
