"""Batched pod placement as a per-pod torch loop (counterpart of
``koordinator_tpu/ops/binpack.py``).

For each pending pod in schedule order, vectorized over the node axis:

    mask  = schedulable & fit_filter & loadaware_filter & admit   # [N]
    score = fit_weight * LeastAllocated + loadaware_weight * LoadAware
            (+ the NUMA score with ``NumaAux``)
    node  = first argmax of where(mask, score, -1)
    state += pod (request into used_req, estimate into est_extra)

With ``ResvArrays`` the pod's matched reservations' free remainders are
credited back on their nodes for the fit path (``used_req - credit``;
LoadAware does not see it), and the pod consumes the most-free matched
reservation on the node it lands on. With ``NumaAux`` the NUMA
least/most-allocated score over ``numa_cap``/``numa_free`` is added, and
a pod placed where it or the node declares a topology policy takes its
request out of ``numa_free``.

This is the reference's ``lax.scan`` solver written as a loop: the route
for configurations the hand-written kernel (ops/binpack_kernel.py) does
not take (non-unit plugin weights, prod-usage thresholds and scoring,
score-unsafe reservation or extras tables, more than 65,536 nodes). The
kernel takes host ``Extras`` rows in compact form (:class:`ExtrasRows`);
this loop expands them to the dense form. Gangs resolve
at batch end (:func:`resolve_gangs`), shared with the kernel path.

:func:`scatter_node_rows` writes re-lowered node rows into a staged
``NodeState``: the device half of incremental staging. The reference's
is an XLA ``.at[idx].set`` outside any Pallas kernel, so here it is a
plain torch op. The reference pads the dirty-row count to power-of-two
buckets (``bucket_row_update``/``dirty_row_bucket``) so drifting counts
share one compiled XLA scatter; eager PyTorch compiles nothing, so they
are not ported (the scatter's result is the same without them).
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
    numa_most_allocated: bool = False  # NUMA scorer: MostAllocated vs Least


class NodeState(NamedTuple):
    """Node-side solver state, ``[N, R]`` int32 and ``[N]`` bool.
    ``numa_cap``/``numa_free`` are the aggregated NUMA inventories (None
    unless the solve scores NUMA)."""

    alloc: torch.Tensor         # [N,R]
    used_req: torch.Tensor      # [N,R] assigned pod requests (updated)
    usage: torch.Tensor         # [N,R] reported usage
    prod_usage: torch.Tensor    # [N,R] prod Filter base
    est_extra: torch.Tensor     # [N,R] assigned-pod estimation correction
    prod_base: torch.Tensor     # [N,R] prod-mode score base
    metric_fresh: torch.Tensor  # [N] bool
    schedulable: torch.Tensor   # [N] bool
    numa_cap: Optional[torch.Tensor] = None   # [N,R] Σ NUMA-node allocatable
    numa_free: Optional[torch.Tensor] = None  # [N,R] Σ NUMA-node free


#: the NodeState columns an incremental staging update rewrites (the
#: NUMA inventories ride the fine-grained path, which always restages)
STAGED_NODE_FIELDS = (
    "alloc", "used_req", "usage", "prod_usage", "est_extra", "prod_base",
    "metric_fresh", "schedulable",
)


def scatter_node_rows(state: NodeState, idx: torch.Tensor, rows,
                      in_place: bool) -> NodeState:
    """Write the dirty nodes' re-lowered rows into a staged ``NodeState``
    at ``idx`` (int64, on the state's device); ``rows`` maps each
    :data:`STAGED_NODE_FIELDS` name to its ``[D, ...]`` update there.
    ``in_place`` writes into ``state``'s tensors (``index_copy_``, the
    reference's donated scatter) and returns ``state``; otherwise a new
    generation is written beside it (``index_copy``) and ``state`` is
    left as it was, for a solve that still holds it."""
    if in_place:
        for f in STAGED_NODE_FIELDS:
            getattr(state, f).index_copy_(0, idx, rows[f])
        return state
    return state._replace(**{
        f: getattr(state, f).index_copy(0, idx, rows[f])
        for f in STAGED_NODE_FIELDS
    })


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
    #: [P] bool, the pod declares its own NUMA topology policy; with
    #: NumaAux it consumes numa_free wherever it lands (None = no pod does)
    has_numa_policy: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, req, est, is_prod, is_daemonset, quota_id=None,
              non_preemptible=None, gang_id=None, blocked=None,
              has_numa_policy=None) -> "PodBatch":
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
            has_numa_policy=has_numa_policy,
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


class ExtrasRows(NamedTuple):
    """:class:`Extras` in compact form: only the pods that have a row
    appear, and pods whose rows are equal may share one. Pod ``p`` reads
    row ``row_of_pod[p]`` (-1: no row, every node feasible, score 0)."""

    row_of_pod: torch.Tensor  # [P] int32
    mask: torch.Tensor        # [X,N] bool
    score: torch.Tensor       # [X,N] int32

    def dense(self) -> Extras:
        """The same rows as ``[P,N]`` :class:`Extras`, bit for bit."""
        has = self.row_of_pod >= 0
        row = torch.clamp(self.row_of_pod, min=0).long()
        if self.mask.shape[0] == 0:
            p, n = self.row_of_pod.shape[0], self.mask.shape[1]
            return Extras(
                mask=torch.ones((p, n), dtype=torch.bool,
                                device=self.mask.device),
                score=torch.zeros((p, n), dtype=I32, device=self.mask.device))
        return Extras(
            mask=torch.where(has[:, None], self.mask.index_select(0, row),
                             True),
            score=torch.where(has[:, None], self.score.index_select(0, row),
                              0).to(I32))


class ResvArrays(NamedTuple):
    """Reservations of one solve: the Available ones with a free
    remainder, and which pending pods own each."""

    node: torch.Tensor           # [V] int32 node index of each reservation
    free: torch.Tensor           # [V,R] int32 free remainder
    allocate_once: torch.Tensor  # [V] bool
    match: torch.Tensor          # [P,V] bool pod <-> reservation owner match


class NumaAux(NamedTuple):
    """Turns on NUMA scoring and consumption (needs ``NodeState.numa_cap``
    and ``numa_free``)."""

    node_policy: torch.Tensor  # [N] bool, the node declares a topology policy


class SolveResult(NamedTuple):
    """Everything one batched solve produces. ``assign`` is the node of
    each committed or waiting pod (-1 else); ``raw_assign`` the loop's
    placement before gang resolution. With reservations, ``resv_free`` is
    the final free table and ``resv_vstar``/``resv_delta`` name the
    reservation each pod consumed (-1) and how much; with NUMA,
    ``numa_consumed`` says which pods took their request out of
    ``numa_free``."""

    node_state: NodeState
    quota_state: Optional[object]  # QuotaState when quotas are present
    assign: torch.Tensor           # [P] int32
    commit: torch.Tensor           # [P] bool
    waiting: torch.Tensor          # [P] bool
    rejected: torch.Tensor         # [P] bool
    raw_assign: torch.Tensor       # [P] int32
    resv_free: Optional[torch.Tensor] = None      # [V,R] int32
    resv_vstar: Optional[torch.Tensor] = None     # [P] int32, -1 = none
    resv_delta: Optional[torch.Tensor] = None     # [P,R] int32
    numa_consumed: Optional[torch.Tensor] = None  # [P] bool


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


def numa_node_score(cap: torch.Tensor, free: torch.Tensor, req: torch.Tensor,
                    config: SolverConfig) -> torch.Tensor:
    """``[N]`` NUMA least/most-allocated score: per requested resource,
    ``requested = cap - free + req``; least ``(cap - requested)*100 //
    cap``, most ``requested*100 // cap``, 0 where cap is 0 or requested
    exceeds it; the floor mean over the requested resources."""
    member = req > 0
    requested = cap - free + req
    numer = requested if config.numa_most_allocated else cap - requested
    per = torch.div(numer * 100, torch.clamp(cap, min=1), rounding_mode="floor")
    per = torch.where(member & (cap > 0) & (requested <= cap), per, 0)
    w = member.sum(dtype=I32)
    mean = torch.div(per.sum(dim=-1, dtype=I32), torch.clamp(w, min=1),
                     rounding_mode="floor")
    return torch.where(w > 0, mean, 0)


def resolve_gangs(node_state: NodeState, quota_state, assign, pods: PodBatch,
                  gang_state, resv_out=None, numa_consumed=None) -> SolveResult:
    """The batch-end tail shared by the loop and the kernel: gang
    outcomes, then release of rejected pods' node holds, reservation
    consumption, NUMA holds and quota usage. Without gangs every placed
    pod commits. ``resv_out`` is ``(vstar[P], delta[P,R], rem[P,R],
    free[V,R])``: ``rem`` is the remainder an ``allocate_once``
    reservation released when it was consumed."""
    vstar = delta = rem = rfree = None
    if resv_out is not None:
        vstar, delta, rem, rfree = resv_out
    if gang_state is None:
        falses = torch.zeros_like(assign, dtype=torch.bool)
        return SolveResult(node_state, quota_state, assign, assign >= 0,
                           falses, falses, assign, rfree, vstar, delta,
                           numa_consumed)
    commit, waiting, rejected = gang_outcomes(assign, pods.gang_id, gang_state)
    # a rejected pod held only its net request (the reservation's delta
    # and released remainder were taken off its hold): release that
    rel_req = pods.req if resv_out is None else pods.req - delta - rem
    used_req, est_extra, prod_base = release_rejected(
        node_state.used_req, node_state.est_extra, node_state.prod_base,
        assign, rejected, rel_req, pods.est, pods.is_prod,
    )
    node_state = node_state._replace(
        used_req=used_req, est_extra=est_extra, prod_base=prod_base
    )
    if numa_consumed is not None:
        n = node_state.used_req.shape[0]
        take = rejected & numa_consumed
        nidx = torch.where(take, assign, n).long()
        back = torch.where(take[:, None], pods.req, 0)
        node_state = node_state._replace(
            numa_free=node_state.numa_free + segment_sum(back, nidx, n))
    if resv_out is not None:
        # give rejected pods' consumption (and a released remainder) back
        v = rfree.shape[0]
        take = rejected & (vstar >= 0)
        vidx = torch.where(take, vstar, v).long()
        back = torch.where(take[:, None], delta + rem, 0)
        rfree = rfree + segment_sum(back, vidx, v)
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
                       rejected, assign, rfree, vstar, delta, numa_consumed)


def solve_batch(state: NodeState, pods: PodBatch, params: ScoreParams,
                config: SolverConfig = SolverConfig(), quota_state=None,
                gang_state=None, extras=None,
                resv: Optional[ResvArrays] = None,
                numa: Optional[NumaAux] = None) -> SolveResult:
    """Place a whole pending queue, pod by pod, with quota admission,
    host extras (:class:`Extras`, or :class:`ExtrasRows` expanded to it),
    reservation credit and consumption, NUMA scoring and consumption, and
    batch-end gang resolution. Bit-identical to the reference's
    ``solve_batch`` on the same inputs."""
    if isinstance(extras, ExtrasRows):
        extras = extras.dense()
    n_pods = pods.req.shape[0]
    dev = pods.req.device
    if numa is not None and (state.numa_cap is None or state.numa_free is None):
        raise ValueError("numa needs NodeState.numa_cap and numa_free")
    if state.alloc.shape[0] == 0:
        empty = torch.full((n_pods,), -1, dtype=I32, device=dev)
        falses = torch.zeros(n_pods, dtype=torch.bool, device=dev)
        return SolveResult(
            state, quota_state, empty, falses, falses, falses, empty,
            resv.free if resv is not None else None,
            empty if resv is not None else None,
            torch.zeros_like(pods.req) if resv is not None else None,
            falses if numa is not None else None,
        )
    runtime = None
    if quota_state is not None:
        from koordinator_tpu_torch.ops.quota import (
            quota_admit,
            quota_assume,
            quota_runtime,
        )

        runtime = quota_runtime(quota_state)
    pod_numa = pods.has_numa_policy
    if numa is not None and pod_numa is None:
        pod_numa = torch.zeros(n_pods, dtype=torch.bool, device=dev)
    rfree = resv.free if resv is not None else None
    rnode = resv.node.long() if resv is not None else None
    ns, qs = state, quota_state
    nodes, vstars, deltas, rems, consumed = [], [], [], [], []
    for i in range(n_pods):
        req, est, is_prod = pods.req[i], pods.est[i], pods.is_prod[i]
        eff = ns
        if resv is not None:
            match = resv.match[i]
            credit = torch.zeros_like(ns.used_req).index_add(
                0, rnode, torch.where(match[:, None], rfree, 0))
            eff = ns._replace(used_req=ns.used_req - credit)
        mask, score = score_one_pod(eff, req, est, is_prod,
                                    pods.is_daemonset[i], params, config)
        if numa is not None:
            score = score + numa_node_score(ns.numa_cap, ns.numa_free, req,
                                            config)
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
        add_req = torch.where(ok, req, 0)
        add_est = torch.where(ok, est, 0)[None, :]
        net_req = add_req
        if resv is not None:
            # consume the most-free matched reservation on the chosen
            # node (first max: smallest reservation index); an
            # allocate_once reservation releases its remainder with it
            on_node = match & (rnode == best) & ok
            fsum = torch.where(on_node, rfree.sum(dim=-1, dtype=I32), -1)
            v = torch.argmax(fsum).reshape(1)
            row = rfree.index_select(0, v)[0]
            has = fsum.index_select(0, v)[0] > 0
            delta = torch.where(has, torch.minimum(row, req), 0)
            once = has & resv.allocate_once.index_select(0, v)[0]
            rem = torch.where(once, row - delta, 0)
            new_row = torch.where(has, torch.where(once, 0, row - delta), row)
            rfree = rfree.index_copy(0, v, new_row[None, :])
            vstars.append(torch.where(has, v[0], -1).to(I32))
            deltas.append(delta)
            rems.append(rem)
            net_req = net_req - delta - rem
        add_prod = torch.where(is_prod, add_est, 0)
        ns = ns._replace(
            used_req=ns.used_req.index_add(0, best, net_req[None, :]),
            est_extra=ns.est_extra.index_add(0, best, add_est),
            prod_base=ns.prod_base.index_add(0, best, add_prod),
        )
        if numa is not None:
            consume = ok & (pod_numa[i] | numa.node_policy.index_select(0, best)[0])
            ns = ns._replace(numa_free=ns.numa_free.index_add(
                0, best, -torch.where(consume, req, 0)[None, :]))
            consumed.append(consume)
        if qs is not None:
            qs = quota_assume(qs, pods.quota_id[i], req,
                              pods.non_preemptible[i], node >= 0)
        nodes.append(node)

    def stack(rows, empty_shape, dtype):
        return (torch.stack(rows) if rows
                else torch.zeros(empty_shape, dtype=dtype, device=dev))

    assign = stack(nodes, (0,), I32)
    resv_out = None
    if resv is not None:
        resv_out = (stack(vstars, (0,), I32), stack(deltas, pods.req.shape, I32),
                    stack(rems, pods.req.shape, I32), rfree)
    numa_consumed = (stack(consumed, (0,), torch.bool) if numa is not None
                     else None)
    return resolve_gangs(ns, qs, assign, pods, gang_state, resv_out,
                         numa_consumed)
