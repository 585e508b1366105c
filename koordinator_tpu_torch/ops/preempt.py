"""Joint place+evict: vectorised victim selection over the resident world
(counterpart of ``koordinator_tpu/ops/preempt.py``).

The device twin of the host preemption oracle
(``scheduler/preemption.py``: ``select_victims_on_node`` and
``find_preemption``, transliterated from Koordinator's
pkg/scheduler/plugins/elasticquota/preempt.go:103-294). The same decision
is a few vectorised passes over a dense ``[N, P]`` resident-pod world plus
one loop over the resident axis, all torch ops on the tensors' device:

- **candidacy** (canPreempt, preempt.go:276-294): a resident is a
  candidate iff it is preemptible, has strictly lower priority than the
  preemptor, and belongs to the same quota group;
- **remove-all gate**: every candidate is evicted; if the preemptor still
  fails fit, or the node fails the LoadAware filter (usage does not change
  on eviction), the node is out;
- **reprieve in importance order** (priority descending, then earlier
  assignment): candidates are re-added most important first unless the
  preemptor would stop fitting. The world arrives sorted per node in that
  order (``state/cluster.lower_resident_pods``), so the reprieve is a loop
  over the P axis, vectorised over nodes, and the surviving victim mask
  read in column order is the oracle's victim order;
- **constant quota gate** (preempt.go:176-201): ``used + podReq >
  usedLimit`` against the PostFilter snapshot's used; a quota over its
  runtime reprieves nothing;
- **ranking**: fewest victims, then the lowest top victim priority, then
  the host's node iteration order (``node_rank``).

:func:`preempt_scan` runs a whole preemptor batch with the eviction
deltas applied to its carry; :func:`headroom_repack` plans the cheapest
drain that restores a gang-sized hole. Every integer is int32 and wraps as
the reference's x32 arithmetic does: each sum and prefix sum is asked for
int32 (``torch.sum``/``torch.cumsum`` of int32 or bool return int64
otherwise). The loops over P and K launch a handful of small ops per step
and are launch-bound on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from koordinator_tpu_torch.ops.fit import fit_filter
from koordinator_tpu_torch.ops.loadaware import loadaware_filter

I32 = torch.int32
I32_MAX = 2**31 - 1
I32_MIN = -(2**31)


class ResidentWorld(NamedTuple):
    """Dense per-node resident-pod state, sorted per node in importance
    order (priority descending, then earlier assignment). Padding columns
    are ``valid=False`` and inert everywhere."""

    req: torch.Tensor          # [N,P,R] int32 victim requests
    priority: torch.Tensor     # [N,P] int32
    quota_id: torch.Tensor     # [N,P] int32, -3 = padding
    preemptible: torch.Tensor  # [N,P] bool
    valid: torch.Tensor        # [N,P] bool (False = padding or evicted)


class PreemptorBatch(NamedTuple):
    """Preemptor pods for the scanned joint solve (one row per step)."""

    req: torch.Tensor            # [K,R] int32
    priority: torch.Tensor       # [K] int32
    quota_id: torch.Tensor       # [K] int32
    is_daemonset: torch.Tensor   # [K] bool
    is_prod: torch.Tensor        # [K] bool
    quota_used: torch.Tensor     # [K,R] int32 PostFilter-snapshot used
    used_limit: torch.Tensor     # [K,R] int32 runtime (usedLimit)
    quota_enabled: torch.Tensor  # [K] bool: the quota gate is armed
    active: torch.Tensor         # [K] bool: False = padding, a no-op step


def victim_candidacy(world: ResidentWorld, pod_priority: torch.Tensor,
                     pod_quota: torch.Tensor) -> torch.Tensor:
    """canPreempt as an ``[N,P]`` mask (preempt.go:276-294)."""
    return (world.valid & world.preemptible
            & (world.priority < pod_priority)
            & (world.quota_id == pod_quota))


def _reprieve_scan(pod_req, node_alloc, kept0, cand, res_req, quota_blocks):
    """The reprieve loop over the importance-ordered P axis, vectorised
    over nodes: the carry is each node's kept allocation; a candidate is
    reprieved when the preemptor still fits with it re-added and the
    quota gate does not block. Returns ``(kept [N,R], reprieved [N,P])``."""
    kept = kept0
    not_blocked = ~quota_blocks
    reprieved = []
    for j in range(cand.shape[1]):
        trial = kept + res_req[:, j]
        ok = cand[:, j] & fit_filter(pod_req, node_alloc, trial) & not_blocked
        kept = torch.where(ok[:, None], trial, kept)
        reprieved.append(ok)
    return kept, torch.stack(reprieved, dim=1)


def _select_core(pod_req, pod_priority, pod_quota, pod_is_ds, pod_is_prod,
                 quota_used, used_limit, quota_enabled,
                 alloc, used_req, usage, prod_usage, metric_fresh,
                 schedulable, node_rank, thresholds, prod_thresholds,
                 world: ResidentWorld):
    """One preemptor against the whole world; shared by the per-pod entry
    and the scanned solve so the two cannot disagree on a step."""
    cand = victim_candidacy(world, pod_priority, pod_quota)
    has_cand = cand.any(dim=1)                              # [N]
    removed = torch.where(cand[..., None], world.req, 0).sum(
        dim=1, dtype=I32)                                   # [N,R]
    la_ok = loadaware_filter(alloc, usage, prod_usage, metric_fresh,
                             thresholds, prod_thresholds, pod_is_ds,
                             pod_is_prod)
    kept0 = used_req - removed
    fit_all = fit_filter(pod_req, alloc, kept0)
    # the quota gate is constant across the reprieve (preempt.go:191-199)
    quota_blocks = quota_enabled & (
        (pod_req > 0) & (quota_used + pod_req > used_limit)).any()
    node_ok = schedulable & has_cand & la_ok & fit_all
    _, reprieved = _reprieve_scan(pod_req, alloc, kept0, cand, world.req,
                                  quota_blocks)
    victims = cand & ~reprieved
    n_victims = victims.sum(dim=1, dtype=I32)
    feasible = node_ok & (n_victims > 0)
    top_prio = torch.where(victims, world.priority, I32_MIN).amax(dim=1)
    # lexicographic rank in int32 stages: fewest victims, lowest top
    # priority, host iteration order (argmin takes the first minimum)
    nv_key = torch.where(feasible, n_victims, I32_MAX)
    tie1 = feasible & (n_victims == nv_key.min())
    tp_key = torch.where(tie1, top_prio, I32_MAX)
    tie2 = tie1 & (top_prio == tp_key.min())
    rank_key = torch.where(tie2, node_rank, I32_MAX)
    best = torch.where(feasible.any(), torch.argmin(rank_key).to(I32), -1)
    return best, victims, cand, n_victims


def select_victims(
    pod_req: torch.Tensor,          # [R] int32
    pod_priority: torch.Tensor,     # [] int32
    pod_quota: torch.Tensor,        # [] int32
    pod_is_ds: torch.Tensor,        # [] bool
    pod_is_prod: torch.Tensor,      # [] bool
    quota_used: torch.Tensor,       # [R] int32
    used_limit: torch.Tensor,       # [R] int32
    quota_enabled: torch.Tensor,    # [] bool
    alloc: torch.Tensor,            # [N,R] int32
    used_req: torch.Tensor,         # [N,R] int32
    usage: torch.Tensor,            # [N,R] int32
    prod_usage: torch.Tensor,       # [N,R] int32
    metric_fresh: torch.Tensor,     # [N] bool
    schedulable: torch.Tensor,      # [N] bool
    node_rank: torch.Tensor,        # [N] int32 host iteration order
    thresholds: torch.Tensor,       # [R] int32
    prod_thresholds: torch.Tensor,  # [R] int32
    world: ResidentWorld,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-cluster victim selection for one preemptor.

    Returns ``(best_node [], victims [N,P], candidates [N,P], n_victims
    [N])``; ``best_node`` is -1 when no node is viable, and the best row
    of ``victims`` read along P is the oracle's ordered victim list."""
    return _select_core(
        pod_req, pod_priority, pod_quota, pod_is_ds, pod_is_prod,
        quota_used, used_limit, quota_enabled, alloc, used_req, usage,
        prod_usage, metric_fresh, schedulable, node_rank, thresholds,
        prod_thresholds, world)


def preempt_scan(
    pods: PreemptorBatch,
    alloc: torch.Tensor,            # [N,R] int32
    used_req0: torch.Tensor,        # [N,R] int32
    usage: torch.Tensor,            # [N,R]
    prod_usage: torch.Tensor,       # [N,R]
    metric_fresh: torch.Tensor,     # [N]
    schedulable: torch.Tensor,      # [N]
    node_rank: torch.Tensor,        # [N] int32
    thresholds: torch.Tensor,       # [R]
    prod_thresholds: torch.Tensor,  # [R]
    world: ResidentWorld,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The joint place+evict solve over a preemptor batch: a loop over K
    whose carry is the eviction-adjusted world. Each step runs
    :func:`_select_core` and, on a hit, takes the victims out of the carry
    (the chosen row's ``used_req`` decremented, its columns invalidated),
    all on the device with no read-back. The quota rows are the
    PostFilter snapshot's, held for the batch: equal to the per-pod path
    whenever the preemptors' quota groups do not overlap.

    Returns ``(best_node [K] int32 (-1 = none), victims [K,P] bool)``:
    ``victims[k]`` is the chosen row's victim mask for preemptor k."""
    used_req = used_req0.clone()
    valid = world.valid.clone()
    bests, cols = [], []
    for k in range(pods.req.shape[0]):
        best, victims, _, _ = _select_core(
            pods.req[k], pods.priority[k], pods.quota_id[k],
            pods.is_daemonset[k], pods.is_prod[k], pods.quota_used[k],
            pods.used_limit[k], pods.quota_enabled[k], alloc, used_req,
            usage, prod_usage, metric_fresh, schedulable, node_rank,
            thresholds, prod_thresholds, world._replace(valid=valid))
        hit = pods.active[k] & (best >= 0)
        b = best.clamp(min=0).reshape(1).long()
        row_victims = victims.index_select(0, b)[0] & hit     # [P]
        freed = torch.where(row_victims[:, None],
                            world.req.index_select(0, b)[0], 0).sum(
                                dim=0, dtype=I32)           # [R]
        used_req = used_req.index_add(0, b, -freed[None])
        valid = valid.index_copy(
            0, b, valid.index_select(0, b) & ~row_victims[None])
        bests.append(torch.where(hit, best, -1))
        cols.append(row_victims)
    if not bests:
        p = world.valid.shape[1]
        return (torch.zeros(0, dtype=I32, device=alloc.device),
                torch.zeros((0, p), dtype=torch.bool, device=alloc.device))
    return torch.stack(bests), torch.stack(cols)


def headroom_repack(
    target_req: torch.Tensor,           # [R] int32 the hole to restore
    max_victim_priority: torch.Tensor,  # [] int32 drain only below this
    alloc: torch.Tensor,                # [N,R] int32
    used_req: torch.Tensor,             # [N,R] int32
    schedulable: torch.Tensor,          # [N] bool
    node_rank: torch.Tensor,            # [N] int32
    world: ResidentWorld,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Defrag planner: the cheapest node to drain until ``target_req``
    fits. Drain candidates are preemptible residents strictly below
    ``max_victim_priority``, drained least important first (the reversed
    P axis): the freed prefix is one int32 ``cumsum`` and the least drain
    count per node one masked ``min``.

    Returns ``(best_node [] int32 (-1 = none), drain_mask [N,P], n_drain
    [N] int32 (I32_MAX = cannot restore the hole), fits_now [N] bool)``;
    nodes where the hole already fits are not drain targets."""
    cand = (world.valid & world.preemptible
            & (world.priority < max_victim_priority))       # [N,P]
    fits_now = fit_filter(target_req, alloc, used_req)      # [N]
    # position j of the reversed axis drains the j+1 least important
    # slots (a non-candidate contributes nothing)
    cand_rev = cand.flip(1)
    req_rev = torch.where(cand_rev[..., None], world.req.flip(1), 0)
    freed = torch.cumsum(req_rev, dim=1, dtype=I32)          # [N,P,R]
    ncand = torch.cumsum(cand_rev, dim=1, dtype=I32)         # [N,P]
    remain = used_req[:, None, :] - freed                   # [N,P,R]
    fits_j = ((target_req == 0)
              | (remain + target_req <= alloc[:, None, :])).all(dim=-1)
    # only positions that drained a candidate are plans (a non-candidate
    # slot repeats the previous prefix)
    plan = fits_j & cand_rev
    n_drain = torch.where(plan, ncand, I32_MAX).amin(dim=1)
    n_drain = torch.where(fits_now, 0, n_drain)
    feasible = schedulable & ~fits_now & (n_drain < I32_MAX)
    nd_key = torch.where(feasible, n_drain, I32_MAX)
    tie = feasible & (n_drain == nd_key.min())
    rank_key = torch.where(tie, node_rank, I32_MAX)
    best = torch.where(feasible.any(), torch.argmin(rank_key).to(I32), -1)
    drain_rev = cand_rev & (ncand <= n_drain[:, None])
    return best, drain_rev.flip(1), n_drain, fits_now
