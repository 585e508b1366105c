"""ElasticQuota PostFilter preemption on the host: evict lower-priority
pods of the same quota group to make room (counterpart of
``koordinator_tpu/scheduler/preemption.py``; reference
pkg/scheduler/plugins/elasticquota/preempt.go:103-294).

The parity authority of the device path (``ops/preempt.py``), and the
Scheduler's ``preemption_backend="host"`` (and half of ``"verify"``).
Semantics of ``SelectVictimsOnNode``:

- a pod can preempt a victim iff the victim is preemptible, has lower
  priority, and belongs to the same quota group (``canPreempt``,
  preempt.go:276-294);
- per node: remove every candidate; if the pod still does not fit, the
  node is out; otherwise reprieve victims from the most important down
  (priority descending, then earlier assignment: util.MoreImportantPod),
  re-adding each unless (a) the pod no longer fits with it back, or (b)
  the quota's ``used + podReq`` exceeds its ``usedLimit`` (runtime),
  checked against the PostFilter snapshot's used, so a quota over its
  runtime reprieves nothing (preempt.go:176-201);
- PodDisruptionBudget grouping (preempt.go:219-267) has no counterpart
  (no PDB objects in the typed model).

Node fitness uses the solver's filters (fit + LoadAware; usage does not
change on eviction, as in the reference, where NodeMetric lags eviction).
Sums here are int64 (numpy) where the device path wraps in int32: the two
agree while every sum stays inside the int32 range.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.apis.extension import PriorityClass
from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    PodSpec,
    resources_to_vector,
)
from koordinator_tpu_torch.oracle.scheduler import (
    fit_filter_node,
    loadaware_filter_node,
)
from koordinator_tpu_torch.state.cluster import (
    DEFAULT_USAGE_THRESHOLDS,
    lower_nodes,
)

#: CycleState key under which a caller preempting for many pods keeps the
#: lowered node arrays, so each PostFilter need not re-lower the cluster.
#: Kept only for parity with the reference's API: the port has no
#: CycleState yet, and its callers hand ``find_preemption`` the arrays.
ARRAYS_STATE_KEY = "__preempt_node_arrays__"


def can_preempt(pod: PodSpec, victim: PodSpec) -> bool:
    """preempt.go:276-294 canPreempt: a preemptible victim of strictly
    lower priority in the same quota group."""
    if not victim.preemptible:
        return False
    if pod.priority <= victim.priority:
        return False
    return (pod.quota or "") == (victim.quota or "")


def _more_important(p: PodSpec) -> tuple:
    """Sort key of util.MoreImportantPod: higher priority first, then
    earlier assignment."""
    return (-p.priority, p.assign_time)


def select_victims_on_node(
    pod: PodSpec,
    node_index: int,
    candidates: Sequence[PodSpec],
    arrays,
    quota_used: Optional[np.ndarray],
    used_limit: Optional[np.ndarray],
    thresholds: np.ndarray,
    prod_thresholds: np.ndarray,
) -> Optional[List[PodSpec]]:
    """The victims on one node, or None if preemption there cannot
    help."""
    victims = [v for v in candidates if can_preempt(pod, v)]
    if not victims:
        return None
    req = resources_to_vector(pod.requests)
    alloc = arrays.alloc[node_index].astype(np.int64)
    base_used = arrays.used_req[node_index].astype(np.int64)
    removed = sum((resources_to_vector(v.requests) for v in victims),
                  np.zeros_like(req))
    is_ds = pod.is_daemonset
    is_prod = pod.priority_class == PriorityClass.PROD
    if not loadaware_filter_node(
        arrays.alloc[node_index],
        arrays.usage[node_index],
        arrays.prod_usage[node_index],
        bool(arrays.metric_fresh[node_index]),
        thresholds,
        prod_thresholds,
        is_ds,
        is_prod,
    ):
        return None  # eviction cannot fix a usage-threshold failure
    if not fit_filter_node(req, alloc, base_used - removed):
        return None  # no fit even with every victim gone

    # the quota gate is constant across the reprieve (preempt.go:191-199
    # checks the PostFilter snapshot's used): a quota over its runtime
    # reprieves nothing
    quota_blocks = False
    if quota_used is not None and used_limit is not None:
        dims = req > 0
        quota_blocks = bool(np.any((quota_used + req)[dims]
                                   > used_limit[dims]))

    final: List[PodSpec] = []
    kept = base_used - removed
    for v in sorted(victims, key=_more_important):
        if quota_blocks:
            final.append(v)
            continue
        v_req = resources_to_vector(v.requests)
        if fit_filter_node(req, alloc, kept + v_req):
            kept = kept + v_req  # reprieved
        else:
            final.append(v)
    return final if final else None


def find_preemption(
    snapshot: ClusterSnapshot,
    pod: PodSpec,
    quota_used: Optional[np.ndarray] = None,
    used_limit: Optional[np.ndarray] = None,
    arrays=None,
    thresholds: Optional[np.ndarray] = None,
    prod_thresholds: Optional[np.ndarray] = None,
) -> Optional[Tuple[str, List[PodSpec]]]:
    """``(node name, victims)`` of the cheapest viable preemption, or
    None. Nodes rank by fewest victims, then the lowest top victim
    priority (the spirit of the reference's pickOneNodeForPreemption),
    then the order ``snapshot.pods`` first names them."""
    if thresholds is None:
        thresholds = resources_to_vector(DEFAULT_USAGE_THRESHOLDS)
    if prod_thresholds is None:
        prod_thresholds = resources_to_vector({})
    if arrays is None:
        arrays = lower_nodes(snapshot)
    by_node: Dict[str, List[PodSpec]] = {}
    for p in snapshot.pods:
        if p.node_name is not None:
            by_node.setdefault(p.node_name, []).append(p)
    index = arrays.index()

    best: Optional[Tuple[str, List[PodSpec]]] = None
    best_key = None
    for node_name, candidates in by_node.items():
        i = index.get(node_name)
        if i is None or not arrays.schedulable[i]:
            continue
        victims = select_victims_on_node(
            pod, i, candidates, arrays, quota_used, used_limit,
            thresholds, prod_thresholds,
        )
        if victims is None:
            continue
        key = (len(victims), max(v.priority for v in victims))
        if best_key is None or key < best_key:
            best, best_key = (node_name, victims), key
    return best


def plan_defrag(
    snapshot: ClusterSnapshot,
    target_req: np.ndarray,
    max_victim_priority: int,
    arrays=None,
) -> Optional[Tuple[str, List[PodSpec]]]:
    """Headroom repack: the cheapest node to drain until a
    ``target_req``-sized hole (a gang member's shape) fits, or None.

    Drain candidates are preemptible residents strictly below
    ``max_victim_priority``, drained least important first (the reverse
    of the reprieve order). Where the hole already fits on a node no
    drain is needed (None). Ranked by fewest drained, then node iteration
    order: the scalar twin of ``ops/preempt.headroom_repack``."""
    if arrays is None:
        arrays = lower_nodes(snapshot)
    for i in range(arrays.n):
        if arrays.schedulable[i] and fit_filter_node(
            target_req,
            arrays.alloc[i].astype(np.int64),
            arrays.used_req[i].astype(np.int64),
        ):
            return None  # a hole already exists somewhere
    by_node: Dict[str, List[PodSpec]] = {}
    for p in snapshot.pods:
        if p.node_name is not None:
            by_node.setdefault(p.node_name, []).append(p)
    index = arrays.index()

    best: Optional[Tuple[str, List[PodSpec]]] = None
    best_key = None
    for node_name, residents in by_node.items():
        i = index.get(node_name)
        if i is None or not arrays.schedulable[i]:
            continue
        cand = sorted(
            (p for p in residents
             if p.preemptible and p.priority < max_victim_priority),
            key=_more_important,
        )
        alloc = arrays.alloc[i].astype(np.int64)
        kept = arrays.used_req[i].astype(np.int64)
        drained: List[PodSpec] = []
        fits = False
        for v in reversed(cand):
            kept = kept - resources_to_vector(v.requests)
            drained.append(v)
            if fit_filter_node(target_req, alloc, kept):
                fits = True
                break
        if not fits:
            continue
        key = (len(drained),)
        if best_key is None or key < best_key:
            best, best_key = (node_name, drained), key
    return best
