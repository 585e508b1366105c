"""Lower a typed cluster snapshot onto dense int32 arrays (counterpart of
``koordinator_tpu/state/cluster.py``: the full lowering with reservation
holds, the delta tracker, the delta lowering that patches only the
rows a tracker marked, and the resident-pod world the preemption solve
reads; node-row padding is a later slice).

Lowering runs on the host in exact integer arithmetic (Python ints and
numpy int64) and clips to int32 at the end. Reference semantics:
- the pod usage estimator, pkg/scheduler/plugins/loadaware/estimator/
  default_estimator.go:57-110;
- the assigned-pod estimation staleness rules, load_aware.go:337-376.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from koordinator_tpu_torch.apis.extension import (
    NUM_RESOURCES,
    PriorityClass,
    ResourceName,
)
from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    NodeMetric,
    PodSpec,
    resources_to_vector,
)

# Defaults of the reference scheduler config
# (pkg/scheduler/apis/config/v1beta2/defaults.go:33-48).
DEFAULT_NODE_METRIC_EXPIRATION_SECONDS = 180.0
DEFAULT_RESOURCE_WEIGHTS = {ResourceName.CPU: 1, ResourceName.MEMORY: 1}
DEFAULT_USAGE_THRESHOLDS = {ResourceName.CPU: 65, ResourceName.MEMORY: 95}
DEFAULT_ESTIMATED_SCALING_FACTORS = {ResourceName.CPU: 85, ResourceName.MEMORY: 70}
# estimator zero-request defaults (default_estimator.go:36-39)
DEFAULT_MILLI_CPU_REQUEST = 250
DEFAULT_MEMORY_REQUEST_MIB = 200

_CPU_LIKE = (ResourceName.CPU, ResourceName.BATCH_CPU, ResourceName.MID_CPU)
_MEMORY_LIKE = (ResourceName.MEMORY, ResourceName.BATCH_MEMORY,
                ResourceName.MID_MEMORY)


def go_round(x: float) -> int:
    """``math.Round`` (half away from zero) for non-negative x."""
    return int(math.floor(x + 0.5))


def translate_resource_by_priority(
    resource: ResourceName, priority_class: PriorityClass
) -> ResourceName:
    """The extended resource a Batch or Mid pod requests in place of a
    native one (apis/extension/resource.go)."""
    if priority_class == PriorityClass.BATCH:
        if resource == ResourceName.CPU:
            return ResourceName.BATCH_CPU
        if resource == ResourceName.MEMORY:
            return ResourceName.BATCH_MEMORY
    elif priority_class == PriorityClass.MID:
        if resource == ResourceName.CPU:
            return ResourceName.MID_CPU
        if resource == ResourceName.MEMORY:
            return ResourceName.MID_MEMORY
    return resource


def estimate_pod_used(
    pod: PodSpec,
    scaling_factors: Optional[Mapping[ResourceName, int]] = None,
    resource_weights: Optional[Mapping[ResourceName, int]] = None,
) -> Dict[ResourceName, int]:
    """Estimated usage of a pod per weighted resource: the limit if it
    exceeds the request (factor forced to 100), else the request; a zero
    quantity falls back to 250 mCPU / 200 MiB; ``round(q * factor / 100)``
    capped at the limit."""
    scaling_factors = scaling_factors or DEFAULT_ESTIMATED_SCALING_FACTORS
    resource_weights = resource_weights or DEFAULT_RESOURCE_WEIGHTS
    out: Dict[ResourceName, int] = {}
    for resource in resource_weights:
        real = translate_resource_by_priority(resource, pod.priority_class)
        req = int(pod.requests.get(real, 0))
        lim = int(pod.limits.get(real, 0))
        factor = int(scaling_factors.get(resource, 100))
        if lim > req:
            factor, quantity = 100, lim
        else:
            quantity = req
        if quantity == 0:
            if real in _CPU_LIKE:
                out[resource] = DEFAULT_MILLI_CPU_REQUEST
            elif real in _MEMORY_LIKE:
                out[resource] = DEFAULT_MEMORY_REQUEST_MIB
            else:
                out[resource] = 0
            continue
        estimated = go_round(quantity * factor / 100)
        if lim > 0 and estimated > lim:
            estimated = lim
        out[resource] = estimated
    return out


@dataclasses.dataclass
class NodeArrays:
    """Dense node-side state on the host: ``[N, R]`` int32, ``[N]`` bool."""

    names: List[str]
    alloc: np.ndarray          # [N,R] allocatable
    used_req: np.ndarray       # [N,R] Σ assigned pod requests
    usage: np.ndarray          # [N,R] reported usage
    prod_usage: np.ndarray     # [N,R] Σ reported usage of assigned prod pods
    est_extra: np.ndarray      # [N,R] assigned-pod estimation correction
    prod_base: np.ndarray      # [N,R] prod-mode score base
    metric_fresh: np.ndarray   # [N] bool: metric exists and is not expired
    schedulable: np.ndarray    # [N] bool
    #: [N] float64 metric update times (-inf: no metric), host only and
    #: never staged: the delta lowering recomputes ``metric_fresh`` from
    #: it as ``snapshot.now`` advances, without marks
    metric_update_time: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return len(self.names)

    def index(self) -> Dict[str, int]:
        return {name: i for i, name in enumerate(self.names)}


class ClusterDeltaTracker:
    """Which node rows changed, for incremental lowering.

    A snapshot producer (``scheduler/cache.SchedulerCache``, or a test
    that mutates a snapshot) marks the node rows its mutations touch;
    the model's staging cache then re-lowers only those rows. Marks are
    kept as ``name -> epoch``, so each consumer diffs against its own
    last-seen epoch.
    Anything that changes the node set or its order must call
    :meth:`mark_structure`, and consumers fall back to a full lowering.
    The lock keeps two racing marks from sharing an epoch (markers run
    under the cache lock and outside it)."""

    def __init__(self) -> None:
        self.epoch = 0            # the mark clock, monotone
        self.structure_epoch = 0  # last epoch the node set or order changed
        self._marks: Dict[str, int] = {}
        self._lock = threading.Lock()

    def mark_node(self, name: Optional[str]) -> None:
        """Node ``name``'s lowered row may have changed."""
        if name is None:
            return
        with self._lock:
            self.epoch += 1
            self._marks[name] = self.epoch

    def mark_nodes(self, names) -> None:
        for name in names:
            self.mark_node(name)

    def mark_structure(self) -> None:
        """The node set or its order changed: row indices are stale."""
        with self._lock:
            self.epoch += 1
            self.structure_epoch = self.epoch
            self._marks.clear()

    def dirty_since(self, epoch: int) -> List[str]:
        """Node names marked after ``epoch``."""
        with self._lock:
            return [name for name, at in self._marks.items() if at > epoch]


@dataclasses.dataclass
class PendingPodArrays:
    """Dense pending-pod state in schedule order."""

    uids: List[str]
    req: np.ndarray              # [P,R] requests
    est: np.ndarray              # [P,R] estimator output
    qos: np.ndarray              # [P] int8 QoSClass
    prio_class: np.ndarray       # [P] int8 PriorityClass
    priority: np.ndarray         # [P] int32
    is_prod: np.ndarray          # [P] bool
    is_daemonset: np.ndarray     # [P] bool
    non_preemptible: np.ndarray  # [P] bool
    quota_id: np.ndarray         # [P] int32, -1 if none
    gang_id: np.ndarray          # [P] int32, -1 if none

    @property
    def p(self) -> int:
        return len(self.uids)


def clip_i32(a: np.ndarray) -> np.ndarray:
    info = np.iinfo(np.int32)
    return np.clip(a, info.min, info.max).astype(np.int32)


def _metric_fresh(now, update_time, metric_expiration_seconds):
    """The metric-expiration verdict, scalar in :func:`_node_metric_row`
    and over the cached ``metric_update_time`` column in
    :func:`lower_nodes_delta`: one definition for both paths."""
    return (now - update_time) < metric_expiration_seconds


def _node_metric_row(metric: NodeMetric, assigned, *, now: float,
                     metric_expiration_seconds: float, scaling_factors,
                     resource_weights):
    """One node's metric columns ``(usage, prod_usage, est_extra,
    prod_base, metric_fresh)`` as int64 vectors and a bool.

    ``est_extra`` = Σ max(estimate, reported) over the assigned pods that
    should be estimated (no report, assigned after the metric, or inside
    the report interval), minus their reported usage where node usage
    covers it (load_aware.go:299-327). ``assigned`` is in snapshot order,
    which fixes the accumulation sequence."""
    prod_usage = np.zeros(NUM_RESOURCES, dtype=np.int64)
    prod_base = np.zeros(NUM_RESOURCES, dtype=np.int64)
    usage = resources_to_vector(metric.node_usage)
    fresh = _metric_fresh(now, metric.update_time, metric_expiration_seconds)
    est_sum = np.zeros(NUM_RESOURCES, dtype=np.int64)
    reported_sum = np.zeros(NUM_RESOURCES, dtype=np.int64)
    for pod in assigned:
        is_prod = pod.priority_class == PriorityClass.PROD
        reported = metric.pod_usages.get(pod.uid)
        rep_vec = resources_to_vector(reported) if reported else None
        if is_prod and rep_vec is not None:
            prod_usage += rep_vec
        should_estimate = (
            not reported
            or pod.assign_time >= metric.update_time
            or (metric.update_time - pod.assign_time) < metric.report_interval
        )
        if not should_estimate:
            if is_prod and rep_vec is not None:
                prod_base += rep_vec
            continue
        est_vec = resources_to_vector(
            estimate_pod_used(pod, scaling_factors, resource_weights)
        )
        if rep_vec is not None:
            est_vec = np.maximum(est_vec, rep_vec)
            reported_sum += rep_vec
        est_sum += est_vec
        if is_prod:
            prod_base += est_vec
    sub = np.where(usage >= reported_sum, reported_sum, 0)
    est_extra = est_sum - sub
    return usage, prod_usage, est_extra, prod_base, fresh


def _node_hold_rows(snapshot: ClusterSnapshot, index: Dict[str, int]):
    """``used_req`` int64 rows and the assigned pods of each node in
    ``index`` (all of them, or the delta lowering's dirty ones), in
    snapshot order. ``used_req`` is Σ assigned pod requests plus every
    Available reservation's unallocated remainder on its node (the net
    view of the reference's reserve pod and restore chain)."""
    used_req = np.zeros((len(index), NUM_RESOURCES), dtype=np.int64)
    assigned_by_node: Dict[str, List[PodSpec]] = {}
    for pod in snapshot.pods:
        if pod.node_name is None or pod.node_name not in index:
            continue
        used_req[index[pod.node_name]] += resources_to_vector(pod.requests)
        assigned_by_node.setdefault(pod.node_name, []).append(pod)
    for resv in snapshot.reservations:
        if (
            getattr(resv.state, "value", resv.state) == "Available"
            and resv.node_name in index
        ):
            alloc_vec = resources_to_vector(resv.allocatable or resv.requests)
            used_vec = resources_to_vector(resv.allocated)
            used_req[index[resv.node_name]] += np.maximum(
                alloc_vec - used_vec, 0
            )
    return used_req, assigned_by_node


def lower_nodes(
    snapshot: ClusterSnapshot,
    *,
    metric_expiration_seconds: float = DEFAULT_NODE_METRIC_EXPIRATION_SECONDS,
    scaling_factors: Optional[Mapping[ResourceName, int]] = None,
    resource_weights: Optional[Mapping[ResourceName, int]] = None,
) -> NodeArrays:
    """Lower nodes, assigned pods, reservation holds and metrics to
    :class:`NodeArrays`."""
    n = len(snapshot.nodes)
    names = [node.name for node in snapshot.nodes]
    index = {name: i for i, name in enumerate(names)}
    shape = (n, NUM_RESOURCES)
    alloc = np.zeros(shape, dtype=np.int64)
    usage = np.zeros(shape, dtype=np.int64)
    prod_usage = np.zeros(shape, dtype=np.int64)
    est_extra = np.zeros(shape, dtype=np.int64)
    prod_base = np.zeros(shape, dtype=np.int64)
    metric_fresh = np.zeros(n, dtype=bool)
    schedulable = np.ones(n, dtype=bool)
    metric_update_time = np.full(n, -np.inf)
    for i, node in enumerate(snapshot.nodes):
        alloc[i] = resources_to_vector(node.allocatable)
        schedulable[i] = not node.unschedulable
    used_req, assigned_by_node = _node_hold_rows(snapshot, index)
    for name, metric in snapshot.node_metrics.items():
        if name not in index:
            continue
        i = index[name]
        metric_update_time[i] = metric.update_time
        (
            usage[i], prod_usage[i], est_extra[i], prod_base[i],
            metric_fresh[i],
        ) = _node_metric_row(
            metric,
            assigned_by_node.get(name, ()),
            now=snapshot.now,
            metric_expiration_seconds=metric_expiration_seconds,
            scaling_factors=scaling_factors,
            resource_weights=resource_weights,
        )
    return NodeArrays(
        names=names,
        alloc=clip_i32(alloc),
        used_req=clip_i32(used_req),
        usage=clip_i32(usage),
        prod_usage=clip_i32(prod_usage),
        est_extra=clip_i32(est_extra),
        prod_base=clip_i32(prod_base),
        metric_fresh=metric_fresh,
        schedulable=schedulable,
        metric_update_time=metric_update_time,
    )


def lower_nodes_delta(
    snapshot: ClusterSnapshot,
    prev: NodeArrays,
    dirty_names,
    *,
    metric_expiration_seconds: float = DEFAULT_NODE_METRIC_EXPIRATION_SECONDS,
    scaling_factors: Optional[Mapping[ResourceName, int]] = None,
    resource_weights: Optional[Mapping[ResourceName, int]] = None,
) -> Optional[np.ndarray]:
    """Re-lower ``prev``'s rows of ``dirty_names`` in place against
    ``snapshot``, and flip ``metric_fresh`` on every row whose metric
    crossed the expiration window as ``snapshot.now`` moved.

    Returns the sorted int32 indices of the rows rewritten (possibly
    none), or None when the node set or order no longer matches ``prev``
    (the caller then lowers in full). Dirty rows go through the same
    per-row helpers and int32 clip as :func:`lower_nodes`, so ``prev``
    ends bit-identical to a full lowering of ``snapshot`` when every
    mutated node was marked."""
    if prev.metric_update_time is None:
        return None
    names = [node.name for node in snapshot.nodes]
    if names != prev.names:
        return None
    index = prev.index()
    dirty = sorted({name for name in dirty_names if name in index})
    fresh_now = _metric_fresh(snapshot.now, prev.metric_update_time,
                              metric_expiration_seconds)
    flipped = np.nonzero(fresh_now != prev.metric_fresh)[0]
    sub_index = {name: k for k, name in enumerate(dirty)}
    if sub_index:
        used_req, assigned_by_node = _node_hold_rows(snapshot, sub_index)
        for name, k in sub_index.items():
            i = index[name]
            node = snapshot.nodes[i]
            prev.alloc[i] = clip_i32(resources_to_vector(node.allocatable))
            prev.schedulable[i] = not node.unschedulable
            prev.used_req[i] = clip_i32(used_req[k])
            metric = snapshot.node_metrics.get(name)
            if metric is None:
                prev.metric_update_time[i] = -np.inf
                for column in (prev.usage, prev.prod_usage, prev.est_extra,
                               prev.prod_base):
                    column[i] = 0
                prev.metric_fresh[i] = False
                continue
            prev.metric_update_time[i] = metric.update_time
            u, pu, ee, pb, fresh = _node_metric_row(
                metric,
                assigned_by_node.get(name, ()),
                now=snapshot.now,
                metric_expiration_seconds=metric_expiration_seconds,
                scaling_factors=scaling_factors,
                resource_weights=resource_weights,
            )
            prev.usage[i] = clip_i32(u)
            prev.prod_usage[i] = clip_i32(pu)
            prev.est_extra[i] = clip_i32(ee)
            prev.prod_base[i] = clip_i32(pb)
            prev.metric_fresh[i] = fresh
    rows = {index[name] for name in dirty}
    # a flip on an unmarked row touches only its freshness
    for i in flipped.tolist():
        if i not in rows:
            prev.metric_fresh[i] = fresh_now[i]
            rows.add(i)
    return np.asarray(sorted(rows), dtype=np.int32)


def lower_node_rows(
    snapshot: ClusterSnapshot,
    names: Sequence[str],
    *,
    metric_expiration_seconds: float = DEFAULT_NODE_METRIC_EXPIRATION_SECONDS,
    scaling_factors: Optional[Mapping[ResourceName, int]] = None,
    resource_weights: Optional[Mapping[ResourceName, int]] = None,
) -> Dict[str, np.ndarray]:
    """Lower just ``names``'s rows from the snapshot into new buffers:
    ``{staged field: [K, ...] array}`` aligned to ``names`` (a subset of
    the snapshot's nodes), through the same per-row helpers as
    :func:`lower_nodes`. A parity probe compares such rows against the
    staged arrays."""
    sub_index = {name: k for k, name in enumerate(names)}
    k_count = len(sub_index)
    node_by_name = {node.name: node for node in snapshot.nodes}
    shape = (k_count, NUM_RESOURCES)
    alloc = np.zeros(shape, dtype=np.int64)
    usage = np.zeros(shape, dtype=np.int64)
    prod_usage = np.zeros(shape, dtype=np.int64)
    est_extra = np.zeros(shape, dtype=np.int64)
    prod_base = np.zeros(shape, dtype=np.int64)
    metric_fresh = np.zeros(k_count, dtype=bool)
    schedulable = np.ones(k_count, dtype=bool)
    used_req, assigned_by_node = _node_hold_rows(snapshot, sub_index)
    for name, k in sub_index.items():
        node = node_by_name[name]
        alloc[k] = resources_to_vector(node.allocatable)
        schedulable[k] = not node.unschedulable
        metric = snapshot.node_metrics.get(name)
        if metric is None:
            continue
        (
            usage[k], prod_usage[k], est_extra[k], prod_base[k],
            metric_fresh[k],
        ) = _node_metric_row(
            metric,
            assigned_by_node.get(name, ()),
            now=snapshot.now,
            metric_expiration_seconds=metric_expiration_seconds,
            scaling_factors=scaling_factors,
            resource_weights=resource_weights,
        )
    return {
        "alloc": clip_i32(alloc),
        "used_req": clip_i32(used_req),
        "usage": clip_i32(usage),
        "prod_usage": clip_i32(prod_usage),
        "est_extra": clip_i32(est_extra),
        "prod_base": clip_i32(prod_base),
        "metric_fresh": metric_fresh,
        "schedulable": schedulable,
    }


def schedule_order(pods: Sequence[PodSpec]) -> List[int]:
    """Scheduler-queue order: priority descending, then sub-priority
    descending, then FIFO."""
    return sorted(
        range(len(pods)),
        key=lambda i: (-pods[i].priority, -pods[i].sub_priority, i),
    )


def lower_pending_pods(
    pods: Sequence[PodSpec],
    *,
    quota_index: Optional[Mapping[str, int]] = None,
    gang_index: Optional[Mapping[str, int]] = None,
    scaling_factors: Optional[Mapping[ResourceName, int]] = None,
    resource_weights: Optional[Mapping[ResourceName, int]] = None,
    in_schedule_order: bool = True,
) -> PendingPodArrays:
    """Lower pending pods to :class:`PendingPodArrays` (schedule order by
    default)."""
    order = schedule_order(pods) if in_schedule_order else list(range(len(pods)))
    pods = [pods[i] for i in order]
    p = len(pods)
    req = np.zeros((p, NUM_RESOURCES), dtype=np.int64)
    est = np.zeros((p, NUM_RESOURCES), dtype=np.int64)
    qos = np.zeros(p, dtype=np.int8)
    prio_class = np.zeros(p, dtype=np.int8)
    priority = np.zeros(p, dtype=np.int32)
    is_prod = np.zeros(p, dtype=bool)
    is_daemonset = np.zeros(p, dtype=bool)
    non_preemptible = np.zeros(p, dtype=bool)
    quota_id = np.full(p, -1, dtype=np.int32)
    gang_id = np.full(p, -1, dtype=np.int32)
    for i, pod in enumerate(pods):
        req[i] = resources_to_vector(pod.requests)
        est[i] = resources_to_vector(
            estimate_pod_used(pod, scaling_factors, resource_weights)
        )
        qos[i] = int(pod.qos)
        prio_class[i] = int(pod.priority_class)
        priority[i] = pod.priority
        is_prod[i] = pod.priority_class == PriorityClass.PROD
        is_daemonset[i] = pod.is_daemonset
        non_preemptible[i] = not pod.preemptible
        if quota_index and pod.quota is not None:
            quota_id[i] = quota_index.get(pod.quota, -1)
        if gang_index and pod.gang is not None:
            gang_id[i] = gang_index.get(pod.gang, -1)
    return PendingPodArrays(
        uids=[pod.uid for pod in pods],
        req=clip_i32(req),
        est=clip_i32(est),
        qos=qos,
        prio_class=prio_class,
        priority=priority,
        is_prod=is_prod,
        is_daemonset=is_daemonset,
        non_preemptible=non_preemptible,
        quota_id=quota_id,
        gang_id=gang_id,
    )


# -- the resident-pod world (the victim side of the joint place+evict) --------


@dataclasses.dataclass
class ResidentPodArrays:
    """Dense ``[N, P]`` resident-pod world for the victim selection
    (``ops/preempt.py``), sorted per node in the oracle's importance order
    (priority descending, then earlier assignment:
    ``scheduler/preemption._more_important``), so a victim mask read along
    the P axis is the oracle's ordered victim list.

    ``quota_ids`` maps quota-group names (``""`` = no quota) to the ids in
    ``quota_id``; a preemptor's id comes from :meth:`quota_id_of`, where an
    unseen group matches no resident, as the oracle's string comparison.
    ``node_rank`` is the oracle's node iteration order (the first
    appearance of each ``node_name`` in ``snapshot.pods``, the order
    ``find_preemption`` walks), the last tie-break of the ranking."""

    uids: List[List[str]]      # [N][<=P] resident uids, importance order
    req: np.ndarray            # [N,P,R] int32 requests
    priority: np.ndarray       # [N,P] int32
    quota_id: np.ndarray       # [N,P] int32
    preemptible: np.ndarray    # [N,P] bool
    valid: np.ndarray          # [N,P] bool (False = padding or evicted)
    node_rank: np.ndarray      # [N] int32
    quota_ids: Dict[str, int]  # quota name ("" = none) -> id

    @property
    def n(self) -> int:
        return self.req.shape[0]

    @property
    def p(self) -> int:
        return self.req.shape[1]

    def quota_id_of(self, quota: Optional[str]) -> int:
        """The preemptor-side id of ``quota``: ``-2`` (matching no
        resident; padding is ``-3``) when no resident carries it."""
        return self.quota_ids.get(quota or "", -2)

    def columns_of(self, node_index: int, uids) -> List[int]:
        """P-axis columns of ``uids`` on row ``node_index``."""
        wanted = set(uids)
        return [j for j, uid in enumerate(self.uids[node_index])
                if uid in wanted]


def lower_resident_pods(
    snapshot: ClusterSnapshot,
    arrays: NodeArrays,
) -> ResidentPodArrays:
    """Lower the assigned-pod world to :class:`ResidentPodArrays`, its
    P axis as wide as the fullest node (the reference pads it to a
    compile bucket; eager torch compiles nothing per width)."""
    index = arrays.index()
    by_node: Dict[int, List[PodSpec]] = {}
    unranked = np.iinfo(np.int32).max
    node_rank = np.full(arrays.n, unranked, dtype=np.int32)
    rank = 0
    for pod in snapshot.pods:
        if pod.node_name is None:
            continue
        i = index.get(pod.node_name)
        if i is None:
            continue
        if node_rank[i] == unranked:
            node_rank[i] = rank
            rank += 1
        by_node.setdefault(i, []).append(pod)

    quota_ids: Dict[str, int] = {}
    for pods in by_node.values():
        # a stable sort on the oracle's importance key
        pods.sort(key=lambda p: (-p.priority, p.assign_time))
        for pod in pods:
            quota_ids.setdefault(pod.quota or "", len(quota_ids))

    p = max((len(v) for v in by_node.values()), default=0)
    p = max(p, 1)  # the loops need one column
    n = arrays.n
    req = np.zeros((n, p, NUM_RESOURCES), dtype=np.int64)
    priority = np.zeros((n, p), dtype=np.int32)
    quota_id = np.full((n, p), -3, dtype=np.int32)
    preemptible = np.zeros((n, p), dtype=bool)
    valid = np.zeros((n, p), dtype=bool)
    uids: List[List[str]] = [[] for _ in range(n)]
    for i, pods in by_node.items():
        uids[i] = [pod.uid for pod in pods]
        for j, pod in enumerate(pods):
            req[i, j] = resources_to_vector(pod.requests)
            priority[i, j] = pod.priority
            quota_id[i, j] = quota_ids[pod.quota or ""]
            preemptible[i, j] = pod.preemptible
            valid[i, j] = True
    return ResidentPodArrays(
        uids=uids,
        req=clip_i32(req),
        priority=priority,
        quota_id=quota_id,
        preemptible=preemptible,
        valid=valid,
        node_rank=node_rank,
        quota_ids=quota_ids,
    )


def evict_resident_rows(
    snapshot: ClusterSnapshot,
    arrays: NodeArrays,
    resident: ResidentPodArrays,
    node_name: str,
    victim_uids,
    **lowering_kwargs,
) -> Optional[np.ndarray]:
    """Apply an eviction: the victims leave ``snapshot.pods``, their
    resident columns are invalidated in place, the snapshot's delta
    tracker marks the node, and its row of ``arrays`` is re-lowered in
    place through :func:`lower_nodes_delta` (the same per-row helpers as
    the full lowering, so the row ends equal to a fresh lowering of the
    reduced snapshot). Returns the rewritten row indices, or None when
    the node set drifted (the caller lowers in full)."""
    wanted = set(victim_uids)
    snapshot.pods = [pod for pod in snapshot.pods if pod.uid not in wanted]
    i = arrays.index().get(node_name)
    if i is not None:
        for j, uid in enumerate(resident.uids[i]):
            if uid in wanted:
                resident.valid[i, j] = False
    if snapshot.delta_tracker is not None:
        snapshot.delta_tracker.mark_node(node_name)
    return lower_nodes_delta(snapshot, arrays, [node_name], **lowering_kwargs)
