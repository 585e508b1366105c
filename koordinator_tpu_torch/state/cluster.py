"""Lower a typed cluster snapshot onto dense int32 arrays (counterpart of
``koordinator_tpu/state/cluster.py``: the full lowering; the delta
lowering and resident-pod world are a later slice).

Lowering runs on the host in exact integer arithmetic (Python ints and
numpy int64) and clips to int32 at the end. Reference semantics:
- the pod usage estimator, pkg/scheduler/plugins/loadaware/estimator/
  default_estimator.go:57-110;
- the assigned-pod estimation staleness rules, load_aware.go:337-376.
"""

from __future__ import annotations

import dataclasses
import math
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

    @property
    def n(self) -> int:
        return len(self.names)


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
    fresh = (now - metric.update_time) < metric_expiration_seconds
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
    """``used_req`` int64 rows (Σ assigned pod requests) and the assigned
    pods of each node, in snapshot order."""
    used_req = np.zeros((len(index), NUM_RESOURCES), dtype=np.int64)
    assigned_by_node: Dict[str, List[PodSpec]] = {}
    for pod in snapshot.pods:
        if pod.node_name is None or pod.node_name not in index:
            continue
        used_req[index[pod.node_name]] += resources_to_vector(pod.requests)
        assigned_by_node.setdefault(pod.node_name, []).append(pod)
    return used_req, assigned_by_node


def lower_nodes(
    snapshot: ClusterSnapshot,
    *,
    metric_expiration_seconds: float = DEFAULT_NODE_METRIC_EXPIRATION_SECONDS,
    scaling_factors: Optional[Mapping[ResourceName, int]] = None,
    resource_weights: Optional[Mapping[ResourceName, int]] = None,
) -> NodeArrays:
    """Lower nodes, assigned pods and metrics to :class:`NodeArrays`."""
    if snapshot.reservations:
        raise NotImplementedError(
            "reservations are a later slice of the port (the reference "
            "lowers their holds in state/cluster.py _node_hold_rows)"
        )
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
    for i, node in enumerate(snapshot.nodes):
        alloc[i] = resources_to_vector(node.allocatable)
        schedulable[i] = not node.unschedulable
    used_req, assigned_by_node = _node_hold_rows(snapshot, index)
    for name, metric in snapshot.node_metrics.items():
        if name not in index:
            continue
        i = index[name]
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
    )


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
