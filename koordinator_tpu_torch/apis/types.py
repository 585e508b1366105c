"""The typed objects a placement solve consumes.

Counterpart of ``koordinator_tpu/apis/types.py``, cut to the fields the
placement path, the scheduling round, the descheduler, the manager's
overcommit and the node agent read: pods, nodes, node metrics (with the
agent's disk usage), PVCs, gangs, quotas, reservations, migration jobs
and the cluster snapshot. All quantities are canonical
integer units (CPU in millicores, memory in MiB).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Mapping, Optional

import numpy as np

from koordinator_tpu_torch.apis.extension import (
    NUM_RESOURCES,
    PriorityClass,
    QoSClass,
    ResourceName,
    priority_class_of,
)

#: Sparse resource mapping in canonical units.
Resources = Dict[ResourceName, int]


def resources_to_vector(res: Optional[Mapping[ResourceName, int]]) -> np.ndarray:
    """Densify a sparse resource mapping into an int64 ``[R]`` vector."""
    vec = np.zeros(NUM_RESOURCES, dtype=np.int64)
    if res:
        for name, qty in res.items():
            vec[int(name)] = int(qty)
    return vec


def vector_to_resources(vec: np.ndarray) -> Resources:
    """Sparsify an ``[R]`` vector back into a mapping (drops zeros)."""
    return {ResourceName(i): int(v) for i, v in enumerate(vec) if v != 0}


def selector_matches(
    selector: Optional[Mapping[str, str]], labels: Mapping[str, str]
) -> bool:
    """k8s equality-based label selector: every selector key/value must
    appear in ``labels``. An empty selector matches everything."""
    if not selector:
        return True
    return all(labels.get(k) == v for k, v in selector.items())


@dataclasses.dataclass
class PodSpec:
    """A pod as the scheduler sees it, with the Koordinator label
    protocol already resolved (QoS, priority class, quota, gang)."""

    name: str
    namespace: str = "default"
    uid: str = ""
    requests: Resources = dataclasses.field(default_factory=dict)
    limits: Resources = dataclasses.field(default_factory=dict)
    qos: QoSClass = QoSClass.NONE
    priority: int = 0
    sub_priority: int = 0
    priority_class: Optional[PriorityClass] = None  # derived if None
    quota: Optional[str] = None
    gang: Optional[str] = None
    node_name: Optional[str] = None   # set once assigned
    is_daemonset: bool = False
    preemptible: bool = True
    #: wall-clock seconds when the pod was assigned (LoadAware staleness)
    assign_time: float = 0.0
    #: required node selector (spec.nodeSelector)
    node_selector: Optional[Dict[str, str]] = None
    #: requested host ports: ints (TCP implied) or "<proto>:<port>"
    host_ports: Optional[List] = None
    #: pod labels (reservation owner matching reads them)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: pod annotations (a cpuset or NUMA-policy resource spec lives here)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: device requests by device resource name (DeviceShare)
    device_requests: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: placed at the gang Permit barrier: holds its node, not bound yet
    waiting_permit: bool = False
    #: controller owner reference, "Kind/namespace/name": the workload the
    #: descheduler's arbitrator groups by and duplicates are judged by
    owner: Optional[str] = None
    #: summed container restart counts (RemovePodsHavingTooManyRestarts)
    restart_count: int = 0
    #: creation time in wall-clock seconds: the eviction order's last
    #: tie-break (newer pods are evicted first)
    creation_time: float = 0.0
    #: volume name -> PVC claim key "namespace/name" (spec.volumes with a
    #: persistentVolumeClaim): the node agent's pod-volume resolution
    volumes: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.priority_class is None:
            self.priority_class = priority_class_of(value=self.priority)
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}"


@dataclasses.dataclass
class NodeSpec:
    """A node: allocatable capacity plus scheduling-relevant attributes."""

    name: str
    allocatable: Resources = dataclasses.field(default_factory=dict)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: node annotations (the colocation protocol: node reservation, cpu
    #: normalization and amplification)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    unschedulable: bool = False
    #: allocatable before cpu normalization amplified it (None: not
    #: amplified)
    raw_allocatable: Optional[Resources] = None


@dataclasses.dataclass
class NodeMetric:
    """Reported node and pod usage (the NodeMetric CRD). ``update_time``
    drives staleness; ``report_interval`` the assigned-pod estimation."""

    node_name: str
    node_usage: Resources = dataclasses.field(default_factory=dict)
    #: pod uid -> usage
    pod_usages: Dict[str, Resources] = dataclasses.field(default_factory=dict)
    #: usage of the prod pods (the prod usage mode)
    prod_usage: Resources = dataclasses.field(default_factory=dict)
    #: the system's own usage (the manager's batch calculator input)
    sys_usage: Resources = dataclasses.field(default_factory=dict)
    #: the predictor's reclaimable prod resources (the mid-tier input)
    prod_reclaimable: Resources = dataclasses.field(default_factory=dict)
    #: pod uid -> priority class recorded with the metric (read for pods
    #: the metric reports but the pod list no longer holds)
    pod_priority_class: Dict[str, PriorityClass] = dataclasses.field(
        default_factory=dict)
    #: percentile -> usage, for the aggregated usage mode (p50, p90, p95,
    #: p99)
    aggregated_usage: Dict[int, Resources] = dataclasses.field(
        default_factory=dict)
    #: the window (seconds) the percentiles above were computed over
    #: (the collect policy's primary aggregate duration)
    aggregated_duration: Optional[float] = None
    #: more windows: duration seconds -> percentile -> usage (the
    #: reference's AggregatedNodeUsages, one entry a window)
    aggregated_windows: Dict[float, Dict[int, Resources]] = (
        dataclasses.field(default_factory=dict))
    #: system-usage percentiles per window (AggregatedSystemUsages:
    #: reported, read by nothing in the scheduler)
    aggregated_system_usage: Dict[float, Dict[int, Resources]] = (
        dataclasses.field(default_factory=dict))
    #: host application name -> usage, and its QoS class
    host_app_usages: Dict[str, Resources] = dataclasses.field(
        default_factory=dict)
    host_app_qos: Dict[str, QoSClass] = dataclasses.field(default_factory=dict)
    #: block device -> throughput and utilization over the window (the
    #: node agent's storage accounting)
    disk_usages: Dict[str, "DiskUsage"] = dataclasses.field(
        default_factory=dict)
    update_time: float = 0.0
    report_interval: float = 60.0


@dataclasses.dataclass
class DiskUsage:
    """One block device's throughput and utilization over the report
    window."""

    read_bps: int = 0
    write_bps: int = 0
    io_util_pct: int = 0


@dataclasses.dataclass
class PVCSpec:
    """A PersistentVolumeClaim as the node agent needs it: the claim ->
    bound-PV mapping. ``name`` is the namespaced claim key
    ("namespace/name")."""

    name: str
    volume_name: str = ""       # bound PV name ("" = unbound)
    capacity_mib: int = 0


class GangMode(enum.Enum):
    """Gang failure handling (reference: core/gang.go ScheduleStrategy)."""

    STRICT = "Strict"
    NON_STRICT = "NonStrict"


@dataclasses.dataclass
class GangSpec:
    """A gang / PodGroup: an all-or-nothing co-scheduling unit."""

    name: str
    min_member: int
    #: declared child count (carried, not read by admission)
    total_member: int = 0
    #: seconds a placed member may wait at the Permit barrier
    wait_time: float = 600.0
    mode: GangMode = GangMode.STRICT
    #: gangs that must be admitted together (gang group)
    gang_group: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class QuotaSpec:
    """An elastic quota node in the hierarchical quota tree. A resource
    absent from ``max`` admits nothing on that dimension."""

    name: str
    parent: Optional[str] = None
    min: Resources = dataclasses.field(default_factory=dict)
    max: Resources = dataclasses.field(default_factory=dict)
    shared_weight: Optional[Resources] = None  # defaults to max
    is_parent: bool = False
    allow_lent_resource: bool = True
    guaranteed: Resources = dataclasses.field(default_factory=dict)
    tree_id: str = ""
    #: proportional min scaling when sibling mins oversubscribe the parent
    enable_min_quota_scale: bool = False
    #: tree roots: the node-pool total backing this tree
    total_resource: Optional[Resources] = None


class ReservationState(enum.Enum):
    PENDING = "Pending"
    AVAILABLE = "Available"
    SUCCEEDED = "Succeeded"
    EXPIRED = "Expired"
    FAILED = "Failed"


@dataclasses.dataclass
class ReservationSpec:
    """A resource reservation (the Reservation CRD): capacity held on a
    node that owner pods may allocate from instead of from the node's
    free capacity. Owners are named by label (every ``owner_labels``
    pair on the pod) or, for migration reservations, by pod uid."""

    name: str
    requests: Resources = dataclasses.field(default_factory=dict)
    owner_labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    node_name: Optional[str] = None        # set once the reservation is bound
    state: ReservationState = ReservationState.PENDING
    allocatable: Resources = dataclasses.field(default_factory=dict)
    allocated: Resources = dataclasses.field(default_factory=dict)
    #: absolute expiry (spec.expires); checked before ttl
    expiration_time: Optional[float] = None
    #: relative expiry from create_time (spec.TTL); 0 disables expiration
    ttl: Optional[float] = None
    create_time: float = 0.0
    allocate_once: bool = True
    #: explicit pod owners (migration reservations); when set, only
    #: these pods match
    owner_pod_uids: List[str] = dataclasses.field(default_factory=list)
    #: pods currently allocated from this reservation (bookkeeping, not
    #: matching)
    allocated_pod_uids: List[str] = dataclasses.field(default_factory=list)


class MigrationPhase(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclasses.dataclass
class PodMigrationJob:
    """A descheduler migration job (the PodMigrationJob CRD): the
    reservation-first eviction state machine."""

    name: str
    pod_uid: str
    phase: MigrationPhase = MigrationPhase.PENDING
    reservation_name: Optional[str] = None
    reason: str = ""
    ttl: float = 300.0
    create_time: float = 0.0
    paused: bool = False


@dataclasses.dataclass
class ClusterSnapshot:
    """Everything the placement solver needs for one solve.

    ``delta_tracker`` is the producer's ``state.cluster.
    ClusterDeltaTracker`` (None: the model lowers the snapshot in full);
    with it the model's staging cache re-lowers only the node rows the
    tracker marked. ``delta_epoch`` is the tracker's epoch when the
    snapshot was taken, captured under the producer's lock: the cache
    syncs to it, so a mark racing in after the snapshot is re-lowered
    next round instead of lost."""

    nodes: List[NodeSpec] = dataclasses.field(default_factory=list)
    pods: List[PodSpec] = dataclasses.field(default_factory=list)  # assigned
    pending_pods: List[PodSpec] = dataclasses.field(default_factory=list)
    node_metrics: Dict[str, NodeMetric] = dataclasses.field(default_factory=dict)
    gangs: Dict[str, GangSpec] = dataclasses.field(default_factory=dict)
    quotas: Dict[str, QuotaSpec] = dataclasses.field(default_factory=dict)
    reservations: List[ReservationSpec] = dataclasses.field(default_factory=list)
    now: float = 0.0
    delta_tracker: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    delta_epoch: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False
    )
