"""Cluster SLO configuration (counterpart of
``koordinator_tpu/manager/sloconfig.py``): the colocation strategy with
its node-selector overrides, and the NodeSLO strategies the nodeslo
controller renders per node (threshold, per-QoS resource knobs, CPU
burst, system, host applications).

Plain dataclasses with the reference's default values (its ConfigMap
JSON payloads), merged per node as it merges them: the cluster strategy,
then the node-selector strategies.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.apis.types import selector_matches


def merge_overrides(base, overrides: Dict):
    """Recursive JSON-merge-patch overlay: only keys present in
    ``overrides`` change, nested dicts recurse into nested dataclasses,
    unknown keys are ignored. Returns a new dataclass; ``base`` is not
    mutated."""
    out = copy.deepcopy(base)
    for key, value in overrides.items():
        if not hasattr(out, key):
            continue
        current = getattr(out, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            setattr(out, key, merge_overrides(current, value))
        else:
            setattr(out, key, value)
    return out


@dataclasses.dataclass
class ColocationStrategy:
    """The colocation strategy with the reference's defaults
    (pkg/util/sloconfig/colocation_config.go:50-75)."""

    enable: bool = False
    metric_aggregate_duration_seconds: int = 300
    metric_report_interval_seconds: int = 60
    cpu_reclaim_threshold_percent: int = 60
    memory_reclaim_threshold_percent: int = 65
    degrade_time_minutes: int = 15
    update_time_threshold_seconds: int = 300
    resource_diff_threshold: float = 0.1
    mid_cpu_threshold_percent: int = 100
    mid_memory_threshold_percent: int = 100
    # CalculatePolicy names: "usage" | "request" | "maxUsageRequest"
    cpu_calculate_policy: str = "usage"
    memory_calculate_policy: str = "usage"

    def is_valid(self) -> bool:
        """sloconfig.IsColocationStrategyValid (colocation_config.go:77-85)."""
        return (
            self.metric_aggregate_duration_seconds > 0
            and self.metric_report_interval_seconds > 0
            and 0 < self.cpu_reclaim_threshold_percent <= 100
            and 0 < self.memory_reclaim_threshold_percent <= 100
            and self.degrade_time_minutes > 0
            and self.update_time_threshold_seconds > 0
            and self.resource_diff_threshold > 0
        )

    @classmethod
    def from_dict(cls, d: Dict) -> "ColocationStrategy":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class NodeStrategySelector:
    """A node-scoped strategy override selected by labels; ``overrides``
    holds only the fields the override sets."""

    match_labels: Dict[str, str]
    overrides: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ColocationConfig:
    """The cluster strategy and its node overrides."""

    cluster_strategy: ColocationStrategy = dataclasses.field(
        default_factory=ColocationStrategy
    )
    node_strategies: List[NodeStrategySelector] = dataclasses.field(
        default_factory=list
    )

    def strategy_for_node(self, node_labels: Dict[str, str]) -> ColocationStrategy:
        """The cluster strategy overlaid with the first matching node
        strategy."""
        out = self.cluster_strategy
        for sel in self.node_strategies:
            if selector_matches(sel.match_labels, node_labels):
                out = merge_overrides(out, sel.overrides)
                break
        return out


# ---------------------------------------------------------------------------
# NodeSLO strategies (rendered into per-node NodeSLO by the nodeslo
# controller; consumed by koordlet's qosmanager)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResourceThresholdStrategy:
    """Reference: slov1alpha1.ResourceThresholdStrategy, defaults
    nodeslo_config.go:53-61."""

    enable: bool = False
    cpu_suppress_threshold_percent: int = 65
    cpu_suppress_policy: str = "cpuset"  # cpuset | cfsQuota
    memory_evict_threshold_percent: int = 70
    memory_evict_lower_percent: Optional[int] = None  # default threshold-2
    cpu_evict_policy: str = "evictByRealLimit"
    cpu_evict_be_usage_threshold_percent: int = 90
    cpu_evict_be_satisfaction_lower_percent: Optional[int] = None
    cpu_evict_be_satisfaction_upper_percent: Optional[int] = None
    cpu_evict_time_window_seconds: int = 60


@dataclasses.dataclass
class CPUQOS:
    """Per-QoS cpu knobs (reference: slov1alpha1.CPUQOS, defaults
    nodeslo_config.go:64-97): bvt group identity, SCHED_IDLE, core
    expeller."""

    group_identity: int = 0
    sched_idle: int = 0
    core_expeller: bool = False


@dataclasses.dataclass
class MemoryQOS:
    """Reference: slov1alpha1.MemoryQOS (memcg qos), defaults all-off
    (nodeslo_config.go:136-190)."""

    min_limit_percent: int = 0
    low_limit_percent: int = 0
    throttling_percent: int = 0
    wmark_ratio: int = 95
    wmark_scale_permill: int = 20
    wmark_min_adj: int = 0
    oom_kill_group: int = 0
    priority_enable: int = 0
    priority: int = 0


@dataclasses.dataclass
class ResctrlQOS:
    """Reference: slov1alpha1.ResctrlQOS, defaults nodeslo_config.go:
    100-130: BE gets 0-30% of LLC ways, others full; MBA 100%."""

    cat_range_start_percent: int = 0
    cat_range_end_percent: int = 100
    mba_percent: int = 100


@dataclasses.dataclass
class BlockCfg:
    """One throttled block device (reference: slov1alpha1.BlockCfg/
    BlkIOQOS, blkio_reconcile.go:311-373 getBlkIOUpdaterFromBlockCfg).
    Devices are addressed by their MAJ:MIN number; 0 = unlimited.

    ``block_type="pod_volume"`` addresses a pod volume by name instead:
    the reconciler resolves volume -> PVC claim -> bound PV (the PVC
    informer's map) -> device (blkio_reconcile.go:375-418
    getDiskNumberFromBlockCfg, BlockTypePodVolume)."""

    device: str = ""            # "MAJ:MIN" (block_type="device")
    read_bps: int = 0
    write_bps: int = 0
    read_iops: int = 0
    write_iops: int = 0
    block_type: str = "device"  # "device" | "pod_volume"
    name: str = ""              # volume name (block_type="pod_volume")


@dataclasses.dataclass
class NetworkQOS:
    """Per-class network bandwidth QoS (reference: slov1alpha1
    NetworkQOSCfg). Request/limit values follow the reference's
    IntOrString convention: an int is a percentage of the node's total
    bandwidth; a str is an absolute bits-per-second quantity
    (terwayqos.go:352-371 parseQuantity)."""

    enable: bool = False
    ingress_request: Optional[object] = None  # int % | str bits/s
    ingress_limit: Optional[object] = None
    egress_request: Optional[object] = None
    egress_limit: Optional[object] = None


@dataclasses.dataclass
class QoSConfig:
    enable: bool = False
    cpu: CPUQOS = dataclasses.field(default_factory=CPUQOS)
    memory: MemoryQOS = dataclasses.field(default_factory=MemoryQOS)
    resctrl: ResctrlQOS = dataclasses.field(default_factory=ResctrlQOS)
    blkio: List[BlockCfg] = dataclasses.field(default_factory=list)
    network: NetworkQOS = dataclasses.field(default_factory=NetworkQOS)


def default_qos_config(qos: QoSClass) -> QoSConfig:
    """Per-class defaults (reference: DefaultResourceQOSStrategy,
    nodeslo_config.go:64-130): LSR/LS bvt=2 + core expeller, BE bvt=-1 and
    LLC capped to 30%."""
    cfg = QoSConfig()
    if qos in (QoSClass.LSR, QoSClass.LS):
        cfg.cpu = CPUQOS(group_identity=2, core_expeller=True)
    elif qos is QoSClass.BE:
        cfg.cpu = CPUQOS(group_identity=-1)
        cfg.resctrl = ResctrlQOS(cat_range_end_percent=30)
    return cfg


@dataclasses.dataclass
class ResourceQOSStrategy:
    lsr: QoSConfig = dataclasses.field(
        default_factory=lambda: default_qos_config(QoSClass.LSR)
    )
    ls: QoSConfig = dataclasses.field(
        default_factory=lambda: default_qos_config(QoSClass.LS)
    )
    be: QoSConfig = dataclasses.field(
        default_factory=lambda: default_qos_config(QoSClass.BE)
    )
    system: QoSConfig = dataclasses.field(
        default_factory=lambda: default_qos_config(QoSClass.SYSTEM)
    )

    #: strategy-level policy switches (reference: ResourceQOSPolicies);
    #: key "netQOSPolicy" == "terway-qos" enables the terway net-QoS hook
    policies: Dict[str, str] = dataclasses.field(default_factory=dict)

    def for_qos(self, qos: QoSClass) -> QoSConfig:
        return {
            QoSClass.LSE: self.lsr,  # LSE shares LSR's knobs
            QoSClass.LSR: self.lsr,
            QoSClass.LS: self.ls,
            QoSClass.BE: self.be,
            QoSClass.SYSTEM: self.system,
        }.get(qos, self.ls)


@dataclasses.dataclass
class CPUBurstStrategy:
    """Reference: slov1alpha1.CPUBurstStrategy, defaults
    nodeslo_config.go:360-374."""

    policy: str = "none"  # none | cpuBurstOnly | cfsQuotaBurstOnly | auto
    cpu_burst_percent: int = 1000
    cfs_quota_burst_percent: int = 300
    cfs_quota_burst_period_seconds: int = -1  # -1: always allowed
    share_pool_threshold_percent: int = 50


@dataclasses.dataclass
class SystemStrategy:
    """Reference: slov1alpha1.SystemStrategy, defaults
    nodeslo_config.go:376-382."""

    min_free_kbytes_factor: int = 100   # 1/10000 of total memory
    watermark_scale_factor: int = 150   # 1/10000
    memcg_reap_background: int = 0
    #: node NIC capacity in bits/s (reference: SystemStrategy
    #: TotalNetworkBandwidth); 0 = unknown (net QoS disabled)
    total_network_bandwidth_bps: int = 0


@dataclasses.dataclass
class HostApplicationSpec:
    """A non-pod host process under QoS management (reference:
    slov1alpha1 host_application.go HostApplicationSpec): named, with a
    QoS class and the cgroup directory its processes live in."""

    name: str
    qos: QoSClass = QoSClass.NONE
    cgroup_dir: str = ""
    priority: int = 0


@dataclasses.dataclass
class NodeSLOSpec:
    """The rendered per-node SLO (reference: slov1alpha1.NodeSLOSpec)."""

    resource_used_threshold_with_be: ResourceThresholdStrategy = (
        dataclasses.field(default_factory=ResourceThresholdStrategy)
    )
    resource_qos_strategy: ResourceQOSStrategy = dataclasses.field(
        default_factory=ResourceQOSStrategy
    )
    cpu_burst_strategy: CPUBurstStrategy = dataclasses.field(
        default_factory=CPUBurstStrategy
    )
    system_strategy: SystemStrategy = dataclasses.field(
        default_factory=SystemStrategy
    )
    host_applications: List[HostApplicationSpec] = dataclasses.field(
        default_factory=list
    )
    extensions: Dict[str, object] = dataclasses.field(default_factory=dict)


def default_node_slo_spec() -> NodeSLOSpec:
    """Reference: sloconfig.DefaultNodeSLOSpecConfig
    (nodeslo_config.go:43-51)."""
    return NodeSLOSpec()
