"""QoS strategy framework: timed plugins that actuate node QoS.

Reference: pkg/koordlet/qosmanager/{qosmanager.go,framework/strategy.go,
framework/context.go} — each strategy runs on its own interval with
access to the states informer, metric cache, and resource executor; the
helpers' eviction path is shared.

Counterpart of ``koordinator_tpu/koordlet/qosmanager/framework.py``:
host work in files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Protocol, Sequence

from koordinator_tpu_torch.koordlet.audit import Auditor
from koordinator_tpu_torch.koordlet.metriccache import MetricCache
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta, PodProvider
from koordinator_tpu_torch.koordlet.resourceexecutor import ResourceUpdateExecutor
from koordinator_tpu_torch.manager.sloconfig import NodeSLOSpec
from koordinator_tpu_torch.koordlet.system.cgroup import SystemConfig


@dataclasses.dataclass(frozen=True)
class CPUInfo:
    """One logical processor (reference: koordletutil.ProcessorInfo)."""

    cpu_id: int
    core_id: int
    socket_id: int
    node_id: int  # NUMA node


#: Eviction callback: (pods, reason) -> uids actually evicted. The node
#: agent wires this to the apiserver eviction API (reference:
#: framework.Evictor.EvictPodsIfNotEvicted).
EvictFn = Callable[[List[PodMeta], str], List[str]]


@dataclasses.dataclass
class QoSContext:
    """Shared strategy dependencies (reference: framework/context.go)."""

    metric_cache: MetricCache
    executor: ResourceUpdateExecutor
    pod_provider: PodProvider
    system_config: SystemConfig
    node_slo: NodeSLOSpec = dataclasses.field(default_factory=NodeSLOSpec)
    node_capacity_mcpu: int = 0
    node_capacity_mem_mib: int = 0
    node_reserved_mcpu: int = 0
    cpu_infos: List[CPUInfo] = dataclasses.field(default_factory=list)
    evict: Optional[EvictFn] = None
    auditor: Optional[Auditor] = None
    #: cgroup parent of the best-effort QoS tier (reference:
    #: koordletutil.GetPodQoSRelativePath(PodQOSBestEffort))
    be_cgroup_dir: str = "kubepods/besteffort"
    #: PVC claim key ("namespace/name") -> bound PV name (the
    #: statesinformer's get_volume_name; states_pvc.go)
    volume_name_fn: Optional[Callable[[str], str]] = None
    #: active cpu-normalization ratio (node annotation, parsed by the
    #: informer wiring); quota-burst bases divide by it so the two
    #: features compose instead of fighting
    cpu_normalization_ratio: Optional[float] = None
    #: PV name -> block device "MAJ:MIN" (the host's volume attachment
    #: view; the reference walks /var/lib/kubelet + sysfs for this)
    volume_devices: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: how far back "latest" metric queries look
    metric_collect_interval: float = 60.0
    #: BE tier allocatable (node batch-cpu), for the cpu-evict
    #: evictByAllocatable policy (cpu_evict.go getBEMilliAllocatable);
    #: None = unknown, the policy falls back to the real-limit path
    be_allocatable_fn: Optional[Callable[[], Optional[int]]] = None

    def log(self, group: str, subject: str, op: str, detail: str = "") -> None:
        if self.auditor is not None:
            self.auditor.log(group, subject, op, detail)


class QoSStrategy(Protocol):
    name: str
    interval_seconds: float

    def enabled(self, ctx: QoSContext) -> bool: ...

    def execute(self, ctx: QoSContext, now: float) -> None: ...


class QoSManager:
    """Runs strategies on their intervals (reference: qosmanager.go:42-51
    registers cpusuppress, cpuevict, memoryevict, cpuburst, ...)."""

    def __init__(self, ctx: QoSContext, strategies: Sequence[QoSStrategy]):
        self.ctx = ctx
        self.strategies = list(strategies)
        self._last_run: Dict[str, float] = {}

    def tick(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for s in self.strategies:
            last = self._last_run.get(s.name, -1e18)
            if now - last < s.interval_seconds:
                continue
            if s.enabled(self.ctx):
                s.execute(self.ctx, now)
            self._last_run[s.name] = now

    def run_all(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for s in self.strategies:
            if s.enabled(self.ctx):
                s.execute(self.ctx, now)
            self._last_run[s.name] = now
