"""Collector plugin framework for the metrics advisor.

Reference: pkg/koordlet/metricsadvisor/framework/{plugin.go,context.go} —
a registry of collectors, each on its own timer, appending samples to the
metric cache; SharedState passes cross-collector values (e.g. pod usage
for the system-resource collector).

Here collectors are driven by explicit ``collect()`` ticks (the agent
main loop or tests call them; no goroutines), and the shared state is a
typed ``CollectorContext``.

Counterpart of ``koordinator_tpu/koordlet/metricsadvisor/framework.py``:
host work in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Protocol, Sequence

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.metriccache import MetricCache
from koordinator_tpu_torch.koordlet.system.cgroup import SystemConfig


@dataclasses.dataclass
class ContainerBatchResources:
    """One container's koordinator extended (batch) resources, in
    canonical units (reference: util.GetBatchMilliCPUFromResourceList /
    GetBatchMemoryFromResourceList over container requests/limits).
    ``None`` limit = unlimited."""

    request_mcpu: int = 0
    limit_mcpu: Optional[int] = None
    memory_limit_bytes: Optional[int] = None


@dataclasses.dataclass
class PodMeta:
    """What node-local subsystems need to know about a running pod
    (reference: statesinformer.PodMeta: pod + cgroup parent dir)."""

    uid: str
    cgroup_dir: str            # e.g. "kubepods/pod<uid>"
    qos: QoSClass = QoSClass.NONE
    containers: Dict[str, str] = dataclasses.field(default_factory=dict)
    # container name -> cgroup dir
    name: str = ""
    priority: int = 0          # k8s numeric priority (eviction order)
    cpu_request_mcpu: int = 0
    cpu_limit_mcpu: int = 0    # 0 = no limit
    memory_request_mib: int = 0
    memory_limit_mib: int = 0  # 0 = no limit
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: container name -> extended (batch) resources; populated for BE
    #: pods running on reclaimed batch-cpu/batch-memory
    batch_resources: Dict[str, "ContainerBatchResources"] = (
        dataclasses.field(default_factory=dict)
    )
    #: container name -> cpu limit (mCPU); feeds container-level cfs
    #: quota hooks (cpu-normalization). Absent entry = unknown/unlimited.
    container_limits_mcpu: Dict[str, int] = dataclasses.field(
        default_factory=dict
    )
    #: volume name -> PVC claim key ("namespace/name"); feeds the blkio
    #: pod-volume device resolution (pod.Spec.Volumes projection)
    volumes: Dict[str, str] = dataclasses.field(default_factory=dict)


class PodProvider(Protocol):
    """Source of the current pod list (the statesinformer)."""

    def running_pods(self) -> Sequence[PodMeta]: ...


@dataclasses.dataclass
class CollectorContext:
    """Shared collector state (reference: framework/context.go:63
    SharedState): latest per-source usages for cross-collector math."""

    metric_cache: MetricCache
    system_config: SystemConfig
    pod_provider: Optional[PodProvider] = None
    #: latest node usage sample {"cpu": mCPU, "memory": MiB}
    latest_node_usage: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    #: latest per-pod usage {uid: {"cpu": mCPU, "memory": MiB}}
    latest_pod_usage: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )


class Collector(Protocol):
    name: str

    def setup(self, ctx: CollectorContext) -> None: ...

    def collect(self, now: float) -> None: ...

    def enabled(self) -> bool: ...


class MetricsAdvisor:
    """Runs registered collectors (reference: metrics_advisor.go).

    ``tick`` invokes each enabled collector whose interval elapsed;
    ``collect_all`` forces one round (tests, initial sync).
    """

    def __init__(self, ctx: CollectorContext,
                 collectors: Sequence[Collector],
                 interval_seconds: float = 1.0):
        self.ctx = ctx
        self.collectors: List[Collector] = []
        self.interval_seconds = interval_seconds
        self._last_run: Dict[str, float] = {}
        for c in collectors:
            c.setup(ctx)
            self.collectors.append(c)

    def collect_all(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for c in self.collectors:
            if c.enabled():
                c.collect(now)
                self._last_run[c.name] = now

    def tick(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for c in self.collectors:
            if not c.enabled():
                continue
            if now - self._last_run.get(c.name, -1e18) >= self.interval_seconds:
                c.collect(now)
                self._last_run[c.name] = now
