"""Reporting informers: kubelet-style pod source, NodeResourceTopology,
and Device reporting — the koordlet side of the topology/device pipeline
the scheduler's NUMA/DeviceShare plugins consume.

Reference: pkg/koordlet/statesinformer/impl/
- ``kubelet_stub.go`` + pods informer: scrape the kubelet for the node's
  pod list and publish it into the informer;
- ``states_noderesourcetopology.go:243-320`` (calcNodeTopo /
  calTopologyZoneList): discover CPU topology + per-NUMA resources and
  report the NodeResourceTopology CR the scheduler's
  topology-options manager syncs;
- ``states_device_linux.go``: enumerate accelerator devices and report
  the Device CR for the deviceshare cache.

Here "reporting" is a callback (the in-process API-server bus): the
scheduler wires ``Scheduler.update_node_topology`` /
``Scheduler.update_node_devices`` as the sinks.

Counterpart of ``koordinator_tpu/koordlet/statesinformer/reporters.py``:
host work in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np

from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.device.cache import DeviceEntry
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta
from koordinator_tpu_torch.koordlet.statesinformer.states_informer import (
    StatesInformer,
)
from koordinator_tpu_torch.koordlet.system.cgroup import SystemConfig
from koordinator_tpu_torch.koordlet.system.cpuinfo import (
    ProcessorInfo,
    read_cpu_infos,
)
from koordinator_tpu_torch.numa.hints import NUMATopologyPolicy
from koordinator_tpu_torch.numa.manager import TopologyOptions
from koordinator_tpu_torch.numa.topology import CPUTopology


class KubeletStub(Protocol):
    """The kubelet scrape seam (kubelet_stub.go GetAllPods)."""

    def get_all_pods(self) -> Sequence[PodMeta]: ...


def pod_meta_from_spec(pod) -> PodMeta:
    """Scheduler-side PodSpec -> node-agent PodMeta (the projection a
    kubelet scrape would yield for a pod bound to this node): kube-QoS
    tier from the koordinator QoS class, one ``main`` container, batch
    resources populated for pods running on reclaimed batch-* columns."""
    from koordinator_tpu_torch.apis.extension import QoSClass
    from koordinator_tpu_torch.koordlet.metricsadvisor.framework import (
        ContainerBatchResources,
    )

    # kubelet layout: BE -> besteffort, LS -> burstable, LSR/LSE
    # (guaranteed) sit DIRECTLY under kubepods — cgreconcile's tier
    # rollups and memory.min protection depend on this nesting. Dirs
    # key by pod UID (like the kubelet), not name: same-named pods in
    # different namespaces must not share a cgroup.
    uid_dir = "pod" + pod.uid.replace("/", "_")
    if pod.qos == QoSClass.BE:
        base = f"kubepods/besteffort/{uid_dir}"
    elif pod.qos in (QoSClass.LSR, QoSClass.LSE):
        base = f"kubepods/{uid_dir}"
    else:
        base = f"kubepods/burstable/{uid_dir}"
    meta = PodMeta(
        pod.uid, base, pod.qos,
        containers={"main": f"{base}/main"},
        name=pod.name,
        priority=pod.priority,
        cpu_request_mcpu=pod.requests.get(ResourceName.CPU, 0),
        cpu_limit_mcpu=pod.limits.get(ResourceName.CPU, 0),
        memory_request_mib=pod.requests.get(ResourceName.MEMORY, 0),
        memory_limit_mib=pod.limits.get(ResourceName.MEMORY, 0),
        labels=dict(pod.labels),
        annotations=dict(pod.annotations),
        container_limits_mcpu={
            "main": pod.limits.get(ResourceName.CPU, 0)
        },
        volumes=dict(pod.volumes),
    )
    batch_cpu = pod.requests.get(ResourceName.BATCH_CPU, 0)
    if batch_cpu:
        limit_cpu = pod.limits.get(ResourceName.BATCH_CPU, batch_cpu)
        meta.batch_resources["main"] = ContainerBatchResources(
            request_mcpu=batch_cpu,
            limit_mcpu=limit_cpu,
            memory_limit_bytes=pod.limits.get(
                ResourceName.BATCH_MEMORY,
                pod.requests.get(ResourceName.BATCH_MEMORY, 0),
            ) * 1024 * 1024,
        )
    return meta


class PodsInformer:
    """Polls the kubelet stub and publishes the pod list (the reference's
    pods informer plugin; the poll interval is the caller's tick)."""

    def __init__(self, stub: KubeletStub, informer: StatesInformer):
        self.stub = stub
        self.informer = informer

    def sync(self) -> List[PodMeta]:
        pods = list(self.stub.get_all_pods())
        self.informer.set_pods(pods)
        return pods


@dataclasses.dataclass
class NodeTopologyReport:
    """What the NRT CR carries (zones: cpu topology + per-NUMA amounts)."""

    node_name: str
    options: TopologyOptions


class NodeTopologyReporter:
    """Builds TopologyOptions from the discovered CPU topology and
    per-NUMA memory, and reports through the sink
    (states_noderesourcetopology.go calcNodeTopo)."""

    def __init__(
        self,
        node_name: str,
        system_config: SystemConfig,
        report: Callable[[str, TopologyOptions], None],
        policy: NUMATopologyPolicy = NUMATopologyPolicy.NONE,
        numa_memory_mib: Optional[Dict[int, int]] = None,
        cpu_infos: Optional[Sequence[ProcessorInfo]] = None,
    ):
        self.node_name = node_name
        self.system_config = system_config
        self.report = report
        self.policy = policy
        #: per-NUMA memory; None = split evenly is impossible without a
        #: source, so memory is omitted from the zones
        self.numa_memory_mib = numa_memory_mib
        self._cpu_infos = cpu_infos
        self.last_report: Optional[NodeTopologyReport] = None

    def sync(self) -> Optional[NodeTopologyReport]:
        infos = (
            list(self._cpu_infos)
            if self._cpu_infos is not None
            else read_cpu_infos(self.system_config)
        )
        if not infos:
            return None
        infos.sort(key=lambda p: p.cpu_id)
        n = infos[-1].cpu_id + 1
        present = {p.cpu_id for p in infos}
        # offline / hot-removed cpus leave id holes: they must be neither
        # pinnable nor counted as capacity — reserve them out
        holes = [cpu for cpu in range(n) if cpu not in present]
        core = np.zeros(n, dtype=np.int64)
        node = np.zeros(n, dtype=np.int64)
        socket = np.zeros(n, dtype=np.int64)
        for p in infos:
            # cores are socket-local ids in /proc/cpuinfo; globalize
            core[p.cpu_id] = p.socket_id * 10_000 + p.core_id
            node[p.cpu_id] = p.node_id
            socket[p.cpu_id] = p.socket_id
        for cpu in holes:  # phantom slots get a unique non-colliding core
            core[cpu] = -1 - cpu
        # densify core ids
        _, core = np.unique(core, return_inverse=True)
        topology = CPUTopology(
            core_id=core, node_id=node, socket_id=socket
        )
        per_node_cpus: Dict[int, int] = {}
        for p in infos:  # count only PRESENT cpus toward capacity
            per_node_cpus[p.node_id] = per_node_cpus.get(p.node_id, 0) + 1
        numa_resources: Dict[int, Dict] = {}
        for numa_id in sorted(per_node_cpus):
            res = {ResourceName.CPU: per_node_cpus[numa_id] * 1000}
            if self.numa_memory_mib is not None:
                res[ResourceName.MEMORY] = self.numa_memory_mib.get(numa_id, 0)
            numa_resources[numa_id] = res
        options = TopologyOptions(
            cpu_topology=topology,
            policy=self.policy,
            numa_node_resources=numa_resources,
            reserved_cpus=tuple(holes),
        )
        self.last_report = NodeTopologyReport(self.node_name, options)
        self.report(self.node_name, options)
        return self.last_report


class DeviceSource(Protocol):
    """Accelerator inventory seam (states_device_linux.go enumerates via
    NVML; tests and other hosts provide typed inventories)."""

    def list_devices(self) -> Sequence[DeviceEntry]: ...


class DeviceReporter:
    """Reports the node's device inventory to the scheduler's device
    cache (the Device CR reporting path)."""

    def __init__(
        self,
        node_name: str,
        source: DeviceSource,
        report: Callable[[str, Sequence[DeviceEntry]], None],
    ):
        self.node_name = node_name
        self.source = source
        self.report = report

    def sync(self) -> List[DeviceEntry]:
        entries = list(self.source.list_devices())
        self.report(self.node_name, entries)
        return entries
