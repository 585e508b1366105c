"""Hook protocol: typed request/response contexts for pod lifecycle.

Reference: pkg/koordlet/runtimehooks/protocol/{protocol.go,
pod_context.go, container_context.go, kubeqos_context.go} — each hook
invocation carries a request (pod/container identity + labels,
annotations, cgroup parent, extended resources) and fills a response of
cgroup-level resource values (protocol.go:76-82: CPUShares, CFSQuota,
CPUSet, MemoryLimit, CPUBvt). The context then turns the response into
executor updates (injectForOrder / ReconcilerDone).

Values are canonical cgroup units: cpu shares (v1 scale), cfs quota
microseconds (-1 unlimited), memory bytes (-1 unlimited), bvt in
[-1, 2], cpuset as a cpu-list string ("" allowed: clears the set).

Counterpart of ``koordinator_tpu/koordlet/runtimehooks/protocol.py``:
host work in files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import (
    ContainerBatchResources,
    PodMeta,
)
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    CgroupUpdater,
    ResourceUpdateExecutor,
    merge_if_cfs_quota_larger,
    merge_if_value_larger,
)

#: v1 cpu shares bounds (util/system cgroup.go:236-248)
CPU_SHARES_MIN, CPU_SHARES_MAX = 2, 262144
CFS_BASE_PERIOD_US = 100_000
CFS_QUOTA_MIN_US = 1000


def milli_cpu_to_shares(milli: int) -> int:
    """Reference: sysutil.MilliCPUToShares (cgroup.go:236-248)."""
    if milli <= 0:
        return CPU_SHARES_MIN
    return max(CPU_SHARES_MIN, min(CPU_SHARES_MAX, milli * 1024 // 1000))


def milli_cpu_to_quota(milli: int) -> int:
    """Reference: sysutil.MilliCPUToQuota (cgroup.go:250-258): <= 0 is
    unlimited (-1); floor at 1000us."""
    quota = milli * CFS_BASE_PERIOD_US // 1000
    if quota <= 0:
        return -1
    return max(quota, CFS_QUOTA_MIN_US)


class KubeQOS(enum.Enum):
    """The k8s-native QoS tier (cgroup tree position)."""

    GUARANTEED = "guaranteed"
    BURSTABLE = "burstable"
    BESTEFFORT = "besteffort"


#: Reference: koordletutil.GetPodQoSRelativePath — guaranteed pods live
#: directly under the kubepods root.
KUBE_QOS_DIR = {
    KubeQOS.GUARANTEED: "kubepods",
    KubeQOS.BURSTABLE: "kubepods/burstable",
    KubeQOS.BESTEFFORT: "kubepods/besteffort",
}


def kube_qos_by_cgroup_parent(cgroup_dir: str) -> KubeQOS:
    """Reference: koordletutil.GetKubeQoSByCgroupParent."""
    if "besteffort" in cgroup_dir:
        return KubeQOS.BESTEFFORT
    if "burstable" in cgroup_dir:
        return KubeQOS.BURSTABLE
    return KubeQOS.GUARANTEED


@dataclasses.dataclass
class Resources:
    """The hook response payload (protocol.go:76-87). ``None`` = leave
    the current cgroup value alone."""

    cpu_shares: Optional[int] = None
    cfs_quota_us: Optional[int] = None
    cpuset: Optional[str] = None
    memory_limit_bytes: Optional[int] = None
    cpu_bvt: Optional[int] = None
    #: env vars to ADD to the container (reference: ContainerResponse
    #: AddContainerEnvs, used by the device hook). Only meaningful at
    #: container creation — NRI adjustment / CRI-proxy request merge;
    #: inert in standalone cgroup reconcile (no cgroup file to write).
    add_envs: Optional[Dict[str, str]] = None

    def is_origin_res_changed(self) -> bool:
        return (
            self.cpu_shares is not None
            or self.cfs_quota_us is not None
            or self.cpuset is not None
            or self.memory_limit_bytes is not None
        )

    def updaters(self, cgroup_dir: str) -> List[CgroupUpdater]:
        """Lower the response to executor updates against one cgroup dir
        (protocol.go:127-160 injectCPUShares/CPUSet/CPUQuota/Memory)."""
        out: List[CgroupUpdater] = []
        if self.cpu_shares is not None:
            out.append(CgroupUpdater(
                "cpu.shares", cgroup_dir, str(self.cpu_shares),
                merge_if_value_larger,
            ))
        if self.cfs_quota_us is not None:
            out.append(CgroupUpdater(
                "cpu.cfs_quota_us", cgroup_dir, str(self.cfs_quota_us),
                merge_if_cfs_quota_larger,
            ))
        if self.memory_limit_bytes is not None:
            out.append(CgroupUpdater(
                "memory.limit_in_bytes", cgroup_dir,
                str(self.memory_limit_bytes), merge_if_value_larger,
            ))
        if self.cpuset is not None and self.cpuset != "":
            # an empty cpuset response means "clear": cpuset.cpus cannot
            # be written empty, so the reconciler simply leaves the file
            # (the kubelet/cpu-suppress owns it then)
            out.append(CgroupUpdater("cpuset.cpus", cgroup_dir, self.cpuset))
        if self.cpu_bvt is not None:
            out.append(CgroupUpdater(
                "cpu.bvt_warp_ns", cgroup_dir, str(self.cpu_bvt)
            ))
        return out


@dataclasses.dataclass
class PodRequest:
    """pod_context.go PodRequest: identity + attrs + cgroup parent."""

    pod_meta: PodMeta

    @property
    def labels(self) -> Dict[str, str]:
        return self.pod_meta.labels

    @property
    def annotations(self) -> Dict[str, str]:
        return self.pod_meta.annotations

    @property
    def cgroup_parent(self) -> str:
        return self.pod_meta.cgroup_dir

    @property
    def qos(self) -> QoSClass:
        return self.pod_meta.qos

    @property
    def kube_qos(self) -> KubeQOS:
        return kube_qos_by_cgroup_parent(self.pod_meta.cgroup_dir)

    @property
    def batch_resources(self) -> Dict[str, ContainerBatchResources]:
        return self.pod_meta.batch_resources


@dataclasses.dataclass
class ContainerRequest:
    pod_meta: PodMeta
    container_name: str
    cgroup_parent: str

    @property
    def labels(self) -> Dict[str, str]:
        return self.pod_meta.labels

    @property
    def annotations(self) -> Dict[str, str]:
        return self.pod_meta.annotations

    @property
    def qos(self) -> QoSClass:
        return self.pod_meta.qos

    @property
    def kube_qos(self) -> KubeQOS:
        return kube_qos_by_cgroup_parent(self.cgroup_parent)

    @property
    def batch(self) -> Optional[ContainerBatchResources]:
        return self.pod_meta.batch_resources.get(self.container_name)


class HooksProtocol:
    """Base context: request + response + apply (protocol.go:32-36)."""

    def updaters(self) -> List[CgroupUpdater]:
        raise NotImplementedError

    def reconciler_done(self, executor: ResourceUpdateExecutor) -> int:
        """Apply the response through the shared executor; returns the
        number of files written."""
        return executor.update_batch(True, self.updaters())


@dataclasses.dataclass
class PodContext(HooksProtocol):
    request: PodRequest
    response: Resources = dataclasses.field(default_factory=Resources)

    @classmethod
    def from_meta(cls, pod: PodMeta) -> "PodContext":
        return cls(request=PodRequest(pod_meta=pod))

    def updaters(self) -> List[CgroupUpdater]:
        return self.response.updaters(self.request.cgroup_parent)


@dataclasses.dataclass
class ContainerContext(HooksProtocol):
    request: ContainerRequest
    response: Resources = dataclasses.field(default_factory=Resources)

    @classmethod
    def from_meta(cls, pod: PodMeta, container: str) -> "ContainerContext":
        return cls(request=ContainerRequest(
            pod_meta=pod,
            container_name=container,
            cgroup_parent=pod.containers.get(
                container, f"{pod.cgroup_dir}/{container}"
            ),
        ))

    def updaters(self) -> List[CgroupUpdater]:
        return self.response.updaters(self.request.cgroup_parent)


@dataclasses.dataclass
class KubeQOSContext(HooksProtocol):
    """kubeqos_context.go: reconcile target for a QoS tier root dir."""

    kube_qos: KubeQOS
    response: Resources = dataclasses.field(default_factory=Resources)

    @property
    def cgroup_parent(self) -> str:
        return KUBE_QOS_DIR[self.kube_qos]

    def updaters(self) -> List[CgroupUpdater]:
        return self.response.updaters(self.cgroup_parent)
