"""CPUSet hook: pin containers to scheduler-allocated cpus/share pools.

Reference: pkg/koordlet/runtimehooks/hooks/cpuset/{cpuset.go,rule.go} —
the container cpuset resolves in priority order (rule.go:46-146
getContainerCPUSet):

1. pod annotation ``koordinator.sh/resource-status`` carrying an explicit
   cpuset (LSE/LSR pods pinned by the scheduler's NodeNUMAResource
   PreBind) -> use it verbatim (cpuset.go:114 GetCPUSetFromPod);
2. NUMA-aware allocation (numaNodeResources with cpu) -> join the share
   pools of the allocated NUMA nodes (BE pods use the BE share pools);
3. QoS=SYSTEM -> the system QoS cpuset if configured;
4. QoS=LS -> all share pools;
5. kube besteffort tier -> empty string (cpu-suppress owns the BE dirs);
6. kubelet static policy -> leave alone (None); none policy -> all
   share pools.

Pods pinned via annotation also get their cfs quota unset
(cpuset.go:171-214 UnsetPodCPUQuota: avoid throttling a pinned pod,
issue #489).

Share pools come from the node topology the agent reports (reference:
NodeResourceTopology CR annotations); here `NodeTopoInfo` carries them
(statesinformer Device/NRT reporting).

Counterpart of ``koordinator_tpu/koordlet/runtimehooks/cpuset.py``: host
work in files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_RESOURCE_STATUS,
    QoSClass,
    ResourceName,
)
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import HookRegistry, Stage
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
    ContainerContext,
    KubeQOS,
    PodContext,
)

NAME = "CPUSetAllocator"

#: kubelet cpu-manager policies (extension.KubeletCPUManagerPolicy)
KUBELET_POLICY_NONE = "none"
KUBELET_POLICY_STATIC = "static"


def parse_resource_status(annotations: Dict[str, str]) -> Optional[dict]:
    raw = annotations.get(ANNOTATION_RESOURCE_STATUS)
    if not raw:
        return None
    try:
        status = json.loads(raw)
    except ValueError:
        return None
    return status if isinstance(status, dict) else None


def cpuset_from_status(status: Optional[dict]) -> Optional[str]:
    """The scheduler-pinned cpuset, as a cpu-list string (reference:
    util.GetCPUSetFromPod). None when the pod carries no allocation."""
    if not status:
        return None
    cpus = status.get("cpuset")
    if not cpus:
        return None
    if isinstance(cpus, str):
        return cpus
    return ",".join(str(int(c)) for c in cpus)


def cpuset_from_annotation(annotations: Dict[str, str]) -> Optional[str]:
    return cpuset_from_status(parse_resource_status(annotations))


def numa_nodes_from_status(status: Optional[dict]) -> List[int]:
    """NUMA nodes the scheduler allocated cpu (or batch-cpu) on
    (rule.go:66-78 isNUMAAware check)."""
    if not status:
        return []
    out = []
    for entry in status.get("numaNodeResources", []) or []:
        res = entry.get("resources") or {}
        cpu = res.get(str(int(ResourceName.CPU)), res.get(int(ResourceName.CPU), 0))
        batch = res.get(
            str(int(ResourceName.BATCH_CPU)),
            res.get(int(ResourceName.BATCH_CPU), 0),
        )
        if cpu or batch:
            out.append(int(entry.get("node", 0)))
    return out


@dataclasses.dataclass
class NodeTopoInfo:
    """What the cpuset rule needs from the node topology report."""

    #: NUMA node -> shared-pool cpuset string (LS pods / default)
    share_pools: Dict[int, str] = dataclasses.field(default_factory=dict)
    #: NUMA node -> BE shared-pool cpuset string
    be_share_pools: Dict[int, str] = dataclasses.field(default_factory=dict)
    system_qos_cpuset: str = ""
    kubelet_policy: str = KUBELET_POLICY_NONE


@dataclasses.dataclass
class CpusetRule:
    share_pools: Dict[int, str]
    be_share_pools: Dict[int, str]
    system_qos_cpuset: str
    kubelet_policy: str

    def all_share_pools(self) -> str:
        return ",".join(
            self.share_pools[n] for n in sorted(self.share_pools)
        )

    def container_cpuset(self, req, status: Optional[dict] = None) -> Optional[str]:
        """rule.go:46-146; None = leave alone, "" = clear. ``status`` is
        the pre-parsed resource-status annotation (parsed once per hook
        invocation)."""
        if status is None:
            status = parse_resource_status(req.annotations)
        pinned = cpuset_from_status(status)
        if pinned is not None:
            return pinned

        numa_nodes = numa_nodes_from_status(status)
        if numa_nodes:
            pools = (
                self.be_share_pools if req.qos is QoSClass.BE
                else self.share_pools
            )
            return ",".join(
                pools[n] for n in numa_nodes if n in pools
            )

        if req.qos is QoSClass.SYSTEM and self.system_qos_cpuset:
            return self.system_qos_cpuset

        if req.qos is QoSClass.LS:
            return self.all_share_pools()

        if req.kube_qos is KubeQOS.BESTEFFORT:
            # BE dirs are owned by cpu-suppress; clear container pins
            return ""

        if self.kubelet_policy == KUBELET_POLICY_STATIC:
            return None
        return self.all_share_pools()


class CpusetPlugin:
    name = NAME

    def __init__(self):
        self._rule: Optional[CpusetRule] = None

    def update_rule(self, topo: NodeTopoInfo) -> bool:
        new = CpusetRule(
            share_pools=dict(topo.share_pools),
            be_share_pools=dict(topo.be_share_pools),
            system_qos_cpuset=topo.system_qos_cpuset,
            kubelet_policy=topo.kubelet_policy,
        )
        changed = new != self._rule
        self._rule = new
        return changed

    @property
    def rule(self) -> Optional[CpusetRule]:
        return self._rule

    # -- hook fns ------------------------------------------------------------

    def set_container_cpuset(self, proto) -> None:
        """cpuset.go:105 SetContainerCPUSet (+ :94 unset CFS)."""
        if not isinstance(proto, ContainerContext):
            return
        req = proto.request
        status = parse_resource_status(req.annotations)
        pinned = cpuset_from_status(status)
        if pinned is not None:
            proto.response.cpuset = pinned
            proto.response.cfs_quota_us = -1  # UnsetContainerCPUQuota
            return
        if self._rule is None:
            return
        proto.response.cpuset = self._rule.container_cpuset(req, status)

    def unset_pod_cpu_quota(self, proto) -> None:
        """cpuset.go:171 UnsetPodCPUQuota for annotation-pinned pods."""
        if not isinstance(proto, PodContext):
            return
        if cpuset_from_annotation(proto.request.annotations) is not None:
            proto.response.cfs_quota_us = -1

    def register(self, registry: HookRegistry) -> None:
        registry.register(
            Stage.PRE_CREATE_CONTAINER, self.name,
            "set container cpuset from annotation/share pools",
            self.set_container_cpuset,
        )
        registry.register(
            Stage.PRE_RUN_POD_SANDBOX, self.name,
            "unset cfs quota for cpuset-pinned pods",
            self.unset_pod_cpu_quota,
        )
        registry.register(
            Stage.PRE_UPDATE_CONTAINER_RESOURCES, self.name,
            "re-apply container cpuset on update",
            self.set_container_cpuset,
        )
