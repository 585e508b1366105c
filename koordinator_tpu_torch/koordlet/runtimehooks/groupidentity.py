"""Group identity (bvt) hook: CPU scheduling priority per QoS class.

Reference: pkg/koordlet/runtimehooks/hooks/groupidentity/{rule.go,
interceptor.go} — derives a bvt rule from the merged NodeSLO's
ResourceQOSStrategy (rule.go:78-146 parseRule):

- per-koord-QoS pod values: LSE/LSR -> lsr value, LS -> ls, BE -> be
  (a class's value is its GroupIdentity when its CPUQOS is enabled and
  the cluster CPU policy is groupIdentity, else 0);
- per-kube-QoS *dir* values: besteffort -> be, burstable -> ls,
  guaranteed -> 0 (kernel constraint: guaranteed root stays 0);
- per-kube-QoS *pod fallback* values (pods without koord QoS label):
  guaranteed -> lsr else ls else 0, burstable -> ls, besteffort -> be.

The hook (interceptor.go:29 SetPodBvtValue) resolves a pod's bvt from
its koord QoS first, falling back to its kube QoS tier. The rule-update
callback (rule.go:148-222 ruleUpdateCb) writes the three kube-QoS dir
values and every pod's value through the executor.

Counterpart of
``koordinator_tpu/koordlet/runtimehooks/groupidentity.py``: host work in
files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    CgroupUpdater,
    ResourceUpdateExecutor,
)
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import HookRegistry, Stage
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
    KUBE_QOS_DIR,
    KubeQOS,
    PodContext,
    kube_qos_by_cgroup_parent,
)
from koordinator_tpu_torch.manager.sloconfig import NodeSLOSpec

NAME = "GroupIdentity"
#: the disabled / none value (sloconfig.NoneCPUQOS().GroupIdentity)
BVT_NONE = 0


@dataclasses.dataclass
class BvtRule:
    enable: bool
    pod_qos_params: Dict[QoSClass, int]
    kube_qos_dir_params: Dict[KubeQOS, int]
    kube_qos_pod_params: Dict[KubeQOS, int]
    #: QoS classes whose pods get a shared core-scheduling cookie so SMT
    #: siblings never co-run others' tasks (CPUQOS.core_expeller;
    #: reference: the coresched hook driven by the same rule)
    core_expeller_qos: frozenset = frozenset()

    def pod_bvt(self, qos: QoSClass, kube_qos: KubeQOS) -> int:
        """interceptor.go getPodBvtValue: koord QoS first, kube QoS
        fallback."""
        if qos in self.pod_qos_params:
            return self.pod_qos_params[qos]
        return self.kube_qos_pod_params.get(kube_qos, BVT_NONE)

    def kube_qos_dir_bvt(self, kube_qos: KubeQOS) -> int:
        return self.kube_qos_dir_params.get(kube_qos, BVT_NONE)


def parse_rule(slo: NodeSLOSpec) -> BvtRule:
    """rule.go:78-146 parseRule over the merged NodeSLO spec."""
    strategy = slo.resource_qos_strategy
    lsr_enabled = strategy.lsr.enable
    ls_enabled = strategy.ls.enable
    be_enabled = strategy.be.enable

    lsr_value = strategy.lsr.cpu.group_identity if lsr_enabled else BVT_NONE
    ls_value = strategy.ls.cpu.group_identity if ls_enabled else BVT_NONE
    be_value = strategy.be.cpu.group_identity if be_enabled else BVT_NONE

    # guaranteed pod fallback: lsr if enabled, else ls, else none
    guaranteed_pod = BVT_NONE
    if lsr_enabled:
        guaranteed_pod = lsr_value
    elif ls_enabled:
        guaranteed_pod = ls_value

    return BvtRule(
        enable=lsr_enabled or ls_enabled or be_enabled,
        pod_qos_params={
            QoSClass.LSE: lsr_value,
            QoSClass.LSR: lsr_value,
            QoSClass.LS: ls_value,
            QoSClass.BE: be_value,
        },
        kube_qos_dir_params={
            # guaranteed root dir must stay 0 (kernel constraint)
            KubeQOS.GUARANTEED: BVT_NONE,
            KubeQOS.BURSTABLE: ls_value,
            KubeQOS.BESTEFFORT: be_value,
        },
        kube_qos_pod_params={
            KubeQOS.GUARANTEED: guaranteed_pod,
            KubeQOS.BURSTABLE: ls_value,
            KubeQOS.BESTEFFORT: be_value,
        },
        core_expeller_qos=frozenset(
            qos
            for qos, cfg in (
                (QoSClass.LSE, strategy.lsr),
                (QoSClass.LSR, strategy.lsr),
                (QoSClass.LS, strategy.ls),
            )
            if cfg.enable and cfg.cpu.core_expeller
        ),
    )


class BvtPlugin:
    """The groupidentity hook plugin."""

    name = NAME

    def __init__(self, core_sched=None):
        self._rule: Optional[BvtRule] = None
        #: optional CoreSched (system/core_sched.py) for the expeller
        self.core_sched = core_sched

    # -- rule lifecycle ------------------------------------------------------

    def update_rule(self, slo: NodeSLOSpec) -> bool:
        new = parse_rule(slo)
        changed = new != self._rule
        self._rule = new
        return changed

    @property
    def rule(self) -> Optional[BvtRule]:
        return self._rule

    # -- hook fn -------------------------------------------------------------

    def set_pod_bvt(self, proto) -> None:
        """interceptor.go:29 SetPodBvtValue."""
        if not isinstance(proto, PodContext):
            return
        r = self._rule
        if r is None or not r.enable:
            return
        req = proto.request
        proto.response.cpu_bvt = r.pod_bvt(req.qos, req.kube_qos)

    def register(self, registry: HookRegistry) -> None:
        registry.register(
            Stage.PRE_RUN_POD_SANDBOX, self.name,
            "set bvt value for pod cgroup", self.set_pod_bvt,
        )

    def apply_core_expeller(self, pods: List[PodMeta], pids_of) -> int:
        """Tag each expeller-class pod's tasks with one shared
        core-scheduling cookie (reference: the coresched hook applying the
        CPUQOS core-expeller over PR_SCHED_CORE). ``pids_of(pod)`` reads
        the pod's live pids; returns how many pods were tagged."""
        r = self._rule
        if (
            r is None
            or not r.core_expeller_qos
            or self.core_sched is None
            or not self.core_sched.supported()
        ):
            return 0
        tagged = 0
        for pod in pods:
            if pod.qos not in r.core_expeller_qos:
                continue
            pids = list(pids_of(pod))
            if not pids:
                continue
            self.core_sched.assign_group_cookie(pids[0], pids)
            tagged += 1
        return tagged

    # -- rule-update actuation (rule.go:148-222) -----------------------------

    def rule_update_levels(
        self, pods: List[PodMeta]
    ) -> List[List[CgroupUpdater]]:
        """Leveled bvt writes: kube-QoS dirs first, then pod dirs, then
        container dirs (container values inherit the pod's; written
        explicitly so a disable propagates, rule.go:240-260)."""
        r = self._rule
        if r is None:
            return []
        qos_level = [
            CgroupUpdater(
                "cpu.bvt_warp_ns", KUBE_QOS_DIR[kq],
                str(r.kube_qos_dir_bvt(kq)),
            )
            for kq in (KubeQOS.GUARANTEED, KubeQOS.BURSTABLE,
                       KubeQOS.BESTEFFORT)
        ]
        pod_level = []
        container_level = []
        for pod in pods:
            kube_qos = kube_qos_by_cgroup_parent(pod.cgroup_dir)
            bvt = r.pod_bvt(pod.qos, kube_qos)
            pod_level.append(
                CgroupUpdater("cpu.bvt_warp_ns", pod.cgroup_dir, str(bvt))
            )
            for cdir in pod.containers.values():
                container_level.append(
                    CgroupUpdater("cpu.bvt_warp_ns", cdir, str(bvt))
                )
        return [qos_level, pod_level, container_level]

    def rule_update(self, pods: List[PodMeta],
                    executor: ResourceUpdateExecutor) -> int:
        levels = self.rule_update_levels(pods)
        if not levels:
            return 0
        return executor.leveled_update_batch(levels)
