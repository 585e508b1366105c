"""CgroupResourcesReconcile: memcg QoS knobs per tier/pod/container.

Reference: pkg/koordlet/qosmanager/plugins/cgreconcile/cgroup_reconcile.go
— per reconcile pass it computes, from the NodeSLO ResourceQOSStrategy's
MemoryQOS, the container-level memcg values (:283-354):

    memory.min  = request * minLimitPercent / 100
    memory.low  = request * lowLimitPercent / 100
    memory.high = limit (or node total) * throttlingPercent / 100
    memory.wmark_ratio / wmark_scale_factor / priority / oom.group

pod level sums its containers (:237-281), and the QoS tier dir sums its
pods (:190-208, updateCgroupSummaryForQoS), written top-down through the
merging executor.

Counterpart of ``koordinator_tpu/koordlet/qosmanager/cgreconcile.py``:
host work in files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.qosmanager.framework import QoSContext
from koordinator_tpu_torch.koordlet.resourceexecutor.executor import CgroupUpdater
from koordinator_tpu_torch.koordlet.system.cgroup import CgroupVersion

MIB = 1024 * 1024

#: QoS tier cgroup dirs (kubelet layout)
_QOS_DIR = {
    QoSClass.BE: "kubepods/besteffort",
    QoSClass.LS: "kubepods/burstable",
}


@dataclasses.dataclass
class _Summary:
    """Per-tier rollup (cgroupResourceSummary)."""

    memory_min: int = 0
    memory_low: int = 0


class CgroupResourcesReconcile:
    name = "cgreconcile"
    interval_seconds = 10.0

    def enabled(self, ctx: QoSContext) -> bool:
        strategy = ctx.node_slo.resource_qos_strategy
        return any(
            strategy.for_qos(q).memory is not None
            and strategy.for_qos(q).enable
            for q in (QoSClass.LS, QoSClass.BE, QoSClass.LSR)
        )

    def execute(self, ctx: QoSContext, now: float) -> None:
        strategy = ctx.node_slo.resource_qos_strategy
        node_total_bytes = ctx.node_capacity_mem_mib * MIB
        summaries: Dict[QoSClass, _Summary] = {
            QoSClass.LS: _Summary(),
            QoSClass.BE: _Summary(),
        }
        updates: List[CgroupUpdater] = []
        for pod in ctx.pod_provider.running_pods():
            cfg = strategy.for_qos(pod.qos)
            if not cfg.enable or cfg.memory is None:
                continue
            mem = cfg.memory
            # PodMeta carries pod-level requests (the reference iterates
            # container specs); containers split the pod request evenly
            request = pod.memory_request_mib * MIB
            limit = (pod.memory_limit_mib or 0) * MIB or node_total_bytes
            pod_min = request * mem.min_limit_percent // 100
            pod_low = request * mem.low_limit_percent // 100
            pod_high = (
                limit * mem.throttling_percent // 100
                if mem.throttling_percent
                else 0
            )
            n_containers = max(len(pod.containers), 1)
            for cname, cdir in sorted(pod.containers.items()):
                updates += self._container_updates(
                    cdir,
                    mem,
                    pod_min // n_containers,
                    pod_low // n_containers,
                    pod_high // n_containers,
                )
            # only pods actually living under a managed tier dir roll up
            # into it (LSR/LSE guaranteed pods sit directly under
            # kubepods, not burstable)
            tier = summaries.get(pod.qos)
            if tier is not None:
                tier.memory_min += pod_min
                tier.memory_low += pod_low
            updates.append(CgroupUpdater("memory.min", pod.cgroup_dir, str(pod_min)))
            updates.append(CgroupUpdater("memory.low", pod.cgroup_dir, str(pod_low)))

        # tier dirs written first (top-down hierarchy constraint)
        tier_updates: List[CgroupUpdater] = []
        for qos, summary in summaries.items():
            d = _QOS_DIR[qos]
            tier_updates.append(
                CgroupUpdater("memory.min", d, str(summary.memory_min))
            )
            tier_updates.append(
                CgroupUpdater("memory.low", d, str(summary.memory_low))
            )
        for up in tier_updates + updates:
            ctx.executor.update(True, up)
            ctx.log("cgreconcile", up.parent_dir, up.resource_type, up.value)

    def _container_updates(self, cdir, mem, c_min, c_low, c_high) -> List[CgroupUpdater]:
        return [
            CgroupUpdater("memory.min", cdir, str(c_min)),
            CgroupUpdater("memory.low", cdir, str(c_low)),
            # disabled knobs reset to their neutral values so a config
            # rollback clears previously-applied limits
            CgroupUpdater(
                "memory.high", cdir, str(c_high) if c_high > 0 else "max"
            ),
            CgroupUpdater("memory.wmark_ratio", cdir, str(mem.wmark_ratio)),
            CgroupUpdater(
                "memory.wmark_scale_factor", cdir, str(mem.wmark_scale_permill)
            ),
            CgroupUpdater(
                "memory.priority",
                cdir,
                str(mem.priority) if mem.priority_enable else "0",
            ),
            CgroupUpdater("memory.oom.group", cdir, str(mem.oom_kill_group)),
        ]
