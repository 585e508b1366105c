"""BlkIOReconcile: block-device throttling per QoS tier and pod.

Reference: pkg/koordlet/qosmanager/plugins/blkio/blkio_reconcile.go — the
NodeSLO's per-QoS BlkIOQOS block configs become
``blkio.throttle.{read,write}_{bps,iops}_device`` writes on the QoS tier
cgroup dir and every member pod's dir (:106-243, updateBlkIOConfig;
getBlkIOUpdaterFromBlockCfg :311-373). The reference resolves volume
groups/pod volumes to disk numbers on the host; the typed model addresses
devices by MAJ:MIN directly. A zero limit removes the throttle (writes
``MAJ:MIN 0`` → kernel clears, matching getBlkIORemoverFromDiskNumber).

Counterpart of ``koordinator_tpu/koordlet/qosmanager/blkio.py``: host
work in files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.qosmanager.framework import QoSContext
from koordinator_tpu_torch.koordlet.resourceexecutor.executor import CgroupUpdater
from koordinator_tpu_torch.manager.sloconfig import BlockCfg

_QOS_DIR = {
    QoSClass.BE: "kubepods/besteffort",
    QoSClass.LS: "kubepods/burstable",
}

_FILES = (
    ("blkio.throttle.read_bps_device", "read_bps"),
    ("blkio.throttle.write_bps_device", "write_bps"),
    ("blkio.throttle.read_iops_device", "read_iops"),
    ("blkio.throttle.write_iops_device", "write_iops"),
)


def block_updaters(parent_dir: str, block: BlockCfg) -> List[CgroupUpdater]:
    """The four throttle writes for one device on one cgroup dir."""
    out = []
    for resource_type, field_name in _FILES:
        value = getattr(block, field_name)
        out.append(
            CgroupUpdater(
                resource_type,
                parent_dir,
                f"{block.device} {value}",
                key_extra=block.device,  # one cache entry per device
            )
        )
    return out


class BlkIOReconcile:
    name = "blkio"
    interval_seconds = 10.0

    def __init__(self):
        #: cgroup dir -> devices throttled by a previous pass; a device
        #: that disappears from the config gets an explicit "dev 0"
        #: remover write (reference: getBlkIORemoverFromDiskNumber)
        self._applied: dict = {}

    def enabled(self, ctx: QoSContext) -> bool:
        strategy = ctx.node_slo.resource_qos_strategy
        return bool(self._applied) or any(
            strategy.for_qos(q).blkio for q in (QoSClass.LS, QoSClass.BE)
        )

    def execute(self, ctx: QoSContext, now: float) -> None:
        strategy = ctx.node_slo.resource_qos_strategy
        updates: List[CgroupUpdater] = []
        live: dict = {}

        def throttle(parent_dir: str, blocks) -> None:
            for block in blocks:
                updates.extend(block_updaters(parent_dir, block))
                live.setdefault(parent_dir, set()).add(block.device)

        def resolve_pod_volume(pod, block):
            """volume name -> PVC claim -> bound PV -> device
            (blkio_reconcile.go:387-411 BlockTypePodVolume); None when
            any link is missing — the throttle is skipped, matching the
            reference's error-and-continue."""
            claim = pod.volumes.get(block.name)
            if not claim or ctx.volume_name_fn is None:
                return None
            pv = ctx.volume_name_fn(claim)
            device = ctx.volume_devices.get(pv) if pv else None
            if not device:
                return None
            return dataclasses.replace(
                block, device=device, block_type="device", name=""
            )

        for qos, tier_dir in _QOS_DIR.items():
            blocks = strategy.for_qos(qos).blkio
            if not blocks:
                continue
            device_blocks = [
                b for b in blocks if b.block_type != "pod_volume"
            ]
            volume_blocks = [
                b for b in blocks if b.block_type == "pod_volume"
            ]
            throttle(tier_dir, device_blocks)
            for pod in ctx.pod_provider.running_pods():
                if pod.qos != qos:
                    continue
                throttle(pod.cgroup_dir, device_blocks)
                for block in volume_blocks:
                    resolved = resolve_pod_volume(pod, block)
                    if resolved is not None:
                        throttle(pod.cgroup_dir, [resolved])

        # stale devices: explicitly clear the kernel throttle
        for parent_dir, devices in self._applied.items():
            for device in devices - live.get(parent_dir, set()):
                updates.extend(
                    block_updaters(parent_dir, BlockCfg(device=device))
                )
        self._applied = live

        for up in updates:
            ctx.executor.update(True, up)
            ctx.log("blkio", up.parent_dir, up.resource_type, up.value)
