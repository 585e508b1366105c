"""The QoS strategies that actuate a node (counterpart of
``koordinator_tpu/koordlet/qosmanager``)."""

from koordinator_tpu_torch.koordlet.qosmanager.framework import (
    CPUInfo,
    QoSContext,
    QoSManager,
)
from koordinator_tpu_torch.koordlet.qosmanager.cpusuppress import CPUSuppress
from koordinator_tpu_torch.koordlet.qosmanager.evictors import CPUEvictor, MemoryEvictor
from koordinator_tpu_torch.koordlet.qosmanager.cpuburst import CPUBurst
from koordinator_tpu_torch.koordlet.qosmanager.resctrl import ResctrlReconcile
from koordinator_tpu_torch.koordlet.qosmanager.cgreconcile import (
    CgroupResourcesReconcile,
)
from koordinator_tpu_torch.koordlet.qosmanager.blkio import BlkIOReconcile
from koordinator_tpu_torch.koordlet.qosmanager.sysreconcile import (
    SystemConfigReconcile,
)

__all__ = [
    "CPUInfo",
    "QoSContext",
    "QoSManager",
    "CPUSuppress",
    "CPUEvictor",
    "MemoryEvictor",
    "CPUBurst",
    "ResctrlReconcile",
    "CgroupResourcesReconcile",
    "BlkIOReconcile",
    "SystemConfigReconcile",
]
