"""QoS classes, priority bands and resource columns, integer-encoded.

Counterpart of ``koordinator_tpu/apis/extension.py``: the same enums in
the same column order, so a lowered ``[..., R]`` array means the same
thing in both packages. Canonical units: CPU in millicores, memory in
MiB (int32 on the device).
"""

from __future__ import annotations

import enum
from typing import Mapping, Optional


class QoSClass(enum.IntEnum):
    """Koordinator QoS classes (reference: apis/extension/qos.go)."""

    NONE = 0
    SYSTEM = 1
    LSE = 2
    LSR = 3
    LS = 4
    BE = 5


class PriorityClass(enum.IntEnum):
    """Koordinator priority classes (reference: apis/extension/priority.go)."""

    NONE = 0
    FREE = 1
    BATCH = 2
    MID = 3
    PROD = 4


#: (min, max) inclusive k8s priority value band per class
PRIORITY_BANDS: Mapping[PriorityClass, tuple] = {
    PriorityClass.PROD: (9000, 9999),
    PriorityClass.MID: (7000, 7999),
    PriorityClass.BATCH: (5000, 5999),
    PriorityClass.FREE: (3000, 3999),
}

_PRIORITY_BY_NAME = {
    "koord-prod": PriorityClass.PROD,
    "koord-mid": PriorityClass.MID,
    "koord-batch": PriorityClass.BATCH,
    "koord-free": PriorityClass.FREE,
}


def priority_class_of(
    name: Optional[str] = None, value: Optional[int] = None
) -> PriorityClass:
    """The priority class from a class name or a numeric priority; the
    name takes precedence (reference: apis/extension/priority.go)."""
    if name:
        p = _PRIORITY_BY_NAME.get(name)
        if p is not None:
            return p
    if value is None:
        return PriorityClass.NONE
    for cls, (lo, hi) in PRIORITY_BANDS.items():
        if lo <= value <= hi:
            return cls
    return PriorityClass.NONE


class ResourceName(enum.IntEnum):
    """Resource columns of every ``[..., R]`` array, in fixed order."""

    CPU = 0           # millicores
    MEMORY = 1        # MiB
    BATCH_CPU = 2     # millicores, reclaimed for BE pods
    BATCH_MEMORY = 3  # MiB, reclaimed for BE pods
    MID_CPU = 4       # millicores, reclaimed for MID pods
    MID_MEMORY = 5    # MiB, reclaimed for MID pods
    GPU = 6           # GPU shares in per-cent of a device
    GPU_MEMORY = 7    # MiB of device memory


#: Number of resource columns in substrate arrays.
NUM_RESOURCES = len(ResourceName)


# -- annotation keys the fine-grained plugins read and write (the same
# strings as ``koordinator_tpu/apis/extension.py``) --------------------------

DOMAIN = "koordinator.tpu"

#: a pod's cpuset / NUMA resource spec (JSON)
ANNOTATION_RESOURCE_SPEC = f"{DOMAIN}/resource-spec"
#: the cpuset and NUMA-node resources allocated to a pod (JSON, PreBind)
ANNOTATION_RESOURCE_STATUS = f"{DOMAIN}/resource-status"
#: the devices allocated to a pod (JSON, PreBind)
ANNOTATION_DEVICE_ALLOCATED = f"{DOMAIN}/device-allocated"
#: a pod's device selection hints per device type (JSON)
ANNOTATION_DEVICE_ALLOCATE_HINTS = f"{DOMAIN}/device-allocate-hints"
#: a pod's joint device allocation spec (JSON)
ANNOTATION_DEVICE_JOINT_ALLOCATE = f"{DOMAIN}/device-joint-allocate"
