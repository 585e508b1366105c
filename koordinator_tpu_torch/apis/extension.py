"""QoS classes, priority bands and resource columns, integer-encoded.

Counterpart of ``koordinator_tpu/apis/extension.py``: the same enums in
the same column order, so a lowered ``[..., R]`` array means the same
thing in both packages. Canonical units: CPU in millicores, memory in
MiB (int32 on the device).
"""

from __future__ import annotations

import enum
import json
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

#: a pod's QoS class label (the terway QoS hook reads it)
LABEL_QOS_CLASS = f"{DOMAIN}/qosClass"

#: a pod's cpuset / NUMA resource spec (JSON)
ANNOTATION_RESOURCE_SPEC = f"{DOMAIN}/resource-spec"
#: the cpuset and NUMA-node resources allocated to a pod (JSON, PreBind)
ANNOTATION_RESOURCE_STATUS = f"{DOMAIN}/resource-status"
#: the reservation a pod consumed (PreBind of the plugin chain)
ANNOTATION_RESERVATION_ALLOCATED = f"{DOMAIN}/reservation-allocated"
#: the devices allocated to a pod (JSON, PreBind)
ANNOTATION_DEVICE_ALLOCATED = f"{DOMAIN}/device-allocated"
#: a pod's device selection hints per device type (JSON)
ANNOTATION_DEVICE_ALLOCATE_HINTS = f"{DOMAIN}/device-allocate-hints"
#: a pod's joint device allocation spec (JSON)
ANNOTATION_DEVICE_JOINT_ALLOCATE = f"{DOMAIN}/device-joint-allocate"

# -- node-level colocation protocol (reference: apis/extension/node.go,
# node_colocation.go): reserved resources, cpu normalization and
# amplification ---------------------------------------------------------------

ANNOTATION_NODE_RESERVATION = f"{DOMAIN}/node-reservation"
ANNOTATION_CPU_NORMALIZATION_RATIO = f"{DOMAIN}/cpu-normalization-ratio"
ANNOTATION_RESOURCE_AMPLIFICATION_RATIO = (
    f"{DOMAIN}/node-resource-amplification-ratio"
)
ANNOTATION_NODE_RAW_ALLOCATABLE = f"{DOMAIN}/node-raw-allocatable"


def parse_node_reservation(
    annotations: Optional[Mapping[str, str]],
) -> Optional[dict]:
    """The node-reservation annotation, parsed once for every consumer.

    Accepts the nested form ``{"resources": {"cpu": N, "memory": N},
    "applyPolicy": "..."}`` and the flat form ``{"cpu": N, "memory":
    N}``. Returns ``{"cpu": mcpu, "memory": mib, "apply_policy": str}``
    (canonical units, zeros for absent dims, negatives clamped to 0) or
    None for an absent or malformed annotation. The scheduler's node
    transform (``client/wiring.transform_node``) trims allocatable only
    under the Default policy; the manager's overcommit inputs subtract
    the reservation whatever the policy.
    """
    raw = (annotations or {}).get(ANNOTATION_NODE_RESERVATION)
    if not raw:
        return None
    try:
        spec = json.loads(raw)
    except (ValueError, TypeError):
        return None
    if not isinstance(spec, dict):
        return None
    res = spec.get("resources", spec)
    if not isinstance(res, dict):
        return None
    try:
        cpu = int(res.get("cpu", 0))
        mem = int(res.get("memory", 0))
    except (ValueError, TypeError):
        return None
    return {
        "cpu": max(cpu, 0),
        "memory": max(mem, 0),
        "apply_policy": str(spec.get("applyPolicy", "Default") or "Default"),
    }
