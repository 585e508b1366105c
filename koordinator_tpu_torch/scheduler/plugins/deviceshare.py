"""DeviceShare plugin: GPU/RDMA/FPGA partial + multi-device allocation.

Rebuild of reference pkg/scheduler/plugins/deviceshare/plugin.go
(PreFilter :150, Filter :272, Reserve :377, PreBind :475) + scoring.go.
Device requests come from ``PodSpec.device_requests`` (the reference's
extended resource names); allocation hints and joint-allocate specs from
pod annotations. Composes with NodeNUMAResource: if the topology manager
stored a NUMA affinity for the node, device candidates are filtered to
those NUMA nodes.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_DEVICE_ALLOCATED,
    ANNOTATION_DEVICE_ALLOCATE_HINTS,
    ANNOTATION_DEVICE_JOINT_ALLOCATE,
)
from koordinator_tpu_torch.device.allocator import (
    AutopilotAllocator,
    DeviceHint,
    DeviceUnschedulable,
    JointAllocate,
    normalize_device_requests,
)
from koordinator_tpu_torch.device.cache import (
    DeviceResourceName,
    DeviceType,
    NodeDeviceCache,
)
from koordinator_tpu_torch.scheduler.framework import CycleState, Plugin, Status

_STATE_KEY = "deviceshare.state"
_NUMA_AFFINITY_KEY = "nodenumaresource.affinity"  # set by NodeNUMAResource


class _PreFilterState:
    def __init__(self, pod):
        known = {r.value for r in DeviceResourceName}
        raw = {}
        for name, v in (pod.device_requests or {}).items():
            # unmanaged vendor extended resources fall through to the
            # default fit path (reference: utils.go only collects known
            # device resource names)
            if name in known:
                raw[DeviceResourceName(name)] = int(v)
        self.pod_requests = normalize_device_requests(raw)
        self.skip = not self.pod_requests
        annotations = pod.annotations or {}
        self.hints: Dict[DeviceType, DeviceHint] = {}
        if ANNOTATION_DEVICE_ALLOCATE_HINTS in annotations:
            for t, h in json.loads(
                annotations[ANNOTATION_DEVICE_ALLOCATE_HINTS]
            ).items():
                self.hints[DeviceType(t)] = DeviceHint(
                    selector=h.get("selector"),
                    vf_selector=h.get("vfSelector"),
                    allocate_strategy=h.get("allocateStrategy", ""),
                    exclusive_policy=h.get("exclusivePolicy", ""),
                )
        self.joint: Optional[JointAllocate] = None
        if ANNOTATION_DEVICE_JOINT_ALLOCATE in annotations:
            j = json.loads(annotations[ANNOTATION_DEVICE_JOINT_ALLOCATE])
            self.joint = JointAllocate(
                device_types=[DeviceType(t) for t in j.get("deviceTypes", [])],
                required_scope=j.get("requiredScope", ""),
            )


class DeviceSharePlugin(Plugin):
    name = "DeviceShare"

    def __init__(self, cache: Optional[NodeDeviceCache] = None,
                 scorer: str = "LeastAllocated"):
        self.cache = cache or NodeDeviceCache()
        self.scorer = scorer

    def _allocator(self, state, pf, node) -> Optional[AutopilotAllocator]:
        node_device = self.cache.get(node.name)
        if node_device is None:
            return None
        affinity = state.get(f"{_NUMA_AFFINITY_KEY}.{node.name}")
        numa_mask = affinity.affinity if affinity is not None else None
        return AutopilotAllocator(
            node_device,
            pf.pod_requests,
            hints=pf.hints,
            joint_allocate=pf.joint,
            numa_affinity=numa_mask,
            scorer=self.scorer,
        )

    def pre_filter(self, state: CycleState, snapshot, pod) -> Status:
        try:
            pf = _PreFilterState(pod)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            return Status.unschedulable_(f"invalid device request: {e}")
        except DeviceUnschedulable as e:
            return Status.unschedulable_(str(e))
        if not pf.skip:
            state[_STATE_KEY] = pf
        return Status.success()

    def filter(self, state: CycleState, snapshot, pod, node) -> Status:
        pf = state.get(_STATE_KEY)
        if pf is None:
            return Status.success()
        try:
            allocator = self._allocator(state, pf, node)
            if allocator is None:
                return Status.unschedulable_("node(s) no devices")
            allocator.allocate()
        except DeviceUnschedulable as e:
            return Status.unschedulable_(str(e))
        return Status.success()

    def score(self, state: CycleState, snapshot, pod, node) -> int:
        pf = state.get(_STATE_KEY)
        if pf is None:
            return 0
        try:
            allocator = self._allocator(state, pf, node)
        except DeviceUnschedulable:
            return 0
        if allocator is None:
            return 0
        return min(allocator.score(), 100)

    def reserve(self, state: CycleState, snapshot, pod, node) -> Status:
        pf = state.get(_STATE_KEY)
        if pf is None:
            return Status.success()
        try:
            allocator = self._allocator(state, pf, node)
            if allocator is None:
                return Status.unschedulable_("node(s) no devices")
            allocations = allocator.allocate()
        except DeviceUnschedulable as e:
            return Status.unschedulable_(str(e))
        self.cache.get(node.name).apply(pod.uid, allocations)
        state[f"{self.name}.allocation"] = (node.name, allocations)
        return Status.success()

    def unreserve(self, state: CycleState, snapshot, pod, node) -> None:
        held = state.pop(f"{self.name}.allocation", None)
        if held is not None:
            node_device = self.cache.get(held[0])
            if node_device is not None:
                node_device.release(pod.uid)

    def pre_bind(self, state: CycleState, snapshot, pod, node) -> Status:
        held = state.get(f"{self.name}.allocation")
        if held is None:
            return Status.success()
        _, allocations = held
        pod.annotations[ANNOTATION_DEVICE_ALLOCATED] = json.dumps(
            {
                t.value: [
                    {
                        "minor": a.minor,
                        "resources": {k.value: v for k, v in a.resources.items()},
                        **(
                            {"vfs": a.vf_bus_ids} if a.vf_bus_ids else {}
                        ),
                    }
                    for a in allocs
                ]
                for t, allocs in allocations.items()
            }
        )
        return Status.success()
