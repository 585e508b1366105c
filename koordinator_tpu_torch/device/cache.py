"""Per-node device inventory + free/used accounting.

Semantics oracle: pkg/scheduler/plugins/deviceshare/device_cache.go
(nodeDevice: deviceTotal/deviceFree/deviceUsed keyed device type → minor →
resources, vfAllocations) and apis/scheduling/v1alpha1/device_types.go
(DeviceInfo topology: socket/node/PCIe). Quantities are ints: percentage
shares (100 == one whole device) and MiB for device memory.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Set


class DeviceType(str, enum.Enum):
    GPU = "gpu"
    RDMA = "rdma"
    FPGA = "fpga"


class DeviceResourceName(str, enum.Enum):
    """Device resource dimensions (reference: apis/extension/
    device_share.go resource names)."""

    NVIDIA_GPU = "nvidia.com/gpu"        # whole devices
    KOORD_GPU = "koordinator/gpu"        # percent of one device
    GPU_CORE = "gpu-core"                # percent
    GPU_MEMORY = "gpu-memory"            # MiB
    GPU_MEMORY_RATIO = "gpu-memory-ratio"  # percent
    RDMA = "rdma"                        # percent
    FPGA = "fpga"                        # percent


#: sparse device resource amounts
DeviceResources = Dict[DeviceResourceName, int]


def add_resources(a: DeviceResources, b: DeviceResources) -> DeviceResources:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def sub_resources(a: DeviceResources, b: DeviceResources) -> DeviceResources:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) - v
    return out


def fits(request: DeviceResources, available: DeviceResources) -> bool:
    return all(available.get(k, 0) >= v for k, v in request.items())


def is_zero(res: DeviceResources) -> bool:
    return all(v == 0 for v in res.values())


@dataclasses.dataclass
class VirtualFunction:
    """An SR-IOV virtual function (reference: device_types.go
    VirtualFunction)."""

    bus_id: str
    minor: int = 0
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DeviceEntry:
    """One device instance on a node (reference: device_types.go
    DeviceInfo)."""

    minor: int
    device_type: DeviceType = DeviceType.GPU
    resources: DeviceResources = dataclasses.field(default_factory=dict)
    # topology (reference: DeviceTopology socket/node/pcie)
    socket_id: int = 0
    numa_node: int = 0
    pcie_id: str = "0"
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    vfs: List[VirtualFunction] = dataclasses.field(default_factory=list)
    health: bool = True


class NodeDevice:
    """All devices of one node with free/used accounting (reference:
    device_cache.go nodeDevice)."""

    def __init__(self, node_name: str, entries: Sequence[DeviceEntry] = ()):
        self.node_name = node_name
        self.device_infos: Dict[DeviceType, List[DeviceEntry]] = {}
        self.device_total: Dict[DeviceType, Dict[int, DeviceResources]] = {}
        self.device_used: Dict[DeviceType, Dict[int, DeviceResources]] = {}
        # pod uid -> device type -> [(minor, resources, vf bus ids)]
        self.allocations: Dict[str, Dict[DeviceType, List]] = {}
        # device type -> minor -> allocated VF bus ids
        self.vf_allocations: Dict[DeviceType, Dict[int, Set[str]]] = {}
        for e in entries:
            self.add_entry(e)

    def add_entry(self, entry: DeviceEntry) -> None:
        self.device_infos.setdefault(entry.device_type, []).append(entry)
        total = self.device_total.setdefault(entry.device_type, {})
        # unhealthy devices stay in the inventory with zero resources
        # (reference: device_cache.go updateCacheUsed healthy handling)
        total[entry.minor] = dict(entry.resources) if entry.health else {}
        self.device_used.setdefault(entry.device_type, {}).setdefault(
            entry.minor, {}
        )

    def free(self, device_type: DeviceType) -> Dict[int, DeviceResources]:
        out: Dict[int, DeviceResources] = {}
        for minor, total in self.device_total.get(device_type, {}).items():
            used = self.device_used.get(device_type, {}).get(minor, {})
            out[minor] = {k: v - used.get(k, 0) for k, v in total.items()}
        return out

    def entry(self, device_type: DeviceType, minor: int) -> Optional[DeviceEntry]:
        for e in self.device_infos.get(device_type, []):
            if e.minor == minor:
                return e
        return None

    # -- commit / rollback (reference: device_cache.go updateCacheUsed) ----
    def apply(self, pod_uid: str, allocations: Dict[DeviceType, List]) -> None:
        if pod_uid in self.allocations:
            return
        self.allocations[pod_uid] = allocations
        for device_type, allocs in allocations.items():
            used = self.device_used.setdefault(device_type, {})
            vf_alloc = self.vf_allocations.setdefault(device_type, {})
            for alloc in allocs:
                u = used.setdefault(alloc.minor, {})
                for k, v in alloc.resources.items():
                    u[k] = u.get(k, 0) + v
                for bus_id in alloc.vf_bus_ids:
                    vf_alloc.setdefault(alloc.minor, set()).add(bus_id)

    def release(self, pod_uid: str) -> None:
        allocations = self.allocations.pop(pod_uid, None)
        if not allocations:
            return
        for device_type, allocs in allocations.items():
            used = self.device_used.get(device_type, {})
            vf_alloc = self.vf_allocations.get(device_type, {})
            for alloc in allocs:
                u = used.get(alloc.minor, {})
                for k, v in alloc.resources.items():
                    u[k] = u.get(k, 0) - v
                for bus_id in alloc.vf_bus_ids:
                    vf_alloc.get(alloc.minor, set()).discard(bus_id)


class NodeDeviceCache:
    """node name → NodeDevice (reference: device_cache.go
    nodeDeviceCache)."""

    def __init__(self):
        self.nodes: Dict[str, NodeDevice] = {}

    def update_node(self, node_name: str, entries: Sequence[DeviceEntry]) -> None:
        self.nodes[node_name] = NodeDevice(node_name, entries)

    def get(self, node_name: str) -> Optional[NodeDevice]:
        return self.nodes.get(node_name)
