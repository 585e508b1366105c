"""Device request normalization + the Autopilot allocator.

Semantics oracle: pkg/scheduler/plugins/deviceshare/
{utils.go (resource combination validation/normalization),
devicehandler_gpu.go, devicehandler_default.go,
device_allocator.go (AutopilotAllocator :61, jointAllocate :286,
defaultAllocateDevices :392, allocateVF :464),
numa_topology.go (deviceTopologyGuide), scoring.go}.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from koordinator_tpu_torch.apis.types import selector_matches as _matches
from koordinator_tpu_torch.device.cache import (
    DeviceResourceName,
    DeviceResources,
    DeviceType,
    NodeDevice,
    VirtualFunction,
    fits,
    is_zero,
)

MAX_NODE_SCORE = 100


class DeviceUnschedulable(Exception):
    """Allocation impossible on this node (maps to Unschedulable status)."""


# ---------------------------------------------------------------------------
# request normalization (reference: utils.go DeviceResourceFlags /
# ValidDeviceResourceCombinations / ResourceCombinationsMapper)
# ---------------------------------------------------------------------------

_GPU_NAMES = (
    DeviceResourceName.NVIDIA_GPU,
    DeviceResourceName.KOORD_GPU,
    DeviceResourceName.GPU_CORE,
    DeviceResourceName.GPU_MEMORY,
    DeviceResourceName.GPU_MEMORY_RATIO,
)

_PERCENTAGE_NAMES = {
    DeviceResourceName.KOORD_GPU,
    DeviceResourceName.GPU_CORE,
    DeviceResourceName.GPU_MEMORY_RATIO,
    DeviceResourceName.RDMA,
    DeviceResourceName.FPGA,
}


def _validate_percentage(v: int) -> bool:
    """>100 must be a whole-device multiple (reference: utils.go
    ValidatePercentageResource)."""
    return not (v > 100 and v % 100 != 0)


def normalize_device_requests(
    requests: Dict[DeviceResourceName, int],
) -> Dict[DeviceType, DeviceResources]:
    """Validate the resource-name combination and normalize to per-type
    requests in canonical names (GPU → gpu-core/gpu-memory[-ratio]).

    Reference: utils.go ValidateDeviceRequest + ConvertDeviceRequest:
    nvidia.com/gpu N → core=ratio=N*100; koordinator/gpu P → core=ratio=P;
    gpu-core+gpu-memory[-ratio] kept as-is; bare gpu-memory[-ratio] kept.
    """
    for name, v in requests.items():
        if name in _PERCENTAGE_NAMES and not _validate_percentage(v):
            raise DeviceUnschedulable(f"invalid percentage request {name}={v}")

    gpu_names = frozenset(n for n in _GPU_NAMES if requests.get(n, 0) > 0)
    out: Dict[DeviceType, DeviceResources] = {}
    if gpu_names:
        valid = {
            frozenset({DeviceResourceName.NVIDIA_GPU}),
            frozenset({DeviceResourceName.KOORD_GPU}),
            frozenset({DeviceResourceName.GPU_MEMORY}),
            frozenset({DeviceResourceName.GPU_MEMORY_RATIO}),
            frozenset({DeviceResourceName.GPU_CORE, DeviceResourceName.GPU_MEMORY}),
            frozenset(
                {DeviceResourceName.GPU_CORE, DeviceResourceName.GPU_MEMORY_RATIO}
            ),
        }
        if gpu_names not in valid:
            raise DeviceUnschedulable(
                f"invalid GPU resource combination {sorted(n.value for n in gpu_names)}"
            )
        if DeviceResourceName.NVIDIA_GPU in gpu_names:
            n = requests[DeviceResourceName.NVIDIA_GPU]
            out[DeviceType.GPU] = {
                DeviceResourceName.GPU_CORE: n * 100,
                DeviceResourceName.GPU_MEMORY_RATIO: n * 100,
            }
        elif DeviceResourceName.KOORD_GPU in gpu_names:
            p = requests[DeviceResourceName.KOORD_GPU]
            out[DeviceType.GPU] = {
                DeviceResourceName.GPU_CORE: p,
                DeviceResourceName.GPU_MEMORY_RATIO: p,
            }
        else:
            out[DeviceType.GPU] = {
                n: requests[n] for n in gpu_names
            }
    if requests.get(DeviceResourceName.RDMA, 0) > 0:
        out[DeviceType.RDMA] = {
            DeviceResourceName.RDMA: requests[DeviceResourceName.RDMA]
        }
    if requests.get(DeviceResourceName.FPGA, 0) > 0:
        out[DeviceType.FPGA] = {
            DeviceResourceName.FPGA: requests[DeviceResourceName.FPGA]
        }
    return out


# ---------------------------------------------------------------------------
# hints / joint-allocate specs (reference: apis/extension/device_share.go
# DeviceAllocateHints / DeviceJointAllocate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceHint:
    selector: Optional[Dict[str, str]] = None      # device label equality
    vf_selector: Optional[Dict[str, str]] = None   # require a VF; match labels
    allocate_strategy: str = ""  # "ApplyForAll" | "RequestsAsCount" | ""
    exclusive_policy: str = ""   # "DeviceLevel" | "PCIeLevel" | ""

    @property
    def must_allocate_vf(self) -> bool:
        return self.vf_selector is not None


@dataclasses.dataclass
class JointAllocate:
    device_types: List[DeviceType] = dataclasses.field(default_factory=list)
    required_scope: str = ""  # "SamePCIe" or ""


@dataclasses.dataclass
class DeviceAllocation:
    minor: int
    resources: DeviceResources
    vf_bus_ids: List[str] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# handlers (reference: devicehandler_gpu.go / devicehandler_default.go)
# ---------------------------------------------------------------------------


def _calc_gpu(
    node_device: NodeDevice, requests: DeviceResources, hint: Optional[DeviceHint]
) -> Tuple[DeviceResources, int]:
    total = node_device.device_total.get(DeviceType.GPU, {})
    if not total:
        raise DeviceUnschedulable("Insufficient gpu devices")
    healthy = next((r for r in total.values() if r and not is_zero(r)), None)
    if healthy is None:
        raise DeviceUnschedulable("no healthy GPU Devices")
    requests = dict(requests)
    # fill the missing one of memory/ratio from per-device total memory
    # (reference: devicehandler_gpu.go fillGPUTotalMem)
    total_mem = healthy.get(DeviceResourceName.GPU_MEMORY, 0)
    if DeviceResourceName.GPU_MEMORY in requests:
        if total_mem:
            requests[DeviceResourceName.GPU_MEMORY_RATIO] = (
                requests[DeviceResourceName.GPU_MEMORY] * 100 // total_mem
            )
    else:
        requests[DeviceResourceName.GPU_MEMORY] = (
            requests.get(DeviceResourceName.GPU_MEMORY_RATIO, 0) * total_mem // 100
        )

    ratio = requests.get(DeviceResourceName.GPU_MEMORY_RATIO, 0)
    if ratio > 100 and ratio % 100 == 0:
        count = ratio // 100
        requests = {
            DeviceResourceName.GPU_CORE: requests.get(DeviceResourceName.GPU_CORE, 0)
            // count,
            DeviceResourceName.GPU_MEMORY: requests[DeviceResourceName.GPU_MEMORY]
            // count,
            DeviceResourceName.GPU_MEMORY_RATIO: ratio // count,
        }
        return requests, count
    return requests, 1


def _calc_default(
    device_type: DeviceType,
    resource_name: DeviceResourceName,
    node_device: NodeDevice,
    requests: DeviceResources,
    hint: Optional[DeviceHint],
) -> Tuple[DeviceResources, int]:
    total = node_device.device_total.get(device_type, {})
    if not total:
        raise DeviceUnschedulable(f"Insufficient {device_type.value} devices")
    quantity = requests.get(resource_name, 0)
    if quantity > 100 and quantity % 100 == 0:
        count = quantity // 100
        return {resource_name: quantity // count}, count
    if hint is not None:
        if hint.allocate_strategy == "ApplyForAll":
            count = sum(
                1
                for e in node_device.device_infos.get(device_type, [])
                if _matches(hint.selector, e.labels)
                and not is_zero(node_device.device_total[device_type].get(e.minor, {}))
            )
            if count == 0:
                raise DeviceUnschedulable(
                    f"Insufficient {device_type.value} devices"
                )
            return dict(requests), count
        if hint.allocate_strategy == "RequestsAsCount":
            per_device = 100 if hint.exclusive_policy == "DeviceLevel" else 1
            return {resource_name: per_device}, quantity
    return dict(requests), 1


def calc_requests_and_count(
    node_device: NodeDevice,
    pod_requests: Dict[DeviceType, DeviceResources],
    hints: Dict[DeviceType, DeviceHint],
) -> Tuple[Dict[DeviceType, DeviceResources], Dict[DeviceType, int]]:
    """Per-instance request + desired instance count per device type
    (reference: device_allocator.go:160 calcRequestsAndCountByDeviceType)."""
    requests_per_instance: Dict[DeviceType, DeviceResources] = {}
    desired_count: Dict[DeviceType, int] = {}
    for device_type, requests in pod_requests.items():
        if is_zero(requests):
            continue
        hint = hints.get(device_type)
        if device_type == DeviceType.GPU:
            req, count = _calc_gpu(node_device, requests, hint)
        elif device_type == DeviceType.RDMA:
            req, count = _calc_default(
                device_type, DeviceResourceName.RDMA, node_device, requests, hint
            )
        else:
            req, count = _calc_default(
                device_type, DeviceResourceName.FPGA, node_device, requests, hint
            )
        requests_per_instance[device_type] = req
        desired_count[device_type] = count
    return requests_per_instance, desired_count


# ---------------------------------------------------------------------------
# scoring (reference: scoring.go + device_resources.go scoreDevices)
# ---------------------------------------------------------------------------


def _score_device(
    requests: DeviceResources,
    total: DeviceResources,
    free: DeviceResources,
    scorer: str,
) -> int:
    score_sum, weight_sum = 0, 0
    for r in requests:
        cap = total.get(r, 0)
        used = cap - free.get(r, 0) + requests[r]
        if cap == 0 or used > cap:
            s = 0
        elif scorer == "MostAllocated":
            s = used * MAX_NODE_SCORE // cap
        else:
            s = (cap - used) * MAX_NODE_SCORE // cap
        score_sum += s
        weight_sum += 1
    return score_sum // weight_sum if weight_sum else 0


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------


class AutopilotAllocator:
    """Hint/topology-aware multi-device allocator (reference:
    device_allocator.go AutopilotAllocator)."""

    def __init__(
        self,
        node_device: NodeDevice,
        pod_requests: Dict[DeviceType, DeviceResources],
        hints: Optional[Dict[DeviceType, DeviceHint]] = None,
        joint_allocate: Optional[JointAllocate] = None,
        numa_affinity: Optional[int] = None,  # bitmask over NUMA nodes
        scorer: str = "LeastAllocated",
        required_minors: Optional[Dict[DeviceType, Set[int]]] = None,
        preferred_minors: Optional[Dict[DeviceType, Set[int]]] = None,
    ):
        self.node_device = node_device
        self.hints = hints or {}
        self.joint_allocate = joint_allocate
        self.numa_affinity = numa_affinity
        self.scorer = scorer
        self.required = required_minors or {}
        self.preferred = preferred_minors or {}
        self.requests_per_instance, self.desired_count = calc_requests_and_count(
            node_device, pod_requests, self.hints
        )
        for device_type in self.requests_per_instance:
            hint = self.hints.get(device_type)
            if hint is not None and hint.must_allocate_vf:
                if not any(
                    e.vfs for e in node_device.device_infos.get(device_type, [])
                ):
                    raise DeviceUnschedulable(
                        f"Insufficient {device_type.value} VirtualFunctions"
                    )

    # -- candidate minors after NUMA affinity + selector filtering
    # (reference: device_allocator.go:134 filterNodeDevice) ----------------
    def _candidate_minors(self, device_type: DeviceType) -> List[int]:
        hint = self.hints.get(device_type)
        minors = []
        for e in self.node_device.device_infos.get(device_type, []):
            if self.numa_affinity is not None and not (
                self.numa_affinity >> e.numa_node
            ) & 1:
                continue
            if hint is not None and not _matches(hint.selector, e.labels):
                continue
            minors.append(e.minor)
        return minors

    def allocate(self) -> Dict[DeviceType, List[DeviceAllocation]]:
        """Full allocation: joint allocate first, then remaining types
        (reference: device_allocator.go:94 Allocate)."""
        allocations: Dict[DeviceType, List[DeviceAllocation]] = {}
        if self.joint_allocate and self.joint_allocate.device_types:
            allocations = self._try_joint_allocate()
        for device_type in self.requests_per_instance:
            if device_type in allocations:
                continue
            allocs = self._allocate_device_type(
                device_type,
                self.desired_count.get(device_type, 1),
                preferred_pcies=None,
                minors=self._candidate_minors(device_type),
            )
            if allocs:
                allocations[device_type] = allocs
        if not any(allocations.values()):
            raise DeviceUnschedulable(
                "Insufficient "
                + ", ".join(t.value for t in self.requests_per_instance)
                + " devices"
            )
        return allocations

    def score(self) -> int:
        """Node-level device score (reference: device_allocator.go:507)."""
        final = 0
        for device_type, requests in self.requests_per_instance.items():
            total = self.node_device.device_total.get(device_type, {})
            free = self.node_device.free(device_type)
            if not total:
                continue
            agg_total: DeviceResources = {}
            agg_free: DeviceResources = {}
            for minor in total:
                for k, v in total[minor].items():
                    agg_total[k] = agg_total.get(k, 0) + v
                for k, v in free.get(minor, {}).items():
                    agg_free[k] = agg_free.get(k, 0) + v
            final += _score_device(requests, agg_total, agg_free, self.scorer)
        return final

    # -- joint allocation (reference: :188 tryJointAllocate,
    # :210 allocateByTopology) ---------------------------------------------
    def _try_joint_allocate(self) -> Dict[DeviceType, List[DeviceAllocation]]:
        joint = self.joint_allocate
        primary = joint.device_types[0]
        secondary = joint.device_types[1:]
        desired = self.desired_count.get(primary, 0)
        if desired == 0:
            return {}

        # 1) one PCIe switch with enough free primary devices
        for pcie, minors in self._free_by_pcie(primary):
            if len(minors) >= desired:
                try:
                    allocs = self._joint_allocate_group(
                        primary, secondary, {pcie}, minors=None
                    )
                except DeviceUnschedulable:
                    continue
                if allocs:
                    return allocs
        # 2) one NUMA node, preferring its PCIes
        for node, pcies, minors in self._free_by_numa_node(primary):
            if len(minors) >= desired:
                try:
                    allocs = self._joint_allocate_group(
                        primary, secondary, pcies, minors=None
                    )
                except DeviceUnschedulable:
                    continue
                if allocs:
                    return allocs
        # same-PCIe scope must be satisfied by the grouped attempts above
        if joint.required_scope == "SamePCIe":
            raise DeviceUnschedulable("node(s) Joint-Allocate rules not met")
        # 3) whole machine, preferring any NUMA-grouped PCIes
        all_pcies: Set[str] = set()
        for _, pcies, _ in self._free_by_numa_node(primary):
            all_pcies |= pcies
        allocs = self._joint_allocate_group(primary, secondary, all_pcies, minors=None)
        if allocs:
            return allocs
        raise DeviceUnschedulable("node(s) Joint-Allocate rules not met")

    def _joint_allocate_group(
        self,
        primary: DeviceType,
        secondary: Sequence[DeviceType],
        preferred_pcies: Set[str],
        minors: Optional[List[int]],
    ) -> Dict[DeviceType, List[DeviceAllocation]]:
        """(reference: :286 jointAllocate — primary first, secondaries ride
        the primary's PCIes)."""
        primary_allocs = self._allocate_device_type(
            primary,
            self.desired_count.get(primary, 1),
            preferred_pcies=preferred_pcies,
            minors=self._candidate_minors(primary),
        )
        if not primary_allocs:
            return {}
        result = {primary: primary_allocs}
        primary_pcies = {
            self.node_device.entry(primary, a.minor).pcie_id
            for a in primary_allocs
        }
        for device_type in secondary:
            # only types the pod actually requested ride along
            if device_type not in self.requests_per_instance:
                continue
            if (
                self.joint_allocate is not None
                and self.joint_allocate.required_scope == "SamePCIe"
            ):
                # one secondary device per primary PCIe, pinned to it so the
                # distribution cannot clump on one switch
                allocs = []
                for pcie in sorted(primary_pcies):
                    on_pcie = [
                        m
                        for m in self._candidate_minors(device_type)
                        if self.node_device.entry(device_type, m).pcie_id == pcie
                    ]
                    allocs.extend(
                        self._allocate_device_type(
                            device_type, 1, preferred_pcies={pcie},
                            minors=on_pcie, exclude=[a.minor for a in allocs],
                        )
                    )
            else:
                allocs = self._allocate_device_type(
                    device_type,
                    1,
                    preferred_pcies=primary_pcies,
                    minors=self._candidate_minors(device_type),
                )
            if allocs:
                result[device_type] = allocs
        if self.joint_allocate.required_scope == "SamePCIe":
            self._validate_same_pcie(result, primary, secondary)
        return result

    def _validate_same_pcie(self, result, primary, secondary) -> None:
        """(reference: :255 validateJointAllocation)."""
        def pcies(device_type):
            return {
                self.node_device.entry(device_type, a.minor).pcie_id
                for a in result.get(device_type, [])
            }

        primary_pcies = pcies(primary)
        for device_type in secondary:
            if pcies(device_type) != primary_pcies:
                raise DeviceUnschedulable(
                    "node(s) Device Joint-Allocate rules violation"
                )

    def _free_by_pcie(self, device_type: DeviceType) -> List[Tuple[str, List[int]]]:
        """PCIe id → minors with any free capacity, sorted for determinism
        (reference: numa_topology.go deviceTopologyGuide
        freeNodeDevicesInPCIe)."""
        free = self.node_device.free(device_type)
        candidates = set(self._candidate_minors(device_type))
        groups: Dict[Tuple[int, str], List[int]] = {}
        for e in self.node_device.device_infos.get(device_type, []):
            if e.minor in candidates and not is_zero(free.get(e.minor, {})) and fits(
                self.requests_per_instance.get(device_type, {}), free.get(e.minor, {})
            ):
                groups.setdefault((e.numa_node, e.pcie_id), []).append(e.minor)
        return [
            (pcie, sorted(minors))
            for (_, pcie), minors in sorted(groups.items())
        ]

    def _free_by_numa_node(
        self, device_type: DeviceType
    ) -> List[Tuple[int, Set[str], List[int]]]:
        """NUMA node → (pcies, free minors) (reference: numa_topology.go
        freeNodeDevicesInNode)."""
        free = self.node_device.free(device_type)
        candidates = set(self._candidate_minors(device_type))
        groups: Dict[int, Tuple[Set[str], List[int]]] = {}
        for e in self.node_device.device_infos.get(device_type, []):
            if e.minor in candidates and not is_zero(free.get(e.minor, {})) and fits(
                self.requests_per_instance.get(device_type, {}), free.get(e.minor, {})
            ):
                pcies, minors = groups.setdefault(e.numa_node, (set(), []))
                pcies.add(e.pcie_id)
                minors.append(e.minor)
        return [
            (node, pcies, sorted(minors))
            for node, (pcies, minors) in sorted(groups.items())
        ]

    # -- per-type allocation (reference: :392 defaultAllocateDevices) ------
    def _allocate_device_type(
        self,
        device_type: DeviceType,
        desired_count: int,
        preferred_pcies: Optional[Set[str]],
        minors: List[int],
        exclude: Sequence[int] = (),
    ) -> List[DeviceAllocation]:
        requests = self.requests_per_instance.get(device_type, {})
        # preferred PCIes only steer the ordering; the pod gets exactly the
        # count it asked for (the reference inflates maxDesiredCount by
        # len(preferredPCIEs), device_allocator.go:361-370, which can grant
        # devices beyond the request — treated as unintended here)
        desired_count = max(desired_count, 1)
        max_desired = desired_count
        minors = [m for m in minors if m not in set(exclude)]
        free = self.node_device.free(device_type)
        total = self.node_device.device_total.get(device_type, {})
        hint = self.hints.get(device_type)
        required = self.required.get(device_type, set())
        preferred_minors = self.preferred.get(device_type, set())

        # score each candidate minor, best first; stable-prefer preferred
        # PCIes then preferred (reservation) minors (reference: :415-417)
        def sort_key(minor):
            e = self.node_device.entry(device_type, minor)
            in_pcie = (
                0 if preferred_pcies and e and e.pcie_id in preferred_pcies else 1
            )
            in_preferred = 0 if minor in preferred_minors else 1
            score = _score_device(
                requests, total.get(minor, {}), free.get(minor, {}), self.scorer
            )
            return (in_pcie, in_preferred, -score, minor)

        allocations: List[DeviceAllocation] = []
        for minor in sorted(minors, key=sort_key):
            if required and minor not in required:
                continue
            f = free.get(minor, {})
            if is_zero(f) or not fits(requests, f):
                continue
            alloc = DeviceAllocation(minor=minor, resources=dict(requests))
            if hint is not None and hint.must_allocate_vf:
                vf = self._allocate_vf(device_type, minor, hint.vf_selector)
                if vf is None:
                    continue
                alloc.vf_bus_ids = [vf.bus_id]
            allocations.append(alloc)
            if len(allocations) == max_desired:
                break
        if len(allocations) < desired_count:
            raise DeviceUnschedulable(
                f"Insufficient {device_type.value} devices"
            )
        return allocations

    def _allocate_vf(
        self, device_type: DeviceType, minor: int, vf_selector
    ) -> Optional[VirtualFunction]:
        """First free VF by bus id (reference: :464 allocateVF)."""
        entry = self.node_device.entry(device_type, minor)
        if entry is None:
            return None
        allocated = self.node_device.vf_allocations.get(device_type, {}).get(
            minor, set()
        )
        remaining = [
            vf
            for vf in entry.vfs
            if _matches(vf_selector, vf.labels) and vf.bus_id not in allocated
        ]
        if not remaining:
            return None
        return min(remaining, key=lambda vf: vf.bus_id)
