"""Per-node NUMA resource manager: hints, allocation, release.

Semantics oracle: pkg/scheduler/plugins/nodenumaresource/
{resource_manager.go, node_allocation.go, topology_options.go,
least_allocated.go, most_allocated.go}. Holds per-node allocation state
(pod → cpuset + per-NUMA-node resources), generates NUMA topology hints
for the scheduler-level topology manager, and performs the final
hint-constrained allocation (even distribution + cpuset take).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.apis.types import Resources
from koordinator_tpu_torch.numa.accumulator import (
    CPUAllocationError,
    take_preferred_cpus,
)
from koordinator_tpu_torch.numa.hints import (
    NUMATopologyHint,
    NUMATopologyPolicy,
    mask_bits,
    mask_count,
    mask_of,
)
from koordinator_tpu_torch.numa.topology import (
    AllocatedCPUs,
    CPUBindPolicy,
    CPUExclusivePolicy,
    CPUTopology,
    NUMAAllocateStrategy,
    cpuset_mask,
)

MAX_NODE_SCORE = 100


@dataclasses.dataclass
class TopologyOptions:
    """Per-node topology as synced from the NodeResourceTopology CRD
    (reference: topology_options.go TopologyOptions)."""

    cpu_topology: Optional[CPUTopology] = None
    max_ref_count: int = 1
    policy: NUMATopologyPolicy = NUMATopologyPolicy.NONE
    # NUMA node id -> allocatable resources on that node
    numa_node_resources: Dict[int, Resources] = dataclasses.field(default_factory=dict)
    reserved_cpus: Sequence[int] = ()
    # node CPU amplification ratio (cpu-normalization, reference:
    # topology_options.go AmplificationRatios)
    amplification_ratio: float = 1.0

    @property
    def numa_nodes(self) -> List[int]:
        return sorted(self.numa_node_resources)


@dataclasses.dataclass
class ResourceOptions:
    """One pod's allocation request against one node (reference:
    plugin.go getResourceOptions / ResourceOptions)."""

    requests: Resources
    original_requests: Optional[Resources] = None
    num_cpus_needed: int = 0
    request_cpu_bind: bool = False
    required_cpu_bind_policy: bool = False
    cpu_bind_policy: CPUBindPolicy = CPUBindPolicy.DEFAULT
    cpu_exclusive_policy: CPUExclusivePolicy = CPUExclusivePolicy.NONE
    preferred_cpus: Sequence[int] = ()
    hint: NUMATopologyHint = NUMATopologyHint(None, False, 0)
    # reusable (reservation-restored) resources per NUMA node
    reusable_resources: Dict[int, Resources] = dataclasses.field(default_factory=dict)
    numa_scorer: Optional[str] = None  # "LeastAllocated" | "MostAllocated"

    def __post_init__(self):
        if self.original_requests is None:
            self.original_requests = dict(self.requests)


@dataclasses.dataclass
class PodAllocation:
    """What one pod holds on one node (reference: node_allocation.go
    PodAllocation)."""

    pod_uid: str
    cpuset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.asarray([], dtype=np.int64)
    )
    cpu_exclusive_policy: CPUExclusivePolicy = CPUExclusivePolicy.NONE
    # NUMA node id -> resources taken from that node
    numa_resources: Dict[int, Resources] = dataclasses.field(default_factory=dict)


class NodeAllocation:
    """All pod allocations on one node (reference: node_allocation.go
    NodeAllocation: allocatedPods/allocatedCPUs/allocatedResources)."""

    def __init__(self, node_name: str):
        self.node_name = node_name
        self.pods: Dict[str, PodAllocation] = {}

    def add(self, allocation: PodAllocation) -> None:
        if allocation.pod_uid in self.pods:
            return
        self.pods[allocation.pod_uid] = allocation

    def release(self, pod_uid: str) -> None:
        self.pods.pop(pod_uid, None)

    def allocated_cpus(self, topology: CPUTopology) -> AllocatedCPUs:
        state = AllocatedCPUs.empty(topology)
        for alloc in self.pods.values():
            for c in alloc.cpuset:
                state.ref_count[int(c)] += 1
                if alloc.cpu_exclusive_policy == CPUExclusivePolicy.PCPU_LEVEL:
                    state.exclusive_in_cores.add(int(topology.core_id[int(c)]))
                elif alloc.cpu_exclusive_policy == CPUExclusivePolicy.NUMA_NODE_LEVEL:
                    state.exclusive_in_numa_nodes.add(int(topology.node_id[int(c)]))
        return state

    def available_cpus(
        self,
        topology: CPUTopology,
        max_ref_count: int,
        reserved: Sequence[int] = (),
        preferred: Sequence[int] = (),
    ) -> Tuple[np.ndarray, AllocatedCPUs]:
        """Available mask + allocation detail; preferred (reservation)
        cpus get one refcount forgiven (reference: node_allocation.go:133
        getAvailableCPUs)."""
        state = self.allocated_cpus(topology)
        for c in preferred:
            if state.ref_count[int(c)] > 0:
                state.ref_count[int(c)] -= 1
        available = state.ref_count < max_ref_count
        available &= ~cpuset_mask(topology, reserved)
        return available, state

    def allocated_numa_resources(self) -> Dict[int, Resources]:
        out: Dict[int, Resources] = {}
        for alloc in self.pods.values():
            for node, res in alloc.numa_resources.items():
                acc = out.setdefault(node, {})
                for k, v in res.items():
                    acc[k] = acc.get(k, 0) + v
        return out


def _score_numa(
    scorer: Optional[str], requested: Resources, total: Resources, pod_requests: Resources
) -> int:
    """NUMA-set score used to weight hints (reference: least_allocated.go
    leastResourceScorer / most_allocated.go, weight 1 per requested
    resource)."""
    if scorer is None:
        return 0
    score_sum, weight_sum = 0, 0
    for r in pod_requests:
        cap = total.get(r, 0)
        req = requested.get(r, 0) + pod_requests[r]
        if scorer == "MostAllocated":
            s = 0 if cap == 0 or req > cap else req * MAX_NODE_SCORE // cap
        else:
            s = 0 if cap == 0 or req > cap else (cap - req) * MAX_NODE_SCORE // cap
        score_sum += s
        weight_sum += 1
    return score_sum // weight_sum if weight_sum else 0


def generate_resource_hints(
    numa_node_resources: Dict[int, Resources],
    pod_requests: Resources,
    total_available: Dict[int, Resources],
    scorer: Optional[str] = None,
) -> Dict[ResourceName, List[NUMATopologyHint]]:
    """Hints per resource over all NUMA-node subsets (reference:
    resource_manager.go:459 generateResourceHints): a mask yields a hint
    for a resource iff the mask's total capacity and free amount both cover
    the request and the mask avoids nodes with zero *available* amount of
    it (the reference builds the lack set from available, not capacity);
    preferred = the minimal feasible-by-capacity mask size. Memory-like
    resources are gated together, others independently."""
    numa_nodes = sorted(numa_node_resources)
    resource_names_by_numa = set()
    for res in numa_node_resources.values():
        resource_names_by_numa.update(res)

    lack_mask: Dict[ResourceName, int] = {}
    for r in resource_names_by_numa:
        for node, avail in total_available.items():
            if avail.get(r, 0) == 0:
                lack_mask[r] = lack_mask.get(r, 0) | (1 << node)

    min_affinity = {r: len(numa_nodes) for r in pod_requests}
    memory_names = [r for r in pod_requests if r == ResourceName.MEMORY]
    other_names = [r for r in pod_requests if r != ResourceName.MEMORY]
    hints: Dict[ResourceName, List[NUMATopologyHint]] = {}
    total_resource_names = set()

    def gen(mask: int, score: int, total: Resources, free: Resources,
            names: Sequence[ResourceName]) -> None:
        if not names:
            return
        for r in names:
            if total.get(r, 0) < pod_requests[r]:
                return
        for r in names:
            if mask & lack_mask.get(r, 0):
                return
        n = mask_count(mask)
        for r in names:
            if n < min_affinity[r]:
                min_affinity[r] = n
        for r in names:
            if free.get(r, 0) < pod_requests[r]:
                return
        for r in names:
            hints.setdefault(r, []).append(NUMATopologyHint(mask, False, score))

    for mask in range(1, 1 << len(numa_nodes)):
        bits = [numa_nodes[i] for i in range(len(numa_nodes)) if (mask >> i) & 1]
        real_mask = mask_of(bits)
        total: Resources = {}
        free: Resources = {}
        for node in bits:
            for k, v in total_available.get(node, {}).items():
                free[k] = free.get(k, 0) + v
            for k, v in numa_node_resources.get(node, {}).items():
                total[k] = total.get(k, 0) + v
        requested = {k: max(0, total.get(k, 0) - free.get(k, 0)) for k in total}
        score = _score_numa(scorer, requested, total, pod_requests)

        gen(real_mask, score, total, free, memory_names)
        for r in pod_requests:
            if r in total:
                total_resource_names.add(r)
        for r in other_names:
            gen(real_mask, score, total, free, [r])

    for r in pod_requests:
        for i, h in enumerate(hints.get(r, [])):
            hints[r][i] = dataclasses.replace(
                h, preferred=mask_count(h.affinity) == min_affinity[r]
            )
    for r in total_resource_names:
        hints.setdefault(r, [])
    return hints


class ResourceManager:
    """Cluster-wide NUMA allocation bookkeeping + the allocate entrypoints
    (reference: resource_manager.go resourceManager)."""

    def __init__(
        self,
        default_strategy: NUMAAllocateStrategy = NUMAAllocateStrategy.MOST_ALLOCATED,
    ):
        self.default_strategy = default_strategy
        self.topology_options: Dict[str, TopologyOptions] = {}
        self.node_allocations: Dict[str, NodeAllocation] = {}

    # -- topology options sync (reference: topology_options.go manager) ----
    def update_topology(self, node_name: str, options: TopologyOptions) -> None:
        self.topology_options[node_name] = options

    def get_topology(self, node_name: str) -> TopologyOptions:
        return self.topology_options.get(node_name, TopologyOptions())

    def _node_allocation(self, node_name: str) -> NodeAllocation:
        alloc = self.node_allocations.get(node_name)
        if alloc is None:
            alloc = self.node_allocations[node_name] = NodeAllocation(node_name)
        return alloc

    # -- read paths --------------------------------------------------------
    def available_numa_resources(
        self, node_name: str, reusable: Optional[Dict[int, Resources]] = None
    ) -> Tuple[Dict[int, Resources], Dict[int, Resources]]:
        """(total available, total allocated) per NUMA node (reference:
        node_allocation.go:155 getAvailableNUMANodeResources)."""
        opts = self.get_topology(node_name)
        allocated = self._node_allocation(node_name).allocated_numa_resources()
        available: Dict[int, Resources] = {}
        for node, res in opts.numa_node_resources.items():
            got = dict(res)
            for k, v in allocated.get(node, {}).items():
                got[k] = max(0, got.get(k, 0) - v)
            for k, v in (reusable or {}).get(node, {}).items():
                got[k] = got.get(k, 0) + v
            available[node] = got
        return available, allocated

    def available_cpus(
        self, node_name: str, preferred: Sequence[int] = ()
    ) -> Tuple[np.ndarray, AllocatedCPUs]:
        opts = self.get_topology(node_name)
        if opts.cpu_topology is None or not opts.cpu_topology.is_valid():
            raise CPUAllocationError(f"invalid cpu topology on {node_name}")
        return self._node_allocation(node_name).available_cpus(
            opts.cpu_topology, opts.max_ref_count, opts.reserved_cpus, preferred
        )

    # -- hints (reference: resource_manager.go:123 GetTopologyHints) -------
    def get_topology_hints(
        self, node_name: str, options: ResourceOptions
    ) -> Dict[ResourceName, List[NUMATopologyHint]]:
        opts = self.get_topology(node_name)
        if not opts.numa_node_resources:
            raise CPUAllocationError("insufficient resources on NUMA Node")
        total_available, _ = self.available_numa_resources(
            node_name, options.reusable_resources
        )
        self._trim_numa_cpus(node_name, total_available, options)
        return generate_resource_hints(
            opts.numa_node_resources, options.requests, total_available,
            options.numa_scorer,
        )

    def _trim_numa_cpus(
        self, node_name: str, total_available: Dict[int, Resources],
        options: ResourceOptions,
    ) -> None:
        """Cap per-NUMA available CPU by what the required bind policy can
        actually take (reference: resource_manager.go:141
        trimNUMANodeResources)."""
        if not options.required_cpu_bind_policy:
            return
        opts = self.get_topology(node_name)
        topo = opts.cpu_topology
        available, _ = self.available_cpus(node_name, options.preferred_cpus)
        for node, res in total_available.items():
            if res.get(ResourceName.CPU, 0) == 0:
                continue
            in_node = available & (topo.node_id == node)
            usable = _filter_by_required_policy(
                options.cpu_bind_policy, in_node, topo
            )
            limit = int(usable.sum()) * 1000
            if limit < res.get(ResourceName.CPU, 0):
                res[ResourceName.CPU] = limit

    # -- allocate (reference: resource_manager.go:169 Allocate) ------------
    def allocate(
        self, node_name: str, pod_uid: str, options: ResourceOptions
    ) -> PodAllocation:
        allocation = PodAllocation(
            pod_uid=pod_uid, cpu_exclusive_policy=options.cpu_exclusive_policy
        )
        if options.hint.affinity is not None:
            allocation.numa_resources = self._allocate_by_hint(node_name, options)
        if options.request_cpu_bind:
            allocation.cpuset = self._allocate_cpuset(
                node_name, allocation.numa_resources, options
            )
        return allocation

    def _allocate_by_hint(
        self, node_name: str, options: ResourceOptions
    ) -> Dict[int, Resources]:
        """Distribute the request over the hint's NUMA nodes as evenly as
        the free amounts allow (reference: resource_manager.go:221
        tryBestToDistributeEvenly; we sort candidate nodes by their actual
        free amount per resource — the reference's sort closure compares by
        slice index, which we treat as unintended)."""
        opts = self.get_topology(node_name)
        if not opts.numa_node_resources:
            raise CPUAllocationError("insufficient resources on NUMA Node")
        total_available, _ = self.available_numa_resources(
            node_name, options.reusable_resources
        )
        self._trim_numa_cpus(node_name, total_available, options)

        requests = dict(
            options.original_requests if options.request_cpu_bind else options.requests
        )
        numa_nodes = mask_bits(options.hint.affinity)
        resource_names_by_numa = set()
        for res in total_available.values():
            resource_names_by_numa.update(res)

        result: Dict[int, Resources] = {}
        for r, quantity in list(requests.items()):
            order = sorted(
                numa_nodes, key=lambda n: total_available.get(n, {}).get(r, 0)
            )
            for i, node in enumerate(order):
                split = _split_quantity(r, quantity, len(numa_nodes) - i, options, opts)
                allocated = min(total_available.get(node, {}).get(r, 0), split)
                if r == ResourceName.CPU and options.request_cpu_bind:
                    # cpuset pods take whole logical cpus: floor so the
                    # recorded NUMA amount always matches the cpuset taken
                    allocated = allocated // 1000 * 1000
                if allocated > 0:
                    result.setdefault(node, {})[r] = allocated
                    quantity -= allocated
            requests[r] = quantity

        for r, quantity in requests.items():
            if r in resource_names_by_numa and quantity > 0:
                raise CPUAllocationError(f"Insufficient NUMA {r.name}")
        return result

    def _allocate_cpuset(
        self,
        node_name: str,
        numa_resources: Dict[int, Resources],
        options: ResourceOptions,
    ) -> np.ndarray:
        """Take cpus, constrained to the allocated NUMA nodes when a hint
        was applied (reference: resource_manager.go:314 allocateCPUSet)."""
        opts = self.get_topology(node_name)
        topo = opts.cpu_topology
        available, allocated = self.available_cpus(node_name, options.preferred_cpus)
        if options.required_cpu_bind_policy:
            available = _filter_by_required_policy(
                options.cpu_bind_policy, available, topo
            )
        if int(available.sum()) < options.num_cpus_needed:
            raise CPUAllocationError("not enough cpus available to satisfy request")

        preferred_mask = cpuset_mask(topo, options.preferred_cpus)
        result = np.asarray([], dtype=np.int64)
        needed = options.num_cpus_needed
        if numa_resources:
            for node in sorted(numa_resources):
                in_node = available & (topo.node_id == node)
                num = min(
                    int(in_node.sum()),
                    numa_resources[node].get(ResourceName.CPU, 0) // 1000,
                )
                cpus = take_preferred_cpus(
                    topo, opts.max_ref_count, in_node, preferred_mask, allocated,
                    num, options.cpu_bind_policy, options.cpu_exclusive_policy,
                    self.default_strategy,
                )
                result = np.union1d(result, cpus)
            needed -= len(result)
            if needed != 0:
                raise CPUAllocationError("not enough cpus available to satisfy request")

        if needed > 0:
            available = available & ~cpuset_mask(topo, result)
            rest = take_preferred_cpus(
                topo, opts.max_ref_count, available, preferred_mask, allocated,
                needed, options.cpu_bind_policy, options.cpu_exclusive_policy,
                self.default_strategy,
            )
            result = np.union1d(result, rest)

        if options.required_cpu_bind_policy:
            _check_required_policy(options.cpu_bind_policy, result, topo)
        return result.astype(np.int64)

    # -- commit / rollback (reference: resource_manager.go:403,416) --------
    def update(self, node_name: str, allocation: PodAllocation) -> None:
        opts = self.get_topology(node_name)
        if opts.cpu_topology is None or not opts.cpu_topology.is_valid():
            return
        self._node_allocation(node_name).add(allocation)

    def release(self, node_name: str, pod_uid: str) -> None:
        self._node_allocation(node_name).release(pod_uid)

    def get_allocated_cpuset(self, node_name: str, pod_uid: str) -> Optional[np.ndarray]:
        alloc = self._node_allocation(node_name).pods.get(pod_uid)
        return None if alloc is None else alloc.cpuset


def _split_quantity(
    resource: ResourceName,
    quantity: int,
    numa_node_count: int,
    options: ResourceOptions,
    opts: TopologyOptions,
) -> int:
    """Even-split step (reference: resource_manager.go:277 splitQuantity):
    CPU for a required FullPCPUs bind rounds down to whole physical cores."""
    if resource != ResourceName.CPU:
        return quantity // numa_node_count
    if not options.request_cpu_bind:
        return quantity // numa_node_count
    if (
        options.required_cpu_bind_policy
        and options.cpu_bind_policy == CPUBindPolicy.FULL_PCPUS
        and opts.cpu_topology is not None
    ):
        per_core = opts.cpu_topology.cpus_per_core
        cores = (quantity // 1000) // per_core
        return (cores // numa_node_count) * per_core * 1000
    return (quantity // 1000) // numa_node_count * 1000


def _filter_by_required_policy(
    policy: CPUBindPolicy, available: np.ndarray, topo: CPUTopology
) -> np.ndarray:
    """FullPCPUs keeps only fully-free cores; SpreadByPCPUs one cpu per core
    (reference: resource_manager.go:595 filterCPUsByRequiredCPUBindPolicy)."""
    out = available.copy()
    if policy == CPUBindPolicy.FULL_PCPUS:
        for core in np.unique(topo.core_id[available]):
            members = topo.core_id == core
            if int((available & members).sum()) != int(members.sum()):
                out &= ~members
    elif policy == CPUBindPolicy.SPREAD_BY_PCPUS:
        keep = np.zeros_like(out)
        for core in np.unique(topo.core_id[available]):
            cpus = np.flatnonzero(available & (topo.core_id == core))
            keep[cpus[0]] = True
        out = keep
    return out


def _check_required_policy(
    policy: CPUBindPolicy, cpus: np.ndarray, topo: CPUTopology
) -> None:
    """Post-check (reference: resource_manager.go:629
    satisfiedRequiredCPUBindPolicy)."""
    cores = topo.core_id[cpus.astype(np.int64)] if len(cpus) else np.asarray([])
    if policy == CPUBindPolicy.FULL_PCPUS:
        if len(np.unique(cores)) * topo.cpus_per_core != len(cpus):
            raise CPUAllocationError(
                "insufficient CPUs to satisfy required cpu bind policy FullPCPUs"
            )
    elif policy == CPUBindPolicy.SPREAD_BY_PCPUS:
        if len(np.unique(cores)) != len(cpus):
            raise CPUAllocationError(
                "insufficient CPUs to satisfy required cpu bind policy SpreadByPCPUs"
            )
