"""CPU topology as dense arrays + allocation bookkeeping types.

Reference semantics: pkg/scheduler/plugins/nodenumaresource/cpu_topology.go
(CPUTopology / CPUDetails) and pkg/scheduler/apis/config (CPUBindPolicy,
CPUExclusivePolicy, NUMAAllocateStrategy). Instead of a map cpu→CPUInfo, the
topology is three parallel int arrays indexed by logical cpu id; allocation
state (ref counts, exclusive markers) are arrays of the same shape so the
accumulator's orderings are ``np.lexsort`` keys.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Optional

import numpy as np


class CPUBindPolicy(str, enum.Enum):
    """How a cpuset pod wants its logical CPUs laid out
    (reference: pkg/scheduler/apis/config/types.go CPUBindPolicy)."""

    DEFAULT = "Default"
    FULL_PCPUS = "FullPCPUs"         # monopolize whole physical cores
    SPREAD_BY_PCPUS = "SpreadByPCPUs"  # one logical CPU per physical core
    CONSTRAINED_BURST = "ConstrainedBurst"


class CPUExclusivePolicy(str, enum.Enum):
    """Exclusion domain a cpuset allocation claims
    (reference: CPUExclusivePolicy{None,PCPULevel,NUMANodeLevel})."""

    NONE = "None"
    PCPU_LEVEL = "PCPULevel"
    NUMA_NODE_LEVEL = "NUMANodeLevel"


class NUMAAllocateStrategy(str, enum.Enum):
    """Prefer packing onto busy NUMA nodes or spreading onto free ones
    (reference: NUMAAllocateStrategy MostAllocated/LeastAllocated)."""

    MOST_ALLOCATED = "MostAllocated"
    LEAST_ALLOCATED = "LeastAllocated"


@dataclasses.dataclass(frozen=True)
class CPUTopology:
    """Static CPU topology of one node.

    Arrays are indexed by logical cpu id 0..C-1 (reference:
    cpu_topology.go CPUDetails keyed by CPUID).
    """

    core_id: np.ndarray    # [C] physical core of each logical cpu
    node_id: np.ndarray    # [C] NUMA node of each logical cpu
    socket_id: np.ndarray  # [C] socket of each logical cpu

    @staticmethod
    def build(
        sockets: int = 1,
        nodes_per_socket: int = 1,
        cores_per_node: int = 4,
        threads_per_core: int = 2,
    ) -> "CPUTopology":
        """Synthesize a regular topology (tests + defaults).

        CPU ids are laid out hyperthread-major like common x86 lscpu output
        is *not*; we use the simple contiguous layout (cpu = sequential
        within core) — the accumulator never relies on id layout, only on
        the id→core/node/socket maps.
        """
        n = sockets * nodes_per_socket * cores_per_node * threads_per_core
        cpu = np.arange(n)
        core = cpu // threads_per_core
        node = core // cores_per_node
        socket = node // nodes_per_socket
        return CPUTopology(core_id=core, node_id=node, socket_id=socket)

    @property
    def num_cpus(self) -> int:
        return len(self.core_id)

    @property
    def num_cores(self) -> int:
        return len(np.unique(self.core_id))

    @property
    def num_nodes(self) -> int:
        return len(np.unique(self.node_id))

    @property
    def num_sockets(self) -> int:
        return len(np.unique(self.socket_id))

    @property
    def cpus_per_core(self) -> int:
        return self.num_cpus // max(1, self.num_cores)

    @property
    def cpus_per_node(self) -> int:
        return self.num_cpus // max(1, self.num_nodes)

    @property
    def cpus_per_socket(self) -> int:
        return self.num_cpus // max(1, self.num_sockets)

    @property
    def numa_nodes(self) -> np.ndarray:
        return np.unique(self.node_id)

    def is_valid(self) -> bool:
        return self.num_cpus > 0

    def cpus_in_numa_node(self, node: int) -> np.ndarray:
        return np.flatnonzero(self.node_id == node)


@dataclasses.dataclass
class AllocatedCPUs:
    """Per-cpu allocation state of one node, accumulator input
    (reference: CPUDetails RefCount/ExclusivePolicy fields populated from
    existing PodAllocations, resource_manager.go:431 GetAvailableCPUs).
    """

    ref_count: np.ndarray          # [C] int, how many pods share each cpu
    exclusive_in_cores: set        # core ids with a PCPULevel allocation
    exclusive_in_numa_nodes: set   # NUMA node ids with a NUMANodeLevel alloc

    @staticmethod
    def empty(topology: CPUTopology) -> "AllocatedCPUs":
        return AllocatedCPUs(
            ref_count=np.zeros(topology.num_cpus, dtype=np.int32),
            exclusive_in_cores=set(),
            exclusive_in_numa_nodes=set(),
        )


def cpuset_mask(topology: CPUTopology, cpus: Optional[Iterable[int]]) -> np.ndarray:
    """Bool mask [C] from an iterable of cpu ids (None → empty)."""
    mask = np.zeros(topology.num_cpus, dtype=bool)
    if cpus is not None:
        ids = np.asarray(list(cpus), dtype=np.int64)
        if ids.size:
            mask[ids] = True
    return mask
