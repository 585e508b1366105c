"""Topology-aligned CPU take(): the greedy cpuset bin-packer.

Semantics oracle: pkg/scheduler/plugins/nodenumaresource/cpu_accumulator.go
(takeCPUs :87, takePreferredCPUs :29, cpuAccumulator :234). The phase order
and every tie-breaking sort are preserved exactly; orderings are expressed
as ``np.lexsort`` keys over the topology arrays instead of Go sort.Slice
closures. This runs host-side per node: the candidate-node fan-out is the
batched device solver, the per-node take() is a ≤256-element greedy that
would not benefit from the MXU (SURVEY.md §7 hard part (b)).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.numa.topology import (
    AllocatedCPUs,
    CPUBindPolicy,
    CPUExclusivePolicy,
    CPUTopology,
    NUMAAllocateStrategy,
)


class CPUAllocationError(Exception):
    pass


class _Accumulator:
    """Mutable take() state (reference: cpuAccumulator cpu_accumulator.go:234)."""

    def __init__(
        self,
        topology: CPUTopology,
        max_ref_count: int,
        available: np.ndarray,            # bool [C]
        allocated: AllocatedCPUs,
        num_needed: int,
        exclusive_policy: CPUExclusivePolicy,
        strategy: NUMAAllocateStrategy,
    ):
        self.topo = topology
        self.max_ref_count = max_ref_count
        self.avail = available.copy()
        self.needed = int(num_needed)
        self.exclusive_policy = exclusive_policy
        self.exclusive = exclusive_policy in (
            CPUExclusivePolicy.PCPU_LEVEL,
            CPUExclusivePolicy.NUMA_NODE_LEVEL,
        )
        self.excl_cores = set(allocated.exclusive_in_cores)
        self.excl_nodes = set(allocated.exclusive_in_numa_nodes)
        self.strategy = strategy
        # ref counts only matter when cpus may be shared (maxRefCount > 1,
        # reference: newCPUAccumulator :269-274)
        self.ref = (
            allocated.ref_count.astype(np.int64)
            if max_ref_count > 1
            else np.zeros(topology.num_cpus, dtype=np.int64)
        )
        self.result: List[int] = []

    # -- predicates (reference :306-330) ------------------------------------
    def needs(self, n: int) -> bool:
        return self.needed >= n

    @property
    def satisfied(self) -> bool:
        return self.needed < 1

    @property
    def failed(self) -> bool:
        return self.needed > int(self.avail.sum())

    def _core_excluded(self, core: int) -> bool:
        return (
            self.exclusive_policy == CPUExclusivePolicy.PCPU_LEVEL
            and core in self.excl_cores
        )

    def _node_excluded(self, node: int) -> bool:
        return (
            self.exclusive_policy == CPUExclusivePolicy.NUMA_NODE_LEVEL
            and node in self.excl_nodes
        )

    # -- mutation (reference take() :290-304) -------------------------------
    def take(self, cpus) -> None:
        cpus = [int(c) for c in cpus]
        self.result.extend(cpus)
        for c in cpus:
            self.avail[c] = False
            if self.exclusive:
                if self.exclusive_policy == CPUExclusivePolicy.PCPU_LEVEL:
                    self.excl_cores.add(int(self.topo.core_id[c]))
                elif self.exclusive_policy == CPUExclusivePolicy.NUMA_NODE_LEVEL:
                    self.excl_nodes.add(int(self.topo.node_id[c]))
        self.needed -= len(cpus)

    # -- orderings ----------------------------------------------------------
    def _strategy_key(self, free_score: int) -> int:
        """Ascending sort key: most-allocated prefers the *least* free."""
        if self.strategy == NUMAAllocateStrategy.MOST_ALLOCATED:
            return free_score
        return -free_score

    def _sorted_core_cpus(self, cores: List[int],
                          cpus_in_cores: Dict[int, np.ndarray]) -> List[int]:
        """Core order within a node/socket: cpu count desc, core ref count
        asc (shared mode), core id asc (reference sortCores :345-368);
        cpus within a core ascend."""
        def key(core):
            ref = int(self.ref[cpus_in_cores[core]].sum()) if self.max_ref_count > 1 else 0
            return (-len(cpus_in_cores[core]), ref, core)

        out: List[int] = []
        for core in sorted(cores, key=key):
            out.extend(sorted(int(c) for c in cpus_in_cores[core]))
        return out

    def _group_cores(self, cpu_ids: np.ndarray) -> Dict[int, np.ndarray]:
        groups: Dict[int, list] = {}
        for c in cpu_ids:
            groups.setdefault(int(self.topo.core_id[c]), []).append(int(c))
        return {k: np.asarray(v) for k, v in groups.items()}

    def _sort_cpus_by_ref(self, cpus: List[int]) -> List[int]:
        if self.max_ref_count > 1:
            return sorted(cpus, key=lambda c: (int(self.ref[c]), c))
        return cpus

    def _extract_one_per_core(self, cpus: List[int]) -> List[int]:
        """First cpu of each core in current order (reference extractCPU :332)."""
        seen, out = set(), []
        for c in cpus:
            core = int(self.topo.core_id[c])
            if core not in seen:
                seen.add(core)
                out.append(c)
        return out

    def free_cores_in_node(self, full_only: bool, filter_exclusive: bool) -> List[List[int]]:
        """Free-core cpu lists grouped by NUMA node, node-sorted by the NUMA
        strategy (reference freeCoresInNode :371-461)."""
        cpu_ids = np.flatnonzero(self.avail)
        if filter_exclusive:
            cpu_ids = np.asarray(
                [c for c in cpu_ids if not self._node_excluded(int(self.topo.node_id[c]))],
                dtype=np.int64,
            )
        if cpu_ids.size == 0:
            return []
        socket_free: Dict[int, int] = {}
        for c in cpu_ids:
            socket_free[int(self.topo.socket_id[c])] = (
                socket_free.get(int(self.topo.socket_id[c]), 0) + 1
            )
        cpus_in_cores = self._group_cores(cpu_ids)
        if full_only:
            cpus_in_cores = {
                k: v for k, v in cpus_in_cores.items()
                if len(v) == self.topo.cpus_per_core
            }
        cores_in_nodes: Dict[int, List[int]] = {}
        for core, cpus in cpus_in_cores.items():
            cores_in_nodes.setdefault(int(self.topo.node_id[cpus[0]]), []).append(core)

        cpus_in_nodes = {
            node: self._sorted_core_cpus(cores, cpus_in_cores)
            for node, cores in cores_in_nodes.items()
        }

        def node_key(node):
            some_cpu = cpus_in_nodes[node][0]
            socket = int(self.topo.socket_id[some_cpu])
            return (
                self._strategy_key(len(cpus_in_nodes[node])),
                self._strategy_key(socket_free.get(socket, 0)),
                node,
            )

        return [cpus_in_nodes[n] for n in sorted(cpus_in_nodes, key=node_key)]

    def free_cores_in_socket(self, full_only: bool) -> List[List[int]]:
        """Free-core cpu lists grouped by socket (reference freeCoresInSocket
        :464-527; note: no exclusive filtering, matching the reference)."""
        cpu_ids = np.flatnonzero(self.avail)
        if cpu_ids.size == 0:
            return []
        cpus_in_cores = self._group_cores(cpu_ids)
        if full_only:
            cpus_in_cores = {
                k: v for k, v in cpus_in_cores.items()
                if len(v) == self.topo.cpus_per_core
            }
        cores_in_sockets: Dict[int, List[int]] = {}
        for core, cpus in cpus_in_cores.items():
            cores_in_sockets.setdefault(int(self.topo.socket_id[cpus[0]]), []).append(core)
        cpus_in_sockets = {
            s: self._sorted_core_cpus(cores, cpus_in_cores)
            for s, cores in cores_in_sockets.items()
        }

        def socket_key(s):
            return (self._strategy_key(len(cpus_in_sockets[s])), s)

        return [cpus_in_sockets[s] for s in sorted(cpus_in_sockets, key=socket_key)]

    def free_cpus_in_node(self, filter_exclusive: bool) -> List[List[int]]:
        """All free cpus grouped by NUMA node (reference freeCPUsInNode
        :530-605): used by the SpreadByPCPUs path."""
        cpu_ids = [
            int(c) for c in np.flatnonzero(self.avail)
            if not (
                filter_exclusive
                and (
                    self._core_excluded(int(self.topo.core_id[c]))
                    or self._node_excluded(int(self.topo.node_id[c]))
                )
            )
        ]
        if not cpu_ids:
            return []
        node_free: Dict[int, int] = {}
        socket_free: Dict[int, int] = {}
        cpus_in_nodes: Dict[int, List[int]] = {}
        for c in cpu_ids:
            node = int(self.topo.node_id[c])
            socket = int(self.topo.socket_id[c])
            node_free[node] = node_free.get(node, 0) + 1
            socket_free[socket] = socket_free.get(socket, 0) + 1
            cpus_in_nodes.setdefault(node, []).append(c)
        for node, cpus in cpus_in_nodes.items():
            cpus = self._sort_cpus_by_ref(sorted(cpus))
            if filter_exclusive:
                cpus = self._extract_one_per_core(cpus)
            cpus_in_nodes[node] = cpus

        def node_key(node):
            socket = int(self.topo.socket_id[cpus_in_nodes[node][0]])
            return (
                self._strategy_key(node_free[node]),
                self._strategy_key(socket_free[socket]),
                node,
            )

        return [cpus_in_nodes[n] for n in sorted(cpus_in_nodes, key=node_key)]

    def free_cpus_in_socket(self, filter_exclusive: bool) -> List[List[int]]:
        """All free cpus grouped by socket (reference freeCPUsInSocket
        :608-656; PCPU-level exclusion only)."""
        cpu_ids = [
            int(c) for c in np.flatnonzero(self.avail)
            if not (filter_exclusive and self._core_excluded(int(self.topo.core_id[c])))
        ]
        if not cpu_ids:
            return []
        cpus_in_sockets: Dict[int, List[int]] = {}
        for c in cpu_ids:
            cpus_in_sockets.setdefault(int(self.topo.socket_id[c]), []).append(c)
        for s, cpus in cpus_in_sockets.items():
            cpus = self._sort_cpus_by_ref(sorted(cpus))
            if filter_exclusive:
                cpus = self._extract_one_per_core(cpus)
            cpus_in_sockets[s] = cpus

        def socket_key(s):
            return (self._strategy_key(len(cpus_in_sockets[s])), s)

        return [cpus_in_sockets[s] for s in sorted(cpus_in_sockets, key=socket_key)]

    def free_cpus(self, filter_exclusive: bool) -> List[int]:
        """Global core-major cpu ordering for the last-resort fill
        (reference freeCPUs :666-774): socket affinity with already-taken
        cpus first, then strategy scores, then core fill, stable ids."""
        cpu_ids = [
            int(c) for c in np.flatnonzero(self.avail)
            if not (
                filter_exclusive
                and (
                    self._core_excluded(int(self.topo.core_id[c]))
                    or self._node_excluded(int(self.topo.node_id[c]))
                )
            )
        ]
        if not cpu_ids:
            return []
        cpus_in_cores: Dict[int, List[int]] = {}
        node_free: Dict[int, int] = {}
        socket_free: Dict[int, int] = {}
        for c in cpu_ids:
            core = int(self.topo.core_id[c])
            cpus_in_cores.setdefault(core, []).append(c)
            node_free[int(self.topo.node_id[c])] = (
                node_free.get(int(self.topo.node_id[c]), 0) + 1
            )
            socket_free[int(self.topo.socket_id[c])] = (
                socket_free.get(int(self.topo.socket_id[c]), 0) + 1
            )
        result_sockets = [int(self.topo.socket_id[c]) for c in self.result]
        socket_colo = {
            s: result_sockets.count(s) for s in socket_free
        }

        def core_key(core):
            some_cpu = cpus_in_cores[core][0]
            socket = int(self.topo.socket_id[some_cpu])
            node = int(self.topo.node_id[some_cpu])
            ref = int(self.ref[cpus_in_cores[core]].sum()) if self.max_ref_count > 1 else 0
            return (
                -socket_colo.get(socket, 0),
                self._strategy_key(socket_free[socket]),
                self._strategy_key(node_free[node]),
                len(cpus_in_cores[core]),
                socket,
                ref,
                core,
            )

        out: List[int] = []
        for core in sorted(cpus_in_cores, key=core_key):
            out.extend(self._sort_cpus_by_ref(sorted(cpus_in_cores[core])))
        return out

    def spread(self, cpus: List[int]) -> List[int]:
        """Round-robin one cpu per core per pass (reference spreadCPUs :798)."""
        if len(cpus) <= self.topo.cpus_per_core:
            return cpus
        out: List[int] = []
        pending = list(cpus)
        while pending:
            seen, leftover = set(), []
            for c in pending:
                core = int(self.topo.core_id[c])
                if core in seen:
                    leftover.append(c)
                else:
                    seen.add(core)
                    out.append(c)
            pending = leftover
        return out


def take_cpus(
    topology: CPUTopology,
    max_ref_count: int,
    available: np.ndarray,
    allocated: AllocatedCPUs,
    num_needed: int,
    bind_policy: CPUBindPolicy = CPUBindPolicy.DEFAULT,
    exclusive_policy: CPUExclusivePolicy = CPUExclusivePolicy.NONE,
    strategy: NUMAAllocateStrategy = NUMAAllocateStrategy.MOST_ALLOCATED,
) -> np.ndarray:
    """Take ``num_needed`` logical cpus honoring topology + policies.

    Phase order mirrors reference takeCPUs (cpu_accumulator.go:87-232):
    full-core fit in one NUMA node → one socket → whole sockets desc →
    per-core fill asc; spread path node → socket; final single-cpu fill.
    """
    acc = _Accumulator(
        topology, max_ref_count, available, allocated, num_needed,
        exclusive_policy, strategy,
    )
    if acc.satisfied:
        return np.asarray(sorted(acc.result), dtype=np.int64)
    if acc.failed:
        raise CPUAllocationError("not enough cpus available to satisfy request")

    full_pcpus = bind_policy == CPUBindPolicy.FULL_PCPUS
    if full_pcpus or topology.cpus_per_core == 1:
        # whole request fits in the free full cores of one NUMA node
        if acc.needed <= topology.cpus_per_node:
            for filter_exclusive in (True, False):
                for cpus in acc.free_cores_in_node(True, filter_exclusive):
                    if len(cpus) >= acc.needed:
                        acc.take(cpus[: acc.needed])
                        return np.asarray(sorted(acc.result), dtype=np.int64)
        # ... or of one socket
        if acc.needed <= topology.cpus_per_socket:
            for cpus in acc.free_cores_in_socket(True):
                if len(cpus) >= acc.needed:
                    acc.take(cpus[: acc.needed])
                    return np.asarray(sorted(acc.result), dtype=np.int64)
        # take whole sockets' free cores, most-free first (reference :141-155)
        free = sorted(acc.free_cores_in_socket(True), key=len, reverse=True)
        unsatisfied = []
        for cpus in free:
            if not acc.needs(len(cpus)):
                unsatisfied.append(cpus)
            else:
                acc.take(cpus)
                if acc.satisfied:
                    return np.asarray(sorted(acc.result), dtype=np.int64)
        # fill from the least-free leftover lists, a full core at a time
        if acc.needs(topology.cpus_per_core):
            per_core = topology.cpus_per_core
            for cpus in sorted(unsatisfied, key=len):
                for i in range(0, len(cpus), per_core):
                    acc.take(cpus[i : i + per_core])
                    if acc.satisfied:
                        return np.asarray(sorted(acc.result), dtype=np.int64)
                    if not acc.needs(per_core):
                        break

    if not full_pcpus:
        # spread: same NUMA node first (reference :184-214)
        if acc.needed <= topology.cpus_per_node:
            for filter_exclusive in (True, False):
                for cpus in acc.free_cpus_in_node(filter_exclusive):
                    if len(cpus) >= acc.needed:
                        cpus = acc.spread(cpus)
                        acc.take(cpus[: acc.needed])
                        return np.asarray(sorted(acc.result), dtype=np.int64)
        if acc.needed <= topology.cpus_per_socket:
            for filter_exclusive in (True, False):
                for cpus in acc.free_cpus_in_socket(filter_exclusive):
                    if len(cpus) >= acc.needed:
                        cpus = acc.spread(cpus)
                        acc.take(cpus[: acc.needed])
                        return np.asarray(sorted(acc.result), dtype=np.int64)

    # last resort: single cpus near what's already taken (reference :217-229)
    for filter_exclusive in (True, False):
        for c in acc.spread(acc.free_cpus(filter_exclusive)):
            if acc.needs(1):
                acc.take([c])
            if acc.satisfied:
                return np.asarray(sorted(acc.result), dtype=np.int64)

    raise CPUAllocationError("failed to allocate cpus")


def take_preferred_cpus(
    topology: CPUTopology,
    max_ref_count: int,
    available: np.ndarray,
    preferred: np.ndarray,
    allocated: AllocatedCPUs,
    num_needed: int,
    bind_policy: CPUBindPolicy = CPUBindPolicy.DEFAULT,
    exclusive_policy: CPUExclusivePolicy = CPUExclusivePolicy.NONE,
    strategy: NUMAAllocateStrategy = NUMAAllocateStrategy.MOST_ALLOCATED,
) -> np.ndarray:
    """Drain preferred (reservation-reusable) cpus first, then the rest
    (reference takePreferredCPUs cpu_accumulator.go:29-85)."""
    available = available.copy()
    preferred = available & preferred
    result = np.asarray([], dtype=np.int64)
    needed = int(num_needed)
    if preferred.any():
        take_n = min(needed, int(preferred.sum()))
        result = take_cpus(
            topology, max_ref_count, preferred, allocated, take_n,
            bind_policy, exclusive_policy, strategy,
        )
        needed -= len(result)
        available &= ~preferred
    if needed > 0:
        rest = take_cpus(
            topology, max_ref_count, available, allocated, needed,
            bind_policy, exclusive_policy, strategy,
        )
        result = np.union1d(result, rest)
    return np.asarray(sorted(int(c) for c in result), dtype=np.int64)
