"""Host-side fine-grained (NUMA cpuset + DeviceShare) integration for the
batched solver: the propose → validate → refine loop (the port's copy of
``koordinator_tpu/models/finegrained.py``).

The reference's fine-grained allocators are inherently sequential greedy
algorithms (cpu_accumulator.go takeCPUs topology sort, device_allocator.go
jointAllocate); SURVEY.md §7 prescribes keeping them host-side and feeding
the batched solver per-pod×node feasibility/score rows. This module:

- detects *special* pods (cpuset-requesting LSE/LSR, NUMA-policy-affected,
  device-requesting) whose placement needs the host allocators;
- computes their ``Extras`` rows (mask = hint-merge + trial-allocate
  feasibility, score = DeviceShare score; the NUMA score itself is
  computed in-scan from aggregated inventories — ops/binpack.py
  ``numa_node_score``);
- replays the solver's assignment order against the real managers
  (validate): at each special pod's turn the rows are recomputed against
  the now-partially-applied state — if they differ from what the solver
  used, the batch is re-solved with the refreshed rows. On convergence
  the scan's choices are exactly the choices the sequential incremental
  path would have made.

Termination: the score-consistent phase is capped; after that only
feasibility is enforced (each re-solve permanently masks at least one
(pod, node) pair, so the loop is finite).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.apis.extension import NUM_RESOURCES
from koordinator_tpu_torch.apis.types import ClusterSnapshot, NodeSpec, PodSpec
from koordinator_tpu_torch.numa.hints import NUMATopologyPolicy
from koordinator_tpu_torch.scheduler.framework import CycleState
from koordinator_tpu_torch.scheduler.plugins.deviceshare import (
    _PreFilterState as DevState,
)
from koordinator_tpu_torch.scheduler.plugins.nodenumaresource import (
    _PreFilterState as NumaState,
)


class FineGrained:
    """Bridges the batched solver and the host NUMA/device allocators.

    Wraps the *same* plugin instances the incremental chain uses, so both
    paths share one allocation state (reference: plugins hold the
    ResourceManager / nodeDeviceCache singletons).
    """

    def __init__(self, numa_plugin=None, device_plugin=None,
                 ports_plugin=None):
        self.numa_plugin = numa_plugin
        self.device_plugin = device_plugin
        self.ports_plugin = ports_plugin

    # -- topology lowering --------------------------------------------------

    def has_topology(self, node_names: List[str]) -> bool:
        if self.numa_plugin is None:
            return False
        mgr = self.numa_plugin.manager
        return any(
            mgr.get_topology(name).numa_node_resources for name in node_names
        )

    def numa_arrays(
        self, node_names: List[str]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(cap [N,R], free [N,R], node_policy [N]) aggregated per node from
        the ResourceManager (reference: topology_options.go inventories)."""
        n = len(node_names)
        cap = np.zeros((n, NUM_RESOURCES), np.int32)
        free = np.zeros((n, NUM_RESOURCES), np.int32)
        policy = np.zeros(n, bool)
        mgr = self.numa_plugin.manager
        for i, name in enumerate(node_names):
            opts = mgr.get_topology(name)
            if not opts.numa_node_resources:
                continue
            policy[i] = opts.policy != NUMATopologyPolicy.NONE
            for res in opts.numa_node_resources.values():
                for r, v in res.items():
                    cap[i, int(r)] += v
            total_available, _ = mgr.available_numa_resources(name)
            for res in total_available.values():
                for r, v in res.items():
                    free[i, int(r)] += v
        return cap, free, policy

    def any_node_policy(self, node_names: List[str]) -> bool:
        if self.numa_plugin is None:
            return False
        mgr = self.numa_plugin.manager
        return any(
            mgr.get_topology(name).policy != NUMATopologyPolicy.NONE
            for name in node_names
        )

    # -- special-pod detection ----------------------------------------------

    def pod_flags(
        self, pod: PodSpec, node_policy_present: bool
    ) -> Tuple[bool, bool]:
        """(is_special, has_pod_numa_policy) in one annotation parse.

        *special* = needs host rows: cpuset-requesting pods, pods with
        their own NUMA policy, pods with requests on clusters where some
        node declares a policy (hint-merge gating), and pods with managed
        device requests."""
        special = False
        if self.ports_plugin is not None and getattr(pod, "host_ports", None):
            # host-port pods need the validate loop: batch-internal
            # conflicts are only visible through the plugin's holds
            special = True
        if self.device_plugin is not None and pod.device_requests:
            try:
                special = special or not DevState(pod).skip
            except Exception:
                special = True  # malformed device spec: row computation rejects
        pod_policy = False
        if self.numa_plugin is not None and pod.requests:
            try:
                pf = NumaState(pod)
            except Exception:
                return True, False
            pod_policy = pf.pod_numa_policy != NUMATopologyPolicy.NONE
            special = (
                special
                or pf.request_cpu_bind
                or pod_policy
                or node_policy_present
            )
        return special, pod_policy

    # -- rows: per-pod×node mask + extra score ------------------------------

    def _plugins(self):
        return [
            p
            for p in (self.numa_plugin, self.device_plugin, self.ports_plugin)
            if p is not None
        ]

    def rows(
        self, snapshot: ClusterSnapshot, pod: PodSpec, nodes: List[NodeSpec]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(mask [N] bool, score [N] int32) against the managers' *current*
        state. Mask = NUMA filter (hint merge + trial allocate) ∧ device
        filter; score = device score only (NUMA score is in-scan)."""
        n = len(nodes)
        mask = np.ones(n, bool)
        score = np.zeros(n, np.int32)
        state = CycleState()
        for plugin in self._plugins():
            if not plugin.pre_filter(state, snapshot, pod).ok:
                return np.zeros(n, bool), score
        for i, node in enumerate(nodes):
            ok = True
            for plugin in self._plugins():
                if not plugin.filter(state, snapshot, pod, node).ok:
                    ok = False
                    break
            if not ok:
                mask[i] = False
                continue
            if self.device_plugin is not None:
                score[i] = self.device_plugin.score(state, snapshot, pod, node)
        return mask, score

    # -- validate / apply / rollback ----------------------------------------

    def apply(
        self, snapshot: ClusterSnapshot, pod: PodSpec, node: NodeSpec
    ) -> Tuple[bool, Optional[CycleState]]:
        """Reserve the pod's fine-grained allocation on the real managers
        (the incremental Reserve). Returns (ok, cycle_state); on failure
        everything is rolled back."""
        state = CycleState()
        plugins = self._plugins()
        for plugin in plugins:
            if not plugin.pre_filter(state, snapshot, pod).ok:
                return False, None
        for plugin in plugins:
            if not plugin.filter(state, snapshot, pod, node).ok:
                return False, None
        for i, plugin in enumerate(plugins):
            if not plugin.reserve(state, snapshot, pod, node).ok:
                for done in plugins[: i + 1]:
                    done.unreserve(state, snapshot, pod, node)
                return False, None
        return True, state

    def rollback(
        self, snapshot: ClusterSnapshot, pod: PodSpec, node: NodeSpec,
        state: "CycleState",
    ) -> None:
        for plugin in reversed(self._plugins()):
            plugin.unreserve(state, snapshot, pod, node)

    def pre_bind(
        self, snapshot: ClusterSnapshot, pod: PodSpec, node: NodeSpec,
        state: "CycleState",
    ) -> None:
        """Write the allocation annotations onto the pod (the incremental
        PreBind: resource-status cpuset + device allocation JSON)."""
        for plugin in self._plugins():
            plugin.pre_bind(state, snapshot, pod, node)
