"""NodeNUMAResource plugin: CPUSet/NUMA-aware fine-grained CPU allocation.

Rebuild of reference pkg/scheduler/plugins/nodenumaresource/plugin.go
(PreFilter :219, Filter :275, Score via scoring.go, Reserve :375,
PreBind :431) plus the scheduler-level topology manager admit
(pkg/scheduler/frameworkext/topologymanager/manager.go:56 Admit). Pods of
QoS LSE/LSR with integer CPU requests get pinned logical CPUs laid out by
the topology-aligned accumulator; NUMA topology policies gate placement
per node via hint merge.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

import numpy as np

from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_RESOURCE_SPEC,
    ANNOTATION_RESOURCE_STATUS,
    QoSClass,
    ResourceName,
)
from koordinator_tpu_torch.numa.accumulator import CPUAllocationError
from koordinator_tpu_torch.numa.hints import (
    NUMATopologyHint,
    NUMATopologyPolicy,
    merge_hints,
)
from koordinator_tpu_torch.numa.manager import (
    MAX_NODE_SCORE,
    ResourceManager,
    ResourceOptions,
)
from koordinator_tpu_torch.numa.topology import CPUBindPolicy, CPUExclusivePolicy
from koordinator_tpu_torch.scheduler.framework import CycleState, Plugin, Status

_STATE_KEY = "nodenumaresource.state"
_AFFINITY_KEY = "nodenumaresource.affinity"  # + node name


class _PreFilterState:
    def __init__(self, pod):
        annotations = pod.annotations or {}
        spec = {}
        if ANNOTATION_RESOURCE_SPEC in annotations:
            spec = json.loads(annotations[ANNOTATION_RESOURCE_SPEC])
        self.bind_policy = CPUBindPolicy(spec.get("cpuBindPolicy", "Default"))
        self.exclusive_policy = CPUExclusivePolicy(
            spec.get("cpuExclusivePolicy", "None")
        )
        self.required_bind_policy = bool(spec.get("requiredCPUBindPolicy", False))
        self.pod_numa_policy = NUMATopologyPolicy(
            spec.get("numaTopologyPolicy", "")
        )
        cpu_milli = pod.requests.get(ResourceName.CPU, 0)
        # LSE/LSR integer-cpu pods get a cpuset (reference: plugin.go
        # requestCPUBind — AllowUseCPUSet: qos LSE/LSR + integer request)
        self.request_cpu_bind = (
            pod.qos in (QoSClass.LSE, QoSClass.LSR) and cpu_milli > 0
        ) or self.required_bind_policy
        self.num_cpus_needed = cpu_milli // 1000
        self.requests = dict(pod.requests)
        self.invalid_integer = self.request_cpu_bind and cpu_milli % 1000 != 0


class NodeNUMAResourcePlugin(Plugin):
    """Fine-grained CPU + NUMA-aligned placement."""

    name = "NodeNUMAResource"

    def __init__(
        self,
        resource_manager: Optional[ResourceManager] = None,
        scorer: str = "LeastAllocated",
    ):
        self.manager = resource_manager or ResourceManager()
        self.scorer = scorer

    # -- PreFilter (reference: plugin.go:219) ------------------------------
    def pre_filter(self, state: CycleState, snapshot, pod) -> Status:
        try:
            pf = _PreFilterState(pod)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            return Status.unschedulable_(f"invalid resource spec annotation: {e}")
        if pf.invalid_integer:
            return Status.unschedulable_("the requested CPUs must be integer")
        state[_STATE_KEY] = pf
        return Status.success()

    def _effective_policy(self, pf, opts) -> NUMATopologyPolicy:
        if pf.pod_numa_policy != NUMATopologyPolicy.NONE:
            return pf.pod_numa_policy
        return opts.policy

    def _options(self, pf, opts, affinity=None) -> ResourceOptions:
        requests = dict(pf.requests)
        ratio = getattr(opts, "amplification_ratio", 1.0)
        if pf.request_cpu_bind and ratio and ratio > 1:
            # amplified nodes account raw cpus for cpuset pods (reference:
            # plugin.go:503-505 AmplifyResourceList)
            requests[ResourceName.CPU] = int(
                math.ceil(requests.get(ResourceName.CPU, 0) * ratio)
            )
        return ResourceOptions(
            requests=requests,
            original_requests=dict(pf.requests),
            num_cpus_needed=pf.num_cpus_needed,
            request_cpu_bind=pf.request_cpu_bind,
            required_cpu_bind_policy=pf.required_bind_policy,
            cpu_bind_policy=pf.bind_policy,
            cpu_exclusive_policy=pf.exclusive_policy,
            hint=affinity or NUMATopologyHint(None, False, 0),
            numa_scorer=self.scorer,
        )

    # -- Filter (reference: plugin.go:275 + topology_hint.go:30) -----------
    def filter(self, state: CycleState, snapshot, pod, node) -> Status:
        pf = state.get(_STATE_KEY)
        if pf is None:
            return Status.success()
        opts = self.manager.get_topology(node.name)
        if pf.request_cpu_bind:
            if opts.cpu_topology is None or not opts.cpu_topology.is_valid():
                return Status.unschedulable_("node(s) invalid CPU topology")
        policy = self._effective_policy(pf, opts)
        if policy == NUMATopologyPolicy.NONE:
            return Status.success()
        numa_nodes = opts.numa_nodes
        if not numa_nodes:
            return Status.unschedulable_("node(s) missing NUMA resources")
        # topology-manager Admit: gather hints, merge under the policy,
        # trial-allocate (reference: topologymanager/manager.go:56-78)
        options = self._options(pf, opts)
        try:
            hints = self.manager.get_topology_hints(node.name, options)
        except CPUAllocationError:
            return Status.unschedulable_("node(s) Insufficient NUMA Node resources")
        providers_hints = [{str(int(r)): hints[r] for r in hints}]
        best, admit = merge_hints(policy, numa_nodes, providers_hints)
        if not admit:
            return Status.unschedulable_("node(s) NUMA Topology affinity error")
        state[f"{_AFFINITY_KEY}.{node.name}"] = best
        if best.affinity is not None or pf.request_cpu_bind:
            try:
                self.manager.allocate(node.name, pod.uid, self._options(pf, opts, best))
            except CPUAllocationError as e:
                return Status.unschedulable_(str(e))
        return Status.success()

    # -- Score (reference: scoring.go — least/most allocated over the
    # node's NUMA resources including this pod's request) ------------------
    def score(self, state: CycleState, snapshot, pod, node) -> int:
        pf = state.get(_STATE_KEY)
        if pf is None or not pf.requests:
            return 0
        opts = self.manager.get_topology(node.name)
        if not opts.numa_node_resources:
            return 0
        total_available, _ = self.manager.available_numa_resources(node.name)
        score_sum, weight_sum = 0, 0
        for r, req in pf.requests.items():
            cap = sum(
                res.get(r, 0) for res in opts.numa_node_resources.values()
            )
            free = sum(res.get(r, 0) for res in total_available.values())
            requested = cap - free + req
            if cap == 0 or requested > cap:
                s = 0
            elif self.scorer == "MostAllocated":
                s = requested * MAX_NODE_SCORE // cap
            else:
                s = (cap - requested) * MAX_NODE_SCORE // cap
            score_sum += s
            weight_sum += 1
        return score_sum // weight_sum if weight_sum else 0

    # -- Reserve / Unreserve (reference: plugin.go:375) --------------------
    def reserve(self, state: CycleState, snapshot, pod, node) -> Status:
        pf = state.get(_STATE_KEY)
        if pf is None:
            return Status.success()
        opts = self.manager.get_topology(node.name)
        affinity = state.get(f"{_AFFINITY_KEY}.{node.name}")
        if not pf.request_cpu_bind and (affinity is None or affinity.affinity is None):
            return Status.success()
        try:
            allocation = self.manager.allocate(
                node.name, pod.uid, self._options(pf, opts, affinity)
            )
        except CPUAllocationError as e:
            return Status.unschedulable_(str(e))
        self.manager.update(node.name, allocation)
        state[f"{self.name}.allocation"] = (node.name, allocation)
        return Status.success()

    def unreserve(self, state: CycleState, snapshot, pod, node) -> None:
        held = state.pop(f"{self.name}.allocation", None)
        if held is not None:
            self.manager.release(held[0], held[1].pod_uid)

    # -- PreBind (reference: plugin.go:431 — annotate resource status) -----
    def pre_bind(self, state: CycleState, snapshot, pod, node) -> Status:
        held = state.get(f"{self.name}.allocation")
        if held is None:
            return Status.success()
        _, allocation = held
        status: Dict[str, object] = {}
        if len(allocation.cpuset):
            status["cpuset"] = [int(c) for c in allocation.cpuset]
        if allocation.numa_resources:
            status["numaNodeResources"] = [
                {"node": n, "resources": {int(k): v for k, v in res.items()}}
                for n, res in sorted(allocation.numa_resources.items())
            ]
        if status:
            pod.annotations[ANNOTATION_RESOURCE_STATUS] = json.dumps(status)
        return Status.success()
