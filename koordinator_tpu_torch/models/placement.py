"""PlacementModel: typed snapshot in, committed placements out (counterpart
of ``koordinator_tpu/models/placement.py``).

One solve: lower the snapshot to int32 arrays on the host, stage them on
the device, build the gang and quota state, dispatch the solve (the
hand-written kernel for eligible solves, the per-pod loop otherwise),
and read the result back once in :meth:`InFlightSchedule.finalize`.

Not in this slice of the port, each queued in ROADMAP.md: the staging
cache and delta lowering (a snapshot with a delta tracker is lowered in
full, which gives identical results), the host path for tiny solves,
pod-shape bucketing (it shares XLA compiles, which eager PyTorch does
not have; results are identical without it), reservations, the
fine-grained NUMA/device manager, preemption, the remote backend and
the observability hooks.
"""

from __future__ import annotations

import time
from typing import Dict, FrozenSet, Optional

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.apis.extension import NUM_RESOURCES
from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    GangMode,
    resources_to_vector,
    selector_matches,
)
from koordinator_tpu_torch.ops.binpack import (
    Extras,
    NodeState,
    PodBatch,
    ScoreParams,
    SolverConfig,
    solve_batch,
)
from koordinator_tpu_torch.ops.binpack_kernel import (
    kernel_routing_ok,
    kernel_solve_batch,
    kernel_supported,
    weight_sum,
)
from koordinator_tpu_torch.ops.gang import GangState
from koordinator_tpu_torch.ops.quota import QuotaState
from koordinator_tpu_torch.quota.core import GroupQuotaManager
from koordinator_tpu_torch.state.cluster import (
    DEFAULT_ESTIMATED_SCALING_FACTORS,
    DEFAULT_RESOURCE_WEIGHTS,
    DEFAULT_USAGE_THRESHOLDS,
    NodeArrays,
    PendingPodArrays,
    lower_nodes,
    lower_pending_pods,
)


def _vec(mapping) -> np.ndarray:
    out = np.zeros(NUM_RESOURCES, dtype=np.int32)
    for k, v in mapping.items():
        out[int(k)] = v
    return out


def pod_host_ports(pod) -> FrozenSet[str]:
    """Normalized "proto:port" set of a pod's host ports (counterpart of
    scheduler/plugins/nodeports.py ``pod_host_ports``)."""
    out = set()
    for entry in getattr(pod, "host_ports", None) or ():
        if isinstance(entry, int):
            out.add(f"tcp:{entry}")
        else:
            text = str(entry).lower()
            out.add(text if ":" in text else f"tcp:{text}")
    return frozenset(out)


class ScheduleResult(Dict[str, Optional[str]]):
    """The ``{pod uid: node name | None}`` mapping of committed (bindable)
    placements. ``waiting`` holds placed NonStrict gang members that keep
    their node at the Permit barrier and must not be bound yet."""

    def __init__(self, assignments, waiting=None):
        super().__init__(assignments)
        self.waiting: Dict[str, str] = dict(waiting or {})


class InFlightSchedule:
    """A dispatched solve that has not been read back. On CUDA the kernel
    runs asynchronously; :meth:`finalize` is the one read-back point."""

    def __init__(self, result, node_names, pod_uids, t_staged, timings):
        self.result = result
        self.node_names = node_names
        self.pod_uids = pod_uids
        self.t_staged = t_staged
        self.timings = timings
        self._final: Optional[ScheduleResult] = None

    def finalize(self) -> ScheduleResult:
        """Read the solve back (blocking until the device is done) and
        build the typed result. Idempotent."""
        if self._final is not None:
            return self._final
        result = self.result
        assignments = result.assign.cpu().numpy()
        commit = result.commit.cpu().numpy()
        waiting = result.waiting.cpu().numpy()
        self.timings["solve_s"] = time.perf_counter() - self.t_staged
        names = self.node_names
        self._final = ScheduleResult(
            assignments={
                uid: (names[a] if c else None)
                for uid, a, c in zip(self.pod_uids, assignments, commit)
            },
            waiting={
                uid: names[a]
                for uid, a, w in zip(self.pod_uids, assignments, waiting)
                if w
            },
        )
        return self._final


class PlacementModel:
    """Batched placement on one device (``cuda`` unless ``device`` says
    otherwise)."""

    def __init__(
        self,
        config: SolverConfig = SolverConfig(),
        resource_weights=None,
        usage_thresholds=None,
        prod_usage_thresholds=None,
        scaling_factors=None,
        device: DeviceLike = None,
        fine=None,
    ):
        if fine is not None:
            raise NotImplementedError(
                "the fine-grained NUMA/device manager is a later slice of "
                "the port (models/finegrained.py)"
            )
        self.device = resolve_device(device)
        self.config = config
        self.resource_weights = dict(resource_weights or DEFAULT_RESOURCE_WEIGHTS)
        self.scaling_factors = dict(
            scaling_factors or DEFAULT_ESTIMATED_SCALING_FACTORS
        )
        self.usage_thresholds = dict(usage_thresholds or DEFAULT_USAGE_THRESHOLDS)
        self.prod_usage_thresholds = dict(prod_usage_thresholds or {})

        def put(mapping):
            return torch.as_tensor(_vec(mapping), device=self.device)

        self.params = ScoreParams(
            weights=put(self.resource_weights),
            thresholds=put(self.usage_thresholds),
            prod_thresholds=put(self.prod_usage_thresholds),
        )
        #: static per-model kernel eligibility and score divisor (params
        #: and config are fixed)
        self._kernel_eligible = kernel_supported(self.params, self.config)
        self._wsum = weight_sum(self.params)
        #: which path the last solve took: "kernel" or "loop"
        self.last_solver: Optional[str] = None
        #: wall-time breakdown of the last schedule(): lower_s, stage_s,
        #: solve_s (solve_s is filled at read-back)
        self.last_timings: Optional[Dict[str, float]] = None

    # -- staging ------------------------------------------------------------

    def stage_nodes(self, arrays: NodeArrays) -> NodeState:
        """Copy host node arrays to the model's device."""
        def put(a):
            return torch.as_tensor(a, device=self.device)

        return NodeState(
            alloc=put(arrays.alloc),
            used_req=put(arrays.used_req),
            usage=put(arrays.usage),
            prod_usage=put(arrays.prod_usage),
            est_extra=put(arrays.est_extra),
            prod_base=put(arrays.prod_base),
            metric_fresh=put(arrays.metric_fresh),
            schedulable=put(arrays.schedulable),
        )

    def stage_pods(self, arrays: PendingPodArrays, blocked=None) -> PodBatch:
        """Copy host pending-pod arrays to the model's device."""
        def put(a):
            return torch.as_tensor(a, device=self.device)

        return PodBatch.build(
            req=put(arrays.req),
            est=put(arrays.est),
            is_prod=put(arrays.is_prod),
            is_daemonset=put(arrays.is_daemonset),
            quota_id=put(arrays.quota_id),
            non_preemptible=put(arrays.non_preemptible),
            gang_id=put(arrays.gang_id),
            blocked=None if blocked is None else put(blocked),
        )

    # -- solve --------------------------------------------------------------

    def schedule(self, snapshot: ClusterSnapshot) -> ScheduleResult:
        """Typed end to end: snapshot -> committed placements."""
        return self.schedule_async(snapshot).finalize()

    def schedule_async(self, snapshot: ClusterSnapshot) -> InFlightSchedule:
        """Lower, stage and dispatch one solve without reading it back.
        A snapshot with reservations raises NotImplementedError (from
        ``lower_nodes``: reservations are a later slice of the port)."""
        t_start = time.perf_counter()
        gang_names = sorted(snapshot.gangs)
        quota_names = sorted(snapshot.quotas)
        gang_index = {name: i for i, name in enumerate(gang_names)}
        quota_index = {name: i for i, name in enumerate(quota_names)}

        node_arrays = lower_nodes(
            snapshot,
            scaling_factors=self.scaling_factors,
            resource_weights=self.resource_weights,
        )
        pod_arrays = lower_pending_pods(
            snapshot.pending_pods,
            quota_index=quota_index or None,
            gang_index=gang_index or None,
            scaling_factors=self.scaling_factors,
            resource_weights=self.resource_weights,
        )
        uid_to_pod = {pod.uid: pod for pod in snapshot.pending_pods}
        pods_in_order = [uid_to_pod[uid] for uid in pod_arrays.uids]
        # a gang pod whose GangSpec has not been observed must not bind solo
        blocked = np.array(
            [pod.gang is not None and pod.gang not in gang_index
             for pod in pods_in_order],
            dtype=bool,
        )
        gang_arrays = (self._gang_arrays(snapshot, gang_names)
                       if gang_names else None)
        quota_arrays = (self._quota_arrays(snapshot, quota_names, quota_index,
                                           node_arrays)
                        if quota_names else None)
        extras_np = self._extras_rows(snapshot, pods_in_order)
        t_host_done = time.perf_counter()

        state = self.stage_nodes(node_arrays)
        batch = self.stage_pods(pod_arrays, blocked if blocked.any() else None)
        gang_state = (GangState.build(**gang_arrays, device=self.device)
                      if gang_arrays is not None else None)
        quota_state = (QuotaState.build(**quota_arrays, device=self.device)
                       if quota_arrays is not None else None)
        extras = None
        if extras_np is not None:
            extras = Extras(
                mask=torch.as_tensor(extras_np[0], device=self.device),
                score=torch.as_tensor(extras_np[1], device=self.device),
            )
        t_staged = time.perf_counter()
        self.last_timings = {
            "lower_s": t_host_done - t_start,
            "stage_s": t_staged - t_host_done,
            "solve_s": 0.0,
        }
        result = self._dispatch_solve(state, batch, quota_state, gang_state,
                                      extras)
        return InFlightSchedule(result, node_arrays.names, pod_arrays.uids,
                                t_staged, self.last_timings)

    def _dispatch_solve(self, state, batch, quota_state, gang_state, extras):
        """Eligible solves go to the kernel (on CUDA tensors it launches;
        a build or launch failure raises). Configurations the kernel does
        not cover, and solves with host extras, run the per-pod loop on
        the same device."""
        if self._kernel_eligible and kernel_routing_ok(state, batch, extras):
            self.last_solver = "kernel"
            return kernel_solve_batch(state, batch, self.params, quota_state,
                                      gang_state, self._wsum)
        self.last_solver = "loop"
        return solve_batch(state, batch, self.params, self.config,
                           quota_state, gang_state, extras)

    def _gang_arrays(self, snapshot, gang_names) -> dict:
        """``GangState.build`` arguments: min member, members already
        bound, Strict or not, and the gang-group label."""
        bound = {name: 0 for name in gang_names}
        for pod in snapshot.pods:
            if pod.gang in bound and pod.node_name is not None:
                bound[pod.gang] += 1
        specs = [snapshot.gangs[g] for g in gang_names]
        return dict(
            min_member=[s.min_member for s in specs],
            bound_count=[bound[g] for g in gang_names],
            strict=[s.mode == GangMode.STRICT for s in specs],
            group_id=[
                "/".join(sorted(s.gang_group)) if s.gang_group else g
                for g, s in zip(gang_names, specs)
            ],
        )

    def _quota_arrays(self, snapshot, quota_names, quota_index,
                      node_arrays) -> dict:
        """``QuotaState.build`` arguments for the (possibly hierarchical)
        quota tree. Requests are static within a solve, so the exact tree
        runtime is computed once on the host, one GroupQuotaManager per
        tree, and shipped as the precomputed runtime; the device then
        only tracks each group's used."""
        q = len(quota_names)
        shape = (q, NUM_RESOURCES)
        mn, mx, guar, weight = (np.zeros(shape, np.int64) for _ in range(4))
        allow = np.ones(q, bool)
        child_request = np.zeros(shape, np.int64)
        used = np.zeros(shape, np.int64)
        for name, i in quota_index.items():
            spec = snapshot.quotas[name]
            mn[i] = resources_to_vector(spec.min)
            mx[i] = resources_to_vector(spec.max)
            guar[i] = resources_to_vector(spec.guaranteed)
            weight[i] = (resources_to_vector(spec.shared_weight)
                         if spec.shared_weight is not None else mx[i])
            allow[i] = spec.allow_lent_resource
        for pod in list(snapshot.pending_pods) + list(snapshot.pods):
            if pod.quota in quota_index:
                i = quota_index[pod.quota]
                vec = resources_to_vector(pod.requests)
                child_request[i] += vec
                if pod.node_name is not None:
                    used[i] += vec

        node_total = node_arrays.alloc.astype(np.int64).sum(axis=0)
        by_tree: Dict[str, list] = {}
        for name in quota_names:
            by_tree.setdefault(snapshot.quotas[name].tree_id, []).append(name)
        runtime = np.zeros(shape, np.int64)
        for tree_names in by_tree.values():
            mgr = GroupQuotaManager()
            mgr.cluster_total = node_total.copy()
            for name in tree_names:
                spec = snapshot.quotas[name]
                # only tree roots carry a node-pool total
                if spec.total_resource is not None and (
                    spec.parent is None or spec.parent == "root"
                ):
                    mgr.cluster_total = resources_to_vector(spec.total_resource)
                mgr.update_quota(spec)
            for name in tree_names:
                i = quota_index[name]
                if child_request[i].any():
                    mgr.add_request(name, child_request[i])
            for name in tree_names:
                rt = mgr.refresh_runtime(name)
                runtime[quota_index[name]] = rt if rt is not None else 0
        return dict(min=mn, max=mx, guarantee=guar, weight=weight,
                    allow_lent=allow, child_request=child_request, used=used,
                    total=node_total, runtime=runtime)

    def _extras_rows(self, snapshot, pods_in_order) -> Optional[tuple]:
        """Host ``(mask[P,N], score[P,N])`` rows for pods with a required
        node selector or host ports, or None when no pod has either.
        A host-port pod conflicts with the ports of pods already assigned
        to a node; a later pending pod claiming a port an earlier one
        claimed is deferred (all-False row) to the next round."""
        selector_pods = [i for i, pod in enumerate(pods_in_order)
                         if pod.node_selector]
        port_pods = [i for i, pod in enumerate(pods_in_order)
                     if pod.host_ports]
        if not (selector_pods or port_pods):
            return None
        p, n = len(pods_in_order), len(snapshot.nodes)
        mask = np.ones((p, n), bool)
        score = np.zeros((p, n), np.int32)
        for i in selector_pods:
            selector = pods_in_order[i].node_selector
            mask[i] &= np.fromiter(
                (selector_matches(selector, node.labels)
                 for node in snapshot.nodes),
                dtype=bool, count=n,
            )
        if port_pods:
            used_by_node = [set() for _ in range(n)]
            node_idx = {nd.name: j for j, nd in enumerate(snapshot.nodes)}
            for ap in snapshot.pods:
                j = node_idx.get(ap.node_name)
                if j is not None:
                    used_by_node[j] |= pod_host_ports(ap)
            claimed: set = set()
            for i in port_pods:
                want = pod_host_ports(pods_in_order[i])
                if want & claimed:
                    mask[i] = False
                    continue
                row = np.fromiter(
                    (not (want & used_by_node[j]) for j in range(n)),
                    dtype=bool, count=n,
                )
                # only a pod with a feasible node claims its ports
                if (mask[i] & row).any():
                    claimed |= want
                mask[i] &= row
        return mask, score
