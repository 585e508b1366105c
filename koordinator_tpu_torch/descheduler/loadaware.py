"""LowNodeLoad: balance actual utilization across the pool (counterpart
of ``koordinator_tpu/descheduler/loadaware.py``).

Semantics oracle: pkg/descheduler/framework/plugins/loadaware/
{low_node_load.go:134-326, utilization_util.go} (see SURVEY.md A.7):
classify nodes by *real* utilization (NodeMetric) against low/high
thresholds — underutilized iff below all lows, overutilized iff above
any high — debounce with the anomaly detector, then evict the heaviest
pods from overutilized nodes while the destination pool has headroom.
The classification runs as one vectorized pass over the
(nodes × resources) matrix (``ops.rebalance``), threshold resolution in
reference-exact float64; victim ordering uses the full PodSorter chain
(``descheduler.sorter``). The eviction walk runs on ``backend``: "host"
(the default, as in the reference: the per-pod Python walk), "device"
(the flattened walk on ``device``, ``cuda`` unless the caller passes one:
the hand-written sweep kernel there, its plain version on the CPU) or
"verify" (the device walk, checked against a numpy replica before
anything is applied).

Design note (getNodeUsage, utilization_util.go:132-191): the reference
recomposes node usage as systemUsage + Σ podUsage from the NodeMetric
CR. Our ``NodeMetric.node_usage`` is reported by the koordlet as exactly
that total, so the plugin reads it directly — same quantity, one hop
shorter. Pods without a metric entry behave as in the reference: they
can still be evicted, but decrement neither the node usage nor the
destination headroom (:339-352).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from koordinator_tpu_torch import DeviceLike, resolve_device

from koordinator_tpu_torch.apis.extension import NUM_RESOURCES, ResourceName
from koordinator_tpu_torch.apis.types import ClusterSnapshot, NodeSpec, PodSpec
from koordinator_tpu_torch.apis.types import resources_to_vector, selector_matches
from koordinator_tpu_torch.descheduler.anomaly import BasicDetector, State
from koordinator_tpu_torch.descheduler.framework import BalancePlugin, Evictor
from koordinator_tpu_torch.descheduler.sorter import (
    pod_sort_key_from_static,
    pod_sort_static,
    resource_usage_score,
)
from koordinator_tpu_torch.ops.rebalance import (
    DeviceSweep,
    SweepBatch,
    classify_nodes,
    replay_sweep_host,
    threshold_quantities,
)


@dataclasses.dataclass
class NodePool:
    """One node pool's thresholds (reference: LowNodeLoadNodePool)."""

    name: str = "default"
    # resource -> percent; missing resource = never triggers
    low_thresholds: Dict[ResourceName, int] = dataclasses.field(
        default_factory=lambda: {ResourceName.CPU: 45, ResourceName.MEMORY: 60}
    )
    high_thresholds: Dict[ResourceName, int] = dataclasses.field(
        default_factory=lambda: {ResourceName.CPU: 65, ResourceName.MEMORY: 80}
    )
    use_deviation_thresholds: bool = False
    node_selector: Optional[Dict[str, str]] = None
    resource_weights: Dict[ResourceName, int] = dataclasses.field(
        default_factory=lambda: {ResourceName.CPU: 1, ResourceName.MEMORY: 1}
    )
    # anomaly debounce (reference: LoadAnomalyCondition)
    consecutive_abnormalities: int = 1


@dataclasses.dataclass
class LowNodeLoadArgs:
    """Plugin args (reference: apis/config LowNodeLoadArgs)."""

    node_pools: Sequence[NodePool] = dataclasses.field(
        default_factory=lambda: [NodePool()]
    )
    paused: bool = False
    dry_run: bool = False
    node_fit: bool = True
    number_of_nodes: int = 0
    node_metric_expiration_seconds: Optional[float] = 180.0
    # pod filter: which pods are candidates for eviction at all
    pod_filter: Optional[Callable[[PodSpec], bool]] = None
    # eviction-sweep backend: "host" walks nodes/pods in Python
    # (reference-shaped, the bit-parity oracle); "device" runs the
    # ordered sweep over the flattened candidate list
    # (ops.rebalance.balance_sweep) on ``device``; "verify" runs the
    # device sweep and asserts its decision stream bit-equal to a
    # pure-host replica before applying anything
    backend: str = "host"
    # where "device" and "verify" run the sweep: cuda unless given
    device: DeviceLike = None


def _percent_vec(thresholds: Dict[ResourceName, int]) -> np.ndarray:
    vec = np.full(NUM_RESOURCES, -1, dtype=np.int64)
    for r, p in thresholds.items():
        vec[int(r)] = p
    return vec


class LowNodeLoad(BalancePlugin):
    name = "LowNodeLoad"

    def __init__(self, args: Optional[LowNodeLoadArgs] = None):
        self.args = args or LowNodeLoadArgs()
        self.detectors: Dict[str, BasicDetector] = {}
        #: dry-run mode: the would-be evictions of the last balance pass,
        #: in order (the reference logs them; this is the queryable form)
        self.last_proposals: List = []
        #: per-snapshot pod cache (see _process_pool); initialized here
        #: so direct _process_pool calls work too
        self._sweep_cache: Dict[str, tuple] = {}
        self._cache_snapshot = None

    # -- usage gathering (reference: utilization_util.go getNodeUsage) -----
    def _gather(self, pool: NodePool, snapshot: ClusterSnapshot,
                processed: set):
        nodes: List[NodeSpec] = []
        for node in snapshot.nodes:
            if node.name in processed:
                continue
            if not selector_matches(pool.node_selector, node.labels):
                continue
            nodes.append(node)
        usage = np.zeros((len(nodes), NUM_RESOURCES), dtype=np.int64)
        alloc = np.zeros((len(nodes), NUM_RESOURCES), dtype=np.int64)
        fresh = np.zeros(len(nodes), dtype=bool)
        schedulable = np.zeros(len(nodes), dtype=bool)
        expiry = self.args.node_metric_expiration_seconds
        for i, node in enumerate(nodes):
            alloc[i] = resources_to_vector(node.allocatable)
            schedulable[i] = not node.unschedulable
            metric = snapshot.node_metrics.get(node.name)
            if metric is None:
                continue
            if expiry is not None and snapshot.now - metric.update_time > expiry:
                continue
            fresh[i] = True
            usage[i] = resources_to_vector(metric.node_usage)
        return nodes, usage, alloc, fresh, schedulable

    # -- the Balance extension point (reference: low_node_load.go:134) -----
    def balance(self, snapshot: ClusterSnapshot, evictor: Evictor) -> None:
        if self.args.paused:
            return
        if self.args.backend not in ("host", "device", "verify"):
            raise ValueError(
                f"unknown rebalance backend {self.args.backend!r} "
                "(expected host | device | verify)"
            )
        self.last_proposals = []
        if self.args.backend != "host":
            # no CUDA device and none given raises before any work
            resolve_device(self.args.device)
        try:
            processed: set = set()
            for pool in self.args.node_pools:
                self._process_pool(pool, snapshot, evictor, processed)
        finally:
            # release the per-snapshot cache so a finished (or
            # never-again-invoked) plugin doesn't pin pod data
            self._sweep_cache = {}
            self._cache_snapshot = None

    def _pod_cached(self, pod) -> tuple:
        """(pod_sort_static prefix, request vector) for this sweep."""
        ent = self._sweep_cache.get(pod.uid)
        if ent is None:
            ent = (pod_sort_static(pod), resources_to_vector(pod.requests))
            self._sweep_cache[pod.uid] = ent
        return ent

    def _process_pool(self, pool: NodePool, snapshot: ClusterSnapshot,
                      evictor: Evictor, processed: set) -> None:
        # pod cache: uid -> (static sort prefix, request vector). Pod
        # specs are immutable for a given snapshot object, so the
        # static key parts and the request lowering are computed once
        # per pod instead of once per comparator/filter call; a NEW
        # snapshot (direct _process_pool callers included) resets it.
        if self._cache_snapshot is not snapshot:
            self._sweep_cache = {}
            self._cache_snapshot = snapshot
        nodes, usage, alloc, fresh, schedulable = self._gather(
            pool, snapshot, processed
        )
        if not nodes:
            return
        low_q, high_q, res_mask = threshold_quantities(
            usage, alloc,
            _percent_vec(pool.low_thresholds),
            _percent_vec(pool.high_thresholds),
            fresh,
            use_deviation=pool.use_deviation_thresholds,
        )
        verdict = classify_nodes(
            usage, low_q, high_q, res_mask, fresh, schedulable
        )
        low = verdict.low
        high = verdict.high

        source_idx = [i for i in np.flatnonzero(high)]
        for i in source_idx:
            processed.add(nodes[i].name)
        # a normal observation breaks mid-load nodes' abnormal streaks so
        # non-consecutive spikes don't accumulate (the reference expires
        # streaks via the detector cache timeout; an explicit normal mark
        # is the equivalent debounce)
        high_names = {nodes[i].name for i in source_idx}
        for i in range(len(nodes)):
            if fresh[i] and nodes[i].name not in high_names:
                det = self.detectors.get(nodes[i].name)
                if det is not None:
                    det.mark(True)
        if not source_idx:
            return

        # anomaly debounce (reference: :258 filterRealAbnormalNodes)
        abnormal_idx = []
        for i in source_idx:
            det = self.detectors.get(nodes[i].name)
            if det is None:
                det = self.detectors[nodes[i].name] = BasicDetector(
                    nodes[i].name,
                    consecutive_abnormalities=pool.consecutive_abnormalities,
                )
            if (
                pool.consecutive_abnormalities <= 1
                or det.mark(False) == State.ANOMALY
            ):
                abnormal_idx.append(i)
        if not abnormal_idx:
            return

        low_idx = list(np.flatnonzero(low))
        for i in low_idx:
            det = self.detectors.get(nodes[i].name)
            if det is not None:
                det.reset()
        if not low_idx:
            return
        if len(low_idx) <= self.args.number_of_nodes:
            return
        if len(low_idx) == len(nodes):
            return

        # destination headroom: Σ over low nodes of (high threshold −
        # usage), tracked on the participating resourceNames only
        # (evictPodsFromSourceNodes:247-267)
        available = np.zeros(NUM_RESOURCES, dtype=np.int64)
        for i in low_idx:
            available += high_q[i] - usage[i]

        weights = np.zeros(NUM_RESOURCES, dtype=np.int64)
        for r, w in pool.resource_weights.items():
            weights[int(r)] = w
        # the reference scorer iterates the node usage map, whose keys
        # are exactly resourceNames — weights outside that set never
        # contribute to score or weight-sum
        weights = np.where(res_mask, weights, 0)

        # heaviest source nodes first (reference: sortNodesByUsage desc,
        # sorter.ResourceUsageScorer — weighted mean of 1000-scale
        # mostRequestedScore over resourceNames)
        res_idx = [int(r) for r in np.flatnonzero(res_mask)]

        def node_score(i):
            u = {r: int(usage[i][r]) for r in res_idx}
            a = {r: int(alloc[i][r]) for r in res_idx}
            w = {r: int(weights[r]) for r in res_idx}
            return resource_usage_score(u, a, w)

        abnormal_idx.sort(key=node_score, reverse=True)
        # one pass over the pod list, not one per source node
        pods_by_node: Dict[str, List[PodSpec]] = {}
        for pod in snapshot.pods:
            if pod.node_name:
                pods_by_node.setdefault(pod.node_name, []).append(pod)
        low_arr = np.asarray(low_idx, dtype=np.int64)
        fits_any = _FitProbe(alloc[low_arr] - usage[low_arr])
        if self.args.backend in ("device", "verify"):
            self._sweep_device(
                pool, snapshot, evictor, nodes, abnormal_idx,
                pods_by_node, usage, high_q, available, res_mask,
                weights, fits_any,
                verify=(self.args.backend == "verify"),
            )
        else:
            for i in abnormal_idx:
                self._evict_from_node(
                    pool, snapshot, evictor, nodes[i],
                    pods_by_node.get(nodes[i].name, []), usage[i],
                    high_q[i], available, res_mask, weights, fits_any,
                )
        # one normal observation on every abnormal node at the end of
        # the pass (reference: tryMarkNodesAsNormal)
        for i in abnormal_idx:
            det = self.detectors.get(nodes[i].name)
            if det is not None:
                det.mark(True)

    def _pod_metric(self, snapshot, node, pod):
        """The pod's metric ResourceList from the SOURCE NODE's metric
        map, or None when absent (reference nodeInfo.podMetrics lookup
        :338-341 — keyed off the node being drained, so eviction
        clearing pod.node_name cannot orphan the lookup)."""
        metric = snapshot.node_metrics.get(node.name)
        if metric is not None and pod.uid in metric.pod_usages:
            return metric.pod_usages[pod.uid]
        return None

    def _removable_sorted(
        self, pool, snapshot, evictor, node, node_pods, node_usage,
        node_high_q, res_mask, weights, fits_any,
    ) -> List[PodSpec]:
        """The candidate head both backends share: filter evictable
        pods and order them under the full PodSorter chain. Keeping it
        one function is what makes host/device parity structural — the
        backends can only disagree about the sequential walk, which the
        parity suite pins."""
        removable = []
        for pod in node_pods:
            if pod.is_daemonset:
                continue
            if self.args.pod_filter is not None and not self.args.pod_filter(pod):
                continue
            if not evictor.filter(pod):
                continue
            if self.args.node_fit and not fits_any(self._pod_cached(pod)[1]):
                continue
            removable.append(pod)
        if not removable:
            return removable

        # evict biggest consumers of the *overused* resources first,
        # under the full PodSorter chain (priority class, priority, QoS,
        # costs, usage desc, creation) — sortPodsOnOneOverloadedNode:
        # weights restricted to resources the node is overusing
        over = (node_usage > node_high_q) & res_mask
        over_weights = {
            ResourceName(r): int(weights[r]) for r in np.flatnonzero(over)
        }
        removable.sort(key=lambda pod: pod_sort_key_from_static(
            self._pod_cached(pod)[0],
            self._pod_metric(snapshot, node, pod), node.allocatable,
            over_weights,
        ))
        return removable

    def _evict_from_node(
        self, pool, snapshot, evictor, node, node_pods, node_usage,
        node_high_q, available, res_mask, weights, fits_any,
    ) -> None:
        removable = self._removable_sorted(
            pool, snapshot, evictor, node, node_pods, node_usage,
            node_high_q, res_mask, weights, fits_any,
        )
        for pod in removable:
            # stop once the node is back under every high threshold or the
            # destination headroom is gone (reference: continueEvictionCond)
            if not ((node_usage > node_high_q) & res_mask).any():
                det = self.detectors.get(node.name)
                if det is not None:
                    det.reset()
                return
            if (available[res_mask] <= 0).any():
                return
            if self.args.dry_run:
                # reference evictPods dry-run branch: log instead of
                # evicting, but keep the sweep's accounting identical so
                # the proposals match what a live run would do
                self.last_proposals.append(pod)
            elif not evictor.evict(snapshot, pod, reason=(
                f"node {node.name} over-utilized"
            )):
                continue
            pod_metric = self._pod_metric(snapshot, node, pod)
            if pod_metric is None:
                # evicted, but with no metric there is nothing to
                # subtract (reference evictPods:339-341 continue)
                continue
            u = resources_to_vector(pod_metric)
            available -= np.where(res_mask, u, 0)
            node_usage -= np.where(res_mask, u, 0)

    # -- the device backend (docs/DESIGN.md §27) ---------------------------
    def _sweep_device(
        self, pool, snapshot, evictor, nodes, abnormal_idx, pods_by_node,
        usage, high_q, available, res_mask, weights, fits_any,
        verify=False,
    ) -> None:
        """Run the ordered eviction walk as one sweep over the flattened
        candidate list (ops.rebalance). Host preprocessing — node score
        order, per-node removable filter + PodSorter order — is the
        SAME code as the host backend; only the sequential
        check/evict/subtract walk moves to the device. Evictor refusals
        (including arbiter deferrals) feed back as a ``blocked`` mask
        and the sweep re-runs: a refusal can only change decisions at or
        after its own index, so the applied prefix stays valid and the
        walk resumes in place — worst case one re-scan per refusal. The
        batch is staged once; a re-scan (``DeviceSweep.refuse``) is one
        launch that blocks the candidate on the device and one read-back
        of the streams from it on."""
        cand_pods: List[PodSpec] = []
        cand_nodes: List[NodeSpec] = []
        rows = {"start": [], "u0": [], "hq": [], "m": [], "hm": []}
        segments = []  # (node, first candidate index, end index)
        for i in abnormal_idx:
            node = nodes[i]
            removable = self._removable_sorted(
                pool, snapshot, evictor, node,
                pods_by_node.get(node.name, []), usage[i], high_q[i],
                res_mask, weights, fits_any,
            )
            first = len(cand_pods)
            for j, pod in enumerate(removable):
                cand_pods.append(pod)
                cand_nodes.append(node)
                rows["start"].append(j == 0)
                rows["u0"].append(usage[i])
                rows["hq"].append(high_q[i])
                pod_metric = self._pod_metric(snapshot, node, pod)
                rows["hm"].append(pod_metric is not None)
                rows["m"].append(
                    np.zeros(NUM_RESOURCES, dtype=np.int64)
                    if pod_metric is None
                    else resources_to_vector(pod_metric)
                )
            segments.append((node, first, len(cand_pods)))
        k = len(cand_pods)
        if k == 0:
            return
        batch = SweepBatch(
            node_start=np.asarray(rows["start"], bool),
            usage0=np.stack(rows["u0"]).astype(np.int64),
            high_q=np.stack(rows["hq"]).astype(np.int64),
            metric=np.stack(rows["m"]).astype(np.int64),
            has_metric=np.asarray(rows["hm"], bool),
            valid=np.ones(k, bool),
        )
        blocked = np.zeros(k, bool)
        sweep = DeviceSweep(batch, available, res_mask, self.args.device)

        def checked(got):
            if verify:
                want = replay_sweep_host(batch, available, res_mask, blocked)
                for name, a, b in zip(("propose", "over", "avail_ok"),
                                      got, want):
                    if not np.array_equal(a, b):
                        raise RuntimeError(
                            "rebalance verify backend: device sweep "
                            f"{name} stream diverged from the host "
                            f"replica at candidates "
                            f"{np.flatnonzero(a != b).tolist()}"
                        )
            return got

        propose, over, avail_ok = checked(sweep.run(blocked))
        applied = np.zeros(k, bool)
        idx = 0
        while idx < k:
            if not propose[idx] or applied[idx]:
                idx += 1
                continue
            pod = cand_pods[idx]
            if self.args.dry_run:
                self.last_proposals.append(pod)
                applied[idx] = True
                idx += 1
            elif evictor.evict(snapshot, pod, reason=(
                f"node {cand_nodes[idx].name} over-utilized"
            )):
                applied[idx] = True
                idx += 1
            else:
                blocked[idx] = True
                propose, over, avail_ok = checked(sweep.refuse(idx))
        # detector resets, replayed from the decision streams: the host
        # walk resets a node's detector iff the first candidate that
        # stops the walk on that node stops it via the under-threshold
        # check (over == False, checked BEFORE headroom exhaustion)
        for node, first, end in segments:
            for j in range(first, end):
                if not over[j]:
                    det = self.detectors.get(node.name)
                    if det is not None:
                        det.reset()
                    break
                if not avail_ok[j]:
                    break
        # reproduce the host's in-place pool accounting (nothing after
        # the sweep reads it today, but the contract is bit-parity of
        # state, not just of decisions)
        for j in np.flatnonzero(applied & batch.has_metric):
            available -= np.where(res_mask, batch.metric[j], 0)


class _FitProbe:
    """nodeFit gate (reference: nodeutil.PodFitsAnyNode): some
    underutilized node has headroom for the pod's request.

    Exact, with two O(R) screens before the O(low_nodes × R) scan:
    a pod whose request exceeds the columnwise max headroom fits
    nowhere, and a pod that fits the single emptiest node needs no
    scan — at bench shape (~5k low nodes) that removes ~99% of the
    full scans without changing any answer."""

    def __init__(self, headroom: np.ndarray):
        self.headroom = headroom
        if headroom.size:
            self.col_max = headroom.max(axis=0)
            # anchor: row maximizing the columnwise-normalized minimum
            # headroom (any anchor is correct; this one catches most)
            norm = headroom / np.maximum(self.col_max, 1)[None, :]
            self.anchor = headroom[int(np.argmax(norm.min(axis=1)))]

    def __call__(self, req: np.ndarray) -> bool:
        if not self.headroom.size:
            return False
        if (req > self.col_max).any():
            return False
        if (req <= self.anchor).all():
            return True
        return bool((req[None, :] <= self.headroom).all(axis=1).any())
