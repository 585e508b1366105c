"""The noderesource controller: the colocation overcommit reconciler
(counterpart of ``koordinator_tpu/manager/noderesource.py``).

One ``reconcile_all`` lowers the whole cluster to arrays on the host,
stages them on the controller's device (``cuda`` unless the caller passes
one), computes every node's batch and mid allocatable and the NeedSync
diff gate in one step of torch ops (``ops/overcommit.py``) and reads the
result back once. Host plugins first run the annotation-type
preparations (cpu normalization, then amplification), which may rewrite
the native allocatable the array pass reads.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_CPU_NORMALIZATION_RATIO,
    ANNOTATION_NODE_RAW_ALLOCATABLE,
    ANNOTATION_RESOURCE_AMPLIFICATION_RATIO,
    NUM_RESOURCES,
    PriorityClass,
    QoSClass,
    ResourceName,
    parse_node_reservation,
)
from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    NodeMetric,
    NodeSpec,
    resources_to_vector,
)
from koordinator_tpu_torch.manager.sloconfig import (
    ColocationConfig,
    ColocationStrategy,
)
from koordinator_tpu_torch.ops.overcommit import (
    CalculatePolicy,
    NodeOvercommitInputs,
    OvercommitParams,
    PodOvercommitInputs,
    needs_sync,
    overcommit_allocatable,
)

_POLICY_BY_NAME = {
    "usage": CalculatePolicy.USAGE,
    "request": CalculatePolicy.REQUEST,
    "maxUsageRequest": CalculatePolicy.MAX_USAGE_REQUEST,
}

#: Extended resource columns owned by this controller.
OVERCOMMIT_COLUMNS = (
    ResourceName.BATCH_CPU,
    ResourceName.BATCH_MEMORY,
    ResourceName.MID_CPU,
    ResourceName.MID_MEMORY,
)


@dataclasses.dataclass
class NodeResourceUpdate:
    """One node's reconcile outcome."""

    node_name: str
    #: new values for the overcommit columns (canonical units)
    allocatable: Dict[ResourceName, int]
    #: whether the diff threshold requires writing back
    synced: bool
    #: degraded to zero because the NodeMetric was stale or missing
    degraded: bool
    #: annotations to set on the node (amplification etc.)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: node metadata (annotations, native allocatable) changed and must be
    #: written back even when the overcommit diff is below threshold
    meta_synced: bool = False


def _is_metric_fresh(metric: Optional[NodeMetric],
                     strategy: ColocationStrategy, now: float) -> bool:
    """The degrade gate: no metric, or an update older than
    DegradeTimeMinutes."""
    if metric is None or metric.update_time <= 0:
        return False
    return now - metric.update_time <= strategy.degrade_time_minutes * 60


class HostPlugin:
    """An annotation-type noderesource plugin, run on the host: its output
    is node metadata rather than array math."""

    name = "hostplugin"

    def prepare(self, node: NodeSpec, update: NodeResourceUpdate) -> None:
        raise NotImplementedError


#: Normalization ratios beyond this are malformed: real ones are ~1-2x,
#: and huge values would overflow the int32 capacity columns.
_MAX_NORMALIZATION_RATIO = 100.0


def _cpu_normalization_ratio(node: NodeSpec) -> Optional[float]:
    """The parsed cpu-normalization ratio, or None when absent, malformed
    or not amplifying (ratio <= 1)."""
    raw = node.annotations.get(ANNOTATION_CPU_NORMALIZATION_RATIO)
    if raw is None:
        return None
    try:
        ratio = float(raw)
    except ValueError:
        return None
    # rejects NaN, inf, and int32-overflowing values
    if not 1 < ratio <= _MAX_NORMALIZATION_RATIO:
        return None
    return ratio


class ResourceAmplificationPlugin(HostPlugin):
    """Sets the node's resource-amplification-ratio annotation from the
    cpu normalization ratio (ratio <= 1: no annotation)."""

    name = "ResourceAmplification"

    def prepare(self, node: NodeSpec, update: NodeResourceUpdate) -> None:
        ratio = _cpu_normalization_ratio(node)
        if ratio is None:
            return
        value = json.dumps({"cpu": ratio})
        update.annotations[ANNOTATION_RESOURCE_AMPLIFICATION_RATIO] = value
        if node.annotations.get(ANNOTATION_RESOURCE_AMPLIFICATION_RATIO) != value:
            node.annotations[ANNOTATION_RESOURCE_AMPLIFICATION_RATIO] = value
            update.meta_synced = True


class CPUNormalizationPlugin(HostPlugin):
    """Amplifies the node's CPU allocatable by the normalization ratio,
    keeping the raw value; the raw allocatable comes back when the ratio
    is removed or drops to <= 1."""

    name = "CPUNormalization"

    def prepare(self, node: NodeSpec, update: NodeResourceUpdate) -> None:
        ratio = _cpu_normalization_ratio(node)
        old_cpu = node.allocatable.get(ResourceName.CPU, 0)
        if ratio is None:
            if node.raw_allocatable is not None:
                node.allocatable[ResourceName.CPU] = node.raw_allocatable.get(
                    ResourceName.CPU, old_cpu
                )
                node.raw_allocatable = None
                update.meta_synced = True
            return
        base_cpu = old_cpu
        if node.raw_allocatable is None:
            node.raw_allocatable = dict(node.allocatable)
        else:
            base_cpu = node.raw_allocatable.get(ResourceName.CPU, base_cpu)
        amplified = int(base_cpu * ratio)
        if amplified != old_cpu:
            update.meta_synced = True
        node.allocatable[ResourceName.CPU] = amplified
        update.annotations[ANNOTATION_NODE_RAW_ALLOCATABLE] = json.dumps(
            {"cpu": base_cpu}
        )


def _overcommit_step(nodes, pods, params, old_alloc, diff_threshold_percent,
                     enabled):
    """``(new_alloc [N, R], sync [N])`` on the inputs' device. A disabled
    strategy withdraws the batch and mid resources, and ``needs_sync``
    then fires iff the old values were nonzero."""
    new_alloc = overcommit_allocatable(nodes, pods, params)
    new_alloc = torch.where(enabled[:, None], new_alloc, 0)
    sync = needs_sync(old_alloc, new_alloc, diff_threshold_percent)
    return new_alloc, sync


class NodeResourceController:
    """The batched noderesource reconciler. ``last_timings`` holds the
    last reconcile's ``lower_s`` (host lowering, the host plugins
    included), ``stage_s`` (the copies to the device), ``step_s`` (the
    step's dispatch) and ``readback_s`` (the one read-back, which waits
    for the step)."""

    def __init__(self, config: Optional[ColocationConfig] = None,
                 plugins: Optional[Sequence[HostPlugin]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config or ColocationConfig(
            cluster_strategy=ColocationStrategy(enable=True)
        )
        self.plugins: List[HostPlugin] = list(
            plugins
            if plugins is not None
            else (CPUNormalizationPlugin(), ResourceAmplificationPlugin())
        )
        #: node name -> time of the last synced write-back, for the
        #: periodic force-update gate (update_time_threshold_seconds)
        self._last_sync: Dict[str, float] = {}
        self.last_timings: Dict[str, float] = {}

    # -- lowering -----------------------------------------------------------

    def _lower_nodes(self, snapshot: ClusterSnapshot,
                     strategies: List[ColocationStrategy]) -> Dict[str, np.ndarray]:
        n = len(snapshot.nodes)
        capacity = np.zeros((n, NUM_RESOURCES), np.int32)
        system_used = np.zeros((n, NUM_RESOURCES), np.int32)
        reserved = np.zeros((n, NUM_RESOURCES), np.int32)
        prod_reclaimable = np.zeros((n, NUM_RESOURCES), np.int32)
        fresh = np.zeros(n, bool)
        for i, node in enumerate(snapshot.nodes):
            capacity[i] = resources_to_vector(node.allocatable)
            metric = snapshot.node_metrics.get(node.name)
            fresh[i] = _is_metric_fresh(metric, strategies[i], snapshot.now)
            if metric is not None:
                system_used[i] = resources_to_vector(metric.sys_usage)
                # BE host applications run on reclaimed resources: their
                # usage must not shrink batch capacity (clamped at zero)
                for app, usage in metric.host_app_usages.items():
                    if metric.host_app_qos.get(app) == QoSClass.BE:
                        system_used[i] = np.maximum(
                            system_used[i] - resources_to_vector(usage), 0
                        )
                prod_reclaimable[i] = resources_to_vector(
                    metric.prod_reclaimable
                )
            # a malformed annotation on one node must not abort the
            # cluster-wide reconcile; the batch calculator subtracts the
            # reservation whatever its apply policy
            spec = parse_node_reservation(node.annotations)
            if spec is not None:
                reserved[i, ResourceName.CPU] = spec["cpu"]
                reserved[i, ResourceName.MEMORY] = spec["memory"]
        return dict(capacity=capacity, system_used=system_used,
                    reserved=reserved, prod_reclaimable=prod_reclaimable,
                    metric_fresh=fresh)

    def _lower_pods(self, snapshot: ClusterSnapshot,
                    node_index: Dict[str, int]) -> Dict[str, np.ndarray]:
        rows = []  # (node_idx, req, usage, has_metric, is_hp, is_lse)
        seen_uids = set()
        for pod in snapshot.pods:
            idx = node_index.get(pod.node_name or "", -1)
            metric = snapshot.node_metrics.get(pod.node_name or "")
            usage = None
            if metric is not None and pod.uid in metric.pod_usages:
                usage = resources_to_vector(metric.pod_usages[pod.uid])
                seen_uids.add(pod.uid)
            is_hp = pod.priority_class not in (
                PriorityClass.BATCH,
                PriorityClass.FREE,
            )
            rows.append((
                idx,
                resources_to_vector(pod.requests),
                usage if usage is not None else np.zeros(NUM_RESOURCES, np.int64),
                usage is not None,
                is_hp,
                pod.qos is QoSClass.LSE,
            ))
        # dangling: reported in a NodeMetric but absent from the pod list;
        # req = 0 rows, the priority from the metric's recorded class
        # (default HP)
        for node_name, metric in snapshot.node_metrics.items():
            idx = node_index.get(node_name, -1)
            for uid, usage in metric.pod_usages.items():
                if uid in seen_uids:
                    continue
                cls = metric.pod_priority_class.get(uid, PriorityClass.PROD)
                if cls in (PriorityClass.BATCH, PriorityClass.FREE):
                    continue
                rows.append((
                    idx,
                    np.zeros(NUM_RESOURCES, np.int64),
                    resources_to_vector(usage),
                    True,
                    True,
                    False,
                ))
        if not rows:
            rows.append((
                -1,
                np.zeros(NUM_RESOURCES, np.int64),
                np.zeros(NUM_RESOURCES, np.int64),
                False,
                False,
                False,
            ))
        idxs, reqs, usages, has_metric, is_hp, is_lse = zip(*rows)
        return dict(
            node_idx=np.array(idxs, np.int32),
            req=np.stack(reqs).astype(np.int32),
            usage=np.stack(usages).astype(np.int32),
            has_metric=np.array(has_metric, bool),
            is_hp=np.array(is_hp, bool),
            is_lse=np.array(is_lse, bool),
            active=np.ones(len(rows), bool),
        )

    def _stage(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, copy=True)
                for k, v in arrays.items()}

    # -- reconcile ----------------------------------------------------------

    def reconcile_all(self, snapshot: ClusterSnapshot) -> List[NodeResourceUpdate]:
        """Compute every node's batch and mid allocatable; returns one
        update per node with the NeedSync decision applied. Mutates the
        snapshot's ``NodeSpec.allocatable`` of synced nodes (the
        reference PATCHes Node.status.allocatable)."""
        if not snapshot.nodes:
            return []
        t0 = time.perf_counter()
        strategies = [
            self.config.strategy_for_node(n.labels) for n in snapshot.nodes
        ]
        updates: List[NodeResourceUpdate] = []

        # host plugins first: they may rewrite native allocatable (cpu
        # normalization), which feeds the array pass
        pre = [
            NodeResourceUpdate(n.name, {}, synced=False, degraded=False)
            for n in snapshot.nodes
        ]
        for plugin in self.plugins:
            for node, upd in zip(snapshot.nodes, pre):
                plugin.prepare(node, upd)

        node_index = {n.name: i for i, n in enumerate(snapshot.nodes)}
        nodes_np = self._lower_nodes(snapshot, strategies)
        pods_np = self._lower_pods(snapshot, node_index)

        # per-node strategy knobs as [N, ...] arrays: node-selector
        # overrides cost nothing extra
        n = len(snapshot.nodes)
        old_alloc = np.zeros((n, NUM_RESOURCES), np.int32)
        reclaim = np.zeros((n, NUM_RESOURCES), np.int32)
        mid_thr = np.zeros((n, NUM_RESOURCES), np.int32)
        cpu_pol = np.zeros(n, np.int32)
        mem_pol = np.zeros(n, np.int32)
        diff_thr = np.zeros(n, np.int32)
        enabled = np.zeros(n, bool)
        clamp_pct = lambda p: min(max(int(p), 0), 100)  # noqa: E731
        for i, (node, s) in enumerate(zip(snapshot.nodes, strategies)):
            for col in OVERCOMMIT_COLUMNS:
                old_alloc[i, col] = node.allocatable.get(col, 0)
            # clamped to [0, 100]: a malformed override must not mint
            # batch allocatable beyond node capacity (and the exact
            # percent identities assume pct <= 100)
            reclaim[i, ResourceName.CPU] = clamp_pct(
                s.cpu_reclaim_threshold_percent
            )
            reclaim[i, ResourceName.MEMORY] = clamp_pct(
                s.memory_reclaim_threshold_percent
            )
            mid_thr[i, ResourceName.CPU] = clamp_pct(s.mid_cpu_threshold_percent)
            mid_thr[i, ResourceName.MEMORY] = clamp_pct(
                s.mid_memory_threshold_percent
            )
            cpu_pol[i] = _POLICY_BY_NAME.get(
                s.cpu_calculate_policy, CalculatePolicy.USAGE
            )
            mem_pol[i] = _POLICY_BY_NAME.get(
                s.memory_calculate_policy, CalculatePolicy.USAGE
            )
            diff_thr[i] = int(round(s.resource_diff_threshold * 100))
            enabled[i] = s.enable
        t1 = time.perf_counter()

        staged = self._stage(dict(
            reclaim=reclaim, mid_thr=mid_thr, cpu_pol=cpu_pol,
            mem_pol=mem_pol, old_alloc=old_alloc, diff_thr=diff_thr,
            enabled=enabled))
        nodes_in = NodeOvercommitInputs(**self._stage(nodes_np))
        pods_in = PodOvercommitInputs(**self._stage(pods_np))
        params = OvercommitParams(
            reclaim_percent=staged["reclaim"],
            mid_threshold_percent=staged["mid_thr"],
            cpu_policy=staged["cpu_pol"],
            memory_policy=staged["mem_pol"],
        )
        t2 = time.perf_counter()
        alloc, sync = _overcommit_step(
            nodes_in, pods_in, params, staged["old_alloc"],
            staged["diff_thr"], staged["enabled"],
        )
        t3 = time.perf_counter()
        # one read-back: the sync mask rides as an extra column
        both = torch.cat([alloc, sync[:, None].to(alloc.dtype)], dim=1).cpu()
        t4 = time.perf_counter()
        new_alloc = both[:, :NUM_RESOURCES].numpy()
        sync_mask = both[:, NUM_RESOURCES].numpy() != 0

        fresh_np = nodes_np["metric_fresh"]
        for i, node in enumerate(snapshot.nodes):
            upd = pre[i]
            upd.allocatable = {
                col: int(new_alloc[i, col]) for col in OVERCOMMIT_COLUMNS
            }
            upd.synced = bool(sync_mask[i])
            # periodic force-update: below the diff threshold, re-sync
            # once update_time_threshold_seconds has passed since the
            # last write-back
            if not upd.synced and bool(enabled[i]):
                thr = strategies[i].update_time_threshold_seconds
                # first sighting baselines at now (no restart storm; the
                # diff gate covers genuinely unsynced nodes)
                last = self._last_sync.setdefault(node.name, snapshot.now)
                if thr > 0 and snapshot.now - last >= thr:
                    upd.synced = True
            upd.degraded = bool(enabled[i]) and not bool(fresh_np[i])
            if upd.synced:
                node.allocatable.update(upd.allocatable)
                self._last_sync[node.name] = snapshot.now
            updates.append(upd)
        # prune departed nodes so the map does not grow with churn
        live = {n.name for n in snapshot.nodes}
        for name in [k for k in self._last_sync if k not in live]:
            del self._last_sync[name]
        self.last_timings = dict(lower_s=t1 - t0, stage_s=t2 - t1,
                                 step_s=t3 - t2, readback_s=t4 - t3)
        return updates
