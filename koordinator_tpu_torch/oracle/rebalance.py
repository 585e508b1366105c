"""Scalar host oracle for the LowNodeLoad Balance pass (a copy of
``koordinator_tpu/oracle/rebalance.py``: the parity authority).

A direct transliteration of the reference's complete sweep —
pkg/descheduler/framework/plugins/loadaware/low_node_load.go:134-326 and
utilization_util.go (thresholds, classification, node/pod sorting,
eviction loop, headroom accounting) plus pkg/descheduler/utils/sorter —
written scalar-first: per-node dict maps, explicit comparator functions
under ``functools.cmp_to_key``, one pod at a time. No code is shared
with the plugin under test (``descheduler/loadaware.py``): this module
re-derives every decision from the reference so a differential run is
meaningful.

Determinism note: the reference sorts with Go's unstable ``sort.Sort``;
full ties are order-unspecified there. Oracle and plugin both refine
full ties by input order (stable sorts), the one departure — shared, so
it cancels in the differential.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

from koordinator_tpu_torch.apis.extension import (
    PriorityClass,
    QoSClass,
    ResourceName,
)

#: sorter/pod.go order maps, re-declared (no import from the module
#: under test's dependencies)
_PC_ORDER = {
    PriorityClass.NONE: 5, PriorityClass.PROD: 4, PriorityClass.MID: 3,
    PriorityClass.BATCH: 2, PriorityClass.FREE: 1,
}
_QOS_ORDER = {
    QoSClass.NONE: 5, QoSClass.SYSTEM: 4, QoSClass.LSE: 4,
    QoSClass.LSR: 3, QoSClass.LS: 2, QoSClass.BE: 1,
}


def _kube_qos(pod) -> int:
    reqs = {k: v for k, v in pod.requests.items() if v}
    lims = {k: v for k, v in pod.limits.items() if v}
    if not reqs and not lims:
        return 1  # besteffort
    # guaranteed needs requests == limits AND cpu+memory both limited
    if (reqs == lims and lims.get(ResourceName.CPU)
            and lims.get(ResourceName.MEMORY)):
        return 3
    return 2  # burstable


def _cost(pod, key: str) -> int:
    raw = pod.annotations.get(key)
    if not raw:
        return 0
    if not (raw[0] == "-" or raw == "0" or "1" <= raw[0] <= "9"):
        return 0
    try:
        return int(raw)
    except ValueError:
        return 0


def _most_requested(requested: int, capacity: int) -> int:
    if capacity == 0:
        return 0
    return min(requested, capacity) * 1000 // capacity


def _usage_scorer(weights: Dict) -> Callable:
    """sorter/scorer.go ResourceUsageScorer closure."""

    def score(usage_map: Dict, allocatable: Dict) -> int:
        total, weight_sum = 0, 0
        for resource, quantity in usage_map.items():
            w = int(weights.get(resource, 0))
            total += _most_requested(
                int(quantity), int(allocatable.get(resource, 0))
            ) * w
            weight_sum += w
        return total // weight_sum if weight_sum else 0

    return score


class _Detector:
    """Streak counters (anomaly.BasicDetector re-derivation)."""

    def __init__(self, need_abnormal: int):
        self.need_abnormal = need_abnormal
        self.abnormal = 0
        self.normal = 0
        self.anomalous = False

    def mark(self, is_normal: bool) -> bool:
        if is_normal:
            self.normal += 1
            self.abnormal = 0
            if self.anomalous and self.normal > 1:
                self.anomalous = False
        else:
            self.abnormal += 1
            self.normal = 0
            if self.abnormal > self.need_abnormal:
                self.anomalous = True
        return self.anomalous

    def reset(self) -> None:
        self.abnormal = 0
        self.normal = 0
        self.anomalous = False


class RebalanceOracle:
    """Stateful sweep oracle; one instance mirrors one plugin instance
    (detector streaks persist across sweeps)."""

    def __init__(self, args):
        self.args = args
        self.detectors: Dict[str, _Detector] = {}
        # node -> usage over every resource column (node-fit probe)
        self._full_usage: Dict[str, Dict] = {}

    # -- one full Balance pass ---------------------------------------------
    def sweep(
        self,
        snapshot,
        evict_allowed: Optional[Callable] = None,
    ) -> List[Tuple[str, str]]:
        """Returns the ordered eviction list [(node_name, pod_uid)]."""
        evictions: List[Tuple[str, str]] = []
        processed: set = set()
        for pool in self.args.node_pools:
            if self.args.paused:
                break
            self._pool_pass(pool, snapshot, evictions, processed,
                            evict_allowed or (lambda pod: True))
        return evictions

    def _pool_pass(self, pool, snapshot, evictions, processed,
                   evict_allowed) -> None:
        from koordinator_tpu_torch.apis.types import selector_matches

        nodes = [
            n for n in snapshot.nodes
            if n.name not in processed
            and selector_matches(pool.node_selector, n.labels)
        ]
        if not nodes:
            return

        # newThresholds: fill the union of names (+memory always)
        resource_names = sorted(
            set(pool.low_thresholds) | set(pool.high_thresholds)
            | {ResourceName.MEMORY},
            key=int,
        )
        fill = 0.0 if pool.use_deviation_thresholds else 100.0
        low_pct = {
            r: float(pool.low_thresholds.get(r, fill))
            for r in resource_names
        }
        high_pct = {
            r: float(pool.high_thresholds.get(r, fill))
            for r in resource_names
        }

        # getNodeUsage: node -> usage map over resource_names; nodes
        # with no fresh metric drop out entirely
        usages: Dict[str, Dict] = {}
        pod_metrics: Dict[str, Dict[str, Dict]] = {}
        expiry = self.args.node_metric_expiration_seconds
        for node in nodes:
            metric = snapshot.node_metrics.get(node.name)
            if metric is None:
                continue
            if (expiry is not None
                    and snapshot.now - metric.update_time > expiry):
                continue
            usages[node.name] = {
                r: int(metric.node_usage.get(r, 0)) for r in resource_names
            }
            # full-column usage for the node-fit probe (the plugin's
            # fit check spans every resource column, thresholded or not)
            self._full_usage[node.name] = {
                r: int(metric.node_usage.get(r, 0)) for r in ResourceName
            }
            pod_metrics[node.name] = dict(metric.pod_usages)

        # getNodeThresholds, float64 formula
        if pool.use_deviation_thresholds:
            avg = self._average_percent(nodes, usages, resource_names)
        low_q: Dict[str, Dict] = {}
        high_q: Dict[str, Dict] = {}
        for node in nodes:
            if node.name not in usages:
                continue
            lq, hq = {}, {}
            for r in resource_names:
                cap = float(int(node.allocatable.get(r, 0)))
                if pool.use_deviation_thresholds:
                    if low_pct[r] == 0.0:
                        lq[r] = hq[r] = int(node.allocatable.get(r, 0))
                        continue
                    lo = min(max(avg[r] - low_pct[r], 0.0), 100.0)
                    hi = min(max(avg[r] + high_pct[r], 0.0), 100.0)
                else:
                    lo, hi = low_pct[r], high_pct[r]
                lq[r] = int(lo * 0.01 * cap)
                hq[r] = int(hi * 0.01 * cap)
            low_q[node.name] = lq
            high_q[node.name] = hq

        # classifyNodes
        low_nodes, source_nodes = [], []
        for node in nodes:
            u = usages.get(node.name)
            if u is None:
                continue
            if (not node.unschedulable and all(
                    u[r] <= low_q[node.name][r] for r in resource_names)):
                low_nodes.append(node)
            elif any(u[r] > high_q[node.name][r] for r in resource_names):
                source_nodes.append(node)

        for node in source_nodes:
            processed.add(node.name)
        source_names = {n.name for n in source_nodes}
        for node in nodes:
            if node.name in usages and node.name not in source_names:
                det = self.detectors.get(node.name)
                if det is not None:
                    det.mark(True)
        if not source_nodes:
            return

        # filterRealAbnormalNodes
        abnormal = []
        for node in source_nodes:
            det = self.detectors.get(node.name)
            if det is None:
                det = self.detectors[node.name] = _Detector(
                    pool.consecutive_abnormalities
                )
            if pool.consecutive_abnormalities <= 1 or det.mark(False):
                abnormal.append(node)
        if not abnormal:
            return
        for node in low_nodes:
            det = self.detectors.get(node.name)
            if det is not None:
                det.reset()
        if not low_nodes:
            return
        if len(low_nodes) <= self.args.number_of_nodes:
            return
        if len(low_nodes) == len(nodes):
            return

        # totalAvailableUsages over resource_names
        available = {r: 0 for r in resource_names}
        for node in low_nodes:
            for r in resource_names:
                available[r] += high_q[node.name][r] - usages[node.name][r]

        weights = {
            r: int(pool.resource_weights.get(r, 0)) for r in resource_names
        }

        # sortNodesByUsage descending
        node_scorer = _usage_scorer(weights)
        abnormal.sort(
            key=lambda n: node_scorer(
                usages[n.name],
                {r: int(n.allocatable.get(r, 0)) for r in resource_names},
            ),
            reverse=True,
        )

        pods_on: Dict[str, List] = {}
        for pod in snapshot.pods:
            if pod.node_name:
                pods_on.setdefault(pod.node_name, []).append(pod)

        for node in abnormal:
            self._evict_one_node(
                pool, snapshot, node, pods_on.get(node.name, []),
                usages, low_q, high_q, pod_metrics, available,
                resource_names, weights, low_nodes, evictions,
                evict_allowed,
            )
        for node in abnormal:
            det = self.detectors.get(node.name)
            if det is not None:
                det.mark(True)

    def _average_percent(self, nodes, usages, resource_names) -> Dict:
        """calcAverageResourceUsagePercent (float percent mean)."""
        totals = {r: 0.0 for r in resource_names}
        count = 0
        for node in nodes:
            u = usages.get(node.name)
            if u is None:
                continue
            count += 1
            for r in resource_names:
                cap = int(node.allocatable.get(r, 0))
                if cap == 0:
                    continue
                totals[r] += u[r] / cap * 100.0
        if count == 0:
            return {r: 0.0 for r in resource_names}
        return {r: totals[r] / count for r in resource_names}

    def _fits_some_low_node(self, pod, low_nodes, usages) -> bool:
        """nodeutil.PodFitsAnyNode simplification shared with the
        plugin: request fits under allocatable on a low node, across
        every resource column."""
        for node in low_nodes:
            metric_usage = self._full_usage.get(node.name, {})
            ok = True
            for r in ResourceName:
                used = int(metric_usage.get(r, 0))
                req = int(pod.requests.get(r, 0))
                if used + req > int(node.allocatable.get(r, 0)):
                    ok = False
                    break
            if ok:
                return True
        return False

    def _evict_one_node(
        self, pool, snapshot, node, node_pods, usages, low_q, high_q,
        pod_metrics, available, resource_names, weights, low_nodes,
        evictions, evict_allowed,
    ) -> None:
        node_usage = usages[node.name]
        node_high = high_q[node.name]
        metrics = pod_metrics.get(node.name, {})

        removable = []
        for pod in node_pods:
            if pod.is_daemonset:
                continue
            if (self.args.pod_filter is not None
                    and not self.args.pod_filter(pod)):
                continue
            if self.args.node_fit and not self._fits_some_low_node(
                    pod, low_nodes, usages):
                continue
            removable.append(pod)
        if not removable:
            return

        # sortPodsOnOneOverloadedNode: weights only for overused
        over_weights = {
            r: weights[r] for r in resource_names
            if node_usage[r] > node_high[r]
        }
        pod_scorer = _usage_scorer(over_weights)
        allocatable = {r: int(node.allocatable.get(r, 0))
                       for r in ResourceName}

        def compare(p1, p2) -> int:
            for fn in (
                lambda p: _PC_ORDER.get(
                    p.priority_class or PriorityClass.NONE, 5),
                lambda p: p.priority,
                _kube_qos,
                lambda p: _QOS_ORDER.get(p.qos, 5),
                lambda p: _cost(
                    p, "controller.kubernetes.io/pod-deletion-cost"),
                lambda p: _cost(p, "koordinator.sh/eviction-cost"),
            ):
                a, b = fn(p1), fn(p2)
                if a != b:
                    return -1 if a < b else 1
            m1, m2 = p1.uid in metrics, p2.uid in metrics
            if m1 != m2:
                return -1 if m1 else 1   # Reverse(cmpBool): metered first
            if m1:
                s1 = pod_scorer(metrics[p1.uid], allocatable)
                s2 = pod_scorer(metrics[p2.uid], allocatable)
                if s1 != s2:
                    return -1 if s1 > s2 else 1  # Reverse: heavier first
            if p1.creation_time != p2.creation_time:
                # PodCreationTimestamp: newer evicts first
                return -1 if p1.creation_time > p2.creation_time else 1
            return 0

        removable.sort(key=functools.cmp_to_key(compare))

        # evictPods loop
        for pod in removable:
            if not any(node_usage[r] > node_high[r]
                       for r in resource_names):
                det = self.detectors.get(node.name)
                if det is not None:
                    det.reset()
                return
            if any(available[r] <= 0 for r in resource_names):
                return
            if not evict_allowed(pod):
                continue
            evictions.append((node.name, pod.uid))
            pod_metric = metrics.get(pod.uid)
            if pod_metric is None:
                continue  # evicted, nothing to subtract (:339-341)
            for r in resource_names:
                q = int(pod_metric.get(r, 0))
                available[r] -= q
                node_usage[r] -= q
