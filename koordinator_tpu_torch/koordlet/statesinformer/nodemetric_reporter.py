"""NodeMetric reporter: aggregates the metric cache into a NodeMetric.

Reference: pkg/koordlet/statesinformer/impl/states_nodemetric.go —
``collectMetric`` (:332) queries the TSDB for the collect-policy window,
aggregates node + per-pod usage (avg), percentile stats for aggregated-
usage mode, the system residual, prod-tier usage, and the predictor's
prod-reclaimable, then updates the NodeMetric CR status (:244 sync).

Here the produced object is the scheduler-facing
``apis.types.NodeMetric``, so the report loop closes the colocation
cycle in-process: koordlet reports -> manager computes batch resources ->
scheduler places BE pods. Pod aggregation uses the cache's batched
matrix path — all pods reduce in one pass.

Counterpart of
``koordinator_tpu/koordlet/statesinformer/nodemetric_reporter.py``: host
work in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import (
    PriorityClass,
    QoSClass,
    ResourceName,
    priority_class_of,
)
from koordinator_tpu_torch.apis.types import NodeMetric
from koordinator_tpu_torch.koordlet.metriccache import (
    AggregationType,
    MetricCache,
    MetricKind,
)
from koordinator_tpu_torch.koordlet.prediction import (
    PeakPredictServer,
    prod_reclaimable,
)
from koordinator_tpu_torch.koordlet.statesinformer.states_informer import (
    StatesInformer,
)

#: percentile -> aggregation type for aggregated-usage mode
_PCTS = {
    50: AggregationType.P50,
    90: AggregationType.P90,
    95: AggregationType.P95,
    99: AggregationType.P99,
}


def _percentile_usages(cpu_row, mem_row) -> Dict[int, dict]:
    """percentile -> sparse usage map from one window's aggregate rows."""
    out: Dict[int, dict] = {}
    for pct, agg in _PCTS.items():
        usage = {}
        if cpu_row[agg] is not None:
            usage[ResourceName.CPU] = int(cpu_row[agg])
        if mem_row[agg] is not None:
            usage[ResourceName.MEMORY] = int(mem_row[agg])
        if usage:
            out[pct] = usage
    return out


class NodeMetricReporter:
    def __init__(self, metric_cache: MetricCache, informer: StatesInformer,
                 predict_server: Optional[PeakPredictServer] = None):
        self.metric_cache = metric_cache
        self.informer = informer
        self.predict_server = predict_server
        self.last_report: Optional[NodeMetric] = None

    def _primary_duration(self) -> float:
        """The declared policy window — the SINGLE site defining both
        the query window and the reported aggregated_duration key."""
        policy = self.informer.get_collect_policy()
        return float(policy.aggregate_duration_seconds if policy else 300)

    def _window(self, now: float) -> float:
        return now - self._primary_duration()

    def report(self, now: float) -> Optional[NodeMetric]:
        node = self.informer.get_node()
        if node is None:
            return None
        mc = self.metric_cache
        primary_dur = self._primary_duration()
        start = now - primary_dur
        A = AggregationType

        metric = NodeMetric(node_name=node.name, update_time=now)
        policy = self.informer.get_collect_policy()
        if policy is not None:
            metric.report_interval = float(policy.report_interval_seconds)

        # node + system usage (avg over the window) + aggregated
        # percentiles — one batched pass for the primary window
        node_aggs = mc.aggregate_batch(
            [(MetricKind.NODE_CPU_USAGE, None),
             (MetricKind.NODE_MEMORY_USAGE, None),
             (MetricKind.SYS_CPU_USAGE, None),
             (MetricKind.SYS_MEMORY_USAGE, None)],
            start, now, [A.AVG] + list(_PCTS.values()),
        )
        cpu_row, mem_row, sys_cpu_row, sys_mem_row = node_aggs
        if cpu_row[A.AVG] is not None:
            metric.node_usage[ResourceName.CPU] = int(cpu_row[A.AVG])
        if mem_row[A.AVG] is not None:
            metric.node_usage[ResourceName.MEMORY] = int(mem_row[A.AVG])
        metric.aggregated_usage = _percentile_usages(cpu_row, mem_row)
        if metric.aggregated_usage:
            metric.aggregated_duration = primary_dur
        # extra aggregation windows (reference: AggregatePolicy.Durations
        # -> one AggregatedNodeUsages + AggregatedSystemUsages entry
        # each); node + system series reduce in ONE batched pass per
        # window
        for dur in getattr(policy, "aggregate_durations", ()) or ():
            dur = float(dur)
            if dur == primary_dur:
                continue
            w_cpu, w_mem, ws_cpu, ws_mem = mc.aggregate_batch(
                [(MetricKind.NODE_CPU_USAGE, None),
                 (MetricKind.NODE_MEMORY_USAGE, None),
                 (MetricKind.SYS_CPU_USAGE, None),
                 (MetricKind.SYS_MEMORY_USAGE, None)],
                now - dur, now, list(_PCTS.values()),
            )
            by_pct = _percentile_usages(w_cpu, w_mem)
            if by_pct:
                metric.aggregated_windows[dur] = by_pct
            sys_pct = _percentile_usages(ws_cpu, ws_mem)
            if sys_pct:
                metric.aggregated_system_usage[dur] = sys_pct

        # per-pod usage: ONE batched matrix reduction for all pods
        pods = self.informer.running_pods()
        reqs = []
        for pod in pods:
            reqs.append((MetricKind.POD_CPU_USAGE, {"pod": pod.uid}))
            reqs.append((MetricKind.POD_MEMORY_USAGE, {"pod": pod.uid}))
        pod_aggs = mc.aggregate_batch(reqs, start, now, [A.AVG])
        prod_cpu = prod_mem = 0
        for i, pod in enumerate(pods):
            cpu = pod_aggs[2 * i][A.AVG]
            mem = pod_aggs[2 * i + 1][A.AVG]
            usage = {}
            if cpu is not None:
                usage[ResourceName.CPU] = int(cpu)
            if mem is not None:
                usage[ResourceName.MEMORY] = int(mem)
            if usage:
                metric.pod_usages[pod.uid] = usage
                # Reference GetPodPriorityClassWithDefault (slo-controller
                # plugin.go:297): resolve from the priority band, default
                # unlabeled/priority-0 pods to PROD (BE qos -> BATCH) so
                # ordinary k8s pods' usage stays in the HP sums.
                cls = priority_class_of(value=pod.priority or None)
                if cls == PriorityClass.NONE:
                    cls = (
                        PriorityClass.BATCH
                        if pod.qos == QoSClass.BE
                        else PriorityClass.PROD
                    )
                metric.pod_priority_class[pod.uid] = cls
                is_prod = cls == PriorityClass.PROD
                if is_prod:
                    prod_cpu += usage.get(ResourceName.CPU, 0)
                    prod_mem += usage.get(ResourceName.MEMORY, 0)
        metric.prod_usage = {
            ResourceName.CPU: prod_cpu, ResourceName.MEMORY: prod_mem
        }

        # storage accounting: per-device disk throughput/io-util from the
        # nodestorageinfo collector (VERDICT r3 #6 — volume usage rides
        # the NodeMetric onto the bus)
        for dev in mc.label_values(MetricKind.NODE_DISK_READ_BPS, "dev"):
            labels = {"dev": dev}
            rd = mc.aggregate(
                MetricKind.NODE_DISK_READ_BPS, labels, start, now, A.AVG
            )
            wr = mc.aggregate(
                MetricKind.NODE_DISK_WRITE_BPS, labels, start, now, A.AVG
            )
            util = mc.aggregate(
                MetricKind.NODE_DISK_IO_UTIL, labels, start, now, A.AVG
            )
            if rd is None and wr is None and util is None:
                continue
            from koordinator_tpu_torch.apis.types import DiskUsage

            metric.disk_usages[dev] = DiskUsage(
                read_bps=int(rd or 0),
                write_bps=int(wr or 0),
                io_util_pct=int(util or 0),
            )

        # system residual: avg + primary-window percentiles (reference:
        # AggregatedSystemUsages, states_nodemetric.go:342), from the
        # rows the primary batch already produced
        if sys_cpu_row[A.AVG] is not None:
            metric.sys_usage[ResourceName.CPU] = int(sys_cpu_row[A.AVG])
        if sys_mem_row[A.AVG] is not None:
            metric.sys_usage[ResourceName.MEMORY] = int(sys_mem_row[A.AVG])
        sys_pct = _percentile_usages(sys_cpu_row, sys_mem_row)
        if sys_pct:
            metric.aggregated_system_usage[primary_dur] = sys_pct

        # host applications (reference: NodeMetric HostApplicationMetric)
        apps = self.informer.get_node_slo().host_applications
        if apps:
            app_reqs = []
            for app in apps:
                app_reqs.append(
                    (MetricKind.HOST_APP_CPU_USAGE, {"app": app.name})
                )
                app_reqs.append(
                    (MetricKind.HOST_APP_MEMORY_USAGE, {"app": app.name})
                )
            app_aggs = mc.aggregate_batch(app_reqs, start, now, [A.AVG])
            for i, app in enumerate(apps):
                usage = {}
                cpu = app_aggs[2 * i][A.AVG]
                mem = app_aggs[2 * i + 1][A.AVG]
                if cpu is not None:
                    usage[ResourceName.CPU] = int(cpu)
                if mem is not None:
                    usage[ResourceName.MEMORY] = int(mem)
                if usage:
                    metric.host_app_usages[app.name] = usage
                    metric.host_app_qos[app.name] = app.qos

        # predictor: prod reclaimable (feeds MID resources)
        if self.predict_server is not None:
            rec = prod_reclaimable(
                self.predict_server,
                [(p.uid, p.cpu_request_mcpu, p.memory_request_mib)
                 for p in pods
                 if p.qos in (QoSClass.LS, QoSClass.LSR, QoSClass.LSE)],
                now,
            )
            metric.prod_reclaimable = {
                ResourceName.CPU: rec["cpu"],
                ResourceName.MEMORY: rec["memory"],
            }

        self.last_report = metric
        return metric
