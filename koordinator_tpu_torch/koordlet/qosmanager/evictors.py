"""Pressure-driven best-effort eviction strategies.

Reference: pkg/koordlet/qosmanager/plugins/{memoryevict/memory_evict.go,
cpuevict/cpu_evict.go}.

Memory: when node memory usage% exceeds MemoryEvictThresholdPercent,
evict BE pods (lowest priority first, then largest memory) until
``capacity * (usage% - lower%) / 100`` MiB is released; lower defaults to
threshold - 2 (memory_evict.go:101-160).

CPU: when the BE tier's real cfs limit falls below
CPUEvictBESatisfactionLowerPercent of BE requests while BE pods are
actually cpu-starved (usage/limit >= 90%), release
``(upper% - satisfaction) * request`` mCPU by evicting BE pods (lowest
priority first, then highest cpu usage) (cpu_evict.go:246-360).

Counterpart of ``koordinator_tpu/koordlet/qosmanager/evictors.py``: host
work in files, bit for bit the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.metriccache import AggregationType, MetricKind
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta
from koordinator_tpu_torch.koordlet.qosmanager.framework import QoSContext
from koordinator_tpu_torch.koordlet.resourceexecutor.executor import parse_cfs_quota
from koordinator_tpu_torch.koordlet.system.cgroup import CFS_PERIOD_US, CPU_CFS_QUOTA

MEMORY_RELEASE_BUFFER_PERCENT = 2
BE_CPU_USAGE_THRESHOLD_PERCENT = 90


def _be_pods(ctx: QoSContext) -> List[PodMeta]:
    return [p for p in ctx.pod_provider.running_pods()
            if p.qos is QoSClass.BE]


def _pod_metric_last(ctx: QoSContext, kind: MetricKind, uid: str,
                     now: float) -> Optional[float]:
    return ctx.metric_cache.aggregate(
        kind, {"pod": uid},
        start=now - ctx.metric_collect_interval, end=now,
        agg=AggregationType.LAST,
    )


class MemoryEvictor:
    name = "memoryevict"
    interval_seconds = 1.0
    #: min seconds between eviction rounds (memory_evict.go cooldown)
    cooldown_seconds = 60.0

    def __init__(self):
        self._last_evict = -1e18

    def enabled(self, ctx: QoSContext) -> bool:
        return ctx.node_slo.resource_used_threshold_with_be.enable

    def execute(self, ctx: QoSContext, now: float) -> None:
        threshold = ctx.node_slo.resource_used_threshold_with_be
        pct = threshold.memory_evict_threshold_percent
        lower = threshold.memory_evict_lower_percent
        if lower is None:
            lower = pct - MEMORY_RELEASE_BUFFER_PERCENT
        if pct <= 0 or lower >= pct or ctx.node_capacity_mem_mib <= 0:
            return
        if now - self._last_evict < self.cooldown_seconds:
            return
        used = ctx.metric_cache.aggregate(
            MetricKind.NODE_MEMORY_USAGE,
            start=now - ctx.metric_collect_interval, end=now,
            agg=AggregationType.LAST,
        )
        if used is None:
            return
        usage_pct = used / ctx.node_capacity_mem_mib * 100.0
        if usage_pct < pct:
            return
        need_release_mib = ctx.node_capacity_mem_mib * (
            usage_pct - lower
        ) / 100.0

        infos = []
        for pod in _be_pods(ctx):
            mem = _pod_metric_last(
                ctx, MetricKind.POD_MEMORY_USAGE, pod.uid, now
            ) or 0.0
            infos.append((pod, mem))
        # priority asc; then mem desc; metric-less pods last by name desc
        # (memory_evict.go:203-215)
        infos.sort(key=lambda t: (
            t[0].priority,
            -t[1] if t[1] > 0 else float("inf"),
            tuple(-ord(c) for c in t[0].name),
        ))

        victims, released = [], 0.0
        for pod, mem in infos:
            if released >= need_release_mib:
                break
            victims.append(pod)
            released += mem
        if victims and ctx.evict is not None:
            ctx.evict(victims, "evict by node memory usage")
            self._last_evict = now
            ctx.log("qosmanager/memoryevict", "node", "evict",
                    f"{len(victims)} BE pods, ~{released:.0f} MiB")


class CPUEvictor:
    name = "cpuevict"
    interval_seconds = 1.0
    cooldown_seconds = 60.0

    def __init__(self):
        self._last_evict = -1e18

    def enabled(self, ctx: QoSContext) -> bool:
        t = ctx.node_slo.resource_used_threshold_with_be
        return (
            t.enable
            and t.cpu_evict_be_satisfaction_lower_percent is not None
            and t.cpu_evict_be_satisfaction_upper_percent is not None
        )

    def _be_real_limit_mcpu(self, ctx: QoSContext) -> float:
        """BE tier's effective cpu limit from its cfs quota
        (cpu_evict.go getBEMilliRealLimit)."""
        try:
            raw = CPU_CFS_QUOTA.read(ctx.be_cgroup_dir, ctx.system_config)
        except OSError:
            return float(ctx.node_capacity_mcpu)
        quota = parse_cfs_quota(raw)
        if quota is None or quota <= 0:
            return float(ctx.node_capacity_mcpu)
        return quota / CFS_PERIOD_US * 1000.0

    def _be_limit_mcpu(self, ctx: QoSContext, t) -> float:
        """The satisfaction denominator per CPUEvictPolicy
        (cpu_evict.go:148-151): evictByAllocatable uses the BE tier's
        allocatable (node batch-cpu), the default uses the cfs-quota
        real limit. An unknown allocatable falls back to the real
        limit rather than guessing."""
        if t.cpu_evict_policy == "evictByAllocatable":
            alloc = (
                ctx.be_allocatable_fn() if ctx.be_allocatable_fn else None
            )
            if alloc is not None and alloc > 0:
                return float(alloc)
        return self._be_real_limit_mcpu(ctx)

    def execute(self, ctx: QoSContext, now: float) -> None:
        t = ctx.node_slo.resource_used_threshold_with_be
        if now - self._last_evict < self.cooldown_seconds:
            return
        be_pods = _be_pods(ctx)
        be_request = float(sum(p.cpu_request_mcpu for p in be_pods))
        if be_request <= 0:
            return
        real_limit = self._be_limit_mcpu(ctx, t)
        satisfaction = real_limit / be_request
        lower = t.cpu_evict_be_satisfaction_lower_percent / 100.0
        upper = t.cpu_evict_be_satisfaction_upper_percent / 100.0
        if satisfaction > lower:
            return
        # only evict when BE is actually starved: avg usage near its
        # limit over the configured window (cpu_evict.go:111-114 —
        # the window applies when larger than the collect interval)
        window = max(
            2 * ctx.metric_collect_interval,
            float(t.cpu_evict_time_window_seconds or 0),
        )
        be_usage = ctx.metric_cache.aggregate(
            MetricKind.BE_CPU_USAGE,
            start=now - window, end=now,
            agg=AggregationType.AVG,
        )
        if be_usage is None or real_limit <= 0:
            return
        usage_threshold = t.cpu_evict_be_usage_threshold_percent or (
            BE_CPU_USAGE_THRESHOLD_PERCENT
        )
        if be_usage / real_limit * 100.0 < usage_threshold:
            return

        release_mcpu = (upper - satisfaction) * be_request

        infos = []
        for pod in be_pods:
            usage = _pod_metric_last(
                ctx, MetricKind.POD_CPU_USAGE, pod.uid, now
            ) or 0.0
            rel_usage = (
                usage / pod.cpu_request_mcpu if pod.cpu_request_mcpu else 0.0
            )
            infos.append((pod, rel_usage))
        # priority asc, then relative cpu usage desc (cpu_evict.go:354-360)
        infos.sort(key=lambda x: (x[0].priority, -x[1]))

        victims, released = [], 0.0
        for pod, _ in infos:
            if released >= release_mcpu:
                break
            victims.append(pod)
            released += pod.cpu_request_mcpu
        if victims and ctx.evict is not None:
            ctx.evict(victims, "evict by BE cpu satisfaction")
            self._last_evict = now
            ctx.log("qosmanager/cpuevict", "node", "evict",
                    f"{len(victims)} BE pods, ~{released:.0f} mCPU")
