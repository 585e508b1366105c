"""CPU burst: let latency-sensitive containers briefly exceed their cfs
quota to absorb spikes.

Reference: pkg/koordlet/qosmanager/plugins/cpuburst/cpu_burst.go. Two
halves:

1. **Static burst buffer** (`applyCPUBurst` :561): for each non-BE pod
   with a cpu limit, ``cpu.cfs_burst_us = limit_cores * period *
   CPUBurstPercent / 100``. (Extension beyond the reference: the buffer
   degrades to 0 when the share pool crosses the threshold — the
   reference leaves the static value alone.)

2. **CFS quota burst** (`applyCFSQuotaBurst` :341): throttled pods get
   their cfs quota scaled UP in 1.2x steps, bounded by
   ``base * CFSQuotaBurstPercent / 100``; a token-bucket limiter over
   ``CFSQuotaBurstPeriodSeconds`` (:122-151: capacity =
   period * (maxScale-100) percent-seconds, consumed while usage > 100%
   of limit, refilled while < 60%) forces 0.8x scale-DOWN steps when
   exhausted; the node share-pool state overrides: overload -> scale
   down, cooling (>= 0.9x threshold, :52) -> hold (changeOperationByNode
   :701-709). Node share-pool accounting excludes LSE/LSR requests from
   the total and LSE/LSR/BE usage from the usage (:296-316).

Granularity: this framework's throttle/usage metrics are pod-level
(POD_CPU_THROTTLED_RATIO / POD_CPU_USAGE), so operations are generated
per pod and applied to the pod dir and every container dir. The limiter
seeds DETERMINISTICALLY at half capacity (the reference randomizes the
initial fill in [0, 0.5); determinism is a framework principle).

Counterpart of ``koordinator_tpu/koordlet/qosmanager/cpuburst.py``: host
work in files, bit for bit the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.metriccache import AggregationType, MetricKind
from koordinator_tpu_torch.koordlet.qosmanager.framework import QoSContext
from koordinator_tpu_torch.koordlet.resourceexecutor import CgroupUpdater
from koordinator_tpu_torch.koordlet.system.cgroup import (
    CFS_PERIOD_US,
    CPU_CFS_QUOTA,
)

#: cfs quota scale steps (cpu_burst.go:49-50)
CFS_INCREASE_STEP = 1.2
CFS_DECREASE_STEP = 0.8
#: cooling band starts at this fraction of the share-pool threshold (:52)
SHARE_POOL_COOLING_RATIO = 0.9
#: limiter consume/save usage thresholds, percent of limit (:54-55)
LIMITER_CONSUME_ABOVE_PCT = 100
LIMITER_SAVE_BELOW_PCT = 60

#: node share-pool states (cpu_burst.go:83-94)
OVERLOAD, COOLING, IDLE, UNKNOWN = "overload", "cooling", "idle", "unknown"


def __getattr__(name: str):
    """``milli_cpu_to_quota`` is the runtime hooks' (``runtimehooks/
    protocol.py``), imported on first use as ``_base_quota_us`` does, so
    importing this module never imports the hooks."""
    if name == "milli_cpu_to_quota":
        from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
            milli_cpu_to_quota,
        )

        return milli_cpu_to_quota
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class BurstLimiter:
    """Token bucket in percent-seconds (cpu_burst.go burstLimiter)."""

    def __init__(self, period_sec: int, max_scale_pct: int):
        self.capacity = float(period_sec * (max_scale_pct - 100))
        # deterministic half-fill (reference: random in [0, 0.5)*cap)
        self.token = self.capacity / 2
        self.last: Optional[float] = None

    def update_if_changed(self, period_sec: int, max_scale_pct: int) -> None:
        new_capacity = float(period_sec * (max_scale_pct - 100))
        if new_capacity != self.capacity:
            self.__init__(period_sec, max_scale_pct)

    #: a gap longer than this means the plugin was not reconciling
    #: (disabled, or the daemon was down — the reference's limiter is
    #: in-memory so a restart starts fresh); integrating it as one dt
    #: would slam the bucket to +-capacity
    GAP_RESET_SEC = 30.0

    def allow(self, now: float, usage_scale_pct: int) -> bool:
        # float dt throughout: the reference truncates to whole seconds
        # (:142), which at a ~1s tick cadence would discard most of the
        # elapsed time and let the bucket never drain
        dt = 0.0 if self.last is None else max(now - self.last, 0.0)
        if dt > self.GAP_RESET_SEC:
            dt = 0.0
        if usage_scale_pct >= LIMITER_CONSUME_ABOVE_PCT:
            self.token -= (usage_scale_pct - 100) * dt
        elif usage_scale_pct < LIMITER_SAVE_BELOW_PCT:
            self.token += (100 - usage_scale_pct) * dt
        self.token = max(min(self.token, self.capacity), -self.capacity)
        self.last = now
        return self.token > 0


class CPUBurst:
    name = "cpuburst"
    interval_seconds = 1.0

    def __init__(self):
        #: pod uid -> BurstLimiter (containerLimiter analogue)
        self._limiters: Dict[str, BurstLimiter] = {}
        #: True once any burst/scale write happened: a policy flip to
        #: "none" must still run ONE cleanup pass resetting quotas and
        #: burst buffers, or disabling the feature would leave pods with
        #: a permanent 3x quota override
        self._dirty: bool = False

    def enabled(self, ctx: QoSContext) -> bool:
        return (
            ctx.node_slo.cpu_burst_strategy.policy != "none" or self._dirty
        )

    # -- node share-pool state ----------------------------------------------

    def _pod_usages_last(self, ctx: QoSContext, pods,
                         now: float) -> Dict[str, Optional[float]]:
        """One LAST aggregation per pod per tick, shared by the node
        share-pool accounting and the limiter."""
        return {
            pod.uid: ctx.metric_cache.aggregate(
                MetricKind.POD_CPU_USAGE, {"pod": pod.uid},
                start=now - ctx.metric_collect_interval, end=now,
                agg=AggregationType.LAST,
            )
            for pod in pods
        }

    def _base_quota_us(self, ctx: QoSContext, limit_mcpu: int) -> int:
        """The pod's steady-state quota: the SAME formula the
        cpu-normalization hook writes (milli_cpu_to_quota, then
        ceil(quota/ratio) when a ratio is active) so burst scaling floors
        at the normalized value instead of ping-ponging against it."""
        from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
            milli_cpu_to_quota,
        )

        quota = milli_cpu_to_quota(limit_mcpu)
        if quota <= 0:
            return quota
        ratio = ctx.cpu_normalization_ratio
        if ratio and ratio > 1.0:
            quota = math.ceil(quota / ratio)
        return quota

    def _node_burst_state(self, ctx: QoSContext, usages, now: float) -> str:
        """cpu_burst.go:262-340 getNodeStateForBurst, pod-granular."""
        strategy = ctx.node_slo.cpu_burst_strategy
        if ctx.node_capacity_mcpu <= 0:
            return UNKNOWN
        node_usage = ctx.metric_cache.aggregate(
            MetricKind.NODE_CPU_USAGE,
            start=now - ctx.metric_collect_interval, end=now,
            agg=AggregationType.LAST,
        )
        if node_usage is None:
            return UNKNOWN
        pool_total = float(ctx.node_capacity_mcpu)
        pool_usage = float(node_usage)
        for pod in ctx.pod_provider.running_pods():
            if pod.qos in (QoSClass.LSE, QoSClass.LSR):
                pool_total -= pod.cpu_request_mcpu
            if pod.qos in (QoSClass.LSE, QoSClass.LSR, QoSClass.BE):
                usage = usages.get(pod.uid)
                if usage is not None:
                    pool_usage -= usage
        threshold = strategy.share_pool_threshold_percent / 100.0
        cooling = threshold * SHARE_POOL_COOLING_RATIO
        ratio = 1.0 if pool_total <= 0 else pool_usage / pool_total
        if ratio >= threshold:
            return OVERLOAD
        if ratio >= cooling:
            return COOLING
        return IDLE

    # -- cfs quota burst ----------------------------------------------------

    def _quota_operation(self, ctx: QoSContext, pod, strategy, usages,
                         now: float) -> str:
        """genOperationByContainer (:467-501), pod-granular: 'up',
        'down', 'remain', or 'reset'.

        The limiter ticks BEFORE the policy check — the reference runs
        cfsBurstAllowedByLimiter first — so across a disabled stretch
        the clock keeps advancing and tokens keep refilling while usage
        is low, instead of freezing and then integrating the whole gap
        as one dt on re-enable (ADVICE r4)."""
        allowed = True
        if (strategy.cfs_quota_burst_period_seconds >= 0
                and strategy.cfs_quota_burst_percent >= 100):
            limiter = self._limiters.get(pod.uid)
            if limiter is None:
                limiter = self._limiters[pod.uid] = BurstLimiter(
                    strategy.cfs_quota_burst_period_seconds,
                    strategy.cfs_quota_burst_percent,
                )
            else:
                limiter.update_if_changed(
                    strategy.cfs_quota_burst_period_seconds,
                    strategy.cfs_quota_burst_percent,
                )
            usage = usages.get(pod.uid)
            scale_pct = 100
            if usage is not None and pod.cpu_limit_mcpu > 0:
                scale_pct = int(usage / pod.cpu_limit_mcpu * 100)
            allowed = limiter.allow(now, scale_pct)
        if strategy.policy not in ("auto", "cfsQuotaBurstOnly"):
            return "reset"
        if strategy.cfs_quota_burst_period_seconds >= 0:
            if strategy.cfs_quota_burst_percent < 100:
                return "down"  # illegal config -> not allowed (:558-561)
            if not allowed:
                return "down"
        throttled = ctx.metric_cache.aggregate(
            MetricKind.POD_CPU_THROTTLED_RATIO, {"pod": pod.uid},
            start=now - ctx.metric_collect_interval, end=now,
            agg=AggregationType.LAST,
        )
        if throttled is None:
            return "remain"
        return "up" if throttled > 0 else "remain"

    @staticmethod
    def _apply_node_state(state: str, op: str) -> str:
        """changeOperationByNode (:701-709)."""
        if state == OVERLOAD and op in ("up", "remain"):
            return "down"
        if state in (COOLING, UNKNOWN) and op == "up":
            return "remain"
        return op

    def _scale_quota_dir(self, ctx: QoSContext, cgroup_dir: str,
                         base: int, ceil: int, op: str) -> str:
        """Scale one dir's cfs quota (applyCFSQuotaBurst :397-407):
        target = clamp(step(current), base, ceil). Returns "wrote",
        "unreadable" (dir not materialized — the cleanup pass must stay
        armed), or "noop"."""
        if base <= 0:
            return "noop"
        try:
            raw = CPU_CFS_QUOTA.read(cgroup_dir, ctx.system_config)
            current = int(raw)
        except (OSError, ValueError):
            return "unreadable"  # not materialized yet: skip this round
        if current <= 0:
            return "noop"  # unlimited: nothing to scale (:389-392)
        if op == "up":
            target = int(current * CFS_INCREASE_STEP)
        elif op == "down":
            target = int(current * CFS_DECREASE_STEP)
        elif op == "reset":
            target = base
        else:
            return "noop"
        target = max(base, min(target, ceil))
        if target == current:
            return "noop"
        ctx.executor.update(True, CgroupUpdater(
            "cpu.cfs_quota_us", cgroup_dir, str(target)))
        self._dirty = True
        ctx.log("cpuburst", cgroup_dir, "cfs_quota_burst",
                f"{op}: {current} -> {target}")
        return "wrote"

    # -- main ---------------------------------------------------------------

    def execute(self, ctx: QoSContext, now: float) -> None:
        strategy = ctx.node_slo.cpu_burst_strategy
        # policy flipped to "none" with scaled state outstanding: one
        # cleanup pass resets quota to base and the burst buffer to 0
        cleanup = strategy.policy == "none"
        pods = ctx.pod_provider.running_pods()
        usages = (
            {} if cleanup else self._pod_usages_last(ctx, pods, now)
        )
        node_state = (
            UNKNOWN if cleanup else self._node_burst_state(ctx, usages, now)
        )
        burst_allowed = strategy.policy in ("auto", "cpuBurstOnly") and (
            node_state != OVERLOAD
        )
        cleanup_incomplete = False
        live_uids = set()
        for pod in pods:
            if pod.qos is QoSClass.BE or pod.cpu_limit_mcpu <= 0:
                continue
            live_uids.add(pod.uid)
            # -- half 1: static burst buffer (applyCPUBurst) -------------
            if burst_allowed:
                burst_us = (
                    pod.cpu_limit_mcpu * CFS_PERIOD_US
                    * strategy.cpu_burst_percent // 100 // 1000
                )
            else:
                burst_us = 0
            for bdir in [pod.cgroup_dir, *pod.containers.values()]:
                if ctx.executor.update(True, CgroupUpdater(
                        "cpu.cfs_burst_us", bdir, str(burst_us))):
                    self._dirty = self._dirty or burst_us > 0

            # -- half 2: cfs quota burst (applyCFSQuotaBurst) ------------
            if cleanup:
                op = "reset"
            else:
                op = self._apply_node_state(
                    node_state,
                    self._quota_operation(ctx, pod, strategy, usages, now),
                )
            base = self._base_quota_us(ctx, pod.cpu_limit_mcpu)
            ceil = base
            if not cleanup and strategy.cfs_quota_burst_percent > 100:
                ceil = base * strategy.cfs_quota_burst_percent // 100
            unreadable = (
                self._scale_quota_dir(ctx, pod.cgroup_dir, base, ceil, op)
                == "unreadable"
            )
            for name, cdir in pod.containers.items():
                climit = pod.container_limits_mcpu.get(name, 0)
                if climit <= 0:
                    continue
                cbase = self._base_quota_us(ctx, climit)
                cceil = cbase
                if not cleanup and strategy.cfs_quota_burst_percent > 100:
                    cceil = cbase * strategy.cfs_quota_burst_percent // 100
                if self._scale_quota_dir(
                        ctx, cdir, cbase, cceil, op) == "unreadable":
                    unreadable = True
            if cleanup and unreadable:
                cleanup_incomplete = True
        if cleanup:
            # stay armed (dirty) while any scaled dir was unreadable this
            # pass, so the reset retries next tick instead of stranding a
            # burst quota override. (A pod absent from running_pods()
            # during the window is the residual gap — same exposure the
            # reference has when a pod vanishes mid-reconcile.)
            if not cleanup_incomplete:
                self._dirty = False
                self._limiters.clear()
            return
        # limiter recycle (Recycle :638-645)
        for uid in list(self._limiters):
            if uid not in live_uids:
                del self._limiters[uid]
