"""SLO-config admission: validate the cluster strategy configmaps.

The port's copy of ``koordinator_tpu/webhook/cm.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: pkg/webhook/cm/plugins/sloconfig — checkers for the
slo-controller configmaps reject out-of-range strategies before they
reach nodes (colocation_checker.go, cpu_burst_checker.go,
resource_qos_checker.go): thresholds within percent bounds, positive
windows, bvt group identities in the kernel's accepted set, resctrl
ranges ordered.
"""

from __future__ import annotations

from typing import List

from koordinator_tpu_torch.manager.sloconfig import (
    CPUBurstStrategy,
    ColocationStrategy,
    QoSConfig,
    ResourceQOSStrategy,
    ResourceThresholdStrategy,
)

#: kernel-accepted bvt group identities (groupidentity rule values)
_BVT_VALUES = (-1, 0, 2)


def check_colocation(strategy: ColocationStrategy) -> List[str]:
    """colocation_checker.go — delegates to the typed is_valid plus
    the explicit messages the webhook reports."""
    v: List[str] = []
    if not 0 < strategy.cpu_reclaim_threshold_percent <= 100:
        v.append("cpuReclaimThresholdPercent must be in (0, 100]")
    if not 0 < strategy.memory_reclaim_threshold_percent <= 100:
        v.append("memoryReclaimThresholdPercent must be in (0, 100]")
    if strategy.degrade_time_minutes <= 0:
        v.append("degradeTimeMinutes must be positive")
    if strategy.update_time_threshold_seconds <= 0:
        v.append("updateTimeThresholdSeconds must be positive")
    if not 0 < strategy.resource_diff_threshold <= 1:
        v.append("resourceDiffThreshold must be in (0, 1]")
    if strategy.metric_aggregate_duration_seconds <= 0:
        v.append("metricAggregateDurationSeconds must be positive")
    if strategy.metric_report_interval_seconds <= 0:
        v.append("metricReportIntervalSeconds must be positive")
    if strategy.cpu_calculate_policy not in (
        "usage", "request", "maxUsageRequest"
    ):
        v.append(f"unknown cpu calculate policy "
                 f"{strategy.cpu_calculate_policy!r}")
    if strategy.memory_calculate_policy not in (
        "usage", "request", "maxUsageRequest"
    ):
        v.append(f"unknown memory calculate policy "
                 f"{strategy.memory_calculate_policy!r}")
    return v


def check_cpu_burst(strategy: CPUBurstStrategy) -> List[str]:
    """cpu_burst_checker.go bounds."""
    v: List[str] = []
    if strategy.policy not in ("none", "cpuBurstOnly", "cfsQuotaBurstOnly",
                               "auto"):
        v.append(f"unknown cpu burst policy {strategy.policy!r}")
    if strategy.cpu_burst_percent <= 0 or strategy.cpu_burst_percent > 10000:
        v.append("cpuBurstPercent must be in (0, 10000]")
    if strategy.cfs_quota_burst_percent < 100:
        v.append("cfsQuotaBurstPercent must be >= 100")
    if not 0 <= strategy.share_pool_threshold_percent <= 100:
        v.append("sharePoolThresholdPercent must be in [0, 100]")
    return v


def check_threshold(strategy: ResourceThresholdStrategy) -> List[str]:
    v: List[str] = []
    for name, pct in (
        ("cpuSuppressThresholdPercent",
         strategy.cpu_suppress_threshold_percent),
        ("memoryEvictThresholdPercent",
         strategy.memory_evict_threshold_percent),
        ("cpuEvictBEUsageThresholdPercent",
         strategy.cpu_evict_be_usage_threshold_percent),
    ):
        if not 0 < pct <= 100:
            v.append(f"{name} must be in (0, 100]")
    if strategy.cpu_suppress_policy not in ("cpuset", "cfsQuota"):
        v.append(f"unknown cpu suppress policy "
                 f"{strategy.cpu_suppress_policy!r}")
    return v


def _check_qos(tier: str, cfg: QoSConfig) -> List[str]:
    v: List[str] = []
    if cfg.cpu.group_identity not in _BVT_VALUES:
        v.append(f"{tier}: bvt group identity must be one of "
                 f"{_BVT_VALUES}, got {cfg.cpu.group_identity}")
    rq = cfg.resctrl
    if not (0 <= rq.cat_range_start_percent
            <= rq.cat_range_end_percent <= 100):
        v.append(f"{tier}: resctrl LLC range must satisfy "
                 f"0 <= start <= end <= 100")
    if not 0 < rq.mba_percent <= 100:
        v.append(f"{tier}: resctrl MBA percent must be in (0, 100]")
    for pct_name, pct in (("minLimitPercent", cfg.memory.min_limit_percent),
                          ("lowLimitPercent", cfg.memory.low_limit_percent),
                          ("throttlingPercent",
                           cfg.memory.throttling_percent)):
        if not 0 <= pct <= 100:
            v.append(f"{tier}: memory {pct_name} must be in [0, 100]")
    return v


def check_resource_qos(strategy: ResourceQOSStrategy) -> List[str]:
    """resource_qos_checker.go bounds per tier."""
    v: List[str] = []
    for tier in ("lsr", "ls", "be", "system"):
        v.extend(_check_qos(tier, getattr(strategy, tier)))
    return v


class SLOConfigValidatingWebhook:
    """The configmap admission entry (cm/plugins/sloconfig checkers):
    one validate() per config kind; empty list = admitted."""

    def validate_colocation(self, strategy: ColocationStrategy) -> List[str]:
        return check_colocation(strategy)

    def validate_cpu_burst(self, strategy: CPUBurstStrategy) -> List[str]:
        return check_cpu_burst(strategy)

    def validate_threshold(
        self, strategy: ResourceThresholdStrategy
    ) -> List[str]:
        return check_threshold(strategy)

    def validate_resource_qos(
        self, strategy: ResourceQOSStrategy
    ) -> List[str]:
        return check_resource_qos(strategy)
