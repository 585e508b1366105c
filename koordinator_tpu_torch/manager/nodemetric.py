"""nodemetric controller: reconciles the metric collect policy per node.

The port's copy of ``koordinator_tpu/manager/nodemetric.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: pkg/slo-controller/nodemetric/{nodemetric_controller.go,
collect_policy.go} — the manager creates a NodeMetric CR per node and
stamps the collect policy (aggregate duration / report interval) derived
from the colocation strategy; koordlet reads it to pace its reporting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from koordinator_tpu_torch.manager.sloconfig import ColocationConfig, ColocationStrategy


@dataclasses.dataclass
class NodeMetricCollectPolicy:
    """Reference: slov1alpha1.NodeMetricCollectPolicy."""

    aggregate_duration_seconds: int
    report_interval_seconds: int
    #: aggregation durations for percentile stats (p50/p90/p95/p99)
    aggregate_durations: tuple = (300, 900, 1800)


def node_metric_collect_policy(
    strategy: ColocationStrategy,
) -> Optional[NodeMetricCollectPolicy]:
    """Reference: getNodeMetricCollectPolicy (collect_policy.go:28-48):
    None when the strategy is invalid or colocation disabled."""
    if not strategy.is_valid() or not strategy.enable:
        return None
    return NodeMetricCollectPolicy(
        aggregate_duration_seconds=strategy.metric_aggregate_duration_seconds,
        report_interval_seconds=strategy.metric_report_interval_seconds,
    )


def reconcile_collect_policies(
    config: ColocationConfig, node_labels: Dict[str, Dict[str, str]]
) -> Dict[str, Optional[NodeMetricCollectPolicy]]:
    """Per-node policies, honoring node-selector strategy overrides."""
    return {
        name: node_metric_collect_policy(config.strategy_for_node(labels))
        for name, labels in node_labels.items()
    }
