"""Cluster SLO configuration, the colocation half (counterpart of
``koordinator_tpu/manager/sloconfig.py``: the colocation strategy, its
node-selector overrides and their merge; the NodeSLO strategies wait for
the nodeslo controller and the koordlet).

Plain dataclasses with the reference's default values (its ConfigMap
JSON payloads), merged per node as it merges them: the cluster strategy,
then the first matching node-selector strategy.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List

from koordinator_tpu_torch.apis.types import selector_matches


def merge_overrides(base, overrides: Dict):
    """Recursive JSON-merge-patch overlay: only keys present in
    ``overrides`` change, nested dicts recurse into nested dataclasses,
    unknown keys are ignored. Returns a new dataclass; ``base`` is not
    mutated."""
    out = copy.deepcopy(base)
    for key, value in overrides.items():
        if not hasattr(out, key):
            continue
        current = getattr(out, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            setattr(out, key, merge_overrides(current, value))
        else:
            setattr(out, key, value)
    return out


@dataclasses.dataclass
class ColocationStrategy:
    """The colocation strategy with the reference's defaults
    (pkg/util/sloconfig/colocation_config.go:50-75)."""

    enable: bool = False
    metric_aggregate_duration_seconds: int = 300
    metric_report_interval_seconds: int = 60
    cpu_reclaim_threshold_percent: int = 60
    memory_reclaim_threshold_percent: int = 65
    degrade_time_minutes: int = 15
    update_time_threshold_seconds: int = 300
    resource_diff_threshold: float = 0.1
    mid_cpu_threshold_percent: int = 100
    mid_memory_threshold_percent: int = 100
    # CalculatePolicy names: "usage" | "request" | "maxUsageRequest"
    cpu_calculate_policy: str = "usage"
    memory_calculate_policy: str = "usage"

    def is_valid(self) -> bool:
        """sloconfig.IsColocationStrategyValid (colocation_config.go:77-85)."""
        return (
            self.metric_aggregate_duration_seconds > 0
            and self.metric_report_interval_seconds > 0
            and 0 < self.cpu_reclaim_threshold_percent <= 100
            and 0 < self.memory_reclaim_threshold_percent <= 100
            and self.degrade_time_minutes > 0
            and self.update_time_threshold_seconds > 0
            and self.resource_diff_threshold > 0
        )

    @classmethod
    def from_dict(cls, d: Dict) -> "ColocationStrategy":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class NodeStrategySelector:
    """A node-scoped strategy override selected by labels; ``overrides``
    holds only the fields the override sets."""

    match_labels: Dict[str, str]
    overrides: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ColocationConfig:
    """The cluster strategy and its node overrides."""

    cluster_strategy: ColocationStrategy = dataclasses.field(
        default_factory=ColocationStrategy
    )
    node_strategies: List[NodeStrategySelector] = dataclasses.field(
        default_factory=list
    )

    def strategy_for_node(self, node_labels: Dict[str, str]) -> ColocationStrategy:
        """The cluster strategy overlaid with the first matching node
        strategy."""
        out = self.cluster_strategy
        for sel in self.node_strategies:
            if selector_matches(sel.match_labels, node_labels):
                out = merge_overrides(out, sel.overrides)
                break
        return out
