"""LoadAware filter and score over ``[N, R]`` (counterpart of
``koordinator_tpu/ops/loadaware.py``; reference semantics
pkg/scheduler/plugins/loadaware/load_aware.go)."""

from __future__ import annotations

import torch

from koordinator_tpu_torch.ops.common import (
    least_requested_score,
    percent_rounded,
    weighted_mean_scores,
)


def loadaware_filter(
    node_alloc: torch.Tensor,       # [N,R] int32
    node_usage: torch.Tensor,       # [N,R] int32
    prod_usage: torch.Tensor,       # [N,R] int32
    metric_fresh: torch.Tensor,     # [N] bool
    thresholds: torch.Tensor,       # [R] int32, 0 = not thresholded
    prod_thresholds: torch.Tensor,  # [R] int32, all zero = prod mode off
    pod_is_daemonset: torch.Tensor,  # [] bool
    pod_is_prod: torch.Tensor,       # [] bool
) -> torch.Tensor:
    """``[N]`` bool: nodes that pass the LoadAware filter. DaemonSet pods
    and nodes without a fresh metric always pass."""
    usage_pct = percent_rounded(node_usage, node_alloc)
    prod_pct = percent_rounded(prod_usage, node_alloc)
    checkable = node_alloc > 0
    over = checkable & (thresholds > 0) & (usage_pct >= thresholds)
    over_prod = checkable & (prod_thresholds > 0) & (prod_pct >= prod_thresholds)
    prod_mode = pod_is_prod & (prod_thresholds > 0).any()
    violated = torch.where(prod_mode, over_prod.any(dim=-1), over.any(dim=-1))
    return pod_is_daemonset | ~metric_fresh | ~violated


def loadaware_score(
    pod_est: torch.Tensor,       # [R] int32
    node_alloc: torch.Tensor,    # [N,R]
    node_usage: torch.Tensor,    # [N,R]
    est_extra: torch.Tensor,     # [N,R]
    prod_base: torch.Tensor,     # [N,R]
    metric_fresh: torch.Tensor,  # [N] bool
    weights: torch.Tensor,       # [R]
    pod_is_prod: torch.Tensor,   # [] bool
    score_according_prod: bool = False,
) -> torch.Tensor:
    """``[N]`` LoadAware score in 0..100; nodes without a fresh metric
    score 0. The base is ``usage + est_extra``, or ``prod_base`` for a
    prod pod when ``score_according_prod`` is set."""
    base = node_usage + est_extra
    if score_according_prod:
        base = torch.where(pod_is_prod, prod_base, base)
    per_resource = least_requested_score(base + pod_est, node_alloc)
    score = weighted_mean_scores(per_resource, weights)
    return torch.where(metric_fresh, score, torch.zeros_like(score))
