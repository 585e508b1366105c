"""NodeResourcesFit: the fit filter and LeastAllocated score over ``[N, R]``
(counterpart of ``koordinator_tpu/ops/fit.py``)."""

from __future__ import annotations

import torch

from koordinator_tpu_torch.ops.common import (
    least_requested_score,
    weighted_mean_scores,
)


def fit_filter(
    pod_req: torch.Tensor,     # [R] int32
    node_alloc: torch.Tensor,  # [N,R] int32
    node_used: torch.Tensor,   # [N,R] int32
) -> torch.Tensor:
    """``[N]`` bool: the node has room for every resource the pod
    requests (a zero request imposes no constraint)."""
    fits = (pod_req == 0) | (node_used + pod_req <= node_alloc)
    return fits.all(dim=-1)


def least_allocated_score(
    pod_req: torch.Tensor,     # [R]
    node_alloc: torch.Tensor,  # [N,R]
    node_used: torch.Tensor,   # [N,R]
    weights: torch.Tensor,     # [R]
) -> torch.Tensor:
    """``[N]`` LeastAllocated score in 0..100 over requests."""
    per_resource = least_requested_score(node_used + pod_req, node_alloc)
    return weighted_mean_scores(per_resource, weights)
