"""Shared int32 score math (counterpart of ``koordinator_tpu/ops/common.py``).

Every tensor here is int32 and every operation wraps exactly as the
reference's ``jnp`` int32 arithmetic does. Two torch habits would break
that and are avoided throughout the port: ``torch.sum`` of an int32
tensor returns int64 unless given ``dtype=torch.int32``, and
``torch.full``/``torch.tensor`` default to int64.

The reference divides through ``floor_div_exact`` (a float reciprocal
plus a one-step correction) because int32 division is slow on a TPU.
Within that function's documented domain it equals true floor division
of ``max(y, 0)``, which is what :func:`floor_div_exact` computes here.
"""

from __future__ import annotations

import torch

#: framework.MaxNodeScore in the k8s scheduler framework.
MAX_NODE_SCORE = 100

I32 = torch.int32


def floor_div_exact(y: torch.Tensor, divisor: torch.Tensor) -> torch.Tensor:
    """``floor(max(y, 0) / max(divisor, 1))`` in int32."""
    return torch.div(
        torch.clamp(y, min=0), torch.clamp(divisor, min=1), rounding_mode="floor"
    )


def percent_rounded(used: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """``round(used / total * 100)`` half away from zero, exactly:
    ``floor((200*used + total) / (2*total))``; 0 where ``total == 0``.
    ``200*used + total`` wraps in int32, as it does in the reference."""
    total_safe = torch.clamp(total, min=1)
    pct = torch.div(
        200 * used + total_safe, 2 * total_safe, rounding_mode="floor"
    )
    return torch.where(total > 0, pct, torch.zeros_like(pct))


def least_requested_score(
    requested: torch.Tensor, capacity: torch.Tensor
) -> torch.Tensor:
    """``(capacity - requested) * 100 / capacity``; 0 when capacity is 0
    or requested exceeds it (reference: load_aware.go:388-397)."""
    score = floor_div_exact((capacity - requested) * MAX_NODE_SCORE, capacity)
    bad = (capacity == 0) | (requested > capacity)
    return torch.where(bad, torch.zeros_like(score), score)


def weighted_mean_scores(scores: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``Σ_r score_r * w_r // max(Σ_r w_r, 1)`` along the last axis."""
    weight_sum = torch.clamp(weights.sum(dtype=I32), min=1)
    return torch.div(
        (scores * weights).sum(dim=-1, dtype=I32), weight_sum,
        rounding_mode="floor",
    )


def mul_percent_floor(x: torch.Tensor, pct) -> torch.Tensor:
    """``floor(x * pct / 100)`` without the ``x * pct`` intermediate, by
    the exact identity ``(x // 100) * pct + ((x % 100) * pct) // 100``
    (floor division and a non-negative remainder, as the reference's
    ``//`` and ``%``): safe in int32 for any non-negative ``x`` and
    ``pct <= ~100``, where a plain ``x * pct`` wraps for memory columns
    above ~21.4M MiB."""
    q = torch.div(x, 100, rounding_mode="floor")
    r = torch.remainder(x, 100)
    return q * pct + torch.div(r * pct, 100, rounding_mode="floor")


def percent_exceeds(diff: torch.Tensor, base: torch.Tensor,
                    pct) -> torch.Tensor:
    """Exact ``100 * diff > base * pct`` for non-negative int32 operands
    without either product: for an integer ``diff`` it equals
    ``diff > floor(base * pct / 100)``."""
    return diff > mul_percent_floor(base, pct)
