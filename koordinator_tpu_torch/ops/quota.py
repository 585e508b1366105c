"""Device-path elastic quota: water-filling and admission inside the solve
(counterpart of ``koordinator_tpu/ops/quota.py``).

Requests register with a quota when the pod is created, so within one
solve every group's request, and hence its water-filled runtime, is
constant: the runtime is computed once per solve and each pod's gate is
``used + req <= runtime``. The weighted share ``round(w * T / W)`` is
computed exactly in int32 as ``w*(T//W) + (2*w*(T%W) + W) // (2*W)``,
given weights normalized per dimension under ``WEIGHT_CAP`` and values
saturated at ``SATURATE`` (quota/core.py ``water_filling`` with
``exact_rational=True`` matches it bit for bit).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.ops.common import I32

#: Value saturation: 2^30 canonical units (sums of two still fit int32).
SATURATE = 1 << 30

#: Per-dimension normalized weight cap (Σw per resource ≤ this).
WEIGHT_CAP = (1 << 15) - 1


def normalize_weights(weights: np.ndarray) -> np.ndarray:
    """Scale each resource column whose weight sum exceeds ``WEIGHT_CAP``
    down under it; columns already under the cap are unchanged."""
    weights = np.minimum(np.asarray(weights, dtype=np.int64), SATURATE)
    sums = weights.sum(axis=0)
    out = weights.copy()
    for r in np.nonzero(sums > WEIGHT_CAP)[0]:
        out[:, r] = (weights[:, r] * WEIGHT_CAP) // sums[r]
    return out.astype(np.int32)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64).astype(np.int32),
                           device=device)


class QuotaState(NamedTuple):
    """Quota arrays of one solve, ``[Q, R]`` int32 (single-level tree, or
    any tree when ``runtime`` is precomputed on the host)."""

    min: torch.Tensor            # [Q,R]
    max: torch.Tensor            # [Q,R] saturated
    auto_min: torch.Tensor       # [Q,R] max(min, guarantee)
    weight: torch.Tensor         # [Q,R] normalized shared weights
    allow_lent: torch.Tensor     # [Q] bool
    child_request: torch.Tensor  # [Q,R] Σ pod requests (pending + assigned)
    used: torch.Tensor           # [Q,R] updated by the solve
    np_used: torch.Tensor        # [Q,R] non-preemptible used
    total: torch.Tensor          # [R]
    #: precomputed masked runtime [Q,R]; None = water-fill in the solve
    runtime: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, min, max, weight, allow_lent, total, guarantee=None,
              child_request=None, used=None, np_used=None, runtime=None,
              device: DeviceLike = None) -> "QuotaState":
        """Host-side constructor applying the saturation and weight
        normalization the int32 arithmetic depends on; on ``cuda`` unless
        ``device`` is given."""
        device = resolve_device(device)
        mn = np.minimum(np.asarray(min, dtype=np.int64), SATURATE)
        mx = np.minimum(np.asarray(max, dtype=np.int64), SATURATE)
        guar = (
            np.minimum(np.asarray(guarantee, dtype=np.int64), SATURATE)
            if guarantee is not None else np.zeros_like(mn)
        )
        zeros = np.zeros_like(mn)
        creq = np.minimum(np.asarray(
            child_request if child_request is not None else zeros,
            dtype=np.int64), SATURATE)
        return cls(
            min=_i32(mn, device),
            max=_i32(mx, device),
            auto_min=_i32(np.maximum(mn, guar), device),
            weight=torch.as_tensor(normalize_weights(weight), device=device),
            allow_lent=torch.as_tensor(np.asarray(allow_lent, dtype=bool),
                                       device=device),
            child_request=_i32(creq, device),
            used=_i32(used if used is not None else zeros, device),
            np_used=_i32(np_used if np_used is not None else zeros, device),
            total=_i32(np.minimum(np.asarray(total, dtype=np.int64), SATURATE),
                       device),
            runtime=(
                None if runtime is None else _i32(
                    np.minimum(np.asarray(runtime, dtype=np.int64), SATURATE),
                    device)
            ),
        )


def limited_request(state: QuotaState) -> torch.Tensor:
    """``[Q,R]`` child request floored at min for non-lent groups,
    capped at max (quota_info.go:217-228)."""
    real = torch.where(
        state.allow_lent[:, None],
        state.child_request,
        torch.maximum(state.child_request, state.min),
    )
    return torch.minimum(real, state.max)


def _exact_share(weight, remaining, total_w) -> torch.Tensor:
    """``round_half_up(weight * remaining / total_w)`` in int32."""
    w_safe = torch.clamp(total_w, min=1)
    t_div = torch.div(remaining, w_safe, rounding_mode="floor")
    t_rem = remaining - t_div * w_safe
    frac = torch.div(2 * weight * t_rem[None, :] + w_safe[None, :],
                     2 * w_safe[None, :], rounding_mode="floor")
    share = weight * t_div[None, :] + frac
    return torch.where(total_w[None, :] > 0, share, torch.zeros_like(share))


def water_filling_device(total, request, auto_min, weight, allow_lent):
    """``[Q,R]`` runtime: the reference redistribution over every resource
    dimension at once (the reference's ``lax.while_loop`` as a loop)."""
    zero = torch.zeros_like(request)
    adjustable = request > auto_min
    runtime = torch.where(
        adjustable, auto_min,
        torch.where(allow_lent[:, None], request, auto_min),
    )
    remaining = total - runtime.sum(dim=0, dtype=I32)
    total_w = torch.where(adjustable, weight, zero).sum(dim=0, dtype=I32)
    while bool(((remaining > 0) & (total_w > 0) & adjustable.any(dim=0)).any()):
        active = (remaining > 0) & (total_w > 0)
        delta = torch.where(
            adjustable & active[None, :],
            _exact_share(weight, torch.clamp(remaining, min=0), total_w),
            zero,
        )
        grown = runtime + delta
        saturated = adjustable & (grown >= request)
        surplus = torch.where(saturated, grown - request, zero).sum(
            dim=0, dtype=I32)
        runtime = torch.where(adjustable, torch.minimum(grown, request), runtime)
        adjustable = adjustable & (runtime < request)
        total_w = torch.where(adjustable, weight, zero).sum(dim=0, dtype=I32)
        remaining = torch.where(active, surplus, remaining)
    return runtime


def quota_runtime(state: QuotaState) -> torch.Tensor:
    """``[Q,R]`` masked runtime: the precomputed tree runtime when given,
    else the single-level water-filling capped at max."""
    if state.runtime is not None:
        return state.runtime
    runtime = water_filling_device(
        state.total, limited_request(state), state.auto_min, state.weight,
        state.allow_lent,
    )
    return torch.minimum(runtime, state.max)


def quota_admit(state: QuotaState, runtime, quota_id, pod_req,
                non_preemptible) -> torch.Tensor:
    """``[]`` bool: ``used + req <= runtime`` on the requested dims, and for
    a non-preemptible pod also ``np_used + req <= min``."""
    q = torch.clamp(quota_id, min=0).reshape(1).long()

    def row(a):
        return a.index_select(0, q)[0]

    dims = pod_req > 0
    ok = (~dims | (row(state.used) + pod_req <= row(runtime))).all()
    np_ok = (~(dims & non_preemptible)
             | (row(state.np_used) + pod_req <= row(state.min))).all()
    return (quota_id < 0) | (ok & np_ok)


def quota_assume(state: QuotaState, quota_id, pod_req, non_preemptible,
                 placed) -> QuotaState:
    """Account a placed pod's request into its group's used (and
    non-preemptible used)."""
    take = placed & (quota_id >= 0)
    q = torch.clamp(quota_id, min=0).reshape(1).long()
    add = torch.where(take, pod_req, torch.zeros_like(pod_req))[None, :]
    np_add = torch.where(non_preemptible, add, torch.zeros_like(add))
    return state._replace(
        used=state.used.index_add(0, q, add),
        np_used=state.np_used.index_add(0, q, np_add),
    )
