"""Gang (coscheduling) all-or-nothing admission at batch end (counterpart
of ``koordinator_tpu/ops/gang.py``).

The placement loop places gang members one by one, holding resources as
pods waiting at Permit do; after it, each gang group is decided at once:
a group where every gang reaches its min commits; otherwise Strict gangs
are rejected (their holds released) and NonStrict gangs keep waiting.

``jax.ops.segment_sum`` drops out-of-range indices; here the same
effect comes from ``index_add_`` into an ``n + 1`` buffer whose last row
collects the "no segment" entries and is dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.ops.common import I32


class GangState(NamedTuple):
    """Gang metadata of one solve, ``[G]`` tensors."""

    min_member: torch.Tensor   # [G] int32
    bound_count: torch.Tensor  # [G] int32 members bound before this solve
    strict: torch.Tensor       # [G] bool
    group_id: torch.Tensor     # [G] int32, dense in [0, G)

    @classmethod
    def build(cls, min_member, bound_count=None, strict=None, group_id=None,
              device: DeviceLike = None) -> "GangState":
        """On ``cuda`` unless ``device`` is given."""
        device = resolve_device(device)
        g = len(min_member)
        if group_id is None:
            gid = np.arange(g, dtype=np.int32)
        else:
            # densify arbitrary group labels into [0, G)
            _, gid = np.unique(np.asarray(group_id), return_inverse=True)
            gid = gid.astype(np.int32)
        return cls(
            min_member=torch.as_tensor(np.asarray(min_member, np.int32),
                                       device=device),
            bound_count=torch.as_tensor(np.asarray(
                bound_count if bound_count is not None else np.zeros(g),
                np.int32), device=device),
            strict=torch.as_tensor(np.asarray(
                strict if strict is not None else np.ones(g), bool),
                device=device),
            group_id=torch.as_tensor(gid, device=device),
        )


def segment_sum(data: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``Σ data[i]`` into segment ``idx[i]`` for ``idx`` in ``[0, n]``;
    segment ``n`` is the drop bucket and is cut off."""
    out = torch.zeros((n + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, idx, data)[:n]


def gang_outcomes(assignments, gang_id, gangs: GangState) -> tuple:
    """``(commit[P], waiting[P], rejected[P])`` bool."""
    g = gangs.min_member.shape[0]
    placed = assignments >= 0
    gid = torch.clamp(gang_id, min=0).long()
    member_placed = placed & (gang_id >= 0)
    placed_per_gang = segment_sum(member_placed.to(I32), gid, g)
    valid = (placed_per_gang + gangs.bound_count) >= gangs.min_member
    group_invalid = segment_sum((~valid).to(I32), gangs.group_id.long(), g)
    gang_ok = group_invalid[gangs.group_id.long()] == 0
    pod_gang_ok = gang_ok[gid]
    strict = gangs.strict[gid]
    commit = placed & ((gang_id < 0) | pod_gang_ok)
    waiting = member_placed & ~pod_gang_ok & ~strict
    rejected = member_placed & ~pod_gang_ok & strict
    return commit, waiting, rejected


def release_rejected(node_used_req, node_est_extra, node_prod_base,
                     assignments, rejected, req, est, is_prod) -> tuple:
    """Subtract the rejected pods' requests and estimates from the nodes
    that hold them (the batched Unreserve)."""
    n = node_used_req.shape[0]
    idx = torch.where(rejected, assignments, torch.full_like(assignments, n))
    zero = torch.zeros_like(req)
    rel_req = torch.where(rejected[:, None], req, zero)
    rel_est = torch.where(rejected[:, None], est, zero)
    rel_prod = torch.where((rejected & is_prod)[:, None], est, zero)
    idx = idx.long()
    return (
        node_used_req - segment_sum(rel_req, idx, n),
        node_est_extra - segment_sum(rel_est, idx, n),
        node_prod_base - segment_sum(rel_prod, idx, n),
    )
