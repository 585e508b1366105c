"""The colocation overcommit calculator: batch and mid resources
(counterpart of ``koordinator_tpu/ops/overcommit.py``).

The reference computes the whole cluster in one fused XLA program outside
any Pallas kernel; here it is a handful of torch ops on the inputs'
device. Pod-level contributions are reduced onto their nodes with an
int32 ``index_add_`` (the reference's ``segment_sum``; integer atomics
are order-free, so the sums are deterministic), then the per-node policy
arithmetic runs elementwise over the ``[N, R]`` capacity matrix.

Formulas (reference util.go:40-53):

  by_usage   = max(cap - margin - max(sys, reserved) - hp_used, 0)
  by_request = max(cap - margin - reserved            - hp_req, 0)
  by_max     = max(cap - margin - max(sys, reserved) - hp_max_used_req, 0)

with ``margin = cap * (100 - reclaim_percent) / 100`` and the per-pod
High-Priority (not batch or free) contributions:

  no metric reported  -> used += req,            max_used_req += req
  QoS LSE             -> used += (req.cpu, use.mem), max_used_req += max(req, use)
  otherwise           -> used += use,            max_used_req += max(req, use)

Dangling pods (in a NodeMetric but not in the pod list) are rows with
``req = 0, has_metric = True``. A stale NodeMetric degrades the node's
batch and mid resources to zero (a mask).

Every tensor is int32 (bool for masks) in canonical units (mCPU / MiB),
and every operation keeps int32: no ``torch.zeros``/``torch.full`` without
a dtype, no reduction that widens.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from koordinator_tpu_torch.apis.extension import NUM_RESOURCES, ResourceName
from koordinator_tpu_torch.ops.common import I32, mul_percent_floor, percent_exceeds


class CalculatePolicy:
    """Batch-resource calculate policies (reference:
    apis/configuration/slo_controller_config.go CalculatePolicy)."""

    USAGE = 0
    REQUEST = 1
    MAX_USAGE_REQUEST = 2


class OvercommitParams(NamedTuple):
    """Strategy knobs; each field is cluster-wide (``[R]`` or a scalar)
    or per node (``[N, R]`` or ``[N]``), all int32."""

    #: reclaim-threshold percent per resource column; the safety margin
    #: is cap * (100 - p) / 100
    reclaim_percent: torch.Tensor
    #: mid-resource threshold percent of node allocatable
    mid_threshold_percent: torch.Tensor
    #: CalculatePolicy for batch CPU
    cpu_policy: torch.Tensor
    #: CalculatePolicy for batch memory
    memory_policy: torch.Tensor


class NodeOvercommitInputs(NamedTuple):
    """Per-node inputs, ``[N, R]`` int32 unless noted."""

    capacity: torch.Tensor          # node allocatable (native columns)
    system_used: torch.Tensor       # system usage less BE host apps
    reserved: torch.Tensor          # the node-reservation annotation
    prod_reclaimable: torch.Tensor  # predictor output (mid input)
    metric_fresh: torch.Tensor      # [N] bool; False degrades to zero


class PodOvercommitInputs(NamedTuple):
    """Per-pod inputs, ``[P, ...]``; inactive rows are masked out."""

    node_idx: torch.Tensor    # [P] int32 owning node, -1 for unbound
    req: torch.Tensor         # [P, R] int32 requests
    usage: torch.Tensor       # [P, R] int32 reported usage (0 if none)
    has_metric: torch.Tensor  # [P] bool
    is_hp: torch.Tensor       # [P] bool: priority class not batch/free
    is_lse: torch.Tensor      # [P] bool: QoS == LSE
    active: torch.Tensor      # [P] bool


def _segment_sum(rows: torch.Tensor, seg: torch.Tensor,
                 num_nodes: int) -> torch.Tensor:
    """``[N, R]`` int32 sums of ``rows`` by ``seg``; rows parked at
    ``num_nodes`` land in the extra row, which is sliced off."""
    out = torch.zeros((num_nodes + 1, rows.shape[1]), dtype=I32,
                      device=rows.device)
    out.index_add_(0, seg, rows)
    return out[:-1]


def hp_pod_contributions(pods: PodOvercommitInputs, num_nodes: int):
    """``(hp_req, hp_used, hp_max_used_req)``, each ``[N, R]`` int32:
    the HP pod rows summed onto their nodes."""
    counted = pods.active & pods.is_hp & (pods.node_idx >= 0)
    cm = counted[:, None]
    no_metric = ~pods.has_metric[:, None]

    req = torch.where(cm, pods.req, 0)
    usage = torch.where(cm, pods.usage, 0)
    max_used_req = torch.maximum(req, usage)

    # the used contribution by metric / QoS row (see the module docstring)
    lse_mix = usage.clone()
    lse_mix[:, ResourceName.CPU] = req[:, ResourceName.CPU]
    used = torch.where(no_metric, req,
                       torch.where(pods.is_lse[:, None], lse_mix, usage))
    used = torch.where(cm, used, 0)
    # without a metric, max(req, usage) is req, not max(req, stale zeros)
    max_used_req = torch.where(no_metric, req, max_used_req)
    max_used_req = torch.where(cm, max_used_req, 0)

    # masked rows are parked at row N
    seg = torch.where(counted, pods.node_idx,
                      torch.full_like(pods.node_idx, num_nodes)).long()
    return (_segment_sum(req, seg, num_nodes),
            _segment_sum(used, seg, num_nodes),
            _segment_sum(max_used_req, seg, num_nodes))


def _select_policy(policy, by_usage, by_request, by_max):
    return torch.where(
        policy == CalculatePolicy.MAX_USAGE_REQUEST,
        by_max,
        torch.where(policy == CalculatePolicy.REQUEST, by_request, by_usage),
    )


def batch_allocatable(nodes: NodeOvercommitInputs,
                      pods: PodOvercommitInputs,
                      params: OvercommitParams) -> torch.Tensor:
    """Batch-reclaimable allocatable per node: ``[N, R]`` int32 with only
    the BATCH_CPU and BATCH_MEMORY columns set."""
    num_nodes = nodes.capacity.shape[0]
    hp_req, hp_used, hp_max = hp_pod_contributions(pods, num_nodes)

    cap = nodes.capacity
    margin = mul_percent_floor(cap, 100 - params.reclaim_percent)
    sys_or_reserved = torch.maximum(nodes.system_used, nodes.reserved)

    base = cap - margin
    by_usage = torch.clamp(base - sys_or_reserved - hp_used, min=0)
    by_request = torch.clamp(base - nodes.reserved - hp_req, min=0)
    by_max = torch.clamp(base - sys_or_reserved - hp_max, min=0)

    cpu, mem = ResourceName.CPU, ResourceName.MEMORY
    batch_cpu = _select_policy(params.cpu_policy, by_usage[:, cpu],
                               by_request[:, cpu], by_max[:, cpu])
    batch_mem = _select_policy(params.memory_policy, by_usage[:, mem],
                               by_request[:, mem], by_max[:, mem])

    fresh = nodes.metric_fresh
    out = torch.zeros((num_nodes, NUM_RESOURCES), dtype=cap.dtype,
                      device=cap.device)
    out[:, ResourceName.BATCH_CPU] = torch.where(fresh, batch_cpu, 0)
    out[:, ResourceName.BATCH_MEMORY] = torch.where(fresh, batch_mem, 0)
    return out


def mid_allocatable(nodes: NodeOvercommitInputs,
                    params: OvercommitParams) -> torch.Tensor:
    """Mid-tier allocatable per node, ``min(allocatable * threshold%,
    prod_reclaimable)`` clamped at zero and degraded with the metric mask:
    ``[N, R]`` int32 with MID_CPU and MID_MEMORY set."""
    cap = nodes.capacity
    ceiling = mul_percent_floor(cap, params.mid_threshold_percent)
    mid = torch.clamp(torch.minimum(nodes.prod_reclaimable, ceiling), min=0)

    out = torch.zeros((cap.shape[0], NUM_RESOURCES), dtype=cap.dtype,
                      device=cap.device)
    for col, native in ((ResourceName.MID_CPU, ResourceName.CPU),
                        (ResourceName.MID_MEMORY, ResourceName.MEMORY)):
        out[:, col] = torch.where(nodes.metric_fresh, mid[:, native], 0)
    return out


def overcommit_allocatable(nodes: NodeOvercommitInputs,
                           pods: PodOvercommitInputs,
                           params: OvercommitParams) -> torch.Tensor:
    """The full overcommit pass: batch and mid columns in one ``[N, R]``."""
    return batch_allocatable(nodes, pods, params) + mid_allocatable(
        nodes, params)


def needs_sync(old_alloc: torch.Tensor, new_alloc: torch.Tensor,
               diff_threshold_percent) -> torch.Tensor:
    """Which nodes changed enough to write back, ``[N]`` bool:
    ``|new - old| > old * threshold`` on some resource (a zero old value
    makes any nonzero new one a diff). The threshold is in percent (an
    int32 scalar or per node ``[N]``)."""
    thr = torch.as_tensor(diff_threshold_percent, dtype=I32,
                          device=old_alloc.device)
    if thr.ndim == old_alloc.ndim - 1:
        thr = thr[..., None]
    diff = torch.abs(new_alloc - old_alloc)
    return percent_exceeds(diff, old_alloc, thr).any(dim=-1)
