"""Node-utilization classification and the LowNodeLoad balance sweep
(counterpart of ``koordinator_tpu/ops/rebalance.py``).

Semantics oracle: pkg/descheduler/framework/plugins/loadaware/
{low_node_load.go:286-326, utilization_util.go getNodeThresholds /
isNodeOverutilized / isNodeUnderutilized / calcAverageResourceUsagePercent,
newThresholds}.

Two host stages, numpy in float64 and int64, as in the reference:

- :func:`threshold_quantities` resolves percent thresholds into absolute
  quantities as ``int64(float64(pct) * 0.01 * float64(capacity))``, float
  rounding included (29% of 100,000 truncates to 28,999). Integer ``pct *
  cap // 100`` is not equivalent, and float32 is not either. It also
  resolves the participating resource set: the union of the low and high
  threshold names plus memory, always.
- :func:`classify_nodes` compares usage against the resolved quantities:
  *underutilized* iff usage <= low_q on every participating resource,
  *overutilized* iff usage > high_q on any.

The eviction sweep (low_node_load.go balanceNodes ->
evictPodsFromSourceNodes) walks abnormal nodes in score order and pods in
sort-key order, stopping per node when it drops below its high threshold
and globally when the low nodes' headroom is exhausted. The host orders
the candidates (``descheduler/loadaware.py``); the walk itself runs over
the flattened list with the carry ``(available [R], cur [R])``:

    per candidate: cur      = where(node_start, usage0, cur)
                   over     = any((cur > high_q) & res_mask)
                   avail_ok = !any((available <= 0) & res_mask)
                   propose  = valid & over & avail_ok & !blocked
                   subtract the masked metric from both on propose

The reference writes it as a ``lax.scan``. Here :func:`balance_sweep`
launches the hand-written kernel ``csrc/rebalance_sweep.cu`` for CUDA
tensors and runs its plain version :func:`_balance_sweep` (a Python loop
of torch ops) for CPU tensors; nothing else selects between them. The
walk is strictly serial in the candidates, so the kernel is one warp: a
loop of torch ops would pay a few launches per candidate, again on every
re-scan after an evictor refusal.

All quantities are host int64 until staged; :func:`validate_sweep` checks
that every value and every reachable endpoint (available minus all masked
metrics, per-node usage minus that node's metrics) fits int32 and raises
``ValueError`` otherwise, so the int32 carry never wraps.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.apis.extension import NUM_RESOURCES, ResourceName
from koordinator_tpu_torch.ops import binpack_kernel as bk

I32 = torch.int32

#: sweep kernel launches since import: one per launch on CUDA tensors,
#: the count that shows a run went through the kernel
LAUNCHES = {"rebalance_sweep": 0}


class RebalanceVerdict(NamedTuple):
    low: np.ndarray          # [N] bool: underutilized
    high: np.ndarray         # [N] bool: overutilized
    over_resource: np.ndarray  # [N, R] bool: which resources are over
    low_quantity: np.ndarray   # [N, R] i64 resolved low threshold quantities
    high_quantity: np.ndarray  # [N, R] i64 resolved high threshold quantities


def threshold_quantities(
    usage: np.ndarray,        # [N, R] int
    alloc: np.ndarray,        # [N, R] int capacity/allocatable
    low_percent: np.ndarray,  # [R] int, -1 = unset
    high_percent: np.ndarray,  # [R] int, -1 = unset
    active: np.ndarray,       # [N] bool (nodes with fresh metrics)
    use_deviation: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resolve ``(low_q, high_q, resource_mask)`` exactly as the
    reference. ``resource_mask[r]`` is True iff r participates at all:
    thresholded on either side, or memory (always appended by
    newThresholds). Non-participating resources get quantity = capacity,
    so any compare downstream is inert."""
    alloc = np.asarray(alloc, dtype=np.int64)
    usage = np.asarray(usage, dtype=np.int64)
    low_percent = np.asarray(low_percent, dtype=np.int64)
    high_percent = np.asarray(high_percent, dtype=np.int64)
    mask = (low_percent >= 0) | (high_percent >= 0)
    mask[int(ResourceName.MEMORY)] = True

    # missing names fill with MaxResourcePercentage (100), or with
    # MinResourcePercentage (0) in deviation mode, where the 0 fill is
    # special-cased to full capacity (getNodeThresholds:100-102)
    fill = 0.0 if use_deviation else 100.0
    low_p = np.where(low_percent >= 0, low_percent, fill).astype(np.float64)
    high_p = np.where(high_percent >= 0, high_percent, fill).astype(np.float64)

    if use_deviation:
        # calcAverageResourceUsagePercent: float percent per (node,
        # resource) over nodes with usable metrics, zero-capacity
        # resources skipped, averaged over that node count
        n_active = max(int(np.asarray(active).sum()), 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = np.where(
                alloc > 0, usage.astype(np.float64) / alloc * 100.0, 0.0
            )
        avg = (pct * np.asarray(active, dtype=np.float64)[:, None]).sum(
            axis=0
        ) / n_active
        dev_low = np.clip(avg - low_p, 0.0, 100.0)
        dev_high = np.clip(avg + high_p, 0.0, 100.0)
        # the reference's quirk, kept (getNodeThresholds:100-102): the
        # full-capacity special case keys BOTH sides off the LOW percent
        # being MinResourcePercentage. With only a high threshold set
        # (low filled to 0) both resolve to capacity; with only a low
        # threshold set the high side resolves to avg + 0
        low_q = np.where(
            low_p == 0.0, alloc,
            (dev_low[None, :] * 0.01 * alloc.astype(np.float64)).astype(
                np.int64
            ),
        )
        high_q = np.where(
            low_p == 0.0, alloc,
            (dev_high[None, :] * 0.01 * alloc.astype(np.float64)).astype(
                np.int64
            ),
        )
    else:
        # q = int64(float64(pct) * 0.01 * float64(cap)): float on purpose
        low_q = (low_p[None, :] * 0.01 * alloc.astype(np.float64)).astype(
            np.int64
        )
        high_q = (high_p[None, :] * 0.01 * alloc.astype(np.float64)).astype(
            np.int64
        )
    low_q = np.where(mask[None, :], low_q, alloc)
    high_q = np.where(mask[None, :], high_q, alloc)
    return low_q, high_q, mask


def classify_nodes(
    usage,          # [N, R] int
    low_q,          # [N, R] int resolved low quantities
    high_q,         # [N, R] int resolved high quantities
    resource_mask,  # [R] bool: participates in classification
    active,         # [N] bool: pool nodes with a fresh metric
    schedulable,    # [N] bool: unschedulable nodes can't be "low"
) -> RebalanceVerdict:
    usage = np.asarray(usage, dtype=np.int64)
    low_q = np.asarray(low_q, dtype=np.int64)
    high_q = np.asarray(high_q, dtype=np.int64)
    resource_mask = np.asarray(resource_mask, bool)
    active = np.asarray(active, bool)
    schedulable = np.asarray(schedulable, bool)

    under_each = (usage <= low_q) | ~resource_mask[None, :]
    over_each = (usage > high_q) & resource_mask[None, :]

    low = under_each.all(axis=1) & active & schedulable
    high = over_each.any(axis=1) & active
    return RebalanceVerdict(low, high, over_each, low_q, high_q)


def sweep_candidate_bucket(n: int) -> int:
    """The reference's padded candidate count (a power of two, at least
    8), kept for API parity: the port never pads."""
    n = int(n)
    return max(8, 1 << max(n - 1, 0).bit_length())


class SweepBatch(NamedTuple):
    """The flattened candidate list in host order (node score order, pod
    sort-key order within a node): numpy int64/bool on the host, int32
    and bool tensors once staged (:func:`stage_sweep_batch`)."""

    node_start: np.ndarray  # [K] bool: candidate i is its node's first
    usage0: np.ndarray      # [K, R] int: owning node's usage at entry
    high_q: np.ndarray      # [K, R] int: owning node's high quantities
    metric: np.ndarray      # [K, R] int: pod usage (0 where unknown)
    has_metric: np.ndarray  # [K] bool: pod usage is known
    valid: np.ndarray       # [K] bool: real row


_I32_MIN = np.iinfo(np.int32).min
_I32_MAX = np.iinfo(np.int32).max


def _require_i32(name: str, arr: np.ndarray) -> None:
    arr = np.asarray(arr)
    if arr.size and (
        int(arr.min()) < _I32_MIN or int(arr.max()) > _I32_MAX
    ):
        raise ValueError(
            f"rebalance sweep {name} exceeds the int32 device domain "
            f"[{int(arr.min())}, {int(arr.max())}]: quantities must be "
            "staged in device units that fit int32"
        )


def validate_sweep(batch: SweepBatch, available: np.ndarray,
                   res_mask: np.ndarray) -> None:
    """The reference's endpoint validation: every staged value, the
    furthest the headroom can travel (all masked metrics subtracted) and
    each node's usage less that node's metrics fit int32, and a
    non-empty batch opens with a ``node_start`` candidate. Raises
    ``ValueError`` in the reference's order."""
    available = np.asarray(available, dtype=np.int64)
    res_mask = np.asarray(res_mask, bool)
    masked = np.where(res_mask[None, :], batch.metric, 0).astype(np.int64)
    _require_i32("usage", batch.usage0)
    _require_i32("high quantities", batch.high_q)
    _require_i32("pod metrics", batch.metric)
    _require_i32("available headroom", available)
    _require_i32("available endpoint", available - masked.sum(axis=0))
    if int(batch.valid.shape[0]):
        if not batch.node_start[0]:
            raise ValueError(
                "sweep batch must open with a node_start candidate"
            )
        group = np.cumsum(np.asarray(batch.node_start, bool)) - 1
        starts = np.flatnonzero(batch.node_start)
        node_total = np.zeros((starts.size, masked.shape[1]), dtype=np.int64)
        np.add.at(node_total, group, masked)
        _require_i32(
            "usage endpoint",
            batch.usage0[starts].astype(np.int64) - node_total,
        )


def stage_sweep_batch(batch: SweepBatch, device: DeviceLike = None
                      ) -> SweepBatch:
    """The batch as int32 and bool tensors on ``device`` (copies; ``cuda``
    unless the caller passes one). Values outside int32 raise."""
    device = resolve_device(device)

    def ints(name, a):
        _require_i32(name, a)
        return torch.tensor(np.asarray(a, dtype=np.int32).reshape(
            -1, NUM_RESOURCES), dtype=I32, device=device)

    def flags(a):
        return torch.tensor(np.asarray(a, dtype=bool), dtype=torch.bool,
                            device=device)

    return SweepBatch(
        node_start=flags(batch.node_start),
        usage0=ints("usage", batch.usage0),
        high_q=ints("high quantities", batch.high_q),
        metric=ints("pod metrics", batch.metric),
        has_metric=flags(batch.has_metric),
        valid=flags(batch.valid),
    )


def _balance_sweep(node_start, usage0, high_q, metric, has_metric, valid,
                   blocked, available0, res_mask):
    """The plain version: the reference's scan step as a loop of torch
    ops over the candidates. Returns ``(streams [3, K] bool: propose,
    over, avail_ok; available [R] int32)``."""
    avail = available0.clone()
    cur = torch.zeros_like(available0)
    zero = torch.zeros_like(available0)
    rows = []
    for i in range(int(valid.shape[0])):
        cur = torch.where(node_start[i], usage0[i], cur)
        over = ((cur > high_q[i]) & res_mask).any()
        avail_ok = ~((avail <= 0) & res_mask).any()
        propose = valid[i] & over & avail_ok & ~blocked[i]
        sub = torch.where(propose & has_metric[i] & res_mask, metric[i], zero)
        avail = avail - sub
        cur = cur - sub
        rows.append(torch.stack((propose, over, avail_ok)))
    if not rows:
        return torch.zeros((3, 0), dtype=torch.bool,
                           device=available0.device), avail
    return torch.stack(rows, dim=1), avail


def _launch(batch: SweepBatch, blocked, available, res_mask):
    dev = batch.usage0.device
    k = int(batch.valid.shape[0])
    R = NUM_RESOURCES
    for name, t, shape, dtype in (
            ("node_start", batch.node_start, (k,), torch.bool),
            ("usage0", batch.usage0, (k, R), I32),
            ("high_q", batch.high_q, (k, R), I32),
            ("metric", batch.metric, (k, R), I32),
            ("has_metric", batch.has_metric, (k,), torch.bool),
            ("valid", batch.valid, (k,), torch.bool),
            ("blocked", blocked, (k,), torch.bool),
            ("available", available, (R,), I32),
            ("res_mask", res_mask, (R,), torch.bool)):
        bk._check(name, t, shape, dev, dtype)
    lib = bk._library()
    streams = torch.empty((3, k), dtype=torch.bool, device=dev)
    out = torch.empty(R, dtype=I32, device=dev)
    base = streams.data_ptr()
    rc = bk._on_device(dev, lambda stream: lib.rebalance_sweep_launch(
        batch.node_start.data_ptr(), batch.usage0.data_ptr(),
        batch.high_q.data_ptr(), batch.metric.data_ptr(),
        batch.has_metric.data_ptr(), batch.valid.data_ptr(),
        blocked.data_ptr(), available.data_ptr(), res_mask.data_ptr(), k,
        base, base + k, base + 2 * k, out.data_ptr(), stream))
    if rc != 0:
        raise bk._cuda_error(lib, "rebalance sweep kernel launch", rc)
    LAUNCHES["rebalance_sweep"] += 1
    return streams, out


def balance_sweep(batch: SweepBatch, blocked: torch.Tensor,
                  available: torch.Tensor, res_mask: torch.Tensor):
    """The sweep over a staged batch: ``(streams [3, K] bool: propose,
    over, avail_ok; available [R] int32 after the walk)``. The kernel for
    CUDA tensors, :func:`_balance_sweep` for CPU tensors. A build or
    launch failure raises."""
    dev = batch.usage0.device
    if dev.type == "cuda":
        return _launch(batch, blocked, available, res_mask)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return _balance_sweep(*batch, blocked, available, res_mask)


class DeviceSweep:
    """One staged sweep: the batch validated and staged once, then
    :meth:`run` per blocked mask (the refusal fixpoint re-runs the walk
    after every evictor refusal; only the blocked bytes are copied
    again). The reference re-stages every input on each re-scan; the
    results are the same."""

    def __init__(self, batch: SweepBatch, available, res_mask,
                 device: DeviceLike = None):
        validate_sweep(batch, available, res_mask)
        self.device = resolve_device(device)
        self.k = int(batch.valid.shape[0])
        self.batch = stage_sweep_batch(batch, self.device)
        self.available = torch.tensor(
            np.asarray(available, dtype=np.int64).astype(np.int32),
            dtype=I32, device=self.device)
        self.res_mask = torch.tensor(np.asarray(res_mask, bool),
                                     dtype=torch.bool, device=self.device)

    def run(self, blocked) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host ``(propose, over, avail_ok)`` for this blocked mask."""
        blocked = torch.tensor(np.asarray(blocked, bool), dtype=torch.bool,
                               device=self.device)
        streams, _ = balance_sweep(self.batch, blocked, self.available,
                                   self.res_mask)
        host = streams.cpu().numpy()
        return host[0], host[1], host[2]


def run_balance_sweep(
    batch: SweepBatch,
    available: np.ndarray,   # [R] i64: absorbing headroom on low nodes
    res_mask: np.ndarray,    # [R] bool: participating resources
    blocked: np.ndarray,     # [K] bool: refused candidates (masked out)
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Validate, stage and run the sweep on ``device`` (``cuda`` unless
    the caller passes one); return host ``(propose, over, avail_ok)``."""
    return DeviceSweep(batch, available, res_mask, device).run(blocked)


def replay_sweep_host(
    batch: SweepBatch,
    available: np.ndarray,
    res_mask: np.ndarray,
    blocked: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pure-numpy replica of the walk over the same candidates: the
    verify backend's second opinion."""
    res_mask = np.asarray(res_mask, bool)
    avail = np.asarray(available, dtype=np.int64).copy()
    cur = np.zeros_like(avail)
    k = int(batch.valid.shape[0])
    propose = np.zeros(k, bool)
    over_s = np.zeros(k, bool)
    ok_s = np.zeros(k, bool)
    for i in range(k):
        if batch.node_start[i]:
            cur = batch.usage0[i].astype(np.int64).copy()
        over = bool(((cur > batch.high_q[i]) & res_mask).any())
        avail_ok = not bool(((avail <= 0) & res_mask).any())
        p = bool(batch.valid[i]) and over and avail_ok and not bool(
            blocked[i]
        )
        if p and batch.has_metric[i]:
            sub = np.where(res_mask, batch.metric[i], 0).astype(np.int64)
            avail -= sub
            cur -= sub
        propose[i], over_s[i], ok_s[i] = p, over, avail_ok
    return propose, over_s, ok_s

