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
launches a hand-written kernel of ``csrc/rebalance_sweep.cu`` for CUDA
tensors and runs its plain version :func:`_balance_sweep` (a Python loop
of torch ops) for CPU tensors; nothing else selects between them. The
kernel is chosen from the batch before the launch (:func:`sweep_route`):

- "scan" (``rebalance_scan_launch``): the walk as prefix sums and
  first-index searches, one CTA of 512 threads, each walking a few
  consecutive candidates, over tiles of up to 4,096. It is exact when
  every run of candidates between two node starts carries one ``high_q``
  row, as every batch ``LowNodeLoad`` builds does: a candidate that is
  not proposed changes nothing, so once ``avail_ok`` is false it stays
  false, and once ``over`` is false on a node it stays false there. :func:`_scan_tiled` is its CPU emulation,
  tile size a parameter (the tests hold it against the reference).
- "serial" (``rebalance_sweep_launch``): one warp walks the candidates in
  order, exact for any batch.

All quantities are host int64 until staged; :func:`validate_sweep` checks
that every value and every reachable endpoint (available minus all masked
metrics, per-node usage minus that node's metrics) fits int32 and raises
``ValueError`` otherwise, so the int32 carry never wraps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.apis.extension import NUM_RESOURCES, ResourceName
from koordinator_tpu_torch.ops import binpack_kernel as bk

I32 = torch.int32

#: sweep kernel launches since import, by kernel: "rebalance_scan" (the
#: parallel walk) and "rebalance_sweep" (the one-warp walk); one per
#: launch on CUDA tensors, the count that shows a run went through them
LAUNCHES = {"rebalance_scan": 0, "rebalance_sweep": 0}
#: the kernel of each route, as its launch count's name
ROUTE_KERNELS = {"scan": "rebalance_scan", "serial": "rebalance_sweep"}
#: threads of the scan kernel's one CTA
SCAN_THREADS = 512


def scan_tile(n_columns: int) -> int:
    """Candidates per tile of the scan kernel with ``n_columns``
    participating resources: 512 threads x 8, 4 or 2 candidates."""
    return SCAN_THREADS * (8 if n_columns <= 2 else 4 if n_columns <= 4
                           else 2)


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


def sweep_route(node_start, high_q) -> str:
    """The kernel a batch takes: "scan" when every run of candidates
    between two node starts (and the run before the first) carries one
    ``high_q`` row, else "serial". Numpy arrays or tensors; O(K·R)."""
    if isinstance(high_q, torch.Tensor):
        same = bool(((high_q[1:] == high_q[:-1]).all(dim=1)
                     | node_start[1:]).all())
    else:
        hq = np.asarray(high_q)
        same = bool(((hq[1:] == hq[:-1]).all(axis=1)
                     | np.asarray(node_start, bool)[1:]).all())
    return "scan" if same else "serial"


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's two's-complement range."""
    return torch.remainder(x + 2**31, 2**32) - 2**31


def _seg_sum(v: torch.Tensor, head: torch.Tensor, carry: torch.Tensor
             ) -> torch.Tensor:
    """Inclusive sums of the rows of ``v`` [T, C] (int64), restarting at
    each ``head`` row; rows before the first head continue ``carry``."""
    cs = torch.cumsum(v, 0)
    first = torch.where(head, torch.arange(v.shape[0]), -1)
    last = torch.cummax(first, 0).values
    base = torch.where((last >= 0)[:, None], (cs - v)[last.clamp(min=0)],
                       -carry[None, :])
    return cs - base


def _scan_tiled(node_start, usage0, high_q, metric, has_metric, valid,
                blocked, available0, res_mask, tile: Optional[int] = None):
    """CPU emulation of the scan kernel, tile by tile, with its carries
    (the open node's running usage and whether it was cut, the headroom,
    whether the headroom ran out), in int64 reduced to int32 where the
    kernel compares or carries: exact for batches :func:`sweep_route`
    sends to "scan". Per tile, before the headroom has run out:

    1. node stage: ``cur`` before each candidate if every eligible
       (valid, not blocked) candidate of its node were proposed, a
       segmented exclusive sum; the node is cut at its first candidate
       not over its high quantities, and the eligible candidates before
       the cut are the tentative proposals;
    2. headroom stage: the headroom before each candidate under the
       tentative proposals, an exclusive sum; ``a`` is the first
       candidate whose headroom is exhausted;
    3. streams: the proposals are the tentative ones before ``a``; with
       no ``a`` in the tile, ``over`` is "not yet cut" and ``avail_ok``
       true; from ``a`` on, ``cur`` is recomputed from the actual
       proposals and ``avail_ok`` is false.

    ``tile`` defaults to the kernel's (:func:`scan_tile`). Returns what
    :func:`_balance_sweep` returns."""
    if tile is None:
        tile = scan_tile(int(res_mask.sum()))
    k = int(valid.shape[0])
    i64 = torch.int64
    mask = res_mask.cpu()
    x_all = torch.where((valid & ~blocked & has_metric)[:, None] & mask,
                        metric, 0).to(i64)
    seg = torch.zeros(NUM_RESOURCES, dtype=i64)
    seg_cut = torch.zeros(1, dtype=i64)
    avail = available0.to(i64)
    ran_out = False
    out = torch.zeros((3, k), dtype=torch.bool)
    for s in range(0, k, tile):
        e = min(s + tile, k)
        n = e - s
        head, hq, x = node_start[s:e], high_q[s:e].to(i64), x_all[s:e]
        z = torch.where(head[:, None], usage0[s:e].to(i64), 0)
        if not ran_out:
            cur = _seg_sum(z - x, head, seg) + x
            over = ((_wrap32(cur) > hq) & mask).any(dim=1)
            seen = _seg_sum((~over).to(i64)[:, None], head, seg_cut)[:, 0] > 0
            tent = valid[s:e] & ~blocked[s:e] & ~seen
            d = torch.where(tent[:, None], x, 0)
            room = _seg_sum(-d, torch.zeros_like(head), avail) + d
            out_at = torch.nonzero(((_wrap32(room) <= 0) & mask).any(dim=1))
            if not out_at.numel():
                out[0, s:e], out[1, s:e], out[2, s:e] = tent, ~seen, True
                # carry the actual usage: a node cut in this tile stays
                # frozen at its cut, whatever its later candidates hold
                seg = _wrap32(_seg_sum(z - d, head, seg)[-1])
                seg_cut = seen[-1:].to(i64)
                avail = _wrap32(room[-1] - d[-1])
                continue
            a = int(out_at[0, 0])
            propose = tent & (torch.arange(n) < a)
            avail = _wrap32(room[a])
            ran_out = True
        else:
            a, propose = 0, torch.zeros(n, dtype=torch.bool)
        xa = torch.where(propose[:, None], x, 0)
        after = _seg_sum(z - xa, head, seg)
        out[0, s:e] = propose
        out[1, s:e] = ((_wrap32(after + xa) > hq) & mask).any(dim=1)
        out[2, s:e] = torch.arange(n) < a
        seg = _wrap32(after[-1])
    return out.to(available0.device), _wrap32(avail).to(I32).to(
        available0.device)


class _Launch(NamedTuple):
    """A validated launch of one route's kernel: its arguments as
    pointers, and the output tensors they point into."""

    lib: object
    device: torch.device
    route: str
    k: int
    inputs: tuple           # nine input pointers and K
    outputs: tuple          # three stream pointers and the headroom's
    streams: torch.Tensor   # [3, K] bool: propose, over, avail_ok
    available: torch.Tensor  # [R] int32: the headroom after the walk


def _prepare(batch: SweepBatch, blocked, available, res_mask, route: str,
             streams=None) -> _Launch:
    """Check the inputs and gather the launch of ``route``'s kernel;
    ``streams`` is the contiguous [3, K] bool tensor to write (a new one
    when None)."""
    dev = batch.usage0.device
    k = int(batch.valid.shape[0])
    R = NUM_RESOURCES
    if streams is None:
        streams = torch.empty((3, k), dtype=torch.bool, device=dev)
    for name, t, shape, dtype in (
            ("node_start", batch.node_start, (k,), torch.bool),
            ("usage0", batch.usage0, (k, R), I32),
            ("high_q", batch.high_q, (k, R), I32),
            ("metric", batch.metric, (k, R), I32),
            ("has_metric", batch.has_metric, (k,), torch.bool),
            ("valid", batch.valid, (k,), torch.bool),
            ("blocked", blocked, (k,), torch.bool),
            ("available", available, (R,), I32),
            ("res_mask", res_mask, (R,), torch.bool),
            ("streams", streams, (3, k), torch.bool)):
        bk._check(name, t, shape, dev, dtype)
    if route not in ROUTE_KERNELS:
        raise ValueError(f"unknown sweep route {route!r}")
    out = torch.empty(R, dtype=I32, device=dev)
    inputs = (batch.node_start.data_ptr(), batch.usage0.data_ptr(),
              batch.high_q.data_ptr(), batch.metric.data_ptr(),
              batch.has_metric.data_ptr(), batch.valid.data_ptr(),
              blocked.data_ptr(), available.data_ptr(), res_mask.data_ptr(),
              k)
    return _Launch(bk._library(), dev, route, k, inputs,
                   tuple(streams[j].data_ptr() for j in range(3))
                   + (out.data_ptr(),), streams, out)


def _fire(launch: _Launch, refused: int = -1) -> None:
    """Launch a prepared kernel on the current stream; ``refused`` (the
    scan kernel only; -1: none) is walked as blocked and written into the
    blocked mask."""
    if not -1 <= refused < launch.k or (refused >= 0
                                        and launch.route != "scan"):
        raise ValueError(f"refused index {refused} for route "
                         f"{launch.route!r}, K = {launch.k}")
    lib = launch.lib
    if launch.route == "scan":
        rc = bk._on_device(launch.device, lambda stream: (
            lib.rebalance_scan_launch(*launch.inputs, refused,
                                      *launch.outputs, stream)))
    else:
        rc = bk._on_device(launch.device, lambda stream: (
            lib.rebalance_sweep_launch(*launch.inputs, *launch.outputs,
                                       stream)))
    name = ROUTE_KERNELS[launch.route]
    if rc != 0:
        raise bk._cuda_error(lib, f"{name} kernel launch", rc)
    LAUNCHES[name] += 1


def _launch(batch: SweepBatch, blocked, available, res_mask, route: str,
            refused: int = -1, streams=None):
    """Check, gather and launch ``route``'s kernel (:func:`_prepare`,
    :func:`_fire`); returns ``(streams, available)``. The route is the
    caller's: the scan kernel is exact only on a batch
    :func:`sweep_route` sends to it."""
    launch = _prepare(batch, blocked, available, res_mask, route, streams)
    _fire(launch, refused)
    return launch.streams, launch.available


def balance_sweep(batch: SweepBatch, blocked: torch.Tensor,
                  available: torch.Tensor, res_mask: torch.Tensor):
    """The sweep over a staged batch: ``(streams [3, K] bool: propose,
    over, avail_ok; available [R] int32 after the walk)``. For CUDA
    tensors the kernel of the batch's :func:`sweep_route`,
    :func:`_balance_sweep` for CPU tensors. A build or launch failure
    raises."""
    dev = batch.usage0.device
    if dev.type == "cuda":
        return _launch(batch, blocked, available, res_mask,
                       sweep_route(batch.node_start, batch.high_q))
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return _balance_sweep(*batch, blocked, available, res_mask)


def launch_empty(device) -> None:
    """Launch an empty kernel at the scan kernel's shape (one CTA of 512
    threads, its shared memory): the launch floor its times are read
    against. Not counted in :data:`LAUNCHES`."""
    lib = bk._library()
    dev = torch.device(device)
    rc = bk._on_device(dev, lib.rebalance_empty_launch)
    if rc != 0:
        raise bk._cuda_error(lib, "empty kernel launch", rc)


class DeviceSweep:
    """One staged sweep: the batch validated, staged and routed once
    (:func:`sweep_route`), then :meth:`run` for a blocked mask and
    :meth:`refuse` after each evictor refusal. The reference re-stages
    every input and re-runs the whole walk on each re-scan; the results
    are the same.

    A refusal at candidate ``j`` changes no decision before ``j``, so
    :meth:`refuse` is one launch (the scan kernel marks ``j`` blocked in
    the device's mask itself; the serial route sets the byte first) and
    one copy of the [3, K] streams' bytes from ``j`` on into a pinned host
    buffer, spliced onto the prefix already held. On the CPU the plain
    version re-runs and its suffix is spliced the same way."""

    def __init__(self, batch: SweepBatch, available, res_mask,
                 device: DeviceLike = None):
        validate_sweep(batch, available, res_mask)
        self.device = resolve_device(device)
        self.k = int(batch.valid.shape[0])
        self.route = sweep_route(batch.node_start, batch.high_q)
        self.batch = stage_sweep_batch(batch, self.device)
        self.available = torch.tensor(
            np.asarray(available, dtype=np.int64).astype(np.int32),
            dtype=I32, device=self.device)
        self.res_mask = torch.tensor(np.asarray(res_mask, bool),
                                     dtype=torch.bool, device=self.device)
        self.blocked = torch.zeros(self.k, dtype=torch.bool,
                                   device=self.device)
        #: the host streams, ``[3, K]``: propose, over, avail_ok
        self.host = np.zeros((3, self.k), bool)
        self._launch = self._flat = self._pinned = self._pinned_rows = None
        if self.device.type == "cuda":
            pinned = torch.empty((3, self.k), dtype=torch.bool,
                                 pin_memory=True)
            self._pinned = pinned.view(-1)
            self._pinned_rows = pinned.numpy()

    def _sweep(self, first: int, refused: int = -1) -> None:
        """Walk with the device's mask; take the streams from ``first``
        on into :attr:`host`."""
        if self.device.type == "cpu":
            streams, _ = balance_sweep(self.batch, self.blocked,
                                       self.available, self.res_mask)
            self.host[:, first:] = streams[:, first:].numpy()
            return
        if self._launch is None:  # checked and gathered once a pass
            self._launch = _prepare(self.batch, self.blocked,
                                    self.available, self.res_mask,
                                    self.route)
            self._flat = self._launch.streams.view(-1)
        _fire(self._launch, refused)
        # one copy: the flat [3, K] bytes from row 0's `first` on hold
        # every stream's suffix (and the other two rows' prefixes)
        self._pinned[first:].copy_(self._flat[first:], non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        self.host[:, first:] = self._pinned_rows[:, first:]

    def _result(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.host[0].copy(), self.host[1].copy(), self.host[2].copy()

    def run(self, blocked) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host ``(propose, over, avail_ok)`` for this blocked mask (copied
        to the device, the whole walk read back)."""
        self.blocked.copy_(torch.from_numpy(np.array(blocked, dtype=bool)))
        self._sweep(0)
        return self._result()

    def refuse(self, j: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host ``(propose, over, avail_ok)`` once candidate ``j`` is
        blocked as well."""
        j = int(j)
        if not 0 <= j < self.k:
            raise IndexError(f"candidate {j} out of range [0, {self.k})")
        if self.device.type == "cuda" and self.route == "scan":
            self._sweep(j, refused=j)
        else:
            self.blocked[j] = True
            self._sweep(j)
        return self._result()


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

