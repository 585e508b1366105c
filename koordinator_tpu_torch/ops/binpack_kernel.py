"""The hand-written placement kernels: their wrappers, the route between
them, plain twins, gates and epilogue.

Replaces ``koordinator_tpu/ops/pallas_binpack.py``: the Pallas kernel
``_make_kernel`` (plain, ``use_quota``, ``use_resv`` and ``use_numa``
least/most variants) becomes two CUDA C++ kernels sharing one solve
(``csrc/binpack_common.cuh``): the one-block kernel (``csrc/binpack.cu``)
and the thread-block-cluster kernel (``csrc/binpack_cluster.cu``, one
node slice per CTA; the reference's ``n_shards > 1``). Each CTA keeps
its slice in shared memory for the whole solve, or, past what 16 CTAs
hold, in a device-memory workspace (the L2 form); the quota tables sit in
shared memory when they leave the slice room, else in device memory.
``_pallas_solve``'s input layout becomes :func:`kernel_inputs`;
``_solve_full``/``pallas_solve_batch`` become :func:`kernel_solve_batch`;
the gates ``pallas_supported``, ``pallas_routing_ok``,
``pallas_resv_supported`` and ``pallas_resv_score_safe`` become
:func:`kernel_supported`, :func:`kernel_routing_ok`,
:func:`kernel_resv_supported` and :func:`kernel_resv_score_safe`;
``_kernel_epilogue`` is ``ops/binpack.resolve_gangs``, shared with the
loop solver.

:func:`kernel_route`, a pure function of the solve's sizes, names the
kernel and its CTA count (:func:`route_of` for a solve's inputs);
:func:`binpack` follows it on every device. :func:`binpack_sharded` runs
the cluster kernel at a given CTA count
(``parallel/mesh.shard_kernel_solver`` is its solve).

Reservations reach the kernel as a node -> reservation CSR (reservation
ids sorted by ``(node, id)`` and ``[N+1]`` offsets) beside the dense
``[P,V]`` owner-match bytes, so the thread that owns a node row also
owns its reservations' free rows.

The wrappers launch a kernel for CUDA tensors and run the chosen
kernel's plain twin (:func:`binpack_plain`, :func:`binpack_sharded_plain`)
for CPU tensors; nothing else selects between them. The library is built
with ``nvcc`` at first use, from ``csrc/`` only (one ``nvcc`` per source,
started together, then one link), into ``koordinator_tpu_torch/_build/``
(git ignores it), and bound with ``ctypes``; it also holds the balance
sweep's kernel (``csrc/rebalance_sweep.cu``, wrapped in
``ops/rebalance.py``). A build or launch failure
raises; it never falls back to a twin, another kernel or fewer CTAs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from koordinator_tpu_torch.obs.device import DEVICE_OBS
from koordinator_tpu_torch.ops.binpack import (
    ExtrasRows,
    NodeState,
    NumaAux,
    PodBatch,
    ResvArrays,
    ScoreParams,
    SolveResult,
    resolve_gangs,
)
from koordinator_tpu_torch.ops.common import I32, percent_rounded
from koordinator_tpu_torch.ops.quota import quota_runtime
from koordinator_tpu_torch.parallel.mesh import shard_tile_bucket

#: kernel launches since import by :attr:`Route.kind`: the one-block
#: kernel (binpack.cu), the cluster kernel with its slices in shared
#: memory, and its L2 form; "lanes" counts the lane-batched launches of
#: any route (:func:`binpack_lanes`); one per launch on CUDA tensors, the
#: counts that show a run went through a kernel
LAUNCHES = {"block": 0, "cluster": 0, "l2": 0, "lanes": 0}

#: the packed argmax key carries the node index in 16 bits
MAX_NODES = 65536

#: node slices of the cluster kernel: one CTA each, at most the largest
#: cluster Hopper schedules (16, above the portable 8)
MAX_SHARDS = 16

#: request written into column 0 of a host-blocked pod so it never fits
BLOCKED_REQ = 1 << 30

R = 8

_PACKAGE = Path(__file__).resolve().parents[1]
_CSRC = _PACKAGE / "csrc"
#: the compiled sources; the library's name hashes these and the header
SOURCES = (_CSRC / "binpack.cu", _CSRC / "binpack_cluster.cu",
           _CSRC / "rebalance_sweep.cu")
HEADERS = (_CSRC / "binpack_common.cuh",)
BUILD_DIR = _PACKAGE / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

#: the packed argmax key keeps 15 bits for the score (``score << 16``
#: must stay a positive int32)
SCORE_BUDGET = 32767

#: threads of each CTA of both kernels (``NT`` in ``binpack_common.cuh``)
THREADS = 1024
#: dynamic shared memory a CTA may ask for: the 232,448 bytes a Hopper
#: block can opt into, less 1 KB for the kernels' static slots
SMEM_BYTES = 232448 - 1024
#: pods per prefetched chunk, and the most the two chunk buffers may take
#: before the chunk shrinks (wide match rows), down to 2 pods
POD_CHUNK = 32
POD_BUFFER_BYTES = 16384
#: the words of a pod record before its match bits (``REC_MATCH``)
RECORD_HEAD = 28
#: the word of a pod record holding its extras row (``REC_XROW``)
RECORD_XROW = 24
#: an extras score the kernel takes lies in [0, this] (DeviceShare's
#: score is ``min(..., 100)``; selector and port rows score 0)
EXTRAS_SCORE_MAX = 100
#: the worst score without reservation credit or extras: LeastAllocated,
#: LoadAware and NUMA, each at most 100
BASE_SCORE_WORST = 300
#: a solve of at most this many nodes takes the one-block kernel when it
#: fits there; a larger one takes the cluster, with its CTA count raised
#: until each slice has at most this many rows (if one fits)
ROWS_PER_CTA = 1024

_LIB = None
_LIB_LOCK = threading.Lock()
#: guards LAUNCHES: a sidecar's handler threads launch concurrently
_COUNT_LOCK = threading.Lock()


def _count(kind: str) -> None:
    # a launch recorded into a CUDA graph is not a launch: each replay
    # of the graph counts instead (service/warmpool.py)
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return
    with _COUNT_LOCK:
        LAUNCHES[kind] += 1


def count_replay(kind: str) -> None:
    """One replay of a captured graph whose launch is a ``kind`` kernel."""
    with _COUNT_LOCK:
        LAUNCHES[kind] += 1


def _round16(n: int) -> int:
    return (n + 15) & ~15


def row_words(n_resv: int, numa: bool) -> int:
    """Words of one slice row (``row_words`` in ``binpack_common.cuh``):
    alloc, used, usage + est and the division constants of alloc (8
    each), their 8 shift bytes and a flags word (35); with NUMA the
    capacity, the free carry, the capacity's constants and shifts (26);
    with reservations the row's first reservation (1); made odd."""
    return (35 + (26 if numa else 0) + (1 if n_resv else 0)) | 1


def slice_bytes(n_loc: int, n_resv: int, numa: bool,
                resident: bool = True) -> int:
    """Bytes of one CTA's node slice of ``n_loc`` rows (and an end row;
    in the L2 form, ``resident`` False, whole tiles of 32 rows) with room
    for ``n_resv`` reservations of 11 words each (``slice_bytes`` in
    ``binpack_common.cuh``)."""
    rows = n_loc + 1 if resident else (n_loc + 32) & ~31
    b = _round16(rows * row_words(n_resv, numa) * 4)
    if n_resv:
        b += _round16(n_resv * 11 * 4)
    return b


def record_words(n_resv: int) -> int:
    """Words of a pod record: req, est, flags, the NUMA policy, the
    column lists, the extras row, then the match bits padded to a
    16-byte multiple."""
    words = -(-n_resv // 32)
    return RECORD_HEAD + ((words + 3) & ~3)


def pod_chunk(rw: int) -> int:
    """Pods per prefetched chunk for records of ``rw`` words."""
    return max(2, min(POD_CHUNK, POD_BUFFER_BYTES // (2 * rw * 4)))


class Route(NamedTuple):
    """Which kernel runs a solve, and how it is laid out."""

    kind: str       # "block", "cluster" (slices in shared memory), "l2"
    shards: int     # CTAs: 1 for the block, 2..16 for a cluster
    n_loc: int      # rows of each CTA's slice
    chunk: int      # pods per prefetched chunk
    smem: int       # dynamic shared memory bytes per CTA
    work: int       # bytes of device-memory workspace (the L2 form)
    #: the [Q,8] quota tables in shared memory; else min and runtime are
    #: read from device memory and each CTA keeps its carries there
    quota_shared: bool = True


def kernel_route(n_nodes: int, numa: bool = False, n_resv: int = 0,
                 n_quota: int = 0, shards: Optional[int] = None
                 ) -> Optional[Route]:
    """The kernel for a solve of ``n_nodes`` nodes, ``n_resv``
    reservations and ``n_quota`` quota groups (with or without NUMA),
    from the kernels' shared-memory budgets: the one-block kernel when
    the slice fits one CTA and has at most :data:`ROWS_PER_CTA` rows;
    else the cluster kernel at the smallest CTA count whose slices fit
    and have at most that many rows, or else the smallest that fits;
    else the L2 form at 16 CTAs. With ``shards`` (2..16) the cluster
    kernel at that count: its slices in shared memory when they fit, the
    L2 form otherwise. The quota tables take shared memory beside the
    pod buffers; where they do not fit there, or would push the slices
    out of it, they go to device memory and the slices stay. None only
    when no kernel takes the solve: more than 65,536 nodes (the packed
    key's 16 node bits), or none."""
    if shards is not None and not 2 <= shards <= MAX_SHARDS:
        raise ValueError(f"shards must be 2..{MAX_SHARDS}, got {shards}")
    if not 0 < n_nodes <= MAX_NODES:
        return None
    rw = record_words(n_resv)
    chunk = pod_chunk(rw)
    pods = 2 * chunk * rw * 4
    quota = n_quota * R * 4 * 4
    route = None
    if pods + quota <= SMEM_BYTES:
        route = _layout(n_nodes, numa, n_resv, chunk, pods + quota, shards)
    if n_quota and (route is None or route.kind == "l2"):
        in_device = _layout(n_nodes, numa, n_resv, chunk, pods,
                            shards)._replace(quota_shared=False)
        if route is None or in_device.kind != "l2":
            route = in_device
    return route


def _layout(n_nodes, numa, n_resv, chunk, fixed, shards) -> Route:
    """:func:`kernel_route`'s choice with ``fixed`` bytes of shared
    memory per CTA taken before the slice."""

    def n_loc(k):
        return shard_tile_bucket(n_nodes, k) // k

    def slice_of(rows):
        return slice_bytes(rows, n_resv, numa)

    def fits(rows):
        return fixed + slice_of(rows) <= SMEM_BYTES

    def cluster(k):
        rows = n_loc(k)
        if fits(rows):
            return Route("cluster", k, rows, chunk, fixed + slice_of(rows), 0)
        return Route("l2", k, rows, chunk, fixed,
                     k * slice_bytes(rows, n_resv, numa, resident=False))

    if shards is not None:
        return cluster(shards)
    if n_nodes <= ROWS_PER_CTA and fits(n_nodes):
        return Route("block", 1, n_nodes, chunk, fixed + slice_of(n_nodes), 0)
    resident = [k for k in range(2, MAX_SHARDS + 1) if fits(n_loc(k))]
    small = [k for k in resident if n_loc(k) <= ROWS_PER_CTA]
    return cluster((small or resident or [MAX_SHARDS])[0])


def route_of(inp: "KernelInputs", shards: Optional[int] = None
             ) -> Optional[Route]:
    """:func:`kernel_route` for the kernel inputs ``inp``."""
    return kernel_route(
        int(inp.alloc.shape[0]), inp.numa is not None,
        0 if inp.resv is None else int(inp.resv[0].shape[0]),
        0 if inp.quota is None else int(inp.quota[0].shape[0]), shards)


class KernelInputs(NamedTuple):
    """The kernel's operands, laid out as the kernel reads them."""

    req: torch.Tensor     # [P,8] int32, column 0 = BLOCKED_REQ for blocked pods
    est: torch.Tensor     # [P,8] int32
    flags: torch.Tensor   # [P,4] int32: daemonset & ~blocked, prod, quota id, non-preemptible
    alloc: torch.Tensor   # [N,8] int32
    usage: torch.Tensor   # [N,8] int32
    sched: torch.Tensor   # [N] int32 0/1
    fresh: torch.Tensor   # [N] int32 0/1
    la_ok: torch.Tensor   # [N] int32 0/1: LoadAware thresholds not exceeded
    weight: torch.Tensor  # [8] int32
    wsum: int             # Σ weight, or 1 when that is 0
    used0: torch.Tensor   # [N,8] int32 carries at the start of the solve
    est0: torch.Tensor
    prod0: torch.Tensor
    #: None, or (min, runtime, used, np_used), each [Q,8] int32
    quota: Optional[tuple] = None
    #: None, or (cap [N,8], free [N,8], node_policy [N], pod_policy [P]),
    #: int32; policies 0/1
    numa: Optional[tuple] = None
    #: the NUMA scorer: MostAllocated, else LeastAllocated
    most_allocated: bool = False
    #: None, or (free [V,8], allocate_once [V], offsets [N+1], ids [V]),
    #: int32, and match [P,V] uint8: reservation ids sorted by (node,
    #: id), node j's at ids[offsets[j]:offsets[j+1]]; blocked pods'
    #: match rows are zero
    resv: Optional[tuple] = None
    #: None, or (row_of_pod [P] int32, mask [X,N] uint8, score [X,N]
    #: int32): pod p's host extras row, -1 for none (ops/binpack.py
    #: ``ExtrasRows``); every score in [0, EXTRAS_SCORE_MAX]
    extras: Optional[tuple] = None


class KernelOutputs(NamedTuple):
    assign: torch.Tensor           # [P] int32, -1 = not placed
    used: torch.Tensor             # [N,8] int32 carries after the solve
    est: torch.Tensor
    prod: torch.Tensor
    qused: Optional[torch.Tensor]  # [Q,8] int32, None without quotas
    qnp: Optional[torch.Tensor]
    nfree: Optional[torch.Tensor] = None     # [N,8] numa_free after the solve
    consumed: Optional[torch.Tensor] = None  # [P] int32 0/1 took from numa_free
    vstar: Optional[torch.Tensor] = None     # [P] int32 consumed reservation, -1
    delta: Optional[torch.Tensor] = None     # [P,8] int32 taken from it
    rem: Optional[torch.Tensor] = None       # [P,8] int32 remainder it released
    rfree: Optional[torch.Tensor] = None     # [V,8] int32 free table after


def kernel_supported(params: ScoreParams, config) -> bool:
    """Whether a configuration maps onto the kernel: unit plugin weights,
    no prod-usage thresholds, no prod-usage scoring (quota and gang
    states are supported as solve arguments)."""
    return (
        not config.score_according_prod
        and config.fit_weight == 1
        and config.loadaware_weight == 1
        and not bool(params.prod_thresholds.cpu().any())
    )


def kernel_resv_supported(n_resv: int) -> bool:
    """Whether a reservation table maps onto the kernel: at least one
    reservation (an empty table is passed as ``resv=None``). The
    reference kernel also caps the table at 256 reservations and its
    ``[Vp,N]`` one-hot at 8 MB of VMEM, limits of its exact f32 credit
    matmul on the TPU; the node -> reservation CSR here has neither, so
    the port takes larger tables than the reference kernel. Placements
    are the same either way: the kernel equals the loop solver, which
    equals the reference's scan."""
    return n_resv >= 1


def resv_score_worst(node, free, alloc) -> int:
    """The worst score a solve with this reservation table can reach
    before extras. Without reservations every component is at most 100
    (fit + LoadAware + NUMA <= 300); the matched credit can push the fit
    term to ~100 * (1 + credit/alloc), since ``used - credit`` may go far
    negative. The free table only shrinks within a solve, so the initial
    per-node sums bound the credit for the whole solve. Reads the
    tensors back to the host."""
    node = torch.as_tensor(node).cpu().long().numpy()
    free = torch.as_tensor(free).cpu().numpy().astype(np.int64)
    alloc = torch.as_tensor(alloc).cpu().numpy().astype(np.int64)
    credit = np.zeros_like(alloc)
    np.add.at(credit, node, free)
    ratio = -(-credit // np.maximum(alloc, 1))  # ceil; alloc == 0 scores 0
    return BASE_SCORE_WORST + 100 * int(
        np.where(alloc > 0, ratio, 0).max(initial=0))


def kernel_resv_score_safe(node, free, alloc) -> bool:
    """The packed key budgets 15 bits for the score: a reservation table
    whose worst score (:func:`resv_score_worst`) could overflow it must
    take the loop solver."""
    return resv_score_worst(node, free, alloc) <= SCORE_BUDGET


def kernel_extras_score_safe(score, worst: int = BASE_SCORE_WORST) -> bool:
    """Whether a table of extras scores maps onto the kernel: every score
    in [0, :data:`EXTRAS_SCORE_MAX`], and ``worst`` (the solve's worst
    score before extras, :func:`resv_score_worst` with reservations) plus
    the largest of them within the packed key's budget. A negative score
    must never reach the kernel: the scan treats a masked-in negative
    score as infeasible (``where(mask, score, -1)``, first max), the
    packed key does not. ``score`` is any array; it is read on the host
    once per solve, where the rows are built."""
    score = np.asarray(score)
    if score.size == 0:
        return worst <= SCORE_BUDGET
    lo, hi = int(score.min()), int(score.max())
    return (0 <= lo and hi <= EXTRAS_SCORE_MAX
            and worst + hi <= SCORE_BUDGET)


def kernel_routing_ok(state: NodeState, pods: PodBatch, extras,
                      resv: Optional[ResvArrays] = None,
                      resv_score_safe: bool = True,
                      numa_aux: Optional[NumaAux] = None,
                      extras_score_safe: bool = True) -> bool:
    """Per-solve eligibility: host extras only in compact form
    (``ExtrasRows``) with scores the caller has checked
    (``extras_score_safe``, :func:`kernel_extras_score_safe`), at least
    one pod, NUMA inventories when NUMA is asked for, a reservation
    table the kernel takes (:func:`kernel_resv_supported`) whose score
    budget the caller has checked (``resv_score_safe``,
    :func:`kernel_resv_score_safe`), and a kernel that takes the solve
    (:func:`kernel_route`: 1..65,536 nodes, the packed key's 16 node
    bits; the quota groups only decide where the kernel keeps their
    tables)."""
    n = int(state.alloc.shape[0])
    n_resv = 0 if resv is None else int(resv.node.shape[0])
    return (
        (extras is None
         or (isinstance(extras, ExtrasRows) and extras_score_safe))
        and pods.req.shape[0] > 0
        and (numa_aux is None
             or (state.numa_cap is not None and state.numa_free is not None))
        and (resv is None
             or (kernel_resv_supported(n_resv) and resv_score_safe))
        and kernel_route(n, numa_aux is not None, n_resv) is not None
    )


def weight_sum(params: ScoreParams) -> int:
    """Σ resource weight, or 1 when that is 0: the divisor of the score
    sums (one read-back; fixed for a model's lifetime)."""
    return int(params.weights.sum(dtype=I32)) or 1


def resv_csr(node: torch.Tensor, n_nodes: int) -> tuple:
    """``(offsets [N+1], ids [V])`` int32: reservation ids sorted by
    ``(node, id)``; node j's reservations are ``ids[offsets[j]:
    offsets[j+1]]``, in ascending id."""
    order = torch.sort(node.long(), stable=True).indices
    # an index_add, not a bincount: a CUDA bincount reads its maximum
    # back to the host, which no CUDA graph may hold
    counts = torch.zeros(n_nodes, dtype=torch.long, device=node.device)
    counts.index_add_(0, node.long(), torch.ones_like(node, dtype=torch.long))
    offsets = torch.zeros(n_nodes + 1, dtype=torch.long,
                          device=node.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets.to(I32), order.to(I32)


def kernel_inputs(state: NodeState, pods: PodBatch, params: ScoreParams,
                  quota=None, wsum: Optional[int] = None,
                  numa_aux: Optional[NumaAux] = None,
                  resv: Optional[ResvArrays] = None,
                  most_allocated: bool = False,
                  extras: Optional[ExtrasRows] = None) -> KernelInputs:
    """Lay the solve out for the kernel: precompute the LoadAware filter
    verdict per node, pack the per-pod flags, and encode host-blocked
    pods as unplaceable. ``quota`` is None or (min, runtime, used,
    np_used); ``wsum`` is :func:`weight_sum` of ``params``, read from them
    when not given. With ``numa_aux`` the NUMA inventories ride along;
    with ``resv`` the reservation table becomes the node CSR, and
    blocked pods' match rows are zeroed so no credit lets them fit; with
    ``extras`` the compact rows ride along, the mask as bytes."""
    upct = percent_rounded(state.usage, state.alloc)
    over = (state.alloc > 0) & (params.thresholds > 0) & (
        upct >= params.thresholds)
    req = pods.req.to(I32).clone()
    req[:, 0] = torch.where(pods.blocked, BLOCKED_REQ, req[:, 0])
    flags = torch.stack([
        (pods.is_daemonset & ~pods.blocked).to(I32),
        pods.is_prod.to(I32),
        pods.quota_id.to(I32),
        pods.non_preemptible.to(I32),
    ], dim=1)
    weight = params.weights.to(I32)
    return KernelInputs(
        req=req,
        est=pods.est.to(I32).contiguous(),
        flags=flags.contiguous(),
        alloc=state.alloc.to(I32).contiguous(),
        usage=state.usage.to(I32).contiguous(),
        sched=state.schedulable.to(I32),
        fresh=state.metric_fresh.to(I32),
        la_ok=(~over.any(dim=-1)).to(I32),
        weight=weight.contiguous(),
        wsum=weight_sum(params) if wsum is None else wsum,
        used0=state.used_req.to(I32).contiguous(),
        est0=state.est_extra.to(I32).contiguous(),
        prod0=state.prod_base.to(I32).contiguous(),
        quota=(None if quota is None
               else tuple(q.to(I32).contiguous() for q in quota)),
        numa=None if numa_aux is None else _numa_inputs(state, pods, numa_aux),
        most_allocated=bool(most_allocated),
        resv=None if resv is None else _resv_inputs(resv, pods,
                                                    state.alloc.shape[0]),
        extras=None if extras is None else (
            extras.row_of_pod.to(I32).contiguous(),
            extras.mask.to(torch.uint8).contiguous(),
            extras.score.to(I32).contiguous()),
    )


def _numa_inputs(state: NodeState, pods: PodBatch, numa_aux: NumaAux) -> tuple:
    pod_policy = pods.has_numa_policy
    if pod_policy is None:
        pod_policy = torch.zeros_like(pods.blocked)
    return (state.numa_cap.to(I32).contiguous(),
            state.numa_free.to(I32).contiguous(),
            numa_aux.node_policy.to(I32).contiguous(),
            pod_policy.to(I32).contiguous())


def _resv_inputs(resv: ResvArrays, pods: PodBatch, n_nodes: int) -> tuple:
    offsets, ids = resv_csr(resv.node, n_nodes)
    match = (resv.match & ~pods.blocked[:, None]).to(torch.uint8)
    return (resv.free.to(I32).contiguous(),
            resv.allocate_once.to(I32).contiguous(),
            offsets, ids, match.contiguous())


def binpack_plain(inp: KernelInputs) -> KernelOutputs:
    """The kernel's plain twin: the same per-pod computation as
    ``csrc/binpack.cu`` as a torch loop, on any device. Used by the CPU
    path and held against the kernel on the card. It reads the
    reservations through the same CSR as the kernel, keeping the free
    table in CSR order, so a wrong CSR shows here as well."""
    return _plain(inp, 1)


def binpack_sharded_plain(inp: KernelInputs, shards: int) -> KernelOutputs:
    """The cluster kernel's plain twin (``csrc/binpack_cluster.cu``): the
    node axis cut into ``shards`` ranges of ``n_loc =
    shard_tile_bucket(N, shards) // shards`` rows; per pod, each shard's
    best packed key over its own rows (global node index in the key),
    the max over the shards, and the change made at the winner (the
    rows, reservations and NUMA capacity of the shard that owns it).
    Quota carries are kept in one copy per shard, each gating with its
    own copy and replaying the same adds; copy 0 is returned. Equal to
    :func:`binpack_plain` on every output: the CPU proof of the merge."""
    return _plain(inp, shards)


def _plain(inp: KernelInputs, shards: int) -> KernelOutputs:
    alloc, usage = inp.alloc, inp.usage
    dev = alloc.device
    n = alloc.shape[0]
    n_loc = shard_tile_bucket(n, shards) // shards
    shard_of = torch.arange(n, device=dev) // n_loc
    alloc_safe = torch.clamp(alloc, min=1)
    alloc_zero = alloc == 0
    sched, fresh = inp.sched > 0, inp.fresh > 0
    la_ok = inp.la_ok > 0
    lane_key = 65535 - torch.arange(n, dtype=I32, device=dev)
    no_rows = torch.full((shards * n_loc - n,), -1, dtype=I32, device=dev)
    weight, wsum = inp.weight, inp.wsum
    used, estx, prod = inp.used0.clone(), inp.est0.clone(), inp.prod0.clone()
    quota = inp.quota is not None
    if quota:
        qmin, qrt, qused, qnp = inp.quota
        # one copy of the quota carries per shard: [shards, Q, R]
        qused = qused.expand(shards, *qused.shape).clone()
        qnp = qnp.expand(shards, *qnp.shape).clone()
    numa = inp.numa is not None
    if numa:
        ncap, nfree, npol, pod_policy = inp.numa
        ncap_safe = torch.clamp(ncap, min=1)
        nfree = nfree.clone()
    resv = inp.resv is not None
    if resv:
        rfree0, aonce, offsets, ids, match = inp.resv
        ids = ids.long()
        # node of each CSR position: the last j with offsets[j] <= k
        seg = torch.searchsorted(
            offsets.long(), torch.arange(ids.shape[0], device=dev),
            right=True) - 1
        rfc = rfree0.index_select(0, ids)       # free rows in CSR order
        once_c = aonce.index_select(0, ids) > 0
        vstars, deltas, rems = [], [], []
    consumed = []
    xrow = None
    if inp.extras is not None:
        # the rows each pod reads, named on the host once
        xrow = inp.extras[0].cpu().tolist()
        xmask, xscore = inp.extras[1] > 0, inp.extras[2]

    def score(value):
        # Σ_r w_r * (alloc - value)*100 // alloc, 0 where alloc == 0 or
        # value > alloc, then // wsum
        y = torch.clamp((alloc - value) * 100, min=0)
        term = torch.div(y, alloc_safe, rounding_mode="floor") * weight
        term = torch.where(alloc_zero | (value > alloc), 0, term)
        return torch.div(term.sum(dim=-1, dtype=I32), wsum,
                         rounding_mode="floor")

    nodes = []
    for p in range(inp.req.shape[0]):
        req_v, est_v = inp.req[p], inp.est[p]
        is_ds, is_prod = inp.flags[p, 0] > 0, inp.flags[p, 1] > 0
        used_fit = used
        if resv:
            mrow = match[p].index_select(0, ids) > 0       # CSR order
            credit = torch.zeros_like(used).index_add(
                0, seg, torch.where(mrow[:, None], rfc, 0))
            used_fit = used - credit
        requested = used_fit + req_v
        fit = sched & ((req_v == 0) | (requested <= alloc)).all(dim=-1)
        s2 = torch.where(fresh, score(usage + estx + est_v), 0)
        mask = fit & (is_ds | ~fresh | la_ok)
        total = score(requested) + s2
        if numa:
            member = req_v > 0
            nreq = ncap - nfree + req_v
            numer = nreq if inp.most_allocated else ncap - nreq
            per = torch.div(numer * 100, ncap_safe, rounding_mode="floor")
            per = torch.where(member & (ncap > 0) & (nreq <= ncap), per, 0)
            cnt = member.sum(dtype=I32)
            total = total + torch.where(
                cnt > 0, torch.div(per.sum(dim=-1, dtype=I32),
                                   torch.clamp(cnt, min=1),
                                   rounding_mode="floor"), 0)
        if xrow is not None and xrow[p] >= 0:
            mask = mask & xmask[xrow[p]]
            total = total + xscore[xrow[p]]
        if quota:
            # each shard gates its rows with its own copy
            qid = inp.flags[p, 2]
            non_pre = inp.flags[p, 3] > 0
            q = torch.clamp(qid, min=0).reshape(1).long()
            sel = req_v > 0
            viol = (sel & (qused.index_select(1, q)[:, 0] + req_v
                           > qrt.index_select(0, q)[0])).any(dim=-1)
            viol_np = (sel & non_pre & (qnp.index_select(1, q)[:, 0] + req_v
                                        > qmin.index_select(0, q)[0])).any(
                                            dim=-1)
            admit = (qid < 0) | ~(viol | viol_np)             # [shards]
            mask = mask & admit.index_select(0, shard_of)
        packed = torch.where(mask, (total << 16) | lane_key, -1)
        # each shard's best over its own rows, then the max over shards
        local = torch.cat([packed, no_rows]).view(shards, n_loc).amax(dim=1)
        m = local.max()
        ok = m >= 0
        best = (65535 - (m & 65535)).reshape(1).long()
        nodes.append(torch.where(ok, best[0], -1).to(I32))
        add_req = torch.where(ok, req_v, 0)
        add_est = torch.where(ok, est_v, 0)[None, :]
        if resv:
            # the most-free matched reservation on the winning node,
            # first in CSR order (ascending id) among equals
            on_node = mrow & (seg == best) & ok
            fsum = torch.where(on_node, rfc.sum(dim=-1, dtype=I32), -1)
            k = torch.argmax(fsum).reshape(1)
            has = fsum.index_select(0, k)[0] > 0
            row = rfc.index_select(0, k)[0]
            delta = torch.where(has, torch.minimum(row, req_v), 0)
            once = has & once_c.index_select(0, k)[0]
            rem = torch.where(once, row - delta, 0)
            new_row = torch.where(has, torch.where(once, 0, row - delta), row)
            rfc = rfc.index_copy(0, k, new_row[None, :])
            vstars.append(torch.where(has, ids.index_select(0, k)[0], -1)
                          .to(I32))
            deltas.append(delta)
            rems.append(rem)
            add_req = add_req - delta - rem
        used = used.index_add(0, best, add_req[None, :])
        estx = estx.index_add(0, best, add_est)
        prod = prod.index_add(0, best, torch.where(is_prod, add_est, 0))
        if numa:
            take = ok & ((pod_policy[p] > 0)
                         | (npol.index_select(0, best)[0] > 0))
            nfree = nfree.index_add(
                0, best, -torch.where(take, req_v, 0)[None, :])
            consumed.append(take.to(I32))
        if quota:   # every shard replays the add
            addq = torch.where(sel & ok & (qid >= 0), req_v, 0)
            addq = addq.expand(shards, 1, R)
            qused = qused.index_add(1, q, addq)
            qnp = qnp.index_add(1, q, torch.where(non_pre, addq, 0))

    def stack(rows, shape):
        return (torch.stack(rows) if rows
                else torch.zeros(shape, dtype=I32, device=dev))

    p_count = inp.req.shape[0]
    out = KernelOutputs(
        stack(nodes, (0,)), used, estx, prod,
        qused[0] if quota else None, qnp[0] if quota else None)
    if numa:
        out = out._replace(nfree=nfree, consumed=stack(consumed, (p_count,)))
    if resv:
        rfree = torch.empty_like(rfc).index_copy(0, ids, rfc)
        out = out._replace(vstar=stack(vstars, (p_count,)),
                           delta=stack(deltas, (p_count, R)),
                           rem=stack(rems, (p_count, R)), rfree=rfree)
    return out


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       + ", ".join(src.name for src in SOURCES))


def _digest() -> str:
    h = hashlib.sha256()
    for path in SOURCES + HEADERS:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the kernel library of the current sources is (or would be)
    built: named by the hash of the sources and header."""
    return BUILD_DIR / f"libbinpack-{_digest()}.so"


def build_library() -> Path:
    """Compile ``csrc/`` into a shared library named by the hash of its
    sources and header (an unchanged tree is not rebuilt): one ``nvcc``
    per source, all started together, then one link. Returns its path;
    ``ptxas``'s register and spill report for each kernel variant is
    kept beside it (:func:`build_log`). A build (not a load of a built
    library) is recorded in the device observatory."""
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(SOURCES, objs)]
    log, failed = [], []
    for src, proc in zip(SOURCES, procs):
        stdout, stderr = proc.communicate()
        log.append(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    tmp = out.with_name(f"{stem}.so.tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n"
                           + "\n".join(log))
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)
    DEVICE_OBS.record_compile("binpack_library", time.perf_counter() - t0,
                              "".join(log))
    return out


def build_log() -> str:
    """``nvcc``'s output for the current sources (``-Xptxas -v``:
    registers, shared memory and spills of every kernel variant), or ""
    when the library was not built here."""
    log = build_library().with_suffix(".log")
    return log.read_text() if log.exists() else ""


#: the kernels' instances as (resv, numa, most)
VARIANTS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 1, 1), (1, 1, 1))


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            args = [ptr, i32, i32, i32,              # records, P, rw, chunk
                    ptr, ptr, ptr, ptr, ptr, i32,    # alloc..la_ok, N
                    ptr, i32,                        # weight, wsum
                    ptr, ptr, ptr,                   # used0, est0, prod0
                    ptr, ptr, ptr, ptr, i32,         # quota in, Q
                    ptr, ptr, ptr, i32, i32,         # numa in, on, most
                    ptr, ptr, ptr, ptr, i32,         # resv in, V
                    ptr, ptr,                        # extras mask, score
                    ptr, ptr, ptr, ptr, ptr, ptr,    # outputs
                    ptr, ptr,                        # numa outputs
                    ptr, ptr, ptr, ptr]              # resv outputs
            # qshared, smem, stream
            lib.binpack_launch.argtypes = args + [i32, i32, ptr]
            lib.binpack_launch.restype = i32
            # shards, n_loc, resident, qshared, work, smem, stream
            lib.binpack_cluster_launch.argtypes = args + [
                i32, i32, i32, i32, ptr, i32, ptr]
            lib.binpack_cluster_launch.restype = i32
            # the lane launches: the plain solve's arguments with wsum
            # per lane, then lanes, base_stride
            lane_args = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i32,
                         ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                         i32]
            lib.binpack_lanes_launch.argtypes = lane_args + [i32, ptr]
            lib.binpack_lanes_launch.restype = i32
            # shards, n_loc, resident, work, work_stride, smem, stream
            lib.binpack_cluster_lanes_launch.argtypes = lane_args + [
                i32, i32, i32, ptr, ctypes.c_ulonglong, i32, ptr]
            lib.binpack_cluster_lanes_launch.restype = i32
            lib.binpack_cluster_occupancy.argtypes = [
                i32, i32, i32, i32, i32, i32, ctypes.POINTER(i32)]
            lib.binpack_cluster_occupancy.restype = i32
            # the balance sweep (ops/rebalance.py): nine inputs, K, four
            # outputs, stream
            lib.rebalance_sweep_launch.argtypes = [ptr] * 9 + [i32] + [ptr] * 5
            lib.rebalance_sweep_launch.restype = i32
            # its scan form: nine inputs, K, the refused index, four
            # outputs, stream
            lib.rebalance_scan_launch.argtypes = (
                [ptr] * 9 + [i32, i32] + [ptr] * 5)
            lib.rebalance_scan_launch.restype = i32
            lib.rebalance_scan_shared_bytes.argtypes = []
            lib.rebalance_scan_shared_bytes.restype = i32
            lib.rebalance_empty_launch.argtypes = [ptr]
            lib.rebalance_empty_launch.restype = i32
            lib.binpack_error_string.argtypes = [i32]
            lib.binpack_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _on_device(dev, call):
    """``call(stream)`` with ``dev`` the current device and ``stream`` the
    handle of its current CUDA stream."""
    with torch.cuda.device(dev):
        return call(torch.cuda.current_stream(dev).cuda_stream)


def _cuda_error(lib, what: str, rc: int) -> RuntimeError:
    msg = lib.binpack_error_string(rc).decode()
    return RuntimeError(f"{what} failed: {msg} ({rc})")


def _check(name, t, shape, device, dtype=I32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.data_ptr() % 16 and t.numel():
        raise ValueError(f"{name} is not 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def pod_records(inp: KernelInputs) -> torch.Tensor:
    """The kernels' per-pod records, ``[P, record_words(V)]`` int32: req,
    est, flags, the NUMA policy, the bit masks of the columns with req !=
    0 and with req > 0, the columns with req != 0 in ascending order (4
    bits each, the first lowest), the extras row (-1: none), then the
    match row as bits (reservation v is bit ``v & 31`` of word
    ``v >> 5``)."""
    p = inp.req.shape[0]
    v = 0 if inp.resv is None else inp.resv[0].shape[0]
    dev = inp.req.device
    rec = torch.zeros((p, record_words(v)), dtype=I32, device=dev)
    rec[:, :R] = inp.req
    rec[:, R:2 * R] = inp.est
    rec[:, 2 * R:2 * R + 4] = inp.flags
    if inp.numa is not None:
        rec[:, 2 * R + 4] = inp.numa[3]
    bit = 1 << torch.arange(R, dtype=I32, device=dev)
    rec[:, 2 * R + 5] = ((inp.req != 0) * bit).sum(dim=1, dtype=I32)
    rec[:, 2 * R + 6] = ((inp.req > 0) * bit).sum(dim=1, dtype=I32)
    asked = (inp.req != 0).to(I32)
    slot = 4 * (torch.cumsum(asked, dim=1, dtype=I32) - 1)
    cols = torch.arange(R, dtype=I32, device=dev)
    rec[:, 2 * R + 7] = (asked * (cols << slot.clamp(min=0))).sum(
        dim=1, dtype=I32)
    rec[:, RECORD_XROW] = -1 if inp.extras is None else inp.extras[0]
    if v:
        words = -(-v // 32)
        bits = torch.zeros((p, words * 32), dtype=torch.int64, device=dev)
        bits[:, :v] = inp.resv[4]
        packed = (bits.view(p, words, 32)
                  << torch.arange(32, device=dev)).sum(dim=-1)
        packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
        rec[:, RECORD_HEAD:RECORD_HEAD + words] = packed.to(I32)
    return rec


def _launch(inp: KernelInputs, route: Route) -> KernelOutputs:
    """Launch the kernel ``route`` names on the inputs' device and
    current stream."""
    dev = inp.alloc.device
    p, n = inp.req.shape[0], inp.alloc.shape[0]
    if not (0 < n <= MAX_NODES and p > 0):
        raise ValueError(f"kernel needs 1..{MAX_NODES} nodes and pods, "
                         f"got {n} nodes, {p} pods")
    for name, shape in (("req", (p, R)), ("est", (p, R)), ("flags", (p, 4)),
                        ("alloc", (n, R)), ("usage", (n, R)), ("sched", (n,)),
                        ("fresh", (n,)), ("la_ok", (n,)), ("weight", (R,)),
                        ("used0", (n, R)), ("est0", (n, R)), ("prod0", (n, R))):
        _check(name, getattr(inp, name), shape, dev)
    quota = inp.quota
    q = 0
    if quota is not None:
        q = quota[0].shape[0]
        for name, t in zip(("qmin", "qrt", "qused", "qnp"), quota):
            _check(name, t, (q, R), dev)
    numa = inp.numa
    if numa is not None:
        for name, t, shape in zip(("numa_cap", "numa_free", "node_policy",
                                   "pod_policy"), numa,
                                  ((n, R), (n, R), (n,), (p,))):
            _check(name, t, shape, dev)
    resv = inp.resv
    v = 0
    if resv is not None:
        v = resv[0].shape[0]
        if v < 1:
            raise ValueError("an empty reservation table is passed as None")
        for name, t, shape, dtype in zip(
                ("resv_free", "allocate_once", "offsets", "ids", "match"),
                resv, ((v, R), (v,), (n + 1,), (v,), (p, v)),
                (I32, I32, I32, I32, torch.uint8)):
            _check(name, t, shape, dev, dtype)
    extras = inp.extras
    xptrs = [None] * 2
    if extras is not None:
        x = extras[1].shape[0]
        for name, t, shape, dtype in zip(
                ("row_of_pod", "extras_mask", "extras_score"), extras,
                ((p,), (x, n), (x, n)), (I32, torch.uint8, I32)):
            _check(name, t, shape, dev, dtype)
        xptrs = [extras[1].data_ptr(), extras[2].data_ptr()]
    lib = _library()
    rec = pod_records(inp)
    assign = torch.empty(p, dtype=I32, device=dev)
    used, est, prod = (torch.empty_like(inp.alloc) for _ in range(3))
    out = KernelOutputs(assign, used, est, prod, None, None)
    qptrs = [None] * 4
    if quota is not None:
        # one copy per CTA; copy 0 is the result
        out = out._replace(
            qused=torch.empty((route.shards, q, R), dtype=I32, device=dev)[0],
            qnp=torch.empty((route.shards, q, R), dtype=I32, device=dev)[0])
        qptrs = [t.data_ptr() for t in quota]
    nptrs = [None] * 3
    if numa is not None:
        out = out._replace(nfree=torch.empty_like(inp.alloc),
                           consumed=torch.empty(p, dtype=I32, device=dev))
        nptrs = [t.data_ptr() for t in numa[:3]]
    rptrs = [None] * 4
    if resv is not None:
        out = out._replace(vstar=torch.empty(p, dtype=I32, device=dev),
                           delta=torch.empty_like(inp.req),
                           rem=torch.empty_like(inp.req),
                           rfree=torch.empty_like(resv[0]))
        rptrs = [t.data_ptr() for t in resv[:4]]
    args = (
        rec.data_ptr(), p, rec.shape[1], route.chunk,
        inp.alloc.data_ptr(), inp.usage.data_ptr(), inp.sched.data_ptr(),
        inp.fresh.data_ptr(), inp.la_ok.data_ptr(), n,
        inp.weight.data_ptr(), inp.wsum,
        inp.used0.data_ptr(), inp.est0.data_ptr(), inp.prod0.data_ptr(),
        *qptrs, q,
        *nptrs, int(numa is not None), int(inp.most_allocated),
        *rptrs, v, *xptrs,
        assign.data_ptr(), used.data_ptr(), est.data_ptr(),
        prod.data_ptr(), _ptr(out.qused), _ptr(out.qnp),
        _ptr(out.nfree), _ptr(out.consumed),
        _ptr(out.vstar), _ptr(out.delta), _ptr(out.rem), _ptr(out.rfree),
    )
    qshared = int(route.quota_shared)
    if route.kind == "block":
        rc = _on_device(dev, lambda stream: lib.binpack_launch(
            *args, qshared, route.smem, stream))
        if rc != 0:
            raise _cuda_error(lib, "binpack kernel launch", rc)
    else:
        work = (torch.empty(route.work, dtype=torch.uint8, device=dev)
                if route.kind == "l2" else None)
        rc = _on_device(dev, lambda stream: lib.binpack_cluster_launch(
            *args, route.shards, route.n_loc, int(route.kind == "cluster"),
            qshared, _ptr(work), route.smem, stream))
        if rc != 0:
            raise _cuda_error(lib, f"binpack cluster kernel launch "
                              f"({route.shards} CTAs, {route.kind})", rc)
    _count(route.kind)
    return out


def _run(inp: KernelInputs, route: Optional[Route]) -> KernelOutputs:
    if route is None:
        raise ValueError("no kernel takes this solve (kernel_route): "
                         "use the loop solver")
    if inp.alloc.device.type == "cuda":
        return _launch(inp, route)
    if inp.alloc.device.type != "cpu":
        raise ValueError(f"unsupported device {inp.alloc.device}")
    if route.kind == "block":
        return binpack_plain(inp)
    return binpack_sharded_plain(inp, route.shards)


def binpack(inp: KernelInputs) -> KernelOutputs:
    """Run the placement solve on the kernel :func:`kernel_route` names
    for these inputs: that kernel for CUDA tensors, its plain twin for
    CPU tensors. Every route gives the same outputs."""
    return _run(inp, route_of(inp))


def binpack_sharded(inp: KernelInputs, shards: int) -> KernelOutputs:
    """Run the cluster kernel at ``shards`` (2..16) CTAs, one node slice
    each (in shared memory when it fits, else the L2 form), for CUDA
    tensors; :func:`binpack_sharded_plain` for CPU tensors. Equal to
    :func:`binpack` on every output."""
    if not 2 <= shards <= MAX_SHARDS:
        raise ValueError(f"shards must be 2..{MAX_SHARDS}, got {shards}")
    return _run(inp, route_of(inp, shards))


class LaneInputs(NamedTuple):
    """K plain solves laid out for one lane-batched launch
    (:func:`binpack_lanes`): pod fields ``[K, P, ...]`` (a lane with
    fewer pods is padded with blocked pods), the node fields ``[B, N,
    ...]`` with ``B`` 1 (one base every lane reads) or K (a base per
    lane, a smaller world padded with unschedulable zero rows), and each
    lane's LoadAware verdicts, weights and weight sum."""

    req: torch.Tensor     # [K,P,8] int32, column 0 = BLOCKED_REQ for blocked pods
    est: torch.Tensor     # [K,P,8]
    flags: torch.Tensor   # [K,P,4]
    alloc: torch.Tensor   # [B,N,8]
    usage: torch.Tensor   # [B,N,8]
    sched: torch.Tensor   # [B,N]
    fresh: torch.Tensor   # [B,N]
    la_ok: torch.Tensor   # [K,N]
    weight: torch.Tensor  # [K,8]
    wsum: torch.Tensor    # [K] int32, Σ weight or 1 when that is 0
    used0: torch.Tensor   # [B,N,8]
    est0: torch.Tensor
    prod0: torch.Tensor


class LaneOutputs(NamedTuple):
    assign: torch.Tensor  # [K,P] int32, -1 = not placed
    used: torch.Tensor    # [K,N,8] carries after each lane's solve
    est: torch.Tensor
    prod: torch.Tensor


def lane_inputs(state: NodeState, pods: PodBatch,
                params: ScoreParams) -> LaneInputs:
    """Lay K plain solves out for :func:`binpack_lanes`: ``state``'s
    fields carry a leading base axis of 1 or K, ``pods``' and ``params``'
    a lane axis of K (:func:`kernel_inputs` per lane, stacked)."""
    k = pods.req.shape[0]
    upct = percent_rounded(state.usage, state.alloc)
    thr = params.thresholds[:, None, :]
    over = (state.alloc > 0) & (thr > 0) & (upct >= thr)
    req = pods.req.to(I32).clone()
    req[..., 0] = torch.where(pods.blocked, BLOCKED_REQ, req[..., 0])
    flags = torch.stack([
        (pods.is_daemonset & ~pods.blocked).to(I32),
        pods.is_prod.to(I32),
        pods.quota_id.to(I32),
        pods.non_preemptible.to(I32),
    ], dim=-1)
    weight = params.weights.to(I32)
    wsum = weight.sum(dim=1, dtype=I32)
    return LaneInputs(
        req=req, est=pods.est.to(I32).contiguous(), flags=flags.contiguous(),
        alloc=state.alloc.to(I32).contiguous(),
        usage=state.usage.to(I32).contiguous(),
        sched=state.schedulable.to(I32).contiguous(),
        fresh=state.metric_fresh.to(I32).contiguous(),
        la_ok=(~over.any(dim=-1)).to(I32).expand(k, -1).contiguous(),
        weight=weight.contiguous(),
        wsum=torch.where(wsum == 0, 1, wsum).to(I32).contiguous(),
        used0=state.used_req.to(I32).contiguous(),
        est0=state.est_extra.to(I32).contiguous(),
        prod0=state.prod_base.to(I32).contiguous())


def lane_route(inp: LaneInputs) -> Optional[Route]:
    """The route of a lane batch, one for every lane: :func:`kernel_route`
    of the plain solve at the lanes' node count."""
    return kernel_route(int(inp.alloc.shape[1]))


def lane(inp: LaneInputs, i: int) -> KernelInputs:
    """Lane ``i`` of a lane batch as the inputs of one solve."""
    b = i if inp.alloc.shape[0] > 1 else 0
    return KernelInputs(
        req=inp.req[i], est=inp.est[i], flags=inp.flags[i],
        alloc=inp.alloc[b], usage=inp.usage[b], sched=inp.sched[b],
        fresh=inp.fresh[b], la_ok=inp.la_ok[i], weight=inp.weight[i],
        wsum=int(inp.wsum[i]), used0=inp.used0[b], est0=inp.est0[b],
        prod0=inp.prod0[b])


def binpack_lanes_plain(inp: LaneInputs,
                        route: Optional[Route] = None) -> LaneOutputs:
    """The lane launch's plain version: the plain version of the kernel
    ``route`` names (:func:`lane_route` unless given) run lane by lane."""
    route = lane_route(inp) if route is None else route
    shards = 1 if route.kind == "block" else route.shards
    outs = [_plain(lane(inp, i), shards) for i in range(inp.req.shape[0])]
    return LaneOutputs(*(torch.stack([getattr(o, f) for o in outs])
                         for f in LaneOutputs._fields))


def _launch_lanes(inp: LaneInputs, route: Route) -> LaneOutputs:
    """One launch of the kernel ``route`` names with the lanes along the
    grid's y axis, on the inputs' device and current stream."""
    dev = inp.alloc.device
    k, p = inp.req.shape[:2]
    b, n = inp.alloc.shape[:2]
    if not (0 < n <= MAX_NODES and p > 0 and 0 < k <= 65535):
        raise ValueError(f"the lane kernel needs 1..{MAX_NODES} nodes, pods "
                         f"and 1..65,535 lanes, got {n} nodes, {p} pods, "
                         f"{k} lanes")
    if b not in (1, k):
        raise ValueError(f"{b} bases for {k} lanes: one, or one per lane")
    for name, shape in (("req", (k, p, R)), ("est", (k, p, R)),
                        ("flags", (k, p, 4)), ("alloc", (b, n, R)),
                        ("usage", (b, n, R)), ("sched", (b, n)),
                        ("fresh", (b, n)), ("la_ok", (k, n)),
                        ("weight", (k, R)), ("wsum", (k,)),
                        ("used0", (b, n, R)), ("est0", (b, n, R)),
                        ("prod0", (b, n, R))):
        _check(name, getattr(inp, name), shape, dev)
    lib = _library()
    flat = KernelInputs(req=inp.req.reshape(k * p, R),
                        est=inp.est.reshape(k * p, R),
                        flags=inp.flags.reshape(k * p, 4), alloc=None,
                        usage=None, sched=None, fresh=None, la_ok=None,
                        weight=None, wsum=0, used0=None, est0=None,
                        prod0=None)
    rec = pod_records(flat)
    assign = torch.empty((k, p), dtype=I32, device=dev)
    used, est, prod = (torch.empty((k, n, R), dtype=I32, device=dev)
                       for _ in range(3))
    args = (rec.data_ptr(), p, rec.shape[1], route.chunk,
            inp.alloc.data_ptr(), inp.usage.data_ptr(), inp.sched.data_ptr(),
            inp.fresh.data_ptr(), inp.la_ok.data_ptr(), n,
            inp.weight.data_ptr(), inp.wsum.data_ptr(),
            inp.used0.data_ptr(), inp.est0.data_ptr(), inp.prod0.data_ptr(),
            assign.data_ptr(), used.data_ptr(), est.data_ptr(),
            prod.data_ptr(), k, int(b > 1))
    if route.kind == "block":
        rc = _on_device(dev, lambda stream: lib.binpack_lanes_launch(
            *args, route.smem, stream))
    else:
        work = (torch.empty(k * route.work, dtype=torch.uint8, device=dev)
                if route.kind == "l2" else None)
        rc = _on_device(dev, lambda stream: lib.binpack_cluster_lanes_launch(
            *args, route.shards, route.n_loc, int(route.kind == "cluster"),
            _ptr(work), route.work, route.smem, stream))
    if rc != 0:
        raise _cuda_error(lib, f"binpack lane kernel launch ({k} lanes, "
                          f"{route.kind}, {route.shards} CTAs a lane)", rc)
    _count("lanes")
    return LaneOutputs(assign, used, est, prod)


def binpack_lanes(inp: LaneInputs) -> LaneOutputs:
    """K plain solves as one launch of the kernel :func:`lane_route`
    names, lane ``i`` on ``blockIdx.y == i``, for CUDA tensors; the plain
    version lane by lane for CPU tensors. Lane ``i``'s outputs equal
    :func:`binpack` of :func:`lane` ``(inp, i)``. A batch whose lanes all
    have no pods launches nothing: each lane's carries are its base's."""
    route = lane_route(inp)
    if route is None:
        raise ValueError("no kernel takes this solve (kernel_route): "
                         "use the loop solver")
    k, p = inp.req.shape[:2]
    if p == 0:
        def carry(t):
            return t.expand(k, -1, -1).clone()

        return LaneOutputs(inp.req.new_zeros((k, 0)), carry(inp.used0),
                           carry(inp.est0), carry(inp.prod0))
    if inp.alloc.device.type == "cuda":
        return _launch_lanes(inp, route)
    if inp.alloc.device.type != "cpu":
        raise ValueError(f"unsupported device {inp.alloc.device}")
    return binpack_lanes_plain(inp, route)


def cluster_occupancy(shards: int, device) -> int:
    """How many clusters of ``shards`` CTAs of the cluster kernel can be
    resident on the CUDA ``device`` at once, the least over its instances
    and both forms at the most shared memory a CTA may ask for
    (``cudaOccupancyMaxActiveClusters``). Raises with CUDA's message when
    the query fails."""
    lib = _library()

    def query(_stream):
        least = None
        for resident in (1, 0):
            for resv, numa, most in VARIANTS:
                count = ctypes.c_int(0)
                rc = lib.binpack_cluster_occupancy(
                    shards, resident, resv, numa, most, SMEM_BYTES,
                    ctypes.byref(count))
                if rc != 0:
                    raise _cuda_error(lib, "cluster occupancy query", rc)
                least = (count.value if least is None
                         else min(least, count.value))
        return least

    return _on_device(torch.device(device), query)


def quota_inputs(quota_state) -> Optional[tuple]:
    """The kernel's quota operands ``(min, runtime, used, np_used)``,
    the runtime water-filled once per solve; None without quotas."""
    if quota_state is None:
        return None
    return (quota_state.min, quota_runtime(quota_state), quota_state.used,
            quota_state.np_used)


def kernel_result(state: NodeState, out: KernelOutputs, pods: PodBatch,
                  quota_state=None, gang_state=None, numa: bool = False,
                  resv: bool = False) -> SolveResult:
    """A solve's result from the kernel's outputs: the carries into
    ``state`` (and ``numa_free`` with ``numa``) and ``quota_state``, then
    the batch-end gang epilogue (with the reservation consumption when
    ``resv``)."""
    node_state = state._replace(used_req=out.used, est_extra=out.est,
                                prod_base=out.prod)
    if numa:
        node_state = node_state._replace(numa_free=out.nfree)
    if quota_state is not None:
        quota_state = quota_state._replace(used=out.qused, np_used=out.qnp)
    resv_out = (out.vstar, out.delta, out.rem, out.rfree) if resv else None
    consumed = out.consumed > 0 if numa else None
    return resolve_gangs(node_state, quota_state, out.assign, pods, gang_state,
                         resv_out, consumed)


def kernel_solve_batch(state: NodeState, pods: PodBatch, params: ScoreParams,
                       quota_state=None, gang_state=None,
                       wsum: Optional[int] = None,
                       numa_aux: Optional[NumaAux] = None,
                       resv: Optional[ResvArrays] = None,
                       most_allocated: bool = False,
                       resv_score_checked: bool = False,
                       extras: Optional[ExtrasRows] = None,
                       extras_score_checked: bool = False) -> SolveResult:
    """The kernel path of a solve: quota runtime (water-filled once per
    solve), the kernel, then the batch-end gang epilogue. Equal to
    ``ops/binpack.solve_batch`` on every configuration
    :func:`kernel_supported` accepts (``most_allocated`` is the
    config's ``numa_most_allocated``); the caller routes with that gate
    and :func:`kernel_routing_ok` (``PlacementModel`` checks the first
    once per model, the second per solve), and the kernel wrapper checks
    the shapes it is given. A reservation table whose credit could
    overflow the packed key's score budget raises, unless the caller
    checked it already (``resv_score_checked``); so does an extras table
    (``ExtrasRows``) with a score outside [0, 100] or past the budget,
    unless checked already (``extras_score_checked``)."""
    if resv is not None and not resv_score_checked and not (
            kernel_resv_score_safe(resv.node, resv.free, state.alloc)):
        raise ValueError("reservation credit could overflow the packed "
                         "key's 15-bit score budget: use the loop solver")
    if extras is not None and not extras_score_checked:
        worst = (BASE_SCORE_WORST if resv is None
                 else resv_score_worst(resv.node, resv.free, state.alloc))
        if not kernel_extras_score_safe(extras.score.cpu().numpy(), worst):
            raise ValueError("an extras score outside [0, 100] or past the "
                             "packed key's score budget: use the loop "
                             "solver")
    config = program_config(state, params, quota_state, numa_aux, resv,
                            most_allocated, wsum)
    return solve_program(state, pods, params, config, quota_state,
                         gang_state, numa_aux, resv, extras)


# -- the device programs (service/warmpool.py captures them) --------------

class ProgramConfig(NamedTuple):
    """The static half of a solve program's call: what the host decides
    before the device work (the route and its CTA count, the weight sum
    read back from the params, the NUMA scorer). A warm-pool entry is
    keyed by it and captured with it."""

    route: Route
    wsum: int
    most_allocated: bool


def program_config(state: NodeState, params: ScoreParams, quota_state=None,
                   numa_aux: Optional[NumaAux] = None,
                   resv: Optional[ResvArrays] = None,
                   most_allocated: bool = False,
                   wsum: Optional[int] = None) -> ProgramConfig:
    """:class:`ProgramConfig` of a kernel solve (:func:`kernel_route` of
    its sizes, :func:`weight_sum` of ``params`` unless given)."""
    route = kernel_route(
        int(state.alloc.shape[0]), numa_aux is not None,
        0 if resv is None else int(resv.free.shape[0]),
        0 if quota_state is None else int(quota_state.min.shape[0]))
    return ProgramConfig(route, weight_sum(params) if wsum is None else wsum,
                         bool(most_allocated))


def with_runtime(quota_state):
    """``quota_state`` with its runtime water-filled now (a loop that
    reads back, so never inside a device program), or None."""
    if quota_state is None or quota_state.runtime is not None:
        return quota_state
    return quota_state._replace(runtime=quota_runtime(quota_state))


def solve_program(state: NodeState, pods: PodBatch, params: ScoreParams,
                  config: ProgramConfig, quota_state=None, gang_state=None,
                  numa_aux: Optional[NumaAux] = None,
                  resv: Optional[ResvArrays] = None,
                  extras: Optional[ExtrasRows] = None) -> SolveResult:
    """The kernel path of a solve as device work alone: the inputs' layout,
    the kernel ``config.route`` names (its plain twin on CPU tensors),
    the epilogue. With the quota runtime given (:func:`with_runtime`) it
    reads nothing back, so a CUDA graph can hold it."""
    # binpack() routes by the same sizes as config.route
    out = binpack(kernel_inputs(state, pods, params, quota_inputs(quota_state),
                                config.wsum, numa_aux, resv,
                                config.most_allocated, extras))
    return kernel_result(state, out, pods, quota_state, gang_state,
                         numa_aux is not None, resv is not None)


def lanes_program(inp: LaneInputs, route: Route) -> LaneOutputs:
    """A lane batch (:func:`binpack_lanes`, which routes by the same
    sizes as ``route``, :func:`lane_route`)."""
    return binpack_lanes(inp)


def lanes_assign_program(inp: LaneInputs, route: Route) -> torch.Tensor:
    """:func:`lanes_program`'s ``assign`` alone."""
    return lanes_program(inp, route).assign


def program_kind(config) -> str:
    """The :data:`LAUNCHES` key of a program's kernel: a lane program's
    config is its :class:`Route`, a solve program's a
    :class:`ProgramConfig`."""
    return "lanes" if isinstance(config, Route) else config.route.kind


def run_solve(binding, state: NodeState, pods: PodBatch, params: ScoreParams,
              quota_state=None, gang_state=None,
              numa_aux: Optional[NumaAux] = None,
              resv: Optional[ResvArrays] = None,
              extras: Optional[ExtrasRows] = None,
              most_allocated: bool = False,
              wsum: Optional[int] = None) -> SolveResult:
    """A routed kernel solve through ``binding`` (an ``obs/device``
    binding whose program is :func:`solve_program`): the host half first
    (the route, the weight sum, the quota runtime), then the binding.
    The result's quota state keeps the caller's runtime field."""
    config = program_config(state, params, quota_state, numa_aux, resv,
                            most_allocated, wsum)
    result = binding(state, pods, params, config, with_runtime(quota_state),
                     gang_state, numa_aux, resv, extras)
    if quota_state is not None and quota_state.runtime is None:
        result = result._replace(
            quota_state=result.quota_state._replace(runtime=None))
    return result
