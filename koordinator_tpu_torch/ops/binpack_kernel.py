"""The hand-written placement kernel: its wrapper, plain twin, gates and
epilogue.

Replaces ``koordinator_tpu/ops/pallas_binpack.py``: the Pallas kernel
``_make_kernel`` (plain and ``use_quota`` variants) becomes the CUDA C++
kernel in ``csrc/binpack.cu``; ``_pallas_solve``'s input layout becomes
:func:`kernel_inputs`; ``_solve_full``/``pallas_solve_batch`` become
:func:`kernel_solve_batch`; the gates ``pallas_supported`` and
``pallas_routing_ok`` become :func:`kernel_supported` and
:func:`kernel_routing_ok`; ``_kernel_epilogue`` is
``ops/binpack.resolve_gangs``, shared with the loop solver.

:func:`binpack` launches the kernel for CUDA tensors and runs
:func:`binpack_plain` for CPU tensors; nothing else selects between
them. The library is built with ``nvcc`` at first use, from
``csrc/binpack.cu`` only, into ``koordinator_tpu_torch/_build/`` (git
ignores it), and bound with ``ctypes``. A build or launch failure
raises; it never falls back to the plain twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from koordinator_tpu_torch.ops.binpack import (
    NodeState,
    PodBatch,
    ScoreParams,
    SolveResult,
    resolve_gangs,
)
from koordinator_tpu_torch.ops.common import I32, percent_rounded
from koordinator_tpu_torch.ops.quota import quota_runtime

#: kernel launches since import: the count that shows a run went
#: through the kernel (one per ``binpack`` call on CUDA tensors)
LAUNCHES = 0

#: the packed argmax key carries the node index in 16 bits
MAX_NODES = 65536

#: request written into column 0 of a host-blocked pod so it never fits
BLOCKED_REQ = 1 << 30

R = 8

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "csrc" / "binpack.cu"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIB = None
_LIB_LOCK = threading.Lock()


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


class KernelOutputs(NamedTuple):
    assign: torch.Tensor           # [P] int32, -1 = not placed
    used: torch.Tensor             # [N,8] int32 carries after the solve
    est: torch.Tensor
    prod: torch.Tensor
    qused: Optional[torch.Tensor]  # [Q,8] int32, None without quotas
    qnp: Optional[torch.Tensor]


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


def kernel_routing_ok(state: NodeState, pods: PodBatch, extras) -> bool:
    """Per-solve eligibility: no host extras, 1..65536 nodes (the packed
    key's 16 node bits), at least one pod."""
    n = int(state.alloc.shape[0])
    return extras is None and 0 < n <= MAX_NODES and pods.req.shape[0] > 0


def weight_sum(params: ScoreParams) -> int:
    """Σ resource weight, or 1 when that is 0: the divisor of the score
    sums (one read-back; fixed for a model's lifetime)."""
    return int(params.weights.sum(dtype=I32)) or 1


def kernel_inputs(state: NodeState, pods: PodBatch, params: ScoreParams,
                  quota=None, wsum: Optional[int] = None) -> KernelInputs:
    """Lay the solve out for the kernel: precompute the LoadAware filter
    verdict per node, pack the per-pod flags, and encode host-blocked
    pods as unplaceable. ``quota`` is None or (min, runtime, used,
    np_used); ``wsum`` is :func:`weight_sum` of ``params``, read from them
    when not given."""
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
    )


def binpack_plain(inp: KernelInputs) -> KernelOutputs:
    """The kernel's plain twin: the same per-pod computation as
    ``csrc/binpack.cu`` as a torch loop, on any device. Used by the CPU
    path and held against the kernel on the card."""
    alloc, usage = inp.alloc, inp.usage
    alloc_safe = torch.clamp(alloc, min=1)
    alloc_zero = alloc == 0
    sched, fresh = inp.sched > 0, inp.fresh > 0
    la_ok = inp.la_ok > 0
    lane_key = 65535 - torch.arange(alloc.shape[0], dtype=I32,
                                    device=alloc.device)
    weight, wsum = inp.weight, inp.wsum
    used, estx, prod = inp.used0.clone(), inp.est0.clone(), inp.prod0.clone()
    quota = inp.quota is not None
    if quota:
        qmin, qrt, qused, qnp = inp.quota
        qused, qnp = qused.clone(), qnp.clone()

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
        requested = used + req_v
        fit = sched & ((req_v == 0) | (requested <= alloc)).all(dim=-1)
        s2 = torch.where(fresh, score(usage + estx + est_v), 0)
        mask = fit & (is_ds | ~fresh | la_ok)
        if quota:
            qid = inp.flags[p, 2]
            non_pre = inp.flags[p, 3] > 0
            q = torch.clamp(qid, min=0).reshape(1).long()
            sel = req_v > 0
            viol = (sel & (qused.index_select(0, q)[0] + req_v
                           > qrt.index_select(0, q)[0])).any()
            viol_np = (sel & non_pre & (qnp.index_select(0, q)[0] + req_v
                                        > qmin.index_select(0, q)[0])).any()
            mask = mask & ((qid < 0) | ~(viol | viol_np))
        packed = torch.where(mask, ((score(requested) + s2) << 16) | lane_key,
                             -1)
        m = packed.max()
        ok = m >= 0
        best = (65535 - (m & 65535)).reshape(1).long()
        nodes.append(torch.where(ok, best[0], -1).to(I32))
        add_req = torch.where(ok, req_v, 0)[None, :]
        add_est = torch.where(ok, est_v, 0)[None, :]
        used = used.index_add(0, best, add_req)
        estx = estx.index_add(0, best, add_est)
        prod = prod.index_add(0, best, torch.where(is_prod, add_est, 0))
        if quota:
            addq = torch.where(sel & ok & (qid >= 0), req_v, 0)[None, :]
            qused = qused.index_add(0, q, addq)
            qnp = qnp.index_add(0, q, torch.where(non_pre, addq, 0))
    assign = (torch.stack(nodes) if nodes
              else torch.empty(0, dtype=I32, device=alloc.device))
    return KernelOutputs(assign, used, estx, prod,
                         qused if quota else None, qnp if quota else None)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build_library() -> Path:
    """Compile ``csrc/binpack.cu`` into a shared library named by the
    source's hash (an unchanged source is not rebuilt). Returns its
    path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libbinpack-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.binpack_launch.argtypes = (
                [ptr, ptr, ptr, i32,              # req, est, flags, P
                 ptr, ptr, ptr, ptr, ptr, i32,    # alloc..la_ok, N
                 ptr, i32,                        # weight, wsum
                 ptr, ptr, ptr,                   # used0, est0, prod0
                 ptr, ptr, ptr, ptr, i32,         # quota in, Q
                 ptr, ptr, ptr, ptr, ptr, ptr,    # outputs
                 ptr])                            # stream
            lib.binpack_launch.restype = i32
            lib.binpack_error_string.argtypes = [i32]
            lib.binpack_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != I32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _launch(inp: KernelInputs) -> KernelOutputs:
    global LAUNCHES
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
    lib = _library()
    assign = torch.empty(p, dtype=I32, device=dev)
    used, est, prod = (torch.empty_like(inp.alloc) for _ in range(3))
    qused = qnp = None
    qptrs = [None] * 4
    if quota is not None:
        qused, qnp = torch.empty_like(quota[0]), torch.empty_like(quota[0])
        qptrs = [t.data_ptr() for t in quota]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.binpack_launch(
            inp.req.data_ptr(), inp.est.data_ptr(), inp.flags.data_ptr(), p,
            inp.alloc.data_ptr(), inp.usage.data_ptr(), inp.sched.data_ptr(),
            inp.fresh.data_ptr(), inp.la_ok.data_ptr(), n,
            inp.weight.data_ptr(), inp.wsum,
            inp.used0.data_ptr(), inp.est0.data_ptr(), inp.prod0.data_ptr(),
            *qptrs, q,
            assign.data_ptr(), used.data_ptr(), est.data_ptr(),
            prod.data_ptr(),
            qused.data_ptr() if qused is not None else None,
            qnp.data_ptr() if qnp is not None else None,
            stream,
        )
    if rc != 0:
        msg = lib.binpack_error_string(rc).decode()
        raise RuntimeError(f"binpack kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return KernelOutputs(assign, used, est, prod, qused, qnp)


def binpack(inp: KernelInputs) -> KernelOutputs:
    """Run the placement kernel: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    if inp.alloc.device.type == "cuda":
        return _launch(inp)
    if inp.alloc.device.type != "cpu":
        raise ValueError(f"unsupported device {inp.alloc.device}")
    return binpack_plain(inp)


def kernel_solve_batch(state: NodeState, pods: PodBatch, params: ScoreParams,
                       quota_state=None, gang_state=None,
                       wsum: Optional[int] = None) -> SolveResult:
    """The kernel path of a solve: quota runtime (water-filled once per
    solve), the kernel, then the batch-end gang epilogue. Equal to
    ``ops/binpack.solve_batch`` on every configuration
    :func:`kernel_supported` accepts; the caller routes with that gate
    and :func:`kernel_routing_ok` (``PlacementModel`` checks the first
    once per model, the second per solve), and the kernel wrapper checks
    the shapes it is given."""
    quota = None
    if quota_state is not None:
        quota = (quota_state.min, quota_runtime(quota_state),
                 quota_state.used, quota_state.np_used)
    out = binpack(kernel_inputs(state, pods, params, quota, wsum))
    node_state = state._replace(used_req=out.used, est_extra=out.est,
                                prod_base=out.prod)
    if quota_state is not None:
        quota_state = quota_state._replace(used=out.qused, np_used=out.qnp)
    return resolve_gangs(node_state, quota_state, out.assign, pods, gang_state)
