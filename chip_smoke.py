"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit; builds the CUDA kernel
   library from ``koordinator_tpu_torch/csrc`` with nvcc.
2. Holds the placement kernel against its plain PyTorch twin on the card,
   bit for bit (assignments and every carry): the example problem at
   5,000 nodes x 10,000 pods, and 1,000 nodes with 5,000 pods in 50
   quota groups plus 200 gangs x 32 members.
3. The main path: ``PlacementModel().schedule`` on a seeded snapshot of
   5,000 nodes, 10,000 assigned pods with metrics and 10,000 pending pods
   in 50 quota groups and 200 gangs of 32. The kernel launch count is
   zeroed just before and read just after; the solve must go through the
   kernel, respect node capacity, and equal ``PlacementModel(device=
   "cpu")`` on an identical snapshot.
4. Holds and times the kernel against its twin on the main path's own
   kernel inputs, and prints one JSON line of kernels, then the result
   line ``{"ok": true, "device": {...}}`` last.

Every comparison prints the kernel's time (CUDA events, after a
warm-up), the twin's, and the bound (see :func:`bound`).

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis.types import resources_to_vector
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.quota import quota_runtime

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
#: scalar 32-bit operations per second outside the tensor cores (the
#: data sheet's float32 rate; int32 issues at no higher rate)
SCALAR_OPS_PER_S = 67e12
#: integer operations per (pod, node) pair the placement must do: per
#: resource, fit (add, compare, and), LeastAllocated and LoadAware terms
#: (2 adds for the estimate, 2 x (sub, mul, clamp, divide, compare,
#: select, weight mul, add)) = 21; then 2 divides, the score add, the
#: mask, the packed key (shift, or) and the max
OPS_PER_PAIR = 8 * 21 + 8

# the flagship burst (BASELINE.json north star) and BASELINE configs #3/#4
NODES, ASSIGNED_PER_NODE, PENDING = 5000, 2, 10000
QUOTA_NODES, QUOTA_PODS, QUOTAS, GANGS, GANG_SIZE = 1000, 5000, 50, 200, 32


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    err = 0
    for g, w, name in zip(got, want, got._fields):
        if g is None and w is None:
            continue
        if not bool((g == w).all()):
            raise AssertionError(f"kernel != plain twin on {name}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def bound(inp):
    """(bound_ms, bound_by): the larger of every input read once and every
    output written once at the memory rate, and the (pod, node) pairs
    this data needs at the scalar rate."""
    tensors = [inp.req, inp.est, inp.flags, inp.alloc, inp.usage, inp.sched,
               inp.fresh, inp.la_ok, inp.weight, inp.used0, inp.est0, inp.prod0]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += 4 * inp.req.shape[0] + 3 * inp.alloc.numel() * 4  # outputs
    if inp.quota is not None:
        nbytes += sum(q.numel() * 4 for q in inp.quota) + 2 * inp.quota[0].numel() * 4
    pairs = inp.req.shape[0] * int(inp.sched.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * OPS_PER_PAIR / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(inp, label, card, reps=3) -> dict:
    """Hold the kernel against its plain twin on ``inp`` (tolerance:
    exact, every output) and time both on the card: the kernel over
    ``reps`` launches after the comparison's launch as warm-up, the twin
    over its one comparison run."""
    got = bk.binpack(inp)
    torch.cuda.synchronize()
    want = []
    plain_ms = cuda_ms(lambda: want.append(bk.binpack_plain(inp)), 1)
    err = max_abs_err(got, want[0])
    ms = cuda_ms(lambda: bk.binpack(inp), reps)
    bound_ms, bound_by = bound(inp)
    placed = int((got.assign >= 0).sum())
    print(f"{label}: kernel == plain twin ({placed}/{inp.req.shape[0]} "
          f"placed, max_abs_err {err}) [{card}]: kernel {ms:.3f} ms, plain "
          f"twin {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def capacity_ok(snap, result) -> None:
    """Independent check: on every node, the assigned pods plus the
    committed and waiting placements fit its allocatable on each
    resource a placed pod requests."""
    alloc = {n.name: resources_to_vector(n.allocatable) for n in snap.nodes}
    load = {n: np.zeros_like(v) for n, v in alloc.items()}
    for pod in snap.pods:
        load[pod.node_name] += resources_to_vector(pod.requests)
    placed = {**{u: n for u, n in result.items() if n is not None},
              **result.waiting}
    by_uid = {p.uid: p for p in snap.pending_pods}
    for uid, node in placed.items():
        load[node] += resources_to_vector(by_uid[uid].requests)
    for uid, node in placed.items():
        req = resources_to_vector(by_uid[uid].requests)
        over = (req > 0) & (load[node] > alloc[node])
        assert not over.any(), f"{node} overcommitted"


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    lib = bk.build_library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 2. kernel vs plain twin on the card ---------------------------------
    errs = []
    state, pods, params = testing.example_problem(NODES, PENDING, seed=1)
    errs.append(compare(bk.kernel_inputs(state, pods, params),
                        f"plain {NODES} nodes x {PENDING} pods",
                        card)["max_abs_err"])
    state, pods, params, quota, _ = testing.quota_gang_problem(
        QUOTA_NODES, QUOTA_PODS, QUOTAS, GANGS, GANG_SIZE, seed=1)
    qin = (quota.min, quota_runtime(quota), quota.used, quota.np_used)
    errs.append(compare(bk.kernel_inputs(state, pods, params, qin),
                        f"quota+gang {QUOTA_NODES} nodes x "
                        f"{pods.req.shape[0]} pods ({QUOTAS} quotas, "
                        f"{GANGS} gangs x {GANG_SIZE})", card)["max_abs_err"])

    # -- 3. the main path ------------------------------------------------------
    def snapshot():
        snap = testing.churn_world(NODES, assigned_per_node=ASSIGNED_PER_NODE,
                                   seed=42)
        return testing.add_pending_wave(snap, PENDING, n_quota=QUOTAS,
                                        n_gangs=GANGS, gang_size=GANG_SIZE,
                                        seed=7)

    captured = []
    launch = bk.binpack

    def capture(inp):
        captured.append(inp)
        return launch(inp)

    snap = snapshot()
    model = PlacementModel()
    bk.binpack = capture
    bk.LAUNCHES = 0
    t0 = time.perf_counter()
    result = model.schedule(snap)
    wall = time.perf_counter() - t0
    launches = bk.LAUNCHES
    bk.binpack = launch
    assert model.last_solver == "kernel", model.last_solver
    assert launches > 0, "the main path did not launch the kernel"
    assert len(result) == PENDING
    committed = sum(n is not None for n in result.values())
    assert committed > 0
    capacity_ok(snap, result)
    cpu_model = PlacementModel(device="cpu")
    reference = cpu_model.schedule(snapshot())
    assert cpu_model.last_solver == "kernel"
    assert dict(result) == dict(reference), "cuda != cpu placements"
    assert result.waiting == reference.waiting
    tm = model.last_timings
    print(f"main path [{card}]: {NODES} nodes, {PENDING} pending: "
          f"{committed} committed, {len(result.waiting)} waiting; "
          f"lower_s {tm['lower_s']:.4f} stage_s {tm['stage_s']:.4f} "
          f"solve_s {tm['solve_s']:.4f} wall {wall:.4f} s = "
          f"{PENDING / wall:.1f} pending pods/s (n_pending / wall); "
          f"cuda == cpu; launches {launches}",
          flush=True)

    # -- 4. the kernel at the main path's inputs --------------------------------
    main = compare(captured[0], "binpack at the main path's inputs", card,
                   reps=5)
    main["max_abs_err"] = max(errs + [main["max_abs_err"]])
    print(json.dumps({"kernels": [{
        "name": "binpack",
        "route": "cuda",
        "source": "koordinator_tpu_torch/csrc/binpack.cu",
        "replaces": "koordinator_tpu/ops/pallas_binpack.py:93",
        "launches": launches,
        **main,
        "library_ms": None,
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
