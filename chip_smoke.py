"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit; builds the CUDA kernel
   library from ``koordinator_tpu_torch/csrc`` with nvcc and prints
   ptxas's registers and spills for each kernel variant.
2. Holds the placement kernel against its plain PyTorch twin on the card,
   bit for bit (assignments and every carry): the example problem at
   5,000 nodes x 10,000 pods, and 1,000 nodes with 5,000 pods in 50
   quota groups plus 200 gangs x 32 members.
3. The main path: ``PlacementModel().schedule`` on a seeded snapshot of
   5,000 nodes, 10,000 assigned pods with metrics and 10,000 pending pods
   in 50 quota groups and 200 gangs of 32. The kernel launch count is
   zeroed just before and read just after; the solve must go through the
   kernel, respect node capacity, and equal ``PlacementModel(device=
   "cpu")`` on an identical snapshot. A second run on a fresh model
   prints the timings of a process whose torch kernels are loaded.
4. Holds and times the kernel against its twin on the main path's own
   kernel inputs.
5. The reservation main path: phase 3's snapshot plus 256 Available
   reservations (200 owned by gang label, 56 migration reservations
   naming one solo pending pod each). ``PlacementModel().schedule`` must
   go through the kernel's ``use_resv`` variant, consume reservations,
   respect node capacity with the remaining holds counted, and equal the
   CPU run: placements, waiting pods, consumption records and every
   mutated ``ReservationSpec``. The kernel is then held against its twin
   on that solve's inputs and timed.
6. The fused solve of the reference's bench config #8 (quota, Strict
   gangs, NUMA, reservations) at 5,000 nodes x 10,000 pods, with the
   NUMA least- and most-allocated scorers: ``kernel_solve_batch`` routed
   by ``kernel_routing_ok``, the kernel held against its twin on every
   output, and the whole kernel solve held against the loop
   ``solve_batch`` on the card at 1,000 x 2,000 (the loop runs a few
   dozen torch ops per pod).
7. The node-sharded kernel (``csrc/binpack_cluster.cu``: k CTAs of one
   thread-block cluster, one node shard each) through
   ``parallel/mesh.shard_kernel_solver(k)``, for k in 2, 4, 8, 16, at
   the main path's solve (phase 3) and at config #8 with NUMA least and
   reservations (phase 6): each solve driven with the cluster launch
   count zeroed just before and read just after, held bit for bit
   against the one-block kernel's solve (every output) and its kernel
   (every kernel output), and timed against it in the same process.
   At the fastest k the cluster kernel is held against its plain twin
   ``binpack_sharded_plain`` at full size; the twin also checks it at
   k = 8 on phase 2's quota+gang problem (1,000 nodes) and at k = 4 on
   config #8 cut to 1,000 x 2,000 with NUMA most. Then one JSON line of
   kernels, and the result line ``{"ok": true, "device": {...}}`` last.

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
from koordinator_tpu_torch.apis.types import ReservationState, resources_to_vector
from koordinator_tpu_torch.models import placement
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import SolverConfig, solve_batch
from koordinator_tpu_torch.ops.quota import quota_runtime
from koordinator_tpu_torch.parallel.mesh import shard_kernel_solver
from koordinator_tpu_torch.scheduler.plugins.reservation import reservation_free

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
#: more per (pod, node) pair with NUMA: per resource the requested test,
#: the count, nreq (sub, add), cap > 0, nreq <= cap, and, the numerator
#: (sub), * 100, divide, the sum (11); then the divide, the count test
#: and the add into the score
NUMA_OPS_PER_PAIR = 8 * 11 + 3
#: per (pod, reservation) pair: the match test; per matched pair the 8
#: subtractions of the credit
CREDIT_OPS_PER_MATCH = 8

# the flagship burst (BASELINE.json north star) and BASELINE configs #3/#4
NODES, ASSIGNED_PER_NODE, PENDING = 5000, 2, 10000
QUOTA_NODES, QUOTA_PODS, QUOTAS, GANGS, GANG_SIZE = 1000, 5000, 50, 200, 32
# phase 5: reservations owned by gang label, and migration reservations
LABEL_RESV, MIGRATION_RESV = 200, 56
# phase 6: bench config #8 at its own shape; the loop comparison's cut
FUSED_NODES, FUSED_PODS = 5000, 10000
LOOP_NODES, LOOP_PODS = 1000, 2000
# phase 7: CTAs of the cluster kernel; the reduced checks' shard counts
SHARDS = (2, 4, 8, 16)
QUOTA_SHARDS, LOOP_SHARDS = 8, 4

SOURCE = "koordinator_tpu_torch/csrc/binpack.cu"
CLUSTER_SOURCE = "koordinator_tpu_torch/csrc/binpack_cluster.cu"
REPLACES = "koordinator_tpu/ops/pallas_binpack.py"


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
    output written once at the memory rate, and the operations this
    data needs at the scalar rate: the (pod, schedulable node) pairs,
    with the NUMA terms when NUMA is on, plus one match test per (pod,
    reservation) pair and the credit's subtractions per matched pair."""
    tensors = [t for x in inp if isinstance(x, (torch.Tensor, tuple))
               for t in (x if isinstance(x, tuple) else (x,))]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    p, n = inp.req.shape[0], inp.alloc.shape[0]
    out_words = p + 3 * n * 8                          # assign, carries
    if inp.quota is not None:
        out_words += 2 * inp.quota[0].numel()          # qused, qnp
    if inp.numa is not None:
        out_words += n * 8 + p                         # numa_free, consumed
    per_pair = OPS_PER_PAIR
    if inp.numa is not None:
        per_pair += NUMA_OPS_PER_PAIR
    ops = p * int(inp.sched.sum()) * per_pair
    if inp.resv is not None:
        match = inp.resv[4]
        out_words += p + 2 * p * 8 + inp.resv[0].numel()  # vstar, delta, rem, free
        ops += match.numel() + CREDIT_OPS_PER_MATCH * int(match.sum())
    nbytes += 4 * out_words
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
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
    """Independent check: on every node, the assigned pods, the holds of
    the reservations still Available after the solve, and the committed
    and waiting placements fit its allocatable on each resource a placed
    pod requests."""
    alloc = {n.name: resources_to_vector(n.allocatable) for n in snap.nodes}
    load = {n: np.zeros_like(v) for n, v in alloc.items()}
    for pod in snap.pods:
        load[pod.node_name] += resources_to_vector(pod.requests)
    for resv in snap.reservations:
        if resv.state == ReservationState.AVAILABLE and resv.node_name in load:
            load[resv.node_name] += reservation_free(resv)
    placed = {**{u: n for u, n in result.items() if n is not None},
              **result.waiting}
    by_uid = {p.uid: p for p in snap.pending_pods}
    for uid, node in placed.items():
        load[node] += resources_to_vector(by_uid[uid].requests)
    for uid, node in placed.items():
        req = resources_to_vector(by_uid[uid].requests)
        over = (req > 0) & (load[node] > alloc[node])
        assert not over.any(), f"{node} overcommitted"


def drive(run, wrapper="binpack", counter="LAUNCHES"):
    """Run one path with every kernel input it hands ``bk.<wrapper>``
    captured, the launch count ``bk.<counter>`` zeroed just before and
    read just after (a device synchronise ends the timed span). Returns
    ``(result, launches, wall_s, captured inputs)``."""
    captured = []
    launch = getattr(bk, wrapper)

    def capture(inp, *args):
        captured.append(inp)
        return launch(inp, *args)

    setattr(bk, wrapper, capture)
    try:
        setattr(bk, counter, 0)
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = getattr(bk, counter)
    finally:
        setattr(bk, wrapper, launch)
    return result, launches, wall, captured


def _specs(snap):
    return [(r.name, r.allocated, r.allocated_pod_uids, r.state)
            for r in snap.reservations]


def _records(book):
    return {uid: (name, delta.tolist()) for uid, (name, delta) in book.items()}


def schedule_path(snapshot, label, card):
    """``PlacementModel().schedule`` on ``snapshot()`` through the kernel,
    checked: every pod decided, some committed, node capacity respected,
    and equal to ``PlacementModel(device="cpu")`` on an identical
    snapshot (placements, waiting pods, reservation records and specs).
    Returns ``(result, launches, captured kernel inputs)``."""
    snap = snapshot()
    model = PlacementModel()
    result, launches, wall, captured = drive(lambda: model.schedule(snap))
    assert model.last_solver == "kernel", model.last_solver
    assert launches > 0, f"{label} did not launch the kernel"
    assert len(result) == len(snap.pending_pods)
    committed = sum(n is not None for n in result.values())
    assert committed > 0
    capacity_ok(snap, result)
    cpu_model = PlacementModel(device="cpu")
    cpu_snap = snapshot()
    reference = cpu_model.schedule(cpu_snap)
    assert cpu_model.last_solver == "kernel"
    assert dict(result) == dict(reference), "cuda != cpu placements"
    assert result.waiting == reference.waiting
    assert _records(result.resv_allocs) == _records(reference.resv_allocs)
    assert (_records(result.resv_committed)
            == _records(reference.resv_committed))
    assert _specs(snap) == _specs(cpu_snap), "cuda != cpu reservations"
    tm = model.last_timings
    print(f"{label} [{card}]: {len(snap.nodes)} nodes, "
          f"{len(snap.pending_pods)} pending: {committed} committed, "
          f"{len(result.waiting)} waiting; lower_s {tm['lower_s']:.4f} "
          f"stage_s {tm['stage_s']:.4f} solve_s {tm['solve_s']:.4f} wall "
          f"{wall:.4f} s = {len(snap.pending_pods) / wall:.1f} pending pods/s "
          f"(n_pending / wall); cuda == cpu; launches {launches}", flush=True)
    warm = PlacementModel()
    warm_snap = snapshot()
    t0 = time.perf_counter()
    warm.schedule(warm_snap)
    wall = time.perf_counter() - t0
    tm = warm.last_timings
    print(f"{label}, a second run on a fresh model [{card}]: lower_s "
          f"{tm['lower_s']:.4f} stage_s {tm['stage_s']:.4f} solve_s "
          f"{tm['solve_s']:.4f} wall {wall:.4f} s = "
          f"{len(warm_snap.pending_pods) / wall:.1f} pending pods/s",
          flush=True)
    return result, launches, captured


def same_solve(got, want) -> None:
    """Two SolveResults equal on every tensor, the node and quota states
    included (tolerance: exact)."""
    for name, g, w in zip(want._fields, got, want):
        if w is None:
            assert g is None, name
        elif isinstance(w, tuple):
            same_solve(g, w)
        else:
            assert torch.equal(g, w), f"kernel solve != loop solve on {name}"


def loop_check(most, card) -> None:
    """The whole kernel solve (the kernel and the gang epilogue) against
    the loop ``solve_batch`` on the card, on bench config #8 cut to
    LOOP_NODES x LOOP_PODS."""
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        LOOP_NODES, LOOP_PODS, seed=8)
    got = []
    ms = cuda_ms(lambda: got.append(bk.kernel_solve_batch(
        s_, p_, pr, q, g, numa_aux=aux, resv=rv, most_allocated=most)), 1)
    want = []
    loop_ms = cuda_ms(lambda: want.append(solve_batch(
        s_, p_, pr, SolverConfig(numa_most_allocated=most), q, g, resv=rv,
        numa=aux)), 1)
    same_solve(got[0], want[0])
    print(f"kernel_solve_batch == loop solve_batch, config #8 cut to "
          f"{LOOP_NODES} nodes x {LOOP_PODS} pods, NUMA "
          f"{'most' if most else 'least'} [{card}]: "
          f"{int(got[0].commit.sum())} committed; kernel solve {ms:.3f} ms, "
          f"loop {loop_ms:.3f} ms", flush=True)


def main_path_solve_args(snapshot):
    """The arguments ``PlacementModel().schedule(snapshot())`` hands
    ``kernel_solve_batch``: ``(args, kwargs)``."""
    calls = []
    solve = placement.kernel_solve_batch

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return solve(*args, **kwargs)

    placement.kernel_solve_batch = record
    try:
        PlacementModel().schedule(snapshot())
    finally:
        placement.kernel_solve_batch = solve
    assert len(calls) == 1, len(calls)
    return calls[0]


def trimmed(out, n):
    """Kernel outputs with the node axis cut to the first ``n`` rows."""
    return out._replace(**{f: getattr(out, f)[:n]
                           for f in ("used", "est", "prod", "nfree")
                           if getattr(out, f) is not None})


def compare_sharded(inp, shards, label, card, reps=3) -> dict:
    """Hold the cluster kernel against its plain twin on ``inp`` at
    ``shards`` CTAs (tolerance: exact, every output) and time both, as
    :func:`compare` does for the one-block kernel."""
    got = bk.binpack_sharded(inp, shards)
    torch.cuda.synchronize()
    want = []
    plain_ms = cuda_ms(
        lambda: want.append(bk.binpack_sharded_plain(inp, shards)), 1)
    err = max_abs_err(got, want[0])
    ms = cuda_ms(lambda: bk.binpack_sharded(inp, shards), reps)
    print(f"{label}, {shards} CTAs: cluster kernel == plain twin "
          f"({int((got.assign >= 0).sum())}/{inp.req.shape[0]} placed, "
          f"max_abs_err {err}) [{card}]: kernel {ms:.3f} ms, plain twin "
          f"{plain_ms:.3f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def cluster_path(label, name, solve_one, sharded_solver, card) -> dict:
    """Phase 7 at one input: ``solve_one()`` is the one-block kernel's
    solve, ``sharded_solver(k)`` the solve through
    ``shard_kernel_solver(k)``. For each k in SHARDS, the sharded solve
    is driven with the cluster launch count zeroed, held against the
    one-block solve on every output and its kernel against the one-block
    kernel on every kernel output, and both kernels are timed (5
    launches after a warm-up, CUDA events, in turns). At the fastest k
    the cluster kernel is held against its plain twin. Returns the
    ``kernels`` entry."""
    want, _, _, single_in = drive(solve_one)
    single = bk.binpack(single_in[0])
    n = single_in[0].alloc.shape[0]
    bound_ms, bound_by = bound(single_in[0])
    runs = {}
    for k in SHARDS:
        got, launches, wall, captured = drive(
            lambda: sharded_solver(k), "binpack_sharded", "CLUSTER_LAUNCHES")
        assert launches == 1, f"{label}: {launches} cluster launches, k={k}"
        same_solve(got, want)
        inp = captured[0]
        err = max_abs_err(trimmed(bk.binpack_sharded(inp, k), n), single)
        one_ms = cuda_ms(lambda: bk.binpack(single_in[0]), 5)
        ms = cuda_ms(lambda: bk.binpack_sharded(inp, k), 5)
        one_ms = (one_ms + cuda_ms(lambda: bk.binpack(single_in[0]), 5)) / 2
        runs[k] = dict(launches=launches, max_abs_err=err, ms=ms, inp=inp)
        print(f"{label}, {k} CTAs [{card}]: shard_kernel_solver == one-block "
              f"kernel solve (every output), cluster kernel == one-block "
              f"kernel (max_abs_err {err}); cluster kernel {ms:.3f} ms "
              f"({ms / inp.req.shape[0] * 1e3:.3f} us/pod), one-block "
              f"kernel {one_ms:.3f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}); solve wall {wall:.4f} s; launches {launches}",
              flush=True)
    k = min(runs, key=lambda x: runs[x]["ms"])
    best = runs[k]
    twin = compare_sharded(best["inp"], k, f"{label}, full size", card,
                           reps=5)
    return dict(name=f"{name}_k{k}", replaces=f"{REPLACES}:317",
                launches=best["launches"],
                max_abs_err=max(best["max_abs_err"], twin["max_abs_err"]),
                ms=best["ms"], plain_ms=twin["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, source=CLUSTER_SOURCE)


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
    for line in bk.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}", flush=True)

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

    _, launches, captured = schedule_path(snapshot, "main path", card)

    # -- 4. the kernel at the main path's inputs --------------------------------
    main = compare(captured[0], "binpack at the main path's inputs", card,
                   reps=5)
    main["max_abs_err"] = max(errs + [main["max_abs_err"]])
    kernels = [dict(name="binpack", replaces=f"{REPLACES}:93",
                    launches=launches, **main)]

    # -- 5. the reservation main path --------------------------------------------
    def resv_snapshot():
        return testing.add_reservations(snapshot(), LABEL_RESV,
                                        MIGRATION_RESV, seed=11)

    result, launches, captured = schedule_path(
        resv_snapshot, "reservation main path", card)
    n_resv = captured[0].resv[0].shape[0]
    assert n_resv == LABEL_RESV + MIGRATION_RESV, n_resv
    consumed = len(result.resv_committed) + len(result.resv_allocs)
    assert consumed > 0, "no pod consumed a reservation"
    print(f"reservation main path: {n_resv} reservations, {consumed} pods "
          f"consumed one ({len(result.resv_committed)} committed, "
          f"{len(result.resv_allocs)} waiting)", flush=True)
    resv = compare(captured[0], "binpack use_resv at the reservation main "
                   "path's inputs", card, reps=5)
    kernels.append(dict(name="binpack_resv", replaces=f"{REPLACES}:205",
                        launches=launches, **resv))

    # -- 6. the fused solve, bench config #8 -------------------------------------
    for most in (False, True):
        scorer = "most" if most else "least"
        s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
            FUSED_NODES, FUSED_PODS, seed=8)
        safe = bk.kernel_resv_score_safe(rv.node, rv.free, s_.alloc)
        assert bk.kernel_routing_ok(s_, p_, None, rv, safe, aux)
        solved, launches, wall, captured = drive(
            lambda: bk.kernel_solve_batch(
                s_, p_, pr, q, g, numa_aux=aux, resv=rv, most_allocated=most,
                resv_score_checked=True))
        assert launches > 0, "the fused solve did not launch the kernel"
        placed = int(solved.commit.sum())
        took_numa = int(solved.numa_consumed.sum())
        took_resv = int((solved.resv_vstar >= 0).sum())
        assert placed > 0 and took_numa > 0 and took_resv > 0
        print(f"fused solve, NUMA {scorer} [{card}]: {FUSED_NODES} nodes x "
              f"{FUSED_PODS} pods, quota+gang+numa+resv: {placed} committed, "
              f"{took_numa} took NUMA, {took_resv} consumed a reservation; "
              f"wall {wall:.4f} s; launches {launches}", flush=True)
        fused = compare(captured[0], f"binpack use_numa ({scorer}) + use_resv "
                        f"+ quota at config #8", card, reps=3)
        loop_check(most, card)
        kernels.append(dict(name=f"binpack_numa_{scorer}_resv_quota",
                            replaces=f"{REPLACES}:259", launches=launches,
                            **fused))

    # -- 7. the node-sharded kernel: CTAs of one thread-block cluster ---------
    args, kwargs = main_path_solve_args(snapshot)
    main_sharded = cluster_path(
        "main path's solve", "binpack_sharded",
        lambda: bk.kernel_solve_batch(*args, **kwargs),
        lambda k: shard_kernel_solver(k)(*args[:5]), card)
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        FUSED_NODES, FUSED_PODS, seed=8)
    fused_sharded = cluster_path(
        "config #8, NUMA least + reservations", "binpack_sharded_numa_resv",
        lambda: bk.kernel_solve_batch(s_, p_, pr, q, g, numa_aux=aux,
                                      resv=rv),
        lambda k: shard_kernel_solver(k)(s_, p_, pr, q, g, aux, rv), card)
    state, pods, params, quota, _ = testing.quota_gang_problem(
        QUOTA_NODES, QUOTA_PODS, QUOTAS, GANGS, GANG_SIZE, seed=1)
    reduced = compare_sharded(
        bk.kernel_inputs(state, pods, params, bk.quota_inputs(quota)),
        QUOTA_SHARDS, f"quota+gang {QUOTA_NODES} nodes x {pods.req.shape[0]} "
        "pods", card)
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        LOOP_NODES, LOOP_PODS, seed=8)
    reduced_fused = compare_sharded(
        bk.kernel_inputs(s_, p_, pr, bk.quota_inputs(q), numa_aux=aux,
                         resv=rv, most_allocated=True),
        LOOP_SHARDS, f"config #8 cut to {LOOP_NODES} nodes x {LOOP_PODS} "
        "pods, NUMA most + reservations", card)
    main_sharded["max_abs_err"] = max(main_sharded["max_abs_err"],
                                      reduced["max_abs_err"])
    fused_sharded["max_abs_err"] = max(fused_sharded["max_abs_err"],
                                       reduced_fused["max_abs_err"])
    kernels += [main_sharded, fused_sharded]

    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda",
         "source": k.get("source", SOURCE),
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None}
        for k in kernels]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
