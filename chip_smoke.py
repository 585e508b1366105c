"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Every solve goes through ``ops/binpack_kernel.kernel_route``: the
one-block kernel (``csrc/binpack.cu``) when the node slice fits one CTA,
else the cluster kernel (``csrc/binpack_cluster.cu``) at the CTA count
the route names, its slices in shared memory, or past what 16 CTAs hold
in a device-memory workspace (the L2 form). Each phase prints the route
and the kernel's time (CUDA events, after a warm-up), the plain twin's,
the microseconds per pod and the bound (see :func:`bound`).

1. Prints the card's name and power limit; builds the CUDA kernel
   library from ``koordinator_tpu_torch/csrc`` with nvcc and prints
   ptxas's registers, shared memory and spills for each instance.
2. The routed kernel against the twin of the chosen kernel, bit for bit
   (assignments and every carry): the example problem at 5,000 nodes x
   10,000 pods (the cluster kernel), and 1,000 nodes with 5,000 pods in
   50 quota groups plus 200 gangs x 32 members (the one-block kernel,
   driven through ``kernel_solve_batch`` with the launch counts zeroed);
   then 1,000 nodes with 2,000 pods in 2,000 quota groups, whose tables
   do not fit shared memory (the one-block kernel with its quota carries
   in device memory).
3. The main path: ``PlacementModel().schedule`` on a seeded snapshot of
   5,000 nodes, 10,000 assigned pods with metrics and 10,000 pending pods
   in 50 quota groups and 200 gangs of 32. The launch counts are zeroed
   just before and read just after; the solve must take the route
   asserted here (the cluster kernel, its CTA count printed), respect
   node capacity, and equal ``PlacementModel(device="cpu")`` on an
   identical snapshot. A second run on a fresh model prints the timings
   of a process whose torch kernels are loaded.
4. Holds and times the routed kernel against its twin on the main path's
   own kernel inputs.
5. The reservation main path: phase 3's snapshot plus 256 Available
   reservations (200 owned by gang label, 56 migration reservations
   naming one solo pending pod each). ``PlacementModel().schedule`` must
   go through the routed kernel's reservation instance, consume
   reservations, respect node capacity with the remaining holds counted,
   and equal the CPU run: placements, waiting pods, consumption records
   and every mutated ``ReservationSpec``. The kernel is then held against
   its twin on that solve's inputs and timed.
6. The fused solve of the reference's bench config #8 (quota, Strict
   gangs, NUMA, reservations) at 5,000 nodes x 10,000 pods, with the
   NUMA least- and most-allocated scorers: ``kernel_solve_batch`` routed
   by ``kernel_routing_ok``, the kernel held against its twin on every
   output, and the whole kernel solve held against the loop
   ``solve_batch`` on the card at 1,000 x 2,000 (the loop runs a few
   dozen torch ops per pod). Then the one-block kernel's NUMA and
   reservation instances on config #8 cut to 800 x 2,000 (NUMA least,
   most, and reservations without NUMA).
7. The cluster kernel through ``parallel/mesh.shard_kernel_solver(k)``,
   for k in 2, 4, 8, 16, at the main path's solve (phase 3) and at
   config #8 with NUMA least and reservations (phase 6): each solve
   driven with the launch counts zeroed just before and read just after,
   held bit for bit against the routed solve (every output) and its
   kernel (every kernel output), and timed against it in the same
   process; a k whose slices do not fit shared memory runs the L2 form.
   At the fastest k the cluster kernel is held against its plain twin
   ``binpack_sharded_plain`` at full size; the twin also checks it at
   k = 8 on phase 2's quota+gang problem (1,000 nodes) and at k = 4 on
   config #8 cut to 1,000 x 2,000 with NUMA most.
8. A solve beyond what 16 CTAs' shared memory holds (40,000 nodes x
   1,000 pods, quota and gangs): the L2 form at 16 CTAs, held against its
   twin and timed.
9. The scheduling round on the card: ``Scheduler(enable_preemption=
   False)`` fed through its intake methods. (a) Phase 3's world as a
   burst: ``schedule_pending`` must launch the routed cluster kernel once
   and equal the same feed through a Scheduler on ``PlacementModel(
   device="cpu")``; a second round with no new events must take the
   staging cache's delta path and equal the CPU run again. (b) The
   reference's bench config #9 (churn ticks: 5,000 nodes, 50 metric
   refreshes and a 64-pod wave per tick, 12 ticks) through three
   Schedulers fed the same events: on the card with the staging cache, on
   the card restaging in full every tick (``model.reset_staging()``), and
   on the CPU. Every tick's placements and waiting pods must be equal
   across the three, every card tick must launch the kernel once, and
   every delta tick after the first must take the delta path; after the
   last tick the cache, brought up to the cache's snapshot, must equal a
   fresh staging of it. Prints the median tick wall and the lower/stage/
   solve split of both card runs (ticks 0-1 excluded) and their ratio,
   then holds the kernel against its twin on the last tick's inputs.
10. The fine-grained burst through the Scheduler: phase 3's world with a
   ``zone`` label on every node, a NUMA topology on every 4th node, 8
   GPUs on every 10th, and, by a seeded draw, 100 cpuset (LSR) pods, 100
   GPU pods, 50 host-port pods (20 distinct ports) and 2,000 node-selector
   pods among the 10,000 pending (``testing.add_fine_grained``), fed with
   ``update_node_topology``/``update_node_devices``. Two rounds; each
   prints its wall and split, the refine iterations and the solver of
   every solve, the host time in ``FineGrained.rows``, the kernel's ms
   per launch, and the committed and waiting counts. Every solve must
   launch the routed kernel (none on the loop) and the final solve's
   launch must equal its twin bit for bit. The same stream cut to 1,000
   nodes x 2,000 pending (the same shares) must give, on the card and on
   the CPU, the same placements, annotations, NUMA and device
   allocations. A sub-run with node policy ``SingleNUMANode`` (every pod
   with requests special) at 200 x 400 records its host rows' cost.
   Beside phase 6's loop check, one extras solve (config #8 cut to 1,000
   x 2,000 with 20% selector rows and 5% fine-grained rows) runs on the
   kernel and on the loop, with equal results; both are timed.
11. Preemption on the card, on the reference's bench config #19 world
   (``testing.preemption_storm(seed=11, n_nodes=1250,
   residents_per_node=4, n_arrivals=1000)``: 5,000 preemptible BE
   residents packed tight, 1,000 PROD arrivals that fit nowhere without
   eviction). (a) The storm through ``Scheduler()`` with the reference's
   defaults (preemption on, victim selection on the device): rounds until
   no arrival is pending (at most 40); every round must launch the
   routed kernel once and give the same placements, nominations and
   evicted uids as a Scheduler on ``PlacementModel(device="cpu")`` fed
   the same events, and the final caches must be equal. Each round
   prints its wall, the model's lower/stage/solve split, the preemption
   time, the preemptors tried, the evictions and the placements; the
   kernel is held against its twin on round 0's inputs (all 1,000
   arrivals pending) and on the last round's. (b) The per-pod sweep of
   the first 24 arrivals: ``select_victims_device`` plus
   ``evict_resident_rows`` on the card against the host walk
   ``find_preemption`` plus a full re-lower per hit, identical (node,
   ordered victims) answers, pods/s of each and their ratio (median and
   range of 5 repeats, the arms in turns, each on a fresh world), at
   config #19's shape and at 5,000 nodes x 4 residents. (c) ``preempt_scan_
   device`` over all 1,000 arrivals in one call, equal to the CPU run,
   with its wall. (d) ``Scheduler.defrag_headroom`` (one arrival's
   requests, residents below priority 5,000) with ``preemption_backend=
   "verify"``: the device plan must equal the host plan.
12. Descheduling on the card: ``LowNodeLoad`` (``descheduler/
   loadaware.py``) whose "device" backend runs the balance sweep's scan
   kernel (``csrc/rebalance_sweep.cu``; every batch LowNodeLoad builds
   takes the "scan" route, and a pass must launch no serial kernel).
   (a) The reference's bench config #5
   (``testing.rebalance_world_spec``: 5,000 nodes, 30,000 running pods,
   seed 5; pool low CPU 45 / memory 60, high 65 / 80): "host", "device"
   and "verify" give the same ordered evictions as the port's
   ``RebalanceOracle``; ``balance()`` timed per backend, 5 repeats in
   turns. (b) Bench config #22 at its default (``testing.
   rebalance_storm_spec``: 400 nodes, 10 pods per hot node, seed 22; low
   30 / 30, high 60 / 60): device == host, then the budgeted arm
   (``MigrationArbiter(MigrationBudget(max_per_node=1))`` asked by the
   sink) must hold the reference's ``budget_bounded``, with its sweep
   launches (one per refusal), the wall of each re-scan (``DeviceSweep.
   refuse``: one launch, one read-back of the suffix) and, in a second
   run of the arm, the kernel's time per re-scan (CUDA events); then the
   same world and arbiter through ``Scheduler.rebalance_sweep`` must
   evict the same pods, and the next round's delta staging must equal a
   fresh staging. (c) Config #22 widened to 5,000 nodes (25,000
   candidates), device == host. For each of the three, both kernels (scan
   and serial) are held against the plain version on the pass's batch
   (every stream and the final headroom, exact) and timed in turns. (d)
   The serial route: a batch of 4,991 candidates whose ``high_q`` varies
   inside its nodes through ``run_balance_sweep`` (it must launch the
   serial kernel and no scan kernel), held and timed the same way; an
   empty kernel at the scan kernel's launch shape is timed beside it.
   Each pass is driven with the launch counts zeroed just before and read
   just after.
Then one JSON line of kernels, and the result line ``{"ok": true,
"device": {...}}`` last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    ReservationState,
    resources_to_vector,
)
from koordinator_tpu_torch.control.migration import (
    MigrationArbiter,
    MigrationBudget,
)
from koordinator_tpu_torch.descheduler import (
    LowNodeLoad,
    LowNodeLoadArgs,
    NodePool,
    loadaware,
)
from koordinator_tpu_torch.descheduler.framework import Evictor
from koordinator_tpu_torch.models import placement
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import (
    ExtrasRows,
    SolverConfig,
    solve_batch,
)
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.ops import rebalance as rb
from koordinator_tpu_torch.oracle.rebalance import RebalanceOracle
from koordinator_tpu_torch.parallel.mesh import shard_kernel_solver
from koordinator_tpu_torch.scheduler.plugins.reservation import reservation_free
from koordinator_tpu_torch.scheduler.preemption import find_preemption
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.state.cluster import (
    evict_resident_rows,
    lower_nodes,
)

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
#: per (pod with an extras row, node) pair: the mask test, the score add
EXTRAS_OPS_PER_PAIR = 2

# the flagship burst (BASELINE.json north star) and BASELINE configs #3/#4
NODES, ASSIGNED_PER_NODE, PENDING = 5000, 2, 10000
QUOTA_NODES, QUOTA_PODS, QUOTAS, GANGS, GANG_SIZE = 1000, 5000, 50, 200, 32
# phase 5: reservations owned by gang label, and migration reservations
LABEL_RESV, MIGRATION_RESV = 200, 56
# phase 6: bench config #8 at its own shape; the loop comparison's cut;
# the cut whose NUMA + reservation slice fits one CTA
FUSED_NODES, FUSED_PODS = 5000, 10000
LOOP_NODES, LOOP_PODS = 1000, 2000
BLOCK_NODES, BLOCK_PODS = 800, 2000
# phase 7: CTAs of the cluster kernel; the reduced checks' CTA counts
SHARDS = (2, 4, 8, 16)
QUOTA_SHARDS, LOOP_SHARDS = 8, 4
# phase 8: past 16 CTAs' shared memory (quota pods, gangs x members)
L2_NODES, L2_QUOTA_PODS, L2_GANGS, L2_GANG_SIZE = 40000, 600, 20, 20
# phase 2: quota tables beyond shared memory (nodes, pods, groups)
WIDE_NODES, WIDE_PODS, WIDE_QUOTAS = 1000, 2000, 2000
# phase 9: bench config #9 (nodes, metric refreshes and pending per tick,
# ticks; ticks before WARM_TICKS are left out of the times)
CHURN_NODES, CHURN_DIRTY, CHURN_PENDING, CHURN_TICKS = 5000, 50, 64, 12
WARM_TICKS = 2
# phase 10: the fine-grained pods of the burst (cpuset, GPU, host-port,
# node-selector pods; distinct host ports), the cut held against the
# CPU, the SingleNUMANode sub-run, and the extras solve's row shares
FINE_CPUSET, FINE_GPU, FINE_PORTS, FINE_SELECTOR, FINE_DISTINCT = (
    100, 100, 50, 2000, 20)
FINE_CUT_NODES, FINE_CUT_PENDING = 1000, 2000
SNN_NODES, SNN_PENDING = 200, 400
EXTRAS_SELECTOR, EXTRAS_SCORED = 0.2, 0.05
# phase 11: bench config #19 (seed, nodes, residents per node, arrivals),
# the round cap, the per-pod sweep's pods and its wider node count, and
# the defrag's drain priority bound
STORM_SEED, STORM_NODES, STORM_RPN, STORM_ARRIVALS = 11, 1250, 4, 1000
STORM_MAX_ROUNDS = 40
SWEEP_PODS, SWEEP_WIDE_NODES, SWEEP_REPEATS = 24, 5000, 5
DEFRAG_MAX_PRIORITY = 5000
# phase 12: bench config #5 (nodes, running pods, seed) and its pool (low,
# high percent of CPU and memory); config #22 (nodes, pods per hot node,
# seed) and its pool, at the reference's default and widened to the main
# path's node count; balance() repeats per backend, in turns
REBAL_NODES, REBAL_PODS, REBAL_SEED = 5000, 30000, 5
REBAL_LOW, REBAL_HIGH = (45, 60), (65, 80)
STORM22_NODES, STORM22_PPN, STORM22_SEED = 400, 10, 22
STORM22_WIDE_NODES = 5000
STORM22_LOW, STORM22_HIGH = (30, 30), (60, 60)
BALANCE_REPEATS = 5
# the serial route's batch (candidates, seed); empty launches timed;
# the budgeted arm's re-scans replayed per queue of launches
VARIED_K, VARIED_SEED = 4991, 23
EMPTY_REPS = 200
REPLAY_CHUNK = 200
#: cycles the card sleeps per queued call in :func:`device_ms` (~115 us
#: at 1.7 GHz, above the host's time to launch one sweep)
SLEEP_CYCLES_PER_CALL = 200_000
#: integer operations per candidate of the balance sweep: per resource
#: the start select, the over test and its mask, the headroom test and its
#: mask, the two subtractions (48); the two votes, the propose logic and
#: the store (6)
SWEEP_OPS_PER_CANDIDATE = 8 * 6 + 6

SOURCE = "koordinator_tpu_torch/csrc/binpack.cu"
CLUSTER_SOURCE = "koordinator_tpu_torch/csrc/binpack_cluster.cu"
REPLACES = "koordinator_tpu/ops/pallas_binpack.py"
SWEEP_SOURCE = "koordinator_tpu_torch/csrc/rebalance_sweep.cu"
SWEEP_REPLACES = "koordinator_tpu/ops/rebalance.py:211"


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


def device_ms(fn, reps):
    """ms per call of ``fn`` (which must not synchronise) on the card,
    the calls queued behind a sleeping kernel so that the card runs them
    back to back (a kernel of a few microseconds is otherwise timed at
    the host's launch rate)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
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
    reservation) pair and the credit's subtractions per matched pair,
    and the extras rows' mask test and score add per (pod with a row,
    schedulable node) pair."""
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
    if inp.extras is not None:
        # the compact rows are inputs, read once (counted above); per
        # (pod with a row, schedulable node) pair the mask test and the
        # score add
        ops += (EXTRAS_OPS_PER_PAIR * int((inp.extras[0] >= 0).sum())
                * int(inp.sched.sum()))
    nbytes += 4 * out_words
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def variant(inp) -> str:
    """The kernel instance's variant, from its inputs."""
    parts = []
    if inp.numa is not None:
        parts.append("numa_most" if inp.most_allocated else "numa_least")
    if inp.resv is not None:
        parts.append("resv")
    if inp.quota is not None:
        parts.append("quota")
    return "_".join(parts) or "plain"


def route_name(route) -> str:
    return ("block" if route.kind == "block"
            else f"{route.kind}_k{route.shards}")


def twin(inp, route):
    """The plain twin of the kernel ``route`` names."""
    if route.kind == "block":
        return bk.binpack_plain(inp)
    return bk.binpack_sharded_plain(inp, route.shards)


def compare(inp, label, card, reps=3, shards=None) -> dict:
    """Run ``inp`` on the kernel the route names (or the cluster kernel
    at ``shards`` CTAs), hold it against that kernel's plain twin
    (tolerance: exact, every output) and time both on the card: the
    kernel over ``reps`` launches after the comparison's launch as
    warm-up, the twin over its one comparison run."""
    def run():
        return (bk.binpack(inp) if shards is None
                else bk.binpack_sharded(inp, shards))

    got = run()
    route = bk.route_of(inp, shards)
    torch.cuda.synchronize()
    want = []
    plain_ms = cuda_ms(lambda: want.append(twin(inp, route)), 1)
    err = max_abs_err(got, want[0])
    ms = cuda_ms(run, reps)
    bound_ms, bound_by = bound(inp)
    p = inp.req.shape[0]
    placed = int((got.assign >= 0).sum())
    quota_in = "shared" if route.quota_shared else "device"
    print(f"{label}: {route_name(route)} kernel == plain twin ({placed}/{p} "
          f"placed, max_abs_err {err}) [{card}]: kernel {ms:.3f} ms "
          f"({ms / p * 1e3:.3f} us/pod, {route.n_loc} rows per CTA, smem "
          f"{route.smem} B, quota tables in {quota_in} memory), plain twin "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, route=route,
                variant=variant(inp))


def entry(name_prefix, launches, stats, replaces_line) -> dict:
    """A ``kernels`` line entry from :func:`compare`'s stats."""
    route = stats["route"]
    return dict(name=f"{name_prefix}_{route_name(route)}_{stats['variant']}",
                replaces=f"{REPLACES}:{replaces_line}",
                source=SOURCE if route.kind == "block" else CLUSTER_SOURCE,
                launches=launches, **{k: stats[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by")})


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


def drive(run, wrapper="binpack"):
    """Run one path with every kernel input it hands ``bk.<wrapper>``
    captured with the route it took, every launch count zeroed just
    before and read just after (a device synchronise ends the timed
    span). Returns ``(result, launches by route kind, wall_s, captured
    [(inputs, route)])``."""
    captured = []
    launch = getattr(bk, wrapper)

    def capture(inp, *args):
        out = launch(inp, *args)
        captured.append((inp, bk.route_of(inp, *args)))
        return out

    setattr(bk, wrapper, capture)
    try:
        for kind in bk.LAUNCHES:
            bk.LAUNCHES[kind] = 0
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(bk.LAUNCHES)
    finally:
        setattr(bk, wrapper, launch)
    return result, launches, wall, captured


def routed(label, launches, captured, kind=None):
    """The one solve a driven path made: it launched the kernel its route
    names once and no other (and ``kind`` when given). Returns
    ``(inputs, route)``."""
    assert len(captured) == 1, f"{label}: {len(captured)} solves"
    inp, route = captured[0]
    want = {k: int(k == route.kind) for k in bk.LAUNCHES}
    assert launches == want, f"{label}: launches {launches}, route {route}"
    assert kind is None or route.kind == kind, f"{label}: route {route}"
    return inp, route


def _specs(snap):
    return [(r.name, r.allocated, r.allocated_pod_uids, r.state)
            for r in snap.reservations]


def _records(book):
    return {uid: (name, delta.tolist()) for uid, (name, delta) in book.items()}


def schedule_path(snapshot, label, card, kind):
    """``PlacementModel().schedule`` on ``snapshot()`` through the kernel,
    checked: every pod decided, some committed, node capacity respected,
    and equal to ``PlacementModel(device="cpu")`` on an identical
    snapshot (placements, waiting pods, reservation records and specs);
    the route must be ``kind``. Returns ``(result, launches of the routed
    kernel, captured kernel inputs)``."""
    snap = snapshot()
    model = PlacementModel()
    result, launches, wall, captured = drive(lambda: model.schedule(snap))
    assert model.last_solver == "kernel", model.last_solver
    _, route = routed(label, launches, captured, kind)
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
          f"(n_pending / wall); cuda == cpu; route {route_name(route)} "
          f"({route.n_loc} rows per CTA); launches {launches[route.kind]}",
          flush=True)
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
    return result, launches[route.kind], captured


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


def cluster_path(label, name, solve_one, sharded_solver, card) -> dict:
    """Phase 7 at one input: ``solve_one()`` is the routed solve,
    ``sharded_solver(k)`` the solve through ``shard_kernel_solver(k)``.
    For each k in SHARDS, the sharded solve is driven with the launch
    counts zeroed, held against the routed solve on every output and its
    kernel against the routed kernel on every kernel output, and both
    kernels are timed (5 launches after a warm-up, CUDA events, in
    turns). At the fastest k the cluster kernel is held against its
    plain twin. Returns the ``kernels`` entry."""
    want, _, _, captured = drive(solve_one)
    single_in, single_route = captured[0]
    single = bk.binpack(single_in)
    n = single_in.alloc.shape[0]
    p = single_in.req.shape[0]
    bound_ms, bound_by = bound(single_in)
    runs = {}
    for k in SHARDS:
        got, launches, wall, captured = drive(
            lambda: sharded_solver(k), "binpack_sharded")
        inp, route = routed(f"{label}, k={k}", launches, captured)
        same_solve(got, want)
        err = max_abs_err(trimmed(bk.binpack_sharded(inp, k), n), single)
        one_ms = cuda_ms(lambda: bk.binpack(single_in), 5)
        ms = cuda_ms(lambda: bk.binpack_sharded(inp, k), 5)
        one_ms = (one_ms + cuda_ms(lambda: bk.binpack(single_in), 5)) / 2
        runs[k] = dict(launches=launches[route.kind], max_abs_err=err, ms=ms,
                       inp=inp, route=route)
        print(f"{label}, {k} CTAs, {route.kind} ({route.n_loc} rows per CTA) "
              f"[{card}]: shard_kernel_solver == routed solve (every "
              f"output), kernel == routed kernel (max_abs_err {err}); "
              f"{ms:.3f} ms ({ms / p * 1e3:.3f} us/pod), routed "
              f"{route_name(single_route)} kernel {one_ms:.3f} ms "
              f"({one_ms / p * 1e3:.3f} us/pod), bound {bound_ms:.5f} ms "
              f"({bound_by}); solve wall {wall:.4f} s; launches "
              f"{launches[route.kind]}", flush=True)
    k = min(runs, key=lambda x: runs[x]["ms"])
    best = runs[k]
    twin_stats = compare(best["inp"], f"{label}, full size, {k} CTAs", card,
                         reps=5, shards=k)
    return dict(name=f"{name}_{route_name(best['route'])}",
                replaces=f"{REPLACES}:317", launches=best["launches"],
                max_abs_err=max(best["max_abs_err"],
                                twin_stats["max_abs_err"]),
                ms=best["ms"], plain_ms=twin_stats["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by, source=CLUSTER_SOURCE)


def solve_entry(label, solve, card, kind, replaces_line, reps=3,
                name="binpack", quota_shared=True) -> dict:
    """Drive ``solve()`` (a ``kernel_solve_batch`` call) with the launch
    counts zeroed, assert its route is ``kind`` (its quota tables in
    shared memory or not, as ``quota_shared``), then hold and time the
    routed kernel against its twin on the captured inputs. Returns the
    ``kernels`` entry."""
    _, launches, _, captured = drive(solve)
    inp, route = routed(label, launches, captured, kind)
    assert route.quota_shared == quota_shared, f"{label}: route {route}"
    stats = compare(inp, label, card, reps=reps)
    return entry(name, launches[route.kind], stats, replaces_line)


def fed_scheduler(snap, device=None) -> Scheduler:
    """A Scheduler on ``PlacementModel(device=device)`` fed ``snap``."""
    sched = Scheduler(model=PlacementModel(device=device),
                      enable_preemption=False)
    testing.feed_scheduler(sched, snap)
    return sched


def same_round(got, want, label) -> None:
    """Two schedulers' rounds: equal placements and waiting pods."""
    assert dict(got) == dict(want), f"{label}: cuda != cpu placements"
    assert got.waiting == want.waiting, f"{label}: cuda != cpu waiting"


def scheduler_burst(snapshot, card) -> None:
    """Phase 9 (a): phase 3's world through the Scheduler's intake, two
    rounds, each on the routed kernel once and equal to the CPU run."""
    gpu, cpu = fed_scheduler(snapshot()), fed_scheduler(snapshot(), "cpu")
    for rnd, now, path in ((1, 20.0, "full"), (2, 21.0, "delta")):
        label = f"scheduler burst, round {rnd}"
        pending = len(gpu.cache.pending)
        result, launches, wall, captured = drive(
            lambda: gpu.schedule_pending(now=now))
        _, route = routed(label, launches, captured, "cluster")
        assert gpu.model.last_staging == path, gpu.model.last_staging
        same_round(result, cpu.schedule_pending(now=now), label)
        assert cpu.model.last_staging == path
        committed = sum(n is not None for n in result.values())
        assert committed > 0 or rnd == 2
        tm = gpu.model.last_timings
        print(f"{label} [{card}]: {len(gpu.cache.nodes)} nodes, {pending} "
              f"pending: {committed} committed, {len(result.waiting)} "
              f"waiting; {path} staging; lower_s {tm['lower_s']:.4f} "
              f"stage_s {tm['stage_s']:.4f} solve_s {tm['solve_s']:.4f} "
              f"wall {wall:.4f} s; cuda == cpu; route {route_name(route)}; "
              f"launches {launches[route.kind]}", flush=True)


def churn_ticks(card):
    """Phase 9 (b): bench config #9 through three Schedulers fed the same
    events. Returns ``(launches of the delta run, the last delta tick's
    kernel inputs)``."""
    snap, _ = testing.churn_world(CHURN_NODES, assigned_per_node=2, seed=42)
    delta, full = fed_scheduler(snap), fed_scheduler(snap)
    cpu = fed_scheduler(snap, "cpu")
    rng = np.random.default_rng(7)
    times = {"delta": [], "full": []}
    node_lower = {"delta": [], "full": []}   # the cache's own lower_s
    dirty_rows = []                          # rows a delta tick rewrote
    for name, sched in (("delta", delta), ("full", full)):
        ensure = sched.model.staged_cache.ensure

        def timed(snapshot, want_device=True, ensure=ensure, name=name):
            out = ensure(snapshot, want_device)
            node_lower[name].append(out[2]["lower_s"])
            if name == "delta" and out[3][1].idx is not None:
                dirty_rows.append(out[3][1].idx.size)
            return out

        sched.model.staged_cache.ensure = timed
    launches_delta, last_inp = 0, None
    for t in range(CHURN_TICKS):
        now = 20.0 + t
        testing.feed_churn_tick((delta, full, cpu), snap, rng,
                                dirty=CHURN_DIRTY, pending=CHURN_PENDING,
                                t=t, now=now)
        results = {}
        for name, sched in (("delta", delta), ("full", full)):
            if name == "full":
                sched.model.reset_staging()
            result, launches, wall, captured = drive(
                lambda: sched.schedule_pending(now=now))
            inp, route = routed(f"churn tick {t}, {name}", launches,
                                captured, "cluster")
            want_path = "full" if name == "full" or t == 0 else "delta"
            assert sched.model.last_staging == want_path, (
                name, t, sched.model.last_staging)
            results[name] = result
            if name == "delta":
                launches_delta += launches[route.kind]
                last_inp = inp
            if t >= WARM_TICKS:
                times[name].append((wall, dict(sched.model.last_timings)))
        want = cpu.schedule_pending(now=now)
        for name, result in results.items():
            same_round(result, want, f"churn tick {t}, {name}")
    now = 20.0 + CHURN_TICKS
    for name, sched in (("delta", delta), ("cpu", cpu)):
        snapshot = sched.cache.snapshot(now=now)
        sched.model.prestage(snapshot)
        assert sched.model.staged_cache.last_path == "delta", name
        fresh = sched.model.stage_nodes(
            lower_nodes(snapshot, **sched.model.lowering_kwargs()))
        for f in STAGED_NODE_FIELDS:
            assert torch.equal(getattr(sched.model.staged_cache.state, f),
                               getattr(fresh, f)), f"{name} cache: {f}"
    medians = {}
    for name, rows in times.items():
        medians[name] = {"wall": float(np.median([w for w, _ in rows]))}
        for k in ("lower_s", "stage_s", "solve_s"):
            medians[name][k] = float(np.median([tm[k] for _, tm in rows]))
        m = medians[name]
        nodes_s = float(np.median(node_lower[name][WARM_TICKS:CHURN_TICKS]))
        print(f"churn ticks, {name} staging [{card}]: {CHURN_NODES} nodes, "
              f"{CHURN_DIRTY} metrics + {CHURN_PENDING} pending per tick, "
              f"median of ticks {WARM_TICKS}-{CHURN_TICKS - 1}: tick wall "
              f"{m['wall']:.4f} s, lower_s {m['lower_s']:.4f} (node rows "
              f"{nodes_s:.4f}) stage_s {m['stage_s']:.4f} solve_s "
              f"{m['solve_s']:.4f}", flush=True)
    print(f"churn ticks [{card}]: every tick equal across delta, full and "
          f"cpu; ticks 1-{CHURN_TICKS - 1} delta (median {np.median(dirty_rows):.0f} "
          f"node rows re-lowered); cache == fresh staging; "
          f"tick wall full / delta = "
          f"{medians['full']['wall'] / medians['delta']['wall']:.2f}",
          flush=True)
    return launches_delta, last_inp


def extras_loop_check(card) -> dict:
    """Beside phase 6's loop check: one extras solve, config #8 cut to
    LOOP_NODES x LOOP_PODS with EXTRAS_SELECTOR of the pods on shared
    selector rows and EXTRAS_SCORED on their own scored rows, on the
    kernel and on the loop ``solve_batch`` (which expands the rows); the
    results must be equal on every output. Returns the ``kernels`` entry
    of the kernel's extras instance at this shape."""
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        LOOP_NODES, LOOP_PODS, seed=8)
    row, mask, score = testing.extras_arrays(
        LOOP_NODES, LOOP_PODS, selector_frac=EXTRAS_SELECTOR,
        scored_frac=EXTRAS_SCORED, seed=13)
    extras = ExtrasRows(*(torch.as_tensor(a, device=s_.alloc.device)
                          for a in (row, mask, score)))
    got = []
    _, launches, _, captured = drive(lambda: got.append(
        bk.kernel_solve_batch(s_, p_, pr, q, g, numa_aux=aux, resv=rv,
                              extras=extras)))
    inp, route = routed("extras solve", launches, captured)
    ms = cuda_ms(lambda: bk.kernel_solve_batch(
        s_, p_, pr, q, g, numa_aux=aux, resv=rv, extras=extras), 3)
    want = []
    loop_ms = cuda_ms(lambda: want.append(solve_batch(
        s_, p_, pr, SolverConfig(), q, g, extras, resv=rv, numa=aux)), 1)
    same_solve(got[0], want[0])
    n_rows = int((extras.row_of_pod >= 0).sum())
    print(f"extras solve == loop solve_batch, config #8 cut to {LOOP_NODES} "
          f"nodes x {LOOP_PODS} pods, {n_rows} pods with a row "
          f"({mask.shape[0]} distinct rows) [{card}]: "
          f"{int(got[0].commit.sum())} committed, placements equal; kernel "
          f"solve {ms:.3f} ms, loop {loop_ms:.3f} ms", flush=True)
    stats = compare(inp, f"extras, config #8 cut to {LOOP_NODES} x "
                    f"{LOOP_PODS}", card, reps=3)
    return entry("binpack_extras", launches[route.kind], stats, 259)


def fine_world(n_nodes, n_pending, node_policy=""):
    """Phase 3's world at ``n_nodes`` x ``n_pending`` with the phase's
    fine-grained shares (:func:`testing.add_fine_grained`): ``(snapshot,
    topologies, devices)``."""
    f = n_pending / PENDING
    snap, _ = testing.churn_world(n_nodes, assigned_per_node=ASSIGNED_PER_NODE,
                                  seed=42)
    testing.add_pending_wave(
        snap, n_pending, n_quota=max(1, round(QUOTAS * f)),
        n_gangs=max(1, round(GANGS * f)),
        gang_size=GANG_SIZE if n_pending >= 2000 else 4, seed=7)
    topo, dev = testing.add_fine_grained(
        snap, n_cpuset=round(FINE_CPUSET * f), n_gpu=round(FINE_GPU * f),
        n_ports=round(FINE_PORTS * f), n_selector=round(FINE_SELECTOR * f),
        n_distinct_ports=max(2, round(FINE_DISTINCT * f)),
        node_policy=node_policy)
    return snap, topo, dev


class FineProbe:
    """A Scheduler on ``PlacementModel(device=device)`` fed a fine
    world, with its model's ``FineGrained.rows`` timed (host seconds and
    calls) and the solver of every solve recorded."""

    def __init__(self, world, device=None):
        import copy

        snap, topo, dev = world
        self.sched = fed_scheduler(copy.deepcopy(snap), device)
        testing.feed_fine_grained(self.sched, topo, dev)
        model = self.sched.model
        self.rows_s, self.rows_calls, self.solvers = 0.0, 0, []
        rows, dispatch = model.fine.rows, model._dispatch_solve

        def timed_rows(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return rows(*args, **kwargs)
            finally:
                self.rows_s += time.perf_counter() - t0
                self.rows_calls += 1

        def recorded(*args, **kwargs):
            out = dispatch(*args, **kwargs)
            self.solvers.append(model.last_solver)
            return out

        model.fine.rows = timed_rows
        model._dispatch_solve = recorded

    def round(self, now):
        """One round, driven with the launch counts zeroed: ``(result,
        launches, wall, captured)``; the probe's counters restart."""
        self.rows_s, self.rows_calls, self.solvers = 0.0, 0, []
        return drive(lambda: self.sched.schedule_pending(now=now))

    def state(self):
        """Placements, annotations, NUMA and device holds, plain data."""
        s = self.sched
        pods = {**s.cache.pending, **s.cache.pods}
        return (
            {u: (p.node_name, dict(p.annotations)) for u, p in pods.items()},
            {n: {u: ([int(c) for c in a.cpuset],
                     {k: {int(r): v for r, v in res.items()}
                      for k, res in a.numa_resources.items()})
                 for u, a in na.pods.items()}
             for n, na in s.numa_manager.node_allocations.items()},
            {n: {u: {t.value: [(a.minor, {k.value: v for k, v in
                                         a.resources.items()})
                               for a in allocs]
                     for t, allocs in by_type.items()}
                 for u, by_type in nd.allocations.items()}
             for n, nd in s.device_cache.nodes.items()},
            sorted(s._fine_waiting))


def fine_round_line(label, probe, result, launches, wall, card, ms) -> str:
    """The printed line of one phase-10 round."""
    tm = probe.sched.model.last_timings
    committed = sum(n is not None for n in result.values())
    kinds = {k: v for k, v in launches.items() if v}
    return (f"{label} [{card}]: {len(probe.sched.cache.nodes)} nodes: "
            f"{committed} committed, {len(result.waiting)} waiting "
            f"({len(probe.sched._fine_waiting)} with fine-grained holds); "
            f"wall {wall:.4f} s, lower_s {tm['lower_s']:.4f} stage_s "
            f"{tm['stage_s']:.4f} solve_s {tm['solve_s']:.4f}; refine "
            f"iterations {len(probe.solvers) - 1}, solvers {probe.solvers}; "
            f"FineGrained.rows {probe.rows_s:.4f} s host over "
            f"{probe.rows_calls} calls; launches {kinds}, kernel "
            f"{ms:.3f} ms per launch (the final solve's inputs)")


def fine_rounds(label, probe, card, rounds=2, reference=None):
    """``rounds`` rounds of ``probe``: every solve kernel-routed and
    launched once, the final solve's launch == its twin bit for bit and
    timed; with ``reference`` (a CPU probe) every round equal to it.
    Returns the first round's ``compare`` stats (the whole burst) and the
    launches of all rounds."""
    first, total = None, 0
    for r in range(rounds):
        now = 20.0 + r
        result, launches, wall, captured = probe.round(now)
        assert probe.solvers and set(probe.solvers) == {"kernel"}, (
            label, probe.solvers)
        assert len(captured) == len(probe.solvers) == sum(
            launches.values()), (label, len(captured), launches)
        if reference is not None:
            want, _, _, _ = reference.round(now)
            assert set(reference.solvers) == {"kernel"}, reference.solvers
            same_round(result, want, f"{label}, round {r + 1}")
            assert probe.state() == reference.state(), (
                f"{label}, round {r + 1}: cuda != cpu fine-grained state")
        inp, _ = captured[-1]
        stats = compare(inp, f"{label}, round {r + 1}, final solve", card,
                        reps=3)
        first = first or stats
        total += sum(launches.values())
        print(fine_round_line(f"{label}, round {r + 1}", probe, result,
                              launches, wall, card, stats["ms"])
              + ("; cuda == cpu (placements, annotations, NUMA and device "
                 "holds)" if reference is not None else ""), flush=True)
    return first, total


def fine_grained_burst(card) -> list:
    """Phase 10. Returns its ``kernels`` entries."""
    probe = FineProbe(fine_world(NODES, PENDING))
    stats, launches = fine_rounds("fine-grained burst", probe, card)
    _, numa, devices, _ = probe.state()
    held = sum(len(v) for v in numa.values())
    gpus = sum(len(v) for v in devices.values())
    assert held > 0 and gpus > 0, (held, gpus)
    print(f"fine-grained burst: {held} pods hold NUMA resources or a "
          f"cpuset, {gpus} hold GPUs", flush=True)
    kernels = [entry("binpack_extras", launches, stats, 259)]
    world = fine_world(FINE_CUT_NODES, FINE_CUT_PENDING)
    stats, launches = fine_rounds(
        "fine-grained burst cut", FineProbe(world), card,
        reference=FineProbe(world, "cpu"))
    kernels.append(entry("binpack_extras_cut", launches, stats, 259))
    world = fine_world(SNN_NODES, SNN_PENDING, node_policy="SingleNUMANode")
    stats, launches = fine_rounds(
        "SingleNUMANode nodes", FineProbe(world), card, rounds=1,
        reference=FineProbe(world, "cpu"))
    kernels.append(entry("binpack_extras_single_numa", launches, stats, 259))
    return kernels


def storm_scheduler(device=None, backend="device") -> Scheduler:
    """``Scheduler()`` with the reference's preemption defaults (or
    ``backend``) on ``PlacementModel(device=device)``, fed config #19's
    storm: nodes, residents, then the arrivals."""
    nodes, residents, arrivals = testing.preemption_storm(
        seed=STORM_SEED, n_nodes=STORM_NODES, residents_per_node=STORM_RPN,
        n_arrivals=STORM_ARRIVALS)
    sched = Scheduler(model=PlacementModel(device=device),
                      preemption_backend=backend)
    for node in nodes:
        sched.add_node(node)
    for pod in residents + arrivals:
        sched.add_pod(pod)
    return sched


class PreemptProbe:
    """Times a Scheduler's ``_preempt_unplaced`` (host seconds, a device
    synchronise included) and counts the preemptors it tried (its
    ``select_victims_device`` calls)."""

    def __init__(self, sched):
        self.seconds, self.tried = 0.0, 0
        preempt = sched._preempt_unplaced
        select = sched.model.select_victims_device

        def timed(*args):
            t0 = time.perf_counter()
            preempt(*args)
            if sched.model.device.type == "cuda":
                torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t0

        def counted(*args, **kwargs):
            self.tried += 1
            return select(*args, **kwargs)

        sched._preempt_unplaced = timed
        sched.model.select_victims_device = counted


def frozen(inp):
    """A copy of kernel inputs ``inp`` that later rounds cannot change
    (the staging cache rewrites the staged node tensors in place)."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if type(x) is tuple:
            return tuple(copy(y) for y in x)
        return x
    return inp._replace(**{f: copy(getattr(inp, f)) for f in inp._fields})


def storm_rounds(card) -> list:
    """Phase 11 (a). Returns the ``kernels`` entries of the storm rounds'
    placement kernel: held against its twin and timed on round 0's
    inputs (every arrival pending) and on the last round's."""
    gpu, cpu = storm_scheduler(), storm_scheduler("cpu")
    probe = PreemptProbe(gpu)
    launches, rounds, first, inp = {}, 0, None, None
    t_storm = time.perf_counter()
    for r in range(STORM_MAX_ROUNDS):
        now = 100.0 + r
        label = f"preemption storm, round {r}"
        pending = len(gpu.cache.pending)
        before = set(gpu.cache.pods)
        probe.tried = 0
        result, launched, wall, captured = drive(
            lambda: gpu.schedule_pending(now=now))
        inp, route = routed(label, launched, captured)
        launches[route.kind] = launches.get(route.kind, 0) + 1
        if first is None:
            first = frozen(inp)
        want = cpu.schedule_pending(now=now)
        same_round(result, want, label)
        assert result.nominations == want.nominations, label
        evicted = before - set(gpu.cache.pods)
        assert evicted == before - set(cpu.cache.pods), label
        placed = [u for u, n in result.items() if n is not None]
        tm = gpu.model.last_timings
        print(f"{label} [{card}]: {pending} pending; wall {wall:.4f} s, "
              f"lower_s {tm['lower_s']:.4f} stage_s {tm['stage_s']:.4f} "
              f"solve_s {tm['solve_s']:.4f}, preemption {probe.seconds:.4f}"
              f" s; {probe.tried} preemptors tried, {len(evicted)} "
              f"evictions, {len(result.nominations)} nominations, "
              f"{len(placed)} placements; cuda == cpu; route "
              f"{route_name(route)}; launches {launched[route.kind]}",
              flush=True)
        for uid in placed:
            gpu.cache.finish_binding(uid)
            cpu.cache.finish_binding(uid)
        rounds += 1
        if not gpu.cache.pending:
            break
    storm_s = time.perf_counter() - t_storm
    assert not gpu.cache.pending, f"storm not drained in {rounds} rounds"
    assert ({u: p.node_name for u, p in gpu.cache.pods.items()}
            == {u: p.node_name for u, p in cpu.cache.pods.items()})
    assert list(gpu.cache.pending) == list(cpu.cache.pending)
    print(f"preemption storm [{card}]: {STORM_ARRIVALS} arrivals placed in "
          f"{rounds} rounds; final cache == cpu; kernel launches {launches}; "
          f"phase wall {storm_s:.2f} s (cpu rounds included)", flush=True)
    entries = []
    for which, name, x in (("round 0", "binpack_preempt_storm", first),
                           ("last round", "binpack_preempt_storm_last_round",
                            inp)):
        stats = compare(x, f"preemption storm, {which} ({STORM_NODES} "
                        f"nodes)", card, reps=5)
        kind = stats["route"].kind
        entries.append(entry(name, launches[kind], stats,
                             93 if kind == "block" else 317))
    return entries


def storm_world(n_nodes, n_arrivals):
    """Config #19's storm at ``n_nodes``: ``(snapshot, arrivals)``."""
    nodes, residents, arrivals = testing.preemption_storm(
        seed=STORM_SEED, n_nodes=n_nodes, residents_per_node=STORM_RPN,
        n_arrivals=n_arrivals)
    return ClusterSnapshot(nodes=nodes, pods=residents, now=50.0), arrivals


def sweep_device(n_nodes, model, pods):
    """The device arm of phase 11 (b) on a fresh world: ``(answers,
    seconds)``, timed after one warm-up selection."""
    kw = model.lowering_kwargs()
    snapshot, _ = storm_world(n_nodes, 0)
    arrays = lower_nodes(snapshot, **kw)
    resident = model.lower_residents(snapshot, arrays)
    world = model.resident_world(resident)
    model.select_victims_device(arrays, resident, pods[0], world=world)
    torch.cuda.synchronize()
    hits = []
    t0 = time.perf_counter()
    for pod in pods:
        got = model.select_victims_device(arrays, resident, pod, world=world)
        if got is not None:
            evict_resident_rows(snapshot, arrays, resident, *got, **kw)
        hits.append(got)
    return hits, time.perf_counter() - t0


def sweep_host(n_nodes, model, pods):
    """The host arm of phase 11 (b) on a fresh world: ``(answers,
    seconds)``."""
    kw = model.lowering_kwargs()
    snapshot, _ = storm_world(n_nodes, 0)
    arrays = lower_nodes(snapshot, **kw)
    thresholds = (model.params.thresholds.cpu().numpy(),
                  model.params.prod_thresholds.cpu().numpy())
    hits = []
    t0 = time.perf_counter()
    for pod in pods:
        got = find_preemption(snapshot, pod, arrays=arrays,
                              thresholds=thresholds[0],
                              prod_thresholds=thresholds[1])
        if got is not None:
            gone = {v.uid for v in got[1]}
            snapshot.pods = [p for p in snapshot.pods if p.uid not in gone]
            arrays = lower_nodes(snapshot, **kw)
            got = (got[0], [v.uid for v in got[1]])
        hits.append(got)
    return hits, time.perf_counter() - t0


def spread(values, fmt="{:.1f}") -> str:
    """``median (min-max)`` of ``values``."""
    values = sorted(values)
    return (fmt.format(statistics.median(values)) + " ("
            + fmt.format(values[0]) + "-" + fmt.format(values[-1]) + ")")


def victim_sweep(n_nodes, card) -> None:
    """Phase 11 (b): the first SWEEP_PODS arrivals, evicting as they go,
    on the card (``select_victims_device`` + ``evict_resident_rows``)
    and on the host (``find_preemption`` + a full re-lower per hit),
    SWEEP_REPEATS times each, the arms in turns, each on a fresh world."""
    model = PlacementModel()
    _, pods = storm_world(n_nodes, SWEEP_PODS)
    device_rate, host_rate, ratio = [], [], []
    for rep in range(SWEEP_REPEATS):
        device_hits, device_s = sweep_device(n_nodes, model, pods)
        host_hits, host_s = sweep_host(n_nodes, model, pods)
        assert device_hits == host_hits, f"device sweep != host walk ({rep})"
        hits = sum(h is not None for h in device_hits)
        assert hits == len(pods), hits
        device_rate.append(len(pods) / device_s)
        host_rate.append(len(pods) / host_s)
        ratio.append(host_s / device_s)
    evictions = sum(len(h[1]) for h in device_hits)
    print(f"victim sweep, {n_nodes} nodes x {STORM_RPN} residents, "
          f"{len(pods)} preemptors, {SWEEP_REPEATS} repeats [{card}]: "
          f"device == host walk every repeat ({hits} hits, {evictions} "
          f"evictions); median (min-max): device {spread(device_rate)} "
          f"pods/s, host {spread(host_rate)} pods/s, device / host "
          f"{spread(ratio, '{:.2f}')}; per repeat device "
          f"{[round(x, 1) for x in device_rate]}, host "
          f"{[round(x, 2) for x in host_rate]}", flush=True)


def scan_wave(card) -> None:
    """Phase 11 (c): ``preempt_scan_device`` over the whole wave in one
    call on the card (timed after a warm-up call), equal to the CPU
    model's."""
    snapshot, pods = storm_world(STORM_NODES, STORM_ARRIVALS)
    out = {}
    for device in ("cuda", "cpu"):
        model = PlacementModel(device=device)
        arrays = lower_nodes(snapshot, **model.lowering_kwargs())
        resident = model.lower_residents(snapshot, arrays)
        world = model.resident_world(resident)
        model.preempt_scan_device(arrays, resident, pods[:4], world=world)
        t0 = time.perf_counter()
        out[device] = model.preempt_scan_device(arrays, resident, pods,
                                                world=world)
        out[device + "_s"] = time.perf_counter() - t0
    assert out["cuda"] == out["cpu"], "preempt_scan_device: cuda != cpu"
    hits = sum(h is not None for h in out["cuda"])
    print(f"preempt_scan_device, {STORM_NODES} nodes x {STORM_RPN} "
          f"residents, {len(pods)} preemptors in one call [{card}]: cuda == "
          f"cpu ({hits} hits); wall {out['cuda_s']:.4f} s "
          f"({len(pods) / out['cuda_s']:.1f} pods/s), cpu "
          f"{out['cpu_s']:.4f} s", flush=True)


def defrag_check(card) -> None:
    """Phase 11 (d): ``defrag_headroom`` on the storm world with the
    "verify" backend (device plan == host plan, else it raises)."""
    sched = storm_scheduler(backend="verify")
    arrival = next(iter(sched.cache.pending.values()))
    target = resources_to_vector(arrival.requests)
    t0 = time.perf_counter()
    plan = sched.defrag_headroom(target, DEFRAG_MAX_PRIORITY, now=50.0)
    wall = time.perf_counter() - t0
    assert plan is not None and plan[1], plan
    print(f"defrag_headroom, verify backend [{card}]: device plan == host "
          f"plan: drain {len(plan[1])} pods on {plan[0]} for a hole of "
          f"{target[:2].tolist()}; wall {wall:.4f} s (both plans)",
          flush=True)


class RecordingSink(Evictor):
    """Approves every eviction and mutates nothing, so every pass sees
    the same world (the reference's bench sink); with ``arbiter`` each
    eviction asks the arbiter first."""

    def _do_evict(self, snapshot, pod, reason):
        return True


def rebalance_pool(low, high) -> NodePool:
    cpu, mem = ResourceName.CPU, ResourceName.MEMORY
    return NodePool(low_thresholds={cpu: low[0], mem: low[1]},
                    high_thresholds={cpu: high[0], mem: high[1]})


def rebalance_snapshot(spec):
    return testing.build_snapshot(spec, ttypes, ResourceName)


def zero_launches() -> None:
    rb.LAUNCHES.update({name: 0 for name in rb.LAUNCHES})
    for kind in bk.LAUNCHES:
        bk.LAUNCHES[kind] = 0


def balance_pass(snapshot, pool, backend, arbiter=None):
    """One ``LowNodeLoad.balance`` on ``backend`` ("device": the sweep
    kernel on the card), every launch count zeroed just before and read
    just after (a device synchronise ends the timed span); a device pass
    must take the scan route only. Returns ``(ordered evictions, wall_s,
    scan kernel launches, the DeviceSweeps the pass staged, the sink)``."""
    made = []
    base = loadaware.DeviceSweep

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    loadaware.DeviceSweep = Recorded
    try:
        plugin = LowNodeLoad(LowNodeLoadArgs(node_pools=[pool],
                                             backend=backend))
        sink = RecordingSink(arbiter=arbiter)
        zero_launches()
        t0 = time.perf_counter()
        plugin.balance(snapshot, sink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rb.LAUNCHES)
    finally:
        loadaware.DeviceSweep = base
    assert not any(bk.LAUNCHES.values()), bk.LAUNCHES
    assert launches["rebalance_sweep"] == 0, launches
    if backend == "host":
        assert not any(launches.values()) and not made, (launches, len(made))
    else:
        assert launches["rebalance_scan"] >= 1 and len(made) == 1, (
            launches, len(made))
        assert made[0].route == "scan", made[0].route
    return ([(p.node_name, p.uid) for p in sink.evicted], wall,
            launches["rebalance_scan"], made, sink)


def sweep_bound(sweep):
    """(bound_ms, bound_by) of one sweep over ``sweep``'s batch: every
    input (the batch, the blocked mask, the headroom and the resource
    mask) read once and every output (three bytes per candidate, the
    final headroom) written once at the memory rate, against
    SWEEP_OPS_PER_CANDIDATE at the scalar rate."""
    k = sweep.k
    nbytes = sum(t.numel() * t.element_size() for t in sweep.batch)
    nbytes += k + 4 * 8 + 8           # blocked, available, res_mask
    nbytes += 3 * k + 4 * 8           # the streams, the final available
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = k * SWEEP_OPS_PER_CANDIDATE / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_entry(name, sweep, launches, label, card, reps=5,
                route="scan") -> dict:
    """Both sweep kernels on a pass's staged batch (nothing blocked) held
    against the plain version on the card (tolerance: exact, the three
    streams and the final headroom) and timed in turns (route, other,
    other, route; ``reps`` launches each after the comparison's launch as
    warm-up), the plain version over its one comparison run. Returns the
    ``kernels`` line entry of ``route``'s kernel (``route`` must be the
    batch's own)."""
    assert sweep.route == route, (sweep.route, route)
    blocked = torch.zeros(sweep.k, dtype=torch.bool, device=sweep.device)
    args = (sweep.batch, blocked, sweep.available, sweep.res_mask)
    want = []
    plain_ms = cuda_ms(lambda: want.append(rb._balance_sweep(
        *sweep.batch, *args[1:])), 1)
    streams, avail = want[0]
    other = "serial" if route == "scan" else "scan"
    routes = (route, other) if route == "scan" else (route,)
    err = 0
    for r in routes:
        got = rb._launch(*args, r)
        torch.cuda.synchronize()
        for g, w, what in ((got[0][0], streams[0], "propose"),
                           (got[0][1], streams[1], "over"),
                           (got[0][2], streams[2], "avail_ok"),
                           (got[1], avail, "available")):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"sweep kernel ({r}) != plain version on {what}")
            if g.numel() and r == route:
                err = max(err, int((g.long() - w.long()).abs().max()))
    times = {r: [] for r in routes}
    for r in routes + routes[::-1]:
        times[r].append(device_ms(
            lambda: rb._launch(*args, r), reps))
    ms = min(times[route])
    bound_ms, bound_by = sweep_bound(sweep)
    proposed = int(streams[0].sum())
    beside = "".join(f", the {r} kernel {min(t):.4f} ms" for r, t in
                     times.items() if r != route)
    print(f"{label}: {route} kernel == plain version ({proposed}/{sweep.k} "
          f"proposed, max_abs_err {err}) [{card}]: kernel {ms:.4f} ms "
          f"({ms / max(sweep.k, 1) * 1e6:.1f} ns per candidate; in turns "
          f"{', '.join(f'{t:.4f}' for t in times[route])}){beside}, plain "
          f"version on the card {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}); launches on the path {launches}", flush=True)
    return dict(name=name, source=SWEEP_SOURCE, replaces=SWEEP_REPLACES,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def rebalance_config5(card) -> dict:
    """Phase 12 (a): bench config #5 at full size through ``LowNodeLoad``
    on every backend, equal to the port's oracle; balance() walls in
    turns; the sweep kernel on the pass's batch."""
    t0 = time.perf_counter()
    snap = rebalance_snapshot(testing.rebalance_world_spec(
        REBAL_NODES, REBAL_PODS, seed=REBAL_SEED))
    build_s = time.perf_counter() - t0
    pool = rebalance_pool(REBAL_LOW, REBAL_HIGH)
    seq, wall, launches, sweeps, _ = balance_pass(snap, pool, "device")
    t0 = time.perf_counter()
    want = RebalanceOracle(LowNodeLoadArgs(node_pools=[pool])).sweep(snap)
    oracle_s = time.perf_counter() - t0
    walls = {"host": [], "device": [], "verify": []}
    for rep in range(BALANCE_REPEATS):
        for backend in walls:
            got, w, *_ = balance_pass(snap, pool, backend)
            assert got == want, f"config #5 {backend} != oracle ({rep})"
            walls[backend].append(w)
    assert seq == want and want, "config #5: device != oracle"
    drained = len({n for n, _ in want})
    print(f"rebalance config #5, {REBAL_NODES} nodes x {REBAL_PODS} pods "
          f"[{card}]: host == device == verify == oracle: {len(want)} "
          f"evictions, {drained} nodes drained, {sweeps[0].k} candidates; "
          f"world built in {build_s:.2f} s, oracle {oracle_s:.2f} s; "
          f"balance() median (min-max) of {BALANCE_REPEATS}, in turns: "
          + ", ".join(f"{b} {spread(v, '{:.4f}')} s"
                      for b, v in walls.items())
          + f"; first device pass {wall:.4f} s, {launches} sweep launch",
          flush=True)
    return sweep_entry("rebalance_scan_config5", sweeps[0], launches,
                       "rebalance config #5's sweep", card)


def storm22_scheduler(spec, budget):
    """``Scheduler()`` on the card fed config #22's world (nodes, node
    metrics, the running pods) and one pod that fits nowhere, so every
    round solves; with the arbiter at ``budget``."""
    sched = Scheduler()
    sched.migration_arbiter = MigrationArbiter(budget)
    snap = rebalance_snapshot(spec)
    for node in snap.nodes:
        sched.add_node(node)
    for metric in snap.node_metrics.values():
        sched.update_node_metric(metric)
    for pod in snap.pods:
        sched.add_pod(pod)
    sched.add_pod(ttypes.PodSpec(name="unplaceable", requests={
        ResourceName.CPU: 10**6}))
    return sched


def rebalance_storm(card) -> dict:
    """Phase 12 (b): bench config #22 at the reference's default, device
    against host, the budgeted arm (``max_per_node=1``), then the same
    world and arbiter through ``Scheduler.rebalance_sweep`` and the next
    round's delta staging against a fresh staging."""
    spec = testing.rebalance_storm_spec(STORM22_NODES, STORM22_PPN,
                                        seed=STORM22_SEED)
    snap = rebalance_snapshot(spec)
    pool = rebalance_pool(STORM22_LOW, STORM22_HIGH)
    dev_seq, dev_wall, dev_launches, sweeps, _ = balance_pass(snap, pool,
                                                              "device")
    host_seq, host_wall, *_ = balance_pass(snap, pool, "host")
    assert dev_seq == host_seq and host_seq, "config #22: device != host"
    arbiter = MigrationArbiter(MigrationBudget(max_per_node=1))
    refuse = rb.DeviceSweep.refuse
    refused, walls = [], []

    def timed_refuse(self, j):
        t0 = time.perf_counter()
        try:
            return refuse(self, j)
        finally:
            walls.append(time.perf_counter() - t0)
            refused.append(j)

    rb.DeviceSweep.refuse = timed_refuse
    try:
        budget_seq, budget_wall, rescans, budgeted, sink = balance_pass(
            snap, pool, "device", arbiter=arbiter)
    finally:
        rb.DeviceSweep.refuse = refuse
    host_budget_seq, host_budget_wall, *_ = balance_pass(
        snap, pool, "host",
        arbiter=MigrationArbiter(MigrationBudget(max_per_node=1)))
    assert budget_seq == host_budget_seq, "budgeted arm: device != host"
    assert rescans == len(refused) + 1, (rescans, len(refused))
    kernel_ms = replay_refusals(budgeted[0], refused)
    status = arbiter.status()
    hot = {n for n, _ in host_seq}
    budget_bounded = (
        len(sink.evicted) <= len(hot)
        and all(c <= 1 for c in status["window_nodes"].values())
        and status["deferred_total"] > 0
        and set(status["deferred_by_reason"]) <= {"node-budget", "cooldown"})
    assert budget_bounded, status
    print(f"rebalance config #22, {STORM22_NODES} nodes x {STORM22_PPN} pods "
          f"per hot node [{card}]: device == host: {len(host_seq)} evictions "
          f"({sweeps[0].k} candidates); balance() device {dev_wall:.4f} s "
          f"({dev_launches} launch), host {host_wall:.4f} s; budgeted arm "
          f"(max_per_node=1): {len(sink.evicted)} evicted, "
          f"{status['deferred_total']} deferred "
          f"{status['deferred_by_reason']}, budget_bounded true, "
          f"{rescans} sweep launches (one per refusal, and the first), "
          f"== the host backend's arm ({host_budget_wall:.4f} s); wall "
          f"{budget_wall:.4f} s, {budget_wall / rescans * 1e3:.4f} ms per "
          f"launch; a re-scan (DeviceSweep.refuse: launch, suffix read-back,"
          f" splice) median {statistics.median(walls) * 1e3:.4f} ms (min "
          f"{min(walls) * 1e3:.4f}, max {max(walls) * 1e3:.4f}), the scan "
          f"kernel per re-scan {kernel_ms:.4f} ms (CUDA events, the "
          f"re-scans replayed back to back)", flush=True)
    sched = storm22_scheduler(spec, MigrationBudget(max_per_node=1))
    _, launched, _, _ = drive(lambda: sched.schedule_pending(now=110.0))
    assert sum(launched.values()) == 1, launched
    plugin = LowNodeLoad(LowNodeLoadArgs(node_pools=[pool],
                                         backend="device"))
    zero_launches()
    t0 = time.perf_counter()
    evicted = sched.rebalance_sweep(plugin, now=120.0)
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t0
    sched_launches = rb.LAUNCHES["rebalance_scan"]
    assert rb.LAUNCHES["rebalance_sweep"] == 0, rb.LAUNCHES
    assert sched_launches == rescans, (sched_launches, rescans)
    assert evicted == [p.uid for p in sink.evicted], "Scheduler != sink arm"
    assert not set(evicted) & set(sched.cache.pods)
    fresh = []
    dispatch = sched.model.schedule_async

    def record(snapshot):
        fresh.append(sched.model.stage_nodes(
            lower_nodes(snapshot, **sched.model.lowering_kwargs())))
        return dispatch(snapshot)

    sched.model.schedule_async = record
    sched.schedule_pending(now=121.0)
    assert sched.model.last_staging == "delta", sched.model.last_staging
    state = sched.model.staged_cache.state
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(fresh[-1], f)), f
    print(f"Scheduler.rebalance_sweep with the arbiter [{card}]: "
          f"{len(evicted)} evicted == the budgeted arm's, "
          f"{sched_launches} scan kernel launches, wall {sweep_wall:.4f} s; the "
          f"next round's delta staging == a fresh staging", flush=True)
    return sweep_entry("rebalance_scan_config22_budgeted", budgeted[0],
                       rescans, "rebalance config #22's sweep", card)


def replay_refusals(sweep, refused) -> float:
    """The scan kernel's ms per re-scan of the budgeted arm: its
    refusals replayed in order on the arm's staged batch (the mask
    cleared, each launch blocking its candidate on the device), queued
    back to back in runs of REPLAY_CHUNK (CUDA events); the replay's
    final mask must equal the arm's."""
    sweep.blocked.zero_()
    streams = torch.empty((3, sweep.k), dtype=torch.bool,
                          device=sweep.device)
    total = 0.0
    for at in range(0, len(refused), REPLAY_CHUNK):
        chunk = refused[at:at + REPLAY_CHUNK]
        it = iter(chunk)
        total += device_ms(lambda: rb._launch(
            sweep.batch, sweep.blocked, sweep.available, sweep.res_mask,
            "scan", next(it), streams), len(chunk)) * len(chunk)
    want = np.zeros(sweep.k, bool)
    want[refused] = True
    assert np.array_equal(sweep.blocked.cpu().numpy(), want)
    return total / max(len(refused), 1)


def rebalance_serial(card) -> dict:
    """Phase 12 (d): a batch whose high_q varies inside its nodes goes
    through ``run_balance_sweep`` on the serial route; the serial kernel
    held against the plain version and timed; an empty launch timed."""
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        VARIED_SEED, VARIED_K)
    rng = np.random.default_rng(VARIED_SEED)
    arrays["high_q"] = arrays["high_q"] + rng.integers(
        -3_000, 3_000, arrays["high_q"].shape)
    batch = rb.SweepBatch(**arrays)
    assert rb.sweep_route(batch.node_start, batch.high_q) == "serial"
    zero_launches()
    got = rb.run_balance_sweep(batch, available, res_mask, blocked)
    torch.cuda.synchronize()
    launches = dict(rb.LAUNCHES)
    assert launches == {"rebalance_scan": 0, "rebalance_sweep": 1}, launches
    want = rb.replay_sweep_host(batch, available, res_mask, blocked)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    empty_ms = device_ms(lambda: rb.launch_empty("cuda"), EMPTY_REPS)
    print(f"serial route [{card}]: {VARIED_K} candidates, high_q varied "
          f"inside nodes: run_balance_sweep launched the serial kernel "
          f"once, == the host replica; an empty kernel at the scan "
          f"kernel's launch shape {empty_ms:.4f} ms per launch (CUDA "
          f"events, {EMPTY_REPS} back to back)", flush=True)
    sweep = rb.DeviceSweep(batch, available, res_mask)
    return sweep_entry("rebalance_sweep_serial_varied_high_q", sweep,
                       launches["rebalance_sweep"],
                       "the serial route's batch", card, route="serial")


def rebalance_wide(card) -> dict:
    """Phase 12 (c): config #22 widened to the main path's node count, no
    budget, device against host; the sweep kernel at that K."""
    snap = rebalance_snapshot(testing.rebalance_storm_spec(
        STORM22_WIDE_NODES, STORM22_PPN, seed=STORM22_SEED))
    pool = rebalance_pool(STORM22_LOW, STORM22_HIGH)
    dev_seq, dev_wall, launches, sweeps, _ = balance_pass(snap, pool,
                                                          "device")
    host_seq, host_wall, *_ = balance_pass(snap, pool, "host")
    assert dev_seq == host_seq and host_seq, "config #22 wide: device != host"
    print(f"rebalance config #22 widened, {STORM22_WIDE_NODES} nodes "
          f"[{card}]: device == host: {len(host_seq)} evictions "
          f"({sweeps[0].k} candidates); balance() device {dev_wall:.4f} s "
          f"({launches} launch), host {host_wall:.4f} s", flush=True)
    return sweep_entry("rebalance_scan_config22_wide", sweeps[0], launches,
                       f"config #22 at {STORM22_WIDE_NODES} nodes' sweep",
                       card)


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
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "smem" in line):
            print(f"ptxas: {line.strip()}", flush=True)
    print(f"rebalance_scan_kernel: {bk._library().rebalance_scan_shared_bytes()}"
          " B of dynamic shared memory per CTA", flush=True)

    # -- 2. the routed kernel vs its plain twin on the card -------------------
    state, pods, params = testing.example_problem(NODES, PENDING, seed=1)
    plain = compare(bk.kernel_inputs(state, pods, params),
                    f"plain {NODES} nodes x {PENDING} pods", card)
    state, pods, params, quota, gang = testing.quota_gang_problem(
        QUOTA_NODES, QUOTA_PODS, QUOTAS, GANGS, GANG_SIZE, seed=1)
    kernels = [solve_entry(
        f"quota+gang {QUOTA_NODES} nodes x {pods.req.shape[0]} pods "
        f"({QUOTAS} quotas, {GANGS} gangs x {GANG_SIZE})",
        lambda: bk.kernel_solve_batch(state, pods, params, quota, gang),
        card, "block", 93)]
    state, pods, params, quota, gang = testing.quota_gang_problem(
        WIDE_NODES, WIDE_PODS, WIDE_QUOTAS, 20, 8, seed=2)
    kernels.append(solve_entry(
        f"quota+gang {WIDE_NODES} nodes x {pods.req.shape[0]} pods "
        f"({WIDE_QUOTAS} quotas: tables in device memory)",
        lambda: bk.kernel_solve_batch(state, pods, params, quota, gang),
        card, "block", 282, name="binpack_quota_in_device_memory",
        quota_shared=False))

    # -- 3. the main path ------------------------------------------------------
    def snapshot():
        snap, _ = testing.churn_world(
            NODES, assigned_per_node=ASSIGNED_PER_NODE, seed=42)
        return testing.add_pending_wave(snap, PENDING, n_quota=QUOTAS,
                                        n_gangs=GANGS, gang_size=GANG_SIZE,
                                        seed=7)

    _, launches, captured = schedule_path(snapshot, "main path", card,
                                          "cluster")

    # -- 4. the kernel at the main path's inputs --------------------------------
    main = compare(captured[0][0], "the main path's inputs", card, reps=5)
    main["max_abs_err"] = max(main["max_abs_err"], plain["max_abs_err"])
    kernels.append(entry("binpack", launches, main, 317))

    # -- 5. the reservation main path --------------------------------------------
    def resv_snapshot():
        return testing.add_reservations(snapshot(), LABEL_RESV,
                                        MIGRATION_RESV, seed=11)

    result, launches, captured = schedule_path(
        resv_snapshot, "reservation main path", card, "cluster")
    n_resv = captured[0][0].resv[0].shape[0]
    assert n_resv == LABEL_RESV + MIGRATION_RESV, n_resv
    consumed = len(result.resv_committed) + len(result.resv_allocs)
    assert consumed > 0, "no pod consumed a reservation"
    print(f"reservation main path: {n_resv} reservations, {consumed} pods "
          f"consumed one ({len(result.resv_committed)} committed, "
          f"{len(result.resv_allocs)} waiting)", flush=True)
    resv = compare(captured[0][0], "the reservation main path's inputs", card,
                   reps=5)
    kernels.append(entry("binpack", launches, resv, 205))

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
        inp, route = routed(f"fused solve, NUMA {scorer}", launches,
                            captured, "cluster")
        placed = int(solved.commit.sum())
        took_numa = int(solved.numa_consumed.sum())
        took_resv = int((solved.resv_vstar >= 0).sum())
        assert placed > 0 and took_numa > 0 and took_resv > 0
        print(f"fused solve, NUMA {scorer} [{card}]: {FUSED_NODES} nodes x "
              f"{FUSED_PODS} pods, quota+gang+numa+resv: {placed} committed, "
              f"{took_numa} took NUMA, {took_resv} consumed a reservation; "
              f"wall {wall:.4f} s; route {route_name(route)}; launches "
              f"{launches[route.kind]}", flush=True)
        fused = compare(inp, f"config #8, NUMA {scorer}", card, reps=3)
        loop_check(most, card)
        kernels.append(entry("binpack", launches[route.kind], fused, 259))
    kernels.append(extras_loop_check(card))
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        BLOCK_NODES, BLOCK_PODS, seed=8)
    for most in (False, True):
        kernels.append(solve_entry(
            f"config #8 cut to {BLOCK_NODES} x {BLOCK_PODS}, NUMA "
            f"{'most' if most else 'least'}",
            lambda: bk.kernel_solve_batch(s_, p_, pr, q, g, numa_aux=aux,
                                          resv=rv, most_allocated=most),
            card, "block", 259))
    kernels.append(solve_entry(
        f"config #8 cut to {BLOCK_NODES} x {BLOCK_PODS}, no NUMA",
        lambda: bk.kernel_solve_batch(s_, p_, pr, q, g, resv=rv),
        card, "block", 205))

    # -- 7. the cluster kernel at every CTA count ---------------------------------
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
    reduced = compare(
        bk.kernel_inputs(state, pods, params, bk.quota_inputs(quota)),
        f"quota+gang {QUOTA_NODES} nodes x {pods.req.shape[0]} pods", card,
        shards=QUOTA_SHARDS)
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        LOOP_NODES, LOOP_PODS, seed=8)
    reduced_fused = compare(
        bk.kernel_inputs(s_, p_, pr, bk.quota_inputs(q), numa_aux=aux,
                         resv=rv, most_allocated=True),
        f"config #8 cut to {LOOP_NODES} nodes x {LOOP_PODS} pods, NUMA most "
        "+ reservations", card, shards=LOOP_SHARDS)
    main_sharded["max_abs_err"] = max(main_sharded["max_abs_err"],
                                      reduced["max_abs_err"])
    fused_sharded["max_abs_err"] = max(fused_sharded["max_abs_err"],
                                       reduced_fused["max_abs_err"])
    kernels += [main_sharded, fused_sharded]

    # -- 8. past 16 CTAs' shared memory: the L2 form --------------------------
    state, pods, params, quota, gang = testing.quota_gang_problem(
        L2_NODES, L2_QUOTA_PODS, QUOTAS, L2_GANGS, L2_GANG_SIZE, seed=3)
    kernels.append(solve_entry(
        f"quota+gang {L2_NODES} nodes x {pods.req.shape[0]} pods",
        lambda: bk.kernel_solve_batch(state, pods, params, quota, gang),
        card, "l2", 317))

    # -- 9. the scheduling round on the card -----------------------------------
    scheduler_burst(snapshot, card)
    launches, inp = churn_ticks(card)
    churn = compare(inp, f"churn tick, {CHURN_NODES} x {CHURN_PENDING}", card,
                    reps=5)
    kernels.append(entry("binpack_churn_tick", launches, churn, 317))

    # -- 10. the fine-grained burst through the Scheduler ----------------------
    kernels += fine_grained_burst(card)

    # -- 11. preemption on the card ----------------------------------------------
    kernels.extend(storm_rounds(card))
    for n_nodes in (STORM_NODES, SWEEP_WIDE_NODES):
        victim_sweep(n_nodes, card)
    scan_wave(card)
    defrag_check(card)

    # -- 12. descheduling on the card ------------------------------------------
    kernels.append(rebalance_config5(card))
    kernels.append(rebalance_storm(card))
    kernels.append(rebalance_wide(card))
    kernels.append(rebalance_serial(card))

    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
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
