"""Time the cluster placement kernel, or the balance sweep kernel, of one
checkout of this repository.

    python3 koordinator_tpu_torch/kernel_times.py [--tree DIR] [--sweep]

Imports ``koordinator_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernel library, and times the cluster
kernel, ``ops/binpack_kernel.binpack_sharded``, on the inputs that
``parallel/mesh.shard_kernel_solver(k)`` hands it (CUDA events, 5
launches after one warm-up):

- the main path's solve: the arguments ``PlacementModel().schedule``
  gives ``kernel_solve_batch`` on 5,000 nodes, 10,000 assigned and
  10,000 pending pods (``chip_smoke.py`` phase 3), at k = 2, 4, 8, 16;
- bench config #8, ``testing.full_features_problem(5000, 10000)`` with
  NUMA least and reservations (``chip_smoke.py`` phase 6), at the same k;
- ``testing.quota_gang_problem(40000, 600, 50, 20, 20)`` (``chip_smoke.py``
  phase 8) at k = 16.

With ``--sweep`` it times the balance sweep's kernels instead, with
nothing blocked, on the batch that ``LowNodeLoad``'s "device" backend
stages (``chip_smoke.py`` phase 12): bench config #5
(``testing.rebalance_world_spec(5000, 30000)``) and config #22
(``testing.rebalance_storm_spec``) at 400 and 5,000 nodes; each kernel
the tree has ("scan" and "serial", each through ``ops/rebalance._launch``,
where the tree has ``sweep_route``, else its one kernel, "serial",
through ``balance_sweep``) on the same batch,
queued back to back behind a sleeping kernel (CUDA events). Then the
budgeted arm of config #22 at 400 nodes (``MigrationArbiter(
MigrationBudget(max_per_node=1))``, one re-scan per refusal): the
``balance()`` wall and the sweep launches of each of ``ARM_REPEATS``
passes.

It calls only entry points that every checkout since the kernel it times
was added has, so two trees can be compared on one card: unpack the
other one (``git archive``) into a directory git ignores and run the
script for each tree in turns (a, b, b, a) on one machine. Prints one
JSON line: the tree, the card, and for each input (and k) the kernel's
ms per launch and what it placed or proposed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHARDS = (2, 4, 8, 16)
REPS = 5
ARM_REPEATS = 3
#: cycles the card sleeps per queued sweep launch (~115 us at 1.7 GHz)
SLEEP_CYCLES_PER_CALL = 200_000


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve()
                                              .parents[1]))
    parser.add_argument("--sweep", action="store_true",
                        help="time the balance sweep kernel")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    if args.sweep:
        return _sweep_times(args.tree)

    import torch

    from koordinator_tpu_torch import testing
    from koordinator_tpu_torch.models import placement
    from koordinator_tpu_torch.ops import binpack_kernel as bk
    from koordinator_tpu_torch.parallel.mesh import shard_kernel_solver

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bk.build_library()

    def inputs(solve):
        """The kernel inputs ``solve()`` hands ``binpack_sharded``."""
        seen = []
        launch = bk.binpack_sharded

        def capture(inp, shards):
            seen.append(inp)
            return launch(inp, shards)

        bk.binpack_sharded = capture
        try:
            solve()
        finally:
            bk.binpack_sharded = launch
        assert len(seen) == 1, len(seen)
        return seen[0]

    def timed(inp, k):
        out = bk.binpack_sharded(inp, k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            bk.binpack_sharded(inp, k)
        end.record()
        torch.cuda.synchronize()
        return dict(ms=start.elapsed_time(end) / REPS,
                    placed=int((out.assign >= 0).sum()))

    calls = []
    binding = placement._jit_solve

    def record(*a):
        calls.append(a[:3] + a[4:6])  # state, pods, params, quota, gang
        return binding(*a)

    snap = testing.add_pending_wave(
        testing.churn_world(5000, assigned_per_node=2, seed=42)[0], 10000,
        n_quota=50, n_gangs=200, gang_size=32, seed=7)
    placement._jit_solve = record
    try:
        placement.PlacementModel().schedule(snap)
    finally:
        placement._jit_solve = binding
    main_args = calls[0][:5]
    fused = testing.full_features_problem(5000, 10000, seed=8)
    state, pods, params, quota, gang = testing.quota_gang_problem(
        40000, 600, 50, 20, 20, seed=3)
    times = {}
    for k in SHARDS:
        times[f"main_path_k{k}"] = timed(inputs(
            lambda: shard_kernel_solver(k)(*main_args)), k)
        s_, p_, pr, q, g, rv, aux = fused
        times[f"config8_numa_least_resv_k{k}"] = timed(inputs(
            lambda: shard_kernel_solver(k)(s_, p_, pr, q, g, aux, rv)), k)
    times["quota_40000x1000_k16"] = timed(inputs(
        lambda: shard_kernel_solver(16)(state, pods, params, quota, gang)), 16)
    print(json.dumps({"tree": args.tree, "card": _card(), "reps": REPS,
                      "times": times}), flush=True)
    return 0


def _sweep_times(tree) -> int:
    import statistics
    import time

    import torch

    from koordinator_tpu_torch import testing
    from koordinator_tpu_torch.apis import types
    from koordinator_tpu_torch.apis.extension import ResourceName
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
    from koordinator_tpu_torch.ops import binpack_kernel as bk
    from koordinator_tpu_torch.ops import rebalance as rb

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bk.build_library()

    class Sink(Evictor):
        def _do_evict(self, snapshot, pod, reason):
            return True

    def pool_of(low, high):
        cpu, mem = ResourceName.CPU, ResourceName.MEMORY
        return NodePool(low_thresholds={cpu: low[0], mem: low[1]},
                        high_thresholds={cpu: high[0], mem: high[1]})

    def staged(spec, low, high):
        """The DeviceSweep one device pass stages for ``spec`` with a pool
        of ``low``/``high`` (CPU, memory) percent."""
        pool = pool_of(low, high)
        made = []
        base = loadaware.DeviceSweep

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        loadaware.DeviceSweep = Recorded
        try:
            LowNodeLoad(LowNodeLoadArgs(node_pools=[pool], backend="device")
                        ).balance(testing.build_snapshot(
                            spec, types, ResourceName), Sink())
        finally:
            loadaware.DeviceSweep = base
        assert len(made) == 1, len(made)
        return made[0]

    # a tree with routes has both kernels, each launched by rb._launch;
    # a tree from before the scan kernel has only the serial one, behind
    # balance_sweep
    routed = hasattr(rb, "sweep_route")

    def timed(sweep):
        blocked = torch.zeros(sweep.k, dtype=torch.bool, device=sweep.device)
        args = (sweep.batch, blocked, sweep.available, sweep.res_mask)
        out = dict(k=sweep.k)
        for route in ("scan", "serial") if routed else ("serial",):
            def sweep_once(route=route):
                if routed:
                    return rb._launch(*args, route)
                return rb.balance_sweep(*args)

            streams, _ = sweep_once()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * REPS)
            start.record()
            for _ in range(REPS):
                sweep_once()
            end.record()
            torch.cuda.synchronize()
            out[f"{route}_ms"] = start.elapsed_time(end) / REPS
            out["proposed"] = int(streams[0].sum())
        return out

    def budgeted_arm():
        snap = testing.build_snapshot(testing.rebalance_storm_spec(
            400, 10, seed=22), types, ResourceName)
        plugin = LowNodeLoad(LowNodeLoadArgs(node_pools=[pool_of(
            (30, 30), (60, 60))], backend="device"))
        walls, launches = [], []
        for _ in range(ARM_REPEATS):
            sink = Sink(arbiter=MigrationArbiter(MigrationBudget(
                max_per_node=1)))
            before = sum(rb.LAUNCHES.values())
            t0 = time.perf_counter()
            plugin.balance(snap, sink)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(sum(rb.LAUNCHES.values()) - before)
        return dict(walls=walls, median_s=statistics.median(walls),
                    launches=launches, evicted=len(sink.evicted))

    times = {
        "config5": timed(staged(testing.rebalance_world_spec(
            5000, 30000, seed=5), (45, 60), (65, 80))),
        "config22": timed(staged(testing.rebalance_storm_spec(
            400, 10, seed=22), (30, 30), (60, 60))),
        "config22_5000_nodes": timed(staged(testing.rebalance_storm_spec(
            5000, 10, seed=22), (30, 30), (60, 60))),
        "config22_budgeted_arm": budgeted_arm(),
    }
    print(json.dumps({"tree": tree, "card": _card(), "reps": REPS,
                      "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
