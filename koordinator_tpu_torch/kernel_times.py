"""Time the cluster placement kernel of one checkout of this repository.

    python3 koordinator_tpu_torch/kernel_times.py [--tree DIR]

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

It calls only entry points that every checkout since the cluster kernel
was added has, so two trees can be compared on one card: unpack the
other one (``git archive``) into a directory git ignores and run the
script for each tree in turns (a, b, b, a) on one machine. Prints one
JSON line: the tree, the card, and for each input and k the kernel's ms
per solve and the pods it placed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHARDS = (2, 4, 8, 16)
REPS = 5


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
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

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
    solve = placement.kernel_solve_batch

    def record(*a, **kw):
        calls.append(a)
        return solve(*a, **kw)

    snap = testing.add_pending_wave(
        testing.churn_world(5000, assigned_per_node=2, seed=42)[0], 10000,
        n_quota=50, n_gangs=200, gang_size=32, seed=7)
    placement.kernel_solve_batch = record
    try:
        placement.PlacementModel().schedule(snap)
    finally:
        placement.kernel_solve_batch = solve
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


if __name__ == "__main__":
    sys.exit(main())
