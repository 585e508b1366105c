"""The colocation loop on the card against the CPU (``cuda``: skipped
without an NVIDIA GPU).

This file imports no JAX, so it runs on a machine with a GPU and no JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_colocation_cuda.py``."""

import os

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.client import APIServer, Kind, wire_manager, wire_scheduler
from koordinator_tpu_torch.manager import noderesource as nr
from koordinator_tpu_torch.manager import sloconfig
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops.overcommit import (
    NodeOvercommitInputs,
    OvercommitParams,
    PodOvercommitInputs,
)
from koordinator_tpu_torch.scheduler.scheduler import Scheduler

pytestmark = pytest.mark.cuda

# the warm pool stays inert unless a test configures its store, as
# tests/conftest.py keeps it for the CPU suite (these files also run
# under --noconftest, where a default store in the home directory
# would restore earlier runs' entries and count their launches)
os.environ.setdefault("KTPU_COMPILATION_CACHE_DIR", "")


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _spec(seed, n_nodes=300):
    return testing.colocation_world_spec(
        seed=seed, n_nodes=n_nodes, pods_per_node=10, n_dangling=120,
        n_pending=600)


def _updates(device, spec, reconciles=2):
    ctrl = nr.NodeResourceController(
        testing.colocation_config(spec, sloconfig), device=device)
    snap = testing.colocation_snapshot(spec, ttypes)
    out = []
    for k in range(reconciles):
        out.append([(u.node_name, u.allocatable, u.synced, u.degraded,
                     u.annotations, u.meta_synced)
                    for u in ctrl.reconcile_all(snap)])
        for m in testing.colocation_metric_changes(spec, seed=k):
            snap.node_metrics[m["node_name"]] = testing.colocation_metric(
                m, ttypes)
        snap.now += 60.0
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_controller_on_the_card_equals_the_cpu(seed):
    _needs_gpu()
    spec = _spec(seed)
    assert _updates("cuda", spec) == _updates("cpu", spec)


def test_step_on_the_card_equals_the_cpu():
    """The step alone, on one lowering of a seeded world, int32 wrap
    included (a node whose pod sums overflow)."""
    _needs_gpu()
    spec = _spec(3)
    spec["nodes"][0]["alloc"][1] = 2 ** 31 - 1
    for pod in spec["pods"][:10]:
        if 0 in pod["requests"]:
            pod["requests"][0] = 2 ** 30
    ctrl = nr.NodeResourceController(
        testing.colocation_config(spec, sloconfig), device="cpu")
    snap = testing.colocation_snapshot(spec, ttypes)
    strategies = [ctrl.config.strategy_for_node(n.labels) for n in snap.nodes]
    nodes = ctrl._lower_nodes(snap, strategies)
    pods = ctrl._lower_pods(snap, {n.name: i for i, n in enumerate(snap.nodes)})
    n = len(snap.nodes)
    rng = np.random.default_rng(0)
    params = dict(reclaim_percent=rng.integers(0, 101, (n, 8)).astype(np.int32),
                  mid_threshold_percent=rng.integers(0, 101, (n, 8)).astype(
                      np.int32),
                  cpu_policy=rng.integers(0, 3, n).astype(np.int32),
                  memory_policy=rng.integers(0, 3, n).astype(np.int32))
    old = rng.integers(0, 50000, (n, 8)).astype(np.int32)
    thr = rng.integers(0, 30, n).astype(np.int32)
    enabled = rng.uniform(size=n) > 0.1
    outs = []
    for dev in ("cuda", "cpu"):
        def t(d):
            return {k: torch.as_tensor(v).to(dev) for k, v in d.items()}

        alloc, sync = nr._overcommit_step(
            NodeOvercommitInputs(**t(nodes)), PodOvercommitInputs(**t(pods)),
            OvercommitParams(**t(params)), torch.as_tensor(old).to(dev),
            torch.as_tensor(thr).to(dev), torch.as_tensor(enabled).to(dev))
        assert alloc.dtype == torch.int32 and alloc.device.type == dev
        outs.append((alloc.cpu(), sync.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _loop(device, spec):
    bus = APIServer()
    sched = Scheduler(model=PlacementModel(device=device))
    wire_scheduler(bus, sched)
    manager = wire_manager(bus, nr.NodeResourceController(
        testing.colocation_config(spec, sloconfig), device=device))
    testing.apply_colocation(bus, Kind, spec, ttypes)
    now = spec["now"]
    out = [dict(sched.schedule_pending(now=now)), manager.reconcile(now + 10),
           dict(sched.schedule_pending(now=now + 20))]
    for m in testing.colocation_metric_changes(spec, frac=0.05, now=now + 50):
        bus.apply(Kind.NODE_METRIC, m["node_name"],
                  testing.colocation_metric(m, ttypes))
    out += [manager.reconcile(now + 60), dict(sched.schedule_pending(now=now + 70))]
    out.append({name: dict(node.allocatable)
                for name, node in bus.list(Kind.NODE).items()})
    return out


def test_wired_loop_on_the_card_equals_the_cpu():
    _needs_gpu()
    spec = _spec(4, n_nodes=200)
    got = _loop("cuda", spec)
    assert got == _loop("cpu", spec)
    assert sum(v is not None for v in got[2].values()) > 0
