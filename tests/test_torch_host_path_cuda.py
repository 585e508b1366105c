"""The host route and its cutoff probe on the card (``cuda``: skipped
without an NVIDIA GPU).

``measure_host_fallback_cells()`` on ``cuda`` (its device round the
routed kernel's launch and read-back), and one round of the same world
routed to the host and to the kernel on a ``cuda`` model: equal
placements, the host round staging nothing on the card, launching no
kernel and returning CPU tensors, the kernel round launching once and
releasing the staged generation it pinned on the card. This file imports no JAX, so it runs on a
machine with a GPU and no JAX: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_host_path_cuda.py``."""

import os

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.apis.types import PodSpec
from koordinator_tpu_torch.models import placement
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops import binpack_kernel as bk
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


def test_probe_on_the_card():
    _needs_gpu()
    cells = placement.measure_host_fallback_cells()
    record = placement.host_probe()
    assert record["device"].type == "cuda"
    assert 0 <= cells <= 1 << 18 and record["cells"] == cells
    assert record["device_best_ms"] > 0 and record["host_ns_per_cell"] > 0


def _round(cutoff):
    """One staged round of a 64-node churn world with 16 pending pods on
    a ``cuda`` model: ``(placements, waiting, launches, model, result)``."""
    snap, _ = testing.churn_world(64, assigned_per_node=2, seed=4)
    sched = Scheduler(model=PlacementModel(host_fallback_cells=cutoff),
                      enable_preemption=False)
    testing.feed_scheduler(sched, snap)
    rng = np.random.default_rng(5)
    for j in range(16):
        sched.add_pod(PodSpec(name=f"q{j}", requests={
            ResourceName.CPU: int(rng.integers(200, 4000)),
            ResourceName.MEMORY: int(rng.integers(128, 8192))}))
    for kind in bk.LAUNCHES:
        bk.LAUNCHES[kind] = 0
    flight = sched.model.schedule_async(sched.cache.snapshot(now=20.0))
    if cutoff:
        assert flight.pinned is None
        assert sched.model.staged_cache.state is None
    else:
        assert flight.pinned is not None and flight.pinned.usage.is_cuda
    out = flight.finalize()
    torch.cuda.synchronize()
    assert sched.model.staged_cache._pinned is None
    return (dict(out), out.waiting, sum(bk.LAUNCHES.values()), sched.model,
            flight.result)


def test_host_round_equals_kernel_round_on_the_card():
    _needs_gpu()
    host = _round(1 << 18)
    kernel = _round(0)
    assert host[3].last_solver == "host" and kernel[3].last_solver == "kernel"
    assert host[2] == 0 and kernel[2] == 1
    assert host[0] == kernel[0] and host[1] == kernel[1]
    assert sum(n is not None for n in host[0].values()) > 0
    assert host[4].assign.device.type == "cpu"
    assert torch.equal(host[4].assign, kernel[4].assign.cpu())
