"""The serving failure domain on the card (``cuda``: skipped without an
NVIDIA GPU): the failover's local solve launches the placement kernel
and equals the CPU run, the prewarm loads the kernel library, the
outage churn through a supervised in-process sidecar on the card equals
the in-process run, and the working set's host rung frees the allocator's
bytes and answers every tenant as the unbudgeted arm does.

This file imports no JAX, so it runs on a machine with a GPU and no JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_serving_cuda.py``."""

import os
import tempfile

import pytest
import torch

from koordinator_tpu_torch.apis import types
from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.service import codec, server
from koordinator_tpu_torch.service.client import RemoteSolver
from koordinator_tpu_torch.service.failover import FailoverSolver
from koordinator_tpu_torch.service.supervisor import SolverSupervisor
from koordinator_tpu_torch.state.cluster import ClusterDeltaTracker
from koordinator_tpu_torch.state.workingset import WORKING_SET
from koordinator_tpu_torch.testing.chaos import InProcessSidecar
from koordinator_tpu_torch.testing.failure_domain import (
    density_arm,
    density_stream,
    mode_runs,
    outage_churn,
)

pytestmark = pytest.mark.cuda

# the warm pool stays inert unless a test configures its store, as
# tests/conftest.py keeps it for the CPU suite (these files also run
# under --noconftest, where a default store in the home directory
# would restore earlier runs' entries and count their launches)
os.environ.setdefault("KTPU_COMPILATION_CACHE_DIR", "")


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _dead_failover(device):
    return FailoverSolver(
        RemoteSolver("/nowhere.sock", retry_total_s=0.05,
                     backoff_base_s=0.01, backoff_cap_s=0.02),
        failure_threshold=1, probe_fn=lambda: False, device=device)


def test_local_solve_launches_the_kernel_and_equals_cpu():
    _needs_gpu()
    runs = {}
    for device in ("cuda", "cpu"):
        backend = _dead_failover(device)
        assert backend.wait_prewarm(120)
        model = PlacementModel(backend=backend, device=device)
        before = sum(bk.LAUNCHES.values())
        log, _, modes, _ = outage_churn(
            model, types, ClusterDeltaTracker, ResourceName, n_nodes=512,
            ticks=3)
        runs[device] = (log, modes, sum(bk.LAUNCHES.values()) - before)
    assert runs["cuda"][0] == runs["cpu"][0]
    # the empty warm-up solve already flipped the machine (threshold 1)
    assert runs["cuda"][1] == ["local-degraded"] * 3
    assert runs["cuda"][2] == 3          # one launch a tick
    assert runs["cpu"][2] == 0           # CPU tensors take the twin


def test_prewarm_loads_the_library():
    _needs_gpu()
    backend = _dead_failover("cuda")
    assert backend.wait_prewarm(120)
    assert backend.prewarm_report["loaded"] is True
    assert bk._LIB is not None


def test_outage_churn_on_the_card_equals_inprocess():
    _needs_gpu()
    addr = os.path.join(tempfile.mkdtemp(), "s.sock")
    handles = []

    def spawn():
        handles.append(InProcessSidecar(addr))
        return handles[-1]

    sup = SolverSupervisor(addr, spawn_fn=spawn, backoff_base_s=0.0,
                           backoff_cap_s=0.0, ready_timeout_s=60.0)
    sup.start(monitor=False)
    remote = RemoteSolver(addr, timeout=60.0, backoff_base_s=0.01,
                          backoff_cap_s=0.05)
    backend = FailoverSolver(remote, failure_threshold=2, recovery_probes=2)
    model = PlacementModel(backend=backend)
    backend.on_flip_back = model.reset_staging

    def on_tick(t):
        if t == 4:
            handles[-1].kill()
        elif t == 8:
            assert sup.check_once() == "restarted"

    try:
        log, _, modes, _ = outage_churn(
            model, types, ClusterDeltaTracker, ResourceName, n_nodes=512,
            ticks=12, on_tick=on_tick,
            warm=lambda: setattr(remote, "deadline_s", 0.5))
    finally:
        sup.stop()
        backend.close()
    ref, _, _, _ = outage_churn(PlacementModel(), types,
                                ClusterDeltaTracker, ResourceName,
                                n_nodes=512, ticks=12)
    assert log == ref
    assert mode_runs(modes) == ["remote", "local-fallback",
                                "local-degraded", "remote"]


def test_host_rung_frees_allocator_bytes_and_answers_equal():
    _needs_gpu()
    streams = [density_stream(i, 5, 1024, 64) for i in range(4)]
    digests = {}
    for device, line in (("cuda", None), ("cuda", 1), ("cpu", None)):
        solve = lambda req, cache: server.solve_from_request(
            req, node_cache=cache)
        make = lambda i, d=device: server.NodeStateCache(
            d, tenant=f"d{i}", lane="be")
        probe = make(99)
        assert not solve(codec.SolveRequest(**streams[0][0]), probe).error
        world = probe.device_bytes()
        if device == "cuda" and line is None:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            assert WORKING_SET.demote(probe._ws_key, "host")
            torch.cuda.synchronize()
            assert before - torch.cuda.memory_allocated() >= world
        probe.close()
        _, digests[(device, line)], _ = density_arm(
            streams, codec.SolveRequest, solve, make, WORKING_SET, line,
            world, warmup=1)
    assert digests[("cuda", 1)] == digests[("cuda", None)] == \
        digests[("cpu", None)]
    WORKING_SET.reset()
    assert len(digests[("cuda", 1)]) == 4 * 3
