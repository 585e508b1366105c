"""The plugin chain, the aggregated LoadAware mode and the explainer on the
card (``cuda``: skipped without an NVIDIA GPU).

This file imports no JAX, so it runs on a machine with a GPU and no JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_plugin_chain_cuda.py``."""

import os

import pytest
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types
from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.cmd.scheduler import SchedulerConfig, build_scheduler
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.obs.explain import explain_scores
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.state.cluster import (
    AggregatedArgs,
    lower_nodes,
    lower_pending_pods,
)
from koordinator_tpu_torch.testing import plugin_chain

pytestmark = pytest.mark.cuda

# the warm pool stays inert unless a test configures its store, as
# tests/conftest.py keeps it for the CPU suite (these files also run
# under --noconftest, where a default store in the home directory
# would restore earlier runs' entries and count their launches)
os.environ.setdefault("KTPU_COMPILATION_CACHE_DIR", "")

CPU, MEM = ResourceName.CPU, ResourceName.MEMORY
#: filter at p99, score at p50: the negative-est_extra arm
ARM = dict(usage_thresholds={CPU: 65, MEM: 95}, usage_pct=99, score_pct=50)


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _world(n_nodes, n_pending, aggregated=False):
    spec = plugin_chain.chain_world_spec(n_nodes=n_nodes,
                                         n_pending=n_pending,
                                         aggregated=aggregated)
    return spec, testing.build_snapshot(spec, types, ResourceName)


def test_chain_on_the_card_equals_the_batched_round_and_the_cpu():
    _needs_gpu()
    spec, _ = _world(120, 64)
    out = {}
    for device in ("cuda", "cpu"):
        for gates in ("", "BatchedPlacement=false"):
            s = build_scheduler(SchedulerConfig(feature_gates=gates),
                                device=device)
            testing.feed_scheduler(
                s, testing.build_snapshot(spec, types, ResourceName))
            r = s.schedule_pending(now=spec["now"])
            out[device, gates] = (dict(r), dict(r.waiting))
    want = out["cpu", ""]
    assert all(v == want for v in out.values())
    assert sum(n is not None for n in want[0].values()) > 0


@pytest.mark.parametrize("n_nodes", [120, 1100])
def test_aggregated_kernel_equals_plain(n_nodes):
    """The routed kernel (one block at 120 nodes, the cluster kernel at
    1,100) on the negative-est_extra world equals its plain version on
    the same card inputs, on every output."""
    _needs_gpu()
    _, snap = _world(n_nodes, 256, aggregated=True)
    snap.reservations = []
    for pod in snap.pending_pods:
        pod.quota = None
    model = PlacementModel(aggregated=AggregatedArgs(**ARM))
    arrays = lower_nodes(snap, **model.lowering_kwargs())
    assert (arrays.est_extra < 0).any()
    pods = lower_pending_pods(snap.pending_pods,
                              scaling_factors=model.scaling_factors,
                              resource_weights=model.resource_weights)
    inp = bk.kernel_inputs(model.stage_nodes(arrays), model.stage_pods(pods),
                           model.params)
    route = bk.route_of(inp)
    assert route.kind == ("block" if n_nodes <= 1024 else "cluster")
    got = bk.binpack(inp)
    want = (bk.binpack_plain(inp) if route.kind == "block"
            else bk.binpack_sharded_plain(inp, route.shards))
    for name, g, w in zip(got._fields, got, want):
        if w is not None:
            assert torch.equal(g, w), name
    cpu = PlacementModel(device="cpu", aggregated=AggregatedArgs(**ARM))
    assert dict(model.schedule(snap)) == dict(cpu.schedule(snap))


def test_explain_on_the_card_equals_the_cpu():
    _needs_gpu()
    spec, _ = _world(60, 16, aggregated=True)
    scheds = {}
    for device in ("cuda", "cpu"):
        s = Scheduler(model=PlacementModel(
            device=device, aggregated=AggregatedArgs(**ARM)))
        testing.feed_scheduler(
            s, testing.build_snapshot(spec, types, ResourceName))
        scheds[device] = s
    snap = scheds["cpu"].cache.snapshot(now=spec["now"])
    for pod in snap.pending_pods:
        _, on_card = explain_scores(scheds["cuda"].model, snap, pod)
        _, on_cpu = explain_scores(scheds["cpu"].model, snap, pod)
        for name, col in on_cpu.items():
            assert (on_card[name] == col).all(), (pod.uid, name)
            assert on_card[name].dtype == col.dtype
