"""The lane axis of the placement kernel (``binpack_lanes``): K plain
solves in one launch. On the CPU the wrapper runs its plain version lane
by lane, held here against K single solves (exact). The ``cuda`` cases
hold the lane kernel against that plain version on the card at edge
shapes; they skip without a GPU. This file imports no JAX, so the
``cuda`` cases run on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lanes.py``."""

import functools

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import NodeState, PodBatch, ScoreParams
from koordinator_tpu_torch.service.tenancy import _pad_rows


def solo(n, p, seed, dev, thresholds=None, weights=None):
    state, pods, params = testing.example_problem(n, p, seed=seed,
                                                  device=dev)
    if thresholds is not None:
        params = params._replace(thresholds=torch.as_tensor(
            thresholds, device=dev))
    if weights is not None:
        params = params._replace(weights=torch.as_tensor(weights,
                                                         device=dev))
    return state, pods, params


def lane_batch(node_counts, pod_counts, dev, shared_base=False, seed=0):
    """Lanes of example problems, each with its own pods (and its own
    world unless ``shared_base``: then every lane reads lane 0's), padded
    and stacked as the service stacks them; returns ``(LaneInputs,
    [(state, pods, params) per lane])``."""
    rng = np.random.default_rng(seed)
    lanes = []
    for i, (n, p) in enumerate(zip(node_counts, pod_counts)):
        thr = np.zeros(8, np.int32)
        thr[:2] = rng.integers(40, 96, 2)
        w = np.zeros(8, np.int32)
        w[:2] = rng.integers(0, 3, 2)
        state, pods, params = solo(n, p, seed + i, dev, thr, w)
        if shared_base and i:
            state = lanes[0][0]
        lanes.append((state, pods, params))
    n_max, p_max = max(node_counts), max(pod_counts)
    bases = lanes[:1] if shared_base else lanes
    state = NodeState(*(
        None if getattr(bases[0][0], f) is None
        else torch.stack([_pad_rows(getattr(b[0], f), n_max) for b in bases])
        for f in NodeState._fields))

    def pad_pods(pods):
        pad = _pad_rows(pods.blocked, p_max)
        pad[pods.blocked.shape[0]:] = True
        return PodBatch(*(None if t is None else
                          (pad if f == "blocked" else _pad_rows(t, p_max))
                          for f, t in zip(PodBatch._fields, pods)))

    stacked = [pad_pods(pods) for _, pods, _ in lanes]
    pods = PodBatch(*(None if getattr(stacked[0], f) is None else
                      torch.stack([getattr(b, f) for b in stacked])
                      for f in PodBatch._fields))
    params = ScoreParams(*(torch.stack([getattr(l[2], f) for l in lanes])
                           for f in ScoreParams._fields))
    return bk.lane_inputs(state, pods, params), lanes


def same_as_solo(out, lanes, shards=None):
    for i, (state, pods, params) in enumerate(lanes):
        inp = bk.kernel_inputs(state, pods, params)
        want = (bk.binpack(inp) if shards is None
                else bk.binpack_sharded(inp, shards))
        n, p = state.alloc.shape[0], pods.req.shape[0]
        assert torch.equal(out.assign[i, :p], want.assign), i
        for f in ("used", "est", "prod"):
            assert torch.equal(getattr(out, f)[i, :n], getattr(want, f)), (i, f)


@pytest.mark.parametrize("node_counts,pod_counts,shared", [
    ((40,), (30,), False),                  # K = 1
    ((40, 40, 40), (30, 7, 0), True),       # coalesced, short and empty lanes
    ((40, 23, 31), (12, 30, 5), False),     # tenant worlds of different N
])
def test_lanes_equal_single_solves(node_counts, pod_counts, shared):
    inp, lanes = lane_batch(node_counts, pod_counts, "cpu", shared)
    before = dict(bk.LAUNCHES)
    out = bk.binpack_lanes(inp)
    assert bk.LAUNCHES == before          # CPU tensors: the plain version
    same_as_solo(out, lanes)
    n_max = max(node_counts)
    for i, n in enumerate(node_counts):   # padding rows stay untouched
        assert not out.used[i, n:].any() and not out.prod[i, n:].any()
    for i, p in enumerate(pod_counts):    # padding pods place nowhere
        assert (out.assign[i, p:] == -1).all()
    assert out.used.shape == (len(node_counts), n_max, 8)


def test_lanes_cluster_plain_version_at_two_ctas():
    inp, lanes = lane_batch((50, 37), (20, 25), "cpu")
    route = bk.kernel_route(50, shards=2)
    assert route.kind == "cluster"
    same_as_solo(bk.binpack_lanes_plain(inp, route), lanes, shards=2)


def test_lanes_without_pods_launch_nothing():
    inp, lanes = lane_batch((20, 20), (0, 0), "cpu", shared_base=True)
    out = bk.binpack_lanes(inp)
    assert out.assign.shape == (2, 0)
    for i in range(2):
        assert torch.equal(out.used[i], lanes[0][0].used_req)


# -- on the card ------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("node_counts,pod_counts,shared,shards", [
    ((300,), (200,), False, None),                   # K = 1, one block
    ((300, 300), (150, 0), True, None),              # one empty lane
    ((64,) * 140, (16,) * 140, True, None),          # K above the SM count
    ((900, 700, 500), (120, 90, 60), False, 2),      # k = 2 CTAs, K = 3
    ((4000, 3500), (60, 40), False, 2),              # the L2 form, K = 2
])
def test_lane_kernel_equals_plain_version(node_counts, pod_counts, shared,
                                          shards):
    _cuda()
    inp, lanes = lane_batch(node_counts, pod_counts, "cuda", shared)
    if shards is None:
        route = bk.lane_route(inp)
        launch = bk.binpack_lanes
    else:   # a forced route, as only small N can reach it
        route = bk.kernel_route(max(node_counts), shards=shards)
        launch = functools.partial(bk._launch_lanes, route=route)
    if shards == 2 and node_counts[0] == 4000:
        assert route.kind == "l2"
    before = bk.LAUNCHES["lanes"]
    got = launch(inp)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["lanes"] == before + 1
    want = bk.binpack_lanes_plain(inp, route)
    for f in bk.LaneOutputs._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
def test_failed_lane_launch_raises_without_plain_version(monkeypatch):
    _cuda()

    class Failing:
        def binpack_lanes_launch(self, *args):
            return 700

        def binpack_error_string(self, rc):
            return b"an illegal memory access was encountered"

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(bk, "_library", lambda: Failing())
    monkeypatch.setattr(bk, "binpack_lanes_plain", plain)
    monkeypatch.setattr(bk, "_plain", plain)
    inp, _ = lane_batch((100, 100), (10, 10), "cuda")
    with pytest.raises(RuntimeError, match="lane kernel launch"):
        bk.binpack_lanes(inp)
