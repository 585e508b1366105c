"""The LowNodeLoad balance sweep's kernels (``csrc/rebalance_sweep.cu``:
the scan kernel and the one-warp serial kernel, one per route) against
their plain version (``ops/rebalance._balance_sweep``) and the numpy
replica ``replay_sweep_host``.

This file imports no JAX, so the ``cuda`` cases can run on a machine with
a GPU and no JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_rebalance_kernel.py``. Without a GPU they skip; the CPU
cases hold the plain version against the replica and the wrapper's
device rule."""

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.ops import binpack_kernel
from koordinator_tpu_torch.ops import rebalance as rb

R = 8


def random_batch(seed, k, **kw):
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        seed, k, **kw)
    return rb.SweepBatch(**arrays), available, res_mask, blocked


def _plain(batch, available, res_mask, blocked, device="cpu", route=None):
    """``balance_sweep`` on ``device``; with ``route``, that route's
    kernel (a CUDA device) whatever the batch's own route."""
    staged = rb.stage_sweep_batch(batch, device)
    args = (staged, torch.tensor(blocked, device=device),
            torch.tensor(available.astype(np.int32), device=device),
            torch.tensor(res_mask, device=device))
    if route is None:
        return rb.balance_sweep(*args)
    return rb._launch(*args, route)


def varied_batch(seed, k):
    """A batch whose ``high_q`` varies inside its nodes (the serial
    route's)."""
    batch, available, res_mask, blocked = random_batch(seed, k)
    rng = np.random.default_rng(seed)
    hq = batch.high_q + rng.integers(-3_000, 3_000, batch.high_q.shape)
    batch = batch._replace(high_q=hq)
    assert rb.sweep_route(batch.node_start, batch.high_q) == "serial"
    return batch, available, res_mask, blocked


CASES = [(1, 1, None), (2, 31, None), (3, 32, None), (4, 33, None),
         (5, 500, None), (6, 900, 40), (7, 4000, None)]


@pytest.mark.parametrize("seed,k,headroom", CASES[:6])
def test_plain_matches_host_replica(seed, k, headroom):
    batch, available, res_mask, blocked = random_batch(seed, k,
                                                       headroom=headroom)
    streams, avail = _plain(batch, available, res_mask, blocked)
    want = rb.replay_sweep_host(batch, available, res_mask, blocked)
    for got, w in zip(streams.numpy(), want):
        np.testing.assert_array_equal(got, w)
    subtracted = (want[0] & batch.has_metric)[:, None] * np.where(
        res_mask[None, :], batch.metric, 0)
    np.testing.assert_array_equal(avail.numpy(),
                                  available - subtracted.sum(axis=0))


def test_cpu_tensors_never_launch():
    batch, available, res_mask, blocked = random_batch(8, 40)
    before = dict(rb.LAUNCHES)
    _plain(batch, available, res_mask, blocked)
    _plain(*varied_batch(8, 40))
    sweep = rb.DeviceSweep(batch, available, res_mask, device="cpu")
    sweep.run(blocked)
    sweep.refuse(int(np.argmin(blocked)))
    assert rb.LAUNCHES == before


def _check_kernel(batch, available, res_mask, blocked, route=None):
    """The kernel of ``route`` (the batch's own when None) on the card
    against the plain version on the CPU, exactly."""
    name = rb.ROUTE_KERNELS[route or rb.sweep_route(batch.node_start,
                                                    batch.high_q)]
    before = dict(rb.LAUNCHES)
    got, got_avail = _plain(batch, available, res_mask, blocked, "cuda",
                            route=route)
    torch.cuda.synchronize()
    assert rb.LAUNCHES == dict(before, **{name: before[name] + 1})
    want, want_avail = _plain(batch, available, res_mask, blocked, "cpu")
    assert torch.equal(got.cpu(), want), f"propose/over/avail_ok ({name})"
    assert torch.equal(got_avail.cpu(), want_avail), f"available ({name})"
    return want


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,headroom", CASES)
def test_cuda_kernel_matches_plain(seed, k, headroom):
    _need_cuda()
    batch, available, res_mask, blocked = random_batch(seed, k,
                                                       headroom=headroom)
    assert rb.sweep_route(batch.node_start, batch.high_q) == "scan"
    for route in ("scan", "serial"):
        _check_kernel(batch, available, res_mask, blocked, route)


@pytest.mark.cuda
def test_cuda_all_blocked_and_empty():
    _need_cuda()
    batch, available, res_mask, _ = random_batch(9, 200)
    for route in ("scan", "serial"):
        want = _check_kernel(batch, available, res_mask, np.ones(200, bool),
                             route)
        assert not want[0].any()
    empty = rb.SweepBatch(np.zeros(0, bool), np.zeros((0, R), np.int64),
                          np.zeros((0, R), np.int64),
                          np.zeros((0, R), np.int64), np.zeros(0, bool),
                          np.zeros(0, bool))
    for route in ("scan", "serial"):
        _check_kernel(empty, available, res_mask, np.zeros(0, bool), route)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [511, 512, 513, 1023, 1024, 1025, 2047, 2048,
                               2049, 4095, 4096, 4097, 25_000])
@pytest.mark.parametrize("headroom", [None, 60])
def test_cuda_scan_at_tile_edges(k, headroom):
    """The scan kernel walks tiles of 512 threads x 2, 4 or 8 candidates
    (by the participating columns): K around a thread's and a tile's
    edge, and K = 25,000 (config #22 widened), with the headroom lasting
    and running out, on one, two and five participating columns."""
    _need_cuda()
    batch, available, res_mask, blocked = random_batch(
        k + (headroom or 0), k, headroom=headroom, exhausted=False)
    for n_cols in (1, 2, 5):
        mask = np.zeros(R, bool)
        mask[[1, 0, 3, 6, 7][:n_cols]] = True
        _check_kernel(batch, available, mask, blocked)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols", range(R + 1))
def test_cuda_scan_every_column_count(n_cols):
    """Every count of participating resources (the kernel's instances),
    none included, with a refusal and the headroom running out."""
    _need_cuda()
    batch, available, _, blocked = random_batch(30 + n_cols, 3000,
                                                headroom=200)
    mask = np.zeros(R, bool)
    mask[np.random.default_rng(n_cols).permutation(R)[:n_cols]] = True
    _check_kernel(batch, available, mask, blocked)


@pytest.mark.cuda
def test_cuda_scan_mixed_sign_metrics():
    """Negative metrics (a pod whose usage reads below zero) raise the
    running usage and the headroom; the scan stays exact."""
    _need_cuda()
    batch, available, res_mask, blocked = random_batch(14, 3000,
                                                       headroom=400)
    rng = np.random.default_rng(14)
    neg = rng.random(batch.metric.shape) < 0.3
    batch = batch._replace(metric=np.where(neg, -batch.metric, batch.metric))
    _check_kernel(batch, available, res_mask, blocked)


@pytest.mark.cuda
@pytest.mark.parametrize("columns", [(3,), (1, 3), (1, 3, 4), (0, 1, 3, 6, 7)])
@pytest.mark.parametrize("tiles", [1, 2])
def test_cuda_scan_cut_node_across_a_tile_edge(columns, tiles):
    """A node cut a few candidates before a tile edge of the kernel (4,096,
    2,048 or 1,024 candidates by the participating columns) holds a
    negative metric after its cut and runs on into the next tile, where
    another node exhausts the headroom: the next tile starts from the
    node's usage at its cut."""
    _need_cuda()
    edge = rb.scan_tile(len(columns)) * tiles
    arrays, available, mask, blocked = testing.sweep_cut_across_tile(
        edge, columns)
    batch = rb.SweepBatch(**arrays)
    want = _check_kernel(batch, available, mask, blocked)
    a, b = np.flatnonzero(batch.node_start)[-2:]
    assert a < edge - 1 < b and not want[1][a + 1:b].any()


@pytest.mark.cuda
def test_cuda_serial_route_on_varied_high_q():
    """A batch whose high_q varies inside a node takes the serial kernel
    (the route is chosen from the batch) and equals the plain version."""
    _need_cuda()
    for seed, k in ((15, 700), (16, 2000)):
        batch, available, res_mask, blocked = varied_batch(seed, k)
        _check_kernel(batch, available, res_mask, blocked)


@pytest.mark.cuda
@pytest.mark.parametrize("varied", [False, True])
def test_cuda_refusals_splice(varied):
    """``DeviceSweep.refuse`` on the card: one launch per refusal, the
    refused candidate blocked on the device, the suffix read back and
    spliced; after every refusal the streams equal a full plain run with
    the same mask, and the device's mask equals the host's."""
    _need_cuda()
    k = 1500
    if varied:
        batch, available, res_mask, _ = varied_batch(17, k)
    else:
        batch, available, res_mask, _ = random_batch(17, k, headroom=300)
    sweep = rb.DeviceSweep(batch, available, res_mask, device="cuda")
    assert sweep.route == ("serial" if varied else "scan")
    name = rb.ROUTE_KERNELS[sweep.route]
    blocked = np.zeros(k, bool)
    got = sweep.run(blocked)
    rng = np.random.default_rng(17)
    for step in range(25):
        proposed = np.flatnonzero(got[0])
        j = int(rng.choice(proposed)) if proposed.size and step % 3 else \
            int(rng.integers(k))
        blocked[j] = True
        before = rb.LAUNCHES[name]
        got = sweep.refuse(j)
        assert rb.LAUNCHES[name] == before + 1
        want, _ = _plain(batch, available, res_mask, blocked, "cpu")
        for g, w in zip(got, want.numpy()):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(sweep.blocked.cpu().numpy(), blocked)


@pytest.mark.cuda
def test_cuda_empty_launch():
    _need_cuda()
    before = dict(rb.LAUNCHES)
    rb.launch_empty("cuda")
    torch.cuda.synchronize()
    assert rb.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_headroom_runs_out_mid_node():
    _need_cuda()
    batch, available, res_mask, _ = random_batch(10, 600, headroom=25,
                                                 blocked_frac=0.0,
                                                 invalid_frac=0.0,
                                                 exhausted=False)
    for route in ("scan", "serial"):
        want = _check_kernel(batch, available, res_mask, np.zeros(600, bool),
                             route)
    ok = want[2].numpy()
    first_out = int(np.argmin(ok))
    assert not ok[first_out] and not batch.node_start[first_out], \
        "the headroom must run out inside a node"


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs():
    _need_cuda()
    batch, available, res_mask, blocked = random_batch(11, 64)
    staged = rb.stage_sweep_batch(batch, "cuda")
    good = (torch.tensor(blocked, device="cuda"),
            torch.tensor(available.astype(np.int32), device="cuda"),
            torch.tensor(res_mask, device="cuda"))
    with pytest.raises(ValueError, match="dtype"):
        rb.balance_sweep(staged, good[0], good[1].long(), good[2])
    with pytest.raises(ValueError, match="shape"):
        rb.balance_sweep(staged, good[0][:10], good[1], good[2])
    with pytest.raises(ValueError, match="is on"):
        rb.balance_sweep(staged, good[0].cpu(), good[1], good[2])


@pytest.mark.cuda
def test_cuda_sweep_without_library_raises(monkeypatch):
    _need_cuda()

    def no_build():
        raise RuntimeError("library unavailable")

    monkeypatch.setattr(binpack_kernel, "_LIB", None)
    monkeypatch.setattr(binpack_kernel, "build_library", no_build)
    batch, available, res_mask, blocked = random_batch(12, 16)
    with pytest.raises(RuntimeError, match="library unavailable"):
        rb.run_balance_sweep(batch, available, res_mask, blocked,
                             device="cuda")
