"""The LowNodeLoad balance sweep's kernel (``csrc/rebalance_sweep.cu``)
against its plain version (``ops/rebalance._balance_sweep``) and the
numpy replica ``replay_sweep_host``.

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


def _plain(batch, available, res_mask, blocked, device="cpu"):
    staged = rb.stage_sweep_batch(batch, device)
    return rb.balance_sweep(
        staged, torch.tensor(blocked, device=device),
        torch.tensor(available.astype(np.int32), device=device),
        torch.tensor(res_mask, device=device))


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
    before = rb.LAUNCHES["rebalance_sweep"]
    _plain(batch, available, res_mask, blocked)
    assert rb.LAUNCHES["rebalance_sweep"] == before


def _check_kernel(batch, available, res_mask, blocked):
    before = rb.LAUNCHES["rebalance_sweep"]
    got, got_avail = _plain(batch, available, res_mask, blocked, "cuda")
    torch.cuda.synchronize()
    assert rb.LAUNCHES["rebalance_sweep"] == before + 1
    want, want_avail = _plain(batch, available, res_mask, blocked, "cpu")
    assert torch.equal(got.cpu(), want), "propose/over/avail_ok"
    assert torch.equal(got_avail.cpu(), want_avail), "available"
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
    _check_kernel(batch, available, res_mask, blocked)


@pytest.mark.cuda
def test_cuda_all_blocked_and_empty():
    _need_cuda()
    batch, available, res_mask, _ = random_batch(9, 200)
    want = _check_kernel(batch, available, res_mask, np.ones(200, bool))
    assert not want[0].any()
    empty = rb.SweepBatch(np.zeros(0, bool), np.zeros((0, R), np.int64),
                          np.zeros((0, R), np.int64),
                          np.zeros((0, R), np.int64), np.zeros(0, bool),
                          np.zeros(0, bool))
    _check_kernel(empty, available, res_mask, np.zeros(0, bool))


@pytest.mark.cuda
def test_cuda_headroom_runs_out_mid_node():
    _need_cuda()
    batch, available, res_mask, _ = random_batch(10, 600, headroom=25,
                                                 blocked_frac=0.0,
                                                 invalid_frac=0.0,
                                                 exhausted=False)
    want = _check_kernel(batch, available, res_mask, np.zeros(600, bool))
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
