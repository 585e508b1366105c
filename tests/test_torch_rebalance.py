"""The port's ``ops/rebalance.py`` against the JAX package's: threshold
resolution and classification (float64 truncation and deviation mode
included), the balance sweep's plain version and numpy replica against
the reference's ``run_balance_sweep`` (its ``lax.scan`` on the CPU), the
int32 domain's ``ValueError``s, padding, and ``convert.sweep_batch``."""

import numpy as np
import pytest
import torch

from koordinator_tpu.ops import rebalance as jrb
from koordinator_tpu_torch import convert, testing
from koordinator_tpu_torch.ops import rebalance as rb

R = 8
I32_MAX = 2**31 - 1


def _percents(rng):
    low = np.full(R, -1, np.int64)
    high = np.full(R, -1, np.int64)
    for r in rng.choice(R, size=int(rng.integers(1, 4)), replace=False):
        low[r] = int(rng.integers(0, 60))
        high[r] = int(rng.integers(40, 101))
    if rng.random() < 0.3:
        low[int(rng.integers(R))] = -1
    return low, high


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("deviation", (False, True))
def test_thresholds_and_classification_match_reference(seed, deviation):
    rng = np.random.default_rng(seed)
    n = 40
    alloc = rng.integers(0, 200_000, (n, R))
    alloc[rng.random((n, R)) < 0.1] = 0
    usage = (alloc * rng.random((n, R)) * 1.2).astype(np.int64)
    active = rng.random(n) < 0.85
    schedulable = rng.random(n) < 0.9
    low, high = _percents(rng)
    got = rb.threshold_quantities(usage, alloc, low, high, active, deviation)
    want = jrb.threshold_quantities(usage, alloc, low, high, active,
                                    deviation)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    got_v = rb.classify_nodes(usage, *got, active, schedulable)
    want_v = jrb.classify_nodes(usage, *want, active, schedulable)
    for g, w in zip(got_v, want_v):
        np.testing.assert_array_equal(g, w)


def test_float64_truncation():
    """29% of 100,000 is 28,999 in float64, as in the reference; integer
    arithmetic would give 29,000."""
    alloc = np.zeros((1, R), np.int64)
    alloc[0, 0] = alloc[0, 1] = 100_000
    low = np.full(R, -1)
    high = np.full(R, -1)
    low[0], high[0] = 29, 29
    low_q, high_q, mask = rb.threshold_quantities(
        np.zeros((1, R)), alloc, low, high, np.ones(1, bool))
    assert low_q[0, 0] == high_q[0, 0] == 28_999
    assert mask[0] and mask[1] and not mask[2]
    want = jrb.threshold_quantities(np.zeros((1, R)), alloc, low, high,
                                    np.ones(1, bool))
    np.testing.assert_array_equal(low_q, want[0])


def test_deviation_with_only_a_high_threshold_resolves_to_capacity():
    """The reference's quirk: with only a high threshold set, deviation
    mode resolves both sides of that resource to capacity."""
    alloc = np.full((3, R), 1000, np.int64)
    usage = np.array([[100] * R, [500] * R, [900] * R], np.int64)
    low = np.full(R, -1)
    high = np.full(R, -1)
    high[0] = 10
    got = rb.threshold_quantities(usage, alloc, low, high, np.ones(3, bool),
                                  use_deviation=True)
    np.testing.assert_array_equal(got[0][:, 0], alloc[:, 0])
    np.testing.assert_array_equal(got[1][:, 0], alloc[:, 0])
    want = jrb.threshold_quantities(usage, alloc, low, high,
                                    np.ones(3, bool), use_deviation=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


SWEEPS = [(1, 1, None, False), (2, 37, None, False), (3, 160, None, True),
          (4, 240, 20, False), (5, 300, 8, True), (6, 120, None, True)]


@pytest.mark.parametrize("seed,k,headroom,exhausted", SWEEPS)
def test_sweep_matches_reference(seed, k, headroom, exhausted):
    """The plain version (``device="cpu"``) and the numpy replica equal
    the reference's scan on random batches with blocked, metric-less and
    invalid candidates; the headroom runs out part way with ``headroom``,
    and a column may start exhausted with ``exhausted``."""
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        seed, k, headroom=headroom, exhausted=exhausted)
    want = jrb.run_balance_sweep(jrb.SweepBatch(**arrays), available,
                                 res_mask, blocked)
    batch = rb.SweepBatch(**arrays)
    got = rb.run_balance_sweep(batch, available, res_mask, blocked,
                               device="cpu")
    replay = rb.replay_sweep_host(batch, available, res_mask, blocked)
    for g, r, w in zip(got, replay, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(r, w)
    assert want[0].any() or exhausted


def test_padding_is_inert():
    """The port never pads; rows with ``valid`` False (the reference's
    padding) change nothing and propose nothing."""
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        7, 50, invalid_frac=0.0)
    pad = 14
    padded = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                             v.dtype)])
              for k, v in arrays.items()}
    blocked_p = np.concatenate([blocked, np.zeros(pad, bool)])
    plain = rb.run_balance_sweep(rb.SweepBatch(**arrays), available,
                                 res_mask, blocked, device="cpu")
    got = rb.run_balance_sweep(rb.SweepBatch(**padded), available, res_mask,
                               blocked_p, device="cpu")
    want = jrb.run_balance_sweep(jrb.SweepBatch(**padded), available,
                                 res_mask, blocked_p)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g[:50], p)
        np.testing.assert_array_equal(g, w)
    assert not got[0][50:].any()
    for n in (0, 1, 7, 8, 9, 100, 1025):
        assert rb.sweep_candidate_bucket(n) == jrb.sweep_candidate_bucket(n)


def _raises_both(arrays, available, res_mask, blocked, match):
    for run, make in ((jrb.run_balance_sweep, jrb.SweepBatch),
                      (lambda *a: rb.run_balance_sweep(*a, device="cpu"),
                       rb.SweepBatch)):
        with pytest.raises(ValueError, match=match):
            run(make(**arrays), available, res_mask, blocked)


@pytest.mark.parametrize("field,value,match", [
    ("usage0", I32_MAX + 1, "rebalance sweep usage exceeds"),
    ("high_q", -(2**31) - 1, "rebalance sweep high quantities exceeds"),
    ("metric", I32_MAX + 5, "rebalance sweep pod metrics exceeds"),
])
def test_int32_domain_raises(field, value, match):
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(8, 30)
    arrays[field] = arrays[field].copy()
    arrays[field][3, 1] = value
    _raises_both(arrays, available, res_mask, blocked, match)


def test_int32_endpoints_raise():
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(9, 30)
    big = available.copy()
    big[1] = I32_MAX + 1
    _raises_both(arrays, big, res_mask, blocked,
                 r"rebalance sweep available headroom exceeds .*\[")
    # every metric subtracted takes the headroom below int32's minimum
    low = available.copy()
    low[1] = -(2**31) + 10
    _raises_both(arrays, low, res_mask, blocked,
                 "rebalance sweep available endpoint exceeds")
    # a node whose usage less its pods' metrics leaves int32
    deep = {k: v.copy() for k, v in arrays.items()}
    deep["usage0"][:, 1] = -(2**31) + 5
    _raises_both(deep, available, res_mask, blocked,
                 "rebalance sweep usage endpoint exceeds")
    opened = {k: v.copy() for k, v in arrays.items()}
    opened["node_start"][0] = False
    _raises_both(opened, available, res_mask, blocked,
                 "must open with a node_start candidate")


def test_convert_sweep_batch_stages_int32():
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(10, 25)
    batch = jrb.SweepBatch(**arrays)
    staged = convert.sweep_batch(
        {k: np.asarray(v) for k, v in batch._asdict().items()}, device="cpu")
    for name in rb.SweepBatch._fields:
        got = getattr(staged, name)
        assert got.dtype == (torch.int32 if getattr(batch, name).dtype
                             == np.int64 else torch.bool), name
        np.testing.assert_array_equal(got.numpy(), getattr(batch, name))
    streams, avail = rb.balance_sweep(
        staged, torch.tensor(blocked), torch.tensor(available.astype(
            np.int32)), torch.tensor(res_mask))
    want = jrb.run_balance_sweep(batch, available, res_mask, blocked)
    for g, w in zip(streams.numpy(), want):
        np.testing.assert_array_equal(g, w)
    bad = dict(arrays, metric=arrays["metric"] + I32_MAX)
    with pytest.raises(ValueError, match="pod metrics exceeds"):
        convert.sweep_batch(bad, device="cpu")
    with pytest.raises(TypeError):
        convert.sweep_batch(dict(arrays, extra=np.zeros(3)), device="cpu")
