"""The balance sweep's scan form (``ops/rebalance._scan_tiled``, the CPU
emulation of the scan kernel in ``csrc/rebalance_sweep.cu``) against the
reference's scan (``koordinator_tpu.ops.rebalance.rebalance_sweep``, its
``lax.scan`` on the CPU) and ``replay_sweep_host``, exactly: every stream
and the final headroom, at tile sizes 1, 32 and 1,024. Then the route
predicate (``sweep_route``) and ``DeviceSweep``'s re-scan after a
refusal, whose spliced streams must equal a full run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import rebalance as jrb
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types
from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.descheduler import (
    LowNodeLoad,
    LowNodeLoadArgs,
    NodePool,
    loadaware,
)
from koordinator_tpu_torch.descheduler.framework import Evictor
from koordinator_tpu_torch.ops import rebalance as rb

R = 8
MEM = int(ResourceName.MEMORY)
TILES = (1, 32, 1024)


def reference(arrays, available, res_mask, blocked):
    """The reference's scan: ``(streams [3, K] bool, available [R])``,
    padded to its candidate bucket with inert rows and trimmed."""
    k = len(arrays["valid"])
    pad = rb.sweep_candidate_bucket(k) - k

    def padded(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    propose, over, ok, avail = jrb.rebalance_sweep(
        jnp.asarray(padded(arrays["node_start"])),
        jnp.asarray(padded(arrays["usage0"]), dtype=jnp.int32),
        jnp.asarray(padded(arrays["high_q"]), dtype=jnp.int32),
        jnp.asarray(padded(arrays["metric"]), dtype=jnp.int32),
        jnp.asarray(padded(arrays["has_metric"])),
        jnp.asarray(padded(arrays["valid"])),
        jnp.asarray(padded(np.asarray(blocked, bool))),
        jnp.asarray(available, dtype=jnp.int32),
        jnp.asarray(res_mask))
    streams = np.stack([np.asarray(x, bool)[:k] for x in (propose, over, ok)])
    return streams, np.asarray(avail, np.int32)


def staged_args(arrays, available, res_mask, blocked):
    batch = rb.stage_sweep_batch(rb.SweepBatch(**arrays), "cpu")
    return (*batch, torch.tensor(np.asarray(blocked, bool)),
            torch.tensor(np.asarray(available, np.int64).astype(np.int32)),
            torch.tensor(np.asarray(res_mask, bool)))


def emulated(arrays, available, res_mask, blocked, tile):
    streams, avail = rb._scan_tiled(
        *staged_args(arrays, available, res_mask, blocked), tile=tile)
    return streams.numpy(), avail.numpy()


def check_all(arrays, available, res_mask, blocked, tiles=TILES,
              replica=True):
    """The emulation at each tile size == the reference's scan == the
    plain version (== the numpy replica with ``replica``); returns the
    reference's streams."""
    want, want_avail = reference(arrays, available, res_mask, blocked)
    plain, plain_avail = rb._balance_sweep(
        *staged_args(arrays, available, res_mask, blocked))
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(plain_avail.numpy(), want_avail)
    if replica:
        got = rb.replay_sweep_host(rb.SweepBatch(**arrays), available,
                                   res_mask, blocked)
        np.testing.assert_array_equal(np.stack(got), want)
    for tile in tiles:
        streams, avail = emulated(arrays, available, res_mask, blocked, tile)
        np.testing.assert_array_equal(streams, want, err_msg=f"tile {tile}")
        np.testing.assert_array_equal(avail, want_avail,
                                      err_msg=f"tile {tile}")
    return want


def negate_some(arrays, seed, share=0.3):
    """Mixed-sign metrics: ``share`` of the metric entries negated."""
    rng = np.random.default_rng(seed)
    neg = rng.random(arrays["metric"].shape) < share
    return dict(arrays, metric=np.where(neg, -arrays["metric"],
                                        arrays["metric"]))


BATCHES = [(1, 0, None), (2, 1, None), (3, 7, 2), (4, 31, None),
           (5, 33, 5), (6, 300, None), (7, 700, 40), (8, 1023, None),
           (9, 1024, 60), (10, 1025, None), (11, 2000, 150),
           (12, 1999, None)]


@pytest.mark.parametrize("seed,k,headroom", BATCHES)
def test_emulation_matches_reference(seed, k, headroom):
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        seed, k, headroom=headroom)
    tiles = TILES if k <= 700 else TILES[1:]
    check_all(arrays, available, res_mask, blocked, tiles)


@pytest.mark.parametrize("seed,k,headroom", [(20, 500, None), (21, 900, 80),
                                             (22, 1500, 300)])
def test_emulation_mixed_sign_metrics(seed, k, headroom):
    """Negative metrics raise the running usage and the headroom: the
    monotonicity the scan rests on holds without a sign."""
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        seed, k, headroom=headroom)
    arrays = negate_some(arrays, seed)
    rb.validate_sweep(rb.SweepBatch(**arrays), available, res_mask)
    tiles = TILES if k <= 500 else TILES[1:]
    check_all(arrays, available, res_mask, blocked, tiles)


def test_emulation_tentative_sum_wraps():
    """After a node is cut, its tentative running usage keeps subtracting
    eligible metrics that are never proposed; here that partial sum
    crosses 2**31 and wraps while the walk itself never does (the
    validated endpoints fit). Every form agrees."""
    big = 2_147_483_640
    arrays, mask = testing.sweep_rows([(100, 50, [60, -big, big, 5]),
                          (900, 100, [300, 200, 100])])
    available = np.zeros(R, np.int64)
    available[MEM] = 10_000
    rb.validate_sweep(rb.SweepBatch(**arrays), available, mask)
    blocked = np.zeros(len(arrays["valid"]), bool)
    # the tentative usage before the node's third candidate leaves int32
    assert 100 - 60 + big > np.iinfo(np.int32).max
    want = check_all(arrays, available, mask, blocked, tiles=(1, 2, 3, 1024))
    np.testing.assert_array_equal(want[0], [1, 0, 0, 0, 1, 1, 1])


def test_emulation_cut_node_keeps_its_usage_across_tiles():
    """Node A is cut at its second candidate, holds a negative metric
    after the cut (eligible, never proposed) and runs into the tile where
    node B exhausts the headroom: that tile must start from A's usage at
    the cut (40), not from the running sum of every eligible metric
    (1,039), or A's last candidate reads as over."""
    arrays, mask = testing.sweep_rows([(100, 50, [60, -1000, 1, 1]),
                                       (200, 50, [5, 5])])
    available = np.where(mask, 65, 0).astype(np.int64)
    blocked = np.zeros(6, bool)
    want = check_all(arrays, available, mask, blocked,
                     tiles=(1, 2, 3, 4, 32))
    np.testing.assert_array_equal(want, [[1, 0, 0, 0, 1, 0],
                                         [1, 0, 0, 0, 1, 1],
                                         [1, 1, 1, 1, 1, 0]])


@pytest.mark.parametrize("edge,columns", [(32, (MEM,)), (64, (1, 3, 6)),
                                          (1024, (0, 1, 3, 6, 7))])
def test_emulation_cut_node_across_a_tile_edge(edge, columns):
    """The same at a tile edge of ``edge`` candidates (the kernel's own
    at 1,024 with five columns), the cut a few candidates before it."""
    arrays, available, mask, blocked = testing.sweep_cut_across_tile(
        edge, columns)
    want = check_all(arrays, available, mask, blocked, tiles=(edge,))
    a, b = np.flatnonzero(arrays["node_start"])[-2:]
    assert a < edge - 1 < b and not want[1][a + 1:b].any()
    assert want[2][b + 1] == 0 and want[2][b]


def test_emulation_walk_wraps_as_the_reference():
    """A headroom pushed past 2**31 by a negative metric wraps in the
    reference's int32 scan and so here: the emulation and the plain
    version equal the reference (the int64 replica, which does not wrap,
    differs: this case leaves its domain)."""
    available = np.zeros(R, np.int64)
    available[MEM] = 2_147_483_000
    arrays, mask = testing.sweep_rows([(10, 0, [-1_000, 1_000, 7])])
    rb.validate_sweep(rb.SweepBatch(**arrays), available, mask)
    blocked = np.zeros(3, bool)
    want = check_all(arrays, available, mask, blocked, tiles=(1, 2, 1024),
                     replica=False)
    np.testing.assert_array_equal(want[2], [1, 0, 0])
    replica = rb.replay_sweep_host(rb.SweepBatch(**arrays), available, mask,
                                   blocked)
    assert replica[2].all()


def test_emulation_exhausted_column_cuts_at_zero():
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        30, 400, exhausted=False)
    available = available.copy()
    available[MEM] = 0
    want = check_all(arrays, available, res_mask, blocked)
    assert not want[0].any() and not want[2].any()


def test_emulation_all_blocked_and_empty():
    arrays, available, res_mask, _ = testing.sweep_batch_arrays(31, 300)
    want = check_all(arrays, available, res_mask, np.ones(300, bool))
    assert not want[0].any()
    empty = {name: a[:0] for name, a in arrays.items()}
    streams, avail = emulated(empty, available, res_mask, np.zeros(0, bool),
                              1024)
    assert streams.shape == (3, 0)
    np.testing.assert_array_equal(avail, available)


def test_emulation_headroom_runs_out_inside_a_tile_and_a_node():
    """The headroom runs out part way through a node whose run crosses a
    tile edge, and nodes start on a tile's first candidate."""
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        32, 1100, headroom=60, blocked_frac=0.0, invalid_frac=0.0,
        exhausted=False)
    want = check_all(arrays, available, res_mask, blocked,
                     tiles=(32, 64, 1024))
    first_out = int(np.argmin(want[2]))
    assert not want[2][first_out] and not arrays["node_start"][first_out]


def varied(arrays, seed):
    """``high_q`` varied inside nodes (the serial route's batches)."""
    rng = np.random.default_rng(seed)
    return dict(arrays, high_q=arrays["high_q"] + rng.integers(
        -3_000, 3_000, arrays["high_q"].shape))


class Sink(Evictor):
    def _do_evict(self, snapshot, pod, reason):
        return True


def _lownodeload_sweep(spec, low, high):
    """The DeviceSweep a LowNodeLoad "device" pass on the CPU stages."""
    cpu, mem = ResourceName.CPU, ResourceName.MEMORY
    pool = NodePool(low_thresholds={cpu: low[0], mem: low[1]},
                    high_thresholds={cpu: high[0], mem: high[1]})
    made = []
    base = loadaware.DeviceSweep

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    loadaware.DeviceSweep = Recorded
    try:
        LowNodeLoad(LowNodeLoadArgs(node_pools=[pool], backend="device",
                                    device="cpu")).balance(
            testing.build_snapshot(spec, types, ResourceName), Sink())
    finally:
        loadaware.DeviceSweep = base
    assert len(made) == 1
    return made[0]


@pytest.mark.parametrize("which", ["config5", "config22"])
def test_lownodeload_batches_take_the_scan_route(which):
    if which == "config5":
        sweep = _lownodeload_sweep(testing.rebalance_world_spec(
            300, 1800, seed=5), (45, 60), (65, 80))
    else:
        sweep = _lownodeload_sweep(testing.rebalance_storm_spec(
            60, 10, seed=22), (30, 30), (60, 60))
    assert sweep.k > 0 and sweep.route == "scan"
    assert rb.sweep_route(sweep.batch.node_start, sweep.batch.high_q) == \
        "scan"


def test_varied_high_q_takes_the_serial_route():
    arrays, available, res_mask, _ = testing.sweep_batch_arrays(33, 200)
    assert rb.sweep_route(arrays["node_start"], arrays["high_q"]) == "scan"
    arrays = varied(arrays, 33)
    assert rb.sweep_route(arrays["node_start"], arrays["high_q"]) == "serial"
    staged = rb.stage_sweep_batch(rb.SweepBatch(**arrays), "cpu")
    assert rb.sweep_route(staged.node_start, staged.high_q) == "serial"
    sweep = rb.DeviceSweep(rb.SweepBatch(**arrays), available, res_mask,
                           device="cpu")
    assert sweep.route == "serial"
    # one candidate's row differing inside its node is enough; a row
    # differing at a node start is not
    one = testing.sweep_batch_arrays(34, 50)[0]
    starts = np.flatnonzero(one["node_start"])
    inner = next(i for i in range(1, 50) if not one["node_start"][i])
    hq = one["high_q"].copy()
    hq[starts[1]:] += 1
    assert rb.sweep_route(one["node_start"], hq) == "scan"
    hq[inner, 3] += 1
    assert rb.sweep_route(one["node_start"], hq) == "serial"


def test_scan_form_needs_one_high_q_per_node():
    """Why the route exists: on batches whose high_q varies inside a node
    the scan form may differ from the reference, which the serial kernel
    never does."""
    differ = 0
    for seed in range(40):
        arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
            seed, 200)
        arrays = varied(arrays, seed)
        want, _ = reference(arrays, available, res_mask, blocked)
        streams, _ = emulated(arrays, available, res_mask, blocked, 1024)
        differ += not np.array_equal(streams, want)
    assert differ > 0


@pytest.mark.parametrize("seed,vary", [(40, False), (41, False),
                                       (42, True)])
def test_refusals_splice_equals_full_runs(seed, vary):
    """Random refusal sequences through ``DeviceSweep.refuse`` (on the
    CPU: the plain version, its suffix spliced): after every refusal the
    streams equal a fresh full run with the same mask, the reference's
    scan and the replica."""
    k = 400
    arrays, available, res_mask, _ = testing.sweep_batch_arrays(
        seed, k, headroom=120)
    if vary:
        arrays = varied(arrays, seed)
    batch = rb.SweepBatch(**arrays)
    sweep = rb.DeviceSweep(batch, available, res_mask, device="cpu")
    assert sweep.route == ("serial" if vary else "scan")
    blocked = np.zeros(k, bool)
    got = sweep.run(blocked)
    rng = np.random.default_rng(seed)
    for step in range(12):
        proposed = np.flatnonzero(got[0])
        j = (int(rng.choice(proposed)) if proposed.size and step % 3
             else int(rng.integers(k)))
        blocked[j] = True
        got = sweep.refuse(j)
        fresh = rb.DeviceSweep(batch, available, res_mask,
                               device="cpu").run(blocked)
        want, _ = reference(arrays, available, res_mask, blocked)
        replica = rb.replay_sweep_host(batch, available, res_mask, blocked)
        for g, f, w, r in zip(got, fresh, want, replica):
            np.testing.assert_array_equal(g, f)
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(sweep.blocked.numpy(), blocked)
    with pytest.raises(IndexError):
        sweep.refuse(k)


def test_refusal_leaves_the_prefix_unchanged():
    """The contract the splice rests on: a refusal at ``j`` changes no
    decision before ``j``."""
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        43, 600, headroom=100)
    batch = rb.SweepBatch(**arrays)
    before = np.stack(rb.replay_sweep_host(batch, available, res_mask,
                                           blocked))
    for j in np.flatnonzero(before[0])[::7]:
        more = blocked.copy()
        more[j] = True
        after = np.stack(rb.replay_sweep_host(batch, available, res_mask,
                                              more))
        np.testing.assert_array_equal(after[:, :j], before[:, :j])
        assert not after[0, j]
