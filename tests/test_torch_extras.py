"""Host extras rows (node selectors, host ports, the fine-grained
plugins' rows) in the port against the JAX package, bit for bit: the
kernel's plain twins (one block and k > 1 shards) with the compact rows
the kernel reads, and the loop solver with the dense rows, against the
reference's ``solve_batch(extras=...)``, alone and with quota, gangs,
reservations and NUMA least/most; the score-budget gate that keeps a
negative or over-budget score off the kernel; the model's dispatch; and
the model's compact rows against the reference model's dense ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import binpack as jbp
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.models.placement import HostRows, PlacementModel
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import (
    Extras,
    ExtrasRows,
    SolverConfig,
    solve_batch,
)
from test_torch_binpack import _setup, port
from test_torch_numa import assert_same_numa, with_numa
from test_torch_resv import assert_same_resv, jresv, tresv

N_NODES, N_PODS = 48, 80

#: (selector, scored, deferred) fractions of the pods with a row
KINDS = {
    "selector": (0.4, 0.0, 0.0),
    "ports": (0.0, 0.0, 0.15),
    "scored": (0.0, 0.3, 0.0),
    "mixed": (0.2, 0.15, 0.05),
}
FEATURES = ("plain", "quota+gang", "resv", "numa-least", "numa-most")


def _rows(kind, seed):
    sel, scored, deferred = KINDS[kind]
    return testing.extras_arrays(N_NODES, N_PODS, selector_frac=sel,
                                 scored_frac=scored, deferred_frac=deferred,
                                 n_zones=3, seed=seed)


def _compact(rows):
    row, mask, score = rows
    return ExtrasRows(torch.as_tensor(row), torch.as_tensor(mask),
                      torch.as_tensor(score))


def _problem(feature, seed):
    """The reference's inputs and solve kwargs, and the port's."""
    kind = "quota+gang" if feature in ("quota+gang", "resv") else "plain"
    state, pods, params, quota, gang = _setup(kind, seed, N_NODES, N_PODS)
    jkw, tkw = {}, {}
    config = SolverConfig()
    if feature.startswith("numa"):
        state, pods, jaux, taux = with_numa(state, pods, seed + 7)
        jkw["numa"], tkw["numa"] = jaux, taux
        config = SolverConfig(numa_most_allocated=feature == "numa-most")
    if feature == "resv":
        table = testing.resv_table_arrays(N_NODES, N_PODS, 9, seed=seed + 8)
        jkw["resv"], tkw["resv"] = jresv(table), tresv(table)
    return (state, pods, params, quota, gang, jkw), (
        port(state, pods, params, quota, gang), tkw, config)


def _assert_same(got, want, feature):
    if feature == "resv":
        assert_same_resv(got, want)
    if feature.startswith("numa"):
        assert_same_numa(got, want)
    for f in ("assign", "raw_assign", "commit", "waiting", "rejected"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("used_req", "est_extra", "prod_base"):
        np.testing.assert_array_equal(
            getattr(got.node_state, f).numpy(),
            np.asarray(getattr(want.node_state, f)), err_msg=f)


@pytest.mark.parametrize("feature", FEATURES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_extras_match_reference(kind, feature):
    """twin (compact, 1 and 3 shards) == loop (dense and compact) == the
    JAX scan (dense)."""
    seed = sorted(KINDS).index(kind)
    (state, pods, params, quota, gang, jkw), (tport, tkw, config) = (
        _problem(feature, seed))
    rows = _rows(kind, seed + 20)
    dmask, dscore = testing.dense_extras(*rows)
    want = jbp.solve_batch(
        state, pods, params,
        jbp.SolverConfig(numa_most_allocated=config.numa_most_allocated),
        quota, gang, jbp.Extras(jnp.asarray(dmask), jnp.asarray(dscore)),
        **jkw)
    compact = _compact(rows)
    dense = Extras(torch.as_tensor(dmask), torch.as_tensor(dscore))
    s, p, pr, q, g = tport
    for extras in (dense, compact):
        _assert_same(solve_batch(s, p, pr, config, q, g, extras,
                                 tkw.get("resv"), tkw.get("numa")),
                     want, feature)
    assert bk.kernel_routing_ok(s, p, compact, tkw.get("resv"), True,
                                tkw.get("numa"), True)
    got = bk.kernel_solve_batch(
        s, p, pr, q, g, numa_aux=tkw.get("numa"), resv=tkw.get("resv"),
        most_allocated=config.numa_most_allocated, extras=compact)
    _assert_same(got, want, feature)
    # the cluster kernel's twin at 3 shards, on the same inputs
    inp = bk.kernel_inputs(s, p, pr, bk.quota_inputs(q), None,
                           tkw.get("numa"), tkw.get("resv"),
                           config.numa_most_allocated, compact)
    one = bk.binpack_plain(inp)
    three = bk.binpack_sharded_plain(inp, 3)
    for f in one._fields:
        a, b = getattr(one, f), getattr(three, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    # the rows mattered: masked-out nodes were never chosen
    assign = np.asarray(want.raw_assign)
    placed = assign >= 0
    assert placed.any()
    assert dmask[np.flatnonzero(placed), assign[placed]].all()


def test_extras_scores_move_placements():
    """A scored row changes where its pod lands, on every route."""
    state, pods, params, _, _ = _setup("plain", 4, N_NODES, N_PODS)
    row = np.full(N_PODS, -1, np.int32)
    row[0] = 0
    base = jbp.solve_batch(state, pods, params, jbp.SolverConfig())
    first = int(np.asarray(base.raw_assign)[0])
    assert first >= 0
    score = np.zeros((1, N_NODES), np.int32)
    score[0, (first + 1) % N_NODES] = 100
    mask = np.ones((1, N_NODES), bool)
    rows = (row, mask, score)
    dmask, dscore = testing.dense_extras(*rows)
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(),
                           extras=jbp.Extras(jnp.asarray(dmask),
                                             jnp.asarray(dscore)))
    assert int(np.asarray(want.raw_assign)[0]) != first
    s, p, pr, _, _ = port(state, pods, params)
    got = bk.kernel_solve_batch(s, p, pr, extras=_compact(rows))
    np.testing.assert_array_equal(got.raw_assign.numpy(),
                                  np.asarray(want.raw_assign))


def test_compact_rows_equal_dense():
    """``ExtrasRows.dense`` and ``HostRows`` keep the dense rows bit for
    bit; equal rows share one compact row."""
    rows = _rows("mixed", 3)
    dmask, dscore = testing.dense_extras(*rows)
    dense = _compact(rows).dense()
    np.testing.assert_array_equal(dense.mask.numpy(), dmask)
    np.testing.assert_array_equal(dense.score.numpy(), dscore)
    host = HostRows(N_PODS, N_NODES)
    for i in range(N_PODS):
        if rows[0][i] >= 0:
            host.assign(i, dmask[i], dscore[i])
    row_of_pod, mask, score = host.arrays()
    assert mask.shape[0] == len(set(rows[0][rows[0] >= 0].tolist()))
    np.testing.assert_array_equal(
        testing.dense_extras(row_of_pod, mask, score)[0], dmask)
    np.testing.assert_array_equal(
        testing.dense_extras(row_of_pod, mask, score)[1], dscore)
    empty = ExtrasRows(torch.full((3,), -1, dtype=torch.int32),
                       torch.zeros((0, 5), dtype=torch.bool),
                       torch.zeros((0, 5), dtype=torch.int32)).dense()
    assert empty.mask.all() and not empty.score.any()


@pytest.mark.parametrize("bad", [-1, 101])
def test_unsafe_extras_scores_take_the_loop(bad):
    """A negative or over-100 score keeps a solve off the kernel (the
    scan's ``where(mask, score, -1)`` makes a masked-in negative score
    infeasible, the packed key would not); the loop then equals the
    reference's scan."""
    state, pods, params, _, _ = _setup("plain", 5, N_NODES, N_PODS)
    row, mask, score = _rows("scored", 7)
    score = score.copy()
    score[0, :] = bad
    rows = (row, mask, score)
    assert not bk.kernel_extras_score_safe(score)
    s, p, pr, _, _ = port(state, pods, params)
    compact = _compact(rows)
    assert not bk.kernel_routing_ok(s, p, compact, None, True, None,
                                    bk.kernel_extras_score_safe(score))
    with pytest.raises(ValueError, match="extras score"):
        bk.kernel_solve_batch(s, p, pr, extras=compact)
    model = PlacementModel(device="cpu")
    got = model._dispatch_solve(s, p, None, None, compact,
                                extras_safe=bk.kernel_extras_score_safe(score))
    assert model.last_solver == "loop"
    dmask, dscore = testing.dense_extras(*rows)
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(),
                           extras=jbp.Extras(jnp.asarray(dmask),
                                             jnp.asarray(dscore)))
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))


def test_extras_budget_with_reservation_credit():
    """The worst score before extras plus the largest extras score must
    fit the packed key's 15 bits: a reservation table that alone fits
    can push a scored table past it."""
    alloc = np.zeros((4, 8), np.int32)
    alloc[:, 0] = 1000
    node = np.array([1], np.int32)
    free = np.zeros((1, 8), np.int32)
    free[0, 0] = 324 * 1000       # credit ratio 324: worst 32,700
    worst = bk.resv_score_worst(node, free, alloc)
    assert worst == 32700 and bk.kernel_resv_score_safe(node, free, alloc)
    assert bk.kernel_extras_score_safe(np.zeros((1, 4), np.int32), worst)
    assert bk.kernel_extras_score_safe(np.full((1, 4), 67, np.int32), worst)
    assert not bk.kernel_extras_score_safe(np.full((1, 4), 68, np.int32),
                                           worst)
    assert bk.kernel_extras_score_safe(np.full((2, 4), 100, np.int32))


def test_dispatch_sends_extras_to_the_kernel():
    """Node-selector and host-port pods (the model's own rows) and
    fine-grained specials (rows from its plugins) take the kernel; the
    result equals the reference model's scan."""
    from koordinator_tpu.apis import types as jtypes
    from koordinator_tpu.apis.extension import ResourceName as JR
    from koordinator_tpu.models.placement import PlacementModel as JModel
    from koordinator_tpu_torch.apis import types as ttypes
    from koordinator_tpu_torch.apis.extension import ResourceName as TR

    spec = testing.mixed_snapshot_spec(2, selectors=True)
    jsnap = testing.build_snapshot(spec, jtypes, JR)
    tsnap = testing.build_snapshot(spec, ttypes, TR)
    model = PlacementModel(device="cpu")
    seen = []
    dispatch = model._dispatch_solve

    def record(*args, **kw):
        out = dispatch(*args, **kw)
        seen.append((model.last_solver, args[4]))
        return out

    model._dispatch_solve = record
    got = model.schedule(tsnap)
    want = JModel(use_pallas=False).schedule(jsnap)
    assert dict(got) == dict(want) and got.waiting == want.waiting
    assert [s for s, _ in seen] == ["kernel"]
    extras = seen[0][1]
    assert isinstance(extras, ExtrasRows)
    # selector pods with the same selector share a row
    n_rows = extras.mask.shape[0]
    assert 0 < n_rows < int((extras.row_of_pod >= 0).sum())


def _capture(model, jax_model):
    """Wrap ``_dispatch_solve`` to record each solve's extras as dense
    numpy ``[P,N]`` rows (the reference's unpadded to its real pods)."""
    out = []
    dispatch = model._dispatch_solve

    def record(*args, **kw):
        extras = args[4]
        if extras is None:
            out.append(None)
        elif jax_model:
            n = int(args[0].alloc.shape[0])
            out.append((np.asarray(extras.mask)[:, :n],
                        np.asarray(extras.score)[:, :n]))
        else:
            dense = extras.dense()
            out.append((dense.mask.numpy(), dense.score.numpy()))
        return dispatch(*args, **kw)

    model._dispatch_solve = record
    return out


def test_refine_loop_rows_equal_reference_dense():
    """Every solve of the fine-grained refine loop, round for round: the
    port's compact rows expanded equal the reference model's dense rows
    (the reference pads its pod axis to a bucket: compared on the real
    pods)."""
    from test_torch_finegrained import PORT, REF, _apply, _stream

    ref, prt = REF.scheduler(), PORT.scheduler()
    jrows = _capture(ref.model, True)
    trows = _capture(prt.model, False)
    stream, _ = _stream(seed=11, rounds=3)
    for now, events in stream:
        for event in events:
            _apply(ref, REF, event)
            _apply(prt, PORT, event)
        assert dict(prt.schedule_pending(now)) == dict(
            ref.schedule_pending(now))
    assert len(trows) == len(jrows) and len(trows) > 3
    for t, j in zip(trows, jrows):
        assert (t is None) == (j is None)
        if t is not None:
            p = t[0].shape[0]
            np.testing.assert_array_equal(t[0], j[0][:p])
            np.testing.assert_array_equal(t[1], j[1][:p])
