"""Reservations in the port against the JAX package, bit for bit: the
loop solver and the kernel's CPU path (its plain twin, through the same
node -> reservation CSR the CUDA kernel reads) against the reference's
``solve_batch`` and, for one seed, its Pallas kernel in interpret mode;
the gates; the owner match of the typed path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import NUM_RESOURCES, ResourceName as R
from koordinator_tpu.ops import binpack as jbp
from koordinator_tpu.ops.pallas_binpack import (
    pallas_resv_supported,
    pallas_solve_batch,
)
from koordinator_tpu.scheduler.plugins.reservation import (
    reservation_matches_pod as j_matches,
)
from koordinator_tpu_torch import convert, testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TR
from koordinator_tpu_torch.models.placement import _match_matrix
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import SolverConfig, solve_batch
from koordinator_tpu_torch.scheduler.plugins.reservation import (
    reservation_matches_pod,
)
from test_torch_binpack import _setup, as_dict, assert_same_result, port


def jresv(d):
    return jbp.ResvArrays(**{k: jnp.asarray(v) for k, v in d.items()})


def tresv(d):
    return convert.resv_arrays(d, "cpu")


def assert_same_resv(got, want):
    assert_same_result(got, want)
    for f in ("resv_free", "resv_vstar", "resv_delta"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def solve(solver, state, pods, params, quota=None, gang=None, resv=None,
          numa=None, config=SolverConfig()):
    """The port's ``solver`` ("loop" or "kernel", the kernel's CPU twin)
    on CPU tensors."""
    if solver == "loop":
        return solve_batch(state, pods, params, config, quota, gang,
                           resv=resv, numa=numa)
    return bk.kernel_solve_batch(
        state, pods, params, quota, gang, numa_aux=numa, resv=resv,
        most_allocated=config.numa_most_allocated)


@pytest.mark.parametrize("solver", ["loop", "kernel"])
@pytest.mark.parametrize("kind", ["plain", "gang", "quota+gang"])
@pytest.mark.parametrize("seed", [0, 1])
def test_resv_matches_reference(solver, kind, seed):
    state, pods, params, quota, gang = _setup(kind, seed, 64, 100)
    table = testing.resv_table_arrays(64, 100, 11, seed=seed + 8)
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(), quota,
                           gang, resv=jresv(table))
    got = solve(solver, *port(state, pods, params, quota, gang),
                resv=tresv(table))
    assert_same_resv(got, want)
    vstar = np.asarray(want.resv_vstar)
    assert (vstar >= 0).sum() > 0      # reservations really consumed
    if gang is not None:               # the rejected-release restore ran
        assert (np.asarray(want.rejected) & (vstar >= 0)).sum() > 0


def _credit_problem():
    """Every node fully held; one matched reservation of 4000 m CPU on
    node 3 is the only room for two 2000 m pods."""
    n_nodes = 5
    alloc = np.zeros((n_nodes, NUM_RESOURCES), np.int32)
    alloc[:, R.CPU], alloc[:, R.MEMORY] = 8000, 16384
    zeros = np.zeros_like(alloc)
    nodes = dict(alloc=alloc, used_req=alloc.copy(), usage=zeros,
                 prod_usage=zeros, est_extra=zeros, prod_base=zeros,
                 metric_fresh=np.ones(n_nodes, bool),
                 schedulable=np.ones(n_nodes, bool))
    req = np.zeros((2, NUM_RESOURCES), np.int32)
    req[:, R.CPU] = 2000
    falses = np.zeros(2, bool)
    pods = dict(req=req, est=req, is_prod=falses, is_daemonset=falses,
                quota_id=np.full(2, -1, np.int32), non_preemptible=falses,
                gang_id=np.full(2, -1, np.int32), blocked=falses)
    weights = np.zeros(NUM_RESOURCES, np.int32)
    weights[:2] = 1
    zero_r = np.zeros(NUM_RESOURCES, np.int32)
    params = dict(weights=weights, thresholds=zero_r, prod_thresholds=zero_r)
    free = np.zeros((1, NUM_RESOURCES), np.int32)
    free[0, R.CPU], free[0, R.MEMORY] = 4000, 4096
    table = dict(node=np.array([3], np.int32), free=free,
                 allocate_once=np.array([False]),
                 match=np.ones((2, 1), bool))
    return nodes, pods, params, table


@pytest.mark.parametrize("solver", ["loop", "kernel"])
def test_resv_credit_flips_fit(solver):
    nodes, pods, params, table = _credit_problem()
    j = [jbp.NodeState(**{k: jnp.asarray(v) for k, v in nodes.items()}),
         jbp.PodBatch(**{k: jnp.asarray(v) for k, v in pods.items()}),
         jbp.ScoreParams(**{k: jnp.asarray(v) for k, v in params.items()})]
    want = jbp.solve_batch(*j, jbp.SolverConfig(), resv=jresv(table))
    got = solve(solver, convert.node_state(nodes, "cpu"),
                convert.pod_batch(pods, "cpu"),
                convert.score_params(params, "cpu"), resv=tresv(table))
    assert_same_resv(got, want)
    np.testing.assert_array_equal(got.assign.numpy(), [3, 3])
    assert int(got.resv_free[0, R.CPU]) == 0     # 2 x 2000 consumed


def _budget_table(state, n_pods):
    """330 times the smallest node's CPU as one matched free remainder on
    that node: the credit alone pushes the fit score past 32767."""
    alloc = np.asarray(state.alloc)
    free = np.zeros((1, NUM_RESOURCES), np.int32)
    free[0, R.CPU] = int(alloc[:, R.CPU].min()) * 330
    return dict(node=np.array([int(alloc[:, R.CPU].argmin())], np.int32),
                free=free, allocate_once=np.array([False]),
                match=np.ones((n_pods, 1), bool))


def test_resv_score_budget_table_loop_and_gate():
    """The reference's score-budget table: the loop solver still equals
    the reference's scan (the port divides exactly, the reference
    through a corrected float reciprocal: they agree here), and the
    kernel gates refuse it."""
    state, pods, params, _, _ = _setup("plain", 5)
    bad = _budget_table(state, pods.req.shape[0])
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(),
                           resv=jresv(bad))
    s, p, pr, _, _ = port(state, pods, params)
    got = solve_batch(s, p, pr, SolverConfig(), resv=tresv(bad))
    assert_same_resv(got, want)
    assert not bk.kernel_resv_score_safe(bad["node"], bad["free"], s.alloc)
    assert not bk.kernel_routing_ok(s, p, None, tresv(bad), False)
    with pytest.raises(ValueError, match="score budget"):
        bk.kernel_solve_batch(s, p, pr, resv=tresv(bad))
    ok = testing.resv_table_arrays(96, 150, 11, seed=15)
    assert bk.kernel_resv_score_safe(ok["node"], ok["free"], s.alloc)
    assert bk.kernel_routing_ok(s, p, None, tresv(ok), True)


def test_many_reservations_take_the_kernel():
    """300 reservations: past the reference kernel's 256 cap, taken by the
    port's kernel path (its CPU twin here) and equal to the reference's
    scan."""
    state, pods, params, _, gang = _setup("gang", 4, 48, 80)
    table = testing.resv_table_arrays(48, 80, 300, seed=12, match_frac=0.02)
    assert not pallas_resv_supported(300, 48)
    assert bk.kernel_resv_supported(300)
    assert not bk.kernel_resv_supported(0)
    s, p, pr, _, g = port(state, pods, params, None, gang)
    assert bk.kernel_routing_ok(s, p, None, tresv(table))
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(), None,
                           gang, resv=jresv(table))
    got = bk.kernel_solve_batch(s, p, pr, None, g, resv=tresv(table))
    assert_same_resv(got, want)
    assert (np.asarray(want.resv_vstar) >= 0).sum() > 0


def test_kernel_twin_matches_pallas_interpret():
    """The kernel's CPU path against the reference kernel itself
    (interpret mode), node and pod counts off its 128-multiples."""
    state, pods, params, quota, gang = _setup("quota+gang", 2, 72, 90)
    table = testing.resv_table_arrays(72, 90, 13, seed=10)
    want = pallas_solve_batch(state, pods, params, jbp.SolverConfig(), quota,
                              gang, resv=jresv(table), interpret=True)
    before = dict(bk.LAUNCHES)
    got = bk.kernel_solve_batch(*port(state, pods, params, quota, gang),
                                resv=tresv(table))
    assert bk.LAUNCHES == before          # CPU tensors: the plain twin
    assert_same_resv(got, want)


def test_resv_csr_layout():
    """Ids sorted by (node, id), offsets over every node, empty nodes
    included, reservations on the first and the last node."""
    node = torch.tensor([4, 0, 2, 0, 4, 4, 2], dtype=torch.int32)
    offsets, ids = bk.resv_csr(node, 5)
    assert offsets.tolist() == [0, 2, 2, 4, 4, 7]
    assert ids.tolist() == [1, 3, 2, 6, 0, 4, 5]
    assert offsets.dtype == ids.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1])
def test_match_matrix_equals_pairwise_match(seed):
    """The typed path's indexed owner match equals the reference's
    ``reservation_matches_pod`` over every (pod, reservation) pair."""
    spec = testing.mixed_snapshot_spec(seed, reservations=True)
    jsnap = testing.build_snapshot(spec, jtypes, R)
    tsnap = testing.build_snapshot(spec, ttypes, TR)
    got = _match_matrix(tsnap.reservations, tsnap.pending_pods)
    want = np.array([[j_matches(r, p) for r in jsnap.reservations]
                     for p in jsnap.pending_pods])
    np.testing.assert_array_equal(got, want)
    pairwise = np.array([[reservation_matches_pod(r, p)
                          for r in tsnap.reservations]
                         for p in tsnap.pending_pods])
    np.testing.assert_array_equal(got, pairwise)
    assert got.any() and not got.all()


def test_convert_resv_and_builders():
    """``convert.resv_arrays`` carries the reference's ResvArrays across;
    the seeded table draws what the reference's kernel tests draw."""
    table = testing.resv_table_arrays(30, 20, 5, seed=3)
    got = tresv(as_dict(jresv(table)))
    for k, v in table.items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
    with pytest.raises(ValueError):
        convert.resv_arrays({**table, "onehot": np.zeros(3)}, "cpu")
