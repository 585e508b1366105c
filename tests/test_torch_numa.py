"""NUMA scoring and consumption in the port against the JAX package, bit
for bit: both scorers through the loop solver and the kernel's CPU path
against the reference's ``solve_batch``; the fused quota + gang + NUMA +
reservation solve; the kernel's twin against the reference kernel in
interpret mode; the bench's config #8 builder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import binpack as jbp
from koordinator_tpu.ops.gang import GangState as JGangState
from koordinator_tpu.ops.pallas_binpack import pallas_solve_batch
from koordinator_tpu.ops.quota import QuotaState as JQuotaState
from koordinator_tpu_torch import convert, testing
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import SolverConfig, numa_node_score
from test_torch_binpack import _setup, port
from test_torch_resv import assert_same_resv, jresv, solve, tresv


def with_numa(state, pods, seed):
    """The reference's state and pods with NUMA inventories and policies,
    and its NumaAux; plus the port's NumaAux."""
    cap, free, pod_policy, node_policy = testing.numa_arrays(
        np.asarray(state.alloc), pods.req.shape[0], seed)
    state = state._replace(numa_cap=jnp.asarray(cap),
                           numa_free=jnp.asarray(free))
    pods = pods._replace(has_numa_policy=jnp.asarray(pod_policy))
    return (state, pods, jbp.NumaAux(jnp.asarray(node_policy)),
            convert.numa_aux(dict(node_policy=node_policy), "cpu"))


def assert_same_numa(got, want):
    np.testing.assert_array_equal(got.numa_consumed.numpy(),
                                  np.asarray(want.numa_consumed))
    np.testing.assert_array_equal(got.node_state.numa_free.numpy(),
                                  np.asarray(want.node_state.numa_free))


@pytest.mark.parametrize("solver", ["loop", "kernel"])
@pytest.mark.parametrize("most", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_numa_matches_reference(solver, most, seed):
    state, pods, params, _, _ = _setup("plain", seed, 64, 100)
    state, pods, jaux, taux = with_numa(state, pods, seed + 7)
    want = jbp.solve_batch(state, pods, params,
                           jbp.SolverConfig(numa_most_allocated=most),
                           numa=jaux)
    s, p, pr, _, _ = port(state, pods, params)
    got = solve(solver, s, p, pr, numa=taux,
                config=SolverConfig(numa_most_allocated=most))
    assert got.resv_free is None and got.resv_vstar is None
    assert_same_numa(got, want)
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    np.testing.assert_array_equal(got.node_state.used_req.numpy(),
                                  np.asarray(want.node_state.used_req))
    assert int(np.asarray(want.numa_consumed).sum()) > 0


@pytest.mark.parametrize("solver", ["loop", "kernel"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_quota_gang_numa_resv_matches_reference(solver, seed):
    """Every kernel feature at once: quota admission, Strict gangs, NUMA
    scoring and consumption, reservation credit and consumption."""
    state, pods, params, quota, gang = _setup("quota+gang", seed, 64, 100)
    state, pods, jaux, taux = with_numa(state, pods, seed + 7)
    table = testing.resv_table_arrays(64, 100, 11, seed=seed + 8)
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(), quota,
                           gang, resv=jresv(table), numa=jaux)
    got = solve(solver, *port(state, pods, params, quota, gang),
                resv=tresv(table), numa=taux)
    assert_same_resv(got, want)
    assert_same_numa(got, want)
    # gang rejections released NUMA holds
    assert (np.asarray(want.rejected) & np.asarray(want.numa_consumed)).any()


@pytest.mark.parametrize("most", [False, True])
def test_kernel_twin_matches_pallas_interpret(most):
    """The kernel's CPU path against the reference kernel (interpret
    mode) on the fused solve, off its 128-multiples."""
    state, pods, params, quota, gang = _setup("quota+gang", 3, 70, 85)
    state, pods, jaux, taux = with_numa(state, pods, 10)
    table = testing.resv_table_arrays(70, 85, 9, seed=11)
    config = jbp.SolverConfig(numa_most_allocated=most)
    want = pallas_solve_batch(state, pods, params, config, quota, gang,
                              numa_aux=jaux, resv=jresv(table),
                              interpret=True)
    got = bk.kernel_solve_batch(*port(state, pods, params, quota, gang),
                                numa_aux=taux, resv=tresv(table),
                                most_allocated=most)
    assert_same_resv(got, want)
    assert_same_numa(got, want)


def test_numa_node_score_matches_reference():
    rng = np.random.default_rng(4)
    cap = rng.choice([0, 4000, 16000], (40, 8)).astype(np.int32)
    free = (cap * rng.uniform(0, 1, cap.shape)).astype(np.int32)
    req = np.array([3000, 0, 500, 0, 0, 0, 7000, 0], np.int32)
    for most in (False, True):
        want = jbp.numa_node_score(jnp.asarray(cap), jnp.asarray(free),
                                   jnp.asarray(req),
                                   jbp.SolverConfig(numa_most_allocated=most))
        got = numa_node_score(*(torch.as_tensor(a) for a in (cap, free, req)),
                              SolverConfig(numa_most_allocated=most))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_full_features_builder_matches_reference():
    """Bench config #8 at a small shape: the port's builder solved by the
    kernel's CPU path equals the reference's ``solve_batch`` on the same
    arrays, with every feature active."""
    nodes, pods, params, quota, gang, table, node_policy = (
        testing.full_features_arrays(60, 128))
    jstate = jbp.NodeState(**{k: jnp.asarray(v) for k, v in nodes.items()})
    jpods = jbp.PodBatch(**{k: jnp.asarray(v) for k, v in pods.items()})
    jparams = jbp.ScoreParams(**{k: jnp.asarray(v) for k, v in params.items()})
    want = jbp.solve_batch(jstate, jpods, jparams, jbp.SolverConfig(),
                           JQuotaState.build(**quota),
                           JGangState.build(**gang), resv=jresv(table),
                           numa=jbp.NumaAux(jnp.asarray(node_policy)))
    problem = testing.full_features_problem(60, 128, device="cpu")
    s, p, pr, q, g, resv, aux = problem
    assert bk.kernel_routing_ok(s, p, None, resv, True, aux)
    got = bk.kernel_solve_batch(s, p, pr, q, g, numa_aux=aux, resv=resv)
    assert_same_resv(got, want)
    assert_same_numa(got, want)
    assert int(np.asarray(want.commit).sum()) > 0
    assert not bk.kernel_routing_ok(s._replace(numa_cap=None), p, None, resv,
                                    True, aux)
