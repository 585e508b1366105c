"""The node-sharded solve in the port against the JAX package, bit for
bit: the bucket helpers of ``parallel/mesh.py``; the cluster kernel's
plain twin ``binpack_sharded_plain`` against the one-block twin
``binpack_plain`` (every variant, shard counts up to 16, padding-only
shards, a tie across a shard boundary, reservations on shard edges);
``shard_kernel_solver(k, device="cpu")`` against the reference's
single-device ``solve_batch`` on the shapes of
``tests/test_shard_kernel.py`` and, once, against the reference's own
sharded kernel in interpret mode; and the reference's ``ValueError``
gates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.apis.extension import NUM_RESOURCES, ResourceName as R
from koordinator_tpu.ops import binpack as jbp
from koordinator_tpu.ops.gang import GangState as JGangState
from koordinator_tpu.ops.quota import QuotaState as JQuotaState
from koordinator_tpu.parallel import mesh as jmesh
from koordinator_tpu.testing import example_problem as jax_example_problem
from koordinator_tpu.testing import example_resv
from koordinator_tpu_torch import convert
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import SolverConfig
from koordinator_tpu_torch.parallel import mesh
from test_torch_binpack import _setup, as_dict, assert_same_result, port
from test_torch_hygiene import _resv_numa_inputs
from test_torch_resv import _budget_table, assert_same_resv, jresv, tresv

#: node counts for the bucket helpers: every count to 300, then a sample
#: to 70,000 with the powers of two and the 16-bit edge
_COUNTS = sorted({*range(1, 301), *range(301, 70001, 331), 1024, 4096, 5000,
                  8192, 65535, 65536, 65537, 70000})


def test_pow2_quarter_bucket_matches_reference():
    for floor in (1, 8, 128):
        for n in _COUNTS:
            assert (mesh.pow2_quarter_bucket(n, floor)
                    == jmesh.pow2_quarter_bucket(n, floor)), (n, floor)


@pytest.mark.parametrize("shards", range(1, 17))
def test_shard_buckets_match_reference(shards):
    for n in _COUNTS:
        assert (mesh.shard_tile_bucket(n, shards)
                == jmesh.shard_tile_bucket(n, shards)), n
        assert (mesh.shard_node_bucket(n, shards)
                == jmesh.shard_node_bucket(n, shards)), n


def _kernel_inputs(kind, n_nodes, n_pods, seed):
    """CPU kernel inputs with every branch the kernel takes (stale
    metrics, unschedulable and empty nodes, DaemonSet, blocked and
    never-fitting pods, non-unit weights) for one variant: "plain",
    "quota", "resv" (600 reservations, quota), "numa-least" (quota) or
    "numa-most" (quota, reservations on the first and last node)."""
    layout = {"resv": "many", "numa-most": "ends"}.get(kind, "one")
    numa = {"numa-least": "least", "numa-most": "most"}.get(kind)
    inp = _resv_numa_inputs(n_nodes, n_pods, 0 if kind == "plain" else 5,
                            layout, numa, seed, dev="cpu")
    if kind not in ("resv", "numa-most"):
        inp = inp._replace(resv=None)
    return inp


def assert_same_outputs(got, want):
    for g, w, name in zip(got, want, got._fields):
        if w is None:
            assert g is None, name
        else:
            assert torch.equal(g, w), name


_KINDS = ["plain", "quota", "resv", "numa-least", "numa-most"]


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("shards", [2, 3, 8, 16])
def test_sharded_twin_matches_plain_twin(shards, kind):
    """327 nodes: not a multiple of 128 x shards, so the last shard is
    partly padding (and at 16 shards the last ones are all padding)."""
    inp = _kernel_inputs(kind, 327, 90, seed=shards)
    want = bk.binpack_plain(inp)
    assert_same_outputs(bk.binpack_sharded_plain(inp, shards), want)
    assert int((want.assign >= 0).sum()) > 0


@pytest.mark.parametrize("kind", _KINDS)
def test_padding_only_shards(kind):
    """20 nodes over 16 shards of 128 rows: shards 1..15 hold no node."""
    inp = _kernel_inputs(kind, 20, 60, seed=4)
    want = bk.binpack_plain(inp)
    before = bk.CLUSTER_LAUNCHES
    assert_same_outputs(bk.binpack_sharded(inp, 16), want)
    assert bk.CLUSTER_LAUNCHES == before      # CPU tensors: the plain twin
    assert int((want.assign >= 0).sum()) > 0


def _tie_problem(n_nodes, edge, better):
    """Every node half used except ``edge - 1`` and ``edge`` (the last row
    of one shard and the first of the next), which are empty; with
    ``better`` node ``edge - 1`` holds 4,000 m CPU, so ``edge`` wins.
    Returns the reference's (NodeState, PodBatch, ScoreParams)."""
    alloc = np.zeros((n_nodes, NUM_RESOURCES), np.int32)
    alloc[:, R.CPU], alloc[:, R.MEMORY] = 64000, 131072
    used = alloc // 2
    used[[edge - 1, edge]] = 0
    if better:
        used[edge - 1, R.CPU] = 4000
    zeros = np.zeros_like(alloc)
    state = jbp.NodeState(
        alloc=jnp.asarray(alloc), used_req=jnp.asarray(used),
        usage=jnp.asarray(zeros), prod_usage=jnp.asarray(zeros),
        est_extra=jnp.asarray(zeros), prod_base=jnp.asarray(zeros),
        metric_fresh=jnp.ones(n_nodes, bool),
        schedulable=jnp.ones(n_nodes, bool))
    req = np.zeros((4, NUM_RESOURCES), np.int32)
    req[:, R.CPU], req[:, R.MEMORY] = 1000, 1024
    pods = jbp.PodBatch.build(req=jnp.asarray(req), est=jnp.asarray(req),
                              is_prod=jnp.zeros(4, bool),
                              is_daemonset=jnp.zeros(4, bool))
    weights = np.zeros(NUM_RESOURCES, np.int32)
    weights[[R.CPU, R.MEMORY]] = 1
    params = jbp.ScoreParams(weights=jnp.asarray(weights),
                             thresholds=jnp.zeros(NUM_RESOURCES, jnp.int32),
                             prod_thresholds=jnp.zeros(NUM_RESOURCES,
                                                       jnp.int32))
    return state, pods, params


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("better", [False, True])
def test_cross_shard_tie(shards, better):
    """Identical best nodes at the last row of shard 0 (127) and the first
    of shard 1 (128): the smaller index wins, then the other one; when
    128 is strictly better, shard 1's best wins the merge twice."""
    state, pods, params = _tie_problem(256, 128, better)
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig())
    s, p, pr, _, _ = port(state, pods, params)
    got = mesh.shard_kernel_solver(shards, device="cpu")(s, p, pr)
    assert_same_result(got, want)
    first = [128, 128] if better else [127, 128]
    assert got.assign[:2].tolist() == first
    inp = bk.kernel_inputs(s, p, pr)
    assert_same_outputs(bk.binpack_sharded_plain(inp, shards),
                        bk.binpack_plain(inp))


def test_reservations_on_shard_edges():
    """Reservations on the first and last node of each of three shards
    (0, 127, 128, 255, 256, 383): credit and consumption by the shard
    that owns the node, against the reference's ``solve_batch``."""
    state, pods, params, _, gang = _setup("gang", 3, 384, 120)
    rng = np.random.default_rng(3)
    edges = np.array([0, 127, 128, 255, 256, 383], np.int32)
    free = np.zeros((12, NUM_RESOURCES), np.int32)
    free[:, R.CPU] = rng.integers(2000, 60000, 12)
    free[:, R.MEMORY] = rng.integers(512, 8192, 12)
    table = dict(node=np.tile(edges, 2), free=free,
                 allocate_once=rng.uniform(size=12) < 0.5,
                 match=rng.uniform(size=(120, 12)) < 0.6)
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(), None,
                           gang, resv=jresv(table))
    s, p, pr, _, g = port(state, pods, params, None, gang)
    got = mesh.shard_kernel_solver(3, device="cpu")(s, p, pr, None, g,
                                                     resv=tresv(table))
    assert_same_resv(got, want)
    vstar = np.asarray(want.resv_vstar)
    assert len(set(table["node"][vstar[vstar >= 0]])) >= 4


def _numa_quota_gang_problem():
    """The reference's 8-device full-features test problem: 1,024 nodes x
    96 pods, 8 quota groups, 8 Strict gangs of 8, NUMA inventories."""
    n_nodes, n_pods, n_quota, n_gangs = 1024, 96, 8, 8
    state, pods, params = jax_example_problem(n_nodes, n_pods, seed=11)
    rng = np.random.default_rng(11)
    cap = np.asarray(state.alloc)
    free = (cap * rng.uniform(0.3, 1.0, cap.shape)).astype(np.int32)
    state = state._replace(numa_cap=jnp.asarray(cap),
                           numa_free=jnp.asarray(free))
    gang_id = np.full(n_pods, -1, np.int32)
    gang_id[: n_gangs * 8] = np.repeat(np.arange(n_gangs, dtype=np.int32), 8)
    pods = pods._replace(
        quota_id=jnp.asarray(rng.integers(0, n_quota, n_pods).astype(np.int32)),
        gang_id=jnp.asarray(gang_id),
        has_numa_policy=jnp.asarray(rng.uniform(size=n_pods) < 0.4),
        non_preemptible=jnp.asarray(rng.uniform(size=n_pods) < 0.3),
    )
    total = cap.astype(np.int64).sum(axis=0)
    mn = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    mx = np.zeros_like(mn)
    mn[:, R.CPU] = total[R.CPU] // (2 * n_quota)
    mn[:, R.MEMORY] = total[R.MEMORY] // (2 * n_quota)
    mx[:, R.CPU] = total[R.CPU] // 6
    mx[:, R.MEMORY] = total[R.MEMORY] // 6
    qid = np.asarray(pods.quota_id)
    child = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    np.add.at(child, qid, np.asarray(pods.req).astype(np.int64))
    quota = JQuotaState.build(min=mn, max=mx, weight=mx,
                              allow_lent=np.ones(n_quota, bool), total=total,
                              child_request=child)
    gang = JGangState.build(min_member=[8] * n_gangs)
    node_policy = rng.uniform(size=n_nodes) < 0.5
    return state, pods, params, quota, gang, node_policy


def _resv_gang_problem():
    """The reference's 4-device reservation test problem: 256 nodes x 64
    pods, 9 reservations, 4 Strict gangs of 8."""
    state, pods, params = jax_example_problem(256, 64, seed=13)
    gang_id = np.full(64, -1, np.int32)
    gang_id[:32] = np.repeat(np.arange(4, dtype=np.int32), 8)
    pods = pods._replace(gang_id=jnp.asarray(gang_id))
    gang = JGangState.build(min_member=[8] * 4)
    return state, pods, params, gang, example_resv(9, 256, 64, seed=13)


@pytest.mark.parametrize("case", ["256x96-k2", "327x64-k8",
                                  "1024x96-quota-gang-numa-k8",
                                  "256x64-resv-gang-k4"])
def test_shard_kernel_solver_matches_reference(case):
    """The shapes of ``tests/test_shard_kernel.py``, held against the
    reference's single-device ``solve_batch`` on every output."""
    quota = gang = jaux = taux = resv = None
    if case == "256x96-k2":
        shards = 2
        state, pods, params = jax_example_problem(256, 96, seed=3)
    elif case == "327x64-k8":
        shards = 8
        state, pods, params = jax_example_problem(327, 64, seed=7)
    elif case == "1024x96-quota-gang-numa-k8":
        shards = 8
        state, pods, params, quota, gang, policy = _numa_quota_gang_problem()
        jaux = jbp.NumaAux(node_policy=jnp.asarray(policy))
        taux = convert.numa_aux(dict(node_policy=policy), "cpu")
    else:
        shards = 4
        state, pods, params, gang, resv = _resv_gang_problem()
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(), quota,
                           gang, resv=resv, numa=jaux)
    got = mesh.shard_kernel_solver(shards, device="cpu")(
        *port(state, pods, params, quota, gang), taux,
        None if resv is None else tresv(as_dict(resv)))
    assert_same_result(got, want)
    for f in ("resv_free", "resv_vstar", "resv_delta", "numa_consumed"):
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    assert int(np.asarray(want.commit).sum()) > 0
    if jaux is not None:
        assert int(np.asarray(want.numa_consumed).sum()) > 0
    if resv is not None:
        assert int((np.asarray(want.resv_vstar) >= 0).sum()) > 0


def test_matches_reference_sharded_kernel_interpret():
    """Against the reference's own ``shard_kernel_solver`` over two
    devices of the CPU mesh (its kernel in interpret mode, remote DMAs
    emulated), at 256 nodes x 32 pods."""
    if not jmesh.distributed_kernel_supported():
        pytest.skip("this jax build cannot run the distributed kernel")
    state, pods, params = jax_example_problem(256, 32, seed=3)
    want = jmesh.shard_kernel_solver(jmesh.make_mesh(jax.devices()[:2]))(
        state, pods, params)
    got = mesh.shard_kernel_solver(2, device="cpu")(
        *port(state, pods, params)[:3])
    assert_same_result(got, want)
    assert int((got.assign >= 0).sum()) > 0


def _raising_inputs(case):
    """``(shards, config keywords, state, pods, params, resv)`` on which
    the reference's sharded solve raises ``ValueError`` (reference
    types)."""
    config, resv = {}, None
    if case == "nodes":      # 65,500 nodes pad to 65,664 over 3 shards
        return (3, config, *jax_example_problem(65500, 4, seed=1), None)
    state, pods, params = jax_example_problem(96, 12, seed=2)
    if case == "config":
        config = dict(score_according_prod=True)
    elif case == "empty-resv":
        resv = dict(node=np.zeros(0, np.int32),
                    free=np.zeros((0, NUM_RESOURCES), np.int32),
                    allocate_once=np.zeros(0, bool),
                    match=np.zeros((12, 0), bool))
    else:                    # credit past the packed key's score budget
        resv = _budget_table(state, 12)
    return 2, config, state, pods, params, resv


#: the reference's message and the port's for each gate
_MESSAGES = {
    "config": ("not supported by the pallas kernel",
               "not supported by the kernel"),
    "nodes": ("16 lane bits", "16 lane bits"),
    "empty-resv": ("reservation table unsupported",
                   "empty reservation table"),
    "score-budget": ("could overflow", "could overflow"),
}


@pytest.mark.parametrize("case", sorted(_MESSAGES))
def test_value_errors_match_reference(case):
    if not jmesh.distributed_kernel_supported():
        pytest.skip("this jax build cannot run the distributed kernel")
    shards, config, state, pods, params, resv = _raising_inputs(case)
    theirs, ours = _MESSAGES[case]
    with pytest.raises(ValueError, match=theirs):
        jmesh.shard_kernel_solver(jmesh.make_mesh(jax.devices()[:shards]),
                                  jbp.SolverConfig(**config))(
            state, pods, params,
            resv=None if resv is None else jresv(resv))
    solve = mesh.shard_kernel_solver(shards, SolverConfig(**config),
                                     device="cpu")
    with pytest.raises(ValueError, match=ours):
        solve(*port(state, pods, params)[:3],
              resv=None if resv is None else tresv(resv))


def test_shard_counts_and_cpu_support():
    for shards in (0, 1, 17):
        with pytest.raises(ValueError, match="shards"):
            mesh.shard_kernel_solver(shards, device="cpu")
        assert not mesh.cluster_kernel_supported(shards, "cpu")
        with pytest.raises(ValueError, match="shards"):
            bk.binpack_sharded(_kernel_inputs("plain", 8, 3, 0), shards)
    for shards in range(2, 17):
        assert mesh.cluster_kernel_supported(shards, "cpu")
