"""The port's placement solvers against the JAX package, bit for bit:
``ops/binpack.solve_batch`` against the reference's ``solve_batch``, and
the kernel wrapper's CPU path (layout, ``la_ok``, flags, the blocked
encoding, ``binpack_plain`` and the gang epilogue) against the
reference's ``pallas_solve_batch`` in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.apis.extension import NUM_RESOURCES, ResourceName as R
from koordinator_tpu.ops import binpack as jbp
from koordinator_tpu.ops.gang import GangState as JGangState
from koordinator_tpu.ops.pallas_binpack import pallas_solve_batch
from koordinator_tpu.ops.quota import QuotaState as JQuotaState
from koordinator_tpu.testing import example_problem as jax_example_problem
from koordinator_tpu_torch import convert, testing
from koordinator_tpu_torch.ops import binpack_kernel
from koordinator_tpu_torch.ops.binpack import Extras, SolverConfig, solve_batch


def as_dict(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def port(state, pods, params, quota=None, gang=None):
    """The reference's solver state carried across to the port (CPU)."""
    cpu = "cpu"
    return (convert.node_state(as_dict(state), cpu),
            convert.pod_batch(as_dict(pods), cpu),
            convert.score_params(as_dict(params), cpu),
            None if quota is None else convert.quota_state(as_dict(quota), cpu),
            None if gang is None else convert.gang_state(as_dict(gang), cpu))


def _problem(n_nodes=96, n_pods=150, seed=0):
    """Stale metrics, unschedulable nodes, DaemonSet, blocked and
    never-fitting pods (the reference's kernel-test problem)."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n_nodes, NUM_RESOURCES), np.int32)
    alloc[:, R.CPU] = rng.choice([4000, 16000, 64000], n_nodes)
    alloc[:, R.MEMORY] = rng.choice([8192, 32768], n_nodes)
    usage = (alloc * rng.uniform(0, 0.9, alloc.shape)).astype(np.int32)
    state = jbp.NodeState(
        alloc=jnp.asarray(alloc),
        used_req=jnp.asarray(
            (alloc * rng.uniform(0, 0.3, alloc.shape)).astype(np.int32)),
        usage=jnp.asarray(usage),
        prod_usage=jnp.asarray(usage // 2),
        est_extra=jnp.asarray(usage // 4),
        prod_base=jnp.asarray(usage // 3),
        metric_fresh=jnp.asarray(rng.uniform(size=n_nodes) > 0.2),
        schedulable=jnp.asarray(rng.uniform(size=n_nodes) > 0.1),
    )
    req = np.zeros((n_pods, NUM_RESOURCES), np.int32)
    req[:, R.CPU] = rng.choice([500, 1000, 4000, 100000], n_pods)
    req[:, R.MEMORY] = rng.choice([0, 1024, 4096], n_pods)
    pods = jbp.PodBatch.build(
        req=jnp.asarray(req),
        est=jnp.asarray((req * 85) // 100),
        is_prod=jnp.asarray(rng.uniform(size=n_pods) < 0.5),
        is_daemonset=jnp.asarray(rng.uniform(size=n_pods) < 0.2),
        blocked=jnp.asarray(rng.uniform(size=n_pods) < 0.1),
    )
    weights = np.zeros(NUM_RESOURCES, np.int32)
    weights[[R.CPU, R.MEMORY]] = 1
    thresholds = np.zeros(NUM_RESOURCES, np.int32)
    thresholds[R.CPU], thresholds[R.MEMORY] = 65, 95
    params = jbp.ScoreParams(
        weights=jnp.asarray(weights), thresholds=jnp.asarray(thresholds),
        prod_thresholds=jnp.zeros(NUM_RESOURCES, jnp.int32),
    )
    return state, pods, params


def _with_quota(state, pods, n_quota=7, seed=5):
    """Tight quotas: some groups exhaust their runtime mid-batch."""
    rng = np.random.default_rng(seed)
    n_pods = pods.req.shape[0]
    quota_id = rng.integers(-1, n_quota, n_pods).astype(np.int32)
    pods = pods._replace(
        quota_id=jnp.asarray(quota_id),
        non_preemptible=jnp.asarray(rng.uniform(size=n_pods) < 0.3),
    )
    total = np.asarray(state.alloc).astype(np.int64).sum(axis=0)
    mn = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    mx = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    for r in (R.CPU, R.MEMORY):
        mn[:, r] = total[r] // (4 * n_quota)
        mx[:, r] = total[r] // (n_quota + 2)
    req = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    pr = np.asarray(pods.req).astype(np.int64)
    for q in range(n_quota):
        req[q] = pr[quota_id == q].sum(axis=0)
    qstate = JQuotaState.build(
        min=mn, max=mx, weight=mx, allow_lent=np.ones(n_quota, bool),
        total=total, child_request=req,
    )
    return pods, qstate


def _with_gangs(pods, n_gangs=9, seed=6):
    rng = np.random.default_rng(seed)
    n_pods = pods.req.shape[0]
    gang_id = rng.integers(-1, n_gangs, n_pods).astype(np.int32)
    pods = pods._replace(gang_id=jnp.asarray(gang_id))
    sizes = [max(1, int((gang_id == g).sum())) for g in range(n_gangs)]
    gstate = JGangState.build(
        min_member=[max(1, s - rng.integers(0, 2)) for s in sizes],
        bound_count=rng.integers(0, 2, n_gangs),
        strict=rng.uniform(size=n_gangs) < 0.6,
        group_id=[f"grp{g // 2}" for g in range(n_gangs)],
    )
    return pods, gstate


def _setup(kind, seed, n_nodes=96, n_pods=150):
    state, pods, params = _problem(n_nodes, n_pods, seed)
    quota = gang = None
    if "quota" in kind:
        pods, quota = _with_quota(state, pods, seed=seed + 5)
    if "gang" in kind:
        pods, gang = _with_gangs(pods, seed=seed + 6)
    return state, pods, params, quota, gang


def assert_same_result(got, want):
    for f in ("assign", "raw_assign", "commit", "waiting", "rejected"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in got.node_state._fields:
        np.testing.assert_array_equal(
            getattr(got.node_state, f).numpy(),
            np.asarray(getattr(want.node_state, f)), err_msg=f)
    assert (got.quota_state is None) == (want.quota_state is None)
    if want.quota_state is not None:
        for f in ("used", "np_used"):
            np.testing.assert_array_equal(
                getattr(got.quota_state, f).numpy(),
                np.asarray(getattr(want.quota_state, f)), err_msg=f)


@pytest.mark.parametrize("kind", ["plain", "quota", "gang", "quota+gang"])
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_batch_matches_reference(kind, seed):
    state, pods, params, quota, gang = _setup(kind, seed)
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(),
                           quota_state=quota, gang_state=gang)
    got = solve_batch(*port(state, pods, params)[:3], SolverConfig(),
                      *port(state, pods, params, quota, gang)[3:])
    assert_same_result(got, want)
    assert int(np.asarray(want.commit).sum()) > 0
    if gang is not None:
        assert np.asarray(want.rejected).any() or np.asarray(want.waiting).any()


@pytest.mark.parametrize("config", [
    SolverConfig(fit_weight=2, loadaware_weight=3),
    SolverConfig(score_according_prod=True),
])
def test_solve_batch_non_kernel_configs_match(config):
    state, pods, params, quota, gang = _setup("quota+gang", 3)
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(*config),
                           quota_state=quota, gang_state=gang)
    got = solve_batch(*port(state, pods, params)[:3], config,
                      *port(state, pods, params, quota, gang)[3:])
    assert_same_result(got, want)


def test_solve_batch_extras_match():
    state, pods, params = jax_example_problem(48, 90, seed=4)
    rng = np.random.default_rng(4)
    mask = rng.uniform(size=(90, 48)) < 0.6
    score = rng.integers(-20, 40, (90, 48)).astype(np.int32)
    want = jbp.solve_batch(state, pods, params, jbp.SolverConfig(),
                           extras=jbp.Extras(jnp.asarray(mask),
                                             jnp.asarray(score)))
    got = solve_batch(*port(state, pods, params)[:3], SolverConfig(),
                      extras=Extras(torch.as_tensor(mask),
                                    torch.as_tensor(score)))
    assert_same_result(got, want)


def test_testing_builders_match_reference():
    """The port's seeded example problem draws what the reference's does,
    and its quota+gang builder solves identically in both packages."""
    want = [as_dict(x) for x in jax_example_problem(40, 70, seed=9)]
    got = testing.example_problem_arrays(40, 70, seed=9)
    for w, g in zip(want, got):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    nodes, pods, params, quota, gang = testing.quota_gang_arrays(
        60, 50, 5, 6, 8, seed=2)
    jstate = jbp.NodeState(**{k: jnp.asarray(v) for k, v in nodes.items()})
    jpods = jbp.PodBatch(**{k: jnp.asarray(v) for k, v in pods.items()})
    jparams = jbp.ScoreParams(**{k: jnp.asarray(v) for k, v in params.items()})
    want = jbp.solve_batch(jstate, jpods, jparams, jbp.SolverConfig(),
                           quota_state=JQuotaState.build(**quota),
                           gang_state=JGangState.build(**gang))
    got = binpack_kernel.kernel_solve_batch(
        *testing.quota_gang_problem(60, 50, 5, 6, 8, seed=2, device="cpu"))
    assert_same_result(got, want)


@pytest.mark.parametrize("kind,n_nodes,n_pods", [
    ("plain", 96, 150),
    ("quota+gang", 96, 150),
    ("quota+gang", 33, 41),
])
def test_kernel_cpu_path_matches_pallas_interpret(kind, n_nodes, n_pods):
    """Node and pod counts off the reference's 128-multiples."""
    state, pods, params, quota, gang = _setup(kind, 2, n_nodes, n_pods)
    want = pallas_solve_batch(state, pods, params, jbp.SolverConfig(),
                              quota_state=quota, gang_state=gang,
                              interpret=True)
    before = binpack_kernel.LAUNCHES
    got = binpack_kernel.kernel_solve_batch(
        *port(state, pods, params, quota, gang))
    assert binpack_kernel.LAUNCHES == before  # CPU tensors: the plain twin
    assert_same_result(got, want)


def test_kernel_inputs_layout():
    """The wrapper's layout: blocked pods never fit and lose their
    DaemonSet bypass, la_ok is the precomputed LoadAware verdict."""
    state, pods, params, _, _ = _setup("plain", 0)
    s, p, pr, _, _ = port(state, pods, params)
    inp = binpack_kernel.kernel_inputs(s, p, pr)
    blocked = p.blocked.numpy()
    assert (inp.req[blocked, 0] == binpack_kernel.BLOCKED_REQ).all()
    assert (inp.req[~blocked] == p.req[~blocked]).all()
    np.testing.assert_array_equal(
        inp.flags[:, 0].numpy(), (p.is_daemonset.numpy() & ~blocked))
    assert inp.wsum == 2
    from koordinator_tpu.ops.common import percent_rounded
    over = ((np.asarray(state.alloc) > 0) & (np.asarray(params.thresholds) > 0)
            & (np.asarray(percent_rounded(state.usage, state.alloc))
               >= np.asarray(params.thresholds)))
    np.testing.assert_array_equal(inp.la_ok.numpy(), (~over.any(-1)).astype(np.int32))


def test_kernel_gates():
    state, pods, params, _, _ = _setup("plain", 0)
    s, p, pr, _, _ = port(state, pods, params)
    assert binpack_kernel.kernel_supported(pr, SolverConfig())
    assert not binpack_kernel.kernel_supported(
        pr, SolverConfig(score_according_prod=True))
    assert not binpack_kernel.kernel_supported(
        pr._replace(prod_thresholds=torch.full((8,), 50, dtype=torch.int32)),
        SolverConfig())
    assert binpack_kernel.kernel_routing_ok(s, p, None)
    assert not binpack_kernel.kernel_routing_ok(s, p, object())
    assert not binpack_kernel.kernel_routing_ok(s, p._replace(req=p.req[:0]),
                                                None)
    assert binpack_kernel.weight_sum(pr) == 2
    assert binpack_kernel.weight_sum(
        pr._replace(weights=torch.zeros(8, dtype=torch.int32))) == 1
    with pytest.raises(NotImplementedError):
        solve_batch(s, p, pr, numa=object())
