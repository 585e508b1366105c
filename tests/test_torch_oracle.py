"""The port's oracles (``oracle/placement.py``, the scalar sequential
scheduler, and ``oracle/vectorized.py``, the same semantics vectorized
over the nodes in numpy int64) against the JAX package's, bit for bit.

The cases of the reference's ``tests/test_oracle_vectorized.py`` and
``tests/test_oracle_full_features.py``: on seeded problems the port's
scalar oracle, its vectorized oracle, the reference's two oracles and the
port's kernel twin (``kernel_solve_batch`` on CPU tensors) agree on every
assignment, and the full-features oracle agrees with the twin on every
mutated carry (``used_req``, ``numa_free``, ``resv_free``, quota used).
The reference's oracles are held to its own scan by its tests; no JAX
solve runs here. One case shows the int64/int32 split on purpose: the
oracle sums in int64 where the kernel wraps in int32."""

import numpy as np
import pytest
import torch

from koordinator_tpu.oracle import placement as ref_placement
from koordinator_tpu.oracle import vectorized as ref_vectorized
from koordinator_tpu_torch import convert, testing
from koordinator_tpu_torch.apis.extension import NUM_RESOURCES, ResourceName
from koordinator_tpu_torch.ops.binpack import NumaAux
from koordinator_tpu_torch.ops.binpack_kernel import kernel_solve_batch
from koordinator_tpu_torch.ops.gang import GangState, gang_outcomes
from koordinator_tpu_torch.ops.quota import QuotaState
from koordinator_tpu_torch.oracle import placement, vectorized

CPU, MEM = ResourceName.CPU, ResourceName.MEMORY


def _rich_problem(n_nodes, n_pods, seed, prod_thresholds=False):
    """The reference's numpy problem with every branch: stale metrics,
    cordoned nodes, prod pods, DaemonSets, near-full nodes."""
    rng = np.random.default_rng(seed)
    r = 4
    alloc = np.zeros((n_nodes, r), np.int64)
    alloc[:, 0] = rng.choice([16000, 32000, 64000], n_nodes)
    alloc[:, 1] = rng.choice([32768, 65536], n_nodes)
    usage = (alloc * rng.uniform(0, 0.9, alloc.shape)).astype(np.int64)
    used_req = (alloc * rng.uniform(0, 0.6, alloc.shape)).astype(np.int64)
    prod_usage = (usage * rng.uniform(0, 1.0, usage.shape)).astype(np.int64)
    est_extra = (alloc * rng.uniform(0, 0.1, alloc.shape)).astype(np.int64)
    prod_base = prod_usage.copy()
    metric_fresh = rng.uniform(size=n_nodes) < 0.9
    schedulable = rng.uniform(size=n_nodes) < 0.95
    req = np.zeros((n_pods, r), np.int64)
    req[:, 0] = rng.choice([500, 1000, 2000, 4000], n_pods)
    req[:, 1] = rng.choice([1024, 2048, 8192], n_pods)
    est = (req * 85) // 100
    is_prod = rng.uniform(size=n_pods) < 0.5
    is_ds = rng.uniform(size=n_pods) < 0.05
    weights = np.array([1, 1, 0, 0], np.int64)
    thresholds = np.array([65, 95, 0, 0], np.int64)
    prod_thr = (np.array([55, 80, 0, 0], np.int64) if prod_thresholds
                else np.zeros(r, np.int64))
    return (alloc, used_req, usage, prod_usage, est_extra, prod_base,
            metric_fresh, schedulable, req, est, is_prod, is_ds,
            weights, thresholds, prod_thr)


def _all_equal(*runs):
    first = np.asarray(runs[0])
    for other in runs[1:]:
        np.testing.assert_array_equal(np.asarray(other), first)
    return first


@pytest.mark.parametrize("seed, prod_thr, score_prod", [
    (0, False, False), (1, False, False), (2, False, False),
    (3, False, False), (0, True, False), (1, True, False), (2, True, False),
    (3, True, False), (5, True, True), (6, True, True),
])
def test_vectorized_matches_scalar_and_reference(seed, prod_thr, score_prod):
    """Scalar == vectorized in the port, each equal to the reference's,
    with and without prod thresholds and prod scoring."""
    shape = (30, 80) if score_prod else (40, 120)
    args = _rich_problem(*shape, seed, prod_thresholds=prod_thr)
    kw = dict(score_according_prod=score_prod)
    got = _all_equal(
        placement.schedule_sequential(*args, **kw),
        vectorized.schedule_vectorized(*args, **kw),
        ref_placement.schedule_sequential(*args, **kw),
        ref_vectorized.schedule_vectorized(*args, **kw))
    assert (got >= 0).any()


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_quota_oracles_match_each_other_and_reference(seed):
    """The quota gate: both packages' scalar and vectorized oracles give
    the same assignments and the same used and non-preemptible used."""
    n_nodes, n_pods, n_q = 30, 150, 6
    args = _rich_problem(n_nodes, n_pods, seed)
    rng = np.random.default_rng(seed + 100)
    quota_id = rng.integers(-1, n_q, n_pods)
    non_pre = rng.uniform(size=n_pods) < 0.3
    total = args[0].sum(axis=0)
    mn = np.zeros((n_q, 4), np.int64)
    mx = np.zeros((n_q, 4), np.int64)
    mn[:, :2] = total[:2] // (3 * n_q)
    mx[:, :2] = total[:2] // 4
    qargs = (mn, mx, mn, mx, np.ones(n_q, bool), total)
    outs, quotas = [], []
    for mod in (placement, ref_placement):
        q = mod.SequentialQuota(*qargs)
        outs.append(mod.schedule_sequential_quota(
            *args[:12], quota_id, non_pre, q, args[12], args[13], args[14]))
        quotas.append(q)
    for mod in (vectorized, ref_vectorized):
        q = mod.VectorQuota(*qargs)
        outs.append(mod.schedule_vectorized(
            *args, pod_quota_id=quota_id, pod_non_preemptible=non_pre,
            quota=q))
        quotas.append(q)
    got = _all_equal(*outs)
    assert (got >= 0).any()
    _all_equal(*[q.used for q in quotas])
    _all_equal(*[q.np_used for q in quotas])
    _all_equal(*[q.runtime() for q in quotas])


def test_zero_nodes_returns_all_unplaced():
    """An empty cluster: every pod -1, quota requests still registered,
    as in the reference."""
    args = _rich_problem(0, 10, seed=99)
    for mod in (vectorized, ref_vectorized):
        np.testing.assert_array_equal(mod.schedule_vectorized(*args),
                                      np.full(10, -1))
        vq = mod.VectorQuota(
            np.zeros((2, 4), np.int64), np.full((2, 4), 100, np.int64),
            np.zeros((2, 4), np.int64), np.ones((2, 4), np.int64),
            np.ones(2, bool), np.full(4, 1000, np.int64))
        out = mod.schedule_vectorized(
            *args, pod_quota_id=np.zeros(10, np.int64),
            pod_non_preemptible=np.zeros(10, bool), quota=vq)
        np.testing.assert_array_equal(out, np.full(10, -1))
        assert vq.child_request[0].sum() > 0


def test_vectorized_matches_kernel_twin_and_reference():
    """On the example problem (the probe's problem family): the port's
    oracle through ``oracle_args`` == its kernel twin == the reference's
    oracle == the port's scalar oracle."""
    state, pods, params = testing.example_problem(80, 250, seed=11,
                                                  device="cpu")
    args = vectorized.oracle_args(state, pods, params)
    assert all(isinstance(a, np.ndarray) for a in args)
    twin = kernel_solve_batch(state, pods, params)
    got = _all_equal(
        vectorized.schedule_vectorized(*args),
        twin.assign.numpy(),
        ref_vectorized.schedule_vectorized(*args),
        placement.schedule_sequential(*args))
    assert (got >= 0).sum() > 100


def test_int64_oracle_and_int32_kernel_split_past_int32():
    """On purpose: past the int32 range the oracle's int64 sums and the
    kernel's int32 sums part (inside it they agree: every other case
    here). Node 0's usage plus its assigned pods' estimate passes the
    int32 maximum: the oracle sees a base above the allocatable and
    gives LoadAware 0, so node 1 wins; the kernel's sum wraps negative
    and scores node 0 high."""
    state, pods, params = testing.example_problem(2, 1, seed=2, device="cpu")
    usage, est_extra = state.usage.clone(), state.est_extra.clone()
    usage[0, CPU] = torch.iinfo(torch.int32).max - 1000
    est_extra[0, CPU] = 3000
    alloc = state.alloc.clone()
    alloc[:, CPU] = 64000
    state = state._replace(usage=usage, est_extra=est_extra, alloc=alloc,
                           used_req=torch.zeros_like(alloc))
    params = params._replace(thresholds=torch.zeros_like(params.thresholds))
    args = vectorized.oracle_args(state, pods, params)
    oracle = _all_equal(vectorized.schedule_vectorized(*args),
                        ref_vectorized.schedule_vectorized(*args))
    assert oracle.tolist() == [1]
    assert kernel_solve_batch(state, pods, params).assign.tolist() == [0]


@pytest.mark.parametrize("seed", [13, 14])
def test_gang_outcomes_np_matches_port_and_reference(seed):
    rng = np.random.default_rng(seed)
    g, p = 12, 200
    gang_id = rng.integers(-1, g, p).astype(np.int32)
    assign = np.where(rng.uniform(size=p) < 0.7, rng.integers(0, 50, p),
                      -1).astype(np.int32)
    min_member = rng.integers(1, 20, g)
    bound = rng.integers(0, 3, g)
    strict = rng.uniform(size=g) < 0.5
    group = rng.integers(0, 5, g)
    gs = GangState.build(min_member=min_member, bound_count=bound,
                         strict=strict, group_id=group, device="cpu")
    want = gang_outcomes(torch.from_numpy(assign), torch.from_numpy(gang_id),
                         gs)
    for mod in (vectorized, ref_vectorized):
        got = mod.gang_outcomes_np(assign, gang_id, min_member, bound,
                                   strict, gs.group_id.numpy())
        for g_, w in zip(got, want):
            np.testing.assert_array_equal(g_, w.numpy())


# -- the full-features oracle against the kernel twin -------------------------

def _with_numa(state, pods, rng):
    cap = state.alloc.numpy()
    free = (cap * rng.uniform(0.2, 1.0, cap.shape)).astype(np.int32)
    state = state._replace(numa_cap=torch.from_numpy(cap.copy()),
                           numa_free=torch.from_numpy(free))
    n_pods = pods.req.shape[0]
    pods = pods._replace(has_numa_policy=torch.from_numpy(
        rng.uniform(size=n_pods) < 0.4))
    aux = NumaAux(node_policy=torch.from_numpy(
        rng.uniform(size=cap.shape[0]) < 0.5))
    return state, pods, aux


def _resv_arrays(n_nodes, n_pods, n_resv, rng):
    node = rng.integers(0, n_nodes, n_resv).astype(np.int32)
    free = np.zeros((n_resv, NUM_RESOURCES), np.int32)
    free[:, CPU] = rng.integers(0, 3000, n_resv)
    free[:, MEM] = rng.integers(0, 3000, n_resv)
    allocate_once = rng.uniform(size=n_resv) < 0.5
    match = np.zeros((n_pods, n_resv), bool)
    for v in range(n_resv):
        lo = int(rng.integers(0, max(n_pods - 8, 1)))
        match[lo:lo + int(rng.integers(2, 10)), v] = True
    return convert.resv_arrays(dict(node=node, free=free,
                                    allocate_once=allocate_once,
                                    match=match), "cpu")


def _quota(state, pods, n_quota, rng):
    cap = state.alloc.numpy()
    n_pods = pods.req.shape[0]
    qid = rng.integers(-1, n_quota, n_pods).astype(np.int32)
    pods = pods._replace(
        quota_id=torch.from_numpy(qid),
        non_preemptible=torch.from_numpy(rng.uniform(size=n_pods) < 0.3))
    total = cap.astype(np.int64).sum(axis=0)
    mn = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    mx = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    for r in (CPU, MEM):
        mn[:, r] = total[r] // (2 * n_quota)
        mx[:, r] = total[r] // 3
    req = pods.req.numpy().astype(np.int64)
    child_request = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    sel = qid >= 0
    np.add.at(child_request, qid[sel], req[sel])
    qstate = QuotaState.build(min=mn, max=mx, weight=mx,
                              allow_lent=np.ones(n_quota, bool), total=total,
                              child_request=child_request, device="cpu")

    def vq(mod):
        return mod.VectorQuota(min_=mn, max_=mx,
                               auto_min=qstate.auto_min.numpy(), weight=mx,
                               allow_lent=np.ones(n_quota, bool), total=total)

    return pods, qstate, vq, qid


def _gang(pods, n_gangs, members, rng, min_member=None, strict=None):
    n_pods = pods.req.shape[0]
    gang_id = np.full(n_pods, -1, np.int32)
    count = min(n_gangs * members, n_pods)
    gang_id[:count] = np.repeat(np.arange(n_gangs, dtype=np.int32),
                                members)[:count]
    drawn = rng.uniform(size=n_gangs) < 0.7
    gstate = GangState.build(
        min_member=min_member if min_member is not None
        else [members] * n_gangs,
        strict=strict if strict is not None else drawn, device="cpu")
    return pods._replace(gang_id=torch.from_numpy(gang_id)), gstate, gang_id


def _oracles(state, pods, params, **kw):
    """Both packages' ``solve_full_vectorized`` (the reference's reads the
    port's CPU tensors through ``np.asarray``); equal on every key."""
    quota = kw.pop("quota", None)
    outs = []
    for mod in (vectorized, ref_vectorized):
        extra = {} if quota is None else {"quota": quota(mod)}
        outs.append((mod.solve_full_vectorized(state, pods, params, **kw,
                                               **extra), extra))
    (got, gq), (want, wq) = outs
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    if quota is not None:
        np.testing.assert_array_equal(gq["quota"].used, wq["quota"].used)
        got["quota_used"] = gq["quota"].used
    return got


def _check(result, oracle):
    """The kernel twin's SolveResult == the oracle on every carry."""
    np.testing.assert_array_equal(result.assign.numpy(), oracle["assign"])
    np.testing.assert_array_equal(result.node_state.used_req.numpy(),
                                  oracle["used_req"])
    if "numa_free" in oracle:
        np.testing.assert_array_equal(result.node_state.numa_free.numpy(),
                                      oracle["numa_free"])
        np.testing.assert_array_equal(result.numa_consumed.numpy(),
                                      oracle["numa_consumed"])
    if "resv_free" in oracle:
        np.testing.assert_array_equal(result.resv_free.numpy(),
                                      oracle["resv_free"])
        np.testing.assert_array_equal(result.resv_vstar.numpy(),
                                      oracle["resv_vstar"])
    if "quota_used" in oracle:
        np.testing.assert_array_equal(result.quota_state.used.numpy(),
                                      oracle["quota_used"])


@pytest.mark.parametrize("seed", range(6))
def test_numa_oracle_identity(seed):
    state, pods, params = testing.example_problem(96, 256, seed=seed,
                                                  device="cpu")
    state, pods, aux = _with_numa(state, pods, np.random.default_rng(seed))
    result = kernel_solve_batch(state, pods, params, numa_aux=aux)
    oracle = _oracles(state, pods, params, numa_aux=aux)
    _check(result, oracle)
    assert int(result.numa_consumed.sum()) > 0


@pytest.mark.parametrize("seed", range(6))
def test_reservation_oracle_identity(seed):
    state, pods, params = testing.example_problem(64, 200, seed=seed,
                                                  device="cpu")
    resv = _resv_arrays(64, 200, 24, np.random.default_rng(100 + seed))
    result = kernel_solve_batch(state, pods, params, resv=resv)
    oracle = _oracles(state, pods, params, resv=resv)
    _check(result, oracle)
    assert int((result.resv_vstar >= 0).sum()) > 0


def _fused(n_nodes, n_pods, n_quota, n_resv, rng, seed, gangs):
    state, pods, params = testing.example_problem(n_nodes, n_pods, seed=seed,
                                                  device="cpu")
    state, pods, aux = _with_numa(state, pods, rng)
    resv = _resv_arrays(n_nodes, n_pods, n_resv, rng)
    pods, qstate, vq, qid = _quota(state, pods, n_quota, rng)
    pods, gstate, gang_id = gangs(pods, rng)
    result = kernel_solve_batch(state, pods, params, qstate, gstate,
                                numa_aux=aux, resv=resv)
    oracle = _oracles(
        state, pods, params, quota=vq, pod_quota_id=qid,
        pod_non_preemptible=pods.non_preemptible.numpy(), gang_id=gang_id,
        gang_min_member=gstate.min_member.numpy(),
        gang_bound_count=gstate.bound_count.numpy(),
        gang_strict=gstate.strict.numpy(),
        gang_group_id=gstate.group_id.numpy(), numa_aux=aux, resv=resv)
    _check(result, oracle)
    assert int((result.resv_vstar >= 0).sum()) > 0
    return result


@pytest.mark.parametrize("seed", range(4))
def test_all_features_oracle_identity(seed):
    """Quota, gangs, NUMA and reservations in one solve: the whole
    epilogue (the Strict gangs' release of node, NUMA, reservation and
    quota holds) checked bit for bit."""
    _fused(80, 320, 8, 16, np.random.default_rng(200 + seed), seed,
           lambda pods, rng: _gang(pods, 12, 8, rng))


def test_all_features_epilogue_forced_rejection():
    """One Strict gang that can never reach its minimum: every placed
    member rolls back through the epilogue, oracle bit-identical."""
    result = _fused(
        24, 160, 4, 10, np.random.default_rng(99), 99,
        lambda pods, rng: _gang(pods, 1, 160, rng, min_member=[161],
                                strict=[True]))
    assert int(result.rejected.sum()) > 0
    assert int(result.numa_consumed.sum()) > 0
