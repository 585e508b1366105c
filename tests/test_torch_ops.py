"""The port's scoring, quota and gang primitives against the JAX package,
bit for bit, on the same numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import common as jcommon
from koordinator_tpu.ops import fit as jfit
from koordinator_tpu.ops import gang as jgang
from koordinator_tpu.ops import loadaware as jla
from koordinator_tpu.ops import quota as jquota
from koordinator_tpu_torch.ops import common, fit, gang, loadaware, quota

R = 8


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _nodes(seed, n=64):
    """[N,R] node arrays with the edges: zero allocatable rows and
    columns, requests beyond allocatable, stale metrics."""
    rng = np.random.default_rng(seed)
    alloc = rng.integers(0, 70000, (n, R)).astype(np.int32)
    alloc[rng.uniform(size=(n, R)) < 0.2] = 0
    alloc[:3] = 0
    used = (alloc * rng.uniform(0, 1.2, (n, R))).astype(np.int32)
    usage = (alloc * rng.uniform(0, 1.1, (n, R))).astype(np.int32)
    est_extra = rng.integers(-500, 3000, (n, R)).astype(np.int32)
    prod_base = (usage // 2).astype(np.int32)
    fresh = rng.uniform(size=n) < 0.7
    req = rng.integers(0, 9000, R).astype(np.int32)
    req[rng.uniform(size=R) < 0.3] = 0
    weights = rng.integers(0, 3, R).astype(np.int32)
    thresholds = rng.choice([0, 50, 65, 95], R).astype(np.int32)
    prod_thresholds = rng.choice([0, 40, 80], R).astype(np.int32)
    return dict(alloc=alloc, used=used, usage=usage, est_extra=est_extra,
                prod_base=prod_base, fresh=fresh, req=req, weights=weights,
                thresholds=thresholds, prod_thresholds=prod_thresholds)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scoring_primitives_match(seed):
    d = _nodes(seed)
    alloc, used = d["alloc"], d["used"]
    requested = used + d["req"]
    same(common.percent_rounded(T(used), T(alloc)),
         jcommon.percent_rounded(J(used), J(alloc)))
    same(common.least_requested_score(T(requested), T(alloc)),
         jcommon.least_requested_score(J(requested), J(alloc)))
    # the reference's hot-path form divides through a float reciprocal
    same(common.least_requested_score(T(requested), T(alloc)),
         jcommon.least_requested_score(
             J(requested), J(alloc), jcommon.reciprocal_for(J(alloc))))
    scores = common.least_requested_score(T(requested), T(alloc))
    same(common.weighted_mean_scores(scores, T(d["weights"])),
         jcommon.weighted_mean_scores(J(scores.numpy()), J(d["weights"])))
    same(fit.fit_filter(T(d["req"]), T(alloc), T(used)),
         jfit.fit_filter(J(d["req"]), J(alloc), J(used)))
    same(fit.least_allocated_score(T(d["req"]), T(alloc), T(used),
                                   T(d["weights"])),
         jfit.least_allocated_score(J(d["req"]), J(alloc), J(used),
                                    J(d["weights"])))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("is_ds", [False, True])
@pytest.mark.parametrize("is_prod", [False, True])
def test_loadaware_matches(seed, is_ds, is_prod):
    d = _nodes(seed + 10)
    args = [d["alloc"], d["usage"], d["prod_base"], d["fresh"],
            d["thresholds"], d["prod_thresholds"]]
    same(loadaware.loadaware_filter(*map(T, args), torch.tensor(is_ds),
                                    torch.tensor(is_prod)),
         jla.loadaware_filter(*map(J, args), jnp.asarray(is_ds),
                              jnp.asarray(is_prod)))
    est = (d["req"] * 85) // 100
    for by_prod in (False, True):
        sargs = [est, d["alloc"], d["usage"], d["est_extra"], d["prod_base"],
                 d["fresh"], d["weights"]]
        same(loadaware.loadaware_score(*map(T, sargs), torch.tensor(is_prod),
                                       by_prod),
             jla.loadaware_score(*map(J, sargs), jnp.asarray(is_prod),
                                 by_prod))


def _quota(seed, q=9, with_runtime=False):
    rng = np.random.default_rng(seed)
    mn = rng.integers(0, 20000, (q, R))
    mx = mn + rng.integers(0, 60000, (q, R))
    mx[0, 3] = 1 << 40  # saturated
    weight = rng.integers(0, 5000, (q, R))
    weight[:, 2] = rng.integers(20000, 40000, q)  # normalized dimension
    kw = dict(
        min=mn, max=mx, weight=weight,
        allow_lent=rng.uniform(size=q) < 0.6,
        total=rng.integers(50000, 400000, R),
        guarantee=rng.integers(0, 15000, (q, R)),
        child_request=rng.integers(0, 90000, (q, R)),
        used=rng.integers(0, 30000, (q, R)),
        np_used=rng.integers(0, 10000, (q, R)),
    )
    if with_runtime:
        kw["runtime"] = rng.integers(0, 80000, (q, R))
    return kw


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("with_runtime", [False, True])
def test_quota_runtime_and_gate_match(seed, with_runtime):
    kw = _quota(seed, with_runtime=with_runtime)
    js = jquota.QuotaState.build(**kw)
    ts = quota.QuotaState.build(**kw, device="cpu")
    for f in js._fields:
        if getattr(js, f) is not None:
            same(getattr(ts, f), getattr(js, f))
    rt_t, rt_j = quota.quota_runtime(ts), jquota.quota_runtime(js)
    same(rt_t, rt_j)
    same(quota.water_filling_device(ts.total, quota.limited_request(ts),
                                    ts.auto_min, ts.weight, ts.allow_lent),
         jquota.water_filling_device(js.total, jquota.limited_request(js),
                                     js.auto_min, js.weight, js.allow_lent))
    rng = np.random.default_rng(seed + 100)
    for _ in range(12):
        qid = int(rng.integers(-1, 9))
        req = rng.integers(0, 30000, R).astype(np.int32)
        req[rng.uniform(size=R) < 0.4] = 0
        non_pre = bool(rng.uniform() < 0.5)
        args_t = (torch.tensor(qid, dtype=torch.int32), T(req),
                  torch.tensor(non_pre))
        args_j = (jnp.int32(qid), J(req), jnp.asarray(non_pre))
        same(quota.quota_admit(ts, rt_t, *args_t),
             jquota.quota_admit(js, rt_j, *args_j))
        placed = bool(rng.uniform() < 0.7)
        ts = quota.quota_assume(ts, *args_t, torch.tensor(placed))
        js = jquota.quota_assume(js, *args_j, jnp.asarray(placed))
        same(ts.used, js.used)
        same(ts.np_used, js.np_used)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gang_outcomes_and_release_match(seed):
    rng = np.random.default_rng(seed)
    n, p, g = 20, 120, 11
    assign = rng.integers(-1, n, p).astype(np.int32)
    gang_id = rng.integers(-1, g, p).astype(np.int32)
    build = dict(
        min_member=rng.integers(5, 16, g),
        bound_count=rng.integers(0, 3, g),
        strict=rng.uniform(size=g) < 0.5,
        group_id=[f"grp{rng.integers(0, 5)}" for _ in range(g)],
    )
    tg = gang.GangState.build(**build, device="cpu")
    jg = jgang.GangState.build(**build)
    for f in jg._fields:
        same(getattr(tg, f), getattr(jg, f))
    out_t = gang.gang_outcomes(T(assign), T(gang_id), tg)
    out_j = jgang.gang_outcomes(J(assign), J(gang_id), jg)
    for a, b in zip(out_t, out_j):
        same(a, b)
    rejected = out_t[2].numpy()
    assert rejected.any()
    used, est, prod = (rng.integers(0, 50000, (n, R)).astype(np.int32)
                       for _ in range(3))
    req, pest = (rng.integers(0, 4000, (p, R)).astype(np.int32)
                 for _ in range(2))
    is_prod = rng.uniform(size=p) < 0.5
    args = [used, est, prod, assign, rejected, req, pest, is_prod]
    for a, b in zip(gang.release_rejected(*map(T, args)),
                    jgang.release_rejected(*map(J, args))):
        same(a, b)
