"""The port's eviction control plane against the JAX package's: the
``MigrationArbiter``'s verdict streams, ``status()``, flight payload and
``replay_requests`` on the same seeded request sequences, its metrics,
the ``DefragController``'s confirm streak and cooldown, and the port's
``Scheduler`` with an arbiter against the JAX ``Scheduler``: preemption
storms under tight budgets round for round (nominations, evictions,
deferrals), a zero budget equal to no arbiter, ``defrag_headroom`` and
the controller's loop, and ``rebalance_sweep`` with the next round's
delta staging equal to a fresh staging."""

import numpy as np
import pytest
import torch

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.control import migration as jmig
from koordinator_tpu.descheduler import (
    LowNodeLoad as JLowNodeLoad,
    LowNodeLoadArgs as JArgs,
    NodePool as JNodePool,
)
from koordinator_tpu.metrics import components as jmetrics
from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu.scheduler.scheduler import Scheduler as JScheduler
from koordinator_tpu.testing.chaos import preemption_storm as jstorm
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.control import migration as tmig
from koordinator_tpu_torch.descheduler import (
    LowNodeLoad,
    LowNodeLoadArgs,
    NodePool,
)
from koordinator_tpu_torch.metrics import components as tmetrics
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.state.cluster import lower_nodes

BUDGETS = [
    dict(),
    dict(max_per_round=3),
    dict(max_per_node=2, window_s=10.0),
    dict(max_per_tenant=3, window_s=20.0),
    dict(node_cooldown_s=5.0),
    dict(dry_run=True, max_per_node=1),
    dict(max_per_round=5, max_per_node=2, max_per_tenant=4,
         node_cooldown_s=2.0, window_s=15.0),
]


def _ops(seed, n=60):
    """A seeded stream of arbiter calls: requests from every source,
    undeferrable notes and round starts, with lanes, gangs and gang
    headroom, some batches all-or-nothing."""
    rng = np.random.default_rng(seed)
    ops, now, round_key = [], 100.0, 0
    lanes = ("system", "ls", "be", None)
    for i in range(n):
        now += float(rng.integers(0, 4))
        kind = rng.random()
        if kind < 0.1:
            round_key += 1
            ops.append(("round", round_key))
            continue
        size = int(rng.integers(1, 5))
        uids = [f"u{i}-{j}" for j in range(size)]
        node = None if rng.random() < 0.1 else f"n{int(rng.integers(4))}"
        lane = [lanes[int(rng.integers(4))] for _ in uids]
        if kind < 0.2:
            ops.append(("note", "workingset", node, uids, lane, now))
            continue
        gangs = [None if rng.random() < 0.6 else f"g{int(rng.integers(2))}"
                 for _ in uids]
        headroom = {f"g{g}": int(rng.integers(0, 4)) for g in range(2)
                    if rng.random() < 0.7}
        source = ("preemption", "defrag", "rebalance")[int(rng.integers(3))]
        ops.append(("request", source, node, uids, lane, gangs, headroom,
                    now, bool(rng.random() < 0.3)))
    return ops


def _drive(mig, budget_kw, ops, swap=None):
    arbiter = mig.MigrationArbiter(mig.MigrationBudget(**budget_kw),
                                   clock=lambda: 0.0)
    out = []
    for i, op in enumerate(ops):
        if swap is not None and i == len(ops) // 2:
            arbiter.set_budget(mig.MigrationBudget(**swap))
        if op[0] == "round":
            arbiter.begin_round(op[1])
        elif op[0] == "note":
            arbiter.note(op[1], op[2], op[3], lanes=op[4], now=op[5])
        else:
            v = arbiter.request(op[1], op[2], op[3], lanes=op[4],
                                gangs=op[5], gang_headroom=op[6], now=op[7],
                                all_or_nothing=op[8])
            out.append((v.admitted, v.deferred, v.apply, v.record))
    return arbiter, out


def _counts(metrics):
    return ({s: metrics.MIGRATION_REQUESTS.value({"source": s})
             for s in jmig.SOURCES},
            {s: metrics.MIGRATION_ADMITTED.value({"source": s})
             for s in jmig.SOURCES},
            {(s, r): metrics.MIGRATION_DEFERRALS.value(
                {"source": s, "reason": r})
             for s in jmig.SOURCES for r in jmig.REASONS})


def _delta(after, before):
    return [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]


@pytest.mark.parametrize("budget", range(len(BUDGETS)))
@pytest.mark.parametrize("seed", (1, 2))
def test_arbiter_matches_reference(budget, seed):
    """Verdicts, records, ``status()``, the flight payload, the metrics
    and ``replay_requests`` equal the JAX arbiter's on the same calls."""
    ops = _ops(seed)
    kw = BUDGETS[budget]
    before = (_counts(jmetrics), _counts(tmetrics))
    want_arb, want = _drive(jmig, kw, ops)
    got_arb, got = _drive(tmig, kw, ops)
    assert got == want
    assert got_arb.status() == want_arb.status()
    assert got_arb.flight_payload() == want_arb.flight_payload()
    assert got_arb.decisions() == want_arb.decisions()
    assert (_delta(_counts(tmetrics), before[1])
            == _delta(_counts(jmetrics), before[0]))
    budget_obj = tmig.MigrationBudget(**kw)
    assert budget_obj.unlimited == jmig.MigrationBudget(**kw).unlimited
    assert (tmig.replay_requests(budget_obj, got_arb.decisions())
            == got_arb.decisions())
    if kw and not kw.get("dry_run"):
        assert got_arb.status()["deferred_total"] > 0


def test_arbiter_budget_swap_and_errors_match_reference():
    ops = _ops(5)
    swap = dict(max_per_node=1, window_s=30.0)
    want_arb, want = _drive(jmig, {}, ops, swap=swap)
    got_arb, got = _drive(tmig, {}, ops, swap=swap)
    assert got == want and got_arb.status() == want_arb.status()
    assert got_arb.budget() == tmig.MigrationBudget(**swap)
    for arbiter in (got_arb, want_arb):
        with pytest.raises(ValueError, match="unknown migration source"):
            arbiter.request("gc", "n0", ["x"])
        with pytest.raises(ValueError, match="unknown migration source"):
            arbiter.note("gc", "n0", ["x"])
        with pytest.raises(ValueError, match="align"):
            arbiter.request("defrag", "n0", ["x", "y"], lanes=["ls"])


def _observations(seed, n=40):
    rng = np.random.default_rng(seed)
    now, obs = 0.0, []
    for i in range(n):
        now += float(rng.integers(1, 12))
        frag = bool(rng.random() < 0.7)
        obs.append({"seq": i + 1, "now": now, "frag": frag,
                    "gang": "g" if frag else None,
                    "demand": [8000, 100] if frag else None,
                    "max_victim_priority": 5000 if frag else None,
                    "pending_gangs": 1, "total_free": [1, 2]})
    return obs


@pytest.mark.parametrize("policy", [dict(), dict(confirm=3, cooldown_s=10.0),
                                    dict(confirm=1, cooldown_s=0.0,
                                         dry_run=True)])
def test_defrag_policy_matches_reference(policy):
    """The pure policy step: the confirm streak, the cooldown and the
    streak reset give the same decision stream as the JAX controller."""
    out = []
    for mig in (jmig, tmig):
        ctl = mig.DefragController(None, mig.DefragPolicy(**policy),
                                   clock=lambda: 0.0)
        decisions = [ctl.step(dict(o)) for o in _observations(3)]
        status = ctl.status()
        out.append((decisions, status, ctl.decisions_total()))
    assert out[0] == out[1]
    assert any(d is not None for d in out[1][0])


def _storm_pair(backend, seed, budget, *, n_nodes=8, rpn=4, n_arrivals=14,
                gang_nodes=0, arbiter=True):
    """The JAX and the port Scheduler on the same preemption storm, each
    with its package's arbiter at ``budget`` (None: no arbiter). With
    ``gang_nodes`` the residents of the first nodes form a gang whose
    min-available leaves a headroom of a few members."""
    out = []
    for make, storm, types, mig in (
            (lambda: JScheduler(model=JPlacementModel(use_pallas=False),
                                preemption_backend=backend),
             jstorm, jtypes, jmig),
            (lambda: Scheduler(model=PlacementModel(device="cpu"),
                               preemption_backend=backend),
             testing.preemption_storm, ttypes, tmig)):
        nodes, residents, arrivals = storm(
            seed=seed, n_nodes=n_nodes, residents_per_node=rpn,
            n_arrivals=n_arrivals)
        sched = make()
        if budget is not None and arbiter:
            sched.migration_arbiter = mig.MigrationArbiter(
                mig.MigrationBudget(**budget), clock=lambda: 0.0)
        for node in nodes:
            sched.add_node(node)
        if gang_nodes:
            members = residents[:gang_nodes * rpn]
            sched.update_gang(types.GangSpec(
                name="gx", min_member=len(members) - 5))
            for pod in members:
                pod.gang = "gx"
        for pod in residents + arrivals:
            sched.add_pod(pod)
        out.append(sched)
    return out


def _rounds(ref, port, rounds, t0=100.0):
    seen = {"nominations": 0, "evicted": 0, "deferred": 0}
    for r in range(rounds):
        now = t0 + r
        before = set(port.cache.pods)
        want = ref.schedule_pending(now=now)
        got = port.schedule_pending(now=now)
        assert dict(got) == dict(want), r
        assert got.nominations == want.nominations, r
        evicted = before - set(port.cache.pods)
        assert evicted == before - set(ref.cache.pods), r
        assert set(port.cache.pending) == set(ref.cache.pending), r
        seen["nominations"] += len(got.nominations)
        seen["evicted"] += len(evicted)
        for uid, node in got.items():
            if node is not None:
                port.cache.finish_binding(uid)
                ref.cache.finish_binding(uid)
        if not port.cache.pending:
            break
    if port.migration_arbiter is not None:
        assert (port.migration_arbiter.decisions()
                == ref.migration_arbiter.decisions())
        assert (port.migration_arbiter.status()
                == ref.migration_arbiter.status())
        seen["deferred"] = port.migration_arbiter.status()["deferred_total"]
    return seen


@pytest.mark.parametrize("backend", ("device", "host", "verify"))
@pytest.mark.parametrize("budget,nominates", [
    (dict(max_per_round=4), True),
    (dict(max_per_tenant=4, window_s=1.5), True),
    (dict(max_per_node=1, window_s=1.5), False),
    (dict(node_cooldown_s=3.0), False)])
def test_storm_with_a_tight_budget_matches_reference(backend, budget,
                                                      nominates):
    """Preemption through the arbiter: a victim set is admitted or
    deferred whole, a deferred preemptor gets no nomination, and every
    round (placements, nominations, evictions, the arbiter's records)
    equals the JAX Scheduler's. A set of two victims on one node never
    passes a budget of one eviction per node, nor a node cooldown (one
    admission per node per request)."""
    ref, port = _storm_pair(backend, 3, budget)
    seen = _rounds(ref, port, rounds=6)
    assert (seen["nominations"] > 0) == nominates
    assert seen["deferred"] > 0


def test_gang_min_available_defers_victims_like_the_reference():
    """Victims in a gang: the arbiter's headroom (live bound members less
    ``min_member``) comes from the port's cache as from the reference's."""
    ref, port = _storm_pair("device", 11, {}, gang_nodes=4)
    seen = _rounds(ref, port, rounds=4)
    reasons = port.migration_arbiter.status()["deferred_by_reason"]
    assert reasons.get("gang-min-available", 0) > 0
    assert seen["nominations"] > 0


@pytest.mark.parametrize("backend", ("device", "host"))
def test_zero_budget_arbiter_equals_no_arbiter(backend):
    """The unlimited default budget admits everything: a Scheduler with
    it runs round for round as one without an arbiter (and as the JAX
    Scheduler with one)."""
    ref, port = _storm_pair(backend, 11, {})
    _, bare = _storm_pair(backend, 11, None)
    assert bare.migration_arbiter is None
    for r in range(5):
        now = 100.0 + r
        before = set(bare.cache.pods)
        want = bare.schedule_pending(now=now)
        got = port.schedule_pending(now=now)
        ref.schedule_pending(now=now)
        assert dict(got) == dict(want) and got.nominations == want.nominations
        assert set(port.cache.pods) == set(bare.cache.pods) == set(
            ref.cache.pods)
        for uid, node in got.items():
            if node is not None:
                for s in (port, bare, ref):
                    s.cache.finish_binding(uid)
    status = port.migration_arbiter.status()
    assert status["deferred_total"] == 0 and status["admitted_total"] > 0
    assert status == ref.migration_arbiter.status()


def test_defrag_through_the_arbiter_matches_reference():
    """``defrag_headroom(apply=True)`` under a node cooldown admits one
    drain per node and keeps the partial plan; the controller's loop
    (confirm 2, cooldown) drives it the same way on both packages."""
    target = np.zeros(8, np.int64)
    target[0], target[1] = 8000, 24576
    ref, port = _storm_pair("device", 11, dict(node_cooldown_s=30.0),
                            n_arrivals=0)
    want = ref.defrag_headroom(target, 5000, apply=True, now=50.0)
    got = port.defrag_headroom(target, 5000, apply=True, now=50.0)
    assert got == want and len(got[1]) == 1
    assert set(port.cache.pods) == set(ref.cache.pods)
    # a pending gang whose member fits no node while the cluster has room
    ref, port = _storm_pair("device", 11, dict(node_cooldown_s=30.0),
                            n_arrivals=0)
    out = []
    for sched, types, resource, mig in ((ref, jtypes, JResourceName, jmig),
                                        (port, ttypes, TResourceName, tmig)):
        for i in range(8):
            sched.remove_pod(sched.cache.pods[f"default/storm-be-{i}-0"])
        sched.update_gang(types.GangSpec(name="g", min_member=2))
        for j in range(2):
            sched.add_pod(types.PodSpec(
                name=f"gm{j}", gang="g", priority=5000,
                requests={resource.CPU: 8000, resource.MEMORY: 4096}))
        ctl = mig.DefragController(sched, mig.DefragPolicy(
            interval_s=1.0, cooldown_s=30.0, confirm=2), clock=lambda: 0.0)
        decisions = [ctl.reconcile(now=100.0 + t) for t in range(6)]
        decisions.append(ctl.reconcile(now=140.0, force=True))
        out.append((decisions, ctl.status(), ctl.replay_decisions(),
                    sorted(sched.cache.pods),
                    sched.migration_arbiter.decisions()))
    assert out[0] == out[1]
    assert sum(d is not None for d in out[1][0]) >= 1


def _rebalance_pair(budget, backend, n_nodes=20, ppn=5):
    """Both Schedulers fed config #22's storm at ``n_nodes`` (assigned
    pods and node metrics), each with its arbiter at ``budget``."""
    spec = testing.rebalance_storm_spec(n_nodes=n_nodes, ppn=ppn, seed=22)
    out = []
    for make, types, resource, mig in (
            (lambda: JScheduler(model=JPlacementModel(use_pallas=False)),
             jtypes, JResourceName, jmig),
            (lambda: Scheduler(model=PlacementModel(device="cpu")),
             ttypes, TResourceName, tmig)):
        snap = testing.build_snapshot(spec, types, resource)
        sched = make()
        if budget is not None:
            sched.migration_arbiter = mig.MigrationArbiter(
                mig.MigrationBudget(**budget), clock=lambda: 0.0)
        for node in snap.nodes:
            sched.add_node(node)
        for metric in snap.node_metrics.values():
            sched.update_node_metric(metric)
        for pod in snap.pods:
            sched.add_pod(pod)
        out.append(sched)
    pools = [p(low_thresholds={r.CPU: 30, r.MEMORY: 30},
               high_thresholds={r.CPU: 60, r.MEMORY: 60})
             for p, r in ((JNodePool, JResourceName),
                          (NodePool, TResourceName))]
    plugins = (JLowNodeLoad(JArgs(node_pools=[pools[0]])),
               LowNodeLoad(LowNodeLoadArgs(
                   node_pools=[pools[1]], backend=backend,
                   device=None if backend == "host" else "cpu")))
    return out, plugins


@pytest.mark.parametrize("backend", ("host", "device", "verify"))
@pytest.mark.parametrize("budget", [None, dict(max_per_node=1)])
def test_rebalance_sweep_matches_reference(backend, budget):
    """``Scheduler.rebalance_sweep`` evicts the JAX Scheduler's pods in
    its order (with a per-node budget, one per hot node and the rest
    deferred), and the next round's delta staging equals a fresh
    staging of its snapshot."""
    (ref, port), (jplugin, tplugin) = _rebalance_pair(budget, backend)
    for sched in (ref, port):
        sched.schedule_pending(now=110.0)   # round 0 stages in full
    want = ref.rebalance_sweep(jplugin, now=120.0)
    got = port.rebalance_sweep(tplugin, now=120.0)
    assert got == want and got
    assert set(port.cache.pods) == set(ref.cache.pods)
    if budget is not None:
        status = port.migration_arbiter.status()
        assert status == ref.migration_arbiter.status()
        assert status["deferred_total"] > 0
        assert all(n <= 1 for n in status["window_nodes"].values())
    fresh = []
    dispatch = port.model.schedule_async

    def record(snap):
        fresh.append(port.model.stage_nodes(
            lower_nodes(snap, **port.model.lowering_kwargs())))
        return dispatch(snap)

    port.model.schedule_async = record
    port.schedule_pending(now=121.0)
    assert port.model.last_staging == "delta"
    state = port.model.staged_cache.state
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(fresh[-1], f)), f
