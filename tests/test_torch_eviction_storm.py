"""The eviction storm under arbitration: the port's ``Scheduler`` with a
``MigrationArbiter`` against the JAX package's, on the reference's
chaos cases (``tests/test_migration.py``'s
``test_chaos_eviction_storm_budgets_and_identity`` and
``test_chaos_rebalance_wave_respects_budget``).

The storm runs ``testing.chaos.eviction_storm_world`` (10 unique-fit
nodes) under the reference's schedule of ``EVICTION_STORM_FAULT_KINDS``:
``preemption-storm`` at tick 2, ``rebalance-wave`` at 5 and
``budget-squeeze-mid-wave`` at 7, through a loose budget tightened
mid-wave. Round for round the port's results and nominations, its
arbiter's decision ring, status and deferral counters, its final
placements and staged node accounting equal the reference's (the port
under both preemption backends, the device one as torch ops on the
CPU); the reference's own budget check passes on the port's ring, no
victim is evicted twice, and the placements equal the fault-free control
arm's. The rebalance wave holds a live LoadAware sweep to a node budget
with typed deferrals, port against reference."""

import importlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_migration import _assert_budget_compliance  # noqa: E402

from koordinator_tpu_torch import testing  # noqa: E402

N, TICKS = 10, 14
SCHEDULE = {2: "preemption-storm", 5: "rebalance-wave",
            7: "budget-squeeze-mid-wave"}


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.port = root == "koordinator_tpu_torch"
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.chaos = mod("testing.chaos")
        self.mig = mod("control.migration")
        self.metrics = mod("metrics.components")
        self.cluster = mod("state.cluster")
        self.binpack = mod("ops.binpack")
        self.fw = mod("descheduler.framework")
        self.la = mod("descheduler.loadaware")
        self._sched = mod("scheduler.scheduler").Scheduler
        self._model = mod("models.placement").PlacementModel

    def scheduler(self, backend):
        if self.port:
            return self._sched(model=self._model(device="cpu"),
                               preemption_backend=backend)
        return self._sched(model=self._model(use_pallas=False),
                           preemption_backend="host")

    def low_node_load(self, backend, **kw):
        if self.port and backend != "host":
            kw.update(backend=backend, device="cpu")
        return self.la.LowNodeLoad(self.la.LowNodeLoadArgs(**kw))


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")


def storm_scheduler(P, backend, arbiter):
    nodes, residents, arrivals = P.chaos.eviction_storm_world(
        seed=11, n_nodes=N)
    sched = P.scheduler(backend)
    sched.migration_arbiter = arbiter
    for node in nodes:
        sched.add_node(node)
    for pod in residents + arrivals:
        sched.add_pod(pod)
    return sched


def placements(sched):
    return sorted((p.name, p.node_name)
                  for p in sched.cache.pods.values() if p.node_name)


def accounting(P, sched):
    arrays = P.cluster.lower_nodes(sched.cache.snapshot(now=300.0))
    return [list(arrays.names)] + [np.asarray(getattr(arrays, f)).tolist()
                                   for f in P.binpack.STAGED_NODE_FIELDS]


def run_storm(sched, saboteur=None):
    log = []
    for t in range(TICKS):
        now = 100.0 + 2.0 * t
        if saboteur is not None:
            saboteur(t, now, sched)
        out = sched.schedule_pending(now=now)
        log.append((t, sorted(out.items()), sorted(out.nominations.items())))
    return log


def storm(P, backend):
    """The reference's storm arm, and its fault-free control arm."""
    control = storm_scheduler(P, backend, arbiter=None)
    control_log = run_storm(control)
    loose = P.mig.MigrationBudget(max_per_round=4, max_per_node=2,
                                  max_per_tenant=6, window_s=3.0)
    tight = P.mig.MigrationBudget(max_per_round=2, max_per_node=1,
                                  max_per_tenant=3, window_s=3.0)
    arb = P.mig.MigrationArbiter(loose)
    sched = storm_scheduler(P, backend, arbiter=arb)
    plugin = P.low_node_load(backend)
    schedule = P.chaos.FaultSchedule(SCHEDULE)
    squeeze = {"at": None}
    counter = P.metrics.MIGRATION_DEFERRALS
    before = {r: counter.value({"source": "preemption", "reason": r})
              for r in P.mig.REASONS}
    fired = []

    def saboteur(t, now, s):
        kind = schedule.fault_for(t)
        if kind is not None:
            fired.append(kind)
        if kind == "rebalance-wave":
            s.rebalance_sweep(plugin, now=now)
        if kind == "budget-squeeze-mid-wave":
            arb.set_budget(tight)
            squeeze["at"] = (arb.decisions() or [{}])[-1].get("seq", 0)

    log = run_storm(sched, saboteur)
    counted = {r: counter.value({"source": "preemption", "reason": r})
               - before[r] for r in P.mig.REASONS}
    return dict(
        control_log=control_log, control=placements(control),
        control_accounting=accounting(P, control), log=log,
        placements=placements(sched), accounting=accounting(P, sched),
        decisions=arb.decisions(), status=arb.status(), counted=counted,
        squeeze_at=squeeze["at"], fired=fired,
        budgets=(loose, tight))


@pytest.mark.parametrize("backend", ("host", "device"))
def test_eviction_storm_matches_reference(backend):
    got = storm(PORT, backend)
    want = storm(REF, "host")
    for key in ("control_log", "control", "control_accounting", "log",
                "placements", "accounting", "decisions", "status",
                "counted", "squeeze_at", "fired"):
        assert got[key] == want[key], key
    # the reference's property, on the port's run
    assert got["fired"] == ["preemption-storm", "rebalance-wave",
                            "budget-squeeze-mid-wave"]
    assert all(k in PORT.chaos.EVICTION_STORM_FAULT_KINDS
               for k in got["fired"])
    # every arrival placed on its unique node, every resident evicted
    assert got["control"] == [(f"evstorm-ls-{i}", f"evstorm-n{i}")
                              for i in sorted(range(N), key=str)]
    assert got["placements"] == got["control"]
    assert got["accounting"] == got["control_accounting"]
    records = got["decisions"]
    loose, tight = got["budgets"]
    at = got["squeeze_at"]
    def budget_at(seq):
        return loose if at is None or seq <= at else tight

    # the reference's check and the port's copy of it
    _assert_budget_compliance(records, budget_at)
    PORT.chaos.check_budget_compliance(records, budget_at)
    evicted = [u for rec in records if not rec.get("dry_run")
               for u in rec["admitted"]]
    assert len(evicted) == len(set(evicted)) == N
    deferred = [d for rec in records for d in rec["deferred"]]
    assert deferred, "the tight budget never engaged"
    assert all(d["reason"] in PORT.mig.REASONS for d in deferred)
    assert got["status"]["deferred_total"] == len(deferred)
    assert sum(got["counted"].values()) == sum(
        1 for rec in records if rec["source"] == "preemption"
        for _ in rec["deferred"])
    suffix = [r for r in records if r["seq"] > at]
    assert PORT.mig.replay_requests(tight, suffix) == suffix


def recording(P):
    class Recording(P.fw.Evictor):
        """Approves every eviction and mutates nothing."""

        def _do_evict(self, snapshot, pod, reason):
            return True

        @property
        def sequence(self):
            return [(p.node_name, p.uid) for p in self.evicted]

    return Recording


def wave(P, backend):
    spec = testing.random_cluster_spec(np.random.default_rng(29))
    snapshot = testing.build_snapshot(spec, P.T, P.X.ResourceName)
    arb = P.mig.MigrationArbiter(P.mig.MigrationBudget(max_per_node=1),
                                 clock=lambda: 50.0)
    plugin = P.low_node_load(backend)
    free = recording(P)()
    P.low_node_load(backend).balance(
        testing.build_snapshot(spec, P.T, P.X.ResourceName), free)
    evictor = recording(P)(arbiter=arb)
    plugin.balance(snapshot, evictor)
    return free.sequence, evictor.sequence, arb.decisions(), arb.status()


@pytest.mark.parametrize("backend", ("host", "device"))
def test_rebalance_wave_respects_budget_as_reference(backend):
    got = wave(PORT, backend)
    assert got == wave(REF, "host")
    free, sequence, decisions, _ = got
    per_node = {}
    for node, _uid in sequence:
        per_node[node] = per_node.get(node, 0) + 1
    assert sequence and all(c <= 1 for c in per_node.values())
    assert len(free) > len(sequence)
    assert {d["reason"] for rec in decisions
            for d in rec["deferred"]} == {"node-budget"}


def test_budget_check_catches_an_over_budget_ring():
    """The port's copy of the check refuses what the reference's refuses:
    a ring whose admissions break each cap, judged both ways."""
    tight = PORT.mig.MigrationBudget(max_per_round=2, max_per_node=1,
                                     max_per_tenant=3, window_s=3.0,
                                     node_cooldown_s=5.0)

    def rec(seq, node, uids, lanes, rnd=1, now=100.0):
        return dict(seq=seq, now=now, source="preemption", node=node,
                    round=rnd, uids=uids, lanes=lanes, admitted=uids,
                    deferred=[], dry_run=False)

    rings = {
        "round": [rec(1, "a", ["x"], ["be"]), rec(2, "b", ["y"], ["be"]),
                  rec(3, "c", ["z"], ["ls"])],
        "node": [rec(1, "a", ["x", "y"], ["be", "ls"])],
        "lane": [rec(i, f"n{i}", [f"u{i}"], ["be"], rnd=i)
                 for i in range(4)],
        "cooldown": [rec(1, "a", ["x"], ["be"], now=100.0),
                     rec(2, "a", ["y"], ["ls"], rnd=2, now=103.5)],
        "clean": [rec(1, "a", ["x"], ["be"], now=100.0),
                  rec(2, "a", ["y"], ["ls"], rnd=2, now=106.0)],
    }
    for name, ring in rings.items():
        outcomes = []
        for check in (_assert_budget_compliance,
                      PORT.chaos.check_budget_compliance):
            try:
                check(ring, lambda seq: tight)
                outcomes.append("ok")
            except AssertionError as e:
                outcomes.append(str(e).split(" at ")[0])
        assert outcomes[0] == outcomes[1], (name, outcomes)
        assert (outcomes[0] == "ok") == (name == "clean"), (name, outcomes)
