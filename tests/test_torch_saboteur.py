"""The port's ``StateSaboteur`` and its fault kinds (``testing/chaos.py``)
against the JAX package's, on the CPU.

Each of the three ``STATE_FAULT_KINDS`` runs in both packages on the same
wired world from the same seed: the same victim, the same log, and the
same auditor sweep report after it (``desync-staged-row`` moves the host
arrays and the staged tensor by 777 each, the tensor checked to share no
memory with the arrays). Then the reference's kill-the-leader chaos drive
(``tests/test_chaos.py``'s ``_drive_cluster``, here
``testing.chaos.drive_audited_cluster``) through both packages, with a
seeded schedule over all three kinds and the host cutoff alternating by
tick between 0 and 32 cells (every tick here solves 8 nodes x 4 pods, so
one fixed value would send every tick one way; the reference's model
runs with ``pod_bucketing=False`` so that its gate counts the same
cells): equal saboteur logs, auditor statuses, placement logs and buses,
and each package's placement log equal to its crash-free run."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.testing import chaos
from test_torch_auditor import auditor_cls, report, wired
from test_torch_colocation import CPU, MEM, PORT, REF


def chaos_of(P):
    return importlib.import_module(f"{P.root}.testing.chaos")


def settled(P):
    """A wired scheduler with six placed pods and a settled staged cache
    (the binds' dirty rows re-lowered by an empty round)."""
    bus, sched, _ = wired(P, n_nodes=6)
    for j in range(6):
        pod = P.pod(f"w{j}", {CPU: 500 + 250 * j, MEM: 256})
        bus.apply(P.Kind.POD, pod.uid, pod)
    sched.schedule_pending(now=100.0)
    sched.schedule_pending(now=100.0)
    return bus, sched


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", chaos.STATE_FAULT_KINDS)
def test_fault_kind_matches_reference(kind, seed):
    """Same seed, same victim and log; the sweep after it reports the same
    drift and repairs it in both packages."""
    def case(P):
        bus, sched = settled(P)
        C = chaos_of(P)
        cache = sched.model.staged_cache
        before = None
        if P.port:
            arrays, state = cache.audit_view()[:2]
            before = (arrays.usage.copy(), state.usage.clone())
        sab = C.StateSaboteur(C.FaultSchedule({3: kind}), sched, seed=seed)
        assert sab.inject(2) is None
        assert sab.inject(3) == kind
        if kind == "desync-staged-row" and P.port:
            arrays, state = cache.audit_view()[:2]
            i = arrays.names.index(sab.log[0][2])
            host_moved = arrays.usage - before[0]
            dev_moved = (state.usage - before[1]).numpy()
            for moved in (host_moved, dev_moved):
                assert moved[i, 0] == 777 and int(np.abs(moved).sum()) == 777
        aud = auditor_cls(P)(sched, bus, interval_rounds=0, probe_rows=6)
        r = report(aud.sweep("manual", now=100.0))
        clean = report(aud.sweep("manual", now=100.0))
        return sab.log, sab.injected, r, clean["detections"]

    got, want = case(PORT), case(REF)
    assert got == want
    log, injected, r, clean = got
    assert injected == {kind: 1} and r["detections"] and clean == {}


def test_preconditions_and_schedule_kinds_match_reference():
    """Before any pod is placed or any row staged, a cache corruption and
    a staged-row desync inject nothing; an orphan assume always does. A
    schedule takes the state kinds beside the HBM ones and refuses an
    unknown kind; the HBM saboteur ignores the state kinds."""
    def case(P):
        C = chaos_of(P)
        sched = P.scheduler()
        sched.add_node(P.node("n0"))
        sched.add_node(P.node("n1"))
        sab = C.StateSaboteur(C.FaultSchedule(
            dict(enumerate(C.STATE_FAULT_KINDS))), sched, seed=1)
        applied = [sab.inject(t) for t in range(3)]
        with pytest.raises(ValueError, match="unknown fault kind"):
            C.FaultSchedule({0: "no-such-fault"})
        hbm = C.HBMSaboteur(C.FaultSchedule({0: "orphan-assume"}))
        return applied, sab.log, hbm.inject(0), C.STATE_FAULT_KINDS

    got, want = case(PORT), case(REF)
    assert got == want
    assert got[0] == [None, "orphan-assume", None]


def ref_env():
    """The JAX package's modules as ``drive_audited_cluster`` takes them."""
    def mod(name):
        return importlib.import_module(f"koordinator_tpu.{name}")

    bus = mod("client.bus")
    return SimpleNamespace(
        APIServer=bus.APIServer, Kind=bus.Kind, EventType=bus.EventType,
        NodeSpec=REF.T.NodeSpec, NodeMetric=REF.T.NodeMetric,
        PodSpec=REF.T.PodSpec, ResourceName=REF.X.ResourceName,
        Scheduler=mod("scheduler.scheduler").Scheduler,
        LeaderElector=mod("client.leaderelection").LeaderElector,
        StateAuditor=mod("scheduler.auditor").StateAuditor,
        wire_scheduler=mod("client.wiring").wire_scheduler,
        StateSaboteur=mod("testing.chaos").StateSaboteur,
        FaultSchedule=mod("testing.chaos").FaultSchedule)


def host_every_other(t):
    """Even ticks on the host route (32 cells), odd ticks on the kernel."""
    return 0 if t % 2 else chaos.AUDIT_NODES * 4


def drive(P, kill_leader, sabotage):
    def make():
        if P.port:
            return P._model(device="cpu")
        return P._model(use_pallas=False, pod_bucketing=False)

    env = chaos.port_env() if P.port else ref_env()
    return chaos.drive_audited_cluster(
        env, 31, kill_leader=kill_leader, sabotage=sabotage,
        make_model=make, cutoff_of_tick=host_every_other)


def bus_state(P, bus):
    wiring = importlib.import_module(f"{P.root}.client.wiring")
    cluster = importlib.import_module(f"{P.root}.state.cluster")
    arrays = cluster.lower_nodes(wiring.snapshot_from_bus(bus, now=200.0))
    return (arrays.names,
            {f: getattr(arrays, f).tolist() for f in STAGED_NODE_FIELDS},
            sorted((p.uid, p.node_name)
                   for p in bus.list(P.Kind.POD).values()))


def test_drive_cluster_matches_reference_at_fixed_cutoffs():
    """The kill-the-leader drive with a seeded schedule over all three
    state faults, the cutoff fixed per tick (32 cells on even ticks, 0 on
    odd ones): the port equals the reference (saboteur log, the
    auditors' detections and repairs, per-tick placements, the bus after)
    and its own crash-free run, with host and kernel ticks both in it and
    every bind made once."""
    sabotage = chaos.state_fault_schedule(31).events
    assert sorted(sabotage.values()) == sorted(chaos.STATE_FAULT_KINDS)
    runs = {}
    for P in (PORT, REF):
        live_log, live_bus, info = drive(P, True, sabotage)
        ref_log, ref_bus, _ = drive(P, False, {})
        assert live_log == ref_log, P.root
        assert bus_state(P, live_bus) == bus_state(P, ref_bus), P.root
        assert all(c == 1 for c in info["binds"].values())
        status_b = info["aud_b"].status()
        runs[P.root] = dict(
            log=live_log, bus=bus_state(P, live_bus),
            saboteur=(info["saboteur"].log, info["saboteur"].injected),
            aud_b={k: status_b[k] for k in ("sweeps", "detections",
                                            "repairs")},
            unrepaired=status_b["last"]["unrepaired"],
            aud_a=info["aud_a"].status()["detections"],
            host_ticks=[s == "host" for s in info["solvers"]])
    port, ref = runs["koordinator_tpu_torch"], runs["koordinator_tpu"]
    assert port == ref
    assert port["saboteur"][1] == {k: 1 for k in chaos.STATE_FAULT_KINDS}
    assert port["aud_b"]["detections"] == {
        "cache-bus/stale-pod": 1, "cache-bus/orphan-assume": 1,
        "device-parity/staged-host-drift": 1,
        "device-parity/staged-device-drift": 1}
    assert port["aud_b"]["repairs"] == {"targeted": 2, "full-restage": 1}
    assert port["unrepaired"] == [] and port["aud_a"] == {}
    assert any(port["host_ticks"]) and not all(port["host_ticks"])
