"""The port's anti-entropy auditor (``scheduler/auditor.py``) against the
JAX package's, on the CPU.

Each case of the reference's ``tests/test_auditor.py`` runs once per
package on the same seeded world (a :class:`Pkg` holds one package's
modules): the sweep cadence, the repair ladder's threshold boundary,
every targeted repair, the truth-level overcommit that no rung repairs,
the parity probe's round-robin coverage, a desynced staged row (host and
device halves, then the device half alone, written into the staged
tensor after checking that it shares no memory with the host arrays),
dirty rows skipped, ``lower_node_rows`` against ``lower_nodes``, the
rebuild's release of Permit holds, a dead leader's orphaned Permit hold,
and ``run_loop``'s fencing forget. The two runs must return the same
sweep reports (kind, detections, repairs, unrepaired, probe rows and
skips; timings left out) and the reference's own expectations hold in
both. One case shows on purpose where the two differ: the port marks the
delta tracker on a deleted NodeMetric, the reference does not, so only
the reference's probe reports the row as drift."""

import importlib
import itertools

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.scheduler.auditor import read_back_rows
from test_torch_colocation import PORT, REF

CPU, MEM = 0, 1


def auditor_cls(P):
    return importlib.import_module(f"{P.root}.scheduler.auditor").StateAuditor


def cmd_of(P):
    return importlib.import_module(f"{P.root}.cmd.scheduler")


def report(r):
    """A sweep report without its timings."""
    return {k: r[k] for k in ("kind", "at", "detections", "repairs",
                              "unrepaired", "probe_rows", "probe_skipped")}


def both(case):
    """Run ``case(pkg)`` in both packages; their records must be equal."""
    got, want = case(PORT), case(REF)
    assert got == want
    return got


def wired(P, n_nodes=4, cpu=64000, mem=131072, elector_ids=()):
    """A bus and one wired scheduler (and electors), seeded with nodes
    and fresh metrics."""
    bus = P.bus()
    sched = P.scheduler()
    electors = [P.le.LeaderElector(bus, "koord-scheduler", ident,
                                   lease_duration=1.0)
                for ident in elector_ids]
    P.wiring.wire_scheduler(bus, sched,
                            elector=electors[0] if electors else None)
    for i in range(n_nodes):
        bus.apply(P.Kind.NODE, f"n{i}", P.node(f"n{i}", cpu=cpu, mem=mem))
        bus.apply(P.Kind.NODE_METRIC, f"n{i}", P.metric(
            f"n{i}", usage={CPU: 100 * i}, update_time=90.0))
    return bus, sched, electors


# -- the sweep cadence -----------------------------------------------------------

def test_promotion_sweep_once_per_acquisition():
    """The promotion sweep fires once per lease acquisition, not once per
    round, and again on a re-acquisition."""
    def case(P):
        bus, sched, (ea,) = wired(P, elector_ids=("a",))
        aud = auditor_cls(P)(sched, bus, interval_rounds=0)
        ea.on_started_leading = aud.note_promotion
        for t in range(5):
            assert ea.tick(0.5 * t)
            aud.on_round(now=0.5 * t)
        first = aud.status()["sweeps"]
        eb = P.le.LeaderElector(bus, "koord-scheduler", "b",
                                lease_duration=1.0)
        assert eb.tick(10.0)
        assert not ea.tick(10.1)
        eb.release()
        assert ea.tick(11.0)
        warm = aud.on_round(now=11.0)["warm"]
        assert aud.status()["sweeps"] == {"promotion": 2}
        # the promotion prestages the repaired world (no warm pool is
        # handed to this auditor: its warm entry is the prestage alone)
        assert "error" not in warm["prestage"]
        return first, aud.status()["sweeps"], report(aud.last_report)

    first, _, _ = both(case)
    assert first == {"promotion": 1}


def test_run_loop_promotion_then_periodic_cadence():
    """Through run_loop: round 1 runs the promotion sweep, then one
    periodic sweep every interval_rounds rounds."""
    def case(P):
        bus, sched, (ea,) = wired(P, elector_ids=("a",))
        aud = auditor_cls(P)(sched, bus, interval_rounds=2)
        ea.on_started_leading = aud.note_promotion
        clock = itertools.count()
        cmd = cmd_of(P)
        cmd.run_loop(sched, cmd.SchedulerConfig(schedule_interval_seconds=0.0),
                     elector=ea, auditor=aud, max_rounds=5,
                     now_fn=lambda: 0.25 * next(clock), log=lambda *a: None)
        return aud.status()["sweeps"]

    assert both(case) == {"promotion": 1, "periodic": 2}


def test_sweep_due_peeks_without_consuming():
    def case(P):
        bus, sched, _ = wired(P)
        aud = auditor_cls(P)(sched, bus, interval_rounds=3)
        seen = []
        for _ in range(6):
            seen.append((aud.sweep_due(), aud.sweep_due(),
                         aud.on_round(now=100.0) is not None))
        aud.note_promotion()
        seen.append((aud.sweep_due(), aud.on_round(now=101.0)["kind"]))
        return seen

    seen = both(case)
    assert [s[2] for s in seen[:6]] == [False, False, True] * 2
    assert seen[6] == (True, "promotion")


# -- the repair ladder -----------------------------------------------------------

def test_drift_threshold_boundary():
    """N-1 drifts repair targeted; N drifts rebuild the cache."""
    def case(P):
        bus, sched, _ = wired(P, n_nodes=6)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0,
                             rebuild_threshold=3)
        for name in ("n0", "n1"):
            sched.cache.nodes.pop(name)
        r1 = aud.sweep("manual", now=100.0)
        assert r1["detections"] == {"cache-bus/missing-node": 2}
        assert r1["repairs"] == {"targeted": 2}
        assert set(sched.cache.nodes) == {f"n{i}" for i in range(6)}
        for name in ("n0", "n1", "n2"):
            sched.cache.nodes.pop(name)
        r2 = aud.sweep("manual", now=101.0)
        assert r2["detections"] == {"cache-bus/missing-node": 3}
        assert r2["repairs"] == {"cache-rebuild": 1}
        assert set(sched.cache.nodes) == {f"n{i}" for i in range(6)}
        assert set(sched.cache.node_metrics) == {f"n{i}" for i in range(6)}
        return report(r1), report(r2), aud.status()["repairs"]

    both(case)


def test_orphan_assume_detected_and_dropped():
    def case(P):
        bus, sched, _ = wired(P)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0)
        sched.cache.assumed["ghost"] = 0.0
        r = aud.sweep("manual", now=1000.0)
        assert r["detections"] == {"cache-bus/orphan-assume": 1}
        assert r["repairs"] == {"targeted": 1}
        assert sched.cache.assumed == {}
        return report(r)

    both(case)


def test_resv_overcredit_clamped():
    """Reservation credit above the reserved capacity is detected and
    clamped, with a tracker mark; the next sweep is clean."""
    def case(P):
        bus, sched, _ = wired(P)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0)
        resv = P.T.ReservationSpec(
            name="r0", node_name="n0", state=P.T.ReservationState.AVAILABLE,
            requests=P.res({CPU: 1000}), allocated=P.res({CPU: 4000}), ttl=0)
        bus.apply(P.Kind.RESERVATION, "r0", resv)
        epoch_before = sched.cache.delta_tracker.epoch
        r = aud.sweep("manual", now=100.0)
        assert r["detections"] == {"accounting/resv-overcredit": 1}
        assert r["repairs"] == {"targeted": 1}
        assert resv.allocated[P.X.ResourceName.CPU] == 1000
        assert sched.cache.delta_tracker.epoch > epoch_before
        assert aud.sweep("manual", now=101.0)["detections"] == {}
        return report(r)

    both(case)


def test_gang_illegal_state_repaired():
    def case(P):
        bus, sched, _ = wired(P)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0)
        bus.apply(P.Kind.GANG, "g", P.T.GangSpec(name="g", min_member=2))
        record = sched.gang_manager.gangs["g"]
        record.children.add("p1")
        record.waiting.add("p1")
        record.bound.add("p1")        # waiting AND bound: illegal
        record.bound.add("stranger")  # not a child: illegal
        r = aud.sweep("manual", now=100.0)
        assert r["detections"] == {"accounting/gang-illegal-state": 1}
        assert record.waiting == set()
        assert record.bound == {"p1"}
        assert r["unrepaired"] == []
        return report(r)

    both(case)


def test_double_placed_pod_repaired_from_bus():
    def case(P):
        bus, sched, _ = wired(P)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0)
        pod = P.pod("p", {CPU: 500}, node_name="n0")
        bus.apply(P.Kind.POD, pod.uid, pod)
        sched.cache.pending[pod.uid] = pod
        r = aud.sweep("manual", now=100.0)
        assert "accounting/double-placed" in r["detections"]
        assert pod.uid not in sched.cache.pending
        assert sched.cache.pods[pod.uid].node_name == "n0"
        assert aud.sweep("manual", now=101.0)["detections"] == {}
        return report(r)

    both(case)


def test_stale_and_extra_objects_repaired_targeted():
    """Every targeted kind at once, under the rebuild threshold: a stale
    node, a stale and an extra metric, a stale pod placement, an extra
    pod, an extra reservation, a stale quota and an extra gang."""
    def case(P):
        bus, sched, _ = wired(P, n_nodes=3)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0,
                             rebuild_threshold=32)
        pod = P.pod("bound", {CPU: 700}, node_name="n1")
        bus.apply(P.Kind.POD, pod.uid, pod)
        bus.apply(P.Kind.QUOTA, "q", P.T.QuotaSpec(
            name="q", min=P.res({CPU: 1000}), max=P.res({CPU: 4000})))
        cache = sched.cache
        cache.nodes["n0"] = P.node("n0", cpu=1, mem=1)
        cache.node_metrics["n2"] = P.metric("n2", usage={CPU: 5})
        cache.node_metrics["ghost"] = P.metric("ghost")
        cache.pods[pod.uid] = P.pod("bound", {CPU: 700}, node_name="n2")
        cache.pods["default/extra"] = P.pod("extra", {CPU: 1},
                                            node_name="n0")
        cache.reservations["gone"] = P.T.ReservationSpec(
            name="gone", node_name="n2",
            state=P.T.ReservationState.AVAILABLE)
        cache.quotas["q"] = P.T.QuotaSpec(name="q", max=P.res({CPU: 1}))
        cache.gangs["stray"] = P.T.GangSpec(name="stray", min_member=1)
        r = aud.sweep("manual", now=100.0)
        assert r["repairs"] == {"targeted": sum(r["detections"].values())}
        assert aud.sweep("manual", now=101.0)["detections"] == {}
        assert cache.pods[pod.uid].node_name == "n1"
        return report(r)

    got = both(case)
    assert set(got["detections"]) >= {
        "cache-bus/stale-node", "cache-bus/stale-metric",
        "cache-bus/extra-metric", "cache-bus/stale-pod",
        "cache-bus/extra-pod", "cache-bus/extra-reservation",
        "cache-bus/stale-quota", "cache-bus/extra-gang"}


def test_truth_level_overcommit_is_loud_never_silent():
    """A violation no rung can repair (bus truth overcommitted) is
    rebuilt once, reported unrepaired on every sweep without another
    rebuild, and re-arms when it heals."""
    def case(P):
        bus, sched, _ = wired(P, n_nodes=1, cpu=1000)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0)
        for i in range(2):
            pod = P.pod(f"p{i}", {CPU: 900}, node_name="n0")
            bus.apply(P.Kind.POD, pod.uid, pod)
        r1 = aud.sweep("manual", now=100.0)
        assert r1["detections"] == {"accounting/node-overcommit": 1}
        assert r1["repairs"] == {"cache-rebuild": 1}
        assert r1["unrepaired"] == ["node-overcommit:n0"]
        r2 = aud.sweep("manual", now=101.0)
        assert r2["repairs"] == {}
        assert r2["unrepaired"] == ["node-overcommit:n0"]
        assert aud.status()["unrepairable"] == ["node-overcommit:n0"]
        for uid in list(sched.cache.pods):
            sched.cache.remove_pod(uid)
        for key in list(bus.list(P.Kind.POD)):
            bus.delete(P.Kind.POD, key)
        r3 = aud.sweep("manual", now=102.0)
        assert r3["unrepaired"] == []
        assert aud.status()["unrepairable"] == []
        return report(r1), report(r2), report(r3)

    both(case)


# -- the device <-> host parity probe --------------------------------------------

def staged(P, n_nodes=10):
    bus, sched, _ = wired(P, n_nodes=n_nodes)
    pod = P.pod("warm", {CPU: 500})
    bus.apply(P.Kind.POD, pod.uid, pod)
    sched.schedule_pending(now=100.0)  # populates the staged cache
    # the warm bind marked its node dirty; an empty round re-lowers it, so
    # sweeps start from a clean generation
    sched.schedule_pending(now=100.0)
    return bus, sched


def test_round_robin_covers_every_row_within_k_sweeps():
    """probe_rows=4 over 10 rows: 3 sweeps cover every row, in a fixed
    round-robin order, and the cycle repeats."""
    def case(P):
        bus, sched = staged(P, n_nodes=10)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0, probe_rows=4)
        names = sched.model.staged_cache.audit_view()[0].names
        probed = [aud.sweep("manual", now=100.0)["probe_rows"]
                  for _ in range(3)]
        assert probed[0] == names[0:4]
        assert probed[1] == names[4:8]
        assert probed[2] == names[8:10] + names[0:2]
        assert set().union(*map(set, probed)) == set(names)
        assert aud.sweep("manual", now=100.0)["probe_rows"] == names[2:6]
        return probed

    both(case)


def desync(P, sched, host: bool):
    """Add 777 to staged row 2's CPU usage on the device (and on the host
    when ``host``), with no tracker mark."""
    cache = sched.model.staged_cache
    arrays, state, _, _, _ = cache.audit_view()
    if host:
        arrays.usage[2, 0] += 777
    if P.port:
        usage = state.usage
        # the staged tensor must not share memory with the host arrays,
        # or this write would move the host row too and prove nothing
        assert not np.shares_memory(usage.numpy(), arrays.usage)
        usage[2, 0] += 777
    else:
        cache.state = state._replace(usage=state.usage.at[2, 0].add(777))


@pytest.mark.parametrize("host", [True, False], ids=["host+device", "device"])
def test_desynced_row_detected_and_restaged(host):
    """A staged row drifted from truth with no tracker mark is caught by
    the probe and repaired by a full restage; the next solve is built
    from truth and the next sweep is clean."""
    def case(P):
        bus, sched = staged(P, n_nodes=6)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0, probe_rows=6)
        cache = sched.model.staged_cache
        desync(P, sched, host)
        r = aud.sweep("manual", now=100.0)
        want = {"device-parity/staged-device-drift": 1}
        if host:
            want["device-parity/staged-host-drift"] = 1
        assert r["detections"] == want
        assert r["repairs"] == {"full-restage": 1}
        assert cache.audit_view()[0] is None  # invalidated
        sched.schedule_pending(now=101.0)
        assert cache.last_path == "full"
        assert aud.sweep("manual", now=101.0)["detections"] == {}
        return report(r)

    both(case)


def test_probe_read_back_is_one_block_of_every_field():
    """``read_back_rows`` returns, for the sampled rows, every staged
    field equal to the staged tensors' rows (bool fields as 0/1)."""
    bus, sched = staged(PORT, n_nodes=6)
    state = sched.model.staged_cache.audit_view()[1]
    rows = [4, 0, 5]
    out = read_back_rows(state, rows)
    assert list(out) == list(STAGED_NODE_FIELDS)
    for f in STAGED_NODE_FIELDS:
        want = getattr(state, f)[torch.as_tensor(rows)].numpy()
        np.testing.assert_array_equal(out[f], want.astype(np.int32))


def test_dirty_rows_are_skipped_not_flagged():
    """Rows marked dirty since the staged generation are skipped."""
    def case(P):
        bus, sched = staged(P, n_nodes=6)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0, probe_rows=6)
        bus.apply(P.Kind.NODE_METRIC, "n3", P.metric(
            "n3", usage={CPU: 9999}, update_time=100.5))
        r = aud.sweep("manual", now=100.5)
        assert r["detections"] == {}
        assert r["probe_skipped"] == 1
        assert "n3" not in r["probe_rows"]
        return report(r)

    both(case)


def test_deleted_metric_marked_by_port_only():
    """The difference on purpose: a NodeMetric delete marks the delta
    tracker in the port (``Scheduler.remove_node_metric``) and not in the
    reference, so the reference's probe reads the unmarked row as drift
    and restages, while the port's skips it as dirty."""
    got = {}
    for P in (PORT, REF):
        bus, sched = staged(P, n_nodes=6)
        aud = auditor_cls(P)(sched, bus, interval_rounds=0, probe_rows=6)
        bus.delete(P.Kind.NODE_METRIC, "n3")
        got[P.root] = report(aud.sweep("manual", now=100.5))
    port, ref = got["koordinator_tpu_torch"], got["koordinator_tpu"]
    assert port["detections"] == {} and port["probe_skipped"] == 1
    assert ref["probe_skipped"] == 0
    assert ref["repairs"] == {"full-restage": 1}
    assert set(ref["detections"]) == {"device-parity/staged-host-drift",
                                      "device-parity/staged-device-drift"}


def test_lower_node_rows_matches_full_lowering_rows():
    """lower_node_rows == the same rows of lower_nodes, and equal across
    the packages."""
    def case(P):
        cluster = importlib.import_module(f"{P.root}.state.cluster")
        bus, sched, _ = wired(P, n_nodes=5)
        for i in range(7):
            pod = P.pod(f"p{i}", {CPU: 300 + i}, node_name=f"n{i % 5}")
            bus.apply(P.Kind.POD, pod.uid, pod)
        bus.apply(P.Kind.RESERVATION, "r0", P.T.ReservationSpec(
            name="r0", node_name="n1", state=P.T.ReservationState.AVAILABLE,
            requests=P.res({CPU: 2000}), ttl=0))
        snap = sched.cache.snapshot(now=120.0)
        full = cluster.lower_nodes(snap)
        names = ["n3", "n0", "n1"]
        rows = cluster.lower_node_rows(snap, names)
        for f, got in rows.items():
            for k, name in enumerate(names):
                np.testing.assert_array_equal(
                    got[k], getattr(full, f)[full.names.index(name)])
        return {f: np.asarray(v).tolist() for f, v in sorted(rows.items())}

    both(case)


# -- Permit holds ------------------------------------------------------------------

def test_waiting_gang_pod_released_cleanly_on_rebuild():
    """A rebuild while a gang pod waits at Permit releases its local holds
    (quota used, gang waiting membership, the node hold) and returns it to
    pending; the next round re-waits it with fresh holds."""
    def case(P):
        bus, sched, _ = wired(P, n_nodes=2)
        bus.apply(P.Kind.QUOTA, "q", P.T.QuotaSpec(
            name="q", min=P.res({CPU: 10000}), max=P.res({CPU: 10000})))
        bus.apply(P.Kind.GANG, "g", P.T.GangSpec(
            name="g", min_member=2, mode=P.T.GangMode.NON_STRICT))
        pod = P.pod("member", {CPU: 1000}, gang="g", quota="q")
        bus.apply(P.Kind.POD, pod.uid, pod)
        out = sched.schedule_pending(now=100.0)
        assert pod.uid in out.waiting and pod.uid in sched._waiting
        info = sched.quota_registry.manager_for_quota("q").quotas["q"]
        assert info.used[CPU] == 1000
        aud = auditor_cls(P)(sched, bus, interval_rounds=0,
                             rebuild_threshold=1)
        sched.cache.nodes.pop("n1")
        r = aud.sweep("manual", now=101.0)
        assert r["repairs"] == {"cache-rebuild": 1}
        assert sched._waiting == {}
        assert pod.uid in sched.cache.pending
        assert pod.node_name is None and not pod.waiting_permit
        assert info.used[CPU] == 0
        assert sched.gang_manager.gangs["g"].waiting == set()
        out2 = sched.schedule_pending(now=102.0)
        assert pod.uid in out2.waiting
        info = sched.quota_registry.manager_for_quota("q").quotas["q"]
        assert info.used[CPU] == 1000
        return report(r), dict(out2.waiting)

    both(case)


def test_promotion_sweep_releases_dead_leaders_permit_hold():
    """A deposed leader's Permit-held gang pod is released back to
    pending by the promoted standby's sweep, while the live holder's own
    sweep treats the hold as healthy."""
    def case(P):
        bus = P.bus()
        sched_a, sched_b = P.scheduler(), P.scheduler()
        P.wiring.wire_scheduler(bus, sched_a)
        P.wiring.wire_scheduler(bus, sched_b)
        for i in range(2):
            bus.apply(P.Kind.NODE, f"n{i}", P.node(f"n{i}", cpu=8000,
                                                   mem=16384))
            bus.apply(P.Kind.NODE_METRIC, f"n{i}", P.metric(
                f"n{i}", update_time=90.0))
        bus.apply(P.Kind.GANG, "g", P.T.GangSpec(
            name="g", min_member=2, mode=P.T.GangMode.NON_STRICT))
        pod = P.pod("m1", {CPU: 1000}, gang="g")
        bus.apply(P.Kind.POD, pod.uid, pod)
        out = sched_a.schedule_pending(now=100.0)
        assert pod.uid in out.waiting and pod.waiting_permit
        aud_a = auditor_cls(P)(sched_a, bus, interval_rounds=0)
        assert aud_a.sweep("manual", now=100.5)["detections"] == {}
        aud_b = auditor_cls(P)(sched_b, bus, interval_rounds=0)
        r = aud_b.sweep("promotion", now=101.0)
        assert r["detections"] == {"cache-bus/orphan-permit-hold": 1}
        assert r["repairs"] == {"targeted": 1}
        assert pod.node_name is None and not pod.waiting_permit
        assert pod.uid in sched_b.cache.pending
        pod2 = P.pod("m2", {CPU: 1000}, gang="g")
        bus.apply(P.Kind.POD, pod2.uid, pod2)
        out2 = sched_b.schedule_pending(now=102.0)
        done = dict(out2) | dict(out2.waiting)
        assert done.get(pod.uid) and done.get(pod2.uid)
        assert aud_b.sweep("manual", now=102.5)["detections"] == {}
        return report(r), done

    both(case)


# -- run_loop's fencing forget ----------------------------------------------------

def fenced_world(P, quota_max=10000):
    bus = P.bus()
    sched = P.scheduler()
    ea = P.le.LeaderElector(bus, "koord-scheduler", "a", lease_duration=1.0)
    eb = P.le.LeaderElector(bus, "koord-scheduler", "b", lease_duration=1.0)
    P.wiring.wire_scheduler(bus, sched, elector=ea)
    bus.apply(P.Kind.NODE, "n0", P.node("n0", cpu=10000, mem=64000))
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric("n0", update_time=0.0))
    bus.apply(P.Kind.QUOTA, "a", P.T.QuotaSpec(
        name="a", min=P.res({CPU: 10000}), max=P.res({CPU: quota_max})))
    return bus, sched, ea, eb


def steal_mid_round(P, sched, ea, eb, now):
    """run_loop(once=True) whose round meets a lease stolen mid-round."""
    orig = sched.schedule_pending

    def steal(now=None):
        assert eb.tick(2.0)
        return orig(now=now)

    sched.schedule_pending = steal
    cmd = cmd_of(P)
    rc = cmd.run_loop(sched, cmd.SchedulerConfig(schedule_interval_seconds=0.0),
                      once=True, elector=ea, now_fn=lambda: now,
                      log=lambda *a: None)
    sched.schedule_pending = orig
    return rc


def test_run_loop_forgets_assumed_on_mid_round_deposal():
    def case(P):
        bus, sched, ea, eb = fenced_world(P)
        bus.apply(P.Kind.POD, "default/low", P.pod(
            "low", {CPU: 8000}, quota="a", priority=10, node_name="n0"))
        bus.apply(P.Kind.POD, "default/small", P.pod(
            "small", {CPU: 1000}, quota="a", priority=100))
        bus.apply(P.Kind.POD, "default/big", P.pod(
            "big", {CPU: 8000}, quota="a", priority=100))
        assert steal_mid_round(P, sched, ea, eb, 0.0) == 1
        assert sched.cache.assumed == {}
        assert "default/small" in sched.cache.pending
        assert sched.cache.pending["default/small"].node_name is None
        info = sched.quota_registry.manager_for_quota("a").quotas["a"]
        assert info.used[CPU] == 8000
        assert bus.get(P.Kind.POD, "default/low") is not None
        eb.release()
        assert not ea.tick(4.0)
        assert ea.tick(4.5)
        out = sched.schedule_pending(now=4.5)
        assert out["default/small"] == "n0"
        return dict(out)

    both(case)


def test_fencing_forget_rolls_back_committed_reservation():
    def case(P):
        bus, sched, ea, eb = fenced_world(P)
        resv = P.T.ReservationSpec(
            name="r0", node_name="n0", state=P.T.ReservationState.AVAILABLE,
            requests=P.res({CPU: 2000}), owner_labels={"app": "x"},
            allocate_once=True, ttl=0)
        bus.apply(P.Kind.RESERVATION, "r0", resv)
        bus.apply(P.Kind.POD, "default/low", P.pod(
            "low", {CPU: 6000}, quota="a", priority=10, node_name="n0"))
        bus.apply(P.Kind.POD, "default/small", P.pod(
            "small", {CPU: 1000}, quota="a", priority=100,
            labels={"app": "x"}))
        bus.apply(P.Kind.POD, "default/big", P.pod(
            "big", {CPU: 9000}, quota="a", priority=100))
        assert steal_mid_round(P, sched, ea, eb, 0.0) == 1
        assert sched.cache.assumed == {}
        assert "default/small" in sched.cache.pending
        assert resv.allocated.get(P.X.ResourceName.CPU, 0) == 0
        assert resv.allocated_pod_uids == []
        assert resv.state is P.T.ReservationState.AVAILABLE
        assert sched._resv_inflight == {}
        return sorted(sched.cache.pending)

    both(case)


def test_fencing_forget_covers_barrier_opened_gang_pods():
    def case(P):
        bus, sched, ea, eb = fenced_world(P)
        bus.apply(P.Kind.GANG, "g", P.T.GangSpec(
            name="g", min_member=2, mode=P.T.GangMode.NON_STRICT))
        bus.apply(P.Kind.POD, "default/low", P.pod(
            "low", {CPU: 7000}, quota="a", priority=10, node_name="n0"))
        assert ea.tick(0.0)
        bus.apply(P.Kind.POD, "default/m1", P.pod(
            "m1", {CPU: 1000}, gang="g", quota="a", priority=50,
            preemptible=False))
        out1 = sched.schedule_pending(now=0.0)
        assert "default/m1" in out1.waiting
        bus.apply(P.Kind.POD, "default/m2", P.pod(
            "m2", {CPU: 1000}, gang="g", quota="a", priority=50,
            preemptible=False))
        bus.apply(P.Kind.POD, "default/big", P.pod(
            "big", {CPU: 8000}, quota="a", priority=100))
        assert steal_mid_round(P, sched, ea, eb, 0.5) == 1
        assert sched.cache.assumed == {}
        for uid in ("default/m1", "default/m2"):
            assert sched.cache.pending[uid].node_name is None
            assert not sched.cache.pending[uid].waiting_permit
        info = sched.quota_registry.manager_for_quota("a").quotas["a"]
        assert info.used[CPU] == 7000
        assert sched._waiting == {}
        record = sched.gang_manager.gangs["g"]
        assert record.waiting == set() and record.bound == set()
        return sorted(sched.cache.pending)

    both(case)
