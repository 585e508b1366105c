"""The port's streaming serving mode (``scheduler/streaming.py``), its
``cmd/scheduler.py`` wiring and the arrival traces
(``testing/arrivals.py``), on the CPU.

The cases of the reference's ``tests/test_streaming.py`` run against the
port under a fake clock and ``pump()``: the trigger order (deadline and
watermark, lanes, the interval floor, the trigger on the round's trace),
the intake's shed policy, expiry, the bit-identity of a streaming run and
the fixed-round replay of its batches, the gate's units, the bus-watch
intake and the flip-hook chaining; one real-clock smoke asserts outcomes
only. Then: every trace generator equals the reference's for the same
seed, a heavy-tail trace fed through both packages' ``StreamingLoop``
gives the same round log and placements, and an elector gates the
trigger and hands the intake over on promotion."""

import dataclasses
import importlib
import time

import numpy as np
import pytest

from test_torch_colocation import PORT, REF

CPU, MEM = 0, 1
N_NODES = 8

streaming = importlib.import_module("koordinator_tpu_torch.scheduler.streaming")
arrivals = importlib.import_module("koordinator_tpu_torch.testing.arrivals")
cmd = importlib.import_module("koordinator_tpu_torch.cmd.scheduler")
components = importlib.import_module("koordinator_tpu_torch.metrics.components")
timeline = importlib.import_module("koordinator_tpu_torch.obs.timeline")
ScheduleResult = importlib.import_module(
    "koordinator_tpu_torch.models.placement").ScheduleResult
StreamingConfig = streaming.StreamingConfig
OUTCOME_BOUND = streaming.OUTCOME_BOUND
OUTCOME_EXPIRED = streaming.OUTCOME_EXPIRED
OUTCOME_SHED = streaming.OUTCOME_SHED


def _seed_bus(P, bus, n_nodes=N_NODES):
    for i in range(n_nodes):
        bus.apply(P.Kind.NODE, f"n{i}", P.node(f"n{i}", cpu=64000,
                                               mem=131072))
        bus.apply(P.Kind.NODE_METRIC, f"n{i}", P.metric(
            f"n{i}", update_time=90.0))


def _wire(clock, config=None, pipelined=False, n_nodes=N_NODES,
          timelines=None, P=PORT):
    """A bus-wired scheduler + StreamingLoop of package ``P`` on a fake
    clock."""
    mod = importlib.import_module(f"{P.root}.scheduler.streaming")
    bus = P.bus()
    sched = P.scheduler()
    if timelines is not None:
        sched.timelines = timelines
    P.wiring.wire_scheduler(bus, sched)
    _seed_bus(P, bus, n_nodes)
    loop = mod.StreamingLoop(
        sched,
        apply_fn=lambda pod: bus.apply(P.Kind.POD, pod.uid, pod),
        delete_fn=lambda uid: bus.delete(P.Kind.POD, uid),
        config=config or mod.StreamingConfig(), pipelined=pipelined,
        clock=lambda: clock[0], now_fn=lambda: clock[0],
        log=lambda *a: None)
    return bus, sched, loop


def _pod(name, cpu=500, mem=256, qos="NONE", gang=None, P=PORT):
    return P.pod(name, {CPU: cpu, MEM: mem}, qos=P.X.QoSClass[qos],
                 gang=gang)


# -- trigger determinism (fake clock) ------------------------------------------

class TestTrigger:
    def test_deadline_fires_first_for_lone_urgent_pod(self):
        clock = [100.0]
        cfg = StreamingConfig(watermark=64,
                              lane_deadline_s=(0.002, 0.010, 0.050))
        bus, sched, loop = _wire(clock, cfg)
        assert loop.submit(_pod("urgent", qos="SYSTEM"),
                           now=clock[0]) == "queued"
        assert loop.due(clock[0]) is None
        assert loop.gate.next_deadline() == pytest.approx(100.002)
        clock[0] = 100.0015
        assert loop.pump(clock[0]) is None
        clock[0] = 100.002
        assert loop.pump(clock[0]) == "deadline"
        assert loop.gate.outcome("default/urgent") == OUTCOME_BOUND
        loop.stop()

    def test_watermark_fires_first_for_a_burst(self):
        clock = [200.0]
        cfg = StreamingConfig(watermark=16,
                              lane_deadline_s=(0.002, 0.010, 0.050))
        bus, sched, loop = _wire(clock, cfg)
        for j in range(40):
            assert loop.submit(_pod(f"b{j}"), now=clock[0]) == "queued"
        assert loop.due(clock[0]) == "watermark"
        assert loop.pump(clock[0]) == "watermark"
        st = loop.status()
        assert st["rounds"] == 1, "the burst fragmented into rounds"
        assert st["gate"]["bound"] == 40
        reason, _now, uids = loop.round_log[-1]
        assert reason == "watermark" and len(uids) == 40
        loop.stop()

    def test_deadline_ordering_across_lanes(self):
        clock = [300.0]
        cfg = StreamingConfig(watermark=64,
                              lane_deadline_s=(0.002, 0.010, 0.050))
        bus, sched, loop = _wire(clock, cfg)
        loop.submit(_pod("be-pod", qos="BE"), now=clock[0])
        loop.submit(_pod("ls-pod", qos="LS"), now=clock[0])
        loop.submit(_pod("sys-pod", qos="SYSTEM"), now=clock[0])
        assert loop.gate.next_deadline() == pytest.approx(300.002)
        clock[0] = 300.002
        assert loop.pump(clock[0]) == "deadline"
        assert loop.status()["gate"]["bound"] == 3
        loop.stop()

    def test_min_round_interval_floors_the_dispatch_rate(self):
        clock = [400.0]
        cfg = StreamingConfig(watermark=1, min_round_interval_s=0.020,
                              lane_deadline_s=(0.002, 0.010, 0.050))
        bus, sched, loop = _wire(clock, cfg)
        loop.submit(_pod("p0"), now=clock[0])
        assert loop.pump(clock[0]) == "watermark"
        loop.submit(_pod("p1"), now=clock[0])
        assert loop.pump(clock[0]) is None
        clock[0] += 0.021
        assert loop.pump(clock[0]) == "watermark"
        loop.stop()

    def test_trigger_reason_lands_on_the_round_trace(self):
        trace = importlib.import_module("koordinator_tpu_torch.obs.trace")
        clock = [500.0]
        bus, sched, loop = _wire(clock, StreamingConfig(watermark=1))
        trace.TRACER.clear()
        loop.submit(_pod("traced"), now=clock[0])
        loop.pump(clock[0])
        rounds = [e for e in trace.TRACER.events() if e["name"] == "round"]
        assert rounds and rounds[-1]["args"]["trigger"] == "watermark"
        loop.stop()


# -- intake shed policy ------------------------------------------------------------

class TestIntakeShed:
    def test_be_shed_first_and_outranked_arrival_refused(self):
        clock = [100.0]
        bus, sched, loop = _wire(clock, StreamingConfig(watermark=64,
                                                        capacity=3))
        for name, qos in (("be0", "BE"), ("be1", "BE"), ("ls0", "LS")):
            assert loop.submit(_pod(name, qos=qos), now=clock[0]) == "queued"
        assert loop.submit(_pod("ls1", qos="LS"), now=clock[0]) == "queued"
        assert loop.gate.outcome("default/be1") == OUTCOME_SHED
        assert bus.get(PORT.Kind.POD, "default/be1") is None
        assert loop.submit(_pod("be2", qos="BE"), now=clock[0]) == "shed"
        assert bus.get(PORT.Kind.POD, "default/be2") is None
        assert loop.gate.outcome("default/be2") == OUTCOME_SHED
        st = loop.status()["gate"]
        assert st["shed"]["capacity"] == 2
        assert st["submitted"] == 5
        loop.stop()

    def test_timeline_capacity_drop_is_backpressure_not_silence(self):
        clock = [100.0]
        tl = timeline.PodTimelines(capacity=2)
        bus, sched, loop = _wire(clock, StreamingConfig(watermark=64),
                                 timelines=tl)
        labels = {"lane": "ls", "reason": "timeline-capacity"}
        before = components.STREAM_SHED.value(labels)
        for j in range(3):
            assert loop.submit(_pod(f"p{j}"), now=clock[0]) == "queued"
        st = loop.status()
        assert st["gate"]["shed"]["timeline-capacity"] == 1
        assert st["latency"]["dropped"] == 1
        assert components.STREAM_SHED.value(labels) == before + 1
        clock[0] += 0.010
        loop.pump(clock[0])
        assert loop.gate.outcome("default/p2") == OUTCOME_BOUND
        loop.stop()

    def test_unplaceable_pod_expires_typed_after_max_rounds(self):
        clock = [100.0]
        cfg = StreamingConfig(watermark=64, max_pod_rounds=2,
                              lane_deadline_s=(0.002, 0.010, 0.050))
        bus, sched, loop = _wire(clock, cfg)
        loop.submit(_pod("whale", cpu=100000, mem=999999), now=clock[0])
        clock[0] += 0.011
        assert loop.pump(clock[0]) == "deadline"
        assert loop.gate.outcome("default/whale") is None
        clock[0] += 0.011
        assert loop.pump(clock[0]) == "deadline"
        assert loop.gate.outcome("default/whale") == OUTCOME_EXPIRED
        assert bus.get(PORT.Kind.POD, "default/whale") is None
        assert loop.status()["gate"]["shed"]["deadline-exceeded"] == 1
        assert loop.gate.unresolved() == 0
        loop.stop()


# -- bit-identity vs the fixed-round replay ------------------------------------------

def _replay_fixed(round_log, pods_by_uid, gangs, n_nodes=N_NODES, P=PORT):
    """The recorded per-round batches through the fixed-round loop."""
    bus = P.bus()
    sched = P.scheduler()
    P.wiring.wire_scheduler(bus, sched)
    _seed_bus(P, bus, n_nodes)
    for name, spec in gangs.items():
        bus.apply(P.Kind.GANG, name, spec)
    for _reason, now, uids in round_log:
        for uid in uids:
            pod = pods_by_uid[uid]
            bus.apply(P.Kind.POD, pod.uid, pod)
        sched.schedule_pending(now=now)
    return bus, sched


def _placements(bus, P=PORT):
    return {u: getattr(p, "node_name", None)
            for u, p in bus.list(P.Kind.POD).items()}


def _accounting(bus, P=PORT):
    cluster = importlib.import_module(f"{P.root}.state.cluster")
    ops = importlib.import_module(f"{P.root}.ops.binpack")
    arrays = cluster.lower_nodes(P.wiring.snapshot_from_bus(bus, now=500.0))
    return list(arrays.names), {f: np.asarray(getattr(arrays, f)).tolist()
                                for f in ops.STAGED_NODE_FIELDS}


def _stream(loop, clock, pairs, t0=100.0):
    """Submit a trace's pods at their times (pumping after each), then
    drain the tail past every deadline. Returns ``{uid: pod copy}``."""
    pods_by_uid = {}
    for at, pod in pairs:
        clock[0] = t0 + at
        assert loop.submit(pod, now=clock[0]) == "queued"
        pods_by_uid[pod.uid] = dataclasses.replace(pod)
        loop.pump(clock[0])
    for _ in range(64):
        clock[0] += 0.050
        if loop.pump(clock[0]) is None and loop.gate.depth() == 0:
            break
    return pods_by_uid


@pytest.mark.parametrize("kind", ["heavy-tail", "gang-wave"])
def test_streaming_bit_identical_to_fixed_round_replay(kind):
    clock = [100.0]
    cfg = StreamingConfig(watermark=8, lane_deadline_s=(0.002, 0.010, 0.050))
    bus, sched, loop = _wire(clock, cfg)
    trace = arrivals.make_trace(kind, seed=11, duration_s=1.0,
                                rate_pods_per_s=60.0)
    pairs, gangs = arrivals.trace_pods(trace)
    for name, spec in gangs.items():
        bus.apply(PORT.Kind.GANG, name, spec)
    pods_by_uid = _stream(loop, clock, pairs)
    st = loop.status()["gate"]
    assert st["submitted"] == len(pairs)
    assert loop.gate.unresolved() == 0
    assert st["submitted"] == (st["bound"] + st["shed"]["capacity"]
                               + st["shed"]["deadline-exceeded"])
    r_bus, _ = _replay_fixed(list(loop.round_log), pods_by_uid, gangs)
    assert _placements(bus) == _placements(r_bus)
    assert _accounting(bus) == _accounting(r_bus)
    loop.stop()


def test_arrival_traces_are_seed_deterministic():
    for kind in arrivals.TRACE_KINDS:
        a = arrivals.make_trace(kind, seed=5, duration_s=2.0,
                                rate_pods_per_s=40)
        b = arrivals.make_trace(kind, seed=5, duration_s=2.0,
                                rate_pods_per_s=40)
        c = arrivals.make_trace(kind, seed=6, duration_s=2.0,
                                rate_pods_per_s=40)
        assert a.arrivals == b.arrivals, kind
        assert a.arrivals != c.arrivals, kind
        assert all(x.at <= y.at for x, y in zip(a.arrivals, a.arrivals[1:]))
        assert len(a) > 0


def test_burst_storm_has_mid_trace_storms():
    tr = arrivals.make_trace("burst-storm", seed=2, duration_s=4.0,
                             rate_pods_per_s=10.0, bursts=2, burst_pods=32)
    storm = [a for a in tr if "s0" in a.name or "s1" in a.name]
    assert len(storm) == 64
    assert all(0.1 * 4.0 <= a.at <= 0.9 * 4.0 + 0.01 for a in storm)


class _NullHist:
    def observe(self, *a, **k):
        pass


def test_rolling_window_excludes_stale_samples():
    t = [1000.0]
    tl = timeline.PodTimelines(clock=lambda: t[0], histogram=_NullHist())
    tl.submit("old", "ls")
    t[0] += 0.5
    tl.published("old")
    t[0] += 100.0
    tl.submit("fresh", "ls")
    t[0] += 0.25
    tl.published("fresh")
    assert tl.stats()["all"]["count"] == 2
    rolling = tl.stats(window_s=30.0)
    assert rolling["all"]["count"] == 1
    assert rolling["all"]["p50_s"] == pytest.approx(0.25)
    status = tl.status()
    assert status["rolling"]["window_s"] == tl.ROLLING_WINDOW_S
    assert status["rolling"]["all"]["count"] == 1


def test_smoke_streaming_pipelined_real_clock():
    """A short real run (pipelined rounds, the loop thread, wall-clock
    triggers): outcomes only — every pod binds, and the replay of the
    recorded batches places the same."""
    bus = PORT.bus()
    sched = PORT.scheduler()
    PORT.wiring.wire_scheduler(bus, sched)
    _seed_bus(PORT, bus)
    cfg = StreamingConfig(watermark=8, lane_deadline_s=(0.002, 0.010, 0.030))
    loop = streaming.StreamingLoop(
        sched, apply_fn=lambda pod: bus.apply(PORT.Kind.POD, pod.uid, pod),
        delete_fn=lambda uid: bus.delete(PORT.Kind.POD, uid),
        config=cfg, pipelined=True, log=lambda *a: None).start()
    pods_by_uid = {}
    try:
        for wave in range(3):
            for j in range(12):
                pod = _pod(f"w{wave}p{j}", qos="SYSTEM" if j == 0 else "NONE")
                pods_by_uid[pod.uid] = dataclasses.replace(pod)
                assert loop.submit(pod) == "queued"
            time.sleep(0.05)
        assert loop.drain(timeout_s=30.0), loop.status()
    finally:
        loop.stop()
    st = loop.status()
    assert st["gate"]["bound"] == st["gate"]["submitted"] == 36
    assert st["rounds"] >= 1
    assert st["latency"]["latency"]["all"]["count"] == 36
    r_bus, _ = _replay_fixed(list(loop.round_log), pods_by_uid, {})
    assert _placements(bus) == _placements(r_bus)


def test_run_loop_streaming_branch_validates_wiring():
    with pytest.raises(ValueError, match="StreamingLoop"):
        cmd.run_loop(PORT.scheduler(), cmd.SchedulerConfig(streaming=True))


def test_build_streaming_loop_bus_intake_and_debug_surface():
    bus = PORT.bus()
    sched = PORT.scheduler()
    PORT.wiring.wire_scheduler(bus, sched)
    _seed_bus(PORT, bus)
    config = cmd.SchedulerConfig(streaming=True, stream_watermark=2)
    loop = cmd.build_streaming_loop(sched, bus, config, log=lambda *a: None)
    try:
        ext = _pod("external")
        bus.apply(PORT.Kind.POD, ext.uid, ext)
        assert loop.gate.depth() == 1
        loop.submit(_pod("mine"))
        assert loop.gate.depth() == 2
        assert loop.status()["gate"]["submitted"] == 2
        assert "streaming" in sched.services.names()
        assert sched.services.query("streaming")["gate"]["submitted"] == 2
        loop.pump()
        assert loop.gate.outcome("default/external") == OUTCOME_BOUND
        assert loop.gate.outcome("default/mine") == OUTCOME_BOUND
    finally:
        loop.stop()


def test_gate_forget_on_bus_delete():
    clock = [100.0]
    bus, sched, loop = _wire(clock, StreamingConfig(watermark=64))
    loop.submit(_pod("doomed"), now=clock[0])
    assert loop.gate.depth() == 1
    bus.delete(PORT.Kind.POD, "default/doomed")
    assert loop.gate.depth() == 0
    assert loop.gate.unresolved() == 0
    loop.stop()


def test_gate_direct_unit_watermark_vs_deadline():
    t = [0.0]
    gate = streaming.ArrivalGate(StreamingConfig(
        watermark=2, lane_deadline_s=(0.001, 0.010, 0.050)),
        clock=lambda: t[0])
    gate.admit("a", 2, now=0.0)
    assert gate.due(0.0) is None
    assert gate.next_deadline() == pytest.approx(0.05)
    gate.admit("b", 0, now=0.0)
    assert gate.due(0.0) == "watermark"
    batch = gate.take_round()
    assert [e.uid for e in batch] == ["b", "a"]
    assert gate.due(0.0) is None


def test_gate_resolves_queued_entry_placed_by_overlapped_round():
    t = [0.0]
    gate = streaming.ArrivalGate(StreamingConfig(
        watermark=64, lane_deadline_s=(0.002, 0.010, 0.050)),
        clock=lambda: t[0])
    gate.admit("p", 1, now=0.0)
    assert [e.uid for e in gate.take_round()] == ["p"]
    gate.resolve_round(ScheduleResult({"p": None}), now=0.0)
    assert gate.depth() == 1 and gate.outcome("p") is None
    counts = gate.resolve_round(ScheduleResult({"p": "n3"}), now=0.1)
    assert counts["bound"] == 1
    assert gate.outcome("p") == OUTCOME_BOUND
    assert gate.depth() == 0 and gate.unresolved() == 0
    gate.admit("g", 1, now=0.2)
    gate.resolve_round(ScheduleResult({"g": "n1"}, waiting={"g": "n1"}),
                       now=0.2)
    assert gate.unresolved() == 1
    gate.resolve_round(ScheduleResult({"g": "n1"}), now=0.3)
    assert gate.outcome("g") == OUTCOME_BOUND
    assert gate.unresolved() == 0


def test_observe_readmits_recreated_pod():
    clock = [100.0]
    bus, sched, loop = _wire(clock, StreamingConfig(watermark=64))
    loop.submit(_pod("phoenix"), now=clock[0])
    clock[0] += 0.011
    loop.pump(clock[0])
    assert loop.gate.outcome("default/phoenix") == OUTCOME_BOUND
    bus.delete(PORT.Kind.POD, "default/phoenix")
    reborn = _pod("phoenix")
    bus.apply(PORT.Kind.POD, reborn.uid, reborn)
    loop.observe(reborn, now=clock[0])
    assert loop.gate.depth() == 1, "recreated pod was not re-admitted"
    clock[0] += 0.011
    loop.pump(clock[0])
    assert loop.gate.unresolved() == 0
    loop.stop()


def test_pipelined_loop_wires_failover_flip_quiesce():
    calls = []

    class StubBackend:
        on_flip_back = None
        on_flip_degraded = None

    bus = PORT.bus()
    sched = PORT.scheduler()
    sched.model.backend = StubBackend()
    prev = sched.model.backend.on_flip_back = lambda: calls.append("prev")
    PORT.wiring.wire_scheduler(bus, sched)
    _seed_bus(PORT, bus)
    loop = streaming.StreamingLoop(
        sched, apply_fn=lambda pod: bus.apply(PORT.Kind.POD, pod.uid, pod),
        pipelined=True, log=lambda *a: None)
    try:
        assert sched.model.backend.on_flip_back is not prev
        sched.model.backend.on_flip_back()
        assert calls == ["prev"], "the pre-existing hook must chain"
        assert sched.model.backend.on_flip_degraded is not None
    finally:
        loop.stop()
    assert sched.model.backend.on_flip_back is prev
    assert sched.model.backend.on_flip_degraded is None


def test_fire_round_requeues_batch_on_untyped_failure():
    clock = [100.0]
    bus, sched, loop = _wire(clock, StreamingConfig(watermark=1))
    loop.submit(_pod("p0"), now=clock[0])
    sched.schedule_pending = lambda **kw: (_ for _ in ()).throw(
        RuntimeError("injected"))
    with pytest.raises(RuntimeError, match="injected"):
        loop.fire_round("watermark", now=clock[0])
    assert loop.gate.depth() == 1, "the batch leaked out of the queue"
    assert loop.gate.unresolved() == 1
    loop.stop()


# -- the port against the reference -------------------------------------------------

def _trace_record(mod, trace):
    return (trace.kind, trace.seed, trace.duration_s, trace.rate_pods_per_s,
            [(a.at, a.name, a.lane, a.cpu, a.memory, a.gang, a.qos.value)
             for a in trace.arrivals])


def _pods_record(mod, trace):
    pairs, gangs = mod.trace_pods(trace)
    pods = [(at, p.name, p.uid, {int(k): v for k, v in p.requests.items()},
             p.qos.value, p.gang) for at, p in pairs]
    return pods, {n: (g.min_member, g.mode.value) for n, g in gangs.items()}


@pytest.mark.parametrize("kind", ["diurnal", "heavy-tail", "burst-storm",
                                  "gang-wave"])
def test_trace_generators_match_reference(kind):
    ref = importlib.import_module("koordinator_tpu.testing.arrivals")
    for seed, kw in ((3, {}), (17, {"duration_s": 2.5,
                                    "rate_pods_per_s": 120.0})):
        got = arrivals.make_trace(kind, seed, **kw)
        want = ref.make_trace(kind, seed, **kw)
        assert _trace_record(arrivals, got) == _trace_record(ref, want)
        assert _pods_record(arrivals, got) == _pods_record(ref, want)
        for regime in ("low", "saturating", 2.0):
            assert (_trace_record(arrivals, arrivals.regime_scale(got, regime))
                    == _trace_record(ref, ref.regime_scale(want, regime)))
    assert sorted(arrivals.TRACE_KINDS) == sorted(ref.TRACE_KINDS)
    with pytest.raises(ValueError, match="unknown arrival trace kind"):
        arrivals.make_trace("nope", 1)


#: ~150 heavy-tail pods on 40 nodes; a watermark of 3 lets both triggers fire
CROSS = dict(seed=19, duration_s=1.0, rate_pods_per_s=150.0, nodes=40,
             watermark=3)


def _cross_run(P, pipelined):
    mod = importlib.import_module(f"{P.root}.testing.arrivals")
    strm = importlib.import_module(f"{P.root}.scheduler.streaming")
    clock = [100.0]
    bus, sched, loop = _wire(
        clock, strm.StreamingConfig(watermark=CROSS["watermark"],
                                    lane_deadline_s=(0.002, 0.010, 0.050)),
        pipelined=pipelined, n_nodes=CROSS["nodes"], P=P)
    trace = mod.heavy_tail_trace(CROSS["seed"], duration_s=CROSS["duration_s"],
                                 rate_pods_per_s=CROSS["rate_pods_per_s"])
    pairs, _ = mod.trace_pods(trace)
    try:
        _stream(loop, clock, pairs)
    finally:
        loop.stop()
    status = loop.status()
    return dict(round_log=list(loop.round_log), placements=_placements(bus, P),
                accounting=_accounting(bus, P), gate=status["gate"],
                rounds=status["rounds"], n=len(pairs))


@pytest.fixture(scope="module")
def reference_stream():
    """The reference's run of the cross-package trace, shared so its XLA
    compiles happen once."""
    return _cross_run(REF, pipelined=False)


@pytest.mark.parametrize("pipelined", [False, True])
def test_streaming_loop_matches_reference(reference_stream, pipelined):
    got = _cross_run(PORT, pipelined)
    assert 120 <= got["n"] <= 180
    assert got["round_log"] == reference_stream["round_log"]
    assert got["placements"] == reference_stream["placements"]
    assert got["accounting"] == reference_stream["accounting"]
    assert got["gate"] == reference_stream["gate"]
    assert got["gate"]["bound"] == got["n"]
    triggers = {reason for reason, _, _ in got["round_log"]}
    assert triggers == {"watermark", "deadline"}


def test_attach_elector_gates_rounds_and_adopts_intake():
    """Standby: no round fires without the lease (pods applied by another
    component stay pending, outside the intake). Promotion: the tick that
    takes the expired lease adopts the pending pods into the intake, and
    their deadline fires the first round."""
    clock = [100.0]
    bus, sched, loop = _wire(clock, StreamingConfig(watermark=64))
    le = PORT.le
    holder = le.LeaderElector(bus, "koord-scheduler", "other")
    assert holder.tick(clock[0])
    seat = le.LeaderElector(bus, "koord-scheduler", "me")
    promoted = []
    seat.on_started_leading = lambda: promoted.append(clock[0])
    loop.attach_elector(seat)
    for j in range(3):
        pod = _pod(f"a{j}")
        bus.apply(PORT.Kind.POD, pod.uid, pod)
    for dt in (0.0, 0.02, 5.0, 14.0):
        clock[0] = 100.0 + dt
        assert loop.pump(clock[0]) is None
    assert loop.status()["rounds"] == 0 and loop.status()["leader"] is False
    assert loop.gate.depth() == 0 and len(sched.cache.pending) == 3
    clock[0] = 100.0 + le.LEASE_DURATION + 1.0   # the holder never renewed
    assert loop.pump(clock[0]) is None            # promoted, nothing due yet
    assert promoted == [clock[0]]
    assert loop.status()["leader"] is True and loop.gate.depth() == 3
    clock[0] += 0.011
    assert loop.pump(clock[0]) == "deadline"
    assert all(loop.gate.outcome(f"default/a{j}") == OUTCOME_BOUND
               for j in range(3))
    assert loop.status()["rounds"] == 1
    loop.stop()
    assert seat.on_started_leading is not None    # the original restored
    seat.on_started_leading()
    assert len(promoted) == 2 and loop.gate.depth() == 0
