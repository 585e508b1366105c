"""The port's pipelined tick path (``scheduler/pipeline.py``) and the
fixed-cadence ``run_loop`` (``cmd/scheduler.py``), on the CPU.

The cases of the reference's ``tests/test_pipeline.py`` run against the
port: the overlapped loop equals the serial loop tick for tick (plain
churn, then quota, a gang whose Permit barrier bridges pipelined rounds
and reservation consumption), a fenced publish rolls back and still ends
equal to a serial loop fenced at the same tick, ``run_loop`` sleeps from
round start, runs pipelined, surfaces a deferred fence in its standby
branch and chains pre-existing flip hooks, and an abandoned publisher
drops its late retire. Then one seeded churn at 60 nodes runs through
the port's pipelined loop, the port's serial loop and the JAX package's
serial loop: equal tick for tick and in the end state.

Not ported: the reference's sidecar-SIGKILL chaos case (its supervisor
and failover backend are not ported yet) and its zero-recompile case
(the port compiles no XLA program)."""

import importlib
import threading

import numpy as np
import pytest

from test_torch_colocation import PORT, REF

CPU, MEM = 0, 1
N_NODES = 12

pipeline_mod = importlib.import_module("koordinator_tpu_torch.scheduler.pipeline")
cmd = importlib.import_module("koordinator_tpu_torch.cmd.scheduler")
TickPipeline = pipeline_mod.TickPipeline
FencingError = PORT.le.FencingError


def _seed_bus(P, bus, rng, n_nodes=N_NODES, quota_cpu=16000, gangs=("g",),
              n_resv=1):
    for i in range(n_nodes):
        bus.apply(P.Kind.NODE, f"n{i}", P.node(f"n{i}", cpu=64000,
                                               mem=131072))
        bus.apply(P.Kind.NODE_METRIC, f"n{i}", P.metric(
            f"n{i}", usage={CPU: int(rng.integers(0, 8000)),
                            MEM: int(rng.integers(0, 16384))},
            update_time=90.0))
    bus.apply(P.Kind.QUOTA, "team", P.T.QuotaSpec(
        name="team", min=P.res({CPU: 0, MEM: 0}),
        max=P.res({CPU: quota_cpu, MEM: 32768})))
    for g in gangs:
        bus.apply(P.Kind.GANG, g, P.T.GangSpec(
            name=g, min_member=3, mode=P.T.GangMode.NON_STRICT))
    for r in range(n_resv):
        bus.apply(P.Kind.RESERVATION, f"r{r}", P.T.ReservationSpec(
            name=f"r{r}", requests=P.res({CPU: 8000, MEM: 8192}),
            allocatable=P.res({CPU: 8000, MEM: 8192}),
            owner_labels={"team": "ml"}, node_name=f"n{r}",
            state=P.T.ReservationState.AVAILABLE, allocate_once=False))


def _arrivals(P, rng, t, per_tick=4, gang="g", gang_ticks=(3, 5)):
    """The reference's per-tick stream: plain churn, a quota'd pod every
    tick, gang members split across two ticks (the Permit barrier must
    bridge pipelined rounds), reservation-matching pods on a cadence."""
    pods = [P.pod(f"t{t}p{j}", {CPU: int(rng.integers(200, 2000)),
                                MEM: int(rng.integers(128, 2048))})
            for j in range(per_tick)]
    pods.append(P.pod(f"t{t}q", {CPU: 1000, MEM: 512}, quota="team"))
    if t == gang_ticks[0]:
        pods += [P.pod(f"{gang}{k}", {CPU: 800, MEM: 256}, gang=gang)
                 for k in range(2)]
    if t == gang_ticks[1]:
        pods.append(P.pod(f"{gang}2", {CPU: 800, MEM: 256}, gang=gang))
    if t % 4 == 1:
        pods.append(P.pod(f"t{t}r", {CPU: 700, MEM: 256},
                          labels={"team": "ml"}))
    return pods


def _drive(mode, P=PORT, seed=7, ticks=10, publish_wrap=None,
           boundary_drain=False, world=None):
    """Seeded bus-wired churn through either loop. Returns (per-tick
    placement log, bus, scheduler, pipeline or None, fenced count)."""
    world = world or {}
    rng = np.random.default_rng(seed)
    bus = P.bus()
    sched = P.scheduler()
    P.wiring.wire_scheduler(bus, sched)
    _seed_bus(P, bus, rng, **world.get("seed", {}))
    fence = P.le.FencingError
    log, fenced, pipeline = [], 0, None
    if mode == "pipelined":
        pub = sched.publish_result
        if publish_wrap is not None:
            pub = publish_wrap(pub)
        pipeline = TickPipeline(
            sched, publish=pub, log=lambda *a: None,
            on_result=lambda out: log.append(sorted(out.items())))
    elif publish_wrap is not None:
        pub = publish_wrap(sched.publish_result)
    n_nodes = world.get("seed", {}).get("n_nodes", N_NODES)
    for t in range(ticks):
        now = 100.0 + t
        if boundary_drain and pipeline is not None:
            # retire (and roll back) the previous tick before this tick's
            # arrivals, as a cadence gap would in run_loop
            try:
                pipeline.drain("boundary")
            except fence:
                fenced += 1
                sched.forget_assumed_unbound()
        for i in rng.choice(n_nodes, 2, replace=False):
            name = f"n{int(i)}"
            bus.apply(P.Kind.NODE_METRIC, name, P.metric(
                name, usage={CPU: int(rng.integers(0, 12000)),
                             MEM: int(rng.integers(0, 32768))},
                update_time=now))
        for pod in _arrivals(P, rng, t, **world.get("arrivals", {})):
            bus.apply(P.Kind.POD, pod.uid, pod)
        if mode == "pipelined":
            while True:
                try:
                    pipeline.submit_round(now=now)
                except fence:
                    fenced += 1
                    sched.forget_assumed_unbound()
                    continue
                break
            pipeline.prestage(now=now)
        elif publish_wrap is None:
            log.append(sorted(sched.schedule_pending(now=now).items()))
        else:
            out = sched.commit_tick(sched.begin_tick(now))
            try:
                pub(out)
            except fence:
                fenced += 1
                sched.forget_assumed_unbound()
                continue
            log.append(sorted(out.items()))
    if pipeline is not None:
        try:
            pipeline.drain("shutdown")
        except fence:
            fenced += 1
            sched.forget_assumed_unbound()
        pipeline.stop()
    return log, bus, sched, pipeline, fenced


def _end_state(P, bus, sched):
    """Node accounting, reservation credit and quota used, as plain data."""
    cluster = importlib.import_module(f"{P.root}.state.cluster")
    ops = importlib.import_module(f"{P.root}.ops.binpack")
    arrays = cluster.lower_nodes(P.wiring.snapshot_from_bus(bus, now=500.0))
    return dict(
        names=list(arrays.names),
        fields={f: np.asarray(getattr(arrays, f)).tolist()
                for f in ops.STAGED_NODE_FIELDS},
        resv={name: (_ints(r.allocated), getattr(r.state, "value", r.state),
                     sorted(r.allocated_pod_uids))
              for name, r in bus.list(P.Kind.RESERVATION).items()},
        used={n: i.used.tolist()
              for n, i in sched.quota_manager.quotas.items()})


def _ints(res):
    return {int(k): v for k, v in (res or {}).items()}


def _bound(bus, kind, uids):
    return {u for u in uids if getattr(bus.get(kind, u), "node_name", None)}


def test_pipeline_smoke_overlapped_identity():
    ticks = 6
    p_log, p_bus, p_sched, pipeline, fenced = _drive("pipelined", ticks=ticks)
    s_log, s_bus, s_sched, _, _ = _drive("serial", ticks=ticks)
    assert fenced == 0 and len(p_log) == ticks
    for t, (a, b) in enumerate(zip(p_log, s_log)):
        assert a == b, f"placements diverged at tick {t}"
    assert _end_state(PORT, p_bus, p_sched) == _end_state(PORT, s_bus, s_sched)
    assert p_sched.model.staged_cache.last_path == "delta"
    status = pipeline.status()
    assert status["rounds"] == ticks and not status["inflight"]


def test_pipeline_property_mixed_churn_identity():
    ticks = 10
    p_log, p_bus, p_sched, _, _ = _drive("pipelined", ticks=ticks)
    s_log, s_bus, s_sched, _, _ = _drive("serial", ticks=ticks)
    assert len(p_log) == len(s_log) == ticks
    for t, (a, b) in enumerate(zip(p_log, s_log)):
        assert a == b, f"placements diverged at tick {t}"
    assert _end_state(PORT, p_bus, p_sched) == _end_state(PORT, s_bus, s_sched)
    gang = {"default/g0", "default/g1", "default/g2"}
    assert _bound(p_bus, PORT.Kind.POD, gang) == gang
    assert not p_sched._waiting
    assert p_bus.get(PORT.Kind.RESERVATION, "r0").allocated_pod_uids


def _fencing_wrap(fail_round):
    """Publish wrapper raising FencingError on the Nth publish call."""
    def wrap(inner):
        calls = {"n": 0}

        def publish(out):
            i = calls["n"]
            calls["n"] += 1
            if i == fail_round:
                raise FencingError("injected: deposed mid-publish")
            inner(out)

        return publish

    return wrap


def test_pipeline_fenced_publish_rollback_identity():
    """A FencingError in tick 4's publish, while tick 5's staging is warm:
    the deferred abort surfaces at the next round boundary, the forget
    releases the unpublished round, and the run ends equal to a serial
    loop fenced at the same tick. (The reference ends with an auditor
    sweep, not ported yet; here nothing stays assumed and the staged
    state equals a fresh lowering of the cache.)"""
    ticks, fail_round = 8, 4
    p_log, p_bus, p_sched, _, p_fenced = _drive(
        "pipelined", ticks=ticks, publish_wrap=_fencing_wrap(fail_round),
        boundary_drain=True)
    s_log, s_bus, s_sched, _, s_fenced = _drive(
        "serial", ticks=ticks, publish_wrap=_fencing_wrap(fail_round))
    assert p_fenced == s_fenced == 1
    assert len(p_log) == len(s_log) == ticks - 1
    for t, (a, b) in enumerate(zip(p_log, s_log)):
        assert a == b, f"placements diverged at surviving tick {t}"
    assert _end_state(PORT, p_bus, p_sched) == _end_state(PORT, s_bus, s_sched)
    assert not p_sched.cache.pending and not p_sched.cache.assumed
    snap = p_sched.cache.snapshot(now=200.0)
    p_sched.model.prestage(snap)
    cluster = importlib.import_module("koordinator_tpu_torch.state.cluster")
    ops = importlib.import_module("koordinator_tpu_torch.ops.binpack")
    fresh = cluster.lower_nodes(snap, **p_sched.model.lowering_kwargs())
    staged = p_sched.model.staged_cache.state
    for f in ops.STAGED_NODE_FIELDS:
        assert np.array_equal(getattr(staged, f).numpy(), getattr(fresh, f)), f


def test_run_loop_sleeps_from_round_start():
    ScheduleResult = importlib.import_module(
        "koordinator_tpu_torch.models.placement").ScheduleResult
    clock = {"t": 0.0}
    sleeps = []

    def sleep_fn(s):
        sleeps.append(round(s, 6))
        clock["t"] += s

    class StubScheduler:
        def schedule_pending(self, now=None):
            clock["t"] += 0.3
            return ScheduleResult({})

    rc = cmd.run_loop(
        StubScheduler(), cmd.SchedulerConfig(schedule_interval_seconds=1.0),
        max_rounds=3, now_fn=lambda: clock["t"], sleep_fn=sleep_fn,
        log=lambda *a: None)
    assert rc == 0
    assert sleeps == [0.7, 0.7]


def _wired(seed, n_pods):
    rng = np.random.default_rng(seed)
    bus = PORT.bus()
    sched = PORT.scheduler()
    PORT.wiring.wire_scheduler(bus, sched)
    _seed_bus(PORT, bus, rng)
    for j in range(n_pods):
        pod = PORT.pod(f"p{j}", {CPU: 500 + 10 * j, MEM: 256})
        bus.apply(PORT.Kind.POD, pod.uid, pod)
    return bus, sched


def test_run_loop_pipelined_mode_places_and_drains():
    bus, sched = _wired(3, 5)
    pipeline = TickPipeline(sched, log=lambda *a: None)
    skipped = cmd.run_loop(
        sched, cmd.SchedulerConfig(schedule_interval_seconds=0.0),
        max_rounds=3, log=lambda *a: None, pipeline=pipeline)
    assert skipped == 0
    assert _bound(bus, PORT.Kind.POD, [f"default/p{j}" for j in range(5)]) \
        == {f"default/p{j}" for j in range(5)}
    assert pipeline.status()["stopped"]
    assert "tick-pipeline" in sched.services.names()


def test_publisher_relowers_bind_dirty_rows_after_publish():
    bus, sched = _wired(5, 4)
    calls = []
    prestage = sched.model.prestage

    def spy(snap):
        calls.append((threading.current_thread().name, snap.now))
        return prestage(snap)

    sched.model.prestage = spy
    published = []
    pipeline = TickPipeline(
        sched, log=lambda *a: None,
        publish=lambda out: (published.append(len(calls)),
                             sched.publish_result(out)))
    try:
        pipeline.submit_round(now=100.0)
        pipeline.drain("test")
    finally:
        pipeline.stop()
    # the epilogue's publish lands first, then the publisher re-lowers
    # the rows it dirtied, at the round's own time
    assert published == [0]
    assert calls == [("koord-tick-publisher", 100.0)]
    assert _bound(bus, PORT.Kind.POD, [f"default/p{j}" for j in range(4)]) \
        == {f"default/p{j}" for j in range(4)}


def test_run_loop_standby_surfaces_deferred_fence():
    bus, sched = _wired(17, 1)
    calls = {"n": 0}

    def pub(out):
        i = calls["n"]
        calls["n"] += 1
        if i == 0:
            raise FencingError("injected: deposed mid-publish")
        sched.publish_result(out)

    forgets = []
    orig_forget = sched.forget_assumed_unbound

    def forget():
        out = orig_forget()
        forgets.append(len(out))
        return out

    sched.forget_assumed_unbound = forget

    class FlakyElector:
        retry_period = 0.0

        def __init__(self):
            self.pattern = [True, False, True]

        def tick(self, now):
            return self.pattern.pop(0) if self.pattern else True

    logs = []
    pipeline = TickPipeline(sched, publish=pub, log=lambda *a: None)
    skipped = cmd.run_loop(
        sched, cmd.SchedulerConfig(schedule_interval_seconds=0.0),
        max_rounds=2, log=lambda *a: logs.append(" ".join(map(str, a))),
        pipeline=pipeline, elector=FlakyElector())
    assert skipped == 1
    assert forgets and forgets[0] >= 1
    fence_idx = next(i for i, m in enumerate(logs) if "leadership lost" in m)
    standby_idx = next(i for i, m in enumerate(logs) if "standby" in m)
    assert fence_idx < standby_idx
    assert _bound(bus, PORT.Kind.POD, ["default/p0"]) == {"default/p0"}


def test_run_loop_chains_preexisting_flip_hooks():
    ScheduleResult = importlib.import_module(
        "koordinator_tpu_torch.models.placement").ScheduleResult
    fired = []

    class FakeBackend:
        on_flip_back = None
        on_flip_degraded = None

    backend = FakeBackend()
    backend.on_flip_back = lambda: fired.append("prev-back")
    backend.on_flip_degraded = lambda: fired.append("prev-degraded")
    prevs = (backend.on_flip_back, backend.on_flip_degraded)

    class StubTick:
        inflight = None
        at = 0.0

    class StubScheduler:
        class model:
            backend = None

            @staticmethod
            def prestage(snap):
                pass

        class cache:
            @staticmethod
            def snapshot(now=None):
                return None

        class services:
            _m = {}

            @classmethod
            def register(cls, name, fn):
                cls._m[name] = fn

        def begin_tick(self, now=None, trigger=None):
            return StubTick()

        def commit_tick(self, tick):
            return ScheduleResult({})

    sched = StubScheduler()
    sched.model.backend = backend

    def sleep_fn(_s):
        backend.on_flip_degraded()
        backend.on_flip_back()

    pipeline = TickPipeline(sched, log=lambda *a: None)
    cmd.run_loop(sched, cmd.SchedulerConfig(schedule_interval_seconds=0.0),
                 max_rounds=2, log=lambda *a: None, pipeline=pipeline,
                 sleep_fn=sleep_fn)
    assert fired == ["prev-degraded", "prev-back"]
    assert (backend.on_flip_back, backend.on_flip_degraded) == prevs


def test_stop_abandoned_worker_drops_late_retire():
    bus, sched = _wired(23, 1)
    release = threading.Event()
    results, logs = [], []

    def wedged_pub(out):
        assert release.wait(10.0), "test deadlock: release never set"

    pipeline = TickPipeline(
        sched, publish=wedged_pub,
        log=lambda *a: logs.append(" ".join(map(str, a))),
        on_result=results.append)
    pipeline.STOP_TIMEOUT_S = 0.2
    try:
        pipeline.submit_round(now=100.0)
        pipeline.stop()
        assert pipeline.status()["stopped"]
        assert any("abandoning" in m for m in logs)
    finally:
        release.set()
    pipeline._worker.join(timeout=10.0)
    assert not pipeline._worker.is_alive(), "abandoned worker never exited"
    assert results == []
    assert pipeline.status()["last_round"] is None
    assert any("dropping the rest of the retire" in m for m in logs)


def test_run_loop_auditor_not_ported():
    """``run_loop(auditor=...)`` (once refused, now ported): a pipelined
    loop with a sweep due every round drains before each sweep, so no
    sweep reads a half-retired round as drift
    (``tests/test_torch_auditor.py`` holds the auditor against the
    reference)."""
    auditor_mod = importlib.import_module(
        "koordinator_tpu_torch.scheduler.auditor")
    bus = PORT.bus()
    sched = PORT.scheduler()
    PORT.wiring.wire_scheduler(bus, sched)
    _seed_bus(PORT, bus, np.random.default_rng(3))
    for pod in _arrivals(PORT, np.random.default_rng(4), 0):
        bus.apply(PORT.Kind.POD, pod.uid, pod)
    aud = auditor_mod.StateAuditor(sched, bus, interval_rounds=1)
    clock = iter(range(100))
    assert cmd.run_loop(
        sched, cmd.SchedulerConfig(schedule_interval_seconds=0.0,
                                   pipelined_ticks=True),
        auditor=aud, max_rounds=3, now_fn=lambda: 100.0 + next(clock),
        sleep_fn=lambda s: None, log=lambda *a: None) == 0
    assert aud.status()["sweeps"] == {"periodic": 3}
    assert aud.status()["detections"] == {}
    assert sched.cache.pods  # the rounds placed pods


# -- one seeded churn: port pipelined == port serial == reference serial -------

CHURN = {"seed": {"n_nodes": 60, "quota_cpu": 5000, "gangs": ("wave",),
                  "n_resv": 3},
         "arrivals": {"per_tick": 12, "gang": "wave", "gang_ticks": (2, 4)}}


def test_seeded_churn_pipelined_equals_serial_and_reference():
    ticks = 8
    p_log, p_bus, p_sched, pipeline, fenced = _drive(
        "pipelined", seed=31, ticks=ticks, world=CHURN)
    s_log, s_bus, s_sched, _, _ = _drive(
        "serial", seed=31, ticks=ticks, world=CHURN)
    r_log, r_bus, r_sched, _, _ = _drive(
        "serial", P=REF, seed=31, ticks=ticks, world=CHURN)
    assert fenced == 0 and len(p_log) == len(s_log) == len(r_log) == ticks
    for t in range(ticks):
        assert p_log[t] == s_log[t], f"pipelined != serial at tick {t}"
        assert s_log[t] == r_log[t], f"port != reference at tick {t}"
    end = _end_state(PORT, p_bus, p_sched)
    assert end == _end_state(PORT, s_bus, s_sched)
    assert end == _end_state(REF, r_bus, r_sched)
    # the world exercised what it was built for: the quota capped some
    # pods, the gang crossed rounds at the Permit barrier, reservations
    # were consumed
    gang = {f"default/wave{k}" for k in range(3)}
    assert _bound(p_bus, PORT.Kind.POD, gang) == gang
    assert any(uid.endswith("q") and node is None
               for tick in p_log for uid, node in tick)
    assert any(p_bus.get(PORT.Kind.RESERVATION, f"r{r}").allocated_pod_uids
               for r in range(3))
    assert pipeline.status()["rounds"] == ticks


def test_run_loop_drives_defrag_and_rebalance_on_their_cadence():
    """The fixed-cadence loop's post-round control plane: the defrag
    controller reconciles every round, the rebalance sweep fires once a
    ``rebalance_interval_s`` has passed since the last one."""
    ScheduleResult = importlib.import_module(
        "koordinator_tpu_torch.models.placement").ScheduleResult
    clock = {"t": 0.0}
    calls = []

    class StubScheduler:
        def schedule_pending(self, now=None):
            return ScheduleResult({})

        def rebalance_sweep(self, plugin, now=None):
            calls.append(("sweep", plugin, now))
            return ["default/victim"]

    class Defrag:
        def maybe_reconcile(self, now=None):
            calls.append(("defrag", now))

    def sleep_fn(s):
        clock["t"] += 1.0

    skipped = cmd.run_loop(
        StubScheduler(), cmd.SchedulerConfig(schedule_interval_seconds=1.0,
                                             rebalance_interval_s=2.0),
        max_rounds=5, now_fn=lambda: clock["t"], sleep_fn=sleep_fn,
        log=lambda *a: None, defrag=Defrag(), rebalance="plugin")
    assert skipped == 0
    assert [c for c in calls if c[0] == "defrag"] == [
        ("defrag", float(t)) for t in range(5)]
    assert [c for c in calls if c[0] == "sweep"] == [
        ("sweep", "plugin", 2.0), ("sweep", "plugin", 4.0)]
