"""The port's plugin chain (``scheduler/framework.py``, the incremental
plugins, ``Scheduler.schedule_one`` and rounds with the BatchedPlacement
gate off) against the JAX package's, on the CPU.

Each case of the reference's ``tests/test_scheduler.py`` and
``tests/test_scheduler_regressions.py`` that drives the per-pod cycle
runs once per package (a :class:`Pkg` holds one package's modules) from
the same plain data; the two runs must give the same outcomes, caches,
quota and reservation accounting, and the reference's own expectations
must hold in both. Then: the framework's order (a failing Reserve
unreserves every plugin up to and including itself, the argmax is the
first max in node order), ``schedule_one``'s ElasticQuota nomination and
its evictions, a gate-off round through ``TickPipeline`` equal to the
serial loop, and the batched round equal to the chain on the world of
``chip_smoke.py`` phase 17 (b), cut to 120 nodes x 64 pods. Bit for bit,
no tolerance."""

import importlib

import numpy as np

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.testing import plugin_chain

CPU, MEM = 0, 1


class Pkg:
    """One package's modules, and its Scheduler on the CPU."""

    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.port = root == "koordinator_tpu_torch"
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.fw = mod("scheduler.framework")
        self.plugins = mod("scheduler.plugins")
        self.lowering = mod("scheduler.plugins.lowering")
        self.reservation = mod("scheduler.plugins.reservation")
        self.cluster = mod("state.cluster")
        self.cmd = mod("cmd.scheduler")
        self.explain = mod("obs.explain")
        self.oracle = mod("oracle.scheduler")
        self.Scheduler = mod("scheduler.scheduler").Scheduler
        self.PlacementModel = mod("models.placement").PlacementModel

    def model(self, **kw):
        if self.port:
            return self.PlacementModel(device="cpu", **kw)
        return self.PlacementModel(use_pallas=False, **kw)

    def scheduler(self, n_nodes=3, cpu=16000, mem=32768, usage=500,
                  model=None, **kw):
        """The reference tests' ``_mk_scheduler``: ``n_nodes`` equal
        nodes with a fresh metric."""
        s = self.Scheduler(model=model or self.model(), cluster_total=self.res(
            {CPU: n_nodes * cpu, MEM: n_nodes * mem}), **kw)
        for i in range(n_nodes):
            s.add_node(self.node(f"n{i}", cpu, mem))
            s.update_node_metric(self.metric(f"n{i}", {CPU: usage}))
        return s

    def res(self, d):
        return {self.X.ResourceName(k): v for k, v in d.items()}

    def node(self, name, cpu=16000, mem=32768, **kw):
        return self.T.NodeSpec(name=name, allocatable=self.res(
            {CPU: cpu, MEM: mem}), **kw)

    def metric(self, name, usage, update_time=99.0, **kw):
        return self.T.NodeMetric(node_name=name, node_usage=self.res(usage),
                                 update_time=update_time, **kw)

    def pod(self, name, requests, **kw):
        return self.T.PodSpec(name=name, requests=self.res(requests), **kw)

    def quota(self, name, mn, mx, **kw):
        return self.T.QuotaSpec(name=name, min=self.res(mn),
                                max=self.res(mx), **kw)

    def resv(self, name, req, node, allocated=None, **kw):
        return self.T.ReservationSpec(
            name=name, requests=self.res(req), allocatable=self.res(req),
            allocated=self.res(allocated or {}), node_name=node,
            state=self.T.ReservationState.AVAILABLE, **kw)

    def snapshot(self, spec):
        return testing.build_snapshot(spec, self.T, self.X.ResourceName)


PORT, REF = Pkg("koordinator_tpu_torch"), Pkg("koordinator_tpu")
BOTH = (REF, PORT)


def outcome(o):
    return (o.status, o.node, o.reason, o.victims)


def placed(s):
    return {u: p.node_name for u, p in s.cache.pods.items()}


def quota_used(s):
    return {name: np.asarray(info.used).tolist()
            for name, info in s.quota_manager.quotas.items()}


def resv_view(s):
    return {name: ({int(k): v for k, v in r.allocated.items()},
                   list(r.allocated_pod_uids), r.state.value)
            for name, r in s.cache.reservations.items()}


def test_incremental_path_binds():
    got = []
    for P in BOTH:
        s = P.scheduler(3)
        s.add_pod(P.pod("a", {CPU: 2000}))
        o = s.schedule_one("default/a", now=100.0)
        assert o.status == "bound" and o.node is not None
        assert "default/a" in s.cache.pods
        got.append((outcome(o), placed(s)))
    assert got[0] == got[1]


def test_incremental_gang_waits_then_allows():
    got = []
    for P in BOTH:
        s = P.scheduler(3)
        s.update_gang(P.T.GangSpec(name="g", min_member=2))
        s.add_pod(P.pod("g0", {CPU: 1000}, gang="g"))
        s.add_pod(P.pod("g1", {CPU: 1000}, gang="g"))
        o0 = s.schedule_one("default/g0", now=100.0)
        assert o0.status == "waiting"  # the Permit barrier
        held = dict(s._waiting)
        o1 = s.schedule_one("default/g1", now=100.0)
        assert o1.status == "bound"
        # the barrier opened: g0 is bindable, its assume still open
        assert not s._waiting and "default/g0" in s.cache.assumed
        assert not s.cache.pods["default/g0"].waiting_permit
        got.append((outcome(o0), held, outcome(o1), placed(s)))
    assert got[0] == got[1]


def test_reservation_held_for_owner():
    got = []
    for P in BOTH:
        s = P.scheduler(1, cpu=10000)
        s.update_reservation(P.resv("resv", {CPU: 8000}, "n0",
                                    owner_labels={"team": "ml"}))
        # a non-owner asking 4 cores: only 2 are unreserved
        s.add_pod(P.pod("other", {CPU: 4000}))
        assert s.schedule_pending(now=100.0)["default/other"] is None
        # an owner asking 4 cores gets the reserved capacity
        s.add_pod(P.pod("mlpod", {CPU: 4000}, labels={"team": "ml"}))
        o = s.schedule_one("default/mlpod", now=100.0)
        assert o.status == "bound" and o.node == "n0"
        resv = s.cache.reservations["resv"]
        assert resv.allocated.get(P.X.ResourceName.CPU) == 4000
        pod = s.cache.pods["default/mlpod"]
        assert pod.annotations.get(
            P.X.ANNOTATION_RESERVATION_ALLOCATED) == "resv"
        got.append((outcome(o), resv_view(s), dict(pod.annotations)))
    assert got[0] == got[1]


def test_quota_gates_incremental_path():
    got = []
    for P in BOTH:
        s = P.scheduler(2)
        s.update_quota(P.quota("t", {CPU: 1000}, {CPU: 3000}))
        s.add_pod(P.pod("a", {CPU: 3000}, quota="t"))
        s.add_pod(P.pod("b", {CPU: 1000}, quota="t"))
        a = s.schedule_one("default/a", now=100.0)
        b = s.schedule_one("default/b", now=100.0)
        assert a.status == "bound" and b.status == "unschedulable"
        assert "quota" in b.reason
        got.append((outcome(a), outcome(b), quota_used(s)))
    assert got[0] == got[1]


def test_quota_used_released_when_pod_removed():
    got = []
    for P in BOTH:
        s = P.scheduler(2)
        s.update_quota(P.quota("t", {CPU: 0, MEM: 0}, {CPU: 4000, MEM: 131072}))
        pod = P.pod("a", {CPU: 4000}, quota="t")
        s.add_pod(pod)
        assert s.schedule_one("default/a", now=100.0).status == "bound"
        used = quota_used(s)
        s.remove_pod(pod)
        info = s.quota_manager.quotas["t"]
        assert info.used[CPU] == 0 and info.request[CPU] == 0
        s.add_pod(P.pod("b", {CPU: 4000}, quota="t"))
        assert s.schedule_one("default/b", now=101.0).status == "bound"
        got.append((used, quota_used(s)))
    assert got[0] == got[1]


def test_debug_scores_recorded_by_the_chain():
    got = []
    for P in BOTH:
        s = P.scheduler(2)
        s.debug.dump_scores = True
        s.add_pod(P.pod("a", {CPU: 1000}))
        o = s.schedule_one("default/a", now=100.0)
        assert s.debug.scores and "n0" in s.debug.scores[0]["scores"]
        assert o.scores == s.debug.scores[0]["scores"]
        got.append(s.debug.scores)
    assert got[0] == got[1]


def _transformer_chain(P):
    calls = []
    R = P.X.ResourceName

    class Transformer(P.fw.Plugin):
        name = "T"

        def before_pre_filter(self, state, snapshot, pod):
            calls.append("before_pre_filter")
            return False

        def after_pre_filter(self, state, snapshot, pod):
            calls.append("after_pre_filter")

        def before_filter(self, state, snapshot, pod, node):
            calls.append(f"before_filter:{node.name}")
            # the Filter phase sees a ten times bigger request
            bigger = P.pod(pod.name, {CPU: pod.requests[R.CPU] * 10})
            return bigger, node

        def before_score(self, state, snapshot, pod, nodes):
            calls.append("before_score")
            return pod, [n for n in nodes if n.name == "n1"]

    class Fit(P.fw.Plugin):
        name = "Fit"

        def filter(self, state, snapshot, pod, node):
            if pod.requests[R.CPU] <= node.allocatable[R.CPU]:
                return P.fw.Status.success()
            return P.fw.Status.unschedulable_("too big")

    snapshot = P.T.ClusterSnapshot(nodes=[
        P.node("n0", 20000), P.node("n1", 20000), P.node("small", 1000)])
    out = P.fw.SchedulingFramework([Transformer(), Fit()]).schedule_one(
        snapshot, P.pod("p", {CPU: 2000}))
    return outcome(out), calls


def test_full_transformer_chain():
    got = [_transformer_chain(P) for P in BOTH]
    assert got[0] == got[1]
    (status, node, _, _), calls = got[1]
    # the 20000 request fits n0 and n1, not small; before_score keeps n1
    assert (status, node) == ("bound", "n1")
    assert calls[0] == "before_pre_filter"
    assert calls.index("after_pre_filter") < calls.index("before_filter:n0")
    assert "before_score" in calls


def test_after_pre_filter_runs_on_rejection():
    got = []
    for P in BOTH:
        seen = []

        class Gate(P.fw.Plugin):
            name = "Gate"

            def pre_filter(self, state, snapshot, pod):
                return P.fw.Status.unschedulable_("nope")

            def after_pre_filter(self, state, snapshot, pod):
                seen.append("after")

            def post_filter(self, state, snapshot, pod):
                seen.append("post")

        out = P.fw.SchedulingFramework([Gate()]).schedule_one(
            P.T.ClusterSnapshot(nodes=[P.node("n0")]), P.pod("p", {}))
        assert out.status == "unschedulable" and out.reason == "Gate: nope"
        # AfterPreFilter once, and the refused PreFilter reaches PostFilter
        assert seen == ["after", "post"]
        got.append((outcome(out), seen))
    assert got[0] == got[1]


def _ordering_chain(P):
    """Three plugins: the second's Reserve fails; every score ties."""
    log = []

    class Recorder(P.fw.Plugin):
        def __init__(self, name, fail=False):
            self.name, self.fail = name, fail

        def score(self, state, snapshot, pod, node):
            return 7

        def reserve(self, state, snapshot, pod, node):
            log.append(f"reserve:{self.name}:{node.name}")
            if self.fail:
                return P.fw.Status.unschedulable_("full")
            return P.fw.Status.success()

        def unreserve(self, state, snapshot, pod, node):
            log.append(f"unreserve:{self.name}")

    nodes = [P.node(f"n{i}") for i in range(3)]
    fw = P.fw.SchedulingFramework([Recorder("a"), Recorder("b", True),
                                   Recorder("c")])
    out = fw.schedule_one(P.T.ClusterSnapshot(nodes=nodes),
                          P.pod("p", {CPU: 1}))
    failed = list(log)
    ok = P.fw.SchedulingFramework([Recorder("a"), Recorder("c")]
                                  ).schedule_one(
        P.T.ClusterSnapshot(nodes=nodes), P.pod("p", {CPU: 1}))
    return outcome(out), failed, outcome(ok)


def test_reserve_failure_unreserves_through_the_failing_plugin():
    got = [_ordering_chain(P) for P in BOTH]
    assert got[0] == got[1]
    out, log, ok = got[1]
    assert out[:3] == ("unschedulable", None, "b: full")
    # the argmax is the first max in node order: every score ties at n0
    assert log == ["reserve:a:n0", "reserve:b:n0", "unreserve:a",
                   "unreserve:b"]
    assert ok[:2] == ("bound", "n0")


def test_node_selector_enforced_on_both_paths():
    got = []
    for P in BOTH:
        def mk():
            s = P.Scheduler(model=P.model())
            for name, zone in (("n0", "a"), ("n1", "b")):
                s.add_node(P.node(name, labels={"zone": zone}))
                s.update_node_metric(P.metric(name, {}))
            return s

        sb = mk()
        sb.add_pod(P.pod("pin-b", {CPU: 1000}, node_selector={"zone": "b"}))
        sb.add_pod(P.pod("pin-c", {CPU: 1000}, node_selector={"zone": "c"}))
        out = sb.schedule_pending(now=100.0)
        assert out["default/pin-b"] == "n1" and out["default/pin-c"] is None
        si = mk()
        si.add_pod(P.pod("pin-b", {CPU: 1000}, node_selector={"zone": "b"}))
        si.add_pod(P.pod("pin-c", {CPU: 1000}, node_selector={"zone": "c"}))
        ob = si.schedule_one("default/pin-b", now=100.0)
        oc = si.schedule_one("default/pin-c", now=100.0)
        assert ob.node == "n1" and oc.status == "unschedulable"
        got.append((dict(out), outcome(ob), outcome(oc)))
    assert got[0] == got[1]


def test_batch_and_incremental_agree():
    got = []
    for P in BOTH:
        def build():
            s = P.scheduler(4)
            rng = np.random.default_rng(3)
            for i in range(12):
                s.add_pod(P.pod(
                    f"p{i}", {CPU: int(rng.choice([1000, 2000, 4000])),
                              MEM: int(rng.choice([1024, 4096]))},
                    priority=int(rng.choice([9500, 5500]))))
            return s

        batch = dict(build().schedule_pending(now=100.0))
        s_inc = build()
        pending = list(s_inc.cache.pending.values())
        inc = {}
        for i in P.cluster.schedule_order(pending):
            uid = pending[i].uid
            inc[uid] = s_inc.schedule_one(uid, now=100.0).node
        gate_off = build()
        gate_off.batched_placement = False
        assert batch == inc == dict(gate_off.schedule_pending(now=100.0))
        got.append(batch)
    assert got[0] == got[1]


def test_reservation_unreserve_subtracts_clamped_delta():
    got = []
    for P in BOTH:
        s = P.scheduler(1, cpu=10000)
        # prior owners hold 8 of the reservation's 10 cores
        s.update_reservation(P.resv(
            "resv", {CPU: 10000}, "n0", allocated={CPU: 8000},
            owner_labels={"team": "ml"}, allocate_once=False))
        plugin = P.plugins.ReservationPlugin()
        snap = s.cache.snapshot(now=100.0)
        pod = P.pod("p", {CPU: 5000}, labels={"team": "ml"})
        state = P.fw.CycleState()
        assert plugin.before_pre_filter(state, snap, pod)
        view = P.lowering.node_view(state, snap)
        credit = {k: np.asarray(v).tolist()
                  for k, v in view.extra_used.items()}
        plugin.reserve(state, snap, pod, snap.nodes[0])
        resv = snap.reservations[0]
        assert resv.allocated[P.X.ResourceName.CPU] == 10000  # clamped
        plugin.unreserve(state, snap, pod, snap.nodes[0])
        # only the 2000 actually added is subtracted
        assert resv.allocated[P.X.ResourceName.CPU] == 8000
        got.append((credit, resv_view(s)))
    assert got[0] == got[1]


def test_schedule_one_nominates_and_evicts():
    """ElasticQuota's PostFilter inside the chain: a full node's
    high-priority pod of the same quota group evicts lower-priority
    residents (quota admission refused reaches PostFilter too), stays
    pending, and binds in a later cycle."""
    got = []
    for P in BOTH:
        s = P.scheduler(1, cpu=10000, mem=32768)
        s.update_quota(P.quota("q", {CPU: 0, MEM: 0}, {CPU: 10000, MEM: 32768}))
        for k in range(3):
            s.add_pod(P.pod(f"low{k}", {CPU: 3000, MEM: 1024}, quota="q",
                            priority=10))
            assert s.schedule_one(f"default/low{k}",
                                  now=100.0).status == "bound"
        s.add_pod(P.pod("high", {CPU: 5000, MEM: 1024}, quota="q",
                        priority=100))
        o = s.schedule_one("default/high", now=101.0)
        assert o.status == "nominated" and o.node == "n0" and o.victims
        assert all(v not in s.cache.pods for v in o.victims)
        assert "default/high" in s.cache.pending
        again = s.schedule_one("default/high", now=102.0)
        assert again.status == "bound"
        got.append((outcome(o), outcome(again), placed(s), quota_used(s)))
    assert got[0] == got[1]


def _gate_off_loop(P, pipelined, ticks=6):
    from test_torch_colocation import PORT as CPORT, REF as CREF
    from test_torch_pipeline import _arrivals, _seed_bus

    C = CPORT if P.port else CREF
    rng = np.random.default_rng(7)
    bus = C.bus()
    sched = C.scheduler()
    sched.batched_placement = False
    C.wiring.wire_scheduler(bus, sched)
    _seed_bus(C, bus, rng)
    log, pipeline = [], None
    if pipelined:
        TickPipeline = importlib.import_module(
            f"{P.root}.scheduler.pipeline").TickPipeline
        pipeline = TickPipeline(
            sched, publish=sched.publish_result, log=lambda *a: None,
            on_result=lambda out: log.append(sorted(out.items())))
    for t in range(ticks):
        now = 100.0 + t
        for i in rng.choice(12, 2, replace=False):
            name = f"n{int(i)}"
            bus.apply(C.Kind.NODE_METRIC, name, C.metric(
                name, usage={CPU: int(rng.integers(0, 12000)),
                             MEM: int(rng.integers(0, 32768))},
                update_time=now))
        for pod in _arrivals(C, rng, t):
            bus.apply(C.Kind.POD, pod.uid, pod)
        if pipelined:
            pipeline.submit_round(now=now)
            pipeline.prestage(now=now)
        else:
            out = sched.schedule_pending(now=now)
            sched.publish_result(out)
            log.append(sorted(out.items()))
    if pipeline is not None:
        pipeline.drain("shutdown")
        pipeline.stop()
    return log, placed(sched), quota_used(sched)


def test_gate_off_round_through_tick_pipeline_equals_serial():
    """With the BatchedPlacement gate off, ``begin_tick`` hands
    ``commit_tick`` an already-completed round: through ``TickPipeline``
    it equals the serial loop tick for tick, and the JAX package's serial
    loop."""
    pipelined = _gate_off_loop(PORT, True)
    serial = _gate_off_loop(PORT, False)
    assert pipelined == serial
    assert _gate_off_loop(REF, False) == serial
    # the gang whose barrier bridges two rounds bound
    assert {"default/g0", "default/g1", "default/g2"} <= set(serial[1])


def test_pending_tick_carries_the_completed_round():
    s = PORT.scheduler(2)
    s.batched_placement = False
    s.add_pod(PORT.pod("a", {CPU: 1000}))
    tick = s.begin_tick(now=100.0)
    assert tick.inflight is None and tick.result is not None
    assert s.commit_tick(tick) is tick.result
    assert tick.result["default/a"] is not None


def test_batched_round_equals_chain_on_the_phase17_world():
    """The world of chip_smoke.py phase 17 (b), cut to 120 x 64: the
    batched round, the gate-off round and both JAX paths place alike,
    and consume the same reservations."""
    spec = plugin_chain.chain_world_spec(n_nodes=120, n_pending=64,
                                         n_resv=16)
    got = {}
    for P in BOTH:
        for batched in (True, False):
            s = P.Scheduler(model=P.model())
            s.batched_placement = batched
            testing.feed_scheduler(s, P.snapshot(spec))
            out = s.schedule_pending(now=spec["now"])
            got[P.root, batched] = (dict(out), dict(out.waiting),
                                    resv_view(s), quota_used(s))
    want = got["koordinator_tpu", True]
    assert all(v == want for v in got.values())
    placements = want[0]
    assert 0 < sum(n is not None for n in placements.values()) < 64
    assert any(uids for _, uids, _ in want[2].values())


def test_batched_preemption_evicts_same_round_placements_the_chain_keeps():
    """A disagreement between the two paths that the JAX package has too,
    written down rather than "fixed": the batched round decides as the
    chain does, then runs its PostFilter over the pods it could not
    place, against a snapshot that holds this round's placements, so a
    higher-priority pod of a quota group can evict a lower-priority pod
    of its group placed in the same round. The chain, placing in
    priority order, never meets that case. Both packages do exactly
    this on this world (seed 25 of the phase-17 world, cut)."""
    spec = plugin_chain.chain_world_spec(seed=25, n_nodes=120, n_pending=64)
    got = {}
    for P in BOTH:
        runs = {}
        for batched in (True, False):
            s = P.Scheduler(model=P.model())
            s.batched_placement = batched
            testing.feed_scheduler(s, P.snapshot(spec))
            out = s.schedule_pending(now=spec["now"])
            runs[batched] = (dict(out), dict(out.nominations or {}),
                             placed(s))
        decided, nominated, cache = runs[True]
        chain_decided, chain_nominated, chain_cache = runs[False]
        assert decided == chain_decided and nominated and not chain_nominated
        evicted = set(chain_cache) - set(cache)
        assert evicted and set(cache) < set(chain_cache)
        assert all(decided[u] == chain_cache[u] for u in evicted)
        assert {chain_cache[u] for u in evicted} <= set(nominated.values())
        got[P.root] = runs
    assert got["koordinator_tpu"] == got["koordinator_tpu_torch"]


def test_run_loop_once_over_a_gate_off_round():
    """``run_loop(once=True)`` over a scheduler built with the
    BatchedPlacement gate off: one per-pod round on the wall clock, the
    same placements as the reference's loop."""
    import time

    spec = plugin_chain.chain_world_spec(n_nodes=40, n_pending=24,
                                         now=time.time())
    got = {}
    for P in BOTH:
        extra = {} if P.port else dict(warm_pool=False, host_fallback_cells=0)
        config = P.cmd.SchedulerConfig(
            feature_gates="BatchedPlacement=false", **extra)
        s = (P.cmd.build_scheduler(config, device="cpu") if P.port
             else P.cmd.build_scheduler(config))
        assert not s.batched_placement
        testing.feed_scheduler(s, P.snapshot(spec))
        lines = []
        assert P.cmd.run_loop(s, config, once=True, log=lines.append) == 0
        assert lines[-1].startswith("round: ")
        got[P.root] = (placed(s), sorted(s.cache.pending), lines[-1])
    assert got["koordinator_tpu"] == got["koordinator_tpu_torch"]
    assert got["koordinator_tpu_torch"][0]
