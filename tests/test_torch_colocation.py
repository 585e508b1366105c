"""The port's bus, leader election and component wiring (``client/``)
against the JAX package's, on the CPU.

Each case of the reference's ``tests/test_client_bus.py`` and
``tests/test_leaderelection.py`` for the kinds and loops the port wires
runs once per package (a :class:`Pkg` holds one package's modules); the
two runs must record the same outcome, and the reference's own
expectations must hold in both. Then the full colocation loop (the
manager's overcommit PATCH, the wired Scheduler placing a BE wave on the
batch columns) runs round for round in both packages from one seeded
world."""

import dataclasses
import importlib
import json

import pytest

from koordinator_tpu_torch import testing

CPU, MEM, BCPU, BMEM = 0, 1, 2, 3


class Pkg:
    """One package's modules; its Scheduler and manager on the CPU."""

    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.client = mod("client")
        self.bus_mod = mod("client.bus")
        self.le = mod("client.leaderelection")
        self.wiring = mod("client.wiring")
        self.slo = mod("manager.sloconfig")
        self.nr = mod("manager.noderesource")
        self._sched = mod("scheduler.scheduler").Scheduler
        self._model = mod("models.placement").PlacementModel
        self.port = root == "koordinator_tpu_torch"

    @property
    def Kind(self):
        return self.bus_mod.Kind

    def bus(self):
        return self.bus_mod.APIServer()

    def scheduler(self, **kw):
        model = (self._model(device="cpu") if self.port
                 else self._model(use_pallas=False))
        if "cluster_total" in kw:
            kw["cluster_total"] = self.res(kw["cluster_total"])
        return self._sched(model=model, **kw)

    def controller(self, config=None):
        return self.nr.NodeResourceController(
            config, **({"device": "cpu"} if self.port else {}))

    def manager(self, bus, elector=None, config=None):
        return self.wiring.wire_manager(bus, self.controller(config),
                                        elector=elector)

    def res(self, d):
        return {self.X.ResourceName(k): v for k, v in d.items()}

    def node(self, name="n0", cpu=16000, mem=32768, **kw):
        return self.T.NodeSpec(name=name, allocatable=self.res(
            {CPU: cpu, MEM: mem}), **kw)

    def metric(self, name="n0", usage=None, update_time=99.0, **kw):
        return self.T.NodeMetric(node_name=name,
                                 node_usage=self.res(usage or {}),
                                 update_time=update_time, **kw)

    def pod(self, name, requests, **kw):
        return self.T.PodSpec(name=name, requests=self.res(requests), **kw)


PORT, REF = Pkg("koordinator_tpu_torch"), Pkg("koordinator_tpu")


SERIES = {
    "SCHEDULING_ATTEMPTS": [{"result": "scheduled"},
                            {"result": "unschedulable"}],
    "PENDING_PODS": [None],
    "BATCH_SOLVE_DURATION": [None],
    "PREEMPTION_ATTEMPTS": [None],
    "PREEMPT_VICTIMS": [{"outcome": o}
                        for o in ("selected", "reprieved", "evicted")],
    "DEFRAG_DRAINS": [None],
    "GANG_REJECTIONS": [None],
    "POD_E2E": [{"lane": lane} for lane in ("system", "ls", "be")],
}


def series_values(P):
    """The eight scheduler series of ``P``'s registry, by label."""
    comp = importlib.import_module(f"{P.root}.metrics.components")
    out = {}
    for name, labels in SERIES.items():
        metric = getattr(comp, name)
        for lab in labels:
            key = f"{name}{'' if lab is None else sorted(lab.items())}"
            out[key] = (metric.count(lab) if hasattr(metric, "count")
                        else metric.value(lab))
    return out


#: the reference's device observatory records a span per XLA compile;
#: the port's records one per nvcc build of its kernel library, which a
#: CPU run never makes
NOT_PORTED_SPANS = ("device-compile",)


def spans_of(P):
    """``P``'s TRACER: span counts by name, the rounds (from 0) and the
    open marks."""
    trace = importlib.import_module(f"{P.root}.obs.trace")
    events = [e for e in trace.TRACER.events()
              if e["name"] not in NOT_PORTED_SPANS]
    names = {}
    for e in events:
        names[e["name"]] = names.get(e["name"], 0) + 1
    rounds = sorted({e["round"] for e in events})
    return names, [r - rounds[0] for r in rounds], sorted(trace.TRACER.open_marks())


def _ints(res):
    return None if res is None else {int(k): v for k, v in res.items()}


def both(case):
    """Run ``case(pkg)`` in both packages; their records must be equal."""
    got, want = case(PORT), case(REF)
    assert got == want
    return got


# -- the bus ---------------------------------------------------------------------

def case_watch_replays_then_streams(P):
    bus = P.bus()
    bus.apply(P.Kind.NODE, "n0", P.T.NodeSpec(name="n0"))
    events = []
    bus.watch(P.Kind.NODE, lambda e, n, o: events.append((e.value, n)))
    assert events == [("ADDED", "n0")]
    bus.apply(P.Kind.NODE, "n0", P.T.NodeSpec(name="n0"))
    bus.apply(P.Kind.NODE, "n1", P.T.NodeSpec(name="n1"))
    bus.delete(P.Kind.NODE, "n0")
    assert events == [("ADDED", "n0"), ("MODIFIED", "n0"), ("ADDED", "n1"),
                      ("DELETED", "n0")]
    return events


def case_get_list(P):
    bus = P.bus()
    bus.apply(P.Kind.QUOTA, "t", P.T.QuotaSpec(name="t"))
    assert bus.get(P.Kind.QUOTA, "t").name == "t"
    assert list(bus.list(P.Kind.QUOTA)) == ["t"]
    assert bus.get(P.Kind.QUOTA, "missing") is None
    return list(bus.list(P.Kind.QUOTA))


def case_transact_is_atomic_and_reentrant(P):
    bus = P.bus()
    seen = []
    bus.watch(P.Kind.LEASE, lambda e, n, o: seen.append(n))

    def txn():
        bus.apply(P.Kind.LEASE, "l", "x")
        return bus.get(P.Kind.LEASE, "l")

    assert bus.transact(txn) == "x"
    return seen


def case_scheduler_follows_bus(P):
    bus = P.bus()
    s = P.scheduler()
    P.wiring.wire_scheduler(bus, s)
    bus.apply(P.Kind.NODE, "n0", P.node())
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric())
    bus.apply(P.Kind.POD, "default/p", P.pod("p", {CPU: 1000}))
    out = s.schedule_pending(now=100.0)
    assert out["default/p"] == "n0"
    assert "default/p" not in s.cache.assumed     # the publish confirmed it
    bus.delete(P.Kind.POD, "default/p")
    assert "default/p" not in s.cache.pods
    return dict(out)


def case_full_colocation_loop_over_bus(P):
    bus = P.bus()
    s = P.scheduler()
    P.wiring.wire_scheduler(bus, s)
    manager = P.manager(bus)
    bus.apply(P.Kind.NODE, "n0", P.node(cpu=32000, mem=65536))
    bus.apply(P.Kind.POD, "default/be", P.pod(
        "be", {BCPU: 4000}, qos=P.X.QoSClass.BE, priority=5500))
    out = [dict(s.schedule_pending(now=100.0))]
    assert out[0]["default/be"] is None
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric(
        usage={CPU: 6000, MEM: 8192}, sys_usage=P.res({CPU: 1000}),
        update_time=100.0))
    assert manager.reconcile(now=110.0) == 1
    patched = bus.get(P.Kind.NODE, "n0")
    assert patched.allocatable.get(P.X.ResourceName.BATCH_CPU, 0) > 4000
    out.append(dict(s.schedule_pending(now=120.0)))
    assert out[1]["default/be"] == "n0"
    return out, _ints(patched.allocatable)


def case_modified_pod_does_not_double_count_quota(P):
    bus = P.bus()
    s = P.scheduler()
    P.wiring.wire_scheduler(bus, s)
    bus.apply(P.Kind.QUOTA, "t", P.T.QuotaSpec(
        name="t", min=P.res({CPU: 1000}), max=P.res({CPU: 8000})))
    pod = P.pod("p", {CPU: 2000}, quota="t")
    bus.apply(P.Kind.POD, "default/p", pod)
    bus.apply(P.Kind.POD, "default/p", pod)
    bus.apply(P.Kind.POD, "default/p",
              dataclasses.replace(pod, labels={"x": "y"}))
    request = int(s.quota_manager.quotas["t"].request[CPU])
    assert request == 2000
    bus.delete(P.Kind.POD, "default/p")
    assert s.quota_manager.quotas["t"].request[CPU] == 0
    return request


def case_deletes_propagate_for_every_kind(P):
    dc = importlib.import_module(f"{P.root}.device.cache")
    hints = importlib.import_module(f"{P.root}.numa.hints")
    manager = importlib.import_module(f"{P.root}.numa.manager")
    topo = importlib.import_module(f"{P.root}.numa.topology")
    bus = P.bus()
    s = P.scheduler()
    P.wiring.wire_scheduler(bus, s)
    bus.apply(P.Kind.NODE, "n0", P.node(mem=0))
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric(update_time=1.0))
    bus.apply(P.Kind.QUOTA, "t", P.T.QuotaSpec(name="t",
                                               max=P.res({CPU: 100})))
    bus.apply(P.Kind.GANG, "g", P.T.GangSpec(name="g", min_member=2))
    bus.apply(P.Kind.RESERVATION, "r", P.T.ReservationSpec(
        name="r", node_name="n0", state=P.T.ReservationState.AVAILABLE))
    cpu_topo = topo.CPUTopology.build(sockets=1, nodes_per_socket=1,
                                      cores_per_node=2, threads_per_core=2)
    bus.apply(P.Kind.NODE_RESOURCE_TOPOLOGY, "n0", manager.TopologyOptions(
        cpu_topology=cpu_topo, policy=hints.NUMATopologyPolicy.NONE,
        numa_node_resources={0: P.res({CPU: 4000})}))
    bus.apply(P.Kind.DEVICE, "n0", [dc.DeviceEntry(
        minor=0, device_type=dc.DeviceType.GPU,
        resources={dc.DeviceResourceName.GPU_CORE: 100})])
    for kind, name in ((P.Kind.QUOTA, "t"), (P.Kind.GANG, "g"),
                       (P.Kind.RESERVATION, "r"), (P.Kind.NODE_METRIC, "n0"),
                       (P.Kind.NODE_RESOURCE_TOPOLOGY, "n0"),
                       (P.Kind.DEVICE, "n0")):
        bus.delete(kind, name)
    assert "t" not in s.cache.quotas and "t" not in s.quota_manager.quotas
    assert "g" not in s.cache.gangs and "g" not in s.gang_manager.gangs
    assert "r" not in s.cache.reservations
    assert "n0" not in s.cache.node_metrics
    assert not s.numa_manager.get_topology("n0").numa_node_resources
    assert not s.device_cache.get("n0").device_infos
    bus.delete(P.Kind.NODE, "n0")
    assert "n0" not in s.cache.nodes
    return sorted(s.cache.nodes)


def case_quota_delete_withdraws_parent_accounting(P):
    bus = P.bus()
    s = P.scheduler(cluster_total={CPU: 100000})
    P.wiring.wire_scheduler(bus, s)
    bus.apply(P.Kind.QUOTA, "parent", P.T.QuotaSpec(
        name="parent", is_parent=True, min=P.res({CPU: 10000}),
        max=P.res({CPU: 50000})))
    bus.apply(P.Kind.QUOTA, "child", P.T.QuotaSpec(
        name="child", parent="parent", min=P.res({CPU: 1000}),
        max=P.res({CPU: 50000})))
    bus.apply(P.Kind.POD, "default/p", P.pod("p", {CPU: 2000},
                                             quota="child"))
    before = int(s.quota_manager.quotas["parent"].child_request[CPU])
    assert before == 2000
    bus.delete(P.Kind.QUOTA, "child")
    assert "child" not in s.quota_manager.quotas
    assert s.quota_manager.quotas["parent"].child_request[CPU] == 0
    return before


def case_assigned_pod_request_update_keeps_used_accounted(P):
    bus = P.bus()
    s = P.scheduler()
    P.wiring.wire_scheduler(bus, s)
    bus.apply(P.Kind.NODE, "n0", P.node())
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric())
    bus.apply(P.Kind.QUOTA, "t", P.T.QuotaSpec(
        name="t", min=P.res({CPU: 1000}), max=P.res({CPU: 10000})))
    bus.apply(P.Kind.POD, "default/p", P.pod("p", {CPU: 2000}, quota="t"))
    s.schedule_pending(now=100.0)
    live = s.cache.pods["default/p"]
    assert live.node_name == "n0"
    used = [int(s.quota_manager.quotas["t"].used[CPU])]
    bus.apply(P.Kind.POD, "default/p",
              dataclasses.replace(live, requests=P.res({CPU: 3000})))
    assert s.cache.pods["default/p"].node_name == "n0"
    used.append(int(s.quota_manager.quotas["t"].used[CPU]))
    assert used == [2000, 3000]
    assert s.quota_manager.quotas["t"].request[CPU] == 3000
    return used


def case_preemption_eviction_propagates_to_bus(P):
    bus = P.bus()
    s = P.scheduler()
    P.wiring.wire_scheduler(bus, s)
    bus.apply(P.Kind.NODE, "n0", P.node(cpu=10000))
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric())
    bus.apply(P.Kind.QUOTA, "a", P.T.QuotaSpec(
        name="a", min=P.res({CPU: 10000}), max=P.res({CPU: 10000})))
    bus.apply(P.Kind.POD, "default/low", P.pod("low", {CPU: 8000},
                                               quota="a", priority=10))
    out = [dict(s.schedule_pending(now=100.0))]
    assert out[0]["default/low"] == "n0"
    bus.apply(P.Kind.POD, "default/high", P.pod("high", {CPU: 4000},
                                                quota="a", priority=100))
    result = s.schedule_pending(now=101.0)
    assert result.nominations == {"default/high": "n0"}
    assert bus.get(P.Kind.POD, "default/low") is None
    assert "default/low" not in s.cache.pods
    out.append(dict(s.schedule_pending(now=102.0)))
    assert out[1]["default/high"] == "n0"
    return out


def _reserved_node(P, policy=None, nested=True, cpu=4000):
    spec = {"resources": {"cpu": cpu}} if nested else {"cpu": cpu}
    if policy is not None:
        spec["applyPolicy"] = policy
    return P.node(cpu=10000, annotations={
        P.X.ANNOTATION_NODE_RESERVATION: json.dumps(spec)})


def case_scheduler_sees_trimmed_allocatable(P):
    bus = P.bus()
    s = P.scheduler()
    P.wiring.wire_scheduler(bus, s)
    bus.apply(P.Kind.NODE, "n0", _reserved_node(P))
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric())
    bus.apply(P.Kind.POD, "default/p", P.pod("p", {CPU: 7000}))
    out = [dict(s.schedule_pending(now=100.0))]
    assert out[0]["default/p"] is None
    assert bus.get(P.Kind.NODE, "n0").allocatable[P.X.ResourceName.CPU] == 10000
    bus.apply(P.Kind.POD, "default/q", P.pod("q", {CPU: 5000}))
    out.append(dict(s.schedule_pending(now=101.0)))
    assert out[1]["default/q"] == "n0"
    return out


def case_reserved_cpus_only_policy_not_trimmed(P):
    node = P.wiring.transform_node(_reserved_node(P, policy="ReservedCPUsOnly"))
    assert node.allocatable[P.X.ResourceName.CPU] == 10000
    return _ints(node.allocatable)


def case_flat_form_and_malformed_tolerated(P):
    tf = P.wiring.transform_node
    cpu = P.X.ResourceName.CPU
    got = [tf(_reserved_node(P, nested=False)).allocatable[cpu]]
    broken = P.node(cpu=10000, annotations={
        P.X.ANNOTATION_NODE_RESERVATION: "{not json"})
    got.append(tf(broken).allocatable[cpu])
    got.append(tf(_reserved_node(P, cpu=999999)).allocatable[cpu])
    assert got == [6000, 10000, 0]
    return got


BUS_CASES = {name[5:]: fn for name, fn in globals().items()
             if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(BUS_CASES))
def test_bus_case_matches_reference(case):
    both(BUS_CASES[case])


# -- leader election -----------------------------------------------------------

def _electors(P, bus, **kw):
    return (P.le.LeaderElector(bus, "koord-scheduler", "sched-a", **kw),
            P.le.LeaderElector(bus, "koord-scheduler", "sched-b", **kw))


def le_first_ticker_leads_second_stands_by(P):
    bus = P.bus()
    a, b = _electors(P, bus)
    got = [a.tick(0.0), b.tick(0.1), a.is_leader(), b.is_leader()]
    lease = bus.get(P.Kind.LEASE, "koord-scheduler")
    assert got == [True, False, True, False]
    assert lease.holder == "sched-a" and lease.token == 1
    return got


def le_renew_keeps_leadership_and_token(P):
    bus = P.bus()
    a, b = _electors(P, bus)
    a.tick(0.0)
    got = []
    for t in (2.0, 4.0, 6.0, 8.0, 14.0):
        got.append((a.tick(t), b.tick(t + 0.1)))
    assert all(x == (True, False) for x in got)
    assert bus.get(P.Kind.LEASE, "koord-scheduler").token == 1
    return got


def le_failover_on_expiry_bumps_token(P):
    bus = P.bus()
    started = []
    a, b = _electors(P, bus)
    b.on_started_leading = lambda: started.append("b")
    a.tick(0.0)
    a.tick(2.0)
    got = [b.tick(10.0), b.tick(17.5)]
    lease = bus.get(P.Kind.LEASE, "koord-scheduler")
    assert got == [False, True] and started == ["b"]
    assert lease.holder == "sched-b" and lease.token == 2
    return got, lease.token


def le_renew_deadline_demotes_paused_leader(P):
    bus = P.bus()
    stopped = []
    a = P.le.LeaderElector(bus, "koord-scheduler", "sched-a",
                           on_stopped_leading=lambda: stopped.append("a"))
    a.tick(0.0)
    got = [a.tick(11.0), list(stopped), a.tick(11.5)]
    assert got == [False, ["a"], True]
    assert bus.get(P.Kind.LEASE, "koord-scheduler").token == 1
    return got


def le_release_hands_over_immediately(P):
    bus = P.bus()
    a, b = _electors(P, bus)
    a.tick(0.0)
    a.release()
    got = [a.is_leader(), b.tick(0.5),
           bus.get(P.Kind.LEASE, "koord-scheduler").token]
    assert got == [False, True, 2]
    return got


def le_deposed_leader_write_is_fenced(P):
    bus = P.bus()
    a, b = _electors(P, bus)
    a.tick(0.0)
    a.tick(2.0)
    b.tick(18.0)
    writes = []
    with pytest.raises(P.le.FencingError):
        a.fenced(lambda: writes.append("boom"))
    b.fenced(lambda: writes.append("ok"))
    assert writes == ["ok"]
    return writes


def le_lease_expiry_helper(P):
    lease = P.le.Lease(holder="x", acquire_time=0.0, renew_time=5.0,
                       duration_seconds=15.0)
    got = [lease.expired(19.9), lease.expired(20.0)]
    assert got == [False, True]
    return got


def le_two_schedulers_one_bus(P):
    bus = P.bus()
    sa, sb = P.scheduler(), P.scheduler()
    ea = P.le.LeaderElector(bus, "koord-scheduler", "a")
    eb = P.le.LeaderElector(bus, "koord-scheduler", "b")
    P.wiring.wire_scheduler(bus, sa, elector=ea)
    P.wiring.wire_scheduler(bus, sb, elector=eb)
    bus.apply(P.Kind.NODE, "n0", P.node())
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric(update_time=0.0))
    bus.apply(P.Kind.POD, "default/p1", P.pod("p1", {CPU: 1000}))

    def elected_round(elector, scheduler, now):
        if not elector.tick(now):
            return None
        return dict(scheduler.schedule_pending(now=now))

    got = [elected_round(ea, sa, 0.0), elected_round(eb, sb, 0.1)]
    assert got[0]["default/p1"] == "n0" and got[1] is None
    bus.apply(P.Kind.POD, "default/p2", P.pod("p2", {CPU: 1000}))
    got.append(elected_round(eb, sb, 20.0))
    assert got[2]["default/p2"] == "n0"
    with pytest.raises(P.le.FencingError):
        ea.fenced(lambda: None)
    return got


def le_two_managers_one_bus_fenced_patch(P):
    bus = P.bus()
    ea = P.le.LeaderElector(bus, "koord-manager", "a")
    eb = P.le.LeaderElector(bus, "koord-manager", "b")
    loop_a, loop_b = P.manager(bus, elector=ea), P.manager(bus, elector=eb)
    bus.apply(P.Kind.NODE, "n0", P.node(cpu=32000, mem=65536))
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric(
        usage={CPU: 2000, MEM: 4096}, sys_usage=P.res({CPU: 500}),
        update_time=100.0))
    ea.tick(0.0)
    eb.tick(0.1)
    got = [loop_a.reconcile(now=101.0)]
    first = _ints(bus.get(P.Kind.NODE, "n0").allocatable)
    assert got == [1] and first[BCPU] > 0
    eb.tick(20.0)
    assert eb.is_leader()
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric(
        usage={CPU: 12000, MEM: 16384}, sys_usage=P.res({CPU: 9000}),
        update_time=101.5))
    with pytest.raises(P.le.FencingError):
        loop_a.reconcile(now=102.0)
    # the fenced-off reconcile left the bus node as the leader wrote it
    assert _ints(bus.get(P.Kind.NODE, "n0").allocatable) == first
    got.append(loop_b.reconcile(now=102.0))
    assert got == [1, 1]
    return got, first, _ints(bus.get(P.Kind.NODE, "n0").allocatable)


LE_CASES = {name[3:]: fn for name, fn in globals().items()
            if name.startswith("le_")}


@pytest.mark.parametrize("case", sorted(LE_CASES))
def test_leader_election_case_matches_reference(case):
    both(LE_CASES[case])


# -- the port's own contracts ---------------------------------------------------

def test_fenced_patch_leaks_nothing_into_the_bus():
    """A deposed manager's reconcile runs the host plugins (which write
    the node's allocatable and annotations) on copies: after its
    FencingError the bus node is exactly the one applied before."""
    P = PORT
    bus = P.bus()
    ea = P.le.LeaderElector(bus, "koord-manager", "a")
    eb = P.le.LeaderElector(bus, "koord-manager", "b")
    loop_a = P.manager(bus, elector=ea)
    node = P.node(cpu=32000, mem=65536, annotations={
        P.X.ANNOTATION_CPU_NORMALIZATION_RATIO: "1.5"})
    bus.apply(P.Kind.NODE, "n0", node)
    bus.apply(P.Kind.NODE_METRIC, "n0", P.metric(
        usage={CPU: 2000}, sys_usage=P.res({CPU: 500}), update_time=100.0))
    before = (dict(node.allocatable), dict(node.annotations),
              node.raw_allocatable)
    ea.tick(0.0)
    ea.tick(2.0)
    eb.tick(18.0)
    with pytest.raises(P.le.FencingError):
        loop_a.reconcile(now=101.0)
    live = bus.get(P.Kind.NODE, "n0")
    assert live is node
    assert (dict(live.allocatable), dict(live.annotations),
            live.raw_allocatable) == before


def test_manager_loop_nodeslo_not_ported():
    """``ManagerLoop(nodeslo=...)`` (once refused, now ported): each
    node's rendered NodeSLO lands on the bus, the same in both packages
    (``tests/test_torch_descheduler_loop.py`` holds the renders field for
    field)."""
    def case(P):
        nodeslo = importlib.import_module(f"{P.root}.manager.nodeslo")
        bus = P.bus()
        loop = P.wiring.ManagerLoop(bus, P.controller(),
                                    nodeslo=nodeslo.NodeSLOController())
        bus.apply(P.Kind.NODE, "n0", P.node())
        loop.reconcile(now=100.0)
        slo = bus.get(P.Kind.NODE_SLO, "n0")
        return (slo.cpu_burst_strategy.policy,
                slo.resource_used_threshold_with_be.enable)

    assert both(case) == ("none", False)


# -- the full colocation loop, round for round ----------------------------------

def _loop_spec():
    return testing.colocation_world_spec(
        seed=5, n_nodes=60, pods_per_node=7, n_dangling=40, n_pending=400,
        override_frac=0.2, normalized_frac=0.1, reserving_frac=0.1,
        stale_frac=0.1, host_app_frac=0.1)


def run_loop(P, spec):
    """The colocation loop: 4 rounds around 3 reconciles (the world, 10%
    of the metrics changed, then a periodic force-sync past the update
    time threshold); half the BE wave before round 1, half before round
    3. Returns every round's placements, every reconcile's synced count
    and PATCHed nodes, (the port) the rows each round restaged, the
    Scheduler, the batch capacity checks, the series' changes and the
    spans."""
    importlib.import_module(f"{P.root}.obs.trace").TRACER.clear()
    before = series_values(P)
    bus = P.bus()
    sched = P.scheduler()
    P.wiring.wire_scheduler(bus, sched)
    manager = P.manager(bus, config=testing.colocation_config(spec, P.slo))
    patched = []
    bus.watch(P.Kind.NODE, lambda e, n, o: patched.append(
        (e.value, n, _ints(o.allocatable))))
    half = len(spec["pending"]) // 2
    first = dict(spec, pending=spec["pending"][:half])
    testing.apply_colocation(bus, P.Kind, first, P.T)
    patched.clear()
    now = spec["now"]
    rounds, synced, patches, staged, capacity = [], [], [], [], []

    def round_(t):
        rounds.append(dict(sched.schedule_pending(now=t)))
        # batch capacity holds on every node a pod landed on this round
        for name in {n for n in rounds[-1].values() if n is not None}:
            node = sched.cache.nodes[name]
            for col in (BCPU, BMEM):
                col = P.X.ResourceName(col)
                load = sum(p.requests.get(col, 0)
                           for p in sched.cache.pods.values()
                           if p.node_name == name)
                capacity.append(load <= node.allocatable.get(col, 0))
        if P.port:
            model = sched.model
            delta = model.staged_cache.last_delta
            staged.append((model.last_staging, None if delta.idx is None
                           else sorted(int(i) for i in delta.idx)))

    def reconcile(t):
        patched.clear()
        synced.append(manager.reconcile(now=t))
        patches.append(list(patched))

    round_(now)
    reconcile(now + 10)
    round_(now + 20)
    for m in testing.colocation_metric_changes(spec, frac=0.1, seed=6,
                                               now=now + 50):
        bus.apply(P.Kind.NODE_METRIC, m["node_name"],
                  testing.colocation_metric(m, P.T))
    reconcile(now + 60)
    for pod in testing.colocation_objects(
            dict(spec, pending=spec["pending"][half:]), P.T)["pending"]:
        bus.apply(P.Kind.POD, pod.uid, pod)
    round_(now + 70)
    reconcile(now + 400)
    round_(now + 410)
    after = series_values(P)
    series = {k: after[k] - before[k] for k in after}
    series["PENDING_PODS"] = after["PENDING_PODS"]
    return (rounds, synced, patches, staged, sched, capacity, series,
            spans_of(P))


def test_full_colocation_loop_round_for_round():
    spec = _loop_spec()
    got = run_loop(PORT, spec)
    want = run_loop(REF, spec)
    rounds, synced, patches, staged, sched, _, series, spans = got
    assert rounds == want[0]
    assert synced == want[1]
    assert patches == want[2]
    assert series == want[6]
    assert spans == want[7]
    assert spans[0]["round"] == spans[0]["publish"] == 4
    assert series["POD_E2E[('lane', 'be')]"] == sum(
        v is not None for r in rounds for v in r.values())
    placed = [sum(v is not None for v in r.values()) for r in rounds]
    assert placed[0] == 0 and placed[1] > 0 and placed[2] > 0, placed
    assert synced[0] > synced[1] > 0 and synced[2] > 0, synced
    # the PATCH re-enters add_node: the next round restages exactly the
    # synced rows, by delta
    index = {name: i for i, name in enumerate(sched.cache.nodes)}
    assert staged[0][0] == "full"
    assert staged[1] == ("delta", sorted(index[n] for _, n, _ in patches[0]))
    assert all(path == "delta" for path, _ in staged[1:])
    assert all(ok for ok in got[5])
