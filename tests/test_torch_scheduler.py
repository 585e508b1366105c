"""The port's ``Scheduler`` (batched rounds on a CPU model) against the JAX
package's ``Scheduler(enable_preemption=False)``, driven by one seeded
intake stream: nodes and metrics, quotas in two trees, Strict and
NonStrict gangs (one whose WaitTime elapses), reservations (label and
pod-uid owners, ``allocate_once`` or not, one with a TTL), pending
waves, deletions of pending and bound pods, and binds seen from the bus.
Round for round the results, the cache, the Permit barrier, the quota
accounting, the reservation specs, ``expire_waiting``'s releases and the
staged node fields must be equal (counterpart of
``tests/test_scheduler.py``'s batched path); each pod the fine-grained
manager takes or passes through schedules as the reference's does; a
bound pod's resize marks its node; and the plugin-chain paths run as the
reference's (preemption runs: ``tests/test_torch_preempt_scheduler.py``;
the chain in full: ``tests/test_torch_framework.py``)."""

import numpy as np
import pytest
import torch

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu.scheduler.scheduler import Scheduler as JScheduler
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_RESOURCE_SPEC,
    QoSClass,
)
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.state.cluster import lower_nodes

CPU, MEM = 0, 1
N_NODES = 24
TOTAL = {CPU: N_NODES * 16000, MEM: N_NODES * 32768}


class Package:
    """One package's types, for building its objects from plain data."""

    def __init__(self, types, resource):
        self.types, self.resource = types, resource

    def res(self, d):
        return {self.resource(k): v for k, v in d.items()}

    def node(self, d):
        return self.types.NodeSpec(name=d["name"],
                                   allocatable=self.res(d["alloc"]),
                                   unschedulable=d.get("unsched", False))

    def metric(self, d):
        return self.types.NodeMetric(node_name=d["node"],
                                     node_usage=self.res(d["usage"]),
                                     update_time=d["t"])

    def pod(self, d):
        return self.types.PodSpec(
            name=d["name"], requests=self.res(d["req"]),
            priority=d.get("prio", 0), quota=d.get("quota"),
            gang=d.get("gang"), labels=dict(d.get("labels", {})),
            preemptible=d.get("preemptible", True),
            node_name=d.get("node"), assign_time=d.get("at", 0.0))

    def quota(self, d):
        total = d.get("total")
        return self.types.QuotaSpec(
            name=d["name"], parent=d.get("parent"), min=self.res(d["min"]),
            max=self.res(d["max"]), is_parent=d.get("is_parent", False),
            tree_id=d.get("tree", ""),
            total_resource=None if total is None else self.res(total))

    def gang(self, d):
        return self.types.GangSpec(name=d["name"], min_member=d["min"],
                                   mode=self.types.GangMode(d["mode"]),
                                   wait_time=d.get("wait", 600.0))

    def resv(self, d):
        return self.types.ReservationSpec(
            name=d["name"], requests=self.res(d["req"]),
            allocatable=self.res(d["req"]), node_name=d["node"],
            state=self.types.ReservationState.AVAILABLE,
            owner_labels=dict(d.get("labels", {})),
            owner_pod_uids=list(d.get("owners", [])),
            allocate_once=d["once"], ttl=d.get("ttl"), create_time=100.0)


REF = Package(jtypes, JResourceName)
PORT = Package(ttypes, TResourceName)


def _apply(scheduler, pkg, event):
    """Deliver one intake event (plain data) to ``scheduler``."""
    kind, d = event
    if kind == "node":
        scheduler.add_node(pkg.node(d))
    elif kind == "remove_node":
        scheduler.remove_node(d)
    elif kind == "metric":
        scheduler.update_node_metric(pkg.metric(d))
    elif kind == "quota":
        scheduler.update_quota(pkg.quota(d))
    elif kind == "gang":
        scheduler.update_gang(pkg.gang(d))
    elif kind == "resv":
        scheduler.update_reservation(pkg.resv(d))
    elif kind == "pod":
        scheduler.add_pod(pkg.pod(d))
    elif kind == "remove_pod":
        cached = (scheduler.cache.pods.get(d)
                  or scheduler.cache.pending.get(d))
        scheduler.remove_pod(cached)
    elif kind == "bind":
        # another scheduler's bind, seen as a fresh object from the bus
        scheduler.update_pod(pkg.pod(d))
    else:
        raise ValueError(kind)


def _stream(seed, rounds):
    """``[(now, [events])]`` per round, drawn from one rng."""
    rng = np.random.default_rng(seed)
    setup = []
    for i in range(N_NODES):
        setup.append(("node", dict(name=f"n{i}", alloc={
            CPU: int(rng.choice([8000, 16000, 32000])),
            MEM: int(rng.choice([16384, 32768]))})))
        if rng.random() < 0.85:
            setup.append(("metric", dict(node=f"n{i}", t=95.0, usage={
                CPU: int(rng.integers(0, 6000)),
                MEM: int(rng.integers(0, 12000))})))
    # two quota trees: the default one and "t2" with its own total
    setup += [
        ("quota", dict(name="qa", parent="root", is_parent=True,
                       min={CPU: 20000, MEM: 40000},
                       max={CPU: 120000, MEM: 240000})),
        ("quota", dict(name="qa1", parent="qa", min={CPU: 8000, MEM: 16000},
                       max={CPU: 60000, MEM: 120000})),
        ("quota", dict(name="qa2", parent="qa", min={CPU: 4000, MEM: 8000},
                       max={CPU: 14000, MEM: 30000})),
        ("quota", dict(name="qb", parent="root", is_parent=True, tree="t2",
                       min={CPU: 10000, MEM: 20000},
                       max={CPU: 40000, MEM: 80000},
                       total={CPU: 60000, MEM: 120000})),
        ("quota", dict(name="qb1", parent="qb", tree="t2",
                       min={CPU: 5000, MEM: 10000},
                       max={CPU: 16000, MEM: 40000})),
        ("gang", dict(name="gs", min=3, mode="Strict")),
        ("gang", dict(name="gn", min=9, mode="NonStrict", wait=15.0)),
        ("resv", dict(name="r-web", node="n1", req={CPU: 6000, MEM: 8000},
                      labels={"app": "web"}, once=True)),
        ("resv", dict(name="r-db", node="n3", req={CPU: 9000, MEM: 9000},
                      labels={"app": "db"}, once=False)),
        ("resv", dict(name="r-ttl", node="n5", req={CPU: 4000, MEM: 4000},
                      labels={"app": "web"}, once=False, ttl=35.0)),
        ("resv", dict(name="r-mig", node="n7", req={CPU: 3000, MEM: 3000},
                      owners=["default/w0-3"], once=True)),
    ]
    for j in range(30):   # bound pods already running
        setup.append(("pod", dict(
            name=f"a{j}", node=f"n{int(rng.integers(0, N_NODES))}", at=90.0,
            req={CPU: int(rng.integers(200, 3000)),
                 MEM: int(rng.integers(128, 4096))},
            quota=("qa1", "qb1", None, None)[j % 4])))
    out = []
    pending, bound = [], [f"default/a{j}" for j in range(30)]
    for r in range(rounds):
        now = 100.0 + 10.0 * r
        events = list(setup) if r == 0 else []
        for k in range(14):
            name = f"w{r}-{k}"
            d = dict(name=name, prio=int(rng.integers(0, 3)),
                     req={CPU: int(rng.integers(300, 5000)),
                          MEM: int(rng.integers(256, 6000))},
                     quota=("qa1", "qa2", "qb1", None)[int(rng.integers(0, 4))],
                     preemptible=bool(rng.random() > 0.2))
            if k % 5 == 0:
                d["gang"] = "gs"
            elif k % 5 == 1:
                d["gang"] = "gn"
            if rng.random() < 0.3:
                d["labels"] = {"app": ("web", "db")[k % 2]}
            events.append(("pod", d))
            pending.append(d)
        for _ in range(3):
            node = f"n{int(rng.integers(0, N_NODES))}"
            events.append(("metric", dict(node=node, t=now - 2.0, usage={
                CPU: int(rng.integers(0, 9000)),
                MEM: int(rng.integers(0, 16000))})))
        if r >= 1:
            # a pending pod is deleted, another is bound elsewhere
            gone = pending.pop(int(rng.integers(0, len(pending))))
            events.append(("remove_pod", f"default/{gone['name']}"))
            solo = [p for p in pending if "gang" not in p]
            if solo:
                pod = solo[int(rng.integers(0, len(solo)))]
                pending.remove(pod)
                node = f"n{int(rng.integers(0, N_NODES))}"
                events.append(("bind", dict(pod, node=node, at=now)))
            # a bound pod is deleted
            uid = bound.pop(int(rng.integers(0, len(bound))))
            events.append(("remove_pod", uid))
        if r == 3:
            events.append(("node", dict(name="n2", alloc={CPU: 4000,
                                                          MEM: 8192},
                                        unsched=True)))
            events.append(("node", dict(name="n-new", alloc={CPU: 64000,
                                                             MEM: 65536})))
        if r == 5:
            events.append(("remove_node", "n-new"))
        out.append((now, events))
    return out


def _quota_view(scheduler):
    return {
        (tree, name): tuple(np.asarray(getattr(info, f)).tolist() for f in (
            "used", "non_preemptible_used", "request", "child_request",
            "non_preemptible_request"))
        for tree, mgr in scheduler.quota_registry.items()
        for name, info in mgr.quotas.items()
    }


def _records(book):
    return {uid: (name, [int(x) for x in delta])
            for uid, (name, delta) in book.items()}


def _resv_view(scheduler):
    return {name: ({int(k): v for k, v in r.allocated.items()},
                   list(r.allocated_pod_uids), r.state.value)
            for name, r in scheduler.cache.reservations.items()}


def _capture_staging(model):
    """Wrap ``model.schedule_async`` to record a fresh staging of each
    snapshot it is handed, taken before the solve."""
    fresh = []
    dispatch = model.schedule_async

    def record(snap):
        fresh.append(model.stage_nodes(
            lower_nodes(snap, **model.lowering_kwargs())))
        return dispatch(snap)

    model.schedule_async = record
    return fresh


def _pair():
    ref = JScheduler(model=JPlacementModel(use_pallas=False),
                     cluster_total=REF.res(TOTAL), enable_preemption=False)
    port = Scheduler(model=PlacementModel(device="cpu"),
                     cluster_total=PORT.res(TOTAL), enable_preemption=False)
    return ref, port


def test_scheduler_rounds_match_reference():
    ref, port = _pair()
    fresh = _capture_staging(port.model)
    seen = {"waiting": 0, "released": 0, "resv": 0, "delta": 0}
    for r, (now, events) in enumerate(_stream(seed=3, rounds=8)):
        for event in events:
            _apply(ref, REF, event)
            _apply(port, PORT, event)
        released = port.expire_waiting(now)
        assert sorted(released) == sorted(ref.expire_waiting(now)), r
        seen["released"] += len(released)
        want = ref.schedule_pending(now=now)
        got = port.schedule_pending(now=now)
        ctx = f"round {r}"
        assert dict(got) == dict(want), ctx
        assert got.waiting == want.waiting, ctx
        assert _records(got.resv_allocs) == _records(want.resv_allocs), ctx
        assert (_records(got.resv_committed)
                == _records(want.resv_committed)), ctx
        assert ({u: p.node_name for u, p in port.cache.pods.items()}
                == {u: p.node_name for u, p in ref.cache.pods.items()}), ctx
        assert list(port.cache.pending) == list(ref.cache.pending), ctx
        assert port._waiting == ref._waiting, ctx
        assert _quota_view(port) == _quota_view(ref), ctx
        assert _resv_view(port) == _resv_view(ref), ctx
        staged = port.model.staged_cache.state
        jstaged = ref.model.staged_cache.state
        assert (port.model.staged_cache.last_path
                == ref.model.staged_cache.last_path), ctx
        for f in STAGED_NODE_FIELDS:
            assert torch.equal(getattr(staged, f), getattr(fresh[-1], f)), f
            np.testing.assert_array_equal(
                getattr(staged, f).numpy(), np.asarray(getattr(jstaged, f)),
                err_msg=f"{ctx}: {f}")
        seen["waiting"] += len(got.waiting)
        seen["resv"] += len(got.resv_committed) + len(got.resv_allocs)
        seen["delta"] += port.model.last_staging == "delta"
        # the binds publish: close the committed pods' assumes
        for uid, node in got.items():
            if node is not None:
                port.cache.finish_binding(uid)
                ref.cache.finish_binding(uid)
    # the stream reaches every path it is meant to
    assert seen["waiting"] and seen["released"] and seen["resv"]
    assert seen["delta"] >= 4
    assert ref.cache.reservations["r-ttl"].state.value == "Expired"
    assert _resv_view(port) == _resv_view(ref)
    # an aborted round: its unpublished decisions are forgotten
    now = 200.0
    _apply(ref, REF, ("pod", dict(name="late", req={CPU: 500, MEM: 500},
                                  quota="qa1")))
    _apply(port, PORT, ("pod", dict(name="late", req={CPU: 500, MEM: 500},
                                    quota="qa1")))
    assert dict(port.schedule_pending(now)) == dict(ref.schedule_pending(now))
    forgot = port.forget_assumed_unbound()
    assert sorted(forgot) == sorted(ref.forget_assumed_unbound())
    assert "default/late" in forgot
    assert list(port.cache.pending) == list(ref.cache.pending)
    assert _quota_view(port) == _quota_view(ref)
    assert _resv_view(port) == _resv_view(ref)


def test_split_tick_and_second_round_take_the_delta_path():
    """``begin_tick`` dispatches with the staged generation pinned;
    ``commit_tick`` releases it; a second round with no events re-lowers
    nothing it was not told to and equals the first round's staging."""
    sched = Scheduler(model=PlacementModel(device="cpu"),
                      enable_preemption=False)
    snap, _ = testing.churn_world(40, seed=42)
    testing.add_pending_wave(snap, 120, n_quota=3, n_gangs=4, gang_size=6)
    testing.feed_scheduler(sched, snap)
    tick = sched.begin_tick(now=20.0)
    cache = sched.model.staged_cache
    assert cache._pinned is not None and tick.inflight.pinned is cache._pinned
    first = sched.commit_tick(tick)
    assert cache._pinned is None and cache.last_path == "full"
    assert sum(n is not None for n in first.values()) > 0
    again = sched.schedule_pending(now=20.0)
    assert cache.last_path == "delta"
    want = sched.model.stage_nodes(lower_nodes(sched.cache.snapshot(20.0)))
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(cache.state, f), getattr(want, f)), f
    assert set(again) == set(sched.cache.pending) | {
        u for u, n in again.items() if n is not None}


def test_removals_mark_the_node():
    """Removing a reservation or a node metric marks the node, so the next
    round's delta staging equals a full staging. (The reference's
    ``Scheduler.remove_reservation``/``remove_node_metric`` do not mark,
    and its staged state keeps the old hold and freshness.)"""
    sched = Scheduler(model=PlacementModel(device="cpu"),
                      enable_preemption=False)
    for i in range(3):
        sched.add_node(PORT.node(dict(name=f"n{i}",
                                      alloc={CPU: 16000, MEM: 32768})))
        sched.update_node_metric(PORT.metric(dict(node=f"n{i}", t=99.0,
                                                  usage={CPU: 500})))
    sched.update_reservation(PORT.resv(dict(
        name="r", node="n1", req={CPU: 8000}, labels={"a": "b"}, once=True)))
    sched.add_pod(PORT.pod(dict(name="p0", req={CPU: 1000})))
    sched.schedule_pending(now=100.0)
    sched.remove_reservation("r")
    sched.remove_node_metric("n2")
    sched.add_pod(PORT.pod(dict(name="p1", req={CPU: 1000})))
    fresh = _capture_staging(sched.model)
    sched.schedule_pending(now=101.0)
    assert sched.model.last_staging == "delta"
    state = sched.model.staged_cache.state
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(fresh[-1], f)), f
    assert int(state.used_req[1, 0]) == 0 and not bool(state.metric_fresh[2])


# -- the paths that raised while they were not ported ---------------------------

def _cpu_scheduler():
    return Scheduler(model=PlacementModel(device="cpu"),
                     enable_preemption=False)


def test_preemption_raises():
    """The "verify" backend raises when the device's answer and the host
    oracle's differ, in a preemption round and in ``defrag_headroom``
    (the device side here made to find nothing)."""
    sched = Scheduler(model=PlacementModel(device="cpu"),
                      preemption_backend="verify")
    sched.add_node(PORT.node(dict(name="n0", alloc={CPU: 10000})))
    sched.add_pod(PORT.pod(dict(name="low", req={CPU: 8000}, prio=10)))
    assert sched.schedule_pending(now=100.0)["default/low"] == "n0"
    sched.model.select_victims_device = lambda *a, **k: None
    sched.model.plan_defrag_device = lambda *a, **k: None
    target = ttypes.resources_to_vector(PORT.res({CPU: 9000}))
    with pytest.raises(AssertionError, match="defrag parity violation"):
        sched.defrag_headroom(target, 50, now=100.5)
    sched.add_pod(PORT.pod(dict(name="high", req={CPU: 8000}, prio=100)))
    with pytest.raises(AssertionError, match="preemption parity violation"):
        sched.schedule_pending(now=101.0)


def test_plugin_chain_paths_raise():
    """The two plugin-chain paths, which raised while the chain was not
    ported (the case keeps that name): ``schedule_one`` and a round with
    ``batched_placement=False`` both run and equal the reference's."""
    ref, port = _pair()
    for sched, pkg in ((ref, REF), (port, PORT)):
        for i in range(2):
            sched.add_node(pkg.node(dict(name=f"n{i}",
                                         alloc={CPU: 4000, MEM: 8192})))
        for name, cpu in (("p", 100), ("q", 3000), ("r", 2500)):
            sched.add_pod(pkg.pod(dict(name=name, req={CPU: cpu})))
    got, want = port.schedule_one("default/p", now=1.0), ref.schedule_one(
        "default/p", now=1.0)
    assert (got.status, got.node) == (want.status, want.node) == (
        "bound", got.node)
    ref.batched_placement = port.batched_placement = False
    got, want = port.schedule_pending(now=2.0), ref.schedule_pending(now=2.0)
    assert dict(got) == dict(want) and got.waiting == want.waiting
    assert sum(n is not None for n in got.values()) == 2
    assert ({u: p.node_name for u, p in port.cache.pods.items()}
            == {u: p.node_name for u, p in ref.cache.pods.items()})


def test_fine_grained_intake_raises():
    """Topology and device intake reach the fine-grained manager as they
    reach the reference's (the case keeps the name it had while the
    manager was not ported and both raised)."""
    from test_torch_finegrained import PORT as FPORT, REF as FREF, view

    ref, port = FREF.scheduler(), FPORT.scheduler()
    for s, pk in ((ref, FREF), (port, FPORT)):
        s.add_node(pk.node("n0", 16000, 32768))
        s.update_node_topology("n0", pk.numa(policy="Restricted"))
        s.update_node_devices("n0", pk.gpus(4))
        s.add_node(pk.node("n1", 16000, 32768))
        s.update_node_devices("n1", pk.gpus(2))
        s.remove_node("n1")
    assert port.model.fine.any_node_policy(["n0"])
    assert (port.model.fine.numa_arrays(["n0"])[0].tolist()
            == np.asarray(ref.model.fine.numa_arrays(["n0"])[0]).tolist())
    assert (sorted(port.device_cache.nodes) == sorted(ref.device_cache.nodes)
            == ["n0", "n1"])
    assert port.device_cache.get("n1").device_total == {}
    assert view(port) == view(ref)


@pytest.mark.parametrize("extra,special", [
    (dict(host_ports=[8080]), "host ports"),
    (dict(device_requests={"nvidia.com/gpu": 1}), "device"),
    (dict(qos=QoSClass.LSR), "cpuset"),
    (dict(qos=QoSClass.LSE), "cpuset"),
    (dict(annotations={ANNOTATION_RESOURCE_SPEC:
                       '{"requiredCPUBindPolicy": true}'}), "cpuset"),
    (dict(annotations={ANNOTATION_RESOURCE_SPEC:
                       '{"numaTopologyPolicy": "SingleNUMANode"}'}), "NUMA"),
    (dict(annotations={ANNOTATION_RESOURCE_SPEC: "{not json"}), "unreadable"),
    (dict(annotations={ANNOTATION_RESOURCE_SPEC:
                       '{"cpuBindPolicy": "Bogus"}'}), "unreadable"),
    (dict(device_requests={"vendor.example/fpga": 1}), None),
    (dict(qos=QoSClass.LS), None),
    (dict(annotations={ANNOTATION_RESOURCE_SPEC:
                       '{"cpuBindPolicy": "FullPCPUs"}'}), None),
])
def test_fine_grained_pending_pod_raises(extra, special):
    """Each pod the fine-grained manager takes (``special``: what makes
    it special) or passes through (None) schedules as the reference's
    Scheduler schedules it: the result, the written annotations, the
    NUMA and device holds. (The cases keep the name they had while such
    a round raised.)"""
    from test_torch_finegrained import PORT as FPORT, REF as FREF, view

    from koordinator_tpu.apis.extension import QoSClass as JQoSClass

    ref, port = FREF.scheduler(), FPORT.scheduler()
    for s, pk in ((ref, FREF), (port, FPORT)):
        s.add_node(pk.node("n0", 8000, 8192))
        s.update_node_topology("n0", pk.numa(policy=""))
        s.update_node_devices("n0", pk.gpus(2))
        ref_extra = {k: JQoSClass[v.name] if isinstance(v, QoSClass) else v
                     for k, v in extra.items()}
        s.add_pod(pk.T.PodSpec(
            name="p", requests=pk.res({CPU: 1000}),
            **(ref_extra if pk is FREF else extra)))
    want = ref.schedule_pending(now=1.0)
    got = port.schedule_pending(now=1.0)
    assert dict(got) == dict(want)
    assert view(port) == view(ref)
    placed = got["default/p"] == "n0"
    # a readable spec places; an unreadable one fails the NUMA PreFilter
    assert placed == (special != "unreadable")
    if special in ("cpuset", "device"):
        assert port.cache.pods["default/p"].annotations


def test_resize_of_a_bound_pod_marks_its_node():
    """``update_pod`` of a bound pod swaps it in under the cache's lock
    and marks its node: after a resize from 1,000 to 9,000 mCPU the next
    round's delta staging equals a fresh staging. (The reference swaps
    the object without a mark; its staged row keeps 1,000.)"""
    sched = _cpu_scheduler()
    for i in range(3):
        sched.add_node(PORT.node(dict(name=f"n{i}",
                                      alloc={CPU: 16000, MEM: 32768})))
    sched.add_pod(PORT.pod(dict(name="bound", req={CPU: 1000}, node="n1",
                                at=90.0)))
    sched.add_pod(PORT.pod(dict(name="p0", req={CPU: 500})))
    sched.schedule_pending(now=100.0)
    sched.update_pod(PORT.pod(dict(name="bound", req={CPU: 9000}, node="n1",
                                   at=90.0)))
    assert sched.cache.pods["default/bound"].requests[TResourceName.CPU] == 9000
    sched.add_pod(PORT.pod(dict(name="p1", req={CPU: 500})))
    fresh = _capture_staging(sched.model)
    sched.schedule_pending(now=101.0)
    assert sched.model.last_staging == "delta"
    state = sched.model.staged_cache.state
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(fresh[-1], f)), f
    used_n1 = int(fresh[-1].used_req[1, 0])
    assert used_n1 >= 9000 and int(state.used_req[1, 0]) == used_n1
