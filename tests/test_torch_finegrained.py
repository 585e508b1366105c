"""The fine-grained NUMA/device manager through the port's ``Scheduler``
against the JAX package's ``Scheduler(enable_preemption=False)``.

The seven scenarios of ``tests/test_batched_finegrained.py`` (cpuset,
GPU, reservation, quota and gang pods in one batch; the refine loop on a
cpuset and on a device conflict; reservation credit; allocate_once;
gang rejection rolling back reservation and cpuset holds; a waiting
member's quota) and one seeded intake stream (cpuset, NUMA-policy, GPU,
host-port and node-selector pods, gangs, deletions and a WaitTime
expiry) are driven through both Schedulers on a CPU model. Round for
round the results, the written annotations
(``ANNOTATION_RESOURCE_STATUS``, ``ANNOTATION_DEVICE_ALLOCATED``), the
NUMA manager's allocations, the device cache's state and
``_fine_waiting`` must be equal."""

import importlib
import json

import numpy as np
import pytest

CPU, MEM = 0, 1


class Pkg:
    """One package's modules and a Scheduler on a CPU model."""

    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.DC = mod("device.cache")
        self.H = mod("numa.hints")
        self.M = mod("numa.manager")
        self.Topo = mod("numa.topology")
        self._sched = mod("scheduler.scheduler").Scheduler
        self._model = mod("models.placement").PlacementModel

    def scheduler(self, **kw):
        if self.root == "koordinator_tpu":
            model = self._model(use_pallas=False)
        else:
            model = self._model(device="cpu")
        total = kw.pop("cluster_total", None)
        return self._sched(model=model, enable_preemption=False,
                           cluster_total=None if total is None
                           else self.res(total), **kw)

    def res(self, d):
        return {self.X.ResourceName(k): v for k, v in d.items()}

    def node(self, name, cpu, mem, labels=None):
        return self.T.NodeSpec(name=name, allocatable=self.res(
            {CPU: cpu, MEM: mem}), labels=dict(labels or {}))

    def metric(self, node, usage, t=99.0):
        return self.T.NodeMetric(node_name=node, node_usage=self.res(usage),
                                 update_time=t)

    def numa(self, policy="BestEffort", cores=4, cpu=8000, mem=16384):
        """2 sockets x 1 NUMA node x ``cores`` cores x 2 threads."""
        topo = self.Topo.CPUTopology.build(
            sockets=2, nodes_per_socket=1, cores_per_node=cores,
            threads_per_core=2)
        return self.M.TopologyOptions(
            cpu_topology=topo, policy=self.H.NUMATopologyPolicy(policy),
            numa_node_resources={k: self.res({CPU: cpu, MEM: mem})
                                 for k in (0, 1)})

    def gpus(self, n=4):
        DR = self.DC.DeviceResourceName
        full = {DR.GPU_CORE: 100, DR.GPU_MEMORY: 16384,
                DR.GPU_MEMORY_RATIO: 100}
        return [self.DC.DeviceEntry(
            minor=i, device_type=self.DC.DeviceType.GPU, resources=dict(full),
            numa_node=i // (n // 2 or 1), pcie_id=str(i // 2))
            for i in range(n)]

    def pod(self, name, req, **kw):
        qos = kw.pop("qos", None)
        spec = kw.pop("spec", None)
        ann = dict(kw.pop("annotations", {}))
        if spec is not None:
            ann[self.X.ANNOTATION_RESOURCE_SPEC] = json.dumps(spec)
        if qos is not None:
            kw["qos"] = self.X.QoSClass[qos]
        return self.T.PodSpec(name=name, requests=self.res(req),
                              annotations=ann, **kw)

    def resv(self, name, node, cpu, labels, once):
        return self.T.ReservationSpec(
            name=name, requests=self.res({CPU: cpu}),
            allocatable=self.res({CPU: cpu}), owner_labels=dict(labels),
            node_name=node, state=self.T.ReservationState.AVAILABLE,
            allocate_once=once)


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")


def view(s):
    """Everything the fine-grained path writes, as plain data."""
    X = s.model.fine.numa_plugin.manager  # the scheduler's own manager
    assert X is s.numa_manager
    keys = ("koordinator.tpu/resource-status",
            "koordinator.tpu/device-allocated")
    pods = {**s.cache.pending, **s.cache.pods}
    annotations = {uid: {k: json.loads(p.annotations[k]) for k in keys
                         if k in p.annotations}
                   for uid, p in pods.items()}
    numa = {node: {uid: ([int(c) for c in a.cpuset],
                         {n: {int(r): v for r, v in res.items()}
                          for n, res in a.numa_resources.items()},
                         a.cpu_exclusive_policy.value)
                   for uid, a in alloc.pods.items()}
            for node, alloc in s.numa_manager.node_allocations.items()}
    devices = {}
    for node, nd in s.device_cache.nodes.items():
        devices[node] = (
            {uid: {t.value: [(a.minor, {k.value: v
                                        for k, v in a.resources.items()},
                              list(a.vf_bus_ids)) for a in allocs]
                   for t, allocs in by_type.items()}
             for uid, by_type in nd.allocations.items()},
            {t.value: {m: {k.value: v for k, v in u.items()}
                       for m, u in used.items()}
             for t, used in nd.device_used.items()})
    return dict(
        assigned={u: p.node_name for u, p in s.cache.pods.items()},
        pending=sorted(s.cache.pending),
        waiting=dict(s._waiting),
        fine_waiting={u: held[0] for u, held in s._fine_waiting.items()},
        annotations=annotations, numa=numa, devices=devices,
        resv={n: ({int(k): v for k, v in r.allocated.items()},
                  list(r.allocated_pod_uids), r.state.value)
              for n, r in s.cache.reservations.items()})


def same_round(got, want, ref, port, ctx=""):
    assert dict(got) == dict(want), ctx
    assert got.waiting == want.waiting, ctx
    assert ({u: h[0] for u, h in got.fine_states.items()}
            == {u: h[0] for u, h in want.fine_states.items()}), ctx
    a, b = view(port), view(ref)
    for key in a:
        assert a[key] == b[key], f"{ctx}: {key}"


# -- the seven scenarios of tests/test_batched_finegrained.py --------------------

def mixed_batch(pk):
    s = pk.scheduler(cluster_total={CPU: 64000, MEM: 131072})
    for name in ("n0", "n1", "n2", "n3"):
        s.add_node(pk.node(name, 16000, 32768))
        s.update_node_metric(pk.metric(
            name, {CPU: 500} if name == "n3" else {CPU: 4000}))
    s.update_node_topology("n0", pk.numa())
    s.update_node_topology("n1", pk.numa())
    s.update_node_devices("n2", pk.gpus())
    s.update_reservation(pk.resv("resv-ml", "n3", 8000, {"team": "ml"},
                                 False))
    s.update_quota(pk.T.QuotaSpec(name="t", min=pk.res({CPU: 1000}),
                                  max=pk.res({CPU: 4000})))
    s.update_gang(pk.T.GangSpec(name="g", min_member=2))
    for name in ("n0", "n1", "n2"):
        s.add_pod(pk.pod(f"filler-{name}", {CPU: 2000}, node_name=name))
    for pod in (
        pk.pod("lsr", {CPU: 4000, MEM: 2048}, qos="LSR",
               spec={"cpuBindPolicy": "FullPCPUs"}),
        pk.pod("gpu1", {CPU: 2000, MEM: 1024},
               device_requests={"nvidia.com/gpu": 2}),
        pk.pod("mlres", {CPU: 15000, MEM: 1024}, labels={"team": "ml"},
               priority=100),
        pk.pod("q1", {CPU: 3000}, quota="t"),
        pk.pod("q2", {CPU: 3000}, quota="t"),
        pk.pod("g1", {CPU: 1000}, gang="g"),
        pk.pod("g2", {CPU: 1000}, gang="g"),
        pk.pod("plain", {CPU: 1000, MEM: 512}),
    ):
        s.add_pod(pod)
    return s, [s.schedule_pending(now=100.0)]


def cpuset_conflict(pk):
    s = pk.scheduler()
    for name in ("n0", "n1"):
        s.add_node(pk.node(name, 16000, 32768))
        s.update_node_metric(pk.metric(name, {}))
    s.update_node_topology("n0", pk.numa(policy=""))
    s.add_pod(pk.pod("c1", {CPU: 10000}, qos="LSR"))
    s.add_pod(pk.pod("c2", {CPU: 10000}, qos="LSR"))
    return s, [s.schedule_pending(now=100.0)]


def reservation_credit(pk):
    s = pk.scheduler()
    s.add_node(pk.node("n0", 10000, 32768))
    s.update_node_metric(pk.metric("n0", {}))
    s.update_reservation(pk.resv("resv", "n0", 8000, {"team": "ml"}, False))
    s.add_pod(pk.pod("other", {CPU: 4000}))
    s.add_pod(pk.pod("mlpod", {CPU: 4000}, labels={"team": "ml"}))
    out = [s.schedule_pending(now=100.0)]
    s.add_pod(pk.pod("other2", {CPU: 3000}))
    s.add_pod(pk.pod("ml2", {CPU: 3000}, labels={"team": "ml"}))
    out.append(s.schedule_pending(now=101.0))
    return s, out


def allocate_once(pk):
    s = pk.scheduler()
    s.add_node(pk.node("n0", 10000, 32768))
    s.update_node_metric(pk.metric("n0", {}))
    s.update_reservation(pk.resv("resv", "n0", 8000, {"team": "ml"}, True))
    s.add_pod(pk.pod("ml1", {CPU: 2000}, labels={"team": "ml"}))
    s.add_pod(pk.pod("other", {CPU: 5000}))
    return s, [s.schedule_pending(now=100.0)]


def gang_rollback(pk):
    s = pk.scheduler()
    s.add_node(pk.node("n0", 4000, 8192))
    s.update_node_metric(pk.metric("n0", {}))
    s.update_node_topology("n0", pk.numa(policy=""))
    s.update_reservation(pk.resv("resv", "n0", 2000, {"team": "ml"}, False))
    s.update_gang(pk.T.GangSpec(name="g", min_member=2))
    s.add_pod(pk.pod("ga", {CPU: 2000}, gang="g", qos="LSR",
                     labels={"team": "ml"}))
    s.add_pod(pk.pod("gb", {CPU: 8000}, gang="g"))
    return s, [s.schedule_pending(now=100.0)]


def waiting_quota(pk):
    s = pk.scheduler()
    s.add_node(pk.node("n0", 16000, 32768))
    s.update_node_metric(pk.metric("n0", {}))
    # a cpuset for the waiting member, so its holds wait with it
    s.update_node_topology("n0", pk.numa(policy=""))
    s.update_quota(pk.T.QuotaSpec(name="t", min=pk.res({CPU: 1000}),
                                  max=pk.res({CPU: 8000})))
    s.update_gang(pk.T.GangSpec(name="g", min_member=2,
                                mode=pk.T.GangMode.NON_STRICT))
    pod = pk.pod("w1", {CPU: 2000}, gang="g", quota="t", qos="LSR")
    s.add_pod(pod)
    out = [s.schedule_pending(now=100.0)]
    assert set(s._fine_waiting) == {"default/w1"}
    s.remove_pod(pod)
    return s, out


def device_conflict(pk):
    s = pk.scheduler()
    for name in ("n0", "n1"):
        s.add_node(pk.node(name, 16000, 32768))
        s.update_node_metric(pk.metric(name, {}))
    s.update_node_devices("n0", pk.gpus(4))
    for name in ("g1", "g2"):
        s.add_pod(pk.pod(name, {CPU: 1000},
                         device_requests={"nvidia.com/gpu": 3}))
    return s, [s.schedule_pending(now=100.0)]


SCENARIOS = {
    "mixed_batch": mixed_batch,
    "cpuset_conflict": cpuset_conflict,
    "reservation_credit": reservation_credit,
    "allocate_once": allocate_once,
    "gang_rollback": gang_rollback,
    "waiting_quota": waiting_quota,
    "device_conflict": device_conflict,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    ref, want = SCENARIOS[name](REF)
    port, got = SCENARIOS[name](PORT)
    assert len(got) == len(want)
    for r, (g, w) in enumerate(zip(got, want)):
        assert dict(g) == dict(w), f"{name} round {r}"
        assert g.waiting == w.waiting, f"{name} round {r}"
    a, b = view(port), view(ref)
    for key in a:
        assert a[key] == b[key], f"{name}: {key}"
    # what the reference's own scenario asserts, on the port
    if name == "mixed_batch":
        lsr = port.cache.pods["default/lsr"]
        status = json.loads(lsr.annotations[
            PORT.X.ANNOTATION_RESOURCE_STATUS])
        assert lsr.node_name in ("n0", "n1") and len(status["cpuset"]) == 4
        gpu = json.loads(port.cache.pods["default/gpu1"].annotations[
            PORT.X.ANNOTATION_DEVICE_ALLOCATED])
        assert len(gpu["gpu"]) == 2
        assert port.cache.pods["default/mlres"].node_name == "n3"
    elif name == "cpuset_conflict":
        assert [u for u, n in got[0].items() if n] == ["default/c1"]
        assert len(port.numa_manager.get_allocated_cpuset(
            "n0", "default/c1")) == 10
    elif name == "gang_rollback":
        assert got[0]["default/ga"] is None
        assert port.numa_manager.get_allocated_cpuset(
            "n0", "default/ga") is None
    elif name == "waiting_quota":
        assert got[0].waiting == {"default/w1": "n0"}
        assert port.quota_manager.quotas["t"].used[CPU] == 0
        # the deleted waiting pod's cpuset was released with it
        assert port._fine_waiting == {}
        assert port.numa_manager.get_allocated_cpuset(
            "n0", "default/w1") is None
    elif name == "device_conflict":
        assert sorted(u for u, n in got[0].items() if n) == ["default/g1"]


# -- one seeded intake stream ----------------------------------------------------

N_NODES = 12


def _stream(seed, rounds):
    """``[(now, [events])]``: nodes with and without NUMA topology and
    GPUs, zone labels, and per round a wave of plain, cpuset (LSR,
    FullPCPUs or required bind), NUMA-policy, GPU, host-port and
    node-selector pods, some in gangs (one NonStrict whose WaitTime
    elapses), then deletions of pending and bound pods."""
    rng = np.random.default_rng(seed)
    setup = []
    for i in range(N_NODES):
        setup.append(("node", dict(name=f"n{i}", cpu=16000, mem=32768,
                                   zone=f"z{i % 3}")))
        setup.append(("metric", dict(node=f"n{i}", usage={
            CPU: int(rng.integers(0, 4000)),
            MEM: int(rng.integers(0, 8000))})))
        if i % 3 != 2:
            setup.append(("topology", dict(
                node=f"n{i}", policy=("", "BestEffort", "Restricted")[i % 3]
                if i % 4 else "SingleNUMANode")))
        if i % 4 == 1:
            setup.append(("devices", dict(node=f"n{i}", n=4)))
    setup.append(("gang", dict(name="gs", min=2, mode="Strict")))
    setup.append(("gang", dict(name="gn", min=5, mode="NonStrict",
                               wait=15.0)))
    pending, bound = [], []
    out = []
    for r in range(rounds):
        now = 100.0 + 10.0 * r
        events = list(setup) if r == 0 else []
        for k in range(12):
            kind = int(rng.integers(0, 7))
            cpu = int(rng.integers(1, 5)) * 1000
            d = dict(name=f"w{r}-{k}", req={CPU: cpu,
                                            MEM: int(rng.integers(256, 4096))},
                     prio=int(rng.integers(0, 3)))
            if kind == 1:
                d["qos"] = "LSR"
                if rng.random() < 0.5:
                    d["spec"] = {"cpuBindPolicy": "FullPCPUs"}
            elif kind == 2:
                d["spec"] = {"numaTopologyPolicy": ("SingleNUMANode",
                                                    "Restricted",
                                                    "BestEffort")[k % 3]}
            elif kind == 3:
                d["gpu"] = int(rng.integers(1, 3))
            elif kind == 4:
                d["ports"] = [int(rng.choice([8080, 9090, 7070]))]
            elif kind == 5:
                d["selector"] = {"zone": f"z{int(rng.integers(0, 3))}"}
            elif kind == 6:
                d["spec"] = {"requiredCPUBindPolicy": True}
            if k % 6 == 0:
                d["gang"] = "gs"
            elif k % 6 == 1 and r < 2:
                d["gang"] = "gn"
            events.append(("pod", d))
            pending.append(d["name"])
        if r >= 1:
            gone = pending.pop(int(rng.integers(0, len(pending))))
            events.append(("remove", f"default/{gone}"))
            if bound:
                events.append(("remove",
                               bound.pop(int(rng.integers(0, len(bound))))))
        out.append((now, events))
    return out, bound


def _apply(s, pk, event):
    kind, d = event
    if kind == "node":
        s.add_node(pk.node(d["name"], d["cpu"], d["mem"],
                           labels={"zone": d["zone"]}))
    elif kind == "metric":
        s.update_node_metric(pk.metric(d["node"], d["usage"]))
    elif kind == "topology":
        s.update_node_topology(d["node"], pk.numa(policy=d["policy"]))
    elif kind == "devices":
        s.update_node_devices(d["node"], pk.gpus(d["n"]))
    elif kind == "gang":
        s.update_gang(pk.T.GangSpec(
            name=d["name"], min_member=d["min"],
            mode=pk.T.GangMode(d["mode"]), wait_time=d.get("wait", 600.0)))
    elif kind == "pod":
        kw = {}
        if "gpu" in d:
            kw["device_requests"] = {"nvidia.com/gpu": d["gpu"]}
        if "ports" in d:
            kw["host_ports"] = list(d["ports"])
        if "selector" in d:
            kw["node_selector"] = dict(d["selector"])
        s.add_pod(pk.pod(d["name"], d["req"], qos=d.get("qos"),
                         spec=d.get("spec"), priority=d["prio"],
                         gang=d.get("gang"), **kw))
    elif kind == "remove":
        cached = s.cache.pods.get(d) or s.cache.pending.get(d)
        if cached is not None:
            s.remove_pod(cached)
    else:
        raise ValueError(kind)


def test_intake_stream_matches_reference():
    ref, port = REF.scheduler(), PORT.scheduler()
    stream, _ = _stream(seed=5, rounds=6)
    seen = dict(cpuset=0, devices=0, waiting=0, released=0, specials=0)
    for r, (now, events) in enumerate(stream):
        for event in events:
            _apply(ref, REF, event)
            _apply(port, PORT, event)
        released = port.expire_waiting(now)
        assert sorted(released) == sorted(ref.expire_waiting(now)), r
        seen["released"] += len(released)
        want = ref.schedule_pending(now=now)
        got = port.schedule_pending(now=now)
        same_round(got, want, ref, port, f"round {r}")
        v = view(port)
        seen["cpuset"] += sum(len(a) for a in v["numa"].values())
        seen["devices"] += sum(len(a[0]) for a in v["devices"].values())
        seen["waiting"] += len(got.fine_states)
        for uid, node in got.items():
            if node is not None:
                port.cache.finish_binding(uid)
                ref.cache.finish_binding(uid)
        # a bound pod with holds leaves: its cpuset and devices go back
        held = sorted(u for a in v["numa"].values() for u in a
                      if u in port.cache.pods and u not in port._waiting)
        if held:
            uid = held[r % len(held)]
            ref.remove_pod(ref.cache.pods[uid])
            port.remove_pod(port.cache.pods[uid])
            assert all(uid not in a for a in view(port)["numa"].values())
            assert view(port) == view(ref)
    assert seen["cpuset"] and seen["devices"] and seen["waiting"]
    assert seen["released"]


def test_forget_releases_holds():
    """An aborted round: its unpublished decisions, cpusets and devices
    included, are forgotten as the reference forgets them."""
    ref, port = REF.scheduler(), PORT.scheduler()
    stream, _ = _stream(seed=9, rounds=1)
    for s, pk in ((ref, REF), (port, PORT)):
        for event in stream[0][1]:
            _apply(s, pk, event)
    same_round(port.schedule_pending(now=100.0),
               ref.schedule_pending(now=100.0), ref, port)
    assert any(view(port)["numa"].values())
    assert sorted(port.forget_assumed_unbound()) == sorted(
        ref.forget_assumed_unbound())
    assert view(port) == view(ref)
    assert not any(view(port)["numa"].values())
