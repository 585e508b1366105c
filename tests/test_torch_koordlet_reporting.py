"""The port's states informer and reporters against the JAX package's:
``koordlet/statesinformer`` (``StatesInformer`` with its callbacks and PVC
map, ``NodeMetricReporter``, ``PodsInformer``, ``pod_meta_from_spec``,
``NodeTopologyReporter``, ``DeviceReporter``) and ``client/wiring``'s
``KoordletLoop``, ``koordlet_report_sinks`` and ``wire_koordlet``. The
cases are those of ``tests/test_statesinformer_reporting.py``, the
reporter cases of ``tests/test_loadaware_aggregated.py``, the informer and
storage cases of ``tests/test_pvc_storage.py`` and the koordlet cases of
``tests/test_client_bus.py`` (binds reaching the informer, the NRT and
Device CRs reaching the NUMA manager and the device cache, a gang member
waiting at Permit staying invisible), run through both packages' buses,
schedulers and reporters: each asserts the reference's expectations and
returns what it observed, NodeMetric, NRT and Device reports included,
which must be equal."""

import dataclasses
import enum
import importlib
import json
import os

import numpy as np
import pytest


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.DC = mod("device.cache")
        self.MC = mod("koordlet.metriccache")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.SI = mod("koordlet.statesinformer")
        self.CG = mod("koordlet.system.cgroup")
        self.CPU = mod("koordlet.system.cpuinfo")
        self.PS = mod("koordlet.prediction.predict_server")
        self.NM = mod("manager.nodemetric")
        self.S = mod("manager.sloconfig")
        self.NSLO = mod("manager.nodeslo")
        self.H = mod("numa.hints")
        self.bus = mod("client.bus")
        self.client = mod("client")
        self.wiring = mod("client.wiring")
        self._sched = mod("scheduler.scheduler").Scheduler
        self._model = mod("models.placement").PlacementModel

    def res(self, d):
        return {self.X.ResourceName[k]: v for k, v in d.items()}

    def scheduler(self):
        if self.root == "koordinator_tpu":
            return self._sched(model=self._model(use_pallas=False))
        return self._sched(model=self._model(device="cpu"))

    def cfg(self, root):
        root = str(root)
        return self.CG.SystemConfig(proc_root=os.path.join(root, "proc"),
                                    sysfs_root=os.path.join(root, "sys"),
                                    cgroup_root=os.path.join(root, "cg"))


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")


def plain(x):
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def informer_for(P, node="n0", pods=(), policy=(300, 60)):
    informer = P.SI.StatesInformer()
    informer.set_node(P.T.NodeSpec(node, allocatable=P.res(
        {"CPU": 8000, "MEMORY": 16384})))
    informer.set_pods(list(pods))
    informer.set_collect_policy(P.NM.NodeMetricCollectPolicy(*policy))
    return informer


# -- the informer and the NodeMetric reporter ------------------------------------------


def informer_callbacks(P, tmp):
    informer = P.SI.StatesInformer()
    seen = []
    for kind in P.SI.StateKind:
        informer.register_callback(kind, lambda k, v: seen.append(
            (k.name, plain(v))))
    informer.set_node(P.T.NodeSpec("n0"))
    informer.set_pods([P.FW.PodMeta("p1", "kubepods/podp1",
                                    P.X.QoSClass.LS)])
    informer.set_node_slo(P.S.NodeSLOSpec())
    informer.set_collect_policy(P.NM.NodeMetricCollectPolicy(300, 60))
    informer.upsert_pvc(P.T.PVCSpec(name="ns/claim-a", volume_name="pv-1"))
    assert informer.get_volume_name("ns/claim-a") == "pv-1"
    informer.upsert_pvc(P.T.PVCSpec(name="ns/claim-a", volume_name="pv-2"))
    assert informer.get_volume_name("ns/claim-a") == "pv-2"
    informer.remove_pvc("ns/claim-a")
    informer.remove_pvc("ns/ghost")
    assert informer.get_volume_name("ns/claim-a") == ""

    class Stub:
        def get_all_pods(self):
            return [P.FW.PodMeta(uid="p2", cgroup_dir="kubepods/podp2",
                                 qos=P.X.QoSClass.BE)]

    pods = P.SI.PodsInformer(Stub(), informer).sync()
    assert [p.uid for p in informer.running_pods()] == ["p2"]
    return [seen, plain(pods), plain(informer.get_collect_policy())]


def reporter_windows(P, tmp):
    """The extra windows and the system percentiles
    (``test_reporter_fills_extra_windows``), the duration stamp
    (``test_reporter_stamps_aggregated_duration``), no node, no samples."""
    K = P.MC.MetricKind
    mc = P.MC.MetricCache()
    informer = informer_for(P)
    for t in range(0, 1200, 60):
        mc.append(K.NODE_CPU_USAGE, None, float(t),
                  7000.0 if t < 300 else 2000.0)
        mc.append(K.SYS_CPU_USAGE, None, float(t), 300.0)
    m = P.SI.NodeMetricReporter(mc, informer).report(now=1200.0)
    R = P.X.ResourceName
    assert m.aggregated_duration == 300.0
    assert set(m.aggregated_windows) == {900.0, 1800.0}
    assert m.aggregated_windows[1800.0][99][R.CPU] > \
        m.aggregated_usage[99][R.CPU]
    assert m.aggregated_system_usage[300.0][95][R.CPU] == 300
    stamp = P.MC.MetricCache()
    for t in range(10):
        stamp.append(K.NODE_CPU_USAGE, None, float(t), 3000.0)
    s = P.SI.NodeMetricReporter(stamp, informer_for(P)).report(now=10.0)
    assert s.aggregated_usage[95][R.CPU] == 3000
    none = P.SI.NodeMetricReporter(P.MC.MetricCache(),
                                   P.SI.StatesInformer()).report(now=1.0)
    empty = P.SI.NodeMetricReporter(
        P.MC.MetricCache(),
        informer_for(P, policy=(120, 30))).report(now=5.0)
    return [plain(m), plain(s), none, plain(empty)]


def reporter_pods(P, tmp):
    """A seeded node of 12 pods of every QoS and priority band, with host
    applications, disks and a predictor: every field of the report."""
    K = P.MC.MetricKind
    QoS = P.X.QoSClass
    rng = np.random.default_rng(3)
    pods = []
    for i in range(12):
        qos = [QoS.LS, QoS.BE, QoS.LSR, QoS.LSE, QoS.NONE][i % 5]
        pods.append(P.FW.PodMeta(
            f"default/p{i}", f"kubepods/p{i}", qos,
            priority=[0, 9500, 7500, 5500, 3500, 0][i % 6],
            cpu_request_mcpu=int(rng.integers(500, 4000)),
            memory_request_mib=int(rng.integers(256, 4096))))
    informer = informer_for(P, pods=pods, policy=(600, 30))
    informer.set_node_slo(P.S.NodeSLOSpec(host_applications=[
        P.S.HostApplicationSpec(name="agent", qos=QoS.LS),
        P.S.HostApplicationSpec(name="idle", qos=QoS.BE)]))
    mc = P.MC.MetricCache()
    server = P.PS.PeakPredictServer(P.PS.PredictionConfig(
        safety_margin_percent=10, cold_start_seconds=0))
    for t in np.arange(0.0, 1800.0, 30.0):
        t = float(t)
        mc.append(K.NODE_CPU_USAGE, None, t, float(rng.uniform(1000, 7000)))
        mc.append(K.NODE_MEMORY_USAGE, None, t,
                  float(rng.uniform(4000, 15000)))
        mc.append(K.SYS_CPU_USAGE, None, t, float(rng.uniform(100, 900)))
        mc.append(K.SYS_MEMORY_USAGE, None, t, float(rng.uniform(500, 900)))
        for pod in pods[:-2]:   # the last two have no samples
            cpu = float(rng.uniform(0, pod.cpu_request_mcpu))
            mem = float(rng.uniform(0, pod.memory_request_mib))
            mc.append(K.POD_CPU_USAGE, {"pod": pod.uid}, t, cpu)
            mc.append(K.POD_MEMORY_USAGE, {"pod": pod.uid}, t, mem)
            server.update(P.PS.pod_key(pod.uid), cpu, mem, t)
        mc.append(K.HOST_APP_CPU_USAGE, {"app": "agent"}, t,
                  float(rng.uniform(10, 200)))
        for dev in ("vda", "nvme0n1"):
            mc.append(K.NODE_DISK_READ_BPS, {"dev": dev}, t,
                      float(rng.uniform(0, 1e7)))
            mc.append(K.NODE_DISK_IO_UTIL, {"dev": dev}, t,
                      float(rng.uniform(0, 100)))
        server.update(P.PS.priority_key("prod"), 3000.0, 6000.0, t)
        server.update(P.PS.SYS_KEY, 400.0, 700.0, t)
    reporter = P.SI.NodeMetricReporter(mc, informer, predict_server=server)
    m = reporter.report(now=1800.0)
    assert reporter.last_report is m
    assert set(m.pod_usages) == {p.uid for p in pods[:-2]}
    assert m.disk_usages["vda"].read_bps > 0 and m.host_app_usages["agent"]
    later = reporter.report(now=2400.0)
    return [plain(m), plain(later)]


def reporter_disks_on_bus(P, tmp):
    """``test_reporter_carries_disk_usage_on_bus`` and the PVC watch of
    ``tests/test_pvc_storage.py``."""
    K = P.MC.MetricKind
    bus = P.client.APIServer()
    informer = informer_for(P)
    mc = P.MC.MetricCache()
    for t in range(10):
        mc.append(K.NODE_CPU_USAGE, None, float(t), 3000.0)
        mc.append(K.NODE_DISK_READ_BPS, {"dev": "vda"}, float(t), 2_000_000.0)
        mc.append(K.NODE_DISK_WRITE_BPS, {"dev": "vda"}, float(t), 500_000.0)
        mc.append(K.NODE_DISK_IO_UTIL, {"dev": "vda"}, float(t), 42.0)
    loop = P.client.wire_koordlet(bus, informer, "n0",
                                  reporter=P.SI.NodeMetricReporter(mc,
                                                                   informer))
    out = loop.report(now=10.0)
    published = bus.get(P.bus.Kind.NODE_METRIC, "n0")
    assert published is out
    assert published.disk_usages["vda"].read_bps == 2_000_000
    assert published.disk_usages["vda"].io_util_pct == 42
    bus.apply(P.bus.Kind.PVC, "ns/claim-a",
              P.T.PVCSpec(name="ns/claim-a", volume_name="pv-1"))
    assert informer.get_volume_name("ns/claim-a") == "pv-1"
    bus.delete(P.bus.Kind.PVC, "ns/claim-a")
    assert informer.get_volume_name("ns/claim-a") == ""
    bare = P.client.wire_koordlet(bus, P.SI.StatesInformer(), "n1")
    with pytest.raises(RuntimeError):
        bare.report(now=1.0)
    return [plain(published)]


# -- pod metas, topology and devices ----------------------------------------------------


def pod_metas(P, tmp):
    QoS, R = P.X.QoSClass, P.X.ResourceName
    pods = [
        P.T.PodSpec(name="ls", qos=QoS.LS, requests=P.res(
            {"CPU": 1000, "MEMORY": 512}), limits=P.res({"CPU": 2000})),
        P.T.PodSpec(name="be", namespace="batch", qos=QoS.BE, priority=5500,
                    requests={R.BATCH_CPU: 2000, R.BATCH_MEMORY: 1024},
                    limits={R.BATCH_CPU: 3000}, labels={"a": "b"}),
        P.T.PodSpec(name="be-nolimit", qos=QoS.BE,
                    requests={R.BATCH_CPU: 500}),
        P.T.PodSpec(name="lsr", qos=QoS.LSR, annotations={"x": "y"},
                    volumes={"data": "default/claim"}),
        P.T.PodSpec(name="lse", qos=QoS.LSE),
        P.T.PodSpec(name="none")]
    return [plain(P.SI.pod_meta_from_spec(p)) for p in pods]


def fake_proc_sys(root, sockets=1, cores=4, threads=2, numa_nodes=2):
    proc = os.path.join(root, "proc")
    os.makedirs(proc, exist_ok=True)
    n = sockets * cores * threads
    blocks = []
    for cpu in range(n):
        core = cpu // threads
        blocks.append(
            f"processor\t: {cpu}\n"
            f"physical id\t: {core // (cores // sockets) if sockets > 1 else 0}\n"
            f"core id\t: {core}\n")
    with open(os.path.join(proc, "cpuinfo"), "w") as f:
        f.write("\n".join(blocks) + "\n")
    per_node = n // numa_nodes
    for node in range(numa_nodes):
        d = os.path.join(root, "sys", "devices", "system", "node",
                         f"node{node}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "cpulist"), "w") as f:
            f.write(f"{node * per_node}-{(node + 1) * per_node - 1}\n")


def gpus(P, n=2, numa=0):
    DR = P.DC.DeviceResourceName
    return [P.DC.DeviceEntry(
        minor=i, device_type=P.DC.DeviceType.GPU,
        resources={DR.GPU_CORE: 100, DR.GPU_MEMORY: 16384,
                   DR.GPU_MEMORY_RATIO: 100},
        numa_node=numa, pcie_id="0") for i in range(n)]


def topology_and_devices(P, tmp):
    """``test_topology_and_device_reporting_feed_scheduler``: the NRT and
    Device reports into a scheduler, a cpuset pod and a GPU pod placed."""
    R, QoS = P.X.ResourceName, P.X.QoSClass
    fake_proc_sys(str(tmp))
    cfg = P.cfg(tmp)
    s = P.scheduler()
    s.add_node(P.T.NodeSpec(name="node-a", allocatable=P.res(
        {"CPU": 8000, "MEMORY": 32768})))
    s.update_node_metric(P.T.NodeMetric(node_name="node-a", node_usage={},
                                        update_time=99.0))
    nrt = P.SI.NodeTopologyReporter(
        node_name="node-a", system_config=cfg, report=s.update_node_topology,
        policy=P.H.NUMATopologyPolicy.NONE,
        numa_memory_mib={0: 16384, 1: 16384})
    report = nrt.sync()
    opts = s.numa_manager.get_topology("node-a")
    assert opts.cpu_topology.num_cpus == 8
    assert opts.numa_node_resources[0][R.CPU] == 4000
    assert opts.numa_node_resources[1][R.MEMORY] == 16384

    class GPUSource:
        def list_devices(self):
            return gpus(P)

    entries = P.SI.DeviceReporter("node-a", GPUSource(),
                                  s.update_node_devices).sync()
    s.add_pod(P.T.PodSpec(name="pin", qos=QoS.LSR, requests={R.CPU: 2000}))
    s.add_pod(P.T.PodSpec(name="gpu", requests={R.CPU: 1000},
                          device_requests={"nvidia.com/gpu": 1}))
    out = s.schedule_pending(now=100.0)
    assert out["default/pin"] == "node-a" and out["default/gpu"] == "node-a"
    status = json.loads(s.cache.pods["default/pin"].annotations[
        P.X.ANNOTATION_RESOURCE_STATUS])
    assert len(status["cpuset"]) == 2
    assert "default/gpu" in s.device_cache.get("node-a").allocations
    # offline cpus are reserved, not counted
    holes = {}
    P.SI.NodeTopologyReporter(
        "n", cfg, report=lambda name, o: holes.update({name: o}),
        cpu_infos=[P.CPU.ProcessorInfo(0, 0, 0, 0),
                   P.CPU.ProcessorInfo(1, 0, 0, 0),
                   P.CPU.ProcessorInfo(3, 1, 0, 0)]).sync()
    assert holes["n"].numa_node_resources[0][R.CPU] == 3000
    assert tuple(holes["n"].reserved_cpus) == (2,)
    none = P.SI.NodeTopologyReporter(
        "z", P.cfg(tmp / "empty"), report=lambda *a: None).sync()
    return [plain(report), plain(entries), dict(out),
            plain(s.cache.pods["default/pin"].annotations), plain(holes),
            none]


def seeded_topologies(P, tmp):
    """Seeded fake sysfs trees (1-2 sockets, 4-16 cores, 1-2 threads, 1-4
    NUMA nodes) through ``read_cpu_infos`` and ``NodeTopologyReporter``
    under each policy."""
    rng = np.random.default_rng(29)
    out = []
    policies = list(P.H.NUMATopologyPolicy)
    for i in range(8):
        sockets = int(rng.integers(1, 3))
        cores = sockets * int(rng.integers(2, 9))
        threads = int(rng.integers(1, 3))
        numa = [1, 2, 4][int(rng.integers(0, 3))]
        while (cores * threads) % numa:
            numa //= 2
        root = os.path.join(str(tmp), f"t{i}")
        fake_proc_sys(root, sockets, cores, threads, numa)
        got = {}
        P.SI.NodeTopologyReporter(
            f"n{i}", P.cfg(root), report=lambda n, o: got.update({n: o}),
            policy=policies[i % len(policies)],
            numa_memory_mib={k: 1024 * (k + 1) for k in range(numa)}).sync()
        out.append(plain(got))
    return out


# -- the bus: binds, NRT and devices, a waiting gang member -----------------------------


def bus_binds_and_slo(P, tmp):
    """``test_bindings_published_and_koordlet_wired``."""
    Kind, QoS = P.bus.Kind, P.X.QoSClass
    bus = P.client.APIServer()
    s = P.scheduler()
    P.client.wire_scheduler(bus, s)
    informer = P.SI.StatesInformer()
    loop = P.client.wire_koordlet(bus, informer, "n0")
    events = []
    bus.watch(Kind.POD, lambda e, n, o: events.append((e.name, n)))
    bus.apply(Kind.NODE, "n0", P.T.NodeSpec(name="n0", allocatable=P.res(
        {"CPU": 16000, "MEMORY": 32768})))
    bus.apply(Kind.NODE_METRIC, "n0", P.T.NodeMetric(
        node_name="n0", node_usage={}, update_time=99.0))
    bus.apply(Kind.POD, "default/p", P.T.PodSpec(
        name="p", qos=QoS.LS, requests=P.res({"CPU": 1000})))
    assert informer.running_pods() == []
    out = s.schedule_pending(now=100.0)
    assert out["default/p"] == "n0"
    assert ("MODIFIED", "default/p") in events
    metas = informer.running_pods()
    assert [m.uid for m in metas] == ["default/p"]
    assert metas[0].cpu_request_mcpu == 1000
    assert loop.pods()[0].node_name == "n0"
    manager = P.client.wire_manager(bus, nodeslo=P.NSLO.NodeSLOController(),
                                    **({} if P.root == "koordinator_tpu"
                                       else {"device": "cpu"}))
    manager.reconcile(now=100.0)
    assert informer.get_node_slo() is bus.get(Kind.NODE_SLO, "n0")
    slo = plain(informer.get_node_slo())
    bus.delete(Kind.POD, "default/p")
    assert informer.running_pods() == []
    return [dict(out), events, plain(metas), slo, plain(informer.get_node())]


def bus_nrt_and_devices(P, tmp):
    """``test_koordlet_reports_nrt_and_devices_over_bus``, then a loop
    report publishing all three."""
    Kind = P.bus.Kind
    bus = P.client.APIServer()
    s = P.scheduler()
    P.client.wire_scheduler(bus, s)
    informer = informer_for(P)
    topo_sink, dev_sink = P.wiring.koordlet_report_sinks(bus)

    class FakeDevices:
        def list_devices(self):
            return gpus(P, 1)

    infos = [P.CPU.ProcessorInfo(cpu_id=i, core_id=i % 2, socket_id=0,
                                 node_id=0) for i in range(4)]
    mc = P.MC.MetricCache()
    mc.append(P.MC.MetricKind.NODE_CPU_USAGE, None, 5.0, 1234.0)
    loop = P.client.wire_koordlet(
        bus, informer, "n0",
        reporter=P.SI.NodeMetricReporter(mc, informer),
        topology_reporter=P.SI.NodeTopologyReporter(
            "n0", P.cfg(tmp), topo_sink, cpu_infos=infos),
        device_reporter=P.SI.DeviceReporter("n0", FakeDevices(), dev_sink))
    loop.topology_reporter.sync()
    loop.device_reporter.sync()
    assert bus.get(Kind.NODE_RESOURCE_TOPOLOGY, "n0") is not None
    assert bus.get(Kind.DEVICE, "n0")[0].minor == 0
    assert s.numa_manager.get_topology("n0").numa_node_resources
    assert s.device_cache.get("n0").device_infos
    metric = loop.report(now=10.0)
    assert bus.get(Kind.NODE_METRIC, "n0") is metric
    assert s.numa_manager.get_topology("n0") is bus.get(
        Kind.NODE_RESOURCE_TOPOLOGY, "n0")
    return [plain(metric), plain(bus.get(Kind.NODE_RESOURCE_TOPOLOGY, "n0")),
            plain(bus.get(Kind.DEVICE, "n0"))]


def bus_waiting_gang_member(P, tmp):
    """``test_waiting_gang_member_not_visible_to_koordlet``."""
    Kind = P.bus.Kind
    bus = P.client.APIServer()
    s = P.scheduler()
    P.client.wire_scheduler(bus, s)
    informer = P.SI.StatesInformer()
    P.client.wire_koordlet(bus, informer, "n0")
    bus.apply(Kind.NODE, "n0", P.T.NodeSpec(name="n0", allocatable=P.res(
        {"CPU": 16000, "MEMORY": 32768})))
    bus.apply(Kind.NODE_METRIC, "n0", P.T.NodeMetric(
        node_name="n0", node_usage={}, update_time=99.0))
    bus.apply(Kind.GANG, "g", P.T.GangSpec(name="g", min_member=2,
                                           mode=P.T.GangMode.NON_STRICT))
    bus.apply(Kind.POD, "default/m0", P.T.PodSpec(
        name="m0", gang="g", requests=P.res({"CPU": 1000})))
    out = s.schedule_pending(now=100.0)
    assert out["default/m0"] is None and out.waiting["default/m0"] == "n0"
    assert s.cache.pods["default/m0"].waiting_permit
    bus.apply(Kind.POD, "default/m0", s.cache.pods["default/m0"])
    assert informer.running_pods() == []
    bus.apply(Kind.POD, "default/m1", P.T.PodSpec(
        name="m1", gang="g", requests=P.res({"CPU": 1000})))
    out2 = s.schedule_pending(now=101.0)
    assert out2["default/m0"] == "n0" and out2["default/m1"] == "n0"
    assert sorted(m.uid for m in informer.running_pods()) == [
        "default/m0", "default/m1"]
    return [dict(out), out.waiting, dict(out2),
            plain(sorted(informer.running_pods(), key=lambda m: m.uid))]


CASES = {f.__name__: f for f in (
    informer_callbacks, reporter_windows, reporter_pods,
    reporter_disks_on_bus, pod_metas, topology_and_devices,
    seeded_topologies, bus_binds_and_slo, bus_nrt_and_devices,
    bus_waiting_gang_member)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case, tmp_path):
    ref = CASES[case](REF, tmp_path / "ref")
    port = CASES[case](PORT, tmp_path / "port")
    assert plain(port) == plain(ref)


def test_types_carry_the_agents_fields():
    """The agent's fields of the port's objects are the reference's:
    ``PodSpec.volumes``, ``NodeMetric.disk_usages``, ``DiskUsage`` and
    ``PVCSpec``."""
    for name in ("PodSpec", "NodeMetric", "DiskUsage", "PVCSpec"):
        ref = {f.name: f.default for f in
               dataclasses.fields(getattr(REF.T, name))}
        port = {f.name: f.default for f in
                dataclasses.fields(getattr(PORT.T, name))}
        assert port == ref, name
