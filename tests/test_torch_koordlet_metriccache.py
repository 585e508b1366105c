"""The port's metric cache and collectors against the JAX package's:
``koordlet/metriccache`` (queries, ``aggregate``, ``aggregate_batch``,
``gc``, ``save``/``load``) and ``koordlet/metricsadvisor`` (the framework,
the node, pod, BE, system, PSI, cold-page, page-cache and host-application
collectors, and the device, throttling and storage collectors of
``metricsadvisor/devices.py``). The cases are those of
``tests/test_metriccache.py``, ``tests/test_device_telemetry.py`` and the
kidled and ``CollectorContext`` cases of ``tests/test_system_extras.py``,
plus a seeded run of ``default_collectors()`` over a fake procfs, cgroupfs
and sysfs tree under ``tmp_path``: both packages read the same tree on the
same fake-clock ticks, and their caches must be identical, series by
series, float64 bit for bit. A ``save`` by one package loads in the
other, both ways."""

import dataclasses
import enum
import importlib
import math
import os

import numpy as np
import pytest


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.X = mod("apis.extension")
        self.DC = mod("device.cache")
        self.MC = mod("koordlet.metriccache")
        self.MCM = mod("koordlet.metriccache.metric_cache")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.CO = mod("koordlet.metricsadvisor.collectors")
        self.DV = mod("koordlet.metricsadvisor.devices")
        self.CG = mod("koordlet.system.cgroup")
        self.EX = mod("koordlet.resourceexecutor.executor")
        self.S = mod("manager.sloconfig")

    def cfg(self, root, v2=False):
        root = str(root)
        return self.CG.SystemConfig(cgroup_root=os.path.join(root, "cgroup"),
                                    proc_root=os.path.join(root, "proc"),
                                    sysfs_root=os.path.join(root, "sys"),
                                    use_cgroup_v2=v2)

    def kind(self, name):
        return self.MC.MetricKind[name]


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")
AGGS = ("AVG", "P50", "P90", "P95", "P99", "LAST", "COUNT")


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
    return x


def dump(mc):
    """Every series of a cache (its kind, labels and chronological
    points) and its KV store, plain data."""
    return {repr(key): [ring.window(-math.inf, math.inf)[0].tolist(),
                        ring.window(-math.inf, math.inf)[1].tolist()]
            for key, ring in sorted(mc._series.items())}, dict(mc._kv)


class StaticPods:
    def __init__(self, pods):
        self.pods = pods

    def running_pods(self):
        return self.pods


# -- the cache ---------------------------------------------------------------------


def cache_queries(P, tmp):
    K, A = P.MC.MetricKind, P.MC.AggregationType
    mc = P.MC.MetricCache()
    for t in range(10):
        mc.append(K.NODE_CPU_USAGE, None, float(t), t * 100.0)
    ts, vals = mc.query(K.NODE_CPU_USAGE, start=3.0, end=7.0)
    assert list(ts) == [3.0, 4.0, 5.0, 6.0, 7.0] and vals[0] == 300.0
    ring = P.MC.MetricCache(capacity_per_series=4)
    for t in range(6):
        ring.append(K.NODE_CPU_USAGE, None, float(t), float(t))
    assert list(ring.query(K.NODE_CPU_USAGE)[0]) == [2.0, 3.0, 4.0, 5.0]
    five = P.MC.MetricCache()
    for i, v in enumerate([5.0, 1.0, 3.0, 2.0, 4.0]):
        five.append(K.NODE_CPU_USAGE, None, float(i), v)
    got = {a: five.aggregate(K.NODE_CPU_USAGE, agg=A[a]) for a in AGGS}
    assert got == {"AVG": 3.0, "P50": 2.0, "P90": 4.0, "P95": 4.0,
                   "P99": 4.0, "LAST": 4.0, "COUNT": 5.0}
    assert five.aggregate(K.POD_CPU_USAGE, {"pod": "x"}) is None
    mc.append(K.POD_CPU_USAGE, {"pod": "a"}, 1.0, 100.0)
    mc.append(K.POD_CPU_USAGE, {"pod": "b"}, 1.0, 200.0)
    assert mc.aggregate(K.POD_CPU_USAGE, {"pod": "a"}, agg=A.LAST) == 100.0
    mc.set("node_cpu_info", {"cores": 8})
    assert mc.get("node_cpu_info")["cores"] == 8 and mc.get("x") is None
    gc = P.MC.MetricCache(retention_seconds=60)
    gc.append(K.POD_CPU_USAGE, {"pod": "old"}, 10.0, 1.0)
    gc.append(K.POD_CPU_USAGE, {"pod": "new"}, 100.0, 1.0)
    assert gc.gc(now=120.0) == 1
    assert gc.aggregate(K.POD_CPU_USAGE, {"pod": "old"}, agg=A.LAST) is None
    disks = P.MC.MetricCache()
    disks.append(K.NODE_DISK_READ_BPS, {"dev": "vda"}, 0.0, 1.0)
    disks.append(K.NODE_DISK_READ_BPS, {"dev": "sdb"}, 0.0, 1.0)
    disks.append(K.POD_CPU_USAGE, {"pod": "x"}, 0.0, 1.0)
    assert disks.label_values(K.NODE_DISK_READ_BPS, "dev") == ["sdb", "vda"]
    points = [P.MCM.aggregate_points(np.array(v), A[a]) for a in AGGS
              for v in ([], [7.0], [3.0, 1.0, 2.0], list(range(100)))]
    return [dump(mc), dump(ring), got, dump(gc), points,
            [[K[k].value for k in K.__members__], list(A.__members__)]]


def cache_batch(P, tmp):
    """The reference's batch == scalar case, then a seeded cache of
    ragged series, stale ones and empty ones through ``aggregate_batch``
    in several windows, every aggregation, ``gc`` at two times."""
    K, A = P.MC.MetricKind, P.MC.AggregationType
    mc = P.MC.MetricCache()
    rng = np.random.default_rng(0)
    pods = [f"p{i}" for i in range(5)]
    for p in pods:
        for t in range(rng.integers(1, 20)):
            mc.append(K.POD_CPU_USAGE, {"pod": p}, float(t),
                      float(rng.uniform(0, 1000)))
    reqs = [(K.POD_CPU_USAGE, {"pod": p}) for p in pods]
    aggs = [A[a] for a in AGGS]
    batch = mc.aggregate_batch(reqs, 0.0, 100.0, aggs)
    for (kind, labels), res in zip(reqs, batch):
        for a in aggs:
            assert res[a] == pytest.approx(
                mc.aggregate(kind, labels, 0.0, 100.0, a))
    empty = mc.aggregate_batch(
        [(K.POD_CPU_USAGE, {"pod": "p0"}), (K.POD_CPU_USAGE, {"pod": "x"})],
        0.0, 10.0, [A.AVG])
    assert empty[1][A.AVG] is None
    rng = np.random.default_rng(19)
    big = P.MC.MetricCache(capacity_per_series=64, retention_seconds=600)
    series = [(K.POD_MEMORY_USAGE, {"pod": f"q{i}"}) for i in range(40)]
    for kind, labels in series:
        start = float(rng.integers(0, 900))
        for t in np.sort(rng.uniform(start, start + 1200,
                                     rng.integers(0, 90))):
            big.append(kind, labels, float(t), float(rng.gamma(2.0, 300.0)))
    windows = [big.aggregate_batch(series + [(K.NODE_CPU_USAGE, None)],
                                   lo, hi, aggs)
               for lo, hi in ((0.0, 2400.0), (600.0, 900.0),
                              (1500.0, 1800.0), (5000.0, 6000.0))]
    nothing = big.aggregate_batch([], 0.0, 1.0, aggs)
    dropped = [big.gc(now=1500.0), big.gc(now=2500.0)]
    return [plain(batch), plain(empty), plain(windows), nothing, dropped,
            dump(big)]


def cache_file(P, tmp):
    K, A = P.MC.MetricKind, P.MC.AggregationType
    mc = P.MC.MetricCache()
    for t in range(20):
        mc.append(K.NODE_CPU_USAGE, None, float(t), 100.0 + t)
        mc.append(K.POD_CPU_USAGE, {"pod": "u1"}, float(t), 50.0 + t)
    path = str(tmp / "tsdb.npz")
    os.makedirs(tmp, exist_ok=True)
    mc.save(path)
    fresh = P.MC.MetricCache()
    assert fresh.load(path)
    for kind, labels in ((K.NODE_CPU_USAGE, None),
                         (K.POD_CPU_USAGE, {"pod": "u1"})):
        for agg in (A.AVG, A.P90, A.LAST, A.COUNT):
            assert fresh.aggregate(kind, labels, agg=agg) == \
                mc.aggregate(kind, labels, agg=agg)
    assert not fresh.load(str(tmp / "absent.npz"))
    bad = tmp / "bad.npz"
    bad.write_bytes(b"not an npz")
    assert not fresh.load(str(bad))
    return [dump(fresh)]


# -- the collectors ------------------------------------------------------------------


def write_proc_stat(proc, busy, idle=1000):
    os.makedirs(proc, exist_ok=True)
    with open(os.path.join(proc, "stat"), "w") as f:
        f.write(f"cpu  {busy} 0 0 {idle} 0 0 0 0 0 0\n")
        f.write("cpu0 0 0 0 0 0 0 0 0 0 0\n")


def write_meminfo(proc, total_kb, avail_kb, cached_kb=None):
    with open(os.path.join(proc, "meminfo"), "w") as f:
        f.write(f"MemTotal: {total_kb} kB\nMemFree: 0 kB\n"
                f"MemAvailable: {avail_kb} kB\n")
        if cached_kb is not None:
            f.write(f"Cached: {cached_kb} kB\n")


def write_pod_cgroup(P, cfg, pod_dir, cpu_ns, mem_bytes):
    P.EX.ensure_cgroup_dir(pod_dir, cfg)
    if cfg.use_cgroup_v2:
        P.CG.CPU_ACCT_USAGE.write(pod_dir, f"usage_usec {cpu_ns // 1000}\n"
                                  "user_usec 0\n", cfg)
    else:
        P.CG.CPU_ACCT_USAGE.write(pod_dir, str(cpu_ns), cfg)
    P.CG.MEMORY_USAGE.write(pod_dir, str(mem_bytes), cfg)


def env(P, tmp):
    cfg = P.cfg(tmp)
    write_proc_stat(cfg.proc_root, busy=0)
    write_meminfo(cfg.proc_root, 16 * 1024 * 1024, 8 * 1024 * 1024)
    return cfg, P.MC.MetricCache()


def node_and_pods(P, tmp):
    cfg, mc = env(P, tmp)
    K, A = P.MC.MetricKind, P.MC.AggregationType
    QoS = P.X.QoSClass
    c = P.CO.NodeResourceCollector()
    c.setup(P.FW.CollectorContext(metric_cache=mc, system_config=cfg))
    c.collect(0.0)
    assert mc.aggregate(K.NODE_CPU_USAGE) is None
    write_proc_stat(cfg.proc_root, busy=200)
    c.collect(1.0)
    assert mc.aggregate(K.NODE_CPU_USAGE, agg=A.LAST) == pytest.approx(2000)
    assert mc.aggregate(K.NODE_MEMORY_USAGE, agg=A.LAST) == pytest.approx(
        8192.0)
    pods = [P.FW.PodMeta("be-1", "kubepods/besteffort/be-1", QoS.BE),
            P.FW.PodMeta("ls-1", "kubepods/burstable/ls-1", QoS.LS)]
    write_pod_cgroup(P, cfg, pods[0].cgroup_dir, 0, 512 * 2**20)
    write_pod_cgroup(P, cfg, pods[1].cgroup_dir, 0, 1024 * 2**20)
    pmc = P.MC.MetricCache()
    ctx = P.FW.CollectorContext(metric_cache=pmc, system_config=cfg,
                                pod_provider=StaticPods(pods))
    adv = P.FW.MetricsAdvisor(ctx, [
        P.CO.NodeResourceCollector(), P.CO.PodResourceCollector(),
        P.CO.BEResourceCollector(), P.CO.SysResourceCollector()])
    adv.collect_all(0.0)
    write_proc_stat(cfg.proc_root, busy=500)
    write_pod_cgroup(P, cfg, pods[0].cgroup_dir, int(0.5e9), 512 * 2**20)
    write_pod_cgroup(P, cfg, pods[1].cgroup_dir, int(1.0e9), 1024 * 2**20)
    adv.collect_all(1.0)
    last = lambda k, lb=None: pmc.aggregate(K[k], lb, agg=A.LAST)  # noqa
    assert last("POD_CPU_USAGE", {"pod": "be-1"}) == pytest.approx(500.0)
    assert last("POD_MEMORY_USAGE", {"pod": "ls-1"}) == pytest.approx(1024)
    assert last("BE_CPU_USAGE") == pytest.approx(500.0)
    assert last("SYS_CPU_USAGE") == pytest.approx(1500.0)
    # a counter that went backwards (a container restart) clamps to 0
    write_pod_cgroup(P, cfg, pods[1].cgroup_dir, int(1e8), 1024 * 2**20)
    adv.collect_all(2.0)
    assert last("POD_CPU_USAGE", {"pod": "ls-1"}) == 0.0
    # the advisor's interval
    imc = P.MC.MetricCache()
    iadv = P.FW.MetricsAdvisor(P.FW.CollectorContext(
        metric_cache=imc, system_config=cfg), [P.CO.NodeResourceCollector()],
        interval_seconds=10.0)
    iadv.tick(0.0)
    write_proc_stat(cfg.proc_root, busy=600)
    iadv.tick(5.0)
    iadv.tick(10.0)
    assert imc.aggregate(K.NODE_CPU_USAGE, agg=A.LAST) == pytest.approx(100.0)
    return [dump(mc), dump(pmc), dump(imc), plain(ctx.latest_pod_usage),
            ctx.latest_node_usage]


def psi_pagecache_kidled(P, tmp):
    cfg, mc = env(P, tmp)
    K, A = P.MC.MetricKind, P.MC.AggregationType
    pdir = os.path.join(cfg.proc_root, "pressure")
    os.makedirs(pdir)
    for name, text in (
            ("cpu", "some avg10=1.50 avg60=0.80 avg300=0.30 total=100\n"),
            ("memory", "some avg10=2.00 avg60=0 avg300=0 total=0\n"
                       "full avg10=0.75 avg60=0 avg300=0 total=0\n"),
            ("io", "some avg10=0.10 avg60=0 avg300=0 total=0\n")):
        with open(os.path.join(pdir, name), "w") as f:
            f.write(text)
    ctx = P.FW.CollectorContext(metric_cache=mc, system_config=cfg)
    psi = P.CO.PSICollector()
    psi.setup(ctx)
    assert psi.enabled()
    psi.collect(1.0)
    assert mc.aggregate(K.PSI_CPU_SOME_AVG10, agg=A.LAST) == 1.50
    assert mc.aggregate(K.PSI_MEM_FULL_AVG10, agg=A.LAST) == 0.75
    write_meminfo(cfg.proc_root, 16384000, 8000000, cached_kb=2048000)
    page = P.CO.PageCacheCollector()
    page.setup(ctx)
    assert page.enabled()
    page.collect(1.0)
    assert list(mc.query(K.NODE_PAGE_CACHE_MIB)[1]) == [2048000 / 1024.0]
    cold = P.CO.ColdMemoryCollector(cold_boundary=3)
    cold.setup(ctx)
    off = cold.enabled()
    kid = os.path.join(cfg.sysfs_root, "kernel", "mm", "kidled")
    os.makedirs(kid)
    with open(os.path.join(kid, "scan_period_in_seconds"), "w") as f:
        f.write("0\n")
    os.makedirs(os.path.join(cfg.cgroup_root, "memory"))
    with open(os.path.join(cfg.cgroup_root, "memory",
                           "memory.idle_page_stats"), "w") as f:
        f.write("# version: 1.0\n# scan_period_in_seconds: 120\n"
                "# use_hierarchy: 1\n# buckets: 1,2,5,15,30,60,120,240\n"
                "cfei 0 0 100 200 300 0 0 0\ndfei 0 0 0 50 0 0 0 0\n"
                "cfui 0 0 0 0 25 0 0 0\ndfui 0 0 0 0 0 0 0 0\n"
                "csei 999 0 0 0 0 0 0 0\n")
    cold = P.CO.ColdMemoryCollector(cold_boundary=3)
    cold.setup(ctx)
    assert cold.enabled()
    cold.collect(2.0)
    assert list(mc.query(K.NODE_COLD_PAGE_BYTES)[1]) == [575.0]
    with open(os.path.join(kid, "scan_period_in_seconds")) as f:
        period = f.read()
    assert P.CO.read_psi_avg10(os.path.join(pdir, "missing")) is None
    return [dump(mc), off, period]


def host_applications(P, tmp):
    cfg, mc = env(P, tmp)
    K, A = P.MC.MetricKind, P.MC.AggregationType
    apps = [P.S.HostApplicationSpec(name="agent", qos=P.X.QoSClass.LS,
                                    cgroup_dir="host/agent"),
            P.S.HostApplicationSpec(name="agent", cgroup_dir="host/dup"),
            P.S.HostApplicationSpec(name="log", cgroup_dir="host/log"),
            P.S.HostApplicationSpec(name="nodir")]
    slo = P.S.NodeSLOSpec(host_applications=apps)
    c = P.CO.HostApplicationCollector(slo_provider=lambda: slo)
    c.setup(P.FW.CollectorContext(metric_cache=mc, system_config=cfg))
    assert c.enabled()
    for t, (a, b) in enumerate(((0, 0), (2 * 10**9, 10**9),
                                (3 * 10**9, 5 * 10**9))):
        write_pod_cgroup(P, cfg, "host/agent", a, 100 * 2**20 + t)
        write_pod_cgroup(P, cfg, "host/log", b, 50 * 2**20)
        c.collect(float(t))
    assert mc.aggregate(K.HOST_APP_CPU_USAGE, {"app": "agent"},
                        agg=A.LAST) == pytest.approx(1000.0)
    assert not P.CO.HostApplicationCollector().enabled()
    return [dump(mc)]


def devices(P, tmp):
    cfg, mc = env(P, tmp)
    K, A = P.MC.MetricKind, P.MC.AggregationType
    DR = P.DC.DeviceResourceName
    c = P.DV.DeviceCollector()
    c.setup(P.FW.CollectorContext(metric_cache=mc, system_config=cfg))
    assert not c.enabled() and c.list_devices() == []
    for minor, kw in ((0, dict(device_type="gpu", mem_used=2048,
                               utilization=35, numa=1, pcie="0000:1a")),
                      (1, dict(device_type="gpu", healthy=0,
                               utilization=90)),
                      (2, dict(device_type="tpu")),
                      (3, dict(device_type="npu", mem_total=81920))):
        write_accel(cfg.sysfs_root, minor, **kw)
    assert c.enabled()
    found = c.list_devices()
    assert [d.minor for d in found] == [0, 1, 2, 3]
    assert found[0].device_type is P.DC.DeviceType.GPU
    assert found[0].resources[DR.GPU_MEMORY] == 16384
    assert found[0].numa_node == 1 and found[0].pcie_id == "0000:1a"
    assert found[0].health and not found[1].health
    assert found[2].labels["type"] == "tpu"
    c.collect(10.0)
    assert mc.aggregate(K.DEVICE_UTIL, {"minor": "0"}, agg=A.LAST) == 35.0
    # throttling: +100 periods, +25 throttled -> 0.25
    pod = P.FW.PodMeta("p1", "kubepods/p1", P.X.QoSClass.LS)
    th = P.DV.PodThrottledCollector()
    th.setup(P.FW.CollectorContext(metric_cache=mc, system_config=cfg,
                                   pod_provider=StaticPods([pod])))
    for t, (periods, throttled) in enumerate(((100, 10), (200, 35),
                                              (200, 35), (300, 200))):
        write_cpu_stat(P, cfg, pod.cgroup_dir, periods, throttled)
        th.collect(float(t))
    assert mc.aggregate(K.POD_CPU_THROTTLED_RATIO, {"pod": "p1"},
                        agg=A.P50) == pytest.approx(0.25)
    # storage: partitions skipped, rates and io util
    st = P.DV.NodeStorageInfoCollector()
    st.setup(P.FW.CollectorContext(metric_cache=mc, system_config=cfg))
    assert not st.enabled()
    write_diskstats(cfg, 1000, 2000, 0)
    st.collect(0.0)
    write_diskstats(cfg, 2000, 6000, 250)
    st.collect(1.0)
    assert mc.aggregate(K.NODE_DISK_IO_UTIL, {"dev": "sda"},
                        agg=A.LAST) == pytest.approx(25.0)
    for part in ("sda1", "nvme0n1p1", "mmcblk0p1"):
        assert mc.aggregate(K.NODE_DISK_READ_BPS, {"dev": part}) is None
    return [plain(found), dump(mc),
            P.DV.read_cgroup_cpu_stat(pod.cgroup_dir, cfg),
            P.DV.read_cgroup_cpu_stat("kubepods/ghost", cfg)]


def write_accel(sysfs_root, minor, device_type="tpu", healthy=1,
                mem_total=16384, mem_used=0, utilization=0, numa=0,
                socket=0, pcie="0000:00"):
    d = os.path.join(sysfs_root, "class", "accel", f"accel{minor}")
    os.makedirs(d, exist_ok=True)
    for name, value in (
            ("device_type", device_type), ("healthy", healthy),
            ("mem_total_mib", mem_total), ("mem_used_mib", mem_used),
            ("utilization", utilization), ("numa_node", numa),
            ("socket_id", socket), ("pcie_id", pcie)):
        with open(os.path.join(d, name), "w") as f:
            f.write(str(value))


def write_cpu_stat(P, cfg, cgroup_dir, periods, throttled):
    path = P.CG.CPU_STAT.path(cgroup_dir, cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"nr_periods {periods}\nnr_throttled {throttled}\n"
                f"throttled_time 12345\n")


def write_diskstats(cfg, sectors_read, sectors_written, ticks):
    with open(os.path.join(cfg.proc_root, "diskstats"), "w") as f:
        f.write(f"   8       0 sda 100 0 {sectors_read} 50 200 0 "
                f"{sectors_written} 80 0 {ticks} 500\n"
                "   8       1 sda1 1 0 8 1 1 0 8 1 0 1 1\n"
                f" 259       0 nvme0n1 10 0 {80 + ticks} 5 20 0 160 8 0 10 50\n"
                " 259       1 nvme0n1p1 1 0 8 1 1 0 8 1 0 1 1\n"
                " 179       1 mmcblk0p1 1 0 8 1 1 0 8 1 0 1 1\n")


CASES = {f.__name__: f for f in (
    cache_queries, cache_batch, cache_file, node_and_pods,
    psi_pagecache_kidled, host_applications, devices)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case, tmp_path):
    ref = CASES[case](REF, tmp_path / "ref")
    port = CASES[case](PORT, tmp_path / "port")
    assert plain(port) == plain(ref)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_save_loads_in_the_other_package(direction, tmp_path):
    """One package's ``save`` and the other's ``load``: the same series,
    the same aggregates."""
    src, dst = (REF, PORT) if direction == "ref_to_port" else (PORT, REF)
    rng = np.random.default_rng(7)
    mc = src.MC.MetricCache(capacity_per_series=32)
    kinds = ("NODE_CPU_USAGE", "POD_CPU_USAGE", "NODE_DISK_READ_BPS")
    labels = (None, {"pod": "default/a"}, {"dev": "vda"})
    for t in range(50):
        for k, lb in zip(kinds, labels):
            mc.append(src.kind(k), lb, float(t) + 0.5,
                      float(rng.normal(1000, 200)))
    path = str(tmp_path / "tsdb.npz")
    mc.save(path)
    loaded = dst.MC.MetricCache(capacity_per_series=32)
    assert loaded.load(path)
    assert dump(loaded) == dump(mc)
    for k, lb in zip(kinds, labels):
        for a in AGGS:
            assert loaded.aggregate(dst.kind(k), lb, 10.0, 40.0,
                                    dst.MC.AggregationType[a]) == \
                mc.aggregate(src.kind(k), lb, 10.0, 40.0,
                             src.MC.AggregationType[a])


# -- default_collectors() over one seeded tree ---------------------------------------

TICKS = 12


class Tree:
    """A seeded node: /proc (stat, meminfo, pressure, diskstats), a v1 or
    v2 cgroupfs with 6 pods (one BE pair) and their containers, a kidled
    tree and two accelerators, advanced tick by tick. Written with plain
    file operations, so both packages read the very same files."""

    def __init__(self, root, v2):
        self.root, self.v2 = str(root), v2
        self.rng = np.random.default_rng(11 if v2 else 13)
        self.pods = [(f"pod{i}", ("besteffort" if i < 2 else "burstable"))
                     for i in range(6)]
        self.busy, self.ns = 10**6, {p: 10**9 for p, _ in self.pods}
        self.periods = {p: 1000 for p, _ in self.pods}
        self.throttled = {p: 0 for p, _ in self.pods}
        self.disk = [1000, 2000, 0]

    def path(self, *parts):
        p = os.path.join(self.root, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def write(self, text, *parts):
        with open(self.path(*parts), "w") as f:
            f.write(text)

    def cgroup(self, fs, cg, name):
        if self.v2:
            return ("cgroup", cg, name)
        return ("cgroup", fs, cg, name)

    def advance(self, k):
        rng = self.rng
        self.busy += int(rng.integers(100, 3000))
        self.write(f"cpu  {self.busy} 0 0 {10**7 + k} 0 0 0 0 0 0\n",
                   "proc", "stat")
        total = 64 * 2**20
        self.write(f"MemTotal: {total} kB\nMemAvailable: "
                   f"{total - int(rng.integers(2**20, 2**24))} kB\n"
                   f"Cached: {int(rng.integers(0, 2**22))} kB\n",
                   "proc", "meminfo")
        for res in ("cpu", "memory", "io"):
            text = f"some avg10={rng.uniform(0, 5):.2f} avg60=0 total=0\n"
            if res == "memory":
                text += f"full avg10={rng.uniform(0, 2):.2f} total=0\n"
            self.write(text, "proc", "pressure", res)
        self.disk = [d + int(rng.integers(0, 5000)) for d in self.disk[:2]] \
            + [self.disk[2] + int(rng.integers(0, 900))]
        self.write(f"   8 0 vda 1 0 {self.disk[0]} 1 1 0 {self.disk[1]} 1 0 "
                   f"{self.disk[2]} 1\n   8 1 vda1 1 0 8 1 1 0 8 1 0 1 1\n",
                   "proc", "diskstats")
        for name, tier in self.pods:
            cg = f"kubepods/{tier}/{name}"
            self.ns[name] += int(rng.integers(0, 4 * 10**10))
            self.periods[name] += 300
            self.throttled[name] += int(rng.integers(0, 300))
            mem = str(int(rng.integers(2**26, 2**31)))
            if self.v2:
                cpu = f"usage_usec {self.ns[name] // 1000}\n" \
                      f"nr_periods {self.periods[name]}\n" \
                      f"nr_throttled {self.throttled[name]}\n"
                self.write(cpu, *self.cgroup("cpu", cg, "cpu.stat"))
                self.write(mem, *self.cgroup("memory", cg, "memory.current"))
                self.write(f"usage_usec {self.ns[name] // 2000}\n",
                           *self.cgroup("cpu", cg + "/main", "cpu.stat"))
            else:
                self.write(str(self.ns[name]),
                           *self.cgroup("cpuacct", cg, "cpuacct.usage"))
                self.write(mem, *self.cgroup("memory", cg,
                                             "memory.usage_in_bytes"))
                self.write(f"nr_periods {self.periods[name]}\nnr_throttled "
                           f"{self.throttled[name]}\nthrottled_time 1\n",
                           *self.cgroup("cpu", cg, "cpu.stat"))
                self.write(str(self.ns[name] // 2),
                           *self.cgroup("cpuacct", cg + "/main",
                                        "cpuacct.usage"))
        for minor in (0, 1):
            d = ("sys", "class", "accel", f"accel{minor}")
            for key, value in (("device_type", "gpu"), ("healthy", 1),
                               ("mem_total_mib", 81920),
                               ("mem_used_mib", int(rng.integers(0, 81920))),
                               ("utilization", int(rng.integers(0, 101))),
                               ("numa_node", minor), ("pcie_id", minor)):
                self.write(str(value), *d, key)
        if k == 0:
            self.write("0\n", "sys", "kernel", "mm", "kidled",
                       "scan_period_in_seconds")
        self.write("# version: 1.0\n# buckets: 1,2,5,15\n" + "".join(
            f"{c} " + " ".join(str(int(rng.integers(0, 10**6)))
                               for _ in range(4)) + "\n"
            for c in ("cfei", "dfei", "cfui", "dfui", "csei")),
            *self.cgroup("memory", "", "memory.idle_page_stats"))


def metas(P, tree):
    QoS = P.X.QoSClass
    return [P.FW.PodMeta(name, f"kubepods/{tier}/{name}",
                         QoS.BE if tier == "besteffort" else QoS.LS,
                         containers={"main": f"kubepods/{tier}/{name}/main"})
            for name, tier in tree.pods]


@pytest.mark.parametrize("v2", [False, True], ids=["cgroup_v1", "cgroup_v2"])
def test_default_collectors_over_one_tree(v2, tmp_path):
    """``default_collectors()`` plus the cold-page, page-cache and
    host-application collectors, both packages over the same tree on the
    same fake-clock ticks (one tick skipped by the advisor's interval, one
    pod gone half way): identical caches and shared state."""
    tree = Tree(tmp_path / "node", v2)
    advisors = {}
    for P in (REF, PORT):
        cfg = P.CG.SystemConfig(
            cgroup_root=os.path.join(tree.root, "cgroup"),
            proc_root=os.path.join(tree.root, "proc"),
            sysfs_root=os.path.join(tree.root, "sys"), use_cgroup_v2=v2)
        pods = StaticPods(metas(P, tree))
        slo = P.S.NodeSLOSpec(host_applications=[P.S.HostApplicationSpec(
            name="pod5", cgroup_dir="kubepods/burstable/pod5")])
        ctx = P.FW.CollectorContext(metric_cache=P.MC.MetricCache(),
                                    system_config=cfg, pod_provider=pods)
        collectors = P.CO.default_collectors() + [
            P.CO.ColdMemoryCollector(), P.CO.PageCacheCollector(),
            P.CO.HostApplicationCollector(slo_provider=lambda s=slo: s)]
        advisors[P.root] = (P.FW.MetricsAdvisor(ctx, [], 30.0), collectors,
                            pods)
    for k in range(TICKS):
        tree.advance(k)
        for adv, collectors, pods in advisors.values():
            if k == 0:
                for c in collectors:
                    c.setup(adv.ctx)
                    adv.collectors.append(c)
            if k == TICKS // 2:
                pods.pods = pods.pods[1:]
            adv.tick(1000.0 + 30.0 * k + (10.0 if k == 3 else 0.0))
    (ref, _, _), (port, _, _) = (advisors["koordinator_tpu"],
                                 advisors["koordinator_tpu_torch"])
    kinds = {key[0] for key in port.ctx.metric_cache._series}
    assert {"node_cpu_usage", "pod_cpu_usage", "be_cpu_usage",
            "sys_cpu_usage", "psi_cpu_some_avg10", "device_util",
            "pod_cpu_throttled_ratio", "node_disk_read_bps",
            "container_cpu_usage", "node_cold_page_bytes",
            "node_page_cache_mib", "host_app_cpu_usage"} <= kinds, kinds
    assert dump(port.ctx.metric_cache) == dump(ref.ctx.metric_cache)
    assert plain(port.ctx.latest_pod_usage) == plain(ref.ctx.latest_pod_usage)
    assert port.ctx.latest_node_usage == ref.ctx.latest_node_usage
    assert port._last_run == ref._last_run
