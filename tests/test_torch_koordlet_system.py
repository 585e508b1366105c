"""The port's node-agent system layer against the JAX package's: the typed
cgroup registry (``koordlet/system/cgroup.py``), cpu topology discovery
(``system/cpuinfo.py``), kidled (``system/kidled.py``), the audit log
(``koordlet/audit``), the cgroup executor (``koordlet/resourceexecutor``)
and the koordlet's metric registries (``metrics/components.py``). The
cases are those of ``tests/test_koordlet_system.py``, the kidled cases of
``tests/test_system_extras.py`` and the cpuinfo cases of
``tests/test_statesinformer_reporting.py``: each runs through both
packages, each on its own fake tree under ``tmp_path`` with the same
fake clock, asserts the reference's expectations and returns what it
observed (the trees' files and the audit events included), and the two
must be equal."""

import dataclasses
import enum
import importlib
import os

import pytest


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.CG = mod("koordlet.system.cgroup")
        self.SYS = mod("koordlet.system")
        self.CPU = mod("koordlet.system.cpuinfo")
        self.KID = mod("koordlet.system.kidled")
        self.AUD = mod("koordlet.audit")
        self.EX = mod("koordlet.resourceexecutor.executor")
        self.RE = mod("koordlet.resourceexecutor")
        self.MC = mod("metrics.components")
        self.M = mod("metrics")


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
    return x


def tree(root):
    """Every file under ``root``: relative path -> content."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path) as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


class Env:
    """One package's fake cgroupfs (v1 or v2) under its own directory,
    with a fake clock driving both the executor's cache and its audit
    log."""

    def __init__(self, P, root, v2):
        self.P, self.root = P, str(root)
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.cfg = P.CG.SystemConfig(cgroup_root=self.root,
                                     proc_root=os.path.join(self.root, "p"),
                                     sysfs_root=os.path.join(self.root, "s"),
                                     use_cgroup_v2=v2)
        P.EX.ensure_cgroup_dir("kubepods/pod1", self.cfg)
        self.ex = P.RE.ResourceUpdateExecutor(self.cfg, cache_ttl=10.0,
                                              clock=clock)
        # set after construction: an empty Auditor is falsy (it has a
        # length), so ``auditor=`` would be replaced by one on the wall
        # clock (``auditor or Auditor()``, as the reference)
        self.ex.auditor = self.auditor = P.AUD.Auditor(clock=clock)

    def up(self, cacheable, rtype, parent, value, merge=None, **kw):
        return self.ex.update(cacheable, self.P.RE.CgroupUpdater(
            rtype, parent, value, merge, **kw))

    def res(self, rtype):
        return self.P.CG.get_resource(rtype)

    def events(self):
        return [(e.timestamp, e.group, e.subject.replace(self.root, "<root>"),
                 e.operation, e.detail.replace(self.root, "<root>"))
                for e in self.auditor.query()]

    def files(self):
        return tree(self.root)


# -- the registry ----------------------------------------------------------------


def registry(P, tmp):
    root = str(tmp)
    v1, v2 = (P.CG.SystemConfig(cgroup_root=root, proc_root=root,
                                sysfs_root=root, use_cgroup_v2=v)
              for v in (False, True))
    quota = P.SYS.get_resource("cpu.cfs_quota_us")
    assert quota.path("kubepods/pod1", v1).endswith(
        "/cpu/kubepods/pod1/cpu.cfs_quota_us")
    assert quota.path("kubepods/pod1", v2).endswith("/kubepods/pod1/cpu.max")
    conv = P.SYS.convert_cpu_shares_to_weight
    back = P.SYS.convert_cpu_weight_to_shares
    assert conv(2) == 1 and conv(262144) == 10000
    assert back(1) == 2 and back(10000) == 262144 and back(39) == 998
    bvt, cpuset = P.SYS.get_resource("cpu.bvt_warp_ns"), \
        P.SYS.get_resource("cpuset.cpus")
    assert bvt.validate("2") and bvt.validate("-1")
    assert not bvt.validate("3") and not bvt.validate("x")
    assert cpuset.validate("0-3,8,10-11") and cpuset.validate("")
    assert not cpuset.validate("3-1") and not cpuset.validate("a-b")
    with pytest.raises(KeyError):
        P.SYS.get_resource("cpu.nothing")
    rows = []
    for r in P.SYS.known_resources():
        row = [r.resource_type, r.v1_subfs, r.v1_file, r.v2_file,
               r.supported(P.CG.CgroupVersion.V1),
               r.supported(P.CG.CgroupVersion.V2),
               [os.path.relpath(x, root) for x in r.paths("kubepods/x", v1)]]
        for value in ("0", "1", "2", "-1", "100", "max", "262144", "0-3",
                      "8:0 100", "x"):
            row.append([r.validate(value, v1), r.validate(value, v2)])
        rows.append(row)
    shares = [(s, conv(s), back(conv(s))) for s in range(2, 262144, 977)]
    return [rows, shares, P.CG.CFS_PERIOD_US, list(P.CG.V1_SUBSYSTEMS)]


# -- the executor ----------------------------------------------------------------


def executor_v1(P, tmp):
    e = Env(P, tmp, v2=False)
    seen = []
    seen.append(e.up(True, "cpu.cfs_quota_us", "kubepods/pod1", "100000"))
    path = e.res("cpu.cfs_quota_us").path("kubepods/pod1", e.cfg)
    assert open(path).read() == "100000"
    seen.append(e.up(True, "cpu.cfs_quota_us", "kubepods/pod1", "100000"))
    seen.append(e.up(True, "cpu.cfs_quota_us", "kubepods/pod1", "50000"))
    assert seen == [True, False, True]
    # the cache expires: external drift is corrected
    e.now[0] = 5.0
    seen.append(e.up(True, "cpu.cfs_quota_us", "kubepods/pod1", "50000"))
    e.now[0] = 11.0
    seen.append(e.up(True, "cpu.cfs_quota_us", "kubepods/pod1", "50000"))
    assert seen[3:] == [False, True]
    # an invalid value is rejected and audited
    seen.append(e.up(False, "cpu.bvt_warp_ns", "kubepods/pod1", "7"))
    assert not seen[-1] and e.auditor.query(operation="reject")
    e.up(False, "cpu.shares", "kubepods/pod1", "1024")
    assert "1024" in e.auditor.query(operation="update")[0].detail
    # cgroup.procs reaches every v1 hierarchy
    e.up(False, "cgroup.procs", "kubepods/pod1", "42")
    for fs in ("cpu", "cpuset", "memory"):
        assert open(os.path.join(e.root, fs, "kubepods/pod1",
                                 "cgroup.procs")).read() == "42", fs
    # "max" is written as -1 on v1
    e.up(False, "cpu.cfs_quota_us", "kubepods/pod1", "max")
    assert e.res("cpu.cfs_quota_us").read("kubepods/pod1", e.cfg) == "-1"
    # a missing cgroup dir fails, audited, without raising
    seen.append(e.up(False, "cpu.shares", "kubepods/ghost", "1024"))
    assert not seen[-1] and e.auditor.query(operation="error")
    # a batch
    seen.append(e.ex.update_batch(True, [
        P.RE.CgroupUpdater("memory.limit_in_bytes", "kubepods/pod1", v)
        for v in ("1048576", "1048576", "-1", "2097152")]))
    return [seen, e.files(), e.events()]


def executor_v2(P, tmp):
    e = Env(P, tmp, v2=True)
    quota, period = e.res("cpu.cfs_quota_us"), e.res("cpu.cfs_period_us")
    quota.write("kubepods/pod1", "max 100000", e.cfg)
    e.up(False, "cpu.cfs_quota_us", "kubepods/pod1", "50000")
    assert quota.read("kubepods/pod1", e.cfg) == "50000 100000"
    e.up(False, "cpu.cfs_quota_us", "kubepods/pod1", "-1")
    assert quota.read("kubepods/pod1", e.cfg) == "max 100000"
    period.write("kubepods/pod1", "50000 100000", e.cfg)
    e.up(False, "cpu.cfs_period_us", "kubepods/pod1", "200000")
    assert period.read("kubepods/pod1", e.cfg) == "50000 200000"
    e.up(False, "cpu.shares", "kubepods/pod1", "2")
    assert e.res("cpu.shares").read("kubepods/pod1", e.cfg) == "1"
    e.up(False, "memory.limit_in_bytes", "kubepods/pod1", "-1")
    assert e.res("memory.limit_in_bytes").read(
        "kubepods/pod1", e.cfg) == "max"
    seen = [e.up(False, "cpu.cfs_quota_us", "kubepods/pod1", "max"),
            e.up(False, "memory.limit_in_bytes", "kubepods/pod1", "max"),
            e.up(False, "cpu.cfs_period_us", "kubepods/pod1", "max")]
    assert seen == [True, True, False]
    # quota and period share cpu.max: their cache keys must not collide
    # (a fresh executor: no cached value)
    auditor = e.ex.auditor
    e.ex = P.RE.ResourceUpdateExecutor(e.cfg, cache_ttl=10.0,
                                       clock=lambda: 0.0)
    e.ex.auditor = auditor
    quota.write("kubepods/pod1", "max 100000", e.cfg)
    seen += [e.up(True, "cpu.cfs_quota_us", "kubepods/pod1", "50000"),
             e.up(True, "cpu.cfs_period_us", "kubepods/pod1", "200000"),
             e.up(True, "cpu.cfs_quota_us", "kubepods/pod1", "200000")]
    assert quota.read("kubepods/pod1", e.cfg) == "200000 200000"
    # the v2 blkio throttles pack into io.max, one key per device
    for rtype, value in (("blkio.throttle.read_bps_device", "8:0 1048576"),
                         ("blkio.throttle.write_iops_device", "8:0 200"),
                         ("blkio.throttle.read_bps_device", "8:16 max")):
        seen.append(e.up(True, rtype, "kubepods/pod1", value,
                         key_extra=value.split()[0]))
    # an unsupported v2 file is skipped
    seen.append(e.up(False, "cpuacct.usage", "kubepods/pod1", "1"))
    return [seen, e.files(), e.events()]


def merge_conditions(P, tmp):
    RE = P.RE
    assert RE.merge_if_value_larger("100", "200") == ("200", True)
    assert RE.merge_if_value_larger("200", "100") == ("100", False)
    assert RE.merge_if_cfs_quota_larger("-1", "100000")[1] is False
    assert RE.merge_if_cfs_quota_larger("100000", "-1")[1] is True
    assert RE.merge_if_cfs_quota_larger("100000", "200000")[1] is True
    assert RE.merge_if_cfs_quota_larger("max 100000", "50000")[1] is False
    merged, need = RE.merge_if_cpuset_looser("0-3", "2-5")
    assert need and merged == "0,1,2,3,4,5"
    assert not RE.merge_if_cpuset_looser("0-5", "1-2")[1]
    pairs = [("1", "2"), ("2", "1"), ("x", "1"), ("-1", "-1"), ("max", "5"),
             ("0-3", "3-7"), ("", "1"), ("1,3", "2"), ("0-2", "a")]
    return [[f(a, b) for a, b in pairs] for f in (
        RE.merge_if_value_larger, RE.merge_if_cfs_quota_larger,
        RE.merge_if_cpuset_looser)] + [P.EX.parse_cfs_quota("max 100000"),
                                       P.EX.parse_cfs_quota("junk")]


def leveled_batch(P, tmp):
    e = Env(P, tmp, v2=False)
    P.EX.ensure_cgroup_dir("kubepods/pod1/c1", e.cfg)
    quota, cpuset = e.res("cpu.cfs_quota_us"), e.res("cpuset.cpus")
    quota.write("kubepods/pod1", "400000", e.cfg)
    quota.write("kubepods/pod1/c1", "400000", e.cfg)
    U = P.RE.CgroupUpdater
    shrink = e.ex.leveled_update_batch([
        [U("cpu.cfs_quota_us", "kubepods/pod1", "100000",
           P.RE.merge_if_cfs_quota_larger)],
        [U("cpu.cfs_quota_us", "kubepods/pod1/c1", "100000",
           P.RE.merge_if_cfs_quota_larger)]])
    assert quota.read("kubepods/pod1", e.cfg) == "100000"
    assert quota.read("kubepods/pod1/c1", e.cfg) == "100000"
    cpuset.write("kubepods/pod1", "0-1", e.cfg)
    cpuset.write("kubepods/pod1/c1", "0-1", e.cfg)
    grow = e.ex.leveled_update_batch([
        [U("cpuset.cpus", "kubepods/pod1", "0-3", P.RE.merge_if_cpuset_looser)],
        [U("cpuset.cpus", "kubepods/pod1/c1", "2-3",
           P.RE.merge_if_cpuset_looser)]])
    assert cpuset.read("kubepods/pod1", e.cfg) == "0-3"
    assert cpuset.read("kubepods/pod1/c1", e.cfg) == "2-3"
    return [shrink, grow, e.files(), e.events()]


def auditor(P, tmp):
    a = P.AUD.Auditor(capacity=3, clock=lambda: 1.0)
    for i in range(5):
        a.log("g", f"s{i}", "op")
    assert len(a) == 3
    assert [e.subject for e in a.query()] == ["s4", "s3", "s2"]
    assert a.query(subject="s3", limit=1)[0].subject == "s3"
    assert a.query(group="other") == []
    t = [0.0]
    b = P.AUD.Auditor(capacity=8, clock=lambda: t[0])
    for i in range(12):
        t[0] = float(i)
        b.log("qos" if i % 3 else "exec", f"pod{i % 4}", "update" if i % 2
              else "evict", f"d{i}")
    return [plain(a.query()), plain(b.query(since=6.0)),
            plain(b.query(group="qos", operation="update", limit=2)),
            plain(b.query(subject="pod1"))]


# -- cpuinfo, kidled ---------------------------------------------------------------


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


def cpuinfo(P, tmp):
    assert P.CPU.parse_cpulist("0-3,8,10-11") == [0, 1, 2, 3, 8, 10, 11]
    assert P.CPU.parse_cpulist("") == []
    out = []
    for i, shape in enumerate(((1, 4, 2, 2), (2, 8, 2, 2), (2, 6, 1, 1))):
        root = os.path.join(str(tmp), f"t{i}")
        fake_proc_sys(root, *shape)
        cfg = P.CG.SystemConfig(proc_root=os.path.join(root, "proc"),
                                sysfs_root=os.path.join(root, "sys"),
                                cgroup_root=os.path.join(root, "cg"))
        infos = P.CPU.read_cpu_infos(cfg)
        out.append(plain(infos))
    first = out[0]
    assert len(first) == 8
    assert first[0]["node_id"] == 0 and first[7]["node_id"] == 1
    assert first[0]["core_id"] == first[1]["core_id"]
    empty = P.CG.SystemConfig(proc_root=os.path.join(str(tmp), "none"),
                              sysfs_root=os.path.join(str(tmp), "none"),
                              cgroup_root=os.path.join(str(tmp), "none"))
    assert P.CPU.read_cpu_infos(empty) == []
    return out


IDLE_STATS = """\
# version: 1.0
# scan_period_in_seconds: 120
# use_hierarchy: 1
# buckets: 1,2,5,15,30,60,120,240
cfei 0 0 100 200 300 0 0 0
dfei 0 0 0 50 0 0 0 0
cfui 0 0 0 0 25 0 0 0
dfui 0 0 0 0 0 0 0 0
csei 999 0 0 0 0 0 0 0
"""


def kidled(P, tmp):
    stats = P.KID.parse_idle_page_stats(IDLE_STATS)
    assert stats.scan_period_seconds == 120 and stats.use_hierarchy == 1
    assert stats.buckets == [1, 2, 5, 15, 30, 60, 120, 240]
    assert stats.cold_page_bytes(boundary=3) == 575
    assert stats.cold_page_bytes(boundary=0) == 675
    root = str(tmp)
    cfg = P.CG.SystemConfig(cgroup_root=os.path.join(root, "cg"),
                            proc_root=os.path.join(root, "proc"),
                            sysfs_root=os.path.join(root, "sys"))
    k = P.KID.Kidled(cfg)
    before = k.supported()
    kid = os.path.join(root, "sys", "kernel", "mm", "kidled")
    os.makedirs(kid)
    with open(os.path.join(kid, "scan_period_in_seconds"), "w") as f:
        f.write("120\n")
    mem = os.path.join(root, "cg", "memory", "pod1")
    os.makedirs(mem)
    with open(os.path.join(mem, "memory.idle_page_stats"), "w") as f:
        f.write(IDLE_STATS)
    k.set_scan_period(60)
    k.set_use_hierarchy(True)
    return [plain(stats), before, k.supported(), plain(k.read_stats("pod1")),
            k.read_stats("ghost"), [stats.cold_page_bytes(b)
                                    for b in range(9)], tree(root)]


def metric_registries(P, tmp):
    """The koordlet's two registries: names, every series' metadata, and
    what a few updates add (the registries are process-wide, so deltas)."""
    m = P.MC
    pod = {"pod": "p", "container": "c"}
    before = [m.CGROUP_WRITES.value({"resource": "cpu.shares"}),
              m.POD_EVICTIONS.value({"reason": "memory"}),
              m.COLLECT_DURATION.count({"collector": "noderesource"}),
              m.COLLECT_DURATION.sum({"collector": "noderesource"}),
              m.PREDICT_DURATION.count()]
    m.CGROUP_WRITES.inc({"resource": "cpu.shares"})
    m.CGROUP_WRITES.inc({"resource": "cpu.shares"})
    m.POD_EVICTIONS.inc({"reason": "memory"})
    m.BE_SUPPRESS_CPU_CORES.set(3.5)
    m.NODE_RESOURCE_ALLOCATABLE.set(8000, {"resource": "cpu"})
    m.CONTAINER_CPI_METRIC.set(1.25, pod)
    m.COLLECT_DURATION.observe(0.02, {"collector": "noderesource"})
    m.PREDICT_DURATION.observe(0.5)
    after = [m.CGROUP_WRITES.value({"resource": "cpu.shares"}),
             m.POD_EVICTIONS.value({"reason": "memory"}),
             m.COLLECT_DURATION.count({"collector": "noderesource"}),
             m.COLLECT_DURATION.sum({"collector": "noderesource"}),
             m.PREDICT_DURATION.count()]
    assert P.M.KOORDLET_INTERNAL_METRICS is m.KOORDLET_INTERNAL_METRICS
    assert P.M.KOORDLET_EXTERNAL_METRICS is m.KOORDLET_EXTERNAL_METRICS
    meta = [line for reg in (m.KOORDLET_INTERNAL_METRICS,
                             m.KOORDLET_EXTERNAL_METRICS)
            for line in reg.gather().splitlines() if line.startswith("#")]
    return [m.KOORDLET_INTERNAL_METRICS.name,
            m.KOORDLET_EXTERNAL_METRICS.name, meta,
            [a - b for a, b in zip(after, before)],
            m.BE_SUPPRESS_CPU_CORES.value(),
            m.NODE_RESOURCE_ALLOCATABLE.value({"resource": "cpu"}),
            m.CONTAINER_CPI_METRIC.value(pod)]


CASES = {f.__name__: f for f in (
    registry, executor_v1, executor_v2, merge_conditions, leveled_batch,
    auditor, cpuinfo, kidled, metric_registries)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case, tmp_path):
    ref = CASES[case](REF, tmp_path / "ref")
    port = CASES[case](PORT, tmp_path / "port")
    assert plain(port) == plain(ref)


def test_executor_counts_its_writes(tmp_path):
    """Every write the executor makes counts in ``CGROUP_WRITES`` by
    resource, in both packages alike; a cache hit or a rejection does
    not."""
    out = []
    for P in (REF, PORT):
        e = Env(P, tmp_path / P.root, v2=False)
        keys = [{"resource": r} for r in ("cpu.shares",
                                          "memory.limit_in_bytes")]
        before = [P.MC.CGROUP_WRITES.value(k) for k in keys]
        for value in ("1024", "1024", "2048", "1"):
            e.up(True, "cpu.shares", "kubepods/pod1", value)
        e.up(True, "memory.limit_in_bytes", "kubepods/pod1", "-1")
        out.append([P.MC.CGROUP_WRITES.value(k) - b
                    for k, b in zip(keys, before)])
    assert out[0] == out[1] == [2, 1]
