"""The port's reconcile strategies and node primitives against the JAX
package's: ``system/resctrl`` (the CAT mask, the MBA value, the schemata,
the vendor) with ``qosmanager/resctrl.ResctrlReconcile``, memcg QoS
(``qosmanager/cgreconcile``), blkio throttles with PVC-backed pod volumes
(``qosmanager/blkio``), the /proc/sys knobs (``qosmanager/sysreconcile``),
core scheduling over the injectable prctl (``system/core_sched``) and the
PLEG's poll-diff over a kubepods tree mutated in seeded steps. The cases
are those of ``tests/test_qos_resctrl_blkio.py`` (not its native perf
module), ``tests/test_pvc_storage.py``'s blkio cases and
``tests/test_system_extras.py``'s sysreconcile and core scheduling cases.
Each runs through both packages on its own tree under ``tmp_path`` (v1
and v2 where the strategy writes cgroups), asserts the reference's
expectations where they were written (cgroup v1) and returns what it
observed: written files, audit events, prctl calls and PLEG events. The
two must be equal."""

import ctypes
import importlib
import os

import numpy as np
import pytest

from test_torch_koordlet_qos import StaticPods, plain, tree


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.X = mod("apis.extension")
        self.T = mod("apis.types")
        self.AUD = mod("koordlet.audit")
        self.MC = mod("koordlet.metriccache")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.Q = mod("koordlet.qosmanager")
        self.QR = mod("koordlet.qosmanager.resctrl")
        self.CGR = mod("koordlet.qosmanager.cgreconcile")
        self.BLK = mod("koordlet.qosmanager.blkio")
        self.SYSR = mod("koordlet.qosmanager.sysreconcile")
        self.RE = mod("koordlet.resourceexecutor")
        self.EX = mod("koordlet.resourceexecutor.executor")
        self.CG = mod("koordlet.system.cgroup")
        self.SYS = mod("koordlet.system")
        self.RC = mod("koordlet.system.resctrl")
        self.CS = mod("koordlet.system.core_sched")
        self.SI = mod("koordlet.statesinformer")
        self.PLEG = mod("koordlet.pleg")
        self.PL = mod("koordlet.pleg.pleg")
        self.SLO = mod("manager.sloconfig")


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")


def qos(P, name):
    return getattr(P.X.QoSClass, name)


class Node:
    """One package's node for the reconcile strategies: a fake cgroup tree
    with the two tier dirs, a fake procfs, an executor and the strategy
    context's audit log on a fake clock (``make_ctx`` of
    ``tests/test_qos_resctrl_blkio.py``)."""

    def __init__(self, P, root, pods, v2, slo=None, cap_mem=16384,
                 provider=None, **ctx_kw):
        self.P, self.root = P, str(root)
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.cfg = P.CG.SystemConfig(
            cgroup_root=os.path.join(self.root, "cg"),
            proc_root=os.path.join(self.root, "proc"),
            sysfs_root=os.path.join(self.root, "sys"), use_cgroup_v2=v2)
        for d in ("kubepods/besteffort", "kubepods/burstable"):
            P.EX.ensure_cgroup_dir(d, self.cfg)
        for p in pods:
            P.EX.ensure_cgroup_dir(p.cgroup_dir, self.cfg)
            for c in p.containers.values():
                P.EX.ensure_cgroup_dir(c, self.cfg)
        ex = P.RE.ResourceUpdateExecutor(self.cfg, clock=clock)
        ex.auditor = self.ex_auditor = P.AUD.Auditor(clock=clock)
        self.ctx = P.Q.QoSContext(
            metric_cache=P.MC.MetricCache(), executor=ex,
            pod_provider=provider or StaticPods(pods),
            system_config=self.cfg, node_slo=slo or P.SLO.NodeSLOSpec(),
            node_capacity_mem_mib=cap_mem, auditor=P.AUD.Auditor(clock=clock),
            **ctx_kw)

    def events(self):
        return [(e.timestamp, e.group, e.subject.replace(self.root, "<root>"),
                 e.operation, e.detail.replace(self.root, "<root>"))
                for a in (self.ex_auditor, self.ctx.auditor)
                for e in a.query()]

    def seen(self, **extra):
        return dict(files=tree(self.root), events=self.events(), **extra)

    def cg_file(self, sub, d, name):
        """A cgroup file's path: under the v1 subsystem, or the v2 dir."""
        if self.cfg.use_cgroup_v2:
            return os.path.join(self.cfg.cgroup_root, d, name)
        return os.path.join(self.cfg.cgroup_root, sub, d, name)


# -- system/resctrl: the pure functions ---------------------------------------


def mask_math(P):
    m = P.RC.calculate_cat_l3_mask
    assert m(0x3FF, 10, 80) == "fe" and m(0x7FF, 10, 50) == "3c"
    assert m(0x7FF, 0, 30) == "f" and m(0xFF, 0, 100) == "ff"
    out = [m(cbm, s, e) for cbm in (0xF, 0xFF, 0x3FF, 0x7FF, 0xFFFFF)
           for s in range(0, 100, 7) for e in range(s + 1, 101, 9)]
    errors = []
    for args in ((0x5, 0, 100), (0xFF, 50, 50), (0xFF, -1, 50),
                 (0xFF, 0, 101), (0x6, 0, 100)):
        with pytest.raises(ValueError) as e:
            m(*args)
        errors.append(str(e.value))
    return [out, errors]


def mba_values(P):
    f = P.RC.calculate_mba
    assert f(100) == "100" and f(85) == "90" and f(80) == "80"
    assert f(100, vendor="amd") == "2048000"
    assert f(50, vendor="amd") == str(25 * 1024 // 2)
    return [[f(p, v) for p in range(0, 101)] for v in ("intel", "amd", "x")]


def schemata_roundtrip(P):
    s = P.RC.ResctrlSchemata(l3={0: "ff", 1: "ff"}, mb={0: "100"})
    parsed = P.RC.ResctrlSchemata.parse(s.render())
    assert parsed.l3 == {0: "ff", 1: "ff"} and parsed.mb == {0: "100"}
    odd = P.RC.ResctrlSchemata.parse(
        "  L3:1=7f0;0=00f\nMB:0= 50;2=70\nXX:0=1\nbad line\n\nL3:3=1\n")
    return [s.render(), plain(parsed), plain(odd), odd.render(),
            P.RC.ResctrlSchemata().render()]


def vendor_detection(P, root):
    os.makedirs(root)
    got = []
    for text in ("vendor_id\t: AuthenticAMD\n", "vendor_id\t: GenuineIntel\n",
                 "processor\t: 0\nvendor_id\t: HygonGenuine\n", "nothing\n"):
        with open(os.path.join(root, "cpuinfo"), "w") as f:
            f.write(text)
        got.append(P.RC.detect_vendor(root))
    got.append(P.RC.detect_vendor(os.path.join(root, "missing")))
    assert got[:2] == ["amd", "intel"] and got[-1] == "intel"
    return got


def test_resctrl_functions_equal_reference(tmp_path):
    for case in (mask_math, mba_values, schemata_roundtrip):
        assert case(PORT) == case(REF), case.__name__
    assert (vendor_detection(PORT, str(tmp_path / "port"))
            == vendor_detection(REF, str(tmp_path / "ref")))


def test_group_mapping_equals_reference():
    for P in (REF, PORT):
        got = {q: P.QR.pod_resctrl_group(qos(P, q))
               for q in ("LSE", "LSR", "LS", "BE", "NONE")}
        assert got == {"LSE": "LSR", "LSR": "LSR", "LS": "LS", "BE": "BE",
                       "NONE": ""}


# -- resctrl reconcile ---------------------------------------------------------


def fake_resctrl(n, cbm="7ff", cache_ids=(0, 1), vendor=None):
    """The fake resctrl tree beside the fake cgroup root (where
    ``resctrl_root`` looks), and /proc/cpuinfo with ``vendor``."""
    root = n.P.RC.resctrl_root(n.cfg)
    assert root == os.path.join(n.root, "resctrl")
    os.makedirs(os.path.join(root, "info", "L3"))
    with open(os.path.join(root, "info", "L3", "cbm_mask"), "w") as f:
        f.write(cbm + "\n")
    l3 = ";".join(f"{i}={cbm}" for i in cache_ids)
    mb = ";".join(f"{i}=100" for i in cache_ids)
    with open(os.path.join(root, "schemata"), "w") as f:
        f.write(f"L3:{l3}\nMB:{mb}\n")
    if vendor is not None:
        os.makedirs(n.cfg.proc_root, exist_ok=True)
        with open(os.path.join(n.cfg.proc_root, "cpuinfo"), "w") as f:
            f.write(f"vendor_id\t: {vendor}\n")


def resctrl_pods(P):
    return [P.FW.PodMeta(uid="be1", cgroup_dir="kubepods/besteffort/podbe1",
                         qos=qos(P, "BE"),
                         containers={"c": "kubepods/besteffort/podbe1/c"}),
            P.FW.PodMeta(uid="ls1", cgroup_dir="kubepods/burstable/podls1",
                         qos=qos(P, "LS")),
            P.FW.PodMeta(uid="lsr1", cgroup_dir="kubepods/podlsr1",
                         qos=qos(P, "LSR")),
            P.FW.PodMeta(uid="none", cgroup_dir="kubepods/podnone",
                         qos=qos(P, "NONE"))]


def write_tasks(n, d, threads, procs):
    sub, names = (("", ("cgroup.threads", "cgroup.procs"))
                  if n.cfg.use_cgroup_v2 else ("cpu", ("tasks",
                                                       "cgroup.procs")))
    for name, ids in zip(names, (threads, procs)):
        if ids is None:
            continue
        path = os.path.join(n.cfg.cgroup_root, sub, d, name)
        with open(path, "w") as f:
            f.write("".join(f"{x}\n" for x in ids))


def resctrl_schemata_and_tasks(P, root, v2):
    n = Node(P, root, resctrl_pods(P), v2)
    fake_resctrl(n)
    write_tasks(n, "kubepods/besteffort/podbe1", None, [101, 102])
    write_tasks(n, "kubepods/besteffort/podbe1/c", [103, 101], [103])
    write_tasks(n, "kubepods/burstable/podls1", [201], [200])
    write_tasks(n, "kubepods/podlsr1", None, [301])
    write_tasks(n, "kubepods/podnone", None, [401])
    s = P.QR.ResctrlReconcile()
    assert s.enabled(n.ctx)
    s.execute(n.ctx, now=1.0)
    fs = s.fs
    assert fs.read_schemata("BE").l3 == {0: "f", 1: "f"}
    assert fs.read_schemata("BE").mb == {0: "100", 1: "100"}
    assert fs.read_schemata("LS").l3 == {0: "7ff", 1: "7ff"}
    assert fs.read_tasks("BE") == [101, 102, 103]
    assert fs.read_tasks("LSR") == [301]
    return n.seen(vendor=s.vendor, tasks={g: fs.read_tasks(g)
                                          for g in ("BE", "LS", "LSR")})


def resctrl_idempotent(P, root, v2):
    n = Node(P, root, [], v2)
    fake_resctrl(n, vendor="AuthenticAMD")
    s = P.QR.ResctrlReconcile()
    s.execute(n.ctx, now=1.0)
    first = s.fs.read_schemata("BE").render()
    assert not s.fs.write_schemata_line("BE", "L3:0=f;1=f")
    n.now[0] = 1.0
    s.execute(n.ctx, now=2.0)
    assert s.fs.read_schemata("BE").render() == first
    return n.seen(vendor=s.vendor)


def resctrl_strategy_ranges(P, root, v2):
    """Per-QoS ranges and MBA percents from the NodeSLO, on a 4-cache-id
    20-way host, with an invalid range left alone."""
    slo = P.SLO.NodeSLOSpec()
    st = slo.resource_qos_strategy
    st.be.resctrl.cat_range_start_percent = 10
    st.be.resctrl.cat_range_end_percent = 45
    st.be.resctrl.mba_percent = 35
    st.ls.resctrl.cat_range_end_percent = 90
    st.ls.resctrl.mba_percent = 70
    st.lsr.resctrl.cat_range_start_percent = 60
    st.lsr.resctrl.cat_range_end_percent = 60
    n = Node(P, root, [], v2, slo=slo)
    fake_resctrl(n, cbm="fffff", cache_ids=(0, 1, 2, 3),
                 vendor="GenuineIntel")
    s = P.QR.ResctrlReconcile()
    s.execute(n.ctx, now=1.0)
    return n.seen(vendor=s.vendor)


def resctrl_unsupported(P, root, v2):
    n = Node(P, root, [], v2)
    s = P.QR.ResctrlReconcile()
    assert not s.enabled(n.ctx)
    return n.seen()


# -- cgroup (memcg) reconcile -------------------------------------------------


def memory_slo(P):
    return P.SLO.NodeSLOSpec(resource_qos_strategy=P.SLO.ResourceQOSStrategy(
        be=P.SLO.QoSConfig(enable=True, memory=P.SLO.MemoryQOS(
            min_limit_percent=50, low_limit_percent=80,
            throttling_percent=90),
            resctrl=P.SLO.ResctrlQOS(cat_range_end_percent=30)),
        ls=P.SLO.QoSConfig(enable=True, memory=P.SLO.MemoryQOS(
            min_limit_percent=33, low_limit_percent=67, throttling_percent=0,
            priority_enable=True, priority=7, oom_kill_group=1)),
        lsr=P.SLO.QoSConfig(enable=True, memory=P.SLO.MemoryQOS(
            min_limit_percent=100, low_limit_percent=0,
            throttling_percent=75))))


def cgreconcile_memory_qos(P, root, v2):
    pods = [P.FW.PodMeta(uid="be1", cgroup_dir="kubepods/besteffort/podbe1",
                         qos=qos(P, "BE"), memory_request_mib=1024,
                         memory_limit_mib=2048,
                         containers={"c0": "kubepods/besteffort/podbe1/c0"}),
            P.FW.PodMeta(uid="be2", cgroup_dir="kubepods/besteffort/podbe2",
                         qos=qos(P, "BE"), memory_request_mib=333,
                         containers={"a": "kubepods/besteffort/podbe2/a",
                                     "b": "kubepods/besteffort/podbe2/b",
                                     "c": "kubepods/besteffort/podbe2/c"}),
            P.FW.PodMeta(uid="ls1", cgroup_dir="kubepods/burstable/podls1",
                         qos=qos(P, "LS"), memory_request_mib=777,
                         memory_limit_mib=999,
                         containers={"m": "kubepods/burstable/podls1/m"}),
            P.FW.PodMeta(uid="lsr1", cgroup_dir="kubepods/podlsr1",
                         qos=qos(P, "LSR"), memory_request_mib=4096,
                         memory_limit_mib=4096,
                         containers={"m": "kubepods/podlsr1/m"})]
    n = Node(P, root, pods, v2, slo=memory_slo(P))
    s = P.CGR.CgroupResourcesReconcile()
    assert s.enabled(n.ctx)
    s.execute(n.ctx, now=1.0)
    if not v2:
        mib = 1024 * 1024

        def read(d, f):
            with open(n.cg_file("memory", d, f)) as fh:
                return fh.read()

        d = "kubepods/besteffort/podbe1"
        assert read(d, "memory.min") == str(1024 * mib // 2)
        assert read(d, "memory.low") == str(1024 * mib * 80 // 100)
        assert read(d + "/c0", "memory.min") == str(1024 * mib // 2)
        assert read(d + "/c0", "memory.high") == str(2048 * mib * 90 // 100)
        assert read("kubepods/besteffort", "memory.min") == str(
            1024 * mib // 2 + 333 * mib // 2)
    return n.seen()


def cgreconcile_disabled(P, root, v2):
    n = Node(P, root, [], v2)
    assert not P.CGR.CgroupResourcesReconcile().enabled(n.ctx)
    return n.seen()


# -- blkio ---------------------------------------------------------------------


def blkio_throttles(P, root, v2):
    slo = P.SLO.NodeSLOSpec(resource_qos_strategy=P.SLO.ResourceQOSStrategy(
        be=P.SLO.QoSConfig(enable=True, blkio=[
            P.SLO.BlockCfg(device="253:0", read_bps=10485760, write_iops=200),
            P.SLO.BlockCfg(device="8:16", write_bps=1000, read_iops=50)]),
        ls=P.SLO.QoSConfig(enable=True, blkio=[
            P.SLO.BlockCfg(device="253:0", read_iops=999)])))
    pods = [P.FW.PodMeta(uid="be1", cgroup_dir="kubepods/besteffort/podbe1",
                         qos=qos(P, "BE")),
            P.FW.PodMeta(uid="ls1", cgroup_dir="kubepods/burstable/podls1",
                         qos=qos(P, "LS"))]
    n = Node(P, root, pods, v2, slo=slo)
    s = P.BLK.BlkIOReconcile()
    assert s.enabled(n.ctx)
    s.execute(n.ctx, now=1.0)
    if not v2:
        with open(n.cg_file("blkio", "kubepods/besteffort",
                            "blkio.throttle.read_bps_device")) as f:
            assert f.read() == "8:16 0"
        with open(n.cg_file("blkio", "kubepods/besteffort/podbe1",
                            "blkio.throttle.write_iops_device")) as f:
            assert f.read() == "8:16 0"
    # a device leaves the config: its throttle is cleared next pass
    n.ctx.node_slo.resource_qos_strategy.be.blkio = [
        P.SLO.BlockCfg(device="8:16", write_bps=1000, read_iops=50)]
    n.now[0] = 20.0
    s.execute(n.ctx, now=2.0)
    n.ctx.node_slo.resource_qos_strategy.be.blkio = []
    n.ctx.node_slo.resource_qos_strategy.ls.blkio = []
    assert s.enabled(n.ctx)
    n.now[0] = 40.0
    s.execute(n.ctx, now=3.0)
    return n.seen(applied={k: sorted(v) for k, v in s._applied.items()})


def test_io_max_packing_equals_reference():
    got = []
    for P in (REF, PORT):
        r = P.CG.BLKIO_READ_BPS
        packed = r.v2_encode("253:0 1000", "253:0 wbps=2000")
        assert packed == "253:0 rbps=1000 wbps=2000"
        assert r.v2_encode("253:0 0", packed) == "253:0 rbps=max wbps=2000"
        got.append([P.CG.get_resource(t).v2_encode(v, old)
                    for t in ("blkio.throttle.read_bps_device",
                              "blkio.throttle.write_bps_device",
                              "blkio.throttle.read_iops_device",
                              "blkio.throttle.write_iops_device")
                    for v in ("8:0 5", "8:0 0", "8:16 7")
                    for old in ("", "8:0 rbps=1 wiops=2", "8:16 riops=max")])
    assert got[0] == got[1]


def blkio_pod_volumes(P, root, v2):
    """A pod volume resolves volume -> PVC claim -> bound PV -> device
    through the informer; a missing claim or device skips the throttle."""
    informer = P.SI.StatesInformer()
    informer.upsert_pvc(P.T.PVCSpec(name="ns/data-claim", volume_name="pv-7"))
    informer.upsert_pvc(P.T.PVCSpec(name="ns/lost-claim", volume_name="pv-9"))
    pods = [P.FW.PodMeta("ls", "kubepods/burstable/podls", qos(P, "LS"),
                         volumes={"data": "ns/data-claim",
                                  "lost": "ns/lost-claim",
                                  "gone": "ns/missing"}),
            P.FW.PodMeta("be", "kubepods/besteffort/podbe", qos(P, "BE"),
                         volumes={"data": "ns/data-claim"})]
    informer.set_pods(pods)
    slo = P.SLO.NodeSLOSpec()
    slo.resource_qos_strategy.ls.blkio = [
        P.SLO.BlockCfg(block_type="pod_volume", name=v, read_bps=1000000)
        for v in ("data", "lost", "gone")]
    slo.resource_qos_strategy.be.blkio = [
        P.SLO.BlockCfg(block_type="pod_volume", name="data", write_iops=10),
        P.SLO.BlockCfg(device="253:0", read_bps=5)]
    n = Node(P, root, pods, v2, slo=slo, provider=informer,
             volume_name_fn=informer.get_volume_name,
             volume_devices={"pv-7": "253:16"})
    s = P.BLK.BlkIOReconcile()
    s.execute(n.ctx, now=0.0)
    if not v2:
        with open(n.cg_file("blkio", "kubepods/burstable/podls",
                            "blkio.throttle.read_bps_device")) as f:
            assert f.read() == "253:16 1000000"
    # the claim is deleted: the throttle on its device goes stale
    informer.remove_pvc("ns/data-claim")
    n.now[0] = 20.0
    s.execute(n.ctx, now=1.0)
    return n.seen(applied={k: sorted(v) for k, v in s._applied.items()})


def blkio_unresolvable_skipped(P, root, v2):
    informer = P.SI.StatesInformer()
    pods = [P.FW.PodMeta("ls", "kubepods/burstable/podls", qos(P, "LS"),
                         volumes={"data": "ns/missing-claim"})]
    informer.set_pods(pods)
    slo = P.SLO.NodeSLOSpec()
    slo.resource_qos_strategy.ls.blkio = [P.SLO.BlockCfg(
        block_type="pod_volume", name="data", read_bps=1000000)]
    n = Node(P, root, pods, v2, slo=slo, provider=informer,
             volume_name_fn=informer.get_volume_name, volume_devices={})
    P.BLK.BlkIOReconcile().execute(n.ctx, now=0.0)
    path = n.cg_file("blkio", "kubepods/burstable/podls",
                     "blkio.throttle.read_bps_device")
    assert not os.path.exists(path) or open(path).read() == ""
    return n.seen()


# -- /proc/sys reconcile ---------------------------------------------------------


def sysreconcile_writes(P, root, v2):
    n = Node(P, root, [], v2, slo=P.SLO.NodeSLOSpec(
        system_strategy=P.SLO.SystemStrategy(
            min_free_kbytes_factor=100, watermark_scale_factor=150,
            memcg_reap_background=1)))
    s = P.SYSR.SystemConfigReconcile()
    assert s.enabled(n.ctx)
    s.execute(n.ctx, now=1.0)
    vm = os.path.join(n.cfg.proc_root, "sys", "vm")
    with open(os.path.join(vm, "min_free_kbytes")) as f:
        assert f.read() == str(16384 * 1024 * 100 // 10000)
    with open(os.path.join(vm, "watermark_scale_factor")) as f:
        assert f.read() == "150"
    # steady state: nothing rewritten, nothing audited
    n.now[0] = 5.0
    s.execute(n.ctx, now=2.0)
    n.ctx.node_slo.system_strategy.watermark_scale_factor = 200
    n.now[0] = 9.0
    s.execute(n.ctx, now=3.0)
    return n.seen(written={os.path.relpath(k, n.root): v
                           for k, v in s._written.items()})


def sysreconcile_out_of_range(P, root, v2):
    n = Node(P, root, [], v2, cap_mem=64, slo=P.SLO.NodeSLOSpec(
        system_strategy=P.SLO.SystemStrategy(
            min_free_kbytes_factor=1, watermark_scale_factor=5000,
            memcg_reap_background=2)))
    P.SYSR.SystemConfigReconcile().execute(n.ctx, now=1.0)
    vm = os.path.join(n.cfg.proc_root, "sys", "vm")
    assert not os.path.exists(os.path.join(vm, "min_free_kbytes"))
    assert not os.path.exists(os.path.join(vm, "watermark_scale_factor"))
    return n.seen()


def sysreconcile_disabled(P, root, v2):
    n = Node(P, root, [], v2, slo=P.SLO.NodeSLOSpec(system_strategy=None))
    assert not P.SYSR.SystemConfigReconcile().enabled(n.ctx)
    return n.seen()


CASES = [resctrl_schemata_and_tasks, resctrl_idempotent,
         resctrl_strategy_ranges, resctrl_unsupported, cgreconcile_memory_qos,
         cgreconcile_disabled, blkio_throttles, blkio_pod_volumes,
         blkio_unresolvable_skipped, sysreconcile_writes,
         sysreconcile_out_of_range, sysreconcile_disabled]


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_reconcile_equals_reference(case, v2, tmp_path):
    ref = plain(case(REF, str(tmp_path / "ref"), v2))
    port = plain(case(PORT, str(tmp_path / "port"), v2))
    assert port == ref


# -- core scheduling ----------------------------------------------------------


class Recorder:
    """The FakeKernel's prctl, every call and its answer recorded (the
    cookie pointer as the value it read back)."""

    def __init__(self, P, supported=True):
        self.kernel = P.CS.FakeKernel(supported=supported)
        self.calls = []

    def prctl(self, option, arg2, pid, pid_type, arg5):
        rc = self.kernel.prctl(option, arg2, pid, pid_type, arg5)
        cookie = (ctypes.cast(arg5, ctypes.POINTER(ctypes.c_ulonglong))[0]
                  if arg5 and arg2 == 0 else arg5)
        self.calls.append((option, arg2, pid, pid_type, cookie, rc))
        return rc


def core_sched(P):
    rec = Recorder(P)
    cs = P.CS.CoreSched(prctl=rec.prctl)
    assert cs.supported() and cs.get(100) == 0
    assert cs.create(100, P.CS.PIDTYPE_PID)
    cookie = cs.get(100)
    assert cookie and cookie > 0
    assert cs.assign_group_cookie(100, [101, 102]) == 2
    assert rec.kernel.cookies[101] == rec.kernel.cookies[102] == cookie
    # a leader without a cookie gets one first; itself is skipped
    tagged = cs.assign_group_cookie(200, [200, 201, 202, 203])
    assert cs.share_to(300) and cs.share_from(201)
    unsupported = Recorder(P, supported=False)
    off = P.CS.CoreSched(prctl=unsupported.prctl)
    assert not off.supported() and off.get(1) is None
    assert off.assign_group_cookie(1, [2, 3]) == 0
    assert rec.kernel.prctl(99, 0, 0, 0, 0) == -22
    assert rec.kernel.prctl(P.CS.PR_SCHED_CORE, 9, 0, 0, 0) == -22
    return [rec.calls, dict(rec.kernel.cookies), tagged, unsupported.calls,
            [P.CS.PR_SCHED_CORE, P.CS.PR_SCHED_CORE_GET,
             P.CS.PR_SCHED_CORE_CREATE, P.CS.PR_SCHED_CORE_SHARE_TO,
             P.CS.PR_SCHED_CORE_SHARE_FROM, P.CS.PIDTYPE_PID,
             P.CS.PIDTYPE_TGID, P.CS.PIDTYPE_PGID]]


def test_core_sched_equals_reference():
    assert core_sched(PORT) == core_sched(REF)
    assert PORT.SYS.CoreSched is PORT.CS.CoreSched
    assert PORT.SYS.FakeKernel is PORT.CS.FakeKernel


def test_system_reexports_resctrl():
    for name in ("ResctrlFS", "ResctrlSchemata", "calculate_cat_l3_mask",
                 "calculate_mba", "detect_vendor", "resctrl_root"):
        assert getattr(PORT.SYS, name) is getattr(PORT.RC, name), name


# -- the PLEG -------------------------------------------------------------------


def pleg_steps(P, root, v2, seed=5, steps=8):
    """A PLEG over a kubepods tree mutated in seeded steps: pods appear
    under the three tiers and directly under kubepods, containers appear
    and vanish, pods are deleted, stray files are ignored. Returns every
    poll's events (and the handler's copy)."""
    cfg = P.CG.SystemConfig(cgroup_root=os.path.join(root, "cg"),
                            proc_root=os.path.join(root, "proc"),
                            sysfs_root=os.path.join(root, "sys"),
                            use_cgroup_v2=v2)
    pleg = P.PLEG.PLEG(cfg)
    handled = []
    pleg.register(lambda e: handled.append((e.event.name, e.cgroup_dir)))
    base = os.path.join(cfg.cgroup_root, "" if v2 else "cpu")
    rng = np.random.default_rng(seed)
    polls = [pleg.poll()]  # no tree yet: nothing, primed
    live = []
    tiers = ["kubepods/besteffort", "kubepods/burstable",
             "kubepods/guaranteed", "kubepods"]
    for step in range(steps):
        for _ in range(int(rng.integers(1, 5))):
            d = f"{tiers[int(rng.integers(0, 4))]}/pod{step}-{len(live)}"
            os.makedirs(os.path.join(base, d, "main"))
            if rng.random() < 0.5:
                os.makedirs(os.path.join(base, d, "sidecar"))
            live.append(d)
        with open(os.path.join(base, "kubepods", "cgroup.procs"), "w"):
            pass
        if live and rng.random() < 0.6:
            d = live.pop(int(rng.integers(0, len(live))))
            for dirpath, dirs, files in os.walk(os.path.join(base, d),
                                                topdown=False):
                os.rmdir(dirpath)
        if live and rng.random() < 0.5:
            d = live[int(rng.integers(0, len(live)))]
            c = os.path.join(base, d, "main")
            if os.path.isdir(c):
                os.rmdir(c)
        polls.append(pleg.poll())
    out = [[(e.event.name, e.cgroup_dir) for e in p] for p in polls]
    assert out[0] == [] and any(out[1:])
    assert [x for p in out for x in p] == handled
    second = P.PLEG.PLEG(cfg, kubepods_dir="kubepods/besteffort")
    return [out, handled, second.poll(), sorted(second._known_pods),
            [e.value for e in P.PL.EventType]]


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("seed", [5, 6])
def test_pleg_equals_reference(seed, v2, tmp_path):
    ref = pleg_steps(REF, str(tmp_path / "ref"), v2, seed)
    port = pleg_steps(PORT, str(tmp_path / "port"), v2, seed)
    assert port == ref
