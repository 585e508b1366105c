"""The port's koordlet binary (``cmd/koordlet.py`` with ``KOORDLET_GATES``),
its CPI collector (``koordlet/metricsadvisor/performance.py``) and the
perf-group reader (``native/``) against the JAX package's. The cases are
the koordlet ones of ``tests/test_features_cmd.py``: the gates' defaults,
the collectors and strategies each gate registers, ``main(["--once",
...])`` over copies of one tree, the checkpoint's round trip, the NRI
mode and the unknown hooks mode; plus the auditor split of the reference
(an empty ``Auditor`` is falsy, so the executor keeps its own), the CPI
collector over ``PerfGroup.fake`` sources and the ``g++`` build into
``koordinator_tpu_torch/_build/``. Every daemon ticks on a fake clock."""

import dataclasses
import enum
import importlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_000_000.0


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.X = mod("apis.extension")
        self.F = mod("features")
        self.K = mod("cmd.koordlet")
        self.EX = mod("koordlet.resourceexecutor.executor")
        self.RE = mod("koordlet.resourceexecutor")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.MC = mod("koordlet.metriccache")
        self.PERF = mod("koordlet.metricsadvisor.performance")
        self.N = mod("native")
        self.CG = mod("koordlet.system.cgroup")
        self.SLO = mod("manager.sloconfig")


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")

#: the gates build_koordlet reads: the port registers these and no other
READ_GATES = ("AuditEvents", "PSICollector", "CPICollector",
              "ColdPageCollector", "Accelerators", "BECPUSuppress",
              "BECPUEvict", "BEMemoryEvict", "CPUBurst", "RdtResctrl",
              "CgroupReconcile", "BlkIOReconcile", "SystemConfig")


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


def files(root):
    """Every file under ``root``: bytes, or an ``.npz`` checkpoint's arrays
    (its zip headers carry a write time)."""
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k].tolist() for k in sorted(z.files)}
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def seed_tree(root, v2=False):
    """A seeded node tree: the kube-QoS dirs and three pods' dirs (one
    pinned LSR, one LS, one BE), /proc/stat and /proc/meminfo."""
    from koordinator_tpu_torch.koordlet.resourceexecutor.executor import (
        ensure_cgroup_dir,
    )
    from koordinator_tpu_torch.koordlet.system.cgroup import SystemConfig

    cfg = SystemConfig(cgroup_root=os.path.join(root, "cg"),
                       proc_root=os.path.join(root, "proc"),
                       use_cgroup_v2=v2)
    for d in ("kubepods", "kubepods/burstable", "kubepods/besteffort",
              "kubepods/podlsr/main", "kubepods/burstable/podls/main",
              "kubepods/besteffort/podbe/main"):
        ensure_cgroup_dir(d, cfg)
    rng = np.random.default_rng(31)
    os.makedirs(cfg.proc_root, exist_ok=True)
    with open(os.path.join(cfg.proc_root, "stat"), "w") as f:
        f.write(f"cpu  {int(rng.integers(10**6, 10**7))} 0 0 "
                f"{int(rng.integers(10**8, 10**9))} 0 0 0 0 0 0\n")
    with open(os.path.join(cfg.proc_root, "meminfo"), "w") as f:
        f.write("MemTotal: 67108864 kB\nMemAvailable: "
                f"{int(rng.integers(2**24, 2**25))} kB\n")
    return cfg


def config(P, root, **kw):
    return P.K.KoordletConfig(cgroup_root=os.path.join(root, "cg"),
                              proc_root=os.path.join(root, "proc"), **kw)


def test_koordlet_gates_equal_the_reference_defaults():
    ref = REF.F.KOORDLET_GATES.as_dict()
    port = PORT.F.KOORDLET_GATES.as_dict()
    assert sorted(port) == sorted(READ_GATES)
    assert port == {g: ref[g] for g in READ_GATES}
    assert sorted(set(ref) - set(port)) == [
        "AuditEventsHTTPHandler", "BECPUManager", "HugePageReport",
        "Libpfm4", "NodeTopologyReport"]
    for spec in ("Libpfm4=true", "Bogus=false", "CPUBurst=true,Nope=true"):
        gates = PORT.F.KOORDLET_GATES.copy()
        with pytest.raises(KeyError):
            gates.set_from_spec(spec)
        assert gates.as_dict() == port
    with pytest.raises(KeyError):
        REF.F.KOORDLET_GATES.copy().set_from_spec("Bogus=false")


def assembly(P, root, spec):
    daemon = P.K.build_koordlet(config(P, root, feature_gates=spec))
    return ([c.name for c in daemon.metrics_advisor.collectors],
            [(s.name, getattr(s, "interval_seconds", None))
             for s in daemon.qos_manager.strategies],
            daemon.auditor is None, daemon.pleg is None)


@pytest.mark.parametrize("gate", READ_GATES)
def test_each_gate_registers_the_same_collectors_and_strategies(gate,
                                                                tmp_path):
    flipped = f"{gate}={'false' if REF.F.KOORDLET_GATES.enabled(gate) else 'true'}"
    for spec in ("", flipped):
        ref = assembly(REF, str(tmp_path / "ref"), spec)
        port = assembly(PORT, str(tmp_path / "port"), spec)
        assert port == ref, spec
    assert assembly(PORT, str(tmp_path / "port"), flipped) != assembly(
        PORT, str(tmp_path / "port"), "")


def daemon_run(P, root, mode, v2, spec="AuditEvents=true,CPICollector=true"):
    """``test_nri_mode_actuates_from_pleg`` and the reconciler's twin: a
    daemon over the seeded tree, the bvt rule on, pods handed to its
    informer, two ticks on the fake clock, a checkpoint; then the auditor
    split (``daemon.executor.auditor is not daemon.auditor``)."""
    seed_tree(root, v2)
    daemon = P.K.build_koordlet(config(
        P, root, runtime_hooks_mode=mode, use_cgroup_v2=v2,
        feature_gates=spec, checkpoint_dir=os.path.join(root, "ckpt")))
    slo = P.SLO.NodeSLOSpec()
    for tier in ("lsr", "ls", "be"):
        getattr(slo.resource_qos_strategy, tier).enable = True
    daemon.states_informer.set_node_slo(slo)
    Q = P.X.QoSClass
    pods = [
        P.FW.PodMeta("lsr", "kubepods/podlsr", Q.LSR,
                     containers={"main": "kubepods/podlsr/main"},
                     annotations={P.X.ANNOTATION_RESOURCE_STATUS: json.dumps(
                         {"cpuset": [2, 3]})}),
        P.FW.PodMeta("ls", "kubepods/burstable/podls", Q.LS,
                     containers={"main": "kubepods/burstable/podls/main"},
                     cpu_limit_mcpu=2000),
        P.FW.PodMeta("be", "kubepods/besteffort/podbe", Q.BE,
                     containers={"main": "kubepods/besteffort/podbe/main"}),
    ]
    daemon.states_informer.set_pods(pods)
    daemon.tick(now=T0)
    daemon.tick(now=T0 + 30.0)
    assert daemon.executor.auditor is not daemon.auditor
    assert len(daemon.executor.auditor) > 0
    if mode == "nri":
        assert daemon.nri_server.handled == {}  # dirs made before the build
    if not v2:
        assert P.CG.CPU_BVT_WARP_NS.read("kubepods/burstable/podls",
                                         daemon.executor.config) == "2"
    events = [(e.group, os.path.relpath(e.subject, root)
               if e.subject.startswith(root) else e.subject, e.operation,
               e.detail.replace(root, "<root>"))
              for e in reversed(daemon.executor.auditor.query())]
    own = [(e.group, e.subject, e.operation)
           for e in reversed(daemon.auditor.query())]
    return [files(root), events, own]


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("mode", ["reconciler", "nri"])
def test_daemon_ticks_equal_the_reference(mode, v2, tmp_path):
    ref = daemon_run(REF, str(tmp_path / "ref"), mode, v2)
    port = daemon_run(PORT, str(tmp_path / "port"), mode, v2)
    assert plain(port) == plain(ref)


def test_unknown_hooks_mode_raises(tmp_path):
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="sidecar"):
            P.K.build_koordlet(config(P, str(tmp_path),
                                      runtime_hooks_mode="sidecar"))


def test_main_once_equals_the_reference(tmp_path, monkeypatch, capsys):
    """``main(["--once", ...])`` of both packages on copies of one tree on
    a fixed clock: exit 0 and equal files, the checkpoint included."""
    seed_tree(str(tmp_path / "seed"))
    monkeypatch.setattr(time, "time", lambda: T0)
    out = {}
    for P in (REF, PORT):
        root = str(tmp_path / P.root)
        shutil.copytree(str(tmp_path / "seed"), root)
        argv = ["--once", "--runtime-hooks-mode", "nri",
                "--cgroup-root", os.path.join(root, "cg"),
                "--proc-root", os.path.join(root, "proc"),
                "--feature-gates", "CPICollector=true,AuditEvents=true",
                "--checkpoint-dir", os.path.join(root, "ckpt")]
        assert P.K.main(argv) == 0
        out[P.root] = files(root)
    assert "ckpt/metriccache.npz" in out[PORT.root]
    assert out[PORT.root] == out[REF.root]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("koordlet: built (nri mode) in ")
    assert lines[1].startswith("koordlet: tick returned after ")


def test_main_now_flag(tmp_path):
    """The port's ``--now`` ticks ``--once`` on the given clock: the same
    files as ``build_koordlet(...).tick(now)``; without ``--once`` it is
    refused."""
    for name in ("child", "in_process"):
        seed_tree(str(tmp_path / name))
    root = str(tmp_path / "child")
    assert PORT.K.main([
        "--once", "--now", str(T0), "--cgroup-root", os.path.join(root, "cg"),
        "--proc-root", os.path.join(root, "proc"),
        "--checkpoint-dir", os.path.join(root, "ckpt")]) == 0
    root2 = str(tmp_path / "in_process")
    PORT.K.build_koordlet(config(
        PORT, root2, checkpoint_dir=os.path.join(root2, "ckpt"))).tick(T0)
    assert files(root) == files(root2)
    with pytest.raises(SystemExit):
        PORT.K.main(["--now", "5"])


def checkpoint_round_trip(P, root):
    """A daemon's checkpoint (the metric TSDB and the prediction
    histograms) restored by the next build on the same dir."""
    seed_tree(root)
    ckpt = os.path.join(root, "ckpt")
    first = P.K.build_koordlet(config(P, root, checkpoint_dir=ckpt))
    rng = np.random.default_rng(3)
    K = P.MC.MetricKind
    for k in range(6):
        now = T0 + 60.0 * k
        first.metric_cache.append(K.NODE_CPU_USAGE, None, now,
                                  float(rng.uniform(100, 8000)))
        first.metric_cache.append(K.POD_CPU_USAGE, {"pod": "a"}, now,
                                  float(rng.uniform(10, 900)))
        first.predict_server.update("node", float(rng.uniform(1, 8)),
                                    float(rng.uniform(1, 64)), now)
    first.checkpoint()
    second = P.K.build_koordlet(config(P, root, checkpoint_dir=ckpt))
    return [second.metric_cache.query(K.NODE_CPU_USAGE),
            second.metric_cache.query(K.POD_CPU_USAGE, {"pod": "a"}),
            files(ckpt)]


def test_checkpoint_round_trip(tmp_path):
    ref = plain(checkpoint_round_trip(REF, str(tmp_path / "ref")))
    port = plain(checkpoint_round_trip(PORT, str(tmp_path / "port")))
    assert port == ref and len(port[0][0]) == 6


def cpi_run(P, root):
    """The CPI collector in a daemon's advisor over ``PerfGroup.fake``
    sources (seeded steps a container) for four ticks, one container
    going away after the second: every CONTAINER_CPI series."""
    seed_tree(root)
    daemon = P.K.build_koordlet(config(P, root,
                                       feature_gates="CPICollector=true"))
    rng = np.random.default_rng(12)
    steps = {}

    def fake(cdir):
        steps.setdefault(cdir, (int(rng.integers(1000, 9000)),
                                int(rng.integers(500, 4000))))
        return P.N.PerfGroup.fake(*steps[cdir])

    collector = P.PERF.PerformanceCollector(source_factory=fake)
    collector.setup(daemon.collector_ctx)
    Q = P.X.QoSClass
    pods = [P.FW.PodMeta(f"p{k}", f"kubepods/burstable/podp{k}", Q.LS,
                         containers={c: f"kubepods/burstable/podp{k}/{c}"
                                     for c in ("main", "side")[:k % 2 + 1]})
            for k in range(4)]
    daemon.states_informer.set_pods(pods)
    for t in range(4):
        if t == 2:
            daemon.states_informer.set_pods(pods[1:])
        collector.collect(T0 + 30.0 * t)
    series = {}
    for pod in pods:
        for c in pod.containers:
            series[f"{pod.uid}/{c}"] = daemon.metric_cache.query(
                P.MC.MetricKind.CONTAINER_CPI,
                {"pod": pod.uid, "container": c})
    assert series["p1/side"][1].size == 3
    return [series, sorted(collector._sources)]


def test_cpi_collector_over_fake_groups(tmp_path):
    ref = plain(cpi_run(REF, str(tmp_path / "ref")))
    port = plain(cpi_run(PORT, str(tmp_path / "port")))
    assert port == ref


def test_perf_library_builds_into_the_build_dir(tmp_path, monkeypatch):
    """``g++`` builds ``libkoordperf.so`` into ``koordinator_tpu_torch/
    _build/`` (git ignores it); two threads building a fresh path at once
    each get a whole library; a fake group counts its steps."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    from koordinator_tpu_torch.native import perf

    path = perf.ensure_built()
    assert path == os.path.join(ROOT, "koordinator_tpu_torch", "_build",
                                "libkoordperf.so")
    assert os.path.exists(path)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "koordinator_tpu_torch/_build/" in f.read().split()
    monkeypatch.setattr(perf, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(perf, "_LIB", str(tmp_path / "b" / "lib.so"))
    got = []
    threads = [threading.Thread(target=lambda: got.append(perf.ensure_built()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == [str(tmp_path / "b" / "lib.so")] * 2
    assert os.listdir(str(tmp_path / "b")) == ["lib.so"]
    code = "import ctypes, sys; ctypes.CDLL(sys.argv[1]).kp_open_fake"
    assert subprocess.run([sys.executable, "-c", code, got[0]],
                          capture_output=True).returncode == 0
    group = PORT.N.PerfGroup.fake(7, 3)
    assert [group.read() for _ in range(3)] == [(7, 3), (14, 6), (21, 9)]
    group.close()


def test_perf_group_on_this_process():
    """A real perf group on this process counts cycles and instructions;
    ``perf_event_open`` may be refused (a container's perf_event_paranoid),
    and then the test skips with the reason."""
    try:
        group = PORT.N.PerfGroup.open_self()
    except PORT.N.PerfUnavailable as e:
        pytest.skip(f"perf_event_open refused here: {e}")
    try:
        before = group.read()
        sum(i * i for i in range(200_000))
        after = group.read()
    finally:
        group.close()
    assert after[0] > before[0] and after[1] > before[1]
