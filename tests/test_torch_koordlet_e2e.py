"""The node agents feeding the colocation loop, end to end, in both
packages on the CPU: 16 nodes on a bus, 4 of them wired node agents
(``wire_koordlet``) whose ``MetricsAdvisor`` runs ``default_collectors()``
over a fake procfs and cgroupfs tree under ``tmp_path`` for 11 ticks of a
fake clock, the other 12 with the same kinds of samples appended to their
caches directly; every ``NodeMetricReporter``'s report goes onto the bus,
the manager (``wire_manager``) reconciles from them and PATCHes the batch
allocatable, and a wired ``build_scheduler`` in the aggregated LoadAware
mode (``host_fallback_cells=0``) places a pending wave, a seeded half BE
pods on batch resources. The reports, the batch allocatable, the
placements and what the agents see after the binds are equal between
the packages."""

import dataclasses
import enum
import importlib
import os

import numpy as np
import pytest

NODES, AGENTS, RUNNING, PENDING = 16, 4, 2, 32
TICKS, STEP, T0 = 11, 30.0, 1_000_000.0


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.port = root.endswith("_torch")
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.bus = mod("client.bus")
        self.client = mod("client")
        self.MC = mod("koordlet.metriccache")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.CO = mod("koordlet.metricsadvisor.collectors")
        self.SI = mod("koordlet.statesinformer")
        self.CG = mod("koordlet.system.cgroup")
        self.NM = mod("manager.nodemetric")
        self.cmd = mod("cmd.scheduler")

    def device(self):
        return {"device": "cpu"} if self.port else {}


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


def world(seed=21):
    """Seeded nodes, running pods and the counters a node exposes over
    the ticks (cumulative busy jiffies and pod cpu ns, memory in use)."""
    rng = np.random.default_rng(seed)
    cores = rng.integers(32, 65, NODES)
    mem = rng.integers(64, 257, NODES) * 1024
    req_cpu = rng.integers(500, 4000, (NODES, RUNNING))
    req_mem = rng.integers(512, 8192, (NODES, RUNNING))
    pod_cores = rng.uniform(0.2, 0.9, (NODES, RUNNING, TICKS)) * (
        req_cpu[..., None] / 1000.0)
    busy = pod_cores.sum(axis=1) + rng.uniform(0.05, 0.7, (NODES, 1)) * \
        cores[:, None] * rng.uniform(0.8, 1.2, (NODES, TICKS))
    jiffies = 10**6 + np.cumsum(np.rint(busy * 100 * STEP).astype(np.int64),
                                axis=1)
    pod_ns = 10**9 + np.cumsum(np.rint(pod_cores * STEP * 1e9).astype(
        np.int64), axis=2)
    pod_bytes = np.rint(rng.uniform(0.4, 0.9, (NODES, RUNNING, TICKS))
                        * req_mem[..., None] * 2**20).astype(np.int64)
    used_kb = pod_bytes.sum(axis=1) // 1024 + rng.integers(2**20, 2**22,
                                                          (NODES, 1))
    pending = [(int(rng.integers(100, 4000)), int(rng.integers(128, 8192)),
                bool(rng.random() < 0.5)) for _ in range(PENDING)]
    return dict(cores=cores, mem=mem, req_cpu=req_cpu, req_mem=req_mem,
                jiffies=jiffies, pod_ns=pod_ns, pod_bytes=pod_bytes,
                used_kb=used_kb, pending=pending)


def write_tree(P, cfg, w, i, metas, k):
    os.makedirs(cfg.proc_root, exist_ok=True)
    with open(os.path.join(cfg.proc_root, "stat"), "w") as f:
        f.write(f"cpu  {w['jiffies'][i, k]} 0 0 {10**9 + k} 0 0 0 0 0 0\n")
    total = int(w["mem"][i]) * 1024
    with open(os.path.join(cfg.proc_root, "meminfo"), "w") as f:
        f.write(f"MemTotal: {total} kB\nMemAvailable: "
                f"{total - w['used_kb'][i, k]} kB\n")
    for j, meta in enumerate(metas):
        for res, value in ((P.CG.CPU_ACCT_USAGE, w["pod_ns"][i, j, k]),
                           (P.CG.MEMORY_USAGE, w["pod_bytes"][i, j, k])):
            path = res.path(meta.cgroup_dir, cfg)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(str(value))


def direct_fill(P, cache, w, i, uids):
    """The samples the collectors would derive, appended directly."""
    K = P.MC.MetricKind
    jif = w["jiffies"][i].astype(np.float64)
    node_cpu = np.maximum(jif[1:] - jif[:-1], 0.0) / STEP / 100 * 1000.0
    node_mem = w["used_kb"][i] / 1024.0
    ns = w["pod_ns"][i].astype(np.float64)
    pod_cpu = np.maximum(ns[:, 1:] - ns[:, :-1], 0.0) / STEP / 1e9 * 1000.0
    pod_mem = w["pod_bytes"][i] / (1024.0 * 1024.0)
    for k in range(TICKS):
        now = T0 + STEP * k
        cache.append(K.NODE_MEMORY_USAGE, None, now, node_mem[k])
        cache.append(K.SYS_MEMORY_USAGE, None, now,
                     max(node_mem[k] - (0 + pod_mem[0, k] + pod_mem[1, k]),
                         0.0))
        for j, u in enumerate(uids):
            cache.append(K.POD_MEMORY_USAGE, {"pod": u}, now, pod_mem[j, k])
            if k:
                cache.append(K.POD_CPU_USAGE, {"pod": u}, now,
                             pod_cpu[j, k - 1])
        if k:
            cache.append(K.NODE_CPU_USAGE, None, now, node_cpu[k - 1])
            cache.append(K.SYS_CPU_USAGE, None, now, max(
                node_cpu[k - 1] - (0 + pod_cpu[0, k - 1] + pod_cpu[1, k - 1]),
                0.0))


def run(P, root, w):
    R, Kind = P.X.ResourceName, P.bus.Kind
    bus = P.client.APIServer()
    sched = P.cmd.build_scheduler(P.cmd.SchedulerConfig(
        feature_gates="ElasticQuotaPreemption=false",
        aggregated_usage_thresholds={R.CPU: 65, R.MEMORY: 95},
        aggregated_usage_pct=99, aggregated_score_pct=99,
        host_fallback_cells=0), **P.device())
    P.client.wire_scheduler(bus, sched)
    manager = P.client.wire_manager(bus, **P.device())
    names = [f"n{i}" for i in range(NODES)]
    for i, name in enumerate(names):
        bus.apply(Kind.NODE, name, P.T.NodeSpec(name, allocatable={
            R.CPU: int(w["cores"][i]) * 1000, R.MEMORY: int(w["mem"][i])}))
    uids = {}
    for i, name in enumerate(names):
        for j in range(RUNNING):
            pod = P.T.PodSpec(name=f"a{i}-{j}", node_name=name, requests={
                R.CPU: int(w["req_cpu"][i, j]),
                R.MEMORY: int(w["req_mem"][i, j])}, creation_time=T0)
            uids.setdefault(name, []).append(pod.uid)
            bus.apply(Kind.POD, pod.uid, pod)
    loops, advisors, reporters = {}, {}, {}
    for i, name in enumerate(names):
        informer = P.SI.StatesInformer()
        informer.set_collect_policy(P.NM.NodeMetricCollectPolicy(300, 60))
        reporters[name] = P.SI.NodeMetricReporter(P.MC.MetricCache(),
                                                  informer)
        if i < AGENTS:
            loops[name] = P.client.wire_koordlet(bus, informer, name,
                                                 reporter=reporters[name])
            cfg = P.CG.SystemConfig(
                cgroup_root=os.path.join(root, name, "cg"),
                proc_root=os.path.join(root, name, "proc"),
                sysfs_root=os.path.join(root, name, "sys"))
            advisors[name] = (cfg, P.FW.MetricsAdvisor(
                P.FW.CollectorContext(
                    metric_cache=reporters[name].metric_cache,
                    system_config=cfg, pod_provider=informer),
                P.CO.default_collectors(), interval_seconds=STEP))
        else:
            informer.set_node(bus.get(Kind.NODE, name))
            informer.set_pods([P.SI.pod_meta_from_spec(bus.get(Kind.POD, u))
                               for u in uids[name]])
            direct_fill(P, reporters[name].metric_cache, w, i, uids[name])
    for k in range(TICKS):
        for i, name in enumerate(names[:AGENTS]):
            cfg, adv = advisors[name]
            write_tree(P, cfg, w, i, adv.ctx.pod_provider.running_pods(), k)
            adv.tick(T0 + STEP * k)
    now = T0 + STEP * (TICKS - 1)
    reports = {}
    for name in names:
        if name in loops:
            reports[name] = loops[name].report(now)
        else:
            reports[name] = reporters[name].report(now)
            bus.apply(Kind.NODE_METRIC, name, reports[name])
    assert all(r.aggregated_usage and r.aggregated_windows
               for r in reports.values())
    synced = manager.reconcile(now=now)
    batch = {n: (x.allocatable.get(R.BATCH_CPU, 0),
                 x.allocatable.get(R.BATCH_MEMORY, 0))
             for n, x in bus.list(Kind.NODE).items()}
    for j, (cpu, mem, be) in enumerate(w["pending"]):
        pod = (P.T.PodSpec(name=f"p{j}", qos=P.X.QoSClass.BE, priority=5500,
                           requests={R.BATCH_CPU: cpu, R.BATCH_MEMORY: mem})
               if be else P.T.PodSpec(name=f"p{j}", requests={
                   R.CPU: cpu, R.MEMORY: mem}))
        bus.apply(Kind.POD, pod.uid, pod)
    result = sched.schedule_pending(now=now + 1.0)
    seen = {n: sorted(p.uid for p in loop.pods())
            for n, loop in loops.items()}
    return dict(reports=plain(reports), synced=synced, batch=batch,
                placed=dict(result), waiting=result.waiting, seen=seen)


def test_node_agents_feed_the_colocation_loop(tmp_path):
    w = world()
    ref = run(REF, str(tmp_path / "ref"), w)
    port = run(PORT, str(tmp_path / "port"), w)
    assert port["synced"] == ref["synced"] == NODES
    assert sum(b[0] > 0 for b in port["batch"].values()) > 0
    be = {f"default/p{j}" for j, (_, _, b) in enumerate(w["pending"]) if b}
    placed = {u for u, n in port["placed"].items() if n is not None}
    assert placed & be and placed - be, placed
    assert any(port["seen"].values())
    for key in ("reports", "batch", "placed", "waiting", "seen"):
        assert port[key] == ref[key], key
