"""The node agents feeding the colocation loop on the card (``cuda``:
skipped without an NVIDIA GPU), each against the same run on the CPU, at
a small size (phase 21 of ``chip_smoke.py`` runs it at the main path's
width).

- 24 nodes, 4 of them wired agents (``wire_koordlet``) running
  ``default_collectors()`` over a fake procfs and cgroupfs tree, the rest
  fed the same kinds of samples directly; every report on the bus; the
  manager (``wire_manager``) on the card and a wired ``build_scheduler``
  in the aggregated LoadAware mode on the card: the reports, the PATCHed
  batch allocatable and the round's placements equal the CPU run's, and
  the round launched the placement kernel.
- 8 nodes whose agents also report their NRT (``NodeTopologyReporter``
  over ``read_cpu_infos`` of a fake sysfs) and Devices (``DeviceReporter``)
  through ``koordlet_report_sinks``; a round of cpuset and GPU pods on the
  one-block kernel with extras rows equals the CPU round.

Every tree lives under ``tmp_path``. This file imports no JAX, so it runs
on a machine with a GPU and no JAX: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_koordlet_cuda.py``."""

import os

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import QoSClass, ResourceName
from koordinator_tpu_torch.client import (
    APIServer,
    Kind,
    wire_koordlet,
    wire_manager,
    wire_scheduler,
)
from koordinator_tpu_torch.client.wiring import koordlet_report_sinks
from koordinator_tpu_torch.cmd.scheduler import (
    SchedulerConfig,
    build_scheduler,
)
from koordinator_tpu_torch.device.cache import (
    DeviceEntry,
    DeviceResourceName,
    DeviceType,
)
from koordinator_tpu_torch.koordlet.metriccache import MetricCache, MetricKind
from koordinator_tpu_torch.koordlet.metricsadvisor import (
    CollectorContext,
    MetricsAdvisor,
)
from koordinator_tpu_torch.koordlet.metricsadvisor.collectors import (
    default_collectors,
)
from koordinator_tpu_torch.koordlet.statesinformer import (
    DeviceReporter,
    NodeMetricReporter,
    NodeTopologyReporter,
    StatesInformer,
    pod_meta_from_spec,
)
from koordinator_tpu_torch.koordlet.system.cgroup import (
    CPU_ACCT_USAGE,
    MEMORY_USAGE,
    SystemConfig,
)
from koordinator_tpu_torch.manager.nodemetric import NodeMetricCollectPolicy
from koordinator_tpu_torch.ops import binpack_kernel as bk

pytestmark = pytest.mark.cuda

# the warm pool stays inert unless a test configures its store, as
# tests/conftest.py keeps it for the CPU suite (these files also run
# under --noconftest, where a default store in the home directory
# would restore earlier runs' entries and count their launches)
os.environ.setdefault("KTPU_COMPILATION_CACHE_DIR", "")

CPU, MEM = ResourceName.CPU, ResourceName.MEMORY
NODES, AGENTS, PENDING, TICKS, STEP, T0 = 24, 4, 64, 11, 30.0, 1_000_000.0


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def cfg_at(root):
    return SystemConfig(cgroup_root=os.path.join(root, "cg"),
                        proc_root=os.path.join(root, "proc"),
                        sysfs_root=os.path.join(root, "sys"))


def seeded(seed=5):
    rng = np.random.default_rng(seed)
    cores = rng.integers(32, 65, NODES)
    mem = rng.integers(64, 257, NODES) * 1024
    req = rng.integers(500, 4000, (NODES, 2))
    busy = rng.uniform(0.1, 0.8, (NODES, TICKS)) * cores[:, None]
    jiffies = 10**6 + np.cumsum(np.rint(busy * 100 * STEP).astype(np.int64),
                                axis=1)
    pod_ns = 10**9 + np.cumsum(np.rint(rng.uniform(
        0.1, 0.9, (NODES, 2, TICKS)) * req[..., None] / 1000 * STEP * 1e9)
        .astype(np.int64), axis=2)
    pod_bytes = rng.integers(2**27, 2**31, (NODES, 2, TICKS))
    used_kb = pod_bytes.sum(axis=1) // 1024 + 2**21
    pending = [(int(rng.integers(100, 4000)), int(rng.integers(128, 8192)),
                bool(rng.random() < 0.5)) for _ in range(PENDING)]
    return dict(cores=cores, mem=mem, req=req, jiffies=jiffies,
                pod_ns=pod_ns, pod_bytes=pod_bytes, used_kb=used_kb,
                pending=pending)


def colocation(device, root, w):
    bus = APIServer()
    sched = build_scheduler(SchedulerConfig(
        feature_gates="ElasticQuotaPreemption=false",
        aggregated_usage_thresholds={CPU: 65, MEM: 95},
        aggregated_usage_pct=99, aggregated_score_pct=99,
        host_fallback_cells=0), device=device)
    wire_scheduler(bus, sched)
    manager = wire_manager(bus, device=device)
    for i in range(NODES):
        bus.apply(Kind.NODE, f"n{i}", ttypes.NodeSpec(f"n{i}", allocatable={
            CPU: int(w["cores"][i]) * 1000, MEM: int(w["mem"][i])}))
    for i in range(NODES):
        for j in range(2):
            pod = ttypes.PodSpec(name=f"a{i}-{j}", node_name=f"n{i}",
                                 requests={CPU: int(w["req"][i, j]),
                                           MEM: 1024})
            bus.apply(Kind.POD, pod.uid, pod)
    loops, reports = {}, {}
    for i in range(NODES):
        name = f"n{i}"
        informer = StatesInformer()
        informer.set_collect_policy(NodeMetricCollectPolicy(300, 60))
        reporter = NodeMetricReporter(MetricCache(), informer)
        if i < AGENTS:
            loop = wire_koordlet(bus, informer, name, reporter=reporter)
            cfg = cfg_at(os.path.join(root, name))
            adv = MetricsAdvisor(CollectorContext(
                metric_cache=reporter.metric_cache, system_config=cfg,
                pod_provider=informer), default_collectors(),
                interval_seconds=STEP)
            for k in range(TICKS):
                os.makedirs(cfg.proc_root, exist_ok=True)
                with open(os.path.join(cfg.proc_root, "stat"), "w") as f:
                    f.write(f"cpu  {w['jiffies'][i, k]} 0 0 1 0 0 0 0 0 0\n")
                total = int(w["mem"][i]) * 1024
                with open(os.path.join(cfg.proc_root, "meminfo"), "w") as f:
                    f.write(f"MemTotal: {total} kB\nMemAvailable: "
                            f"{total - w['used_kb'][i, k]} kB\n")
                for j, meta in enumerate(informer.running_pods()):
                    for res, v in ((CPU_ACCT_USAGE, w["pod_ns"][i, j, k]),
                                   (MEMORY_USAGE, w["pod_bytes"][i, j, k])):
                        path = res.path(meta.cgroup_dir, cfg)
                        os.makedirs(os.path.dirname(path), exist_ok=True)
                        with open(path, "w") as f:
                            f.write(str(v))
                adv.tick(T0 + STEP * k)
            loops[name] = loop
        else:
            informer.set_node(bus.get(Kind.NODE, name))
            informer.set_pods([pod_meta_from_spec(bus.get(
                Kind.POD, f"default/a{i}-{j}")) for j in range(2)])
            for k in range(TICKS):
                now = T0 + STEP * k
                reporter.metric_cache.append(
                    MetricKind.NODE_MEMORY_USAGE, None, now,
                    w["used_kb"][i, k] / 1024.0)
                if k:
                    reporter.metric_cache.append(
                        MetricKind.NODE_CPU_USAGE, None, now,
                        float(w["jiffies"][i, k] - w["jiffies"][i, k - 1])
                        / STEP / 100 * 1000.0)
        now = T0 + STEP * (TICKS - 1)
        if name in loops:
            reports[name] = loops[name].report(now)
        else:
            reports[name] = reporter.report(now)
            bus.apply(Kind.NODE_METRIC, name, reports[name])
    synced = manager.reconcile(now=T0 + STEP * (TICKS - 1))
    batch = {n: dict(x.allocatable) for n, x in bus.list(Kind.NODE).items()}
    for j, (cpu, mem, be) in enumerate(w["pending"]):
        pod = (ttypes.PodSpec(name=f"p{j}", qos=QoSClass.BE, priority=5500,
                              requests={ResourceName.BATCH_CPU: cpu,
                                        ResourceName.BATCH_MEMORY: mem})
               if be else ttypes.PodSpec(name=f"p{j}",
                                         requests={CPU: cpu, MEM: mem}))
        bus.apply(Kind.POD, pod.uid, pod)
    for kind in bk.LAUNCHES:
        bk.LAUNCHES[kind] = 0
    result = sched.schedule_pending(now=T0 + STEP * TICKS)
    launches = sum(bk.LAUNCHES.values())
    return (reports, synced, batch, dict(result), result.waiting,
            {n: sorted(p.uid for p in loop.pods())
             for n, loop in loops.items()}), launches


def test_node_agents_feed_the_loop_on_the_card(tmp_path):
    _needs_gpu()
    w = seeded()
    got, launches = colocation(None, str(tmp_path / "cuda"), w)
    want, _ = colocation("cpu", str(tmp_path / "cpu"), w)
    assert launches >= 1
    assert all(r.aggregated_usage and r.aggregated_windows
               for r in got[0].values())
    assert any(v for n, v in got[2].items()
               if v.get(ResourceName.BATCH_CPU, 0) > 0)
    for a, b, what in zip(got, want, ("reports", "synced", "allocatable",
                                      "placements", "waiting", "agents")):
        assert a == b, what


def seeded_gpus(rng):
    return [DeviceEntry(
        minor=k, device_type=DeviceType.GPU, resources={
            DeviceResourceName.GPU_CORE: 100,
            DeviceResourceName.GPU_MEMORY: int(rng.choice((16384, 81920))),
            DeviceResourceName.GPU_MEMORY_RATIO: 100},
        numa_node=k // 4, pcie_id=str(k // 2)) for k in range(8)]


def numa_devices(device, root):
    rng = np.random.default_rng(9)
    bus = APIServer()
    sched = build_scheduler(SchedulerConfig(
        feature_gates="ElasticQuotaPreemption=false",
        host_fallback_cells=0), device=device)
    wire_scheduler(bus, sched)
    topo_sink, dev_sink = koordlet_report_sinks(bus)
    for i in range(8):
        name = f"n{i}"
        bus.apply(Kind.NODE, name, ttypes.NodeSpec(name, allocatable={
            CPU: 32000, MEM: 131072}))
        cfg = cfg_at(os.path.join(root, name))
        os.makedirs(cfg.proc_root, exist_ok=True)
        with open(os.path.join(cfg.proc_root, "cpuinfo"), "w") as f:
            f.write("\n".join(f"processor\t: {c}\nphysical id\t: {c // 16}\n"
                              f"core id\t: {c // 2}\n" for c in range(32)))
        for node in (0, 1):
            d = os.path.join(cfg.sysfs_root, "devices", "system", "node",
                             f"node{node}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "cpulist"), "w") as f:
                f.write(f"{16 * node}-{16 * node + 15}\n")
        informer = StatesInformer()
        informer.set_collect_policy(NodeMetricCollectPolicy(300, 60))
        mc = MetricCache()
        mc.append(MetricKind.NODE_CPU_USAGE, None, T0, 4000.0 + 1000 * i)
        gpus = seeded_gpus(rng)

        class Source:
            def list_devices(self, gpus=gpus):
                return gpus

        wire_koordlet(
            bus, informer, name, reporter=NodeMetricReporter(mc, informer),
            topology_reporter=NodeTopologyReporter(
                name, cfg, topo_sink, numa_memory_mib={0: 65536, 1: 65536}),
            device_reporter=DeviceReporter(name, Source(), dev_sink)
        ).report(T0)
        assert sched.numa_manager.get_topology(name) is bus.get(
            Kind.NODE_RESOURCE_TOPOLOGY, name)
    for j in range(24):
        pod = (ttypes.PodSpec(name=f"c{j}", qos=QoSClass.LSR,
                              requests={CPU: 1000 * (2 + j % 4), MEM: 2048})
               if j % 2 == 0 else
               ttypes.PodSpec(name=f"g{j}", requests={CPU: 1000, MEM: 2048},
                              device_requests={"nvidia.com/gpu": 1 + j % 2}))
        bus.apply(Kind.POD, pod.uid, pod)
    for kind in bk.LAUNCHES:
        bk.LAUNCHES[kind] = 0
    result = sched.schedule_pending(now=T0 + 1.0)
    launches = dict(bk.LAUNCHES)
    pods = {u: (p.node_name, dict(p.annotations))
            for u, p in {**sched.cache.pending, **sched.cache.pods}.items()}
    devices = {n: sorted(nd.allocations) for n, nd in
               sched.device_cache.nodes.items()}
    return (dict(result), result.waiting, pods, devices), launches


def test_reported_numa_and_devices_round_on_the_card(tmp_path):
    _needs_gpu()
    got, launches = numa_devices(None, str(tmp_path / "cuda"))
    want, _ = numa_devices("cpu", str(tmp_path / "cpu"))
    assert launches["block"] >= 1 and sum(launches.values()) == \
        launches["block"], launches
    assert sum(n is not None for n in got[0].values()) > 0
    assert any(got[3].values())
    assert got == want

