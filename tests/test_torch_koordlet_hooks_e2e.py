"""The koordlet acting on the scheduler's placements, end to end, in both
packages on the CPU (the koordlet leg of ``tests/test_e2e_sim.py`` at a
small size): 8 nodes on a bus, each with a fake cpuinfo and NUMA sysfs
tree whose ``NodeTopologyReporter`` publishes its NRT and whose
``DeviceReporter`` publishes 4 seeded GPUs; 2 running LS pods a node with
CPU limits; 16 pending pods, a seeded half LSR pods asking 2-4 whole CPUs
(a cpuset) and the rest asking 1-2 GPUs, placed by a wired
``build_scheduler``. Each node then gets a ``build_koordlet`` daemon over
its tree (cgroup v1 on even nodes, v2 on odd ones; NRI mode on half,
crossed with the version; ``AuditEvents`` on), wired with
``wire_koordlet``; a NodeSLO with group identity on is published and each
agent gets its share pools from its NRT; one tick on a fake clock. Every
pinned container holds its cpuset with cfs quota -1, every GPU pod's
container env names its minors. A second wave of 8 pods is placed, their
dirs made: the NRI half runs its hooks off the PLEG alone, the
reconciler half on its next tick; 4 pods are deleted and their dirs
removed, the NRI half's stop stages run. A cpu-normalization ratio of
1.25 on half the nodes rescales the cpu-share pods' quotas; its removal
from a quarter restores their spec quotas once. The placements,
annotations, trees, the executors' writes in order, the server
responses, the audit events and the NRI counts are equal between the
packages.

The scenario is a function of the package and the device, so
``tests/test_torch_koordlet_hooks_cuda.py`` runs it on the card against
the CPU; this module imports the JAX package only inside its test."""

import dataclasses
import enum
import importlib
import json
import math
import os
import shutil

import numpy as np

NODES, RUNNING, PENDING, WAVE, DELETED = 8, 2, 16, 8, 4
GPUS = 4
T0, RECONCILE_S = 1_000_000.0, 10.0
RATIO = 1.25
SEED = 41
GATES = "AuditEvents=true"


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.port = root.endswith("_torch")
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.bus = mod("client.bus")
        self.client = mod("client")
        self.wiring = mod("client.wiring")
        self.DC = mod("device.cache")
        self.H = mod("numa.hints")
        self.EX = mod("koordlet.resourceexecutor.executor")
        self.RH = mod("koordlet.runtimehooks")
        self.CS = mod("koordlet.runtimehooks.cpuset")
        self.SI = mod("koordlet.statesinformer")
        self.CG = mod("koordlet.system.cgroup")
        self.SLO = mod("manager.sloconfig")
        self.cmd = mod("cmd.scheduler")
        self.K = mod("cmd.koordlet")


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
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def events(auditor, root):
    """An audit log oldest first, paths relative to ``root``, without the
    wall-clock timestamps."""
    return [(e.group, os.path.relpath(e.subject, root)
             if e.subject.startswith(root) else e.subject, e.operation,
             e.detail.replace(root, "<root>"))
            for e in reversed(auditor.query())]


def world(seed=SEED):
    """Seeded nodes (16-32 CPUs, 2 NUMA nodes), their GPUs' memory, the
    running pods' requests and limits, and both waves."""
    rng = np.random.default_rng(seed)
    cores = rng.integers(8, 17, NODES) * 2
    mem = rng.integers(64, 129, NODES) * 1024
    gpu_mib = rng.choice([16384, 40960, 81920], (NODES, GPUS))
    running = rng.integers(500, 2000, (NODES, RUNNING))

    def wave(n, offset):
        pods = []
        for j in range(offset, offset + n):
            if j % 2 == 0:
                pods.append(("cpuset", 1000 * int(rng.integers(2, 5)),
                             int(rng.integers(1024, 4096)), 0))
            else:
                pods.append(("gpu", int(rng.integers(500, 2000)),
                             int(rng.integers(1024, 4096)),
                             int(rng.integers(1, 3))))
        return pods

    first = wave(PENDING, 0)
    second = wave(WAVE, PENDING)
    return dict(cores=cores, mem=mem, gpu_mib=gpu_mib, running=running,
                first=first, second=second,
                deleted=sorted(int(k) for k in rng.choice(
                    PENDING + WAVE, DELETED, replace=False)))


def v2_node(i):
    return i % 2 == 1


def nri_node(i):
    return (i // 2) % 2 == 0


def single_numa_node(i):
    """The NRT's policy: SingleNUMANode on every third node, so PreBind
    writes the NUMA nodes it allocated (numaNodeResources)."""
    return i % 3 == 0


def topology(cfg, cores):
    """/proc/cpuinfo and the NUMA sysfs of ``cores`` logical CPUs: 2
    threads a core, 2 NUMA nodes, a socket each."""
    n_cores = cores // 2
    numa = [0 if c < n_cores // 2 else 1 for c in range(n_cores)]
    os.makedirs(cfg.proc_root, exist_ok=True)
    with open(os.path.join(cfg.proc_root, "cpuinfo"), "w") as f:
        f.write("\n".join(
            f"processor\t: {cpu}\nphysical id\t: {numa[cpu // 2]}\n"
            f"core id\t: {cpu // 2}\n" for cpu in range(2 * n_cores)) + "\n")
    for node in (0, 1):
        cpus = [c for c in range(2 * n_cores) if numa[c // 2] == node]
        d = os.path.join(cfg.sysfs_root, "devices", "system", "node",
                         f"node{node}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "cpulist"), "w") as f:
            f.write(f"{cpus[0]}-{cpus[-1]}\n")


def cpu_list(cpus):
    """A sorted CPU set as a cpu-list string ("0-3,8")."""
    out, cpus = [], sorted(cpus)
    start = prev = None
    for c in cpus + [None]:
        if c is not None and prev is not None and c == prev + 1:
            prev = c
            continue
        if start is not None:
            out.append(f"{start}" if start == prev else f"{start}-{prev}")
        start = prev = c
    return ",".join(out)


def topo_info(P, nrt):
    """The share pools an agent takes from its NRT: each NUMA node's CPUs
    less the reserved ones, for LS and BE pods alike."""
    node_of = [int(n) for n in nrt.cpu_topology.node_id]
    reserved = set(nrt.reserved_cpus)
    pools = {numa: cpu_list(c for c, n in enumerate(node_of)
                            if n == numa and c not in reserved)
             for numa in sorted(set(node_of))}
    return P.RH.NodeTopoInfo(share_pools=pools, be_share_pools=dict(pools))


class GPUs:
    def __init__(self, P, mib):
        self.P, self.mib = P, [int(m) for m in mib]

    def list_devices(self):
        DC = self.P.DC
        return [DC.DeviceEntry(
            minor=k, device_type=DC.DeviceType.GPU, resources={
                DC.DeviceResourceName.GPU_CORE: 100,
                DC.DeviceResourceName.GPU_MEMORY: self.mib[k],
                DC.DeviceResourceName.GPU_MEMORY_RATIO: 100},
            numa_node=k * 2 // GPUS, socket_id=k * 2 // GPUS,
            pcie_id=str(k // 2)) for k in range(GPUS)]


def pod_spec(P, j, kind, cpu, mem, gpus, now):
    R, Q = P.X.ResourceName, P.X.QoSClass
    if kind == "cpuset":
        return P.T.PodSpec(name=f"cpuset-{j}", qos=Q.LSR, requests={
            R.CPU: cpu, R.MEMORY: mem}, limits={R.CPU: cpu},
            creation_time=now)
    return P.T.PodSpec(name=f"gpu-{j}", qos=Q.LS, requests={
        R.CPU: cpu, R.MEMORY: mem}, limits={R.CPU: cpu},
        device_requests={"nvidia.com/gpu": gpus}, creation_time=now)


def make_dirs(P, cfg, meta):
    P.EX.ensure_cgroup_dir(meta.cgroup_dir, cfg)
    for cdir in meta.containers.values():
        P.EX.ensure_cgroup_dir(cdir, cfg)


def remove_dirs(P, cfg, cgroup_dir):
    tops = ([cfg.cgroup_root] if cfg.use_cgroup_v2 else
            [os.path.join(cfg.cgroup_root, fs) for fs in P.CG.V1_SUBSYSTEMS])
    for top in tops:
        shutil.rmtree(os.path.join(top, cgroup_dir), ignore_errors=True)


def read(P, res, d, cfg):
    return res.decode(res.read(d, cfg), cfg)


def check_pins(P, bus, agents, names):
    """Every container of a pod whose resource-status carries a cpuset
    holds it in its cpuset file, with cfs quota -1 on the pod and the
    container; every GPU pod's container env names exactly its minors.
    A pod whose status names NUMA nodes and no cpuset holds their share
    pools. Returns the server responses."""
    Kind = P.bus.Kind
    responses = {}
    pinned = gpus = numa_aware = 0
    for name in names:
        daemon = agents[name]
        cfg = daemon.executor.config
        for meta in daemon.states_informer.running_pods():
            spec = bus.get(Kind.POD, meta.uid)
            status = P.CS.parse_resource_status(spec.annotations)
            cpuset = P.CS.cpuset_from_status(status)
            # the NUMA nodes of the resource-status PreBind wrote (its
            # resource keys are the ResourceName integers, as strings)
            numa = P.CS.numa_nodes_from_status(status)
            if status and "numaNodeResources" in status:
                assert numa, spec.annotations
                numa_aware += 1
            if cpuset is None and numa:
                pools = daemon.runtime_hooks.cpuset.rule.share_pools
                want = ",".join(pools[n] for n in numa)
                for cdir in meta.containers.values():
                    assert read(P, P.CG.CPU_SET, cdir, cfg) == want, meta.uid
            if cpuset is not None:
                pinned += 1
                assert read(P, P.CG.CPU_CFS_QUOTA, meta.cgroup_dir, cfg) == "-1"
                for cdir in meta.containers.values():
                    assert read(P, P.CG.CPU_SET, cdir, cfg) == cpuset, meta.uid
                    assert read(P, P.CG.CPU_CFS_QUOTA, cdir, cfg) == "-1"
            for c in meta.containers:
                responses[f"{meta.uid}/{c}"] = (
                    daemon.runtime_hooks.server.create_container(
                        meta, c, apply=False))
            raw = spec.annotations.get(P.X.ANNOTATION_DEVICE_ALLOCATED)
            if raw:
                gpus += 1
                minors = ",".join(str(d["minor"])
                                  for d in json.loads(raw)["gpu"])
                env = responses[f"{meta.uid}/main"].add_envs
                assert env["NVIDIA_VISIBLE_DEVICES"] == minors, meta.uid
                assert env["TPU_VISIBLE_CHIPS"] == minors
    assert numa_aware > 0
    return responses, pinned, gpus


def hook_errors(P, daemon):
    """Every hook failure of ``daemon``'s registry from here on: the
    reconciler and the servers run the hooks under IGNORE with no error
    list, so ``run_hooks`` gets this one wherever its caller gave none."""
    registry = daemon.runtime_hooks.registry
    run, collected = registry.run_hooks, []

    def collecting(stage, proto, fail_policy=P.RH.FailurePolicy.IGNORE,
                   errors=None):
        run(stage, proto, fail_policy,
            collected if errors is None else errors)

    registry.run_hooks = collecting
    return collected


def run(P, root, device=None):
    """The scenario in package ``P`` (the port's scheduler on
    ``device``), under ``root``. Returns what the packages are held equal
    on, and the counts the checks saw."""
    w = world()
    R, Kind = P.X.ResourceName, P.bus.Kind
    dev = {"device": device} if P.port else {}
    bus = P.client.APIServer()
    sched = P.cmd.build_scheduler(P.cmd.SchedulerConfig(
        feature_gates="ElasticQuotaPreemption=false", host_fallback_cells=0),
        **dev)
    P.client.wire_scheduler(bus, sched)
    topo_sink, dev_sink = P.wiring.koordlet_report_sinks(bus)
    names = [f"n{i}" for i in range(NODES)]
    cfgs = {}
    for i, name in enumerate(names):
        bus.apply(Kind.NODE, name, P.T.NodeSpec(name, allocatable={
            R.CPU: int(w["cores"][i]) * 1000, R.MEMORY: int(w["mem"][i])}))
        cfg = cfgs[name] = P.CG.SystemConfig(
            cgroup_root=os.path.join(root, name, "cg"),
            proc_root=os.path.join(root, name, "proc"),
            sysfs_root=os.path.join(root, name, "sys"),
            use_cgroup_v2=v2_node(i))
        topology(cfg, int(w["cores"][i]))
        mem = int(w["mem"][i])
        P.SI.NodeTopologyReporter(
            name, cfg, topo_sink, policy=P.H.NUMATopologyPolicy[
                "SINGLE_NUMA_NODE" if single_numa_node(i) else "NONE"],
            numa_memory_mib={0: mem // 2, 1: mem - mem // 2}).sync()
        P.SI.DeviceReporter(name, GPUs(P, w["gpu_mib"][i]), dev_sink).sync()
        bus.apply(Kind.NODE_METRIC, name, P.T.NodeMetric(
            node_name=name, node_usage={}, update_time=T0))
        for k in range(RUNNING):
            cpu = int(w["running"][i, k])
            pod = P.T.PodSpec(name=f"run-{i}-{k}", qos=P.X.QoSClass.LS,
                              node_name=name, requests={R.CPU: cpu,
                                                        R.MEMORY: 1024},
                              limits={R.CPU: cpu}, creation_time=T0)
            bus.apply(Kind.POD, pod.uid, pod)
    first = [pod_spec(P, j, *p, T0) for j, p in enumerate(w["first"])]
    for pod in first:
        bus.apply(Kind.POD, pod.uid, pod)
    round1 = sched.schedule_pending(now=T0 + 1.0)
    assert not round1.waiting and all(round1[p.uid] for p in first), round1

    # (a) the agents
    agents, errors = {}, {}
    for i, name in enumerate(names):
        cfg = cfgs[name]
        for d in ("kubepods", "kubepods/burstable", "kubepods/besteffort"):
            P.EX.ensure_cgroup_dir(d, cfg)
        for pod in bus.list(Kind.POD).values():
            if pod.node_name == name:
                make_dirs(P, cfg, P.SI.pod_meta_from_spec(pod))
        daemon = agents[name] = P.K.build_koordlet(P.K.KoordletConfig(
            cgroup_root=cfg.cgroup_root, proc_root=cfg.proc_root,
            use_cgroup_v2=cfg.use_cgroup_v2, feature_gates=GATES,
            runtime_hooks_mode="nri" if nri_node(i) else "reconciler",
            reconcile_interval_seconds=RECONCILE_S))
        errors[name] = hook_errors(P, daemon)
        P.client.wire_koordlet(bus, daemon.states_informer, name)
    slo = P.SLO.NodeSLOSpec()
    for tier in ("lsr", "ls", "be"):
        getattr(slo.resource_qos_strategy, tier).enable = True
    for name in names:
        bus.apply(Kind.NODE_SLO, name, slo)
        agents[name].runtime_hooks.set_node_topo(topo_info(
            P, bus.get(Kind.NODE_RESOURCE_TOPOLOGY, name)))
        agents[name].tick(T0 + 2.0)
    responses, pinned, gpus = check_pins(P, bus, agents, names)
    assert pinned == PENDING // 2 and gpus == PENDING // 2, (pinned, gpus)
    for name in names:
        cfg = agents[name].executor.config
        assert read(P, P.CG.CPU_BVT_WARP_NS, "kubepods/burstable", cfg) == "2"
        for meta in agents[name].states_informer.running_pods():
            assert read(P, P.CG.CPU_BVT_WARP_NS, meta.cgroup_dir, cfg) == "2"

    # (b) a second wave, then deletions
    second = [pod_spec(P, j, *p, T0 + 2.0)
              for j, p in enumerate(w["second"], start=PENDING)]
    for pod in second:
        bus.apply(Kind.POD, pod.uid, pod)
    round2 = sched.schedule_pending(now=T0 + 3.0)
    assert not round2.waiting and all(round2[p.uid] for p in second), round2
    handled = {}
    for i, name in enumerate(names):
        daemon = agents[name]
        for pod in second:
            if round2[pod.uid] == name:
                make_dirs(P, cfgs[name], P.SI.pod_meta_from_spec(
                    bus.get(Kind.POD, pod.uid)))
        if nri_node(i):
            daemon.pleg.poll()
            handled[name] = dict(daemon.nri_server.handled)
        else:
            daemon.tick(T0 + 2.0 + RECONCILE_S)
    wave_responses, pinned, gpus = check_pins(P, bus, agents, names)
    assert pinned == (PENDING + WAVE) // 2 and gpus == (PENDING + WAVE) // 2
    everyone = first + second
    gone = [bus.get(Kind.POD, everyone[k].uid) for k in w["deleted"]]
    for pod in gone:
        bus.delete(Kind.POD, pod.uid)
        remove_dirs(P, cfgs[pod.node_name],
                    P.SI.pod_meta_from_spec(pod).cgroup_dir)
    for i, name in enumerate(names):
        if nri_node(i):
            agents[name].pleg.poll()
        else:
            agents[name].tick(T0 + 2.0 + 2 * RECONCILE_S)
    for pod in gone:
        d = P.SI.pod_meta_from_spec(pod).cgroup_dir
        cfg = cfgs[pod.node_name]
        for res in (P.CG.CPU_SET, P.CG.CPU_CFS_QUOTA):
            assert not os.path.exists(res.path(d, cfg)), d
    stops = {name: dict(agents[name].nri_server.handled)
             for i, name in enumerate(names) if nri_node(i)}

    # (c) cpu normalization: a ratio on half the nodes, removed from a
    # quarter
    scaled_names, restored_names = names[: NODES // 2], names[: NODES // 4]
    quotas = []
    for step, (ratio, which) in enumerate(((RATIO, scaled_names),
                                           (None, restored_names),
                                           (None, restored_names))):
        for name in which:
            node = bus.get(Kind.NODE, name)
            ann = dict(node.annotations)
            ann.pop(P.X.ANNOTATION_CPU_NORMALIZATION_RATIO, None)
            if ratio is not None:
                ann[P.X.ANNOTATION_CPU_NORMALIZATION_RATIO] = str(ratio)
            bus.apply(Kind.NODE, name, dataclasses.replace(node,
                                                           annotations=ann))
        now = T0 + 2.0 + (3 + step) * RECONCILE_S
        seen = {}
        for name in names:
            agents[name].tick(now)
            cfg = agents[name].executor.config
            for meta in agents[name].states_informer.running_pods():
                if meta.qos is not P.X.QoSClass.LS:
                    continue
                path = P.CG.CPU_CFS_QUOTA.path(meta.cgroup_dir, cfg)
                seen[meta.uid] = (read(P, P.CG.CPU_CFS_QUOTA,
                                       meta.cgroup_dir, cfg)
                                  if os.path.exists(path) else None)
                spec = P.RH.milli_cpu_to_quota(meta.cpu_limit_mcpu)
                if name in scaled_names and (step == 0 or name not in
                                             restored_names):
                    assert seen[meta.uid] == str(math.ceil(spec / RATIO))
                elif name in restored_names:
                    assert seen[meta.uid] == str(spec), (step, meta.uid)
                else:
                    assert seen[meta.uid] is None, meta.uid
        quotas.append(seen)
    assert all(e == [] for e in errors.values()), errors

    return dict(
        placements=[dict(round1), dict(round2)],
        annotations={u: dict(p.annotations)
                     for u, p in sorted(bus.list(Kind.POD).items())},
        trees={n: tree(os.path.join(root, n, "cg")) for n in names},
        writes={n: events(agents[n].executor.auditor, root) for n in names},
        audit={n: events(agents[n].auditor, root) for n in names},
        responses=[responses, wave_responses],
        nri=[handled, stops], quotas=quotas)


def test_koordlet_hooks_act_on_the_placements(tmp_path):
    ref = plain(run(Pkg("koordinator_tpu"), str(tmp_path / "ref")))
    port = plain(run(Pkg("koordinator_tpu_torch"), str(tmp_path / "port"),
                     device="cpu"))
    for key in ref:
        assert port[key] == ref[key], key
