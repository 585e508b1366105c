"""The node agent's actuation half closing the colocation loop, end to end,
in both packages on the CPU: 32 nodes on a bus, 4 of them wired node
agents whose collectors run over a fake procfs and cgroupfs tree (two on
cgroup v1, two on v2), the other 28 with their samples appended to their
caches directly; the reports, the manager's PATCH and a first round (a
seeded half BE pods on batch resources). Then the manager publishes a
NodeSLO with the BE thresholds on (memory evict at 70%, CPU suppress at
65%, the CPU evict satisfaction band 60-80%; the suppress policy cpuset
on two agents, cfsQuota on the other two), the agents run all eight QoS
strategies over their trees (with a fake resctrl tree and /proc/sys/vm)
while one is pushed over the memory threshold and one's BE tier starved,
and a seeded quarter of the other nodes run the memory evictor over the
threshold. Each victim is deleted from the bus, its pod directories
removed from its agent's tree (a PLEG over each tree reports exactly the
victims) and re-created unbound under a new name; the agents collect
again, every node reports, the manager reconciles and a second round
re-places the victims. The victims in order, the trees, the reports, the
batch allocatable and the placements are equal between the packages.

The scenario is a function of the package and the device, so
``tests/test_torch_koordlet_qos_cuda.py`` runs it on the card against
the CPU; this module imports the JAX package only inside its test."""

import dataclasses
import enum
import importlib
import os
import shutil

import numpy as np

NODES, AGENTS, RUNNING, PENDING = 32, 4, 2, 64
TICKS, STEP, T0 = 11, 30.0, 1_000_000.0
#: the collectors' ticks under pressure, then one after the evictions
PRESSURE_TICKS = 2
#: the NodeSLO's BE thresholds (percent)
MEMORY_EVICT, CPU_SUPPRESS, SATISFACTION = 70, 65, (60, 80)
#: agents pushed over the memory threshold, agents whose BE tier is
#: starved, and the share of the other nodes over the memory threshold
MEMORY_AGENTS, STARVED_AGENTS, FED_PRESSED = 1, 1, 0.25
SEED = 20


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.port = root.endswith("_torch")
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.bus = mod("client.bus")
        self.client = mod("client")
        self.AUD = mod("koordlet.audit")
        self.MC = mod("koordlet.metriccache")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.CO = mod("koordlet.metricsadvisor.collectors")
        self.SI = mod("koordlet.statesinformer")
        self.SIS = mod("koordlet.statesinformer.states_informer")
        self.CG = mod("koordlet.system.cgroup")
        self.CPUI = mod("koordlet.system.cpuinfo")
        self.RE = mod("koordlet.resourceexecutor")
        self.EX = mod("koordlet.resourceexecutor.executor")
        self.Q = mod("koordlet.qosmanager")
        self.PLEG = mod("koordlet.pleg")
        self.NM = mod("manager.nodemetric")
        self.NSLO = mod("manager.nodeslo")
        self.SLO = mod("manager.sloconfig")
        self.cmd = mod("cmd.scheduler")


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
            with open(path) as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def now_at(k):
    return T0 + STEP * k


def world(seed=SEED):
    """Seeded nodes, running pods, the counters a node exposes over the
    first TICKS ticks, and the pending wave."""
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
    # whole microseconds: the v2 agents' cpu.stat carries usage_usec
    pod_ns = 10**9 + np.cumsum(np.rint(pod_cores * STEP * 1e6).astype(
        np.int64), axis=2) * 1000
    pod_bytes = np.rint(rng.uniform(0.4, 0.9, (NODES, RUNNING, TICKS))
                        * req_mem[..., None] * 2**20).astype(np.int64)
    used_kb = pod_bytes.sum(axis=1) // 1024 + rng.integers(2**20, 2**22,
                                                          (NODES, 1))
    pending = [(int(rng.integers(100, 4000)), int(rng.integers(128, 8192)),
                bool(rng.random() < 0.5)) for _ in range(PENDING)]
    return dict(cores=cores, mem=mem, req_cpu=req_cpu, req_mem=req_mem,
                jiffies=jiffies, pod_ns=pod_ns, pod_bytes=pod_bytes,
                used_kb=used_kb, pending=pending)


def v2_agent(i):
    return i % 2 == 1


def cpu_text(P, cfg, ns, throttle=None):
    """The cpu counter file's content: v1 cpuacct.usage in ns, v2
    cpu.stat's usage_usec (with the throttling counters when given)."""
    if not cfg.use_cgroup_v2:
        return str(ns)
    text = f"usage_usec {ns // 1000}\n"
    if throttle is not None:
        text += f"nr_periods {throttle[0]}\nnr_throttled {throttle[1]}\n"
    return text


def quota_text(cfg, quota_us):
    """A cfs quota as the kernel shows it: v1 ``cpu.cfs_quota_us``, v2
    ``cpu.max`` with its period."""
    return f"{quota_us} 100000" if cfg.use_cgroup_v2 else str(quota_us)


def put(res, d, cfg, text):
    path = res.path(d, cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def write_tree(P, cfg, w, i, metas, k):
    """Phase 21's tree of agent ``i`` at tick ``k``."""
    os.makedirs(cfg.proc_root, exist_ok=True)
    with open(os.path.join(cfg.proc_root, "stat"), "w") as f:
        f.write(f"cpu  {w['jiffies'][i, k]} 0 0 {10**9 + k} 0 0 0 0 0 0\n")
    total = int(w["mem"][i]) * 1024
    with open(os.path.join(cfg.proc_root, "meminfo"), "w") as f:
        f.write(f"MemTotal: {total} kB\nMemAvailable: "
                f"{total - w['used_kb'][i, k]} kB\n")
    for j, meta in enumerate(metas):
        put(P.CG.CPU_ACCT_USAGE, meta.cgroup_dir, cfg,
            cpu_text(P, cfg, int(w["pod_ns"][i, j, k])))
        put(P.CG.MEMORY_USAGE, meta.cgroup_dir, cfg,
            str(w["pod_bytes"][i, j, k]))


def fed_rows(w, i):
    """The samples the collectors would derive for node ``i`` at every
    tick: node cpu, node memory, pod cpu, pod memory."""
    jif = w["jiffies"][i].astype(np.float64)
    ns = w["pod_ns"][i].astype(np.float64)
    return (np.maximum(jif[1:] - jif[:-1], 0.0) / STEP / 100 * 1000.0,
            w["used_kb"][i] / 1024.0,
            np.maximum(ns[:, 1:] - ns[:, :-1], 0.0) / STEP / 1e9 * 1000.0,
            w["pod_bytes"][i] / (1024.0 * 1024.0))


def fed_tick(P, cache, rows, uids, k, now, memory=None):
    """Append the samples of tick ``k`` (``memory`` in place of the
    node's when given) at ``now``."""
    K = P.MC.MetricKind
    node_cpu, node_mem, pod_cpu, pod_mem = rows
    mem = node_mem[k] if memory is None else memory
    cache.append(K.NODE_MEMORY_USAGE, None, now, mem)
    cache.append(K.SYS_MEMORY_USAGE, None, now,
                 max(mem - sum(pod_mem[j, k] for j in range(len(uids))), 0.0))
    for j, u in enumerate(uids):
        cache.append(K.POD_MEMORY_USAGE, {"pod": u}, now, pod_mem[j, k])
        if k:
            cache.append(K.POD_CPU_USAGE, {"pod": u}, now, pod_cpu[j, k - 1])
    if k:
        cache.append(K.NODE_CPU_USAGE, None, now, node_cpu[k - 1])
        cache.append(K.SYS_CPU_USAGE, None, now, max(
            node_cpu[k - 1] - sum(pod_cpu[j, k - 1]
                                  for j in range(len(uids))), 0.0))


def build(P, root, w, device):
    """The reporting half (the world of ``tests/test_torch_koordlet_e2e.py``)
    and round 1. Returns the world as a dict."""
    R, Kind = P.X.ResourceName, P.bus.Kind
    dev = {"device": device} if P.port else {}
    bus = P.client.APIServer()
    sched = P.cmd.build_scheduler(P.cmd.SchedulerConfig(
        feature_gates="ElasticQuotaPreemption=false",
        aggregated_usage_thresholds={R.CPU: 65, R.MEMORY: 95},
        aggregated_usage_pct=99, aggregated_score_pct=99,
        host_fallback_cells=0), **dev)
    P.client.wire_scheduler(bus, sched)
    manager = P.client.wire_manager(bus, **dev)
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
    loops, advisors, informers, reporters = {}, {}, {}, {}
    for i, name in enumerate(names):
        informer = informers[name] = P.SI.StatesInformer()
        informer.set_collect_policy(P.NM.NodeMetricCollectPolicy(300, 60))
        reporters[name] = P.SI.NodeMetricReporter(P.MC.MetricCache(),
                                                  informer)
        if i < AGENTS:
            loops[name] = P.client.wire_koordlet(bus, informer, name,
                                                 reporter=reporters[name])
            cfg = P.CG.SystemConfig(
                cgroup_root=os.path.join(root, name, "cg"),
                proc_root=os.path.join(root, name, "proc"),
                sysfs_root=os.path.join(root, name, "sys"),
                use_cgroup_v2=v2_agent(i))
            advisors[name] = (cfg, P.FW.MetricsAdvisor(
                P.FW.CollectorContext(
                    metric_cache=reporters[name].metric_cache,
                    system_config=cfg, pod_provider=informer),
                P.CO.default_collectors(), interval_seconds=STEP))
        else:
            informer.set_node(bus.get(Kind.NODE, name))
            informer.set_pods([P.SI.pod_meta_from_spec(bus.get(Kind.POD, u))
                               for u in uids[name]])
            rows = fed_rows(w, i)
            for k in range(TICKS):
                fed_tick(P, reporters[name].metric_cache, rows, uids[name],
                         k, now_at(k))
    for k in range(TICKS):
        for i, name in enumerate(names[:AGENTS]):
            cfg, adv = advisors[name]
            write_tree(P, cfg, w, i, adv.ctx.pod_provider.running_pods(), k)
            adv.tick(now_at(k))
    now = now_at(TICKS - 1)
    for name in names:
        if name in loops:
            loops[name].report(now)
        else:
            bus.apply(Kind.NODE_METRIC, name, reporters[name].report(now))
    manager.reconcile(now=now)
    for j, (cpu, mem, be) in enumerate(w["pending"]):
        pod = (P.T.PodSpec(name=f"p{j}", qos=P.X.QoSClass.BE, priority=5500,
                           requests={R.BATCH_CPU: cpu, R.BATCH_MEMORY: mem},
                           creation_time=T0)
               if be else P.T.PodSpec(name=f"p{j}", requests={
                   R.CPU: cpu, R.MEMORY: mem}, creation_time=T0))
        bus.apply(Kind.POD, pod.uid, pod)
    round1 = sched.schedule_pending(now=now + 1.0)
    return dict(bus=bus, sched=sched, manager=manager, names=names,
                uids=uids, loops=loops, advisors=advisors,
                informers=informers, reporters=reporters, root=root,
                round1=round1)


# -- the actuation half ------------------------------------------------------


def node_slo(P, policies):
    """The NodeSLO renderer: the BE thresholds on, memcg QoS and a blkio
    throttle for BE pods, CPU burst on, the /proc/sys knobs; each node's
    suppress policy from ``policies`` (an extender)."""
    spec = P.SLO.NodeSLOSpec()
    t = spec.resource_used_threshold_with_be
    t.enable = True
    t.memory_evict_threshold_percent = MEMORY_EVICT
    t.cpu_suppress_threshold_percent = CPU_SUPPRESS
    (t.cpu_evict_be_satisfaction_lower_percent,
     t.cpu_evict_be_satisfaction_upper_percent) = SATISFACTION
    be = spec.resource_qos_strategy.be
    be.enable = True
    be.memory = P.SLO.MemoryQOS(min_limit_percent=20, low_limit_percent=40,
                                throttling_percent=90)
    be.blkio = [P.SLO.BlockCfg(device="253:0", read_bps=52428800,
                               write_iops=400)]
    spec.cpu_burst_strategy.policy = "auto"
    spec.system_strategy = P.SLO.SystemStrategy(
        min_free_kbytes_factor=100, watermark_scale_factor=150)

    def policy(name, labels, rendered):
        rendered.resource_used_threshold_with_be.cpu_suppress_policy = (
            policies.get(name, "cpuset"))

    return P.NSLO.NodeSLOController(cluster_spec=spec, extenders=[policy])


def topology(cfg, cores, vendor):
    """/proc/cpuinfo (``vendor``) and the NUMA sysfs of ``cores`` logical
    CPUs: 2 threads a core, 2 NUMA nodes, a socket each."""
    n_cores = cores // 2
    numa = [0 if c < n_cores // 2 else 1 for c in range(n_cores)]
    os.makedirs(cfg.proc_root, exist_ok=True)
    with open(os.path.join(cfg.proc_root, "cpuinfo"), "w") as f:
        f.write("\n".join(
            f"processor\t: {cpu}\nvendor_id\t: {vendor}\nphysical id\t: "
            f"{numa[cpu // 2]}\ncore id\t: {cpu // 2}\n"
            for cpu in range(2 * n_cores)) + "\n")
    for node in (0, 1):
        cpus = [c for c in range(2 * n_cores) if numa[c // 2] == node]
        d = os.path.join(cfg.sysfs_root, "devices", "system", "node",
                         f"node{node}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "cpulist"), "w") as f:
            f.write(f"{cpus[0]}-{cpus[-1]}\n")


def resctrl_tree(cfg, ways, cache_ids):
    root = os.path.join(os.path.dirname(cfg.cgroup_root), "resctrl")
    os.makedirs(os.path.join(root, "info", "L3"))
    cbm = format((1 << ways) - 1, "x")
    with open(os.path.join(root, "info", "L3", "cbm_mask"), "w") as f:
        f.write(cbm + "\n")
    with open(os.path.join(root, "schemata"), "w") as f:
        f.write("L3:" + ";".join(f"{c}={cbm}" for c in range(cache_ids))
                + "\nMB:" + ";".join(f"{c}=100" for c in range(cache_ids))
                + "\n")


def remove_pod_dirs(P, cfg, cgroup_dir):
    """What the kubelet removes of a deleted pod: its cgroup dirs."""
    tops = ([cfg.cgroup_root] if cfg.use_cgroup_v2 else
            [os.path.join(cfg.cgroup_root, fs) for fs in P.CG.V1_SUBSYSTEMS])
    for top in tops:
        shutil.rmtree(os.path.join(top, cgroup_dir), ignore_errors=True)


def draw_pressure(names, be_hosts, seed):
    """The seeded pressure of the actuation half: the agents' suppress
    policies, which agents go over the memory threshold (of those that
    run a BE pod, ``be_hosts``) and which have their BE tier starved,
    which other nodes go over the memory threshold, and their usage
    shares."""
    rng = np.random.default_rng(seed)
    agents = list(range(AGENTS))
    policies = {names[i]: ("cfsQuota" if (i // 2) % 2 else "cpuset")
                for i in agents}
    memory = sorted(int(x) for x in rng.choice(be_hosts, MEMORY_AGENTS,
                                               replace=False))
    cpuset = [i for i in agents if policies[names[i]] == "cpuset"
              and i not in memory]
    starved = sorted(int(x) for x in rng.choice(cpuset, STARVED_AGENTS,
                                                replace=False))
    fed = np.arange(AGENTS, len(names))
    pressed = sorted(int(x) for x in rng.choice(
        fed, int(round(FED_PRESSED * len(fed))), replace=False))
    share = rng.uniform(0.75, 0.92, len(names))
    return dict(policies=policies, memory=memory, starved=starved,
                pressed=pressed, share=share, seed=seed)


def residents(P, name, i, starved, rng):
    """The seeded pods that were already running on agent ``i``: an LS pod
    with a CPU limit (CPU burst's subject) and, on a starved agent, three
    BE pods requesting plain CPU (the CPU evictor's: batch pods request
    no CPU)."""
    R = P.X.ResourceName
    pods = [P.T.PodSpec(name=f"burst-{i}", qos=P.X.QoSClass.LS,
                        node_name=name, priority=9000,
                        requests={R.CPU: 1000, R.MEMORY: 1024},
                        limits={R.CPU: 2000}, creation_time=T0)]
    if i in starved:
        for k in range(3):
            pods.append(P.T.PodSpec(
                name=f"be-{i}-{k}", qos=P.X.QoSClass.BE, node_name=name,
                priority=int(rng.integers(5000, 6000)),
                requests={R.CPU: int(rng.integers(1000, 3001)),
                          R.MEMORY: int(rng.integers(512, 2049))},
                creation_time=T0))
    return pods


class Agent:
    """One agent's actuation half: its QoSContext wired as the node agent
    wires it, its QoSManager over the eight strategies, its PLEG, and the
    counters its fake tree exposes from here on."""

    def __init__(self, P, W, w, i, pr, evict, clock):
        Kind, R = P.bus.Kind, P.X.ResourceName
        self.P, self.i, self.name = P, i, W["names"][i]
        self.informer = W["informers"][self.name]
        self.cfg, self.advisor = W["advisors"][self.name]
        node = W["bus"].get(Kind.NODE, self.name)
        ex = P.RE.ResourceUpdateExecutor(self.cfg, clock=clock)
        ex.auditor = self.auditor = P.AUD.Auditor(clock=clock)
        informer = self.informer

        def be_allocatable():
            n = informer.get_node()
            value = n.allocatable.get(R.BATCH_CPU) if n else None
            return int(value) if value else None

        self.ctx = P.Q.QoSContext(
            metric_cache=W["reporters"][self.name].metric_cache,
            executor=ex, pod_provider=informer, system_config=self.cfg,
            auditor=self.auditor,
            node_capacity_mcpu=node.allocatable[R.CPU],
            node_capacity_mem_mib=node.allocatable[R.MEMORY],
            volume_name_fn=informer.get_volume_name,
            be_allocatable_fn=be_allocatable,
            evict=lambda victims, reason: evict(self.name, victims, reason))
        informer.register_callback(
            P.SIS.StateKind.NODE_SLO,
            lambda kind, slo: setattr(self.ctx, "node_slo", slo))
        self.manager = P.Q.QoSManager(self.ctx, [
            P.Q.CPUSuppress(), P.Q.CPUEvictor(), P.Q.MemoryEvictor(),
            P.Q.CPUBurst(), P.Q.ResctrlReconcile(),
            P.Q.CgroupResourcesReconcile(), P.Q.BlkIOReconcile(),
            P.Q.SystemConfigReconcile()])
        self.pressed = i in pr["memory"]
        self.starved = i in pr["starved"]
        self.rng = np.random.default_rng([pr["seed"], i])
        self.cores = int(w["cores"][i])
        self.total_kb = int(w["mem"][i]) * 1024
        self.jiffies = int(w["jiffies"][i, TICKS - 1])
        self.ns = {u: int(w["pod_ns"][i, j, TICKS - 1])
                   for j, u in enumerate(W["uids"][self.name])}
        self.share = float(pr["share"][i])

    def setup(self):
        """The kubelet's dirs for every running pod (every v1 subsystem),
        the tiers, the topology, the resctrl tree, /proc/sys/vm, the
        seeded usage of the pods that arrived, the starved BE tier's quota
        and the burst pod's quota; then the PLEG's primer poll."""
        P, cfg = self.P, self.cfg
        for d in ("kubepods", "kubepods/besteffort", "kubepods/burstable"):
            P.EX.ensure_cgroup_dir(d, cfg)
        topology(cfg, self.cores,
                 "AuthenticAMD" if self.i % 4 == 3 else "GenuineIntel")
        self.ctx.cpu_infos = [
            P.Q.CPUInfo(cpu_id=x.cpu_id, core_id=x.core_id,
                        socket_id=x.socket_id, node_id=x.node_id)
            for x in P.CPUI.read_cpu_infos(cfg)]
        resctrl_tree(cfg, 11 + self.i % 9, 2)
        os.makedirs(os.path.join(cfg.proc_root, "sys", "vm"), exist_ok=True)
        self.rate, self.bytes = {}, {}
        be_request = 0
        for meta in sorted(self.informer.running_pods(), key=lambda m: m.uid):
            P.EX.ensure_cgroup_dir(meta.cgroup_dir, cfg)
            for c in meta.containers.values():
                P.EX.ensure_cgroup_dir(c, cfg)
            cpu = (meta.cpu_request_mcpu or sum(
                b.request_mcpu for b in meta.batch_resources.values()))
            mem = (meta.memory_request_mib or sum(
                b.memory_limit_bytes for b in meta.batch_resources.values())
                // 2**20)
            share = self.rng.uniform(0.2, 0.9)
            if self.starved and meta.qos is P.X.QoSClass.BE and \
                    meta.cpu_request_mcpu:
                share = 0.5
                be_request += meta.cpu_request_mcpu
            self.rate[meta.uid] = share * cpu / 1000.0
            self.bytes[meta.uid] = int(self.rng.uniform(0.4, 0.9) * mem
                                       * 2**20)
            self.ns.setdefault(meta.uid, int(self.rng.integers(10**9,
                                                               10**10)))
            if meta.name.startswith("burst-"):
                for d in (meta.cgroup_dir, *meta.containers.values()):
                    put(P.CG.CPU_CFS_QUOTA, d, cfg,
                        quota_text(cfg, 200000))
        if self.starved:
            # half the BE pods' CPU request: satisfaction 50% < 60%
            put(P.CG.CPU_CFS_QUOTA, "kubepods/besteffort", cfg,
                quota_text(cfg, be_request * 100 // 2))
        self.sys_cores = self.rng.uniform(0.05, 0.3) * self.cores
        self.sys_kb = int(self.rng.integers(2**20, 2**22))
        pods_kb = sum(self.bytes.values()) // 1024
        self.extra_kb = (max(int(self.share * self.total_kb) - pods_kb
                             - self.sys_kb, 0) if self.pressed else 0)
        self.pleg = P.PLEG.PLEG(cfg)
        self.pleg.poll()

    def tick(self, k):
        """Write the tree at tick ``k`` and run the collectors."""
        P, cfg = self.P, self.cfg
        live = sorted(self.informer.running_pods(), key=lambda m: m.uid)
        busy = self.sys_cores + sum(self.rate[m.uid] for m in live)
        self.jiffies += int(round(busy * 100 * STEP))
        with open(os.path.join(cfg.proc_root, "stat"), "w") as f:
            f.write(f"cpu  {self.jiffies} 0 0 {10**9 + k} 0 0 0 0 0 0\n")
        used = (sum(self.bytes[m.uid] for m in live) // 1024 + self.sys_kb
                + self.extra_kb)
        with open(os.path.join(cfg.proc_root, "meminfo"), "w") as f:
            f.write(f"MemTotal: {self.total_kb} kB\nMemAvailable: "
                    f"{max(self.total_kb - used, 0)} kB\n")
        for m in live:
            self.ns[m.uid] += int(round(self.rate[m.uid] * STEP * 1e6)) * 1000
            throttle = ((100 * k, 30 * k) if m.name.startswith("burst-")
                        else None)
            put(P.CG.CPU_ACCT_USAGE, m.cgroup_dir, cfg,
                cpu_text(P, cfg, self.ns[m.uid], throttle))
            if throttle is not None and not cfg.use_cgroup_v2:
                put(P.CG.CPU_STAT, m.cgroup_dir, cfg,
                    f"nr_periods {throttle[0]}\nnr_throttled {throttle[1]}\n")
            put(P.CG.MEMORY_USAGE, m.cgroup_dir, cfg, str(self.bytes[m.uid]))
        self.advisor.tick(now_at(k))


def actuate(P, W, w, seed=SEED + 1):
    """The actuation half on a built world: (a) the NodeSLO and the agents'
    QoS wiring, (b) the seeded pressure, (c) the QoS ticks with the
    eviction glue and the PLEG's check, (d) collect, report, reconcile and
    the round that re-places the victims. Returns what the two packages
    (or two devices) are held to."""
    Kind, R = P.bus.Kind, P.X.ResourceName
    bus, names = W["bus"], W["names"]
    be_hosts = [i for i in range(AGENTS) if any(
        m.qos is P.X.QoSClass.BE
        for m in W["informers"][names[i]].running_pods())]
    pr = draw_pressure(names, be_hosts, seed)
    clock_now = [now_at(TICKS - 1) + 2.0]
    clock = lambda: clock_now[0]  # noqa: E731
    victims, recreated = [], {}
    agents = {}

    def evict(node, metas, reason):
        """The eviction glue: delete from the bus, remove the pod's dirs
        from the agent's tree, re-create it unbound under a new name."""
        for meta in metas:
            pod = bus.get(Kind.POD, meta.uid)
            bus.delete(Kind.POD, meta.uid)
            if node in agents:
                remove_pod_dirs(P, agents[node].cfg, meta.cgroup_dir)
            new = P.T.PodSpec(name=f"{pod.name}-r", qos=pod.qos,
                              priority=pod.priority,
                              requests=dict(pod.requests),
                              limits=dict(pod.limits),
                              creation_time=clock_now[0])
            bus.apply(Kind.POD, new.uid, new)
            victims.append((node, reason, meta.uid, meta.cgroup_dir, new.uid))
            recreated[new.uid] = node
        return [m.uid for m in metas]

    # (a) the agents' QoS wiring, then the NodeSLO through the manager
    for i in range(AGENTS):
        a = Agent(P, W, w, i, pr, evict, clock)
        agents[a.name] = a
    W["manager"].nodeslo = node_slo(P, pr["policies"])
    W["manager"].reconcile(now=clock_now[0])
    for a in agents.values():
        slo = a.ctx.node_slo
        assert slo.resource_used_threshold_with_be.enable
        assert (slo.resource_used_threshold_with_be.cpu_suppress_policy
                == pr["policies"][a.name])
    # (b) pressure: the residents, the agents' trees, the fed caches
    rng = np.random.default_rng(seed)
    for i in range(AGENTS):
        for pod in residents(P, names[i], i, pr["starved"], rng):
            bus.apply(Kind.POD, pod.uid, pod)
    for a in agents.values():
        a.setup()
    for k in range(TICKS, TICKS + PRESSURE_TICKS):
        for a in agents.values():
            a.tick(k)
    t_qos = now_at(TICKS + PRESSURE_TICKS - 1)
    clock_now[0] = t_qos
    fed = {}
    for i in range(AGENTS, len(names)):
        name = names[i]
        informer = W["informers"][name]
        metas = sorted((P.SI.pod_meta_from_spec(p)
                        for p in bus.list(Kind.POD).values()
                        if p.node_name == name), key=lambda m: m.uid)
        informer.set_pods(metas)
        node = bus.get(Kind.NODE, name)
        cache = W["reporters"][name].metric_cache
        mem = {}
        if i in pr["pressed"]:
            cache.append(P.MC.MetricKind.NODE_MEMORY_USAGE, None, t_qos,
                         float(pr["share"][i] * node.allocatable[R.MEMORY]))
            for m in metas:
                if m.qos is P.X.QoSClass.BE:
                    mem[m.uid] = float(int(rng.integers(256, 4096)))
                    cache.append(P.MC.MetricKind.POD_MEMORY_USAGE,
                                 {"pod": m.uid}, t_qos, mem[m.uid])
        cfg = P.CG.SystemConfig(cgroup_root=os.path.join(W["root"], name),
                                proc_root=os.path.join(W["root"], name),
                                sysfs_root=os.path.join(W["root"], name))
        ctx = P.Q.QoSContext(
            metric_cache=cache, executor=P.RE.ResourceUpdateExecutor(cfg),
            pod_provider=informer, system_config=cfg,
            node_slo=bus.get(Kind.NODE_SLO, name),
            node_capacity_mcpu=node.allocatable[R.CPU],
            node_capacity_mem_mib=node.allocatable[R.MEMORY],
            evict=lambda metas, reason, n=name: evict(n, metas, reason))
        fed[name] = (ctx, P.Q.QoSManager(ctx, [P.Q.MemoryEvictor()]), mem)
    # (c) the QoS ticks: the agents' eight strategies, the others' memory
    # evictor
    for name in names:
        if name in agents:
            agents[name].manager.tick(t_qos)
        else:
            fed[name][1].tick(t_qos)
    pleg = {}
    for name, a in agents.items():
        events = [(e.event.name, e.cgroup_dir) for e in a.pleg.poll()]
        mine = sorted(v[3] for v in victims if v[0] == name)
        assert sorted(d for ev, d in events if ev == "POD_DELETED") == mine
        assert all(ev == "POD_DELETED" or (ev == "CONTAINER_DELETED"
                                           and os.path.dirname(d) in mine)
                   for ev, d in events), events
        pleg[name] = events
    # (d) collect, report, reconcile, re-place
    k = TICKS + PRESSURE_TICKS
    t_report = now_at(k)
    clock_now[0] = t_report
    for a in agents.values():
        a.tick(k)
    for i in range(AGENTS, len(names)):
        name = names[i]
        informer = W["informers"][name]
        informer.set_pods(sorted((P.SI.pod_meta_from_spec(p)
                                  for p in bus.list(Kind.POD).values()
                                  if p.node_name == name),
                                 key=lambda m: m.uid))
        live = [u for u in W["uids"][name]
                if bus.get(Kind.POD, u) is not None]
        memory = None
        if i in pr["pressed"]:
            gone = sum(v for u, v in fed[name][2].items()
                       if bus.get(Kind.POD, u) is None)
            memory = float(pr["share"][i] * bus.get(
                Kind.NODE, name).allocatable[R.MEMORY]) - gone
        rows = fed_rows(w, i)
        fed_tick(P, W["reporters"][name].metric_cache, rows,
                 live, TICKS - 1, t_report, memory)
    reports = {}
    for name in names:
        if name in W["loops"]:
            reports[name] = W["loops"][name].report(t_report)
        else:
            reports[name] = W["reporters"][name].report(t_report)
            bus.apply(Kind.NODE_METRIC, name, reports[name])
    synced = W["manager"].reconcile(now=t_report)
    nodes = {n: x for n, x in bus.list(Kind.NODE).items()}
    batch = {n: (x.allocatable.get(R.BATCH_CPU, 0),
                 x.allocatable.get(R.BATCH_MEMORY, 0))
             for n, x in nodes.items()}
    pending = sorted(u for u, p in bus.list(Kind.POD).items()
                     if not p.node_name)
    result = W["sched"].schedule_pending(now=t_report + 1.0)
    placed = {u: n for u, n in result.items() if n is not None}
    back = sum(placed.get(u) == n for u, n in recreated.items())
    return dict(
        victims=victims, pleg=pleg, pending=pending,
        trees={n: tree(os.path.dirname(a.cfg.cgroup_root))
               for n, a in agents.items()},
        audits={n: audit_events(a) for n, a in agents.items()},
        reports=reports, synced=synced, batch=batch, nodes=nodes,
        placed=dict(result), waiting=dict(result.waiting), back=back,
        pressure=pr, recreated=recreated)


def audit_events(agent):
    """The agent's audit log (its executor's and its strategies'), oldest
    first, its tree's root written as ``<root>``."""
    root = os.path.dirname(agent.cfg.cgroup_root)
    return [(e.timestamp, e.group, e.subject.replace(root, "<root>"),
             e.operation, e.detail.replace(root, "<root>"))
            for e in reversed(agent.auditor.query())]


def check_fits(P, out, before_pods):
    """Every placement of the round fits its node's allocatable as the
    bus held it after the PATCH, on each resource the pod requests."""
    R = P.X.ResourceName
    kinds = [R.CPU, R.MEMORY, R.BATCH_CPU, R.BATCH_MEMORY]
    load = {n: {r: 0 for r in kinds} for n in out["nodes"]}
    for p in before_pods:
        for r in kinds:
            load[p.node_name][r] += p.requests.get(r, 0)
    placed = {**{u: n for u, n in out["placed"].items() if n is not None},
              **out["waiting"]}
    for uid, node in placed.items():
        for r in kinds:
            load[node][r] += out["pods"][uid].requests.get(r, 0)
    for uid, node in placed.items():
        alloc = out["nodes"][node].allocatable
        for r in kinds:
            if out["pods"][uid].requests.get(r, 0) > 0:
                assert load[node][r] <= alloc.get(r, 0), (node, r)


def run(P, root, device="cpu", seed=SEED):
    """Build, round 1, the actuation half; the bound pods before the round
    and the pending pods by uid ride along for :func:`check_fits`."""
    w = world(seed)
    W = build(P, root, w, device)
    Kind = P.bus.Kind
    inner = W["sched"].schedule_pending
    seen = {}

    def schedule(now=None, trigger=None):
        pods = W["bus"].list(Kind.POD).values()
        seen["before"] = [p for p in pods if p.node_name]
        seen["pods"] = {p.uid: p for p in pods if not p.node_name}
        return inner(now=now, trigger=trigger)

    W["sched"].schedule_pending = schedule
    out = actuate(P, W, w, seed + 1)
    out["pods"] = seen["pods"]
    out["before"] = seen["before"]
    out["round1"] = dict(W["round1"])
    return out


def comparable(out):
    return plain({k: out[k] for k in (
        "victims", "pleg", "pending", "trees", "audits", "reports", "synced",
        "batch", "placed", "waiting", "back", "round1")})


def test_actuation_closes_the_loop(tmp_path):
    ref_pkg, port_pkg = Pkg("koordinator_tpu"), Pkg("koordinator_tpu_torch")
    ref = run(ref_pkg, str(tmp_path / "ref"))
    port = run(port_pkg, str(tmp_path / "port"))
    check_fits(port_pkg, port, port["before"])
    reasons = {v[1] for v in port["victims"]}
    assert reasons == {"evict by node memory usage",
                       "evict by BE cpu satisfaction"}, reasons
    starved = port["pressure"]["starved"]
    assert any(v[0] == f"n{starved[0]}" for v in port["victims"])
    assert set(port["recreated"]) <= set(port["pending"])
    replaced = [u for u in port["recreated"] if port["placed"].get(u)]
    assert replaced, "no victim re-placed"
    assert all(port["audits"].values())
    for name, files in port["trees"].items():
        assert any(p.endswith("schemata") for p in files), name
        assert "proc/sys/vm/min_free_kbytes" in files, name
    a, b = comparable(ref), comparable(port)
    for key in a:
        assert b[key] == a[key], key
