"""The port's QoS strategies (``koordlet/qosmanager``: the framework, cpu
suppress, the memory and cpu evictors, cpu burst with its quota-burst
limiter) against the JAX package's. The cases are those of
``tests/test_qosmanager.py``, plus a memory-eviction tie (equal
priorities, no metrics, names that are prefixes of one another) and a
negative suppress budget. Each case runs through both packages, each on
its own fake cgroup tree (v1 and v2) under ``tmp_path`` with the same
fake clock; it asserts the reference's expectations where they were
written (cgroup v1) and returns what it observed: the tree's files, the
audit events, the victims in order and the strategies' state. The two
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
        self.X = mod("apis.extension")
        self.AUD = mod("koordlet.audit")
        self.MC = mod("koordlet.metriccache")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.Q = mod("koordlet.qosmanager")
        self.CS = mod("koordlet.qosmanager.cpusuppress")
        self.CB = mod("koordlet.qosmanager.cpuburst")
        self.EV = mod("koordlet.qosmanager.evictors")
        self.RE = mod("koordlet.resourceexecutor")
        self.EX = mod("koordlet.resourceexecutor.executor")
        self.CG = mod("koordlet.system.cgroup")
        self.SLO = mod("manager.sloconfig")


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


def topo_2numa_8cpu(P):
    """2 NUMA nodes x 2 cores x 2 HT = 8 cpus; siblings adjacent ids."""
    return [P.Q.CPUInfo(cpu_id=node * 4 + core * 2 + ht,
                        core_id=node * 2 + core, socket_id=0, node_id=node)
            for node in range(2) for core in range(2) for ht in range(2)]


def pod(P, uid, cgroup_dir, qos, **kw):
    return P.FW.PodMeta(uid, cgroup_dir, getattr(P.X.QoSClass, qos), **kw)


class StaticPods:
    def __init__(self, pods):
        self.pods = pods

    def running_pods(self):
        return self.pods


class Node:
    """One package's node: a fake cgroup tree (v1 or v2) under ``root``,
    an executor and two audit logs on a fake clock, a recording evict
    callback and the ``QoSContext`` over them (``make_ctx`` of
    ``tests/test_qosmanager.py``)."""

    def __init__(self, P, root, pods, v2, slo=None, cap_mcpu=8000,
                 cap_mem=16384, evict=False):
        self.P, self.root = P, str(root)
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.cfg = P.CG.SystemConfig(cgroup_root=os.path.join(self.root, "cg"),
                                     proc_root=os.path.join(self.root, "proc"),
                                     sysfs_root=os.path.join(self.root, "sys"),
                                     use_cgroup_v2=v2)
        P.EX.ensure_cgroup_dir("kubepods/besteffort", self.cfg)
        for p in pods:
            P.EX.ensure_cgroup_dir(p.cgroup_dir, self.cfg)
            for c in p.containers.values():
                P.EX.ensure_cgroup_dir(c, self.cfg)
        ex = P.RE.ResourceUpdateExecutor(self.cfg, clock=clock)
        # an empty Auditor is falsy: set it after construction
        ex.auditor = self.ex_auditor = P.AUD.Auditor(clock=clock)
        self.evicted = []

        def record(victims, reason):
            self.evicted.append((reason, [v.uid for v in victims]))
            return [v.uid for v in victims]

        self.ctx = P.Q.QoSContext(
            metric_cache=P.MC.MetricCache(),
            executor=ex,
            pod_provider=StaticPods(pods),
            system_config=self.cfg,
            node_slo=slo or P.SLO.NodeSLOSpec(
                resource_used_threshold_with_be=(
                    P.SLO.ResourceThresholdStrategy(enable=True))),
            node_capacity_mcpu=cap_mcpu,
            node_capacity_mem_mib=cap_mem,
            cpu_infos=topo_2numa_8cpu(P),
            evict=record if evict else None,
            auditor=P.AUD.Auditor(clock=clock),
        )

    @property
    def K(self):
        return self.P.MC.MetricKind

    def append(self, kind, labels, t, value):
        self.ctx.metric_cache.append(getattr(self.K, kind), labels, t, value)

    def read(self, res, d):
        return getattr(self.P.CG, res).read(d, self.cfg)

    def write(self, res, d, value):
        getattr(self.P.CG, res).write(d, value, self.cfg)

    def events(self):
        return [(e.timestamp, e.group, e.subject.replace(self.root, "<root>"),
                 e.operation, e.detail.replace(self.root, "<root>"))
                for a in (self.ex_auditor, self.ctx.auditor)
                for e in a.query()]

    def seen(self, **extra):
        return dict(files=tree(self.root), events=self.events(),
                    evicted=self.evicted, **extra)


def threshold_slo(P, **kw):
    return P.SLO.NodeSLOSpec(resource_used_threshold_with_be=(
        P.SLO.ResourceThresholdStrategy(enable=True, **kw)))


# -- the pure functions ----------------------------------------------------------


def budget_formula(P):
    got = P.CS.calculate_be_suppress_mcpu(
        capacity_mcpu=8000, threshold_percent=65, node_used_mcpu=3000.0,
        pod_used_mcpu={"ls": 2000.0, "be": 500.0}, non_be_uids={"ls"},
        reserved_mcpu=0)
    assert got == 5200 - 2000 - 500
    return got


def budget_reserved_wins(P):
    got = P.CS.calculate_be_suppress_mcpu(8000, 65, 2000.0, {"ls": 2000.0},
                                          {"ls"}, reserved_mcpu=700)
    assert got == 5200 - 2000 - 700
    return got


def budget_negative(P):
    # 5200 - 7000 - 1500.5 = -3300.5: int() truncates toward zero
    got = P.CS.calculate_be_suppress_mcpu(
        8000, 65, 9000.5, {"ls": 7000.0, "be": 500.0}, {"ls"}, 0)
    assert got == -3300
    return got


def cpus_ht_pairs_scattered(P):
    cpus = P.CS.select_suppress_cpus(4, topo_2numa_8cpu(P), old_count=0)
    numa0, numa1 = [c for c in cpus if c < 4], [c for c in cpus if c >= 4]
    assert len(numa0) == 2 and len(numa1) == 2 and numa0[1] == numa0[0] + 1
    return cpus


def cpus_minimum_two(P):
    cpus = P.CS.select_suppress_cpus(0, topo_2numa_8cpu(P), 0)
    assert len(cpus) == 2
    return [cpus, P.CS.select_suppress_cpus(-3, topo_2numa_8cpu(P), 0)]


def cpus_growth_limited(P):
    cpus = P.CS.select_suppress_cpus(8, topo_2numa_8cpu(P), old_count=2)
    assert len(cpus) == 3
    return cpus


def cpus_capped(P):
    cpus = P.CS.select_suppress_cpus(64, topo_2numa_8cpu(P), 0)
    assert len(cpus) == 8
    odd = [P.Q.CPUInfo(cpu_id=c, core_id=c // 2 if c < 4 else c,
                       socket_id=c // 3, node_id=c % 2) for c in range(7)]
    return [cpus] + [P.CS.select_suppress_cpus(w, odd, o)
                     for w in range(-1, 9) for o in (0, 2, 5)]


PURE = [budget_formula, budget_reserved_wins, budget_negative,
        cpus_ht_pairs_scattered, cpus_minimum_two, cpus_growth_limited,
        cpus_capped]


@pytest.mark.parametrize("case", PURE, ids=[c.__name__ for c in PURE])
def test_pure_function_equals_reference(case):
    assert case(PORT) == case(REF)


# -- cpu suppress ------------------------------------------------------------------


def suppress_pods(P):
    return [pod(P, "ls", "kubepods/burstable/ls", "LS"),
            pod(P, "be", "kubepods/besteffort/be", "BE",
                containers={"c": "kubepods/besteffort/be/c"})]


def prime_suppress(n, node_mcpu, be_mcpu, ls_mcpu):
    n.append("NODE_CPU_USAGE", None, 100.0, node_mcpu)
    n.append("POD_CPU_USAGE", {"pod": "ls"}, 100.0, ls_mcpu)
    n.append("POD_CPU_USAGE", {"pod": "be"}, 100.0, be_mcpu)


def quota_of(raw):
    return int(raw.split()[0])


def suppress_cpuset(P, root, v2):
    n = Node(P, root, suppress_pods(P), v2)
    prime_suppress(n, 3000, 500, 2000)
    P.CS.CPUSuppress().execute(n.ctx, now=100.0)
    # budget 2.7 cpus -> ceil -> 3 (cpu_suppress.go:388 rounds up)
    assert n.read("CPU_SET", "kubepods/besteffort") == "0,1,2"
    assert n.read("CPU_SET", "kubepods/besteffort/be/c") == "0,1,2"
    return n.seen()


def suppress_cfs_quota(P, root, v2):
    n = Node(P, root, suppress_pods(P), v2,
             slo=threshold_slo(P, cpu_suppress_policy="cfsQuota"))
    n.write("CPU_CFS_QUOTA", "kubepods/besteffort", "-1")
    prime_suppress(n, 3000, 500, 2000)
    P.CS.CPUSuppress().execute(n.ctx, now=100.0)
    got = quota_of(n.read("CPU_CFS_QUOTA", "kubepods/besteffort"))
    assert got == 2700 * 100000 // 1000
    return n.seen()


def suppress_disabled_recovers(P, root, v2):
    n = Node(P, root, suppress_pods(P), v2)
    prime_suppress(n, 3000, 500, 2000)
    s = P.CS.CPUSuppress()
    s.execute(n.ctx, now=100.0)
    assert n.read("CPU_SET", "kubepods/besteffort") == "0,1,2"
    n.ctx.node_slo.resource_used_threshold_with_be.enable = False
    n.now[0] = 1.0
    s.execute(n.ctx, now=101.0)
    assert n.read("CPU_SET", "kubepods/besteffort") == "0,1,2,3,4,5,6,7"
    return n.seen(policy=dict(s._suppressed_policy))


def suppress_kernel_range_cpuset(P, root, v2):
    n = Node(P, root, suppress_pods(P), v2)
    n.write("CPU_SET", "kubepods/besteffort", "0-7")
    prime_suppress(n, 3000, 500, 2000)
    P.CS.CPUSuppress().execute(n.ctx, now=100.0)
    assert n.read("CPU_SET", "kubepods/besteffort") == "0,1,2"
    return n.seen()


def suppress_quota_small_delta_bypassed(P, root, v2):
    n = Node(P, root, suppress_pods(P), v2,
             slo=threshold_slo(P, cpu_suppress_policy="cfsQuota"))
    prime_suppress(n, 3000, 500, 2000)
    s = P.CS.CPUSuppress()
    s.execute(n.ctx, now=100.0)
    first = n.read("CPU_CFS_QUOTA", "kubepods/besteffort")
    n.append("POD_CPU_USAGE", {"pod": "ls"}, 101.0, 2010.0)
    n.now[0] = 1.0
    s.execute(n.ctx, now=101.0)
    assert n.read("CPU_CFS_QUOTA", "kubepods/besteffort") == first
    return n.seen()


def suppress_negative_budget(P, root, v2):
    """A budget below zero: the cpuset policy still grants 2 cpus, the
    cfs quota policy floors at BE_MIN_QUOTA_US."""
    seen = []
    for policy in ("cpuset", "cfsQuota"):
        n = Node(P, os.path.join(root, policy), suppress_pods(P), v2,
                 slo=threshold_slo(P, cpu_suppress_policy=policy))
        n.write("CPU_CFS_QUOTA", "kubepods/besteffort", "400000")
        prime_suppress(n, 9000.5, 500, 7000)
        P.CS.CPUSuppress().execute(n.ctx, now=100.0)
        if policy == "cpuset":
            assert n.read("CPU_SET", "kubepods/besteffort") == "0,1"
        else:
            assert quota_of(n.read("CPU_CFS_QUOTA",
                                   "kubepods/besteffort")) == 2000
        seen.append(n.seen())
    return seen


# -- the evictors --------------------------------------------------------------


def recording(n):
    return [u for _, uids in n.evicted for u in uids]


def memory_largest_lowest_priority(P, root, v2):
    pods = [pod(P, "be1", "kubepods/besteffort/be1", "BE", name="be1",
                priority=5500),
            pod(P, "be2", "kubepods/besteffort/be2", "BE", name="be2",
                priority=5000),
            pod(P, "be3", "kubepods/besteffort/be3", "BE", name="be3",
                priority=5000)]
    n = Node(P, root, pods, v2, evict=True)
    n.append("NODE_MEMORY_USAGE", None, 100.0, 0.80 * 16384)
    for uid, mib in (("be1", 512.0), ("be2", 1024.0), ("be3", 2048.0)):
        n.append("POD_MEMORY_USAGE", {"pod": uid}, 100.0, mib)
    P.EV.MemoryEvictor().execute(n.ctx, now=100.0)
    assert recording(n) == ["be3"]
    return n.seen()


def memory_below_threshold(P, root, v2):
    n = Node(P, root, [pod(P, "be1", "kubepods/besteffort/be1", "BE")], v2,
             evict=True)
    n.append("NODE_MEMORY_USAGE", None, 100.0, 0.5 * 16384)
    P.EV.MemoryEvictor().execute(n.ctx, now=100.0)
    assert n.evicted == []
    return n.seen()


def memory_cooldown(P, root, v2):
    n = Node(P, root, [pod(P, "be1", "kubepods/besteffort/be1", "BE")], v2,
             evict=True)
    n.append("NODE_MEMORY_USAGE", None, 100.0, 0.9 * 16384)
    m = P.EV.MemoryEvictor()
    m.execute(n.ctx, now=100.0)
    n.append("NODE_MEMORY_USAGE", None, 130.0, 0.9 * 16384)
    m.execute(n.ctx, now=130.0)
    assert len(n.evicted) == 1
    return n.seen(last=m._last_evict)


def memory_tie_prefix_names(P, root, v2):
    """Equal priorities and no metrics: the order is by the name's
    negated code points, in which a name sorts before its extensions
    ("b", "be", "bea"), not in plain reverse order."""
    names = ["bea", "b", "be", "c", "ab", "a"]
    pods = [pod(P, f"u-{x}", f"kubepods/besteffort/{x}", "BE", name=x,
                priority=5000) for x in names]
    pods.append(pod(P, "u-m", "kubepods/besteffort/m", "BE", name="m",
                    priority=5000))
    n = Node(P, root, pods, v2, evict=True)
    n.append("NODE_MEMORY_USAGE", None, 100.0, 0.95 * 16384)
    n.append("POD_MEMORY_USAGE", {"pod": "u-m"}, 100.0, 256.0)
    P.EV.MemoryEvictor().execute(n.ctx, now=100.0)
    # the pod with a metric first; then the metric-less by name
    assert recording(n) == ["u-m", "u-c", "u-b", "u-be", "u-bea", "u-a",
                            "u-ab"]
    assert recording(n) != ["u-m"] + [f"u-{x}" for x in sorted(
        names, reverse=True)]
    return n.seen()


def cpu_evict_slo(P):
    return threshold_slo(P, cpu_evict_be_satisfaction_lower_percent=60,
                         cpu_evict_be_satisfaction_upper_percent=80)


def cpu_starved(P, root, v2):
    pods = [pod(P, "be1", "kubepods/besteffort/be1", "BE", priority=5000,
                cpu_request_mcpu=2000),
            pod(P, "be2", "kubepods/besteffort/be2", "BE", priority=5500,
                cpu_request_mcpu=2000)]
    n = Node(P, root, pods, v2, slo=cpu_evict_slo(P), evict=True)
    n.write("CPU_CFS_QUOTA", "kubepods/besteffort", "200000")
    n.append("BE_CPU_USAGE", None, 100.0, 1900.0)
    n.append("POD_CPU_USAGE", {"pod": "be1"}, 100.0, 900.0)
    n.append("POD_CPU_USAGE", {"pod": "be2"}, 100.0, 1000.0)
    P.EV.CPUEvictor().execute(n.ctx, now=100.0)
    assert recording(n) == ["be1"]
    return n.seen()


def cpu_not_starved(P, root, v2):
    n = Node(P, root, [pod(P, "be1", "kubepods/besteffort/be1", "BE",
                           cpu_request_mcpu=2000)], v2,
             slo=cpu_evict_slo(P), evict=True)
    n.write("CPU_CFS_QUOTA", "kubepods/besteffort", "200000")
    n.append("BE_CPU_USAGE", None, 100.0, 500.0)
    P.EV.CPUEvictor().execute(n.ctx, now=100.0)
    assert n.evicted == []
    return n.seen()


def cpu_evict_by_allocatable(P, root, v2):
    pods = [pod(P, "be1", "kubepods/besteffort/be1", "BE", priority=5000,
                cpu_request_mcpu=2000),
            pod(P, "be2", "kubepods/besteffort/be2", "BE", priority=5500,
                cpu_request_mcpu=2000)]
    slo = cpu_evict_slo(P)
    slo.resource_used_threshold_with_be.cpu_evict_policy = (
        "evictByAllocatable")
    n = Node(P, os.path.join(root, "alloc"), pods, v2, slo=slo, evict=True)
    n.write("CPU_CFS_QUOTA", "kubepods/besteffort", "400000")
    n.ctx = dataclasses.replace(n.ctx, be_allocatable_fn=lambda: 2000)
    n.append("BE_CPU_USAGE", None, 100.0, 1900.0)
    P.EV.CPUEvictor().execute(n.ctx, now=100.0)
    assert recording(n) == ["be1"]
    # the default (real-limit) policy does not evict here
    m = Node(P, os.path.join(root, "real"), pods, v2, slo=cpu_evict_slo(P),
             evict=True)
    m.write("CPU_CFS_QUOTA", "kubepods/besteffort", "400000")
    m.append("BE_CPU_USAGE", None, 100.0, 1900.0)
    P.EV.CPUEvictor().execute(m.ctx, now=100.0)
    assert m.evicted == []
    return [n.seen(), m.seen()]


def cpu_window_averages_spike(P, root, v2):
    slo = cpu_evict_slo(P)
    slo.resource_used_threshold_with_be.cpu_evict_time_window_seconds = 300
    n = Node(P, root, [pod(P, "be1", "kubepods/besteffort/be1", "BE",
                           priority=5000, cpu_request_mcpu=4000)], v2,
             slo=slo, evict=True)
    n.write("CPU_CFS_QUOTA", "kubepods/besteffort", "200000")
    n.append("BE_CPU_USAGE", None, -150.0, 1900.0)
    for t in range(-140, 101, 20):
        n.append("BE_CPU_USAGE", None, float(t), 100.0)
    P.EV.CPUEvictor().execute(n.ctx, now=100.0)
    assert n.evicted == []
    return n.seen()


# -- cpu burst -------------------------------------------------------------------


def burst_slo(P):
    slo = P.SLO.NodeSLOSpec()
    slo.cpu_burst_strategy.policy = "auto"
    return slo


def burst_applied_to_ls(P, root, v2):
    pods = [pod(P, "ls", "kubepods/burstable/ls", "LS", cpu_limit_mcpu=2000,
                containers={"c": "kubepods/burstable/ls/c"}),
            pod(P, "be", "kubepods/besteffort/be", "BE", cpu_limit_mcpu=2000)]
    n = Node(P, root, pods, v2, slo=burst_slo(P))
    P.CB.CPUBurst().execute(n.ctx, now=100.0)
    for d in ("kubepods/burstable/ls", "kubepods/burstable/ls/c"):
        assert n.read("CPU_BURST", d) == "2000000"
    with pytest.raises(OSError):
        n.read("CPU_BURST", "kubepods/besteffort/be")
    return n.seen()


def burst_degrades_when_hot(P, root, v2):
    n = Node(P, root, [pod(P, "ls", "kubepods/burstable/ls", "LS",
                           cpu_limit_mcpu=2000)], v2, slo=burst_slo(P))
    n.append("NODE_CPU_USAGE", None, 100.0, 4800.0)
    P.CB.CPUBurst().execute(n.ctx, now=100.0)
    assert n.read("CPU_BURST", "kubepods/burstable/ls") == "0"
    return n.seen()


def quota_node(P, root, v2, quota_us=200000):
    """The quota-burst half's node: one LS pod (limit 2 cpus, one
    container) with its quota written, an idle share pool."""
    p = pod(P, "ls", "kubepods/burstable/ls", "LS", cpu_limit_mcpu=2000,
            containers={"c": "kubepods/burstable/ls/c"},
            container_limits_mcpu={"c": 2000})
    n = Node(P, root, [p], v2, slo=burst_slo(P))
    for d in ("kubepods/burstable/ls", "kubepods/burstable/ls/c"):
        n.write("CPU_CFS_QUOTA", d, str(quota_us))
    n.append("NODE_CPU_USAGE", None, 100.0, 1000.0)
    return n


def burst_seen(n, burst):
    return n.seen(limiters={u: (lim.capacity, lim.token, lim.last)
                            for u, lim in burst._limiters.items()},
                  dirty=burst._dirty)


def v1_quota(n, d, want, v2):
    if not v2:
        assert n.read("CPU_CFS_QUOTA", d) == want


def quota_throttled_scales_up(P, root, v2):
    n = quota_node(P, root, v2)
    n.append("POD_CPU_THROTTLED_RATIO", {"pod": "ls"}, 100.0, 0.4)
    b = P.CB.CPUBurst()
    b.execute(n.ctx, now=100.0)
    v1_quota(n, "kubepods/burstable/ls", "240000", v2)
    v1_quota(n, "kubepods/burstable/ls/c", "240000", v2)
    return burst_seen(n, b)


def quota_clamped_at_ceil(P, root, v2):
    n = quota_node(P, root, v2, quota_us=590000)
    n.append("POD_CPU_THROTTLED_RATIO", {"pod": "ls"}, 100.0, 0.4)
    b = P.CB.CPUBurst()
    b.execute(n.ctx, now=100.0)
    v1_quota(n, "kubepods/burstable/ls", "600000", v2)
    return burst_seen(n, b)


def quota_unthrottled_remains(P, root, v2):
    n = quota_node(P, root, v2)
    n.append("POD_CPU_THROTTLED_RATIO", {"pod": "ls"}, 100.0, 0.0)
    b = P.CB.CPUBurst()
    b.execute(n.ctx, now=100.0)
    v1_quota(n, "kubepods/burstable/ls", "200000", v2)
    return burst_seen(n, b)


def quota_overloaded_scales_down(P, root, v2):
    n = quota_node(P, root, v2, quota_us=400000)
    n.append("NODE_CPU_USAGE", None, 100.0, 4800.0)
    n.append("POD_CPU_THROTTLED_RATIO", {"pod": "ls"}, 100.0, 0.4)
    b = P.CB.CPUBurst()
    b.execute(n.ctx, now=100.0)
    v1_quota(n, "kubepods/burstable/ls", "320000", v2)
    return burst_seen(n, b)


def quota_exhausted_limiter(P, root, v2):
    n = quota_node(P, root, v2, quota_us=400000)
    n.ctx.node_slo.cpu_burst_strategy.cfs_quota_burst_period_seconds = 10
    n.append("POD_CPU_THROTTLED_RATIO", {"pod": "ls"}, 100.0, 0.4)
    b = P.CB.CPUBurst()
    for t in range(100, 160, 10):
        n.append("POD_CPU_USAGE", {"pod": "ls"}, float(t), 6000.0)
        n.now[0] = float(t)
        b.execute(n.ctx, now=float(t))
    assert b._limiters["ls"].token <= 0
    if not v2:
        assert int(n.read("CPU_CFS_QUOTA", "kubepods/burstable/ls")) < 400000
    return burst_seen(n, b)


def quota_limiter_ticks_while_disabled(P, root, v2):
    n = quota_node(P, root, v2, quota_us=400000)
    n.ctx.node_slo.cpu_burst_strategy.cfs_quota_burst_period_seconds = 10
    b = P.CB.CPUBurst()
    b.execute(n.ctx, now=100.0)
    lim = b._limiters["ls"]
    before = lim.token
    n.ctx.node_slo.cpu_burst_strategy.policy = "cpuBurstOnly"
    n.now[0] = 400.0
    b.execute(n.ctx, now=500.0)
    assert lim.last == 500.0
    n.ctx.node_slo.cpu_burst_strategy.policy = "auto"
    n.append("POD_CPU_USAGE", {"pod": "ls"}, 501.0, 6000.0)
    n.now[0] = 401.0
    b.execute(n.ctx, now=501.0)
    assert lim.token >= before - 250
    return burst_seen(n, b)


def quota_reset_when_disabled(P, root, v2):
    n = quota_node(P, root, v2, quota_us=400000)
    n.ctx.node_slo.cpu_burst_strategy.policy = "cpuBurstOnly"
    b = P.CB.CPUBurst()
    b.execute(n.ctx, now=100.0)
    v1_quota(n, "kubepods/burstable/ls", "200000", v2)
    return burst_seen(n, b)


def quota_policy_none_cleanup(P, root, v2):
    n = quota_node(P, root, v2)
    n.append("POD_CPU_THROTTLED_RATIO", {"pod": "ls"}, 100.0, 0.4)
    b = P.CB.CPUBurst()
    b.execute(n.ctx, now=100.0)
    v1_quota(n, "kubepods/burstable/ls", "240000", v2)
    n.ctx.node_slo.cpu_burst_strategy.policy = "none"
    assert b.enabled(n.ctx)
    n.now[0] = 1.0
    b.execute(n.ctx, now=101.0)
    v1_quota(n, "kubepods/burstable/ls", "200000", v2)
    assert n.read("CPU_BURST", "kubepods/burstable/ls") == "0"
    if not v2:
        assert not b.enabled(n.ctx)
    return burst_seen(n, b)


def quota_normalized_floor(P, root, v2):
    seen = []
    for ratio_case, metric in (("down", ("NODE_CPU_USAGE", None, 4800.0)),
                               ("up", ("POD_CPU_THROTTLED_RATIO",
                                       {"pod": "ls"}, 0.4))):
        n = quota_node(P, os.path.join(root, ratio_case), v2,
                       quota_us=125000)
        n.ctx.cpu_normalization_ratio = 1.6
        n.append(metric[0], metric[1], 100.0, metric[2])
        b = P.CB.CPUBurst()
        b.execute(n.ctx, now=100.0)
        v1_quota(n, "kubepods/burstable/ls",
                 "125000" if ratio_case == "down" else "150000", v2)
        seen.append(burst_seen(n, b))
    return seen


def manager_tick_intervals(P, root, v2):
    runs = []

    class Fake:
        name = "fake"
        interval_seconds = 10.0

        def enabled(self, ctx):
            return True

        def execute(self, ctx, now):
            runs.append(now)

    n = Node(P, root, [], v2)
    mgr = P.Q.QoSManager(n.ctx, [Fake()])
    for t in (0.0, 5.0, 10.0):
        mgr.tick(t)
    assert runs == [0.0, 10.0]
    mgr.run_all(12.0)
    return n.seen(runs=runs, last=dict(mgr._last_run))


def manager_runs_the_strategies(P, root, v2):
    """The manager over the real strategies on one node: suppress, the
    two evictors and burst, ticked on their intervals."""
    pods = suppress_pods(P) + [
        pod(P, "be2", "kubepods/besteffort/be2", "BE", name="be2",
            priority=5000, cpu_request_mcpu=3000),
        pod(P, "ls2", "kubepods/burstable/ls2", "LS", cpu_limit_mcpu=1000,
            containers={"c": "kubepods/burstable/ls2/c"},
            container_limits_mcpu={"c": 1000})]
    slo = cpu_evict_slo(P)
    slo.cpu_burst_strategy.policy = "auto"
    n = Node(P, root, pods, v2, slo=slo, evict=True)
    n.write("CPU_CFS_QUOTA", "kubepods/besteffort", "100000")
    for t in (90.0, 100.0):
        prime_suppress(n, 3000, 500, 2000)
        n.append("NODE_MEMORY_USAGE", None, t, 0.9 * 16384)
        n.append("BE_CPU_USAGE", None, t, 990.0)
        n.append("POD_MEMORY_USAGE", {"pod": "be2"}, t, 900.0)
    strategies = [P.CS.CPUSuppress(), P.EV.CPUEvictor(), P.EV.MemoryEvictor(),
                  P.CB.CPUBurst()]
    mgr = P.Q.QoSManager(n.ctx, strategies)
    for t in (100.0, 100.5, 101.0):
        n.now[0] = t
        mgr.tick(t)
    assert n.evicted
    return n.seen(last=dict(mgr._last_run))


TREE = [suppress_cpuset, suppress_cfs_quota, suppress_disabled_recovers,
        suppress_kernel_range_cpuset, suppress_quota_small_delta_bypassed,
        suppress_negative_budget, memory_largest_lowest_priority,
        memory_below_threshold, memory_cooldown, memory_tie_prefix_names,
        cpu_starved, cpu_not_starved, cpu_evict_by_allocatable,
        cpu_window_averages_spike, burst_applied_to_ls,
        burst_degrades_when_hot, quota_throttled_scales_up,
        quota_clamped_at_ceil, quota_unthrottled_remains,
        quota_overloaded_scales_down, quota_exhausted_limiter,
        quota_limiter_ticks_while_disabled, quota_reset_when_disabled,
        quota_policy_none_cleanup, quota_normalized_floor,
        manager_tick_intervals, manager_runs_the_strategies]


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("case", TREE, ids=[c.__name__ for c in TREE])
def test_strategy_equals_reference(case, v2, tmp_path):
    ref = plain(case(REF, str(tmp_path / "ref"), v2))
    port = plain(case(PORT, str(tmp_path / "port"), v2))
    assert port == ref


def test_cpu_burst_quota_floor_helper():
    """The port's copy of the runtime hooks' MilliCPUToQuota (the
    quota-burst base) equals the reference's."""
    from koordinator_tpu.koordlet.runtimehooks.protocol import (
        milli_cpu_to_quota,
    )

    for milli in (-5, 0, 1, 5, 9, 10, 11, 999, 1000, 2000, 123457):
        assert PORT.CB.milli_cpu_to_quota(milli) == milli_cpu_to_quota(milli)
