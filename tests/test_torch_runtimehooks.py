"""The port's runtime hooks (``koordlet/runtimehooks``: the protocol, the
registry, the bvt, cpuset, device, batch-resource, cpu-normalization and
terway plugins, the reconciler, the server and ``RuntimeHooks``) against
the JAX package's. The cases are those of ``tests/test_runtimehooks.py``
and ``tests/test_hooks_actuation.py`` (less the CRI proxy's case, in
``tests/test_torch_runtimeproxy.py``), plus the malformed annotations of the cpuset and
device hooks and the float64 edges of the cfs quota scaling. Each case
runs through both packages, each on its own fake cgroup tree under
``tmp_path`` (v1 and v2 where a tree is written); it asserts the
reference's expectations and returns what it observed: the responses,
the tree's files, the executor's writes in order and the audit events.
The two must be equal."""

import dataclasses
import enum
import importlib
import json
import math
import os

import numpy as np
import pytest


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.AUD = mod("koordlet.audit")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.RE = mod("koordlet.resourceexecutor")
        self.EX = mod("koordlet.resourceexecutor.executor")
        self.RH = mod("koordlet.runtimehooks")
        self.PR = mod("koordlet.runtimehooks.protocol")
        self.CS = mod("koordlet.runtimehooks.cpuset")
        self.DV = mod("koordlet.runtimehooks.devices")
        self.CN = mod("koordlet.runtimehooks.cpunormalization")
        self.TW = mod("koordlet.runtimehooks.terwayqos")
        self.SI = mod("koordlet.statesinformer")
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
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if isinstance(x, BaseException):
        return f"{type(x).__name__}: {x}"
    return x


def tree(root):
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def events(auditor, root):
    """The audit log oldest first, paths relative to ``root``, without the
    wall-clock timestamps."""
    return [(e.group, os.path.relpath(e.subject, root)
             if e.subject.startswith(root) else e.subject, e.operation,
             e.detail.replace(root, "<root>"))
            for e in reversed(auditor.query())]


def pin_annotation(P, cpus, numa_resources=None):
    status = {"cpuset": list(cpus)}
    if numa_resources:
        status["numaNodeResources"] = numa_resources
    return {P.X.ANNOTATION_RESOURCE_STATUS: json.dumps(status)}


def lsr_pod(P):
    return P.FW.PodMeta("lsr-pod", "kubepods/podlsr", P.X.QoSClass.LSR,
                        containers={"main": "kubepods/podlsr/main"},
                        annotations=pin_annotation(P, [0, 1, 4, 5]))


def be_pod(P):
    return P.FW.PodMeta(
        "be-pod", "kubepods/besteffort/podbe", P.X.QoSClass.BE,
        containers={"work": "kubepods/besteffort/podbe/work"},
        batch_resources={"work": P.FW.ContainerBatchResources(
            request_mcpu=1000, limit_mcpu=2000,
            memory_limit_bytes=512 * 1024 * 1024)})


def ls_pod(P, **kw):
    return P.FW.PodMeta("ls-pod", "kubepods/burstable/podls",
                        P.X.QoSClass.LS,
                        containers={"main": "kubepods/burstable/podls/main"},
                        **kw)


class Fs:
    """One package's fake cgroup tree under ``root`` (v1 or v2) with the
    kube-QoS dirs and the pods' dirs, and an executor over it."""

    def __init__(self, P, root, pods=(), v2=False):
        self.root = str(root)
        self.cfg = P.CG.SystemConfig(
            cgroup_root=os.path.join(self.root, "cg"),
            proc_root=os.path.join(self.root, "proc"),
            terway_qos_root=os.path.join(self.root, "terway"),
            use_cgroup_v2=v2)
        for d in ("kubepods", "kubepods/burstable", "kubepods/besteffort"):
            P.EX.ensure_cgroup_dir(d, self.cfg)
        for p in pods:
            P.EX.ensure_cgroup_dir(p.cgroup_dir, self.cfg)
            for c in p.containers.values():
                P.EX.ensure_cgroup_dir(c, self.cfg)
        self.ex = P.RE.ResourceUpdateExecutor(self.cfg,
                                              auditor=P.AUD.Auditor())

    def seen(self):
        return dict(tree=tree(self.root),
                    writes=events(self.ex.auditor, self.root))


def enabled_slo(P):
    slo = P.SLO.NodeSLOSpec()
    for tier in ("lsr", "ls", "be"):
        getattr(slo.resource_qos_strategy, tier).enable = True
    return slo


# -- the registry, the protocol and the bvt rule --------------------------------


def registry(P, root):
    """``TestRegistry``: order, duplicates, the failure policies (errors
    collected under IGNORE), the stages with hooks."""
    S = P.RH.Stage
    reg = P.RH.HookRegistry()
    calls = []
    reg.register(S.PRE_RUN_POD_SANDBOX, "a", "", lambda p: calls.append("a"))
    reg.register(S.PRE_RUN_POD_SANDBOX, "b", "", lambda p: calls.append("b"))
    reg.run_hooks(S.PRE_RUN_POD_SANDBOX, P.RH.PodContext.from_meta(ls_pod(P)))
    assert calls == ["a", "b"]
    with pytest.raises(ValueError) as dup:
        reg.register(S.PRE_RUN_POD_SANDBOX, "a", "", lambda p: None)

    def boom(p):
        raise RuntimeError("x")

    reg.register(S.PRE_CREATE_CONTAINER, "boom", "", boom)
    reg.register(S.PRE_CREATE_CONTAINER, "after", "",
                 lambda p: calls.append("after"))
    errs = []
    ctx = P.PR.ContainerContext.from_meta(ls_pod(P), "main")
    reg.run_hooks(S.PRE_CREATE_CONTAINER, ctx, P.RH.FailurePolicy.IGNORE,
                  errors=errs)
    reg.run_hooks(S.PRE_CREATE_CONTAINER, ctx)  # IGNORE with no list
    assert calls[-2:] == ["after", "after"] and len(errs) == 1
    with pytest.raises(RuntimeError):
        reg.run_hooks(S.PRE_CREATE_CONTAINER, ctx, P.RH.FailurePolicy.FAIL)
    return [calls, str(dup.value), errs, reg.stages_with_hooks(),
            [h.name for h in reg.hooks_by_stage(S.PRE_CREATE_CONTAINER)],
            [s.value for s in S], [f.value for f in P.RH.FailurePolicy]]


def conversions(P, root):
    """``milli_cpu_to_shares`` / ``milli_cpu_to_quota`` over seeded and
    edge values, and the kube-QoS dirs."""
    rng = np.random.default_rng(5)
    millis = [-1000, -1, 0, 1, 2, 5, 9, 10, 11, 999, 1000, 1001, 2000,
              256000, 262144000, 262145000] + [
        int(m) for m in rng.integers(0, 300000, 64)]
    shares = [P.RH.milli_cpu_to_shares(m) for m in millis]
    quotas = [P.RH.milli_cpu_to_quota(m) for m in millis]
    assert P.RH.milli_cpu_to_shares(0) == 2
    assert P.RH.milli_cpu_to_shares(1000) == 1024
    assert P.RH.milli_cpu_to_quota(-1) == -1
    assert P.RH.milli_cpu_to_quota(2000) == 200000
    assert P.RH.milli_cpu_to_quota(5) == 1000
    return [millis, shares, quotas, P.RH.KUBE_QOS_DIR,
            [P.RH.kube_qos_by_cgroup_parent(d) for d in (
                "kubepods", "kubepods/burstable/x", "kubepods/besteffort/y",
                "kubepods/podz")]]


def _bvt_slos(P):
    lsr_only = P.SLO.NodeSLOSpec()
    lsr_only.resource_qos_strategy.lsr.enable = True
    be_only = P.SLO.NodeSLOSpec()
    be_only.resource_qos_strategy.be.enable = True
    custom = enabled_slo(P)
    custom.resource_qos_strategy.ls.cpu.group_identity = 1
    custom.resource_qos_strategy.lsr.cpu.core_expeller = True
    return [P.SLO.NodeSLOSpec(), enabled_slo(P), lsr_only, be_only, custom]


def bvt_rules(P, root):
    """``TestBvtRule``: the rule of the default, enabled, lsr-only, be-only
    and a custom NodeSLO; every pod and dir value."""
    KQ, Q = P.RH.KubeQOS, P.X.QoSClass
    out = []
    for slo in _bvt_slos(P):
        rule = P.RH.parse_rule(slo)
        out.append([rule, [[rule.pod_bvt(q, kq) for kq in KQ] for q in Q],
                    [rule.kube_qos_dir_bvt(kq) for kq in KQ]])
    default, enabled = (P.RH.parse_rule(s) for s in _bvt_slos(P)[:2])
    assert not default.enable
    assert default.pod_bvt(Q.LS, KQ.BURSTABLE) == 0
    assert enabled.pod_bvt(Q.LSR, KQ.GUARANTEED) == 2
    assert enabled.pod_bvt(Q.BE, KQ.BESTEFFORT) == -1
    assert enabled.pod_bvt(Q.NONE, KQ.GUARANTEED) == 2
    assert enabled.kube_qos_dir_bvt(KQ.GUARANTEED) == 0
    return out


def bvt_rule_update(P, root, v2):
    """``test_rule_update_writes_dirs_and_pods``, then the rule switched
    off: the leveled writes of both updates."""
    pods = [ls_pod(P), be_pod(P)]
    fs = Fs(P, root, pods, v2)
    plugin = P.RH.BvtPlugin()
    assert plugin.update_rule(enabled_slo(P))
    assert not plugin.update_rule(enabled_slo(P))
    written = plugin.rule_update(pods, fs.ex)
    assert written > 0
    BVT = P.CG.CPU_BVT_WARP_NS
    if not v2:
        assert BVT.read("kubepods/burstable", fs.cfg) == "2"
        assert BVT.read("kubepods/besteffort", fs.cfg) == "-1"
        assert BVT.read("kubepods", fs.cfg) == "0"
        assert BVT.read("kubepods/besteffort/podbe/work", fs.cfg) == "-1"
    plugin.update_rule(P.SLO.NodeSLOSpec())
    off = plugin.rule_update(pods, fs.ex)
    ctx = P.RH.PodContext.from_meta(ls_pod(P))
    plugin.set_pod_bvt(ctx)
    return [written, off, ctx.response, fs.seen()]


# -- the cpuset and device hooks ------------------------------------------------


def _topo(P, **kw):
    return P.RH.NodeTopoInfo(share_pools={0: "2-3", 1: "6-7"},
                             be_share_pools={0: "3", 1: "7"}, **kw)


def cpuset_plugin(P, root):
    """``TestCpusetPlugin``: the annotation pin wins (quota unset), LS
    takes every share pool, NUMA-aware pods their nodes' pools, BE
    containers are cleared, the kubelet's static policy is left alone, a
    pinned pod's pod-level quota is unset; plus a SYSTEM pod's cpuset."""
    Q, CC = P.X.QoSClass, P.PR.ContainerContext
    R = P.X.ResourceName
    p = P.RH.CpusetPlugin()
    assert p.update_rule(_topo(P, system_qos_cpuset="0"))
    assert not p.update_rule(_topo(P, system_qos_cpuset="0"))
    numa = P.FW.PodMeta(
        "ls-numa", "kubepods/burstable/podn", Q.LS,
        containers={"main": "kubepods/burstable/podn/main"},
        annotations={P.X.ANNOTATION_RESOURCE_STATUS: json.dumps({
            "numaNodeResources": [{"node": 1, "resources": {
                str(int(R.CPU)): 2000}}]})})
    be_numa = P.FW.PodMeta(
        "be-numa", "kubepods/besteffort/podbn", Q.BE,
        containers={"main": "kubepods/besteffort/podbn/main"},
        annotations={P.X.ANNOTATION_RESOURCE_STATUS: json.dumps({
            "numaNodeResources": [{"node": 0, "resources": {
                int(R.BATCH_CPU): 2000}}]})})
    system = P.FW.PodMeta("sys", "kubepods/podsys", Q.SYSTEM,
                          containers={"main": "kubepods/podsys/main"})
    guaranteed = P.FW.PodMeta("g", "kubepods/podg", Q.NONE,
                              containers={"main": "kubepods/podg/main"})
    out = []
    for pod, name in ((lsr_pod(P), "main"), (ls_pod(P), "main"),
                      (numa, "main"), (be_numa, "main"), (system, "main"),
                      (be_pod(P), "work"), (guaranteed, "main")):
        ctx = CC.from_meta(pod, name)
        p.set_container_cpuset(ctx)
        out.append([ctx.response, len(ctx.updaters())])
    assert out[0][0].cpuset == "0,1,4,5" and out[0][0].cfs_quota_us == -1
    assert out[1][0].cpuset == "2-3,6-7" and out[1][0].cfs_quota_us is None
    assert out[2][0].cpuset == "6-7"
    assert out[5][0].cpuset == "" and out[5][1] == 0
    static = P.RH.CpusetPlugin()
    static.update_rule(_topo(P, kubelet_policy="static"))
    ctx = CC.from_meta(guaranteed, "main")
    static.set_container_cpuset(ctx)
    assert ctx.response.cpuset is None
    pod_ctx = P.RH.PodContext.from_meta(lsr_pod(P))
    P.RH.CpusetPlugin().unset_pod_cpu_quota(pod_ctx)
    assert pod_ctx.response.cfs_quota_us == -1
    unarmed = CC.from_meta(ls_pod(P), "main")
    P.RH.CpusetPlugin().set_container_cpuset(unarmed)
    return [out, ctx.response, pod_ctx.response, unarmed.response,
            p.rule, p.rule.all_share_pools()]


#: resource-status annotations the cpuset hook must parse or skip
#: without raising, and the strings it is given
STATUS_CASES = [
    None, "", "not json", "[1, 2]", "42", "{}", '{"cpuset": ""}',
    '{"cpuset": []}', '{"cpuset": "3-5"}', '{"cpuset": [7, 3]}',
    '{"cpuset": ["2", 4.0]}', '{"numaNodeResources": null}',
    '{"numaNodeResources": [{"node": 1}]}',
    '{"numaNodeResources": [{"node": 0, "resources": {"0": 0}}]}',
    '{"numaNodeResources": [{"node": 1, "resources": {"1": 4096}}]}',
    '{"numaNodeResources": [{"node": 1, "resources": {"2": 500}}, '
    '{"resources": {"0": 1000}}]}',
    '{"numaNodeResources": [{"node": 5, "resources": {"0": 1000}}]}',
]


def cpuset_annotations(P, root):
    """The cpuset hook over well-formed and malformed resource-status
    annotations, for an LS and a BE pod."""
    p = P.RH.CpusetPlugin()
    p.update_rule(_topo(P))
    out = []
    for raw in STATUS_CASES:
        ann = {} if raw is None else {P.X.ANNOTATION_RESOURCE_STATUS: raw}
        status = P.CS.parse_resource_status(ann)
        row = [status, P.CS.cpuset_from_status(status),
               P.CS.numa_nodes_from_status(status)]
        for qos, d in ((P.X.QoSClass.LS, "kubepods/burstable/podx"),
                       (P.X.QoSClass.BE, "kubepods/besteffort/podx")):
            pod = P.FW.PodMeta("x", d, qos, containers={"c": f"{d}/c"},
                               annotations=ann)
            ctx = P.PR.ContainerContext.from_meta(pod, "c")
            p.set_container_cpuset(ctx)
            pod_ctx = P.RH.PodContext.from_meta(pod)
            p.unset_pod_cpu_quota(pod_ctx)
            row += [ctx.response, pod_ctx.response]
        out.append(row)
    return out


def device_annotations(P, gpu_minors=(0, 2), rdma_vfs=("0000:81:00.2",)):
    return {P.X.ANNOTATION_DEVICE_ALLOCATED: json.dumps({
        "gpu": [{"minor": m, "resources": {}} for m in gpu_minors],
        "rdma": [{"minor": 0, "resources": {}, "vfs": list(rdma_vfs)}]})}


#: device-allocated annotations the device hook must parse or skip
DEVICE_CASES = [
    None, "", "not json", "[]", '{"gpu": "x"}', '{"gpu": []}',
    '{"gpu": [{"minor": 0}, "not-a-dict", {"minor": "x"}], "rdma": '
    '["nope", {"minor": 0, "vfs": ["0000:81:00.2"]}]}',
    '{"gpu": [{"minor": 3}, {"minor": "5"}, {}], "rdma": [{"vfs": "a"}, '
    '{"vfs": [1, "b", null, 2.5]}]}',
    '{"fpga": [{"minor": 1}]}',
]


def device_env(P, root):
    """``TestDeviceEnvInject`` (less the CRI proxy): an allocated pod gets
    its minors in both env names and its VFs, a pod without one gets no
    env, malformed entries are skipped; the server with ``apply`` writes
    nothing for an env."""
    registry = P.RH.HookRegistry()
    P.RH.DeviceEnvPlugin().register(registry)
    fs = Fs(P, root)
    server = P.RH.RuntimeHookServer(registry, fs.ex)
    out = []
    pods = [P.FW.PodMeta("p1", "kubepods/podp1", P.X.QoSClass.LSR,
                         containers={"main": "kubepods/podp1/main"},
                         annotations=device_annotations(P))]
    for k, raw in enumerate(DEVICE_CASES):
        ann = {} if raw is None else {P.X.ANNOTATION_DEVICE_ALLOCATED: raw}
        pods.append(P.FW.PodMeta(f"d{k}", f"kubepods/podd{k}",
                                 P.X.QoSClass.LS,
                                 containers={"main": f"kubepods/podd{k}/main"},
                                 annotations=ann))
    for pod in pods:
        out.append([P.DV.parse_device_allocations(pod.annotations),
                    server.create_container(pod, "main", apply=False),
                    server.create_container(pod, "main", apply=True)])
    first = out[0][1].add_envs
    assert first["TPU_VISIBLE_CHIPS"] == first["NVIDIA_VISIBLE_DEVICES"] == "0,2"
    assert first["KOORDINATOR_RDMA_VFS"] == "0000:81:00.2"
    assert out[1][1].add_envs is None
    return [out, fs.seen()]


def device_scheduler_to_env(P, root):
    """``test_device_pod_scheduler_to_env_e2e``: a GPU pod placed by the
    scheduler on the CPU, its PreBind annotation turned into a PodMeta
    and the env of its allocated minor."""
    from numpy.random import default_rng

    R = P.X.ResourceName
    DC = importlib.import_module(f"{P.root}.device.cache")
    S = importlib.import_module(f"{P.root}.scheduler.scheduler")
    PM = importlib.import_module(f"{P.root}.models.placement")
    sched = (S.Scheduler(model=PM.PlacementModel(device="cpu"))
             if P is PORT else S.Scheduler())
    sched.add_node(P.T.NodeSpec(name="n0", allocatable={
        R.CPU: 16000, R.MEMORY: 32768}))
    sched.update_node_metric(P.T.NodeMetric(node_name="n0", node_usage={},
                                            update_time=99.0))
    sched.update_node_devices("n0", [
        DC.DeviceEntry(minor=i, device_type=DC.DeviceType.GPU, resources={
            DC.DeviceResourceName.GPU_CORE: 100,
            DC.DeviceResourceName.GPU_MEMORY: 16384,
            DC.DeviceResourceName.GPU_MEMORY_RATIO: 100},
            numa_node=0, pcie_id="0") for i in range(4)])
    rng = default_rng(9)
    for j in range(3):
        sched.update_pod(P.T.PodSpec(
            name=f"gpu-{j}", requests={R.CPU: 1000, R.MEMORY: 1024},
            device_requests={DC.DeviceResourceName.NVIDIA_GPU:
                             int(rng.integers(1, 3))}))
    result = sched.schedule_pending(now=100.0)
    registry = P.RH.HookRegistry()
    P.RH.DeviceEnvPlugin().register(registry)
    server = P.RH.RuntimeHookServer(registry)
    envs = {}
    for uid, node in sorted(result.items()):
        if node is None:
            continue
        bound = sched.cache.pods[uid]
        meta = P.SI.pod_meta_from_spec(bound)
        envs[uid] = server.create_container(meta, "main", apply=False)
        minors = [str(d["minor"]) for d in json.loads(
            bound.annotations[P.X.ANNOTATION_DEVICE_ALLOCATED])["gpu"]]
        assert envs[uid].add_envs["NVIDIA_VISIBLE_DEVICES"] == ",".join(
            minors)
    assert envs
    return [dict(result), envs]


# -- batch resources and cpu normalization --------------------------------------


def batch_resources(P, root):
    """``TestBatchResourcePlugin``: a BE pod's shares, quota and memory
    limit, an unlimited container making the pod unlimited, non-BE pods
    untouched, the normalization ratio shrinking the quota (1.5, 1.25 to
    an integer, 2.3 just above one), the cfs quota disabled."""
    plugin = P.RH.BatchResourcePlugin()
    out = []
    ctx = P.RH.PodContext.from_meta(be_pod(P))
    plugin.set_pod_resources(ctx)
    assert (ctx.response.cpu_shares, ctx.response.cfs_quota_us,
            ctx.response.memory_limit_bytes) == (1024, 200000, 512 << 20)
    out.append(ctx.response)
    pod = be_pod(P)
    pod.batch_resources["extra"] = P.FW.ContainerBatchResources(
        request_mcpu=500, limit_mcpu=None, memory_limit_bytes=None)
    ctx = P.RH.PodContext.from_meta(pod)
    plugin.set_pod_resources(ctx)
    assert ctx.response.cfs_quota_us == -1
    out.append(ctx.response)
    ctx = P.RH.PodContext.from_meta(ls_pod(P))
    plugin.set_pod_resources(ctx)
    assert not ctx.response.is_origin_res_changed()
    out.append(ctx.response)
    scaled = {}
    for ratio, limit in ((1.5, 2000), (1.25, 2000), (2.3, 2300), (1.0, 2000),
                         (0.5, 2000)):
        plugin = P.RH.BatchResourcePlugin()
        changed = plugin.update_rule(cpu_normalization_ratio=ratio)
        pod = be_pod(P)
        pod.batch_resources["work"].limit_mcpu = limit
        scaled[ratio] = [changed]
        for ctx in (P.PR.ContainerContext.from_meta(pod, "work"),
                    P.RH.PodContext.from_meta(pod)):
            plugin.set_container_resources(ctx)
            plugin.set_pod_resources(ctx)
            scaled[ratio].append(ctx.response)
    assert scaled[1.5][1].cfs_quota_us == 133334    # ceil(200000 / 1.5)
    assert scaled[1.25][1].cfs_quota_us == 160000   # 200000 / 1.25 exactly
    assert 230000 / 2.3 > 100000
    assert scaled[2.3][1].cfs_quota_us == 100001    # 230000 / 2.3 in float64
    out.append(scaled)
    plugin = P.RH.BatchResourcePlugin()
    plugin.update_rule(cfs_quota_enabled=False)
    ctx = P.RH.PodContext.from_meta(be_pod(P))
    plugin.set_pod_resources(ctx)
    assert ctx.response.cfs_quota_us == -1
    out.append(ctx.response)
    return out


def _node(P, ratio=None):
    ann = {} if ratio is None else {
        P.X.ANNOTATION_CPU_NORMALIZATION_RATIO: str(ratio)}
    return P.T.NodeSpec(name="n0", annotations=ann)


def cpu_normalization(P, root):
    """``TestCPUNormalization`` on the plugin: the quota scaled by ceil
    (1.3, 2.0; 1.25 to an integer, 2.3 just above one), the restore after
    a removal written once, a never-scaled plugin inert, BE, pinned and
    unlimited pods untouched, malformed ratios ignored."""
    Q = P.X.QoSClass
    out = []
    for ratio, limit in ((1.3, 2000), (2.0, 1000), (1.25, 2000),
                         (2.3, 2300), (1.0, 2000), ("x", 2000), (-2, 2000)):
        p = P.RH.CPUNormalizationPlugin()
        changed = p.update_rule(_node(P, ratio))
        pod = P.FW.PodMeta(
            "ls", "kubepods/burstable/podls", Q.LS, cpu_limit_mcpu=limit,
            containers={"main": "kubepods/burstable/podls/main"},
            container_limits_mcpu={"main": limit})
        pctx = P.RH.PodContext.from_meta(pod)
        cctx = P.PR.ContainerContext.from_meta(pod, "main")
        p.adjust_pod_cfs_quota(pctx)
        p.adjust_container_cfs_quota(cctx)
        out.append([changed, p.ratio, pctx.response, cctx.response])
    assert out[0][2].cfs_quota_us == math.ceil(200000 / 1.3)
    assert out[1][3].cfs_quota_us == 50000
    assert out[2][2].cfs_quota_us == 160000
    assert out[3][2].cfs_quota_us == 100001
    p = P.RH.CPUNormalizationPlugin()
    p.update_rule(_node(P, 1.5))
    p.update_rule(_node(P))
    pod = P.FW.PodMeta("ls", "kubepods/burstable/podls", Q.LS,
                       cpu_limit_mcpu=2000)
    ctx = P.RH.PodContext.from_meta(pod)
    p.adjust_pod_cfs_quota(ctx)
    assert p.restoring and ctx.response.cfs_quota_us == 200000
    p.finish_restore()
    ctx2 = P.RH.PodContext.from_meta(pod)
    p.adjust_pod_cfs_quota(ctx2)
    assert ctx2.response.cfs_quota_us is None
    out.append([ctx.response, ctx2.response])
    p = P.RH.CPUNormalizationPlugin()
    p.update_rule(_node(P))
    scaled = P.RH.CPUNormalizationPlugin()
    scaled.update_rule(_node(P, 1.5))
    for pod in (P.FW.PodMeta("ls", "kubepods/burstable/podls", Q.LS,
                             cpu_limit_mcpu=2000),
                P.FW.PodMeta("be", "kubepods/besteffort/podbe", Q.BE,
                             cpu_limit_mcpu=2000),
                P.FW.PodMeta("pin", "kubepods/podpin", Q.NONE,
                             cpu_limit_mcpu=2000,
                             annotations=pin_annotation(P, [0, 1])),
                P.FW.PodMeta("ls", "kubepods/burstable/podls", Q.LS)):
        for plugin in (p, scaled):
            ctx = P.RH.PodContext.from_meta(pod)
            plugin.adjust_pod_cfs_quota(ctx)
            out.append(ctx.response)
    assert out[-7].cfs_quota_us == 133334 and out[-8].cfs_quota_us is None
    assert all(r.cfs_quota_us is None for r in out[-6:])
    return out


def _normalized_world(P, root, v2):
    pod = P.FW.PodMeta(
        "ls", "kubepods/burstable/podls", P.X.QoSClass.LS,
        containers={"main": "kubepods/burstable/podls/main"},
        cpu_limit_mcpu=4000, container_limits_mcpu={"main": 4000})
    fs = Fs(P, root, [pod], v2)
    informer = P.SI.StatesInformer()
    informer.set_pods([pod])
    hooks = P.RH.RuntimeHooks(informer, fs.ex)
    return fs, informer, hooks, pod


def cpu_normalization_cgroupfs(P, root, v2):
    """``test_normalized_node_scales_quota_in_fake_cgroupfs`` and
    ``test_ratio_removal_restores_in_cgroupfs``: the annotation through
    the informer's NODE callback scales the quota (1.6, then 1.25), its
    removal writes the spec quota back once, a re-added ratio scales
    again."""
    fs, informer, hooks, pod = _normalized_world(P, root, v2)
    quota = lambda: P.CG.CPU_CFS_QUOTA.read(pod.cgroup_dir, fs.cfg)  # noqa: E731
    seen = []
    for ratio in (1.6, 1.25, None, None, 2.3):
        informer.set_node(_node(P, ratio))
        seen.append([quota(), hooks.cpunormalization.ratio,
                     hooks.cpunormalization.restoring])
    if not v2:
        assert [s[0] for s in seen] == ["250000", "320000", "400000",
                                        "400000", "173914"]
    assert not seen[2][2]
    return [seen, fs.seen()]


# -- the reconciler, the server and RuntimeHooks ------------------------------


def _wire(P, root, pods, v2):
    fs = Fs(P, root, pods, v2)
    informer = P.SI.StatesInformer()
    rh = P.RH.RuntimeHooks(informer, fs.ex)
    rh.set_node_topo(P.RH.NodeTopoInfo(share_pools={0: "2-3", 1: "6-7"}))
    informer.set_node_slo(enabled_slo(P))
    return fs, informer, rh


def reconciler_actuates(P, root, v2):
    """``test_reconciler_actuates_everything``: the pinned cpuset and its
    unset quota, the BE pod's batch limits, the LS pod's bvt and share
    pools, the tiers' bvt; then a second reconcile (cache hits) and the
    reconciler's levels on their own."""
    pods = [lsr_pod(P), be_pod(P), ls_pod(P)]
    fs, informer, rh = _wire(P, root, pods, v2)
    informer.set_pods(pods)
    cfg, CG = fs.cfg, P.CG
    if not v2:
        assert CG.CPU_SET.read("kubepods/podlsr/main", cfg) == "0,1,4,5"
        assert CG.CPU_CFS_QUOTA.read("kubepods/podlsr", cfg) == "-1"
        assert CG.CPU_CFS_QUOTA.read("kubepods/besteffort/podbe",
                                     cfg) == "200000"
        assert CG.CPU_SHARES.read("kubepods/besteffort/podbe", cfg) == "1024"
        assert CG.CPU_BVT_WARP_NS.read("kubepods/burstable/podls",
                                       cfg) == "2"
        assert CG.CPU_SET.read("kubepods/burstable/podls/main",
                               cfg) == "2-3,6-7"
        assert CG.CPU_BVT_WARP_NS.read("kubepods/besteffort", cfg) == "-1"
    again = rh.reconcile()
    errs = []
    for pod in pods:
        rh.registry.run_hooks(P.RH.Stage.PRE_RUN_POD_SANDBOX,
                              P.RH.PodContext.from_meta(pod),
                              P.RH.FailurePolicy.IGNORE, errors=errs)
    assert errs == []
    fresh = Fs(P, os.path.join(str(root), "levels"), pods, v2)
    bvt = P.RH.BvtPlugin()
    bvt.update_rule(enabled_slo(P))
    registry = P.RH.HookRegistry()
    for plugin in (bvt, P.RH.CpusetPlugin(), P.RH.BatchResourcePlugin()):
        plugin.register(registry)
    levels = P.RH.Reconciler(registry, fresh.ex, bvt_plugin=bvt).reconcile(
        pods)
    return [again, levels, fs.seen(), fresh.seen()]


def slo_disable_resets_bvt(P, root, v2):
    """``test_slo_disable_resets_bvt``."""
    pods = [ls_pod(P)]
    fs, informer, rh = _wire(P, root, pods, v2)
    informer.set_pods(pods)
    informer.set_node_slo(P.SLO.NodeSLOSpec())
    if not v2:
        assert P.CG.CPU_BVT_WARP_NS.read("kubepods/burstable/podls",
                                         fs.cfg) == "0"
    return fs.seen()


def server_paths(P, root, v2):
    """``test_server_event_path`` and ``test_server_no_apply_returns_
    mutation_only``: every stage of the server, applied and not."""
    pods = [be_pod(P), lsr_pod(P)]
    fs, informer, rh = _wire(P, root, pods, v2)
    s = rh.server
    out = [s.run_pod_sandbox(pods[0], apply=False)]
    assert out[0].cpu_shares == 1024
    with pytest.raises(OSError):
        P.CG.CPU_SHARES.read("kubepods/besteffort/podbe", fs.cfg)
    res = s.create_container(pods[0], "work", apply=True)
    assert res.cfs_quota_us == 200000
    out.append(res)
    for pod, c in ((pods[0], "work"), (pods[1], "main")):
        out += [s.run_pod_sandbox(pod), s.create_container(pod, c),
                s.start_container(pod, c), s.post_start_container(pod, c),
                s.update_container_resources(pod, c),
                s.stop_container(pod, c), s.stop_pod_sandbox(pod)]
    return [out, fs.seen()]


def topo_change_reactuates(P, root, v2):
    """``test_topo_change_reactuates_cpuset``: a widened share pool
    re-actuates with no pod event; the same topology again writes
    nothing."""
    pods = [ls_pod(P)]
    fs, informer, rh = _wire(P, root, pods, v2)
    informer.set_pods(pods)
    rh.set_node_topo(P.RH.NodeTopoInfo(share_pools={0: "2-5", 1: "6-7"}))
    if not v2:
        assert P.CG.CPU_SET.read("kubepods/burstable/podls/main",
                                 fs.cfg) == "2-5,6-7"
    n = len(fs.ex.auditor)
    rh.set_node_topo(P.RH.NodeTopoInfo(share_pools={0: "2-5", 1: "6-7"}))
    assert len(fs.ex.auditor) == n
    return fs.seen()


def v2_merge(P, root):
    """``test_v2_merge_compares_in_v1_value_space``."""
    cfg = P.CG.SystemConfig(cgroup_root=os.path.join(str(root), "cg2"),
                            proc_root=os.path.join(str(root), "proc2"),
                            use_cgroup_v2=True)
    os.makedirs(os.path.join(str(root), "cg2", "kubepods"))
    ex = P.RE.ResourceUpdateExecutor(cfg, auditor=P.AUD.Auditor())
    SH = P.CG.CPU_SHARES
    SH.write("kubepods", SH.encode("2048", "", cfg), cfg)
    before = SH.read("kubepods", cfg)
    shrink = P.RE.CgroupUpdater("cpu.shares", "kubepods", "1024",
                                P.RE.merge_if_value_larger)
    assert not ex.update(False, shrink, merge=True)
    assert SH.read("kubepods", cfg) == before
    grow = P.RE.CgroupUpdater("cpu.shares", "kubepods", "4096",
                              P.RE.merge_if_value_larger)
    assert ex.update(False, grow, merge=True)
    return [before, SH.read("kubepods", cfg), tree(str(root)),
            events(ex.auditor, str(root))]


# -- terway --------------------------------------------------------------------


def terway_slo(P, policy=None, total_bps=10_000_000_000, be_egress=None):
    slo = P.SLO.NodeSLOSpec()
    slo.resource_qos_strategy.policies[P.TW.NET_QOS_POLICY_KEY] = (
        policy or P.TW.NET_QOS_POLICY_TERWAY)
    slo.system_strategy.total_network_bandwidth_bps = total_bps
    slo.resource_qos_strategy.ls.network = P.SLO.NetworkQOS(
        enable=True, ingress_request=50, ingress_limit=100,
        egress_request=50, egress_limit=100)
    slo.resource_qos_strategy.be.network = P.SLO.NetworkQOS(
        enable=True, ingress_request=10, ingress_limit=40,
        egress_request=10, egress_limit=be_egress or "2000000000")
    return slo


def terway(P, root):
    """``TestTerwayQos``: the node tiers (percentages of the bit rate,
    absolute bits/s strings, "2.5e9"), the pods' priorities and limits,
    an over-total value rejected with the prior config kept, a negative
    percent rejected, the disable removing both files."""
    plugin = P.TW.TerwayQosPlugin(os.path.join(str(root), "terway"))
    plugin.update_node_slo(terway_slo(P))
    text = open(plugin.node_file).read()
    cfg = dict(line.split("=") for line in text.strip().splitlines())
    total = 10_000_000_000 // 8
    assert int(cfg["hw_tx_bps_max"]) == total
    assert int(cfg["l1_rx_bps_min"]) == total // 2
    assert int(cfg["l2_rx_bps_max"]) == total * 40 // 100
    assert int(cfg["l2_tx_bps_max"]) == 2_000_000_000 // 8
    Q = P.X.QoSClass
    plugin.update_pods([
        P.FW.PodMeta("ls", "kubepods/burstable/podls", Q.LS,
                     labels={P.X.LABEL_QOS_CLASS: Q.LS.value},
                     annotations={P.TW.ANNOTATION_NET_QOS: json.dumps(
                         {"ingressLimit": "800000000",
                          "egressLimit": "400000000"})}),
        P.FW.PodMeta("be", "kubepods/besteffort/podbe", Q.BE),
        P.FW.PodMeta("plain", "kubepods/podplain", Q.NONE),
        P.FW.PodMeta("junk", "kubepods/podjunk", Q.NONE,
                     annotations={P.TW.ANNOTATION_NET_QOS: "{bad"}),
        P.FW.PodMeta("lsr", "kubepods/podlsr", Q.LSR,
                     labels={P.X.LABEL_QOS_CLASS: Q.LSR.value}),
    ])
    data = json.loads(open(plugin.pod_file).read())
    assert data["ls"]["prio"] == 1 and data["be"]["prio"] == 2
    assert data["ls"]["ingress_bandwidth"] == 100_000_000
    before = tree(str(root))
    plugin.update_node_slo(terway_slo(P, be_egress="20000000000"))
    assert tree(str(root)) == before
    bad = terway_slo(P)
    bad.resource_qos_strategy.ls.network.ingress_limit = -5
    plugin.update_node_slo(bad)
    float_total = terway_slo(P, be_egress="2.5e9")
    plugin.update_node_slo(float_total)
    after_float = tree(str(root))
    plugin.update_node_slo(terway_slo(P, policy="none"))
    assert not os.path.exists(plugin.node_file)
    assert not os.path.exists(plugin.pod_file)
    return [before, after_float, tree(str(root)),
            events(plugin.auditor, str(root))]


def terway_wired(P, root, v2):
    """``test_wired_through_runtimehooks_callbacks``."""
    fs = Fs(P, root, (), v2)
    informer = P.SI.StatesInformer()
    hooks = P.RH.RuntimeHooks(informer, fs.ex)
    informer.set_node_slo(terway_slo(P))
    assert os.path.exists(hooks.terwayqos.node_file)
    informer.set_pods([P.FW.PodMeta("ls", "kubepods/burstable/podls",
                                    P.X.QoSClass.LS, containers={})])
    assert "ls" in json.loads(open(hooks.terwayqos.pod_file).read())
    return fs.seen()


CASES = {f.__name__: f for f in (
    registry, conversions, bvt_rules, cpuset_plugin, cpuset_annotations,
    device_env, device_scheduler_to_env, batch_resources, cpu_normalization,
    v2_merge, terway)}
TREE_CASES = {f.__name__: f for f in (
    bvt_rule_update, cpu_normalization_cgroupfs, reconciler_actuates,
    slo_disable_resets_bvt, server_paths, topo_change_reactuates,
    terway_wired)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case, tmp_path):
    ref = plain(CASES[case](REF, tmp_path / "ref"))
    port = plain(CASES[case](PORT, tmp_path / "port"))
    assert port == ref


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_tree_case_matches_reference(case, v2, tmp_path):
    ref = plain(TREE_CASES[case](REF, tmp_path / "ref", v2))
    port = plain(TREE_CASES[case](PORT, tmp_path / "port", v2))
    assert port == ref


def test_standard_plugins_register_the_same_stages(tmp_path):
    """``RuntimeHooks`` registers the reference's plugins at the same
    stages in the same order, and its module default registry is empty."""
    def stages(P, root):
        fs = Fs(P, root)
        rh = P.RH.RuntimeHooks(P.SI.StatesInformer(), fs.ex)
        return ({s.value: [(h.name, h.description)
                           for h in rh.registry.hooks_by_stage(s)]
                 for s in rh.registry.stages_with_hooks()},
                P.RH.DEFAULT_REGISTRY.stages_with_hooks())
    assert plain(stages(PORT, tmp_path / "port")) == plain(
        stages(REF, tmp_path / "ref"))
