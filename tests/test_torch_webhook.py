"""The port's admission webhooks, manager gates and ``build_manager``
against the JAX package's: every case of ``tests/test_webhook.py`` (pod
mutation with profile injection, batch/mid translation and quota-tree
affinity; pod validation; the ElasticQuota topology guard; node
amplification admit and validate; the SLO configmap checkers) and the
manager cases of ``tests/test_features_cmd.py`` run through both
packages' modules on the same inputs. Each case asserts the reference's
expectations in both packages and returns what it observed (pods, nodes,
violations, errors, placements) as plain data, which must be equal."""

import dataclasses
import enum
import importlib
import json

import pytest

CPU, MEM, BCPU, BMEM = 0, 1, 2, 3


class Pkg:
    """One package's modules, built the same way."""

    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.W = mod("webhook")
        self.WM = mod("webhook.mutating")
        self.WC = mod("webhook.cm")
        self.WN = mod("webhook.node")
        self.S = mod("manager.sloconfig")
        self.QP = mod("quota.profile")
        self.bus = mod("client.bus")
        self.wiring = mod("client.wiring")
        self.cmd = mod("cmd.manager")
        self.features = mod("features")
        self._sched = mod("scheduler.scheduler").Scheduler
        self._model = mod("models.placement").PlacementModel

    def R(self, i):
        return self.X.ResourceName(i)

    def res(self, d):
        return {self.R(k): v for k, v in d.items()}

    def scheduler(self):
        if self.root == "koordinator_tpu":
            return self._sched(model=self._model(use_pallas=False))
        return self._sched(model=self._model(device="cpu"))

    def build_manager(self, config, **kw):
        if self.root == "koordinator_tpu_torch":
            kw["device"] = "cpu"
        return self.cmd.build_manager(config, **kw)


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")


def plain(x):
    """Enums by name, dataclasses as dicts, containers recursively."""
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


POD_FIELDS = ("name", "namespace", "requests", "limits", "qos", "priority",
              "priority_class", "sub_priority", "labels", "annotations",
              "node_selector", "quota", "owner")


def pod_view(pod):
    return plain({f: getattr(pod, f) for f in POD_FIELDS})


def node_view(node):
    return plain({f: getattr(node, f) for f in
                  ("name", "allocatable", "raw_allocatable", "annotations")})


# -- pod mutation ---------------------------------------------------------------


def batch_webhook(P):
    wh = P.W.PodMutatingWebhook()
    wh.update_profile(P.W.ClusterColocationProfile(
        name="colocation-batch",
        namespace_selector={"colocation": "enabled"},
        labels={"injected": "yes"},
        qos_class=P.X.QoSClass.BE,
        priority=5500,  # batch band
        koordinator_priority=333,
    ))
    wh.set_namespace_labels("batch-ns", {"colocation": "enabled"})
    wh.set_namespace_labels("prod-ns", {})
    return wh


def m_batch(P):
    pod = P.T.PodSpec(name="job", namespace="batch-ns",
                      requests=P.res({CPU: 4000, MEM: 2048}),
                      limits=P.res({CPU: 8000}))
    batch_webhook(P).mutate(pod)
    assert pod.qos == P.X.QoSClass.BE and pod.sub_priority == 333
    assert pod.priority_class == P.X.PriorityClass.BATCH
    assert pod.requests == P.res({BCPU: 4000, BMEM: 2048})
    assert pod.limits == P.res({BCPU: 8000})
    return pod_view(pod)


def m_non_matching_namespace(P):
    pod = P.T.PodSpec(name="svc", namespace="prod-ns",
                      requests=P.res({CPU: 1000}))
    batch_webhook(P).mutate(pod)
    assert pod.qos == P.X.QoSClass.NONE
    assert pod.requests == P.res({CPU: 1000})
    return pod_view(pod)


def m_selector_and_key_mapping(P):
    wh = P.W.PodMutatingWebhook()
    wh.update_profile(P.W.ClusterColocationProfile(
        name="map", selector={"app": "ml"},
        label_keys_mapping={"quota-name": "team"}))
    pod = wh.mutate(P.T.PodSpec(name="a",
                                labels={"app": "ml", "team": "vision"}))
    other = wh.mutate(P.T.PodSpec(name="b", labels={"team": "vision"}))
    assert pod.labels["quota-name"] == "vision"
    assert "quota-name" not in other.labels
    return [pod_view(pod), pod_view(other)]


def m_mid_and_limit_only_request(P):
    wh = P.W.PodMutatingWebhook([P.W.ClusterColocationProfile(name="all")])
    pod = wh.mutate(P.T.PodSpec(name="m", priority=7500,
                                limits=P.res({CPU: 2000})))
    mid = P.X.ResourceName.MID_CPU
    assert pod.limits == {mid: 2000} and pod.requests == {mid: 2000}
    return pod_view(pod)


def m_prod_untouched(P):
    wh = P.W.PodMutatingWebhook([P.W.ClusterColocationProfile(name="all")])
    pod = wh.mutate(P.T.PodSpec(name="p", priority=9500,
                                requests=P.res({CPU: 1000})))
    assert pod.requests == P.res({CPU: 1000})
    return pod_view(pod)


def m_unmanaged_batch_pod(P):
    pod = P.W.PodMutatingWebhook().mutate(
        P.T.PodSpec(name="raw", priority=5500, requests=P.res({CPU: 4000})))
    assert pod.requests == P.res({CPU: 4000})
    return pod_view(pod)


def m_end_to_end_batch_resources(P):
    wh = batch_webhook(P)
    s = P.scheduler()
    s.add_node(P.T.NodeSpec(name="n0", allocatable=P.res(
        {CPU: 16000, MEM: 32768, BCPU: 6000, BMEM: 8192})))
    s.update_node_metric(P.T.NodeMetric(node_name="n0", node_usage={},
                                        update_time=99.0))
    s.add_pod(wh.mutate(P.T.PodSpec(name="job", namespace="batch-ns",
                                    requests=P.res({CPU: 4000, MEM: 2048}))))
    out = dict(s.schedule_pending(now=100.0))
    s.add_pod(wh.mutate(P.T.PodSpec(name="job2", namespace="batch-ns",
                                    requests=P.res({CPU: 4000}))))
    out2 = dict(s.schedule_pending(now=101.0))
    assert out["batch-ns/job"] == "n0" and out2["batch-ns/job2"] is None
    return [out, out2]


def tree_webhook(P):
    wh = P.W.PodMutatingWebhook()
    wh.update_quota(P.T.QuotaSpec(name="team-a", tree_id="tree-1",
                                  min=P.res({CPU: 8000}),
                                  max=P.res({CPU: 16000})))
    wh.update_quota(P.T.QuotaSpec(name="team-free", min=P.res({CPU: 8000}),
                                  max=P.res({CPU: 16000})))
    wh.update_quota_profile(P.QP.QuotaProfile(
        name="pool-a", quota_name="root-a", tree_id="tree-1",
        node_selector={"pool": "a"}))
    return wh


def t_tree_quotas(P):
    wh = tree_webhook(P)
    pods = [wh.mutate(P.T.PodSpec(name=f"p{i}", quota=q))
            for i, q in enumerate(("team-a", "team-free", "nope"))]
    assert [p.node_selector for p in pods] == [{"pool": "a"}, None, None]
    return [pod_view(p) for p in pods]


def t_merge_and_conflict(P):
    wh = tree_webhook(P)
    pod = wh.mutate(P.T.PodSpec(name="p", quota="team-a",
                                node_selector={"zone": "z1"}))
    pod2 = wh.mutate(P.T.PodSpec(name="p2", quota="team-a",
                                 node_selector={"pool": "b"}))
    assert pod.node_selector == {"zone": "z1", "pool": "a"}
    assert pod2.node_selector["pool"] == P.WM.UNSATISFIABLE
    return [pod_view(pod), pod_view(pod2)]


def t_tree_pod_lands_on_tree_nodes(P):
    def cluster():
        s = P.scheduler()
        s.add_node(P.T.NodeSpec(name="big-free", allocatable=P.res(
            {CPU: 64000, MEM: 65536})))
        s.add_node(P.T.NodeSpec(name="tree-node", labels={"pool": "a"},
                                allocatable=P.res({CPU: 16000, MEM: 16384})))
        for n in ("big-free", "tree-node"):
            s.update_node_metric(P.T.NodeMetric(node_name=n, node_usage={},
                                                update_time=99.0))
        s.update_quota(P.T.QuotaSpec(
            name="team-a", tree_id="tree-1",
            min=P.res({CPU: 8000, MEM: 8192}),
            max=P.res({CPU: 16000, MEM: 16384})))
        return s

    def pod():
        return P.T.PodSpec(name="p", quota="team-a",
                           requests=P.res({CPU: 1000, MEM: 1024}))

    s = cluster()
    s.add_pod(pod())
    plain_round = dict(s.schedule_pending(now=100.0))
    s = cluster()
    s.add_pod(tree_webhook(P).mutate(pod()))
    admitted = dict(s.schedule_pending(now=100.0))
    assert plain_round["default/p"] == "big-free"
    assert admitted["default/p"] == "tree-node"
    return [plain_round, admitted]


def t_wired_through_bus(P):
    bus = P.bus.APIServer()
    wh = P.W.PodMutatingWebhook()
    P.wiring.wire_pod_webhook(bus, wh)
    bus.apply(P.bus.Kind.QUOTA, "team-a", P.T.QuotaSpec(
        name="team-a", tree_id="tree-1", min=P.res({CPU: 1000}),
        max=P.res({CPU: 2000})))
    bus.apply(P.bus.Kind.QUOTA_PROFILE, "pool-a", P.QP.QuotaProfile(
        name="pool-a", quota_name="root-a", tree_id="tree-1",
        node_selector={"pool": "a"}))
    pod = wh.mutate(P.T.PodSpec(name="p", quota="team-a"))
    bus.delete(P.bus.Kind.QUOTA_PROFILE, "pool-a")
    pod2 = wh.mutate(P.T.PodSpec(name="p2", quota="team-a"))
    bus.delete(P.bus.Kind.QUOTA, "team-a")
    assert pod.node_selector == {"pool": "a"} and pod2.node_selector is None
    return [pod_view(pod), pod_view(pod2), sorted(wh.quota_specs),
            sorted(wh.quota_profiles)]


# -- pod validation ---------------------------------------------------------------


def v_pods(P):
    v = P.W.PodValidatingWebhook()
    Q = P.X.QoSClass
    cases = [
        dict(name="x", qos=Q.LS, requests=P.res({BCPU: 1000})),
        dict(name="y", qos=Q.BE, priority=5500, requests=P.res({BCPU: 1000})),
        dict(name="be-prod", qos=Q.BE, priority=9500),
        dict(name="lsr-batch", qos=Q.LSR, priority=5500,
             requests=P.res({CPU: 2000})),
        dict(name="lsr-prod", qos=Q.LSR, priority=9500,
             requests=P.res({CPU: 2000})),
        dict(name="lsr-frac", qos=Q.LSR, priority=9500,
             requests=P.res({CPU: 1500})),
        dict(name="lse-none", qos=Q.LSE, priority=9500),
    ]
    out = [v.validate(P.T.PodSpec(**kw)) for kw in cases]
    assert any("QoS BE" in e for e in out[0]) and out[1] == []
    assert any("combination" in e for e in out[2])
    assert any("combination" in e for e in out[3]) and out[4] == []
    assert any("integer" in e for e in out[5])
    assert any("must declare" in e for e in out[6])
    old = P.T.PodSpec(name="x", qos=Q.LS, priority=9500)
    new = P.T.PodSpec(name="x", qos=Q.BE, priority=5500)
    errs = v.validate(new, old_pod=old)
    assert any("qosClass" in e for e in errs)
    assert any("spec.priority" in e for e in errs)
    return out + [errs]


# -- the quota topology guard -----------------------------------------------------


def guard_ops(P, ops):
    """Each op ``(verb, kwargs or name)`` -> "ok" or the error text."""
    g = P.W.QuotaTopologyGuard()
    out = []
    for verb, arg in ops:
        try:
            if verb == "delete":
                g.validate_delete(arg)
            else:
                kw = dict(arg)
                for f in ("min", "max"):
                    kw[f] = P.res(kw.get(f, {}))
                getattr(g, f"validate_{verb}")(P.T.QuotaSpec(**kw))
            out.append("ok")
        except P.W.QuotaTopologyError as e:
            out.append(str(e))
    return out, sorted(g.quotas)


PARENT = ("add", dict(name="parent", is_parent=True, min={CPU: 10000},
                      max={CPU: 20000}))
GUARD_SCRIPTS = {
    "negative_and_min_over_max": [
        ("add", dict(name="neg", min={CPU: -1}, max={CPU: 100})),
        ("add", dict(name="inv", min={CPU: 200}, max={CPU: 100}))],
    "parent_checks": [
        PARENT,
        ("add", dict(name="orphan", parent="ghost", min={CPU: 1},
                     max={CPU: 1}, is_parent=True)),
        ("add", dict(name="leaf", parent="parent", min={CPU: 1000},
                     max={CPU: 20000})),
        ("add", dict(name="under-leaf", parent="leaf", min={CPU: 1},
                     max={CPU: 20000}, is_parent=True))],
    "sibling_min_sum": [
        PARENT,
        ("add", dict(name="a", parent="parent", min={CPU: 6000},
                     max={CPU: 20000})),
        ("add", dict(name="b", parent="parent", min={CPU: 6000},
                     max={CPU: 20000})),
        ("add", dict(name="b", parent="parent", min={CPU: 4000},
                     max={CPU: 20000}))],
    "max_keys": [
        PARENT,
        ("add", dict(name="c", parent="parent", min={CPU: 100},
                     max={CPU: 20000, MEM: 1024}))],
    "delete_with_children": [
        PARENT,
        ("add", dict(name="kid", parent="parent", min={CPU: 100},
                     max={CPU: 20000})),
        ("delete", "parent"), ("delete", "kid"), ("delete", "parent"),
        ("delete", "ghost")],
    "update_rules": [
        PARENT,
        ("update", dict(name="parent", is_parent=True, tree_id="other",
                        min={CPU: 10000}, max={CPU: 20000})),
        ("add", dict(name="kid", parent="parent", min={CPU: 100},
                     max={CPU: 20000})),
        ("update", dict(name="parent", is_parent=False, min={CPU: 10000},
                        max={CPU: 20000})),
        ("update", dict(name="parent", is_parent=True, min={CPU: 50},
                        max={CPU: 20000})),
        ("update", dict(name="ghost", min={CPU: 1}, max={CPU: 1})),
        ("add", dict(name="kid", min={CPU: 1}, max={CPU: 1}))],
}
GUARD_EXPECT = {
    "negative_and_min_over_max": ["< 0", "min > max"],
    "parent_checks": ["ok", "not found", "ok", "not a parent"],
    "sibling_min_sum": ["ok", "ok", "brothers", "ok"],
    "max_keys": ["ok", "max keys"],
    "delete_with_children": ["ok", "ok", "children", "ok", "ok",
                             "not found"],
    "update_rules": ["ok", "immutable", "ok", "isParent", "children's min",
                     "not found", "already exists"],
}


# -- node amplification --------------------------------------------------------------


def ratio_node(P, cpu=32000, ratio=1.5):
    return P.T.NodeSpec(
        name="n0", allocatable=P.res({CPU: cpu, MEM: 65536}),
        annotations={P.X.ANNOTATION_RESOURCE_AMPLIFICATION_RATIO:
                     json.dumps({str(CPU): ratio})})


def n_mutations(P):
    M = P.W.NodeMutatingWebhook()
    raw = P.X.ANNOTATION_NODE_RAW_ALLOCATABLE
    out = []
    # create passes through
    node = ratio_node(P)
    M.mutate(node, old_node=None)
    out.append(node_view(node))
    # a kubelet update re-amplifies
    old = ratio_node(P, cpu=32000)
    old.raw_allocatable = P.res({CPU: 32000, MEM: 65536})
    old.allocatable = P.res({CPU: 48000, MEM: 65536})
    new = ratio_node(P, cpu=40000)
    M.mutate(new, old_node=old)
    assert new.allocatable[P.R(CPU)] == 60000
    out.append(node_view(new))
    # an unchanged update amplifies from the stored raw; an echo is a no-op
    for cpu, stored, ratio, want in ((48000, 32000, 1.5, 48000),
                                     (60000, 40000, 1.5, 60000),
                                     (48000, 32000, 2.0, 64000)):
        old = ratio_node(P, cpu=cpu)
        old.raw_allocatable = P.res({CPU: stored, MEM: 65536})
        new = ratio_node(P, cpu=cpu, ratio=ratio)
        M.mutate(new, old_node=old)
        assert new.allocatable[P.R(CPU)] == want
        out.append(node_view(new))
    # the annotation added later takes effect at once
    old = P.T.NodeSpec(name="n0", allocatable=P.res({CPU: 32000, MEM: 65536}))
    new = ratio_node(P, cpu=32000)
    M.mutate(new, old_node=old)
    assert new.allocatable[P.R(CPU)] == 48000
    out.append(node_view(new))
    # removing the ratio cleans the raw record
    old = ratio_node(P, cpu=48000)
    old.raw_allocatable = P.res({CPU: 32000, MEM: 65536})
    new = P.T.NodeSpec(name="n0", allocatable=P.res({CPU: 48000, MEM: 65536}),
                       annotations={raw: json.dumps({"cpu": 32000})})
    M.mutate(new, old_node=old)
    assert raw not in new.annotations and new.raw_allocatable is None
    out.append(node_view(new))
    # the raw record survives serialization through the annotation; a
    # corrupt one counts as never recorded
    for text, want_raw in ((json.dumps({"cpu": 32000}), 32000),
                           (json.dumps({"cpu": "garbage"}), 48000)):
        old = ratio_node(P, cpu=48000)
        old.annotations[raw] = text
        out.append(plain(P.WN.stored_raw_allocatable(old)))
        echoed = ratio_node(P, cpu=48000)
        M.mutate(echoed, old_node=old)
        assert echoed.raw_allocatable[P.R(CPU)] == want_raw
        out.append(node_view(echoed))
    # a malformed ratio never crashes the mutation
    for payload in ("[1.5]", '"1.5"', "1.5", "not json"):
        node = P.T.NodeSpec(name="n0", allocatable=P.res({CPU: 1000}),
                            annotations={
                                P.X.ANNOTATION_RESOURCE_AMPLIFICATION_RATIO:
                                    payload})
        M.mutate(node, old_node=P.T.NodeSpec(name="n0"))
        out.append(node_view(node))
    return out


def n_validations(P):
    V = P.W.NodeValidatingWebhook()
    out = [V.validate(ratio_node(P, ratio=0.8))]
    assert out[0] and "[1.0, 100.0]" in out[0][0]
    for payload in ("not json", "[1.5]", '"1.5"', "1.5", '{"0": Infinity}',
                    '{"0": NaN}', '{"0": 1000.0}', '{"0": 2.0}'):
        node = P.T.NodeSpec(name="n0", annotations={
            P.X.ANNOTATION_RESOURCE_AMPLIFICATION_RATIO: payload})
        out.append(V.validate(node))
    assert all(out[1:-1]) and out[-1] == []
    return out


# -- the SLO configmap checkers ---------------------------------------------------------


def c_slo_checks(P):
    w = P.W.SLOConfigValidatingWebhook()
    S = P.S
    out = [w.validate_colocation(S.ColocationStrategy()),
           w.validate_cpu_burst(S.CPUBurstStrategy()),
           w.validate_threshold(S.ResourceThresholdStrategy()),
           w.validate_resource_qos(S.ResourceQOSStrategy())]
    assert out == [[], [], [], []]
    bad = S.ColocationStrategy(cpu_reclaim_threshold_percent=150,
                               degrade_time_minutes=0,
                               cpu_calculate_policy="banana")
    out.append(w.validate_colocation(bad))
    assert len(out[-1]) == 3
    out.append(w.validate_cpu_burst(S.CPUBurstStrategy(
        policy="never", cfs_quota_burst_percent=50)))
    assert len(out[-1]) == 2
    out.append(w.validate_threshold(S.ResourceThresholdStrategy(
        cpu_suppress_threshold_percent=0, cpu_suppress_policy="x")))
    assert len(out[-1]) == 2
    qos = S.ResourceQOSStrategy()
    qos.be.cpu.group_identity = 7
    qos.ls.resctrl.cat_range_start_percent = 80
    qos.ls.resctrl.cat_range_end_percent = 20
    qos.lsr.resctrl.mba_percent = 0
    qos.system.memory.throttling_percent = 101
    out.append(w.validate_resource_qos(qos))
    assert len(out[-1]) == 4
    # the checker rejects everything the runtime is_valid rejects
    for kw in (dict(metric_report_interval_seconds=0),
               dict(resource_diff_threshold=0),
               dict(metric_aggregate_duration_seconds=0),
               dict(cpu_reclaim_threshold_percent=0),
               dict(memory_reclaim_threshold_percent=200),
               dict(degrade_time_minutes=0),
               dict(update_time_threshold_seconds=0)):
        strategy = S.ColocationStrategy(**kw)
        assert not strategy.is_valid()
        out.append(P.WC.check_colocation(strategy))
        assert out[-1]
    return out


# -- the manager's gates and build_manager -----------------------------------------------


def g_build_manager(P):
    off = P.build_manager(P.cmd.ManagerConfig())
    on = P.build_manager(P.cmd.ManagerConfig(
        feature_gates="NodeMutatingWebhook=true,NodeValidatingWebhook=true,"
                      "ConfigMapValidatingWebhook=true"))
    assert off.node_mutating_webhook is None
    assert on.slo_config_webhook is not None
    node, violations = on.admit_node(
        P.T.NodeSpec(name="n0", allocatable=P.res({CPU: 1000})))
    assert violations == [] and node.allocatable[P.R(CPU)] == 1000
    pod, pod_violations = off.admit_pod(
        P.T.PodSpec(name="x", requests=P.res({CPU: 100})))
    assert pod_violations == []
    gates = P.features.FeatureGate(dict(P.features.MANAGER_GATES.as_dict()))
    m2 = P.build_manager(P.cmd.ManagerConfig(
        feature_gates="PodMutatingWebhook=false"), gates=gates)
    assert m2.mutating_webhook is None
    # a rejected pod comes back with its violations
    bad, bad_violations = off.admit_pod(P.T.PodSpec(
        name="y", qos=P.X.QoSClass.LS, requests=P.res({BCPU: 1000})))
    assert bad_violations

    def wired(m):
        return {f.name: getattr(m, f.name) is not None
                for f in dataclasses.fields(m)}

    return [wired(off), wired(on), wired(m2), node_view(node),
            pod_view(pod), pod_view(bad), bad_violations,
            type(off.noderesource).__name__,
            off.profile_controller_factory.__name__]


CASES = {f.__name__: f for f in (
    m_batch, m_non_matching_namespace, m_selector_and_key_mapping,
    m_mid_and_limit_only_request, m_prod_untouched, m_unmanaged_batch_pod,
    m_end_to_end_batch_resources, t_tree_quotas, t_merge_and_conflict,
    t_tree_pod_lands_on_tree_nodes, t_wired_through_bus, v_pods,
    n_mutations, n_validations, c_slo_checks, g_build_manager)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case):
    assert CASES[case](PORT) == CASES[case](REF)


@pytest.mark.parametrize("script", sorted(GUARD_SCRIPTS))
def test_quota_guard_matches_reference(script):
    got = guard_ops(PORT, GUARD_SCRIPTS[script])
    assert got == guard_ops(REF, GUARD_SCRIPTS[script])
    outcomes, _ = got
    assert len(outcomes) == len(GUARD_EXPECT[script])
    for outcome, want in zip(outcomes, GUARD_EXPECT[script]):
        assert want in outcome, (outcome, want)


def test_manager_gates_are_the_names_build_manager_reads():
    """A manager gate is registered with the code that reads it: the six
    webhook gates ``build_manager`` consults, at the reference's
    defaults; any other name (the reference's other manager gates
    included) is refused and leaves the registry untouched."""
    gates = PORT.features.MANAGER_GATES
    ref = REF.features.MANAGER_GATES.as_dict()
    assert gates.as_dict() == {name: ref[name] for name in gates.as_dict()}
    assert sorted(gates.as_dict()) == [
        "ConfigMapValidatingWebhook", "ElasticValidatingWebhook",
        "NodeMutatingWebhook", "NodeValidatingWebhook",
        "PodMutatingWebhook", "PodValidatingWebhook"]
    copy = gates.copy()
    for name in sorted(set(ref) - set(gates.as_dict())):
        with pytest.raises(KeyError):
            copy.set_from_spec(f"PodMutatingWebhook=false,{name}=true")
    assert copy.as_dict() == gates.as_dict()
    # the scheduler's registry is unchanged by the manager's
    assert sorted(PORT.features.SCHEDULER_GATES.as_dict()) == [
        "BatchedPlacement", "ElasticQuotaPreemption"]
