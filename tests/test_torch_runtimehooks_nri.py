"""The port's NRI mode (``koordlet/runtimehooks/nri.py``: the PLEG's pod
lifecycle events dispatched to the hook server's stages) against the JAX
package's. The cases are those of ``tests/test_nri.py``, on cgroup v1 and
v2, plus a seeded churn of pods whose dirs appear and go in a seeded
order. Each case runs through both packages, each on its own fake cgroup
tree under ``tmp_path``; it asserts the reference's expectations and
returns what it observed: the handled and dropped counts, the
``synchronize`` counts, the tree's files and the executor's writes in
order. The two must be equal."""

import dataclasses
import enum
import importlib
import json
import os
import shutil

import numpy as np
import pytest


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.X = mod("apis.extension")
        self.AUD = mod("koordlet.audit")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.PLEG = mod("koordlet.pleg")
        self.RE = mod("koordlet.resourceexecutor")
        self.EX = mod("koordlet.resourceexecutor.executor")
        self.RH = mod("koordlet.runtimehooks")
        self.NRI = mod("koordlet.runtimehooks.nri")
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
    return x


def tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


class Env:
    """``make_env`` of ``tests/test_nri.py``: a fake tree (v1 or v2), an
    informer, ``RuntimeHooks`` over an executor, the bvt rule armed."""

    def __init__(self, P, root, v2):
        self.P, self.root = P, str(root)
        self.cfg = P.CG.SystemConfig(
            cgroup_root=os.path.join(self.root, "cg"),
            proc_root=os.path.join(self.root, "proc"), use_cgroup_v2=v2)
        for d in ("kubepods", "kubepods/burstable", "kubepods/besteffort"):
            P.EX.ensure_cgroup_dir(d, self.cfg)
        self.informer = P.SI.StatesInformer()
        self.ex = P.RE.ResourceUpdateExecutor(self.cfg,
                                              auditor=P.AUD.Auditor())
        self.hooks = P.RH.RuntimeHooks(self.informer, self.ex)
        slo = P.SLO.NodeSLOSpec()
        for tier in ("lsr", "ls", "be"):
            getattr(slo.resource_qos_strategy, tier).enable = True
        self.informer.set_node_slo(slo)

    def mkdir(self, d):
        self.P.EX.ensure_cgroup_dir(d, self.cfg)

    def rmdir(self, d):
        tops = ([self.cfg.cgroup_root] if self.cfg.use_cgroup_v2 else
                [os.path.join(self.cfg.cgroup_root, fs)
                 for fs in self.P.CG.V1_SUBSYSTEMS])
        for top in tops:
            shutil.rmtree(os.path.join(top, d), ignore_errors=True)

    def read(self, res, d):
        return res.read(d, self.cfg)

    def seen(self, nri):
        return dict(handled=dict(nri.handled), dropped=nri.dropped,
                    tree=tree(self.root),
                    writes=[(e.group, os.path.relpath(e.subject, self.root),
                             e.operation,
                             e.detail.replace(self.root, "<root>"))
                            for e in reversed(self.ex.auditor.query())])


def lsr_pod(P, uid="lsr", cpus=(0, 1)):
    return P.FW.PodMeta(
        uid, f"kubepods/pod{uid}", P.X.QoSClass.LSR,
        containers={"main": f"kubepods/pod{uid}/main"},
        annotations={P.X.ANNOTATION_RESOURCE_STATUS: json.dumps(
            {"cpuset": list(cpus)})})


def ls_pod(P, uid="ls"):
    return P.FW.PodMeta(uid, f"kubepods/burstable/pod{uid}", P.X.QoSClass.LS,
                        containers={"main": f"kubepods/burstable/pod{uid}/main"})


def pod_added(P, root, v2):
    """``test_pod_added_event_lands_bvt_in_cgroupfs`` and
    ``test_container_added_pins_cpuset``."""
    e = Env(P, root, v2)
    pleg = P.PLEG.PLEG(e.cfg)
    e.informer.set_pods([])
    nri = e.hooks.attach_nri(pleg)
    pleg.poll()
    ls, lsr = ls_pod(P), lsr_pod(P)
    e.informer.set_pods([ls, lsr])
    e.mkdir(ls.cgroup_dir)
    e.mkdir(lsr.cgroup_dir)
    pleg.poll()
    assert nri.handled.get("RunPodSandbox") == 2
    e.mkdir(lsr.containers["main"])
    pleg.poll()
    assert nri.handled.get("CreateContainer") == 1
    if not v2:
        assert e.read(P.CG.CPU_BVT_WARP_NS, ls.cgroup_dir) == "2"
        assert e.read(P.CG.CPU_SET, lsr.containers["main"]) == "0,1"
    return e.seen(nri)


def unknown_dir_dropped(P, root, v2):
    """``test_unknown_dir_dropped_not_crashed``."""
    e = Env(P, root, v2)
    pleg = P.PLEG.PLEG(e.cfg)
    e.informer.set_pods([])
    nri = e.hooks.attach_nri(pleg)
    pleg.poll()
    e.mkdir("kubepods/podghost")
    e.mkdir("kubepods/podghost/c")
    pleg.poll()
    assert nri.dropped == 2 and not nri.handled
    return e.seen(nri)


def filters(P, root, v2):
    """``test_event_subscription_filters`` and
    ``test_disabled_stage_skipped``: a subscription to CreateContainer
    alone, and the sandbox stage disabled."""
    out = []
    for k, kw in enumerate(({"events": {"CreateContainer"}},
                            {"disable_stages": {"PreRunPodSandbox"}})):
        e = Env(P, os.path.join(str(root), str(k)), v2)
        pleg = P.PLEG.PLEG(e.cfg)
        pod = ls_pod(P)
        e.informer.set_pods([pod])
        nri = e.hooks.attach_nri(pleg, **kw)
        pleg.poll()
        e.mkdir(pod.cgroup_dir)
        events = pleg.poll()
        assert events and not nri.handled
        e.mkdir(pod.containers["main"])
        pleg.poll()
        out.append([events, e.seen(nri)])
    return out


def stop_events(P, root, v2):
    """``test_stop_hooks_run_after_informer_dropped_pod``: the informer
    drops the pod before its dirs go; the stop stages resolve through the
    retained index."""
    e = Env(P, root, v2)
    pleg = P.PLEG.PLEG(e.cfg)
    pod = ls_pod(P)
    e.informer.set_pods([pod])
    nri = e.hooks.attach_nri(pleg)
    e.mkdir(pod.cgroup_dir)
    e.mkdir(pod.containers["main"])
    pleg.poll()
    e.informer.set_pods([])
    e.rmdir(pod.cgroup_dir)
    pleg.poll()
    assert nri.handled.get("StopPodSandbox") == 1
    assert nri.handled.get("StopContainer") == 1
    assert nri.dropped == 0
    return e.seen(nri)


def bad_names(P, root, v2):
    """``test_unknown_event_name_rejected``, ``test_unknown_stage_name_
    rejected`` and ``test_all_events_constant_matches_names``."""
    e = Env(P, root, v2)
    out = []
    for kw in ({"events": {"CreateContainers"}},
               {"disable_stages": {"PreRunPodsandbox"}}):
        with pytest.raises(ValueError) as err:
            e.hooks.attach_nri(P.PLEG.PLEG(e.cfg), **kw)
        out.append(str(err.value))
    assert P.NRI.ALL_EVENTS == {"RunPodSandbox", "StopPodSandbox",
                                "CreateContainer", "StopContainer"}
    return [out, sorted(P.NRI.ALL_EVENTS), P.NRI.EVENT_NAMES]


def synchronize(P, root, v2):
    """``test_attach_synchronizes_existing_pods``: attach re-runs the
    hooks over every running pod; a second synchronize counts the same
    contexts, a subscription without containers fewer."""
    e = Env(P, root, v2)
    pods = [lsr_pod(P), ls_pod(P)]
    for pod in pods:
        e.mkdir(pod.cgroup_dir)
        e.mkdir(pod.containers["main"])
    e.informer.set_pods(pods)
    pleg = P.PLEG.PLEG(e.cfg)
    nri = P.RH.NriServer(e.hooks.server, e.informer)
    nri.attach(pleg)
    if not v2:
        assert e.read(P.CG.CPU_SET, pods[0].containers["main"]) == "0,1"
        assert e.read(P.CG.CPU_BVT_WARP_NS, pods[0].cgroup_dir) == "2"
    counts = [nri.synchronize(),
              P.RH.NriServer(e.hooks.server, e.informer,
                             events={"RunPodSandbox"}).synchronize()]
    assert counts == [4, 2]
    return [counts, e.seen(nri)]


def seeded_churn(P, root, v2):
    """Seeded pods whose dirs appear and go in a seeded order over eight
    polls; some pods the informer never knew (dropped), some dropped from
    the informer before their dirs go (resolved through the retained
    index), every second poll preceded by a reconcile."""
    e = Env(P, root, v2)
    rng = np.random.default_rng(17)
    pods = [lsr_pod(P, f"p{k}", sorted(int(c) for c in rng.choice(
        16, 2, replace=False))) if k % 2 else ls_pod(P, f"p{k}")
        for k in range(12)]
    known = [p for p in pods if rng.random() < 0.75]
    e.informer.set_pods(known)
    pleg = P.PLEG.PLEG(e.cfg)
    nri = e.hooks.attach_nri(pleg)
    pleg.poll()
    order = [int(k) for k in rng.permutation(len(pods))]
    polls = []
    for step in range(8):
        for k in order[step::8]:
            pod = pods[k]
            e.mkdir(pod.cgroup_dir)
            if rng.random() < 0.7:
                e.mkdir(pod.containers["main"])
        if step >= 4:
            gone = known[:1]
            known = known[1:]
            e.informer.set_pods(known)
            for pod in gone:
                e.rmdir(pod.cgroup_dir)
        if step % 2:
            e.hooks.reconcile()
        polls.append([(ev.event, ev.cgroup_dir) for ev in pleg.poll()])
    return [polls, e.seen(nri)]


CASES = {f.__name__: f for f in (pod_added, unknown_dir_dropped, filters,
                                 stop_events, bad_names, synchronize,
                                 seeded_churn)}


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nri_case_matches_reference(case, v2, tmp_path):
    ref = plain(CASES[case](REF, tmp_path / "ref", v2))
    port = plain(CASES[case](PORT, tmp_path / "port", v2))
    assert port == ref
