"""The port's ``Scheduler`` with the reference's defaults
(``enable_preemption=True``, ``preemption_backend="device"``) against the
JAX ``Scheduler``: the same seeded preemption storms (the port's
``testing.preemption_storm`` against ``koordinator_tpu.testing.chaos``'s)
fed to both, round for round equal placements, nominations, evicted uids,
quota accounting and final cache under each backend ("device", "host",
"verify"); ``defrag_headroom`` planned and applied; the staging cache's
delta path after a preemption round equal to a fresh staging; and the
eviction sink (counterpart of the batched preemption tests in
``tests/test_preempt_device.py`` and ``tests/test_quota_preemption.py``)."""

import numpy as np
import pytest
import torch

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu.scheduler.plugins.elasticquota import (
    ElasticQuotaPlugin as JElasticQuotaPlugin,
)
from koordinator_tpu.scheduler.scheduler import Scheduler as JScheduler
from koordinator_tpu.testing.chaos import preemption_storm as jstorm
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.scheduler.plugins.elasticquota import (
    ElasticQuotaPlugin,
)
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.state.cluster import lower_nodes

CPU, MEM = 0, 1
BACKENDS = ("device", "host", "verify")


def _plain(pod):
    return (pod.uid, pod.node_name, {int(k): v for k, v in
                                     pod.requests.items()},
            int(pod.qos), int(pod.priority_class), pod.priority, pod.quota,
            pod.assign_time, pod.preemptible)


def test_storm_world_matches_reference():
    """The port's storm draws the reference's world from the same seed."""
    for seed, quota in ((11, None), (3, "q")):
        want = jstorm(seed=seed, n_nodes=9, residents_per_node=4,
                      n_arrivals=7, quota=quota)
        got = testing.preemption_storm(seed=seed, n_nodes=9,
                                       residents_per_node=4, n_arrivals=7,
                                       quota=quota)
        assert [n.name for n in got[0]] == [n.name for n in want[0]]
        for g, w in zip(got[1:], want[1:]):
            assert [_plain(p) for p in g] == [_plain(p) for p in w]


def _quota(types, resource, name, cpu, mem):
    return types.QuotaSpec(name=name, min={resource.CPU: cpu,
                                           resource.MEMORY: mem},
                           max={resource.CPU: cpu, resource.MEMORY: mem})


def _pair(backend, seed, quota=None, quota_share=1.0, n_nodes=8, rpn=3,
          n_arrivals=12, extra_residents=()):
    """The JAX and the port Scheduler, each fed its package's storm; with
    ``quota`` every pod is in that group, whose min and max are
    ``quota_share`` of the cluster."""
    out = []
    for make, storm, types, resource in (
            (lambda total: JScheduler(
                model=JPlacementModel(use_pallas=False), cluster_total=total,
                preemption_backend=backend),
             jstorm, jtypes, JResourceName),
            (lambda total: Scheduler(
                model=PlacementModel(device="cpu"), cluster_total=total,
                preemption_backend=backend),
             testing.preemption_storm, ttypes, TResourceName)):
        nodes, residents, arrivals = storm(
            seed=seed, n_nodes=n_nodes, residents_per_node=rpn,
            n_arrivals=n_arrivals, quota=quota)
        cpu = sum(n.allocatable[resource.CPU] for n in nodes)
        mem = sum(n.allocatable[resource.MEMORY] for n in nodes)
        sched = make({resource.CPU: cpu, resource.MEMORY: mem})
        if quota is not None:
            sched.update_quota(_quota(types, resource, quota,
                                      int(cpu * quota_share),
                                      int(mem * quota_share)))
        for node in nodes:
            sched.add_node(node)
        for d in extra_residents:
            residents.append(types.PodSpec(
                name=d["name"], node_name=d["node"],
                requests={resource.CPU: d["cpu"], resource.MEMORY: d["mem"]},
                priority=d["prio"], preemptible=d["preemptible"],
                quota=quota, assign_time=d["at"]))
        for pod in residents + arrivals:
            sched.add_pod(pod)
        out.append(sched)
    return out


def _quota_view(scheduler):
    return {(tree, name): tuple(np.asarray(getattr(info, f)).tolist()
                                for f in ("used", "request"))
            for tree, mgr in scheduler.quota_registry.items()
            for name, info in mgr.quotas.items()}


def _same_rounds(ref, port, rounds, t0=100.0):
    """Run both for ``rounds`` rounds (or until nothing is pending),
    asserting each round equal; returns the totals seen."""
    seen = {"nominations": 0, "evicted": 0, "placed": 0}
    for r in range(rounds):
        now = t0 + r
        before = set(port.cache.pods)
        assert before == set(ref.cache.pods), r
        want = ref.schedule_pending(now=now)
        got = port.schedule_pending(now=now)
        assert dict(got) == dict(want), r
        assert got.waiting == want.waiting, r
        assert got.nominations == want.nominations, r
        evicted = before - set(port.cache.pods)
        assert evicted == before - set(ref.cache.pods), r
        assert ({u: p.node_name for u, p in port.cache.pods.items()}
                == {u: p.node_name for u, p in ref.cache.pods.items()}), r
        assert list(port.cache.pending) == list(ref.cache.pending), r
        assert _quota_view(port) == _quota_view(ref), r
        seen["nominations"] += len(got.nominations)
        seen["evicted"] += len(evicted)
        seen["placed"] += sum(n is not None for n in got.values())
        for uid, node in got.items():
            if node is not None:
                port.cache.finish_binding(uid)
                ref.cache.finish_binding(uid)
        if not port.cache.pending:
            break
    return seen


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", (3, 11))
def test_storm_rounds_match_reference(backend, seed):
    """No quota gate: placements, nominations, evictions and the cache
    equal round for round, and the nominated preemptors bind later."""
    ref, port = _pair(backend, seed)
    seen = _same_rounds(ref, port, rounds=6)
    assert seen["nominations"] > 0 and seen["evicted"] > 0
    assert seen["placed"] >= seen["nominations"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("share", (4.0, 0.55))
def test_quota_storm_rounds_match_reference(backend, share):
    """Every pod in one quota group: with headroom (a min and max of 4x
    the cluster) the reprieve runs; at 0.55 of the cluster the group is
    over its runtime and nothing is reprieved. Mixed resident priorities and a
    non-preemptible resident per node make the victim sets differ."""
    extra = [dict(name=f"x{i}", node=f"storm-n{i}", cpu=1000, mem=2048,
                  prio=[50, 7000, 300][i % 3], preemptible=i % 2 == 0,
                  at=float(i)) for i in range(8)]
    ref, port = _pair(backend, 5, quota="q", quota_share=share, rpn=3,
                      extra_residents=extra)
    seen = _same_rounds(ref, port, rounds=5)
    assert seen["nominations"] > 0


@pytest.mark.parametrize("seed", (3, 11))
def test_quota_post_filter_matches_reference(seed):
    """ElasticQuota's PostFilter with the group's runtime quota as its
    limit (the default) and with its max: on a group whose runtime lies
    below its max, ``quota_rows`` and ``post_filter`` equal the JAX
    plugin's for every arrival, and the two limits choose differently."""
    ref, port = _pair("host", seed, quota="q")
    for sched, types, resource in ((ref, jtypes, JResourceName),
                                   (port, ttypes, TResourceName)):
        sched.update_quota(types.QuotaSpec(
            name="q", min={resource.CPU: 30000, resource.MEMORY: 100000},
            max={resource.CPU: 10**6, resource.MEMORY: 10**7}))
    answers = {}
    for runtime in (True, False):
        jplugin = JElasticQuotaPlugin(ref.quota_registry,
                                      enable_runtime_quota=runtime)
        tplugin = ElasticQuotaPlugin(port.quota_registry,
                                     enable_runtime_quota=runtime)
        jsnap, tsnap = ref.cache.snapshot(now=100.0), port.cache.snapshot(
            now=100.0)
        answers[runtime] = []
        for uid, jpod in ref.cache.pending.items():
            tpod = port.cache.pending[uid]
            for got, want in zip(tplugin.quota_rows(tpod),
                                 jplugin.quota_rows(jpod)):
                np.testing.assert_array_equal(got, want)
            want = jplugin.post_filter(None, jsnap, jpod)
            got = tplugin.post_filter(None, tsnap, tpod)
            assert (got is None) == (want is None), uid
            if got is not None:
                got, want = [(a[0], [v.uid for v in a[1]])
                             for a in (got, want)]
            assert got == want, uid
            answers[runtime].append(got)
    assert answers[True] != answers[False]


def test_default_scheduler_preempts():
    """The reference's defaults: a full cluster's high-priority pod
    evicts the lower-priority pods of its quota group, is nominated, and
    binds the next round."""
    sched = Scheduler(model=PlacementModel(device="cpu"))
    assert sched.preemption_backend == "device"
    assert sched._quota_plugin.enable_preemption
    assert sched.MAX_PREEMPTIONS_PER_ROUND == 32
    sched.add_node(ttypes.NodeSpec(name="n0", allocatable={
        TResourceName.CPU: 10000, TResourceName.MEMORY: 32768}))
    sched.add_pod(ttypes.PodSpec(name="low", priority=10, requests={
        TResourceName.CPU: 8000}))
    assert sched.schedule_pending(now=100.0)["default/low"] == "n0"
    sched.add_pod(ttypes.PodSpec(name="high", priority=100, requests={
        TResourceName.CPU: 8000}))
    out = sched.schedule_pending(now=101.0)
    assert out["default/high"] is None
    assert out.nominations == {"default/high": "n0"}
    assert "default/low" not in sched.cache.pods
    assert sched.schedule_pending(now=102.0)["default/high"] == "n0"


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="preemption_backend"):
        Scheduler(model=PlacementModel(device="cpu"),
                  preemption_backend="gpu")


def test_the_round_caps_its_preemptors():
    """At most ``MAX_PREEMPTIONS_PER_ROUND`` preemptors per round, as the
    reference (a storm of more arrivals than the cap)."""
    ref, port = _pair("device", 7, n_nodes=12, rpn=2, n_arrivals=20)
    port.MAX_PREEMPTIONS_PER_ROUND = ref.MAX_PREEMPTIONS_PER_ROUND = 5
    seen = _same_rounds(ref, port, rounds=1)
    assert seen["nominations"] == 5


def test_delta_staging_after_preemption_equals_a_fresh_staging():
    """The evictions of a preemption round mark their nodes (``remove_pod``
    through ``_evict_victims``), so the next round's delta staging equals
    a fresh lowering of its snapshot."""
    _, port = _pair("device", 3)
    fresh = []
    dispatch = port.model.schedule_async

    def record(snap):
        fresh.append(port.model.stage_nodes(
            lower_nodes(snap, **port.model.lowering_kwargs())))
        return dispatch(snap)

    port.model.schedule_async = record
    first = port.schedule_pending(now=100.0)
    assert first.nominations
    port.schedule_pending(now=101.0)
    assert port.model.last_staging == "delta"
    state = port.model.staged_cache.state
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(fresh[-1], f)), f


@pytest.mark.parametrize("backend", BACKENDS)
def test_defrag_headroom_matches_reference(backend):
    """``defrag_headroom`` plans the same drain as the JAX Scheduler, and
    with ``apply=True`` evicts it; a hole that already fits plans None."""
    ref, port = _pair(backend, 11, n_arrivals=0)
    target = np.zeros(len(jtypes.resources_to_vector({})), np.int64)
    target[CPU], target[MEM] = 8000, 24576
    for apply in (False, True):
        want = ref.defrag_headroom(target, 5000, apply=apply, now=50.0)
        got = port.defrag_headroom(target, 5000, apply=apply, now=50.0)
        assert got == want, apply
        assert got is not None and got[1]
        assert set(port.cache.pods) == set(ref.cache.pods)
    # the drained node now has the hole: nothing left to drain
    assert port.defrag_headroom(target, 5000, now=50.0) is None
    assert ref.defrag_headroom(target, 5000, now=50.0) is None


def test_evictions_go_through_the_sink():
    """With ``evict_pod_fn`` set, each victim goes to it (a bus deletion
    that re-enters ``remove_pod``), and the round equals the local one."""
    ref, port = _pair("device", 3)
    sunk = []

    def sink(pod):
        sunk.append(pod.uid)
        port.remove_pod(pod)

    port.evict_pod_fn = sink
    seen = _same_rounds(ref, port, rounds=2)
    assert len(sunk) == seen["evicted"] > 0


def test_disabled_preemption_nominates_nothing():
    ref, port = _pair("device", 3)
    port._quota_plugin.enable_preemption = False
    ref._quota_plugin.enable_preemption = False
    seen = _same_rounds(ref, port, rounds=2)
    assert seen["nominations"] == seen["evicted"] == 0
