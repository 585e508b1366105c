"""Seeded synthetic problems for the port's tests and ``chip_smoke.py``
(counterpart of ``koordinator_tpu/testing/__init__.py``).

Every builder draws from ``numpy.random.default_rng(seed)`` in a fixed
order, so the same seed gives the same problem in both packages: the
``*_arrays`` builders return plain numpy (the reference's NamedTuples as
dicts, or ``build`` keyword arguments) that either package can take.
"""

from __future__ import annotations

import numpy as np

from koordinator_tpu_torch import DeviceLike, convert, resolve_device
from koordinator_tpu_torch.apis.extension import NUM_RESOURCES, ResourceName
from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    GangMode,
    GangSpec,
    NodeMetric,
    NodeSpec,
    PodSpec,
    QuotaSpec,
)
from koordinator_tpu_torch.ops.gang import GangState
from koordinator_tpu_torch.ops.quota import QuotaState

CPU, MEM = ResourceName.CPU, ResourceName.MEMORY


def example_problem_arrays(n_nodes, n_pods, seed=0):
    """The standard random placement problem as numpy dicts (node state,
    pod batch, score params): mixed node sizes, 0-50% ambient usage,
    cpu+memory thresholds. Draws exactly as the reference's
    ``testing.example_problem``."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n_nodes, NUM_RESOURCES), dtype=np.int32)
    alloc[:, CPU] = rng.choice([16000, 32000, 64000], n_nodes)
    alloc[:, MEM] = rng.choice([32768, 65536], n_nodes)
    usage = (alloc * rng.uniform(0, 0.5, alloc.shape)).astype(np.int32)
    nodes = dict(
        alloc=alloc, used_req=np.zeros_like(alloc), usage=usage,
        prod_usage=usage // 2, est_extra=np.zeros_like(alloc),
        prod_base=usage // 2, metric_fresh=np.ones(n_nodes, bool),
        schedulable=np.ones(n_nodes, bool),
    )
    req = np.zeros((n_pods, NUM_RESOURCES), dtype=np.int32)
    req[:, CPU] = rng.choice([500, 1000, 2000], n_pods)
    req[:, MEM] = rng.choice([1024, 2048], n_pods)
    pods = dict(
        req=req, est=(req * 85) // 100,
        is_prod=rng.uniform(size=n_pods) < 0.5,
        is_daemonset=np.zeros(n_pods, bool),
        quota_id=np.full(n_pods, -1, np.int32),
        non_preemptible=np.zeros(n_pods, bool),
        gang_id=np.full(n_pods, -1, np.int32),
        blocked=np.zeros(n_pods, bool),
    )
    weights = np.zeros(NUM_RESOURCES, dtype=np.int32)
    weights[[CPU, MEM]] = 1
    thresholds = np.zeros(NUM_RESOURCES, dtype=np.int32)
    thresholds[CPU], thresholds[MEM] = 65, 95
    params = dict(weights=weights, thresholds=thresholds,
                  prod_thresholds=np.zeros(NUM_RESOURCES, np.int32))
    return nodes, pods, params


def example_problem(n_nodes, n_pods, seed=0, device: DeviceLike = None):
    """:func:`example_problem_arrays` as the port's (NodeState, PodBatch,
    ScoreParams) on ``device``."""
    device = resolve_device(device)
    nodes, pods, params = example_problem_arrays(n_nodes, n_pods, seed)
    return (convert.node_state(nodes, device), convert.pod_batch(pods, device),
            convert.score_params(params, device))


def quota_gang_arrays(n_nodes, n_quota_pods, n_quota, n_gangs, gang_size,
                      seed=0):
    """ElasticQuota + Coscheduling on the example problem: ``n_quota_pods``
    pods plus ``n_gangs * gang_size`` gang members at random positions,
    every pod in one of ``n_quota`` groups (a few in none), 30%
    non-preemptible; group max at a third of an equal share of the
    cluster so admission rejects mid-batch; gangs 60% Strict with min
    member 0-1 below their size, paired into gang groups.

    Returns ``(nodes, pods, params, quota_kwargs, gang_kwargs)``: numpy
    dicts, the last two for ``QuotaState.build``/``GangState.build``."""
    n_gang_pods = n_gangs * gang_size
    n_pods = n_quota_pods + n_gang_pods
    nodes, pods, params = example_problem_arrays(n_nodes, n_pods, seed)
    rng = np.random.default_rng(seed + 1)
    quota_id = rng.integers(-1, n_quota, n_pods).astype(np.int32)
    gang_id = np.full(n_pods, -1, np.int32)
    gang_id[rng.permutation(n_pods)[:n_gang_pods]] = np.repeat(
        np.arange(n_gangs, dtype=np.int32), gang_size)
    pods.update(quota_id=quota_id, gang_id=gang_id,
                non_preemptible=rng.uniform(size=n_pods) < 0.3)
    total = nodes["alloc"].astype(np.int64).sum(axis=0)
    mn = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    mx = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    for r in (CPU, MEM):
        mn[:, r] = total[r] // (12 * n_quota)
        mx[:, r] = total[r] // (3 * n_quota)
    child_request = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    managed = quota_id >= 0
    np.add.at(child_request, quota_id[managed],
              pods["req"][managed].astype(np.int64))
    quota = dict(min=mn, max=mx, weight=mx, allow_lent=np.ones(n_quota, bool),
                 total=total, child_request=child_request)
    gang = dict(
        min_member=gang_size - rng.integers(0, 2, n_gangs),
        bound_count=np.zeros(n_gangs, np.int32),
        strict=rng.uniform(size=n_gangs) < 0.6,
        group_id=[f"grp{g // 2}" for g in range(n_gangs)],
    )
    return nodes, pods, params, quota, gang


def quota_gang_problem(n_nodes, n_quota_pods, n_quota, n_gangs, gang_size,
                       seed=0, device: DeviceLike = None):
    """:func:`quota_gang_arrays` as the port's (NodeState, PodBatch,
    ScoreParams, QuotaState, GangState) on ``device``."""
    device = resolve_device(device)
    nodes, pods, params, quota, gang = quota_gang_arrays(
        n_nodes, n_quota_pods, n_quota, n_gangs, gang_size, seed)
    return (convert.node_state(nodes, device), convert.pod_batch(pods, device),
            convert.score_params(params, device),
            QuotaState.build(**quota, device=device),
            GangState.build(**gang, device=device))


def churn_world(n_nodes, *, assigned_per_node=2, seed=42) -> ClusterSnapshot:
    """The typed churn world: ``n_nodes`` uniform nodes, ``assigned_per_node
    * n_nodes`` randomly bound pods, a metric on every node at t=10, the
    snapshot at now=20. Draws as the reference's ``testing.churn_world``."""
    rng = np.random.default_rng(seed)
    nodes = [
        NodeSpec(name=f"n{i}", allocatable={CPU: 64000, MEM: 131072})
        for i in range(n_nodes)
    ]
    pods = []
    for j in range(assigned_per_node * n_nodes):
        node_i = int(rng.integers(0, n_nodes))
        pods.append(PodSpec(
            name=f"a{j}", node_name=f"n{node_i}", assign_time=5.0,
            requests={CPU: int(rng.integers(200, 2000)),
                      MEM: int(rng.integers(128, 2048))},
        ))
    metrics = {
        f"n{i}": NodeMetric(
            node_name=f"n{i}",
            node_usage={CPU: int(rng.integers(500, 30000)),
                        MEM: int(rng.integers(512, 65536))},
            update_time=10.0,
        )
        for i in range(n_nodes)
    }
    return ClusterSnapshot(nodes=nodes, pods=pods, pending_pods=[],
                           node_metrics=metrics, now=20.0)


def add_pending_wave(snap: ClusterSnapshot, n_pods, *, n_quota, n_gangs,
                     gang_size, seed=7) -> ClusterSnapshot:
    """Put a pending wave into ``snap``: ``n_pods`` pods in ``n_quota``
    root-level quota groups, ``n_gangs * gang_size`` of them members of
    gangs (Strict and NonStrict mixed, min member 0-2 below size), 10%
    non-preemptible, three priority levels. Group max is drawn around an
    equal share of the wave's demand, so some groups bind."""
    rng = np.random.default_rng(seed)
    mean_cpu, mean_mem = 850, 576   # of the request draws below
    share_cpu = n_pods * mean_cpu // n_quota
    share_mem = n_pods * mean_mem // n_quota
    snap.quotas = {}
    for k in range(n_quota):
        max_cpu = int(share_cpu * rng.uniform(0.7, 1.4))
        max_mem = int(share_mem * rng.uniform(0.7, 1.4))
        snap.quotas[f"q{k}"] = QuotaSpec(
            name=f"q{k}", parent="root",
            min={CPU: max_cpu // 4, MEM: max_mem // 4},
            max={CPU: max_cpu, MEM: max_mem},
        )
    snap.gangs = {
        f"g{k}": GangSpec(
            name=f"g{k}", min_member=gang_size - int(rng.integers(0, 3)),
            mode=GangMode.STRICT if rng.uniform() < 0.5 else GangMode.NON_STRICT,
        )
        for k in range(n_gangs)
    }
    gang_of = np.full(n_pods, -1)
    gang_of[rng.permutation(n_pods)[:n_gangs * gang_size]] = np.repeat(
        np.arange(n_gangs), gang_size)
    snap.pending_pods = [
        PodSpec(
            name=f"w{j}",
            requests={CPU: int(rng.integers(200, 1500)),
                      MEM: int(rng.integers(128, 1024))},
            priority=int(rng.integers(0, 3)),
            quota=f"q{int(rng.integers(0, n_quota))}",
            gang=f"g{gang_of[j]}" if gang_of[j] >= 0 else None,
            preemptible=bool(rng.uniform() >= 0.1),
        )
        for j in range(n_pods)
    ]
    return snap


def mixed_snapshot_spec(seed=0, n_nodes=40, n_assigned=60, n_pending=120,
                        selectors=False):
    """A seeded snapshot as plain data, for building the same snapshot
    with either package's types (:func:`build_snapshot`). It carries what
    lowering and placement branch on: fresh, stale and missing metrics,
    reported and unreported pod usage inside and outside the report
    interval, prod/mid/batch pods, limits above requests, zero requests,
    an unschedulable node, DaemonSet and non-preemptible pods, a
    two-level quota tree plus a root-level group, Strict and NonStrict
    gangs in a gang group, members already bound, and a pod of an
    unknown gang. ``selectors`` adds node-selector and host-port pods."""
    rng = np.random.default_rng(seed)
    now = 1000.0
    nodes = [
        dict(name=f"n{i}",
             alloc={int(CPU): int(rng.choice([8000, 16000, 32000])),
                    int(MEM): int(rng.choice([16384, 32768])),
                    int(ResourceName.BATCH_CPU): 6000,
                    int(ResourceName.BATCH_MEMORY): 8192},
             labels={"zone": "a" if i % 3 else "b"},
             unschedulable=i == 1)
        for i in range(n_nodes)
    ]
    priorities = [0, 9500, 7500, 5500]   # none, prod, mid, batch

    def pod(name, **kw):
        prio = int(rng.choice(priorities))
        cpu, mem = int(rng.integers(0, 3000)), int(rng.integers(0, 3000))
        req = {int(CPU): cpu, int(MEM): mem}
        if prio == 5500:
            req = {int(ResourceName.BATCH_CPU): cpu,
                   int(ResourceName.BATCH_MEMORY): mem}
        lim = {k: v * 2 for k, v in req.items()} if rng.uniform() < 0.3 else {}
        return dict(name=name, requests=req, limits=lim, priority=prio,
                    sub_priority=int(rng.integers(0, 3)), **kw)

    assigned = []
    for j in range(n_assigned):
        node = f"n{int(rng.integers(0, n_nodes))}"
        assigned.append(pod(
            f"a{j}", node_name=node,
            assign_time=float(rng.choice([100.0, 950.0, 990.0])),
            gang="g0" if j < 3 else None))
    metrics = []
    for i in range(n_nodes):
        if i == 2:
            continue  # no metric
        name = f"n{i}"
        usages = {
            f"default/{p['name']}": {int(CPU): int(rng.integers(0, 2500)),
                                     int(MEM): int(rng.integers(0, 2500))}
            for p in assigned
            if p["node_name"] == name and rng.uniform() < 0.6
        }
        metrics.append(dict(
            node_name=name,
            node_usage={int(CPU): int(rng.integers(0, 9000)),
                        int(MEM): int(rng.integers(0, 16000))},
            pod_usages=usages,
            update_time=now - (5000.0 if i == 3 else 60.0),  # n3 is stale
            report_interval=60.0,
        ))
    quotas = [
        dict(name="team", parent="root", is_parent=True,
             min={int(CPU): 20000, int(MEM): 20000},
             max={int(CPU): 60000, int(MEM): 60000}),
        dict(name="team-x", parent="team",
             min={int(CPU): 8000, int(MEM): 8000},
             max={int(CPU): 30000, int(MEM): 40000}),
        dict(name="team-y", parent="team", allow_lent_resource=False,
             min={int(CPU): 6000, int(MEM): 6000},
             max={int(CPU): 25000, int(MEM): 40000}),
        dict(name="solo", parent="root",
             min={int(CPU): 4000, int(MEM): 4000},
             max={int(CPU): 15000, int(MEM): 15000}),
    ]
    gangs = [
        dict(name="g0", min_member=8, mode="Strict"),
        dict(name="g1", min_member=6, mode="NonStrict", gang_group=["g1", "g2"]),
        dict(name="g2", min_member=30, mode="Strict", gang_group=["g1", "g2"]),
        dict(name="g3", min_member=10, mode="NonStrict"),
    ]
    gang_choices = [None] * 6 + ["g0", "g1", "g2", "g3", "ghost"]
    quota_choices = [None, "team-x", "team-y", "solo"]
    pending = []
    for j in range(n_pending):
        extra = {}
        if selectors and j % 9 == 0:
            extra["node_selector"] = {"zone": "b"}
        if selectors and j % 13 == 0:
            extra["host_ports"] = [8080] if j % 2 else ["udp:53"]
        pending.append(pod(
            f"p{j}",
            quota=quota_choices[int(rng.integers(0, 4))],
            gang=gang_choices[int(rng.integers(0, len(gang_choices)))],
            is_daemonset=bool(rng.uniform() < 0.1),
            preemptible=bool(rng.uniform() >= 0.2),
            **extra,
        ))
    return dict(now=now, nodes=nodes, assigned=assigned, pending=pending,
                metrics=metrics, quotas=quotas, gangs=gangs)


def build_snapshot(spec, types, resource_name):
    """A ``types.ClusterSnapshot`` from :func:`mixed_snapshot_spec` data;
    ``types`` is either package's ``apis.types`` module and
    ``resource_name`` its ``ResourceName``."""
    def res(d):
        return {resource_name(k): v for k, v in d.items()}

    def pod(d):
        d = dict(d)
        d["requests"], d["limits"] = res(d["requests"]), res(d["limits"])
        return types.PodSpec(**d)

    return types.ClusterSnapshot(
        nodes=[types.NodeSpec(name=n["name"], allocatable=res(n["alloc"]),
                              labels=dict(n["labels"]),
                              unschedulable=n["unschedulable"])
               for n in spec["nodes"]],
        pods=[pod(p) for p in spec["assigned"]],
        pending_pods=[pod(p) for p in spec["pending"]],
        node_metrics={
            m["node_name"]: types.NodeMetric(
                node_name=m["node_name"], node_usage=res(m["node_usage"]),
                pod_usages={u: res(v) for u, v in m["pod_usages"].items()},
                update_time=m["update_time"],
                report_interval=m["report_interval"])
            for m in spec["metrics"]
        },
        gangs={
            g["name"]: types.GangSpec(
                name=g["name"], min_member=g["min_member"],
                mode=types.GangMode(g["mode"]),
                gang_group=list(g.get("gang_group", [])))
            for g in spec["gangs"]
        },
        quotas={
            q["name"]: types.QuotaSpec(
                **{**q, "min": res(q["min"]), "max": res(q["max"])})
            for q in spec["quotas"]
        },
        now=spec["now"],
    )
