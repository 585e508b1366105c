"""Seeded synthetic problems for the port's tests and ``chip_smoke.py``
(counterpart of ``koordinator_tpu/testing/__init__.py``).

Every builder draws from ``numpy.random.default_rng(seed)`` in a fixed
order, so the same seed gives the same problem in both packages: the
``*_arrays`` builders return plain numpy (the reference's NamedTuples as
dicts, or ``build`` keyword arguments) that either package can take.
:func:`preemption_storm` draws from ``random.Random(seed)``, as its
counterpart in ``koordinator_tpu/testing/chaos.py`` does.
"""

from __future__ import annotations

import copy
import random
from typing import Sequence

import numpy as np

from koordinator_tpu_torch import DeviceLike, convert, resolve_device
from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_CPU_NORMALIZATION_RATIO,
    ANNOTATION_NODE_RESERVATION,
    NUM_RESOURCES,
    PriorityClass,
    QoSClass,
    ResourceName,
)
from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    GangMode,
    GangSpec,
    NodeMetric,
    NodeSpec,
    PodSpec,
    QuotaSpec,
    ReservationSpec,
    ReservationState,
)
from koordinator_tpu_torch.ops.binpack import NumaAux
from koordinator_tpu_torch.ops.gang import GangState
from koordinator_tpu_torch.ops.quota import QuotaState
from koordinator_tpu_torch.state.cluster import ClusterDeltaTracker
from koordinator_tpu_torch.testing.plugin_chain import (
    set_aggregated,
    typed_aggregated,
)

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


def resv_table_arrays(n_nodes, n_pods, n_resv, seed=8, once_frac=0.4,
                      match_frac=0.25):
    """A reservation table over an example problem, as a
    ``ResvArrays`` dict: reservations on random nodes, free remainders
    of 500-100,000 m CPU (big enough that the credit flips fit
    decisions) and 0-8,191 MiB, random owner matches, ``allocate_once``
    mixed in. Draws as the reference's kernel tests do."""
    rng = np.random.default_rng(seed)
    node = rng.integers(0, n_nodes, n_resv).astype(np.int32)
    free = np.zeros((n_resv, NUM_RESOURCES), np.int32)
    free[:, CPU] = rng.integers(500, 100001, n_resv)
    free[:, MEM] = rng.integers(0, 8192, n_resv)
    match = rng.uniform(size=(n_pods, n_resv)) < match_frac
    return dict(node=node, free=free,
                allocate_once=rng.uniform(size=n_resv) < once_frac,
                match=match)


def numa_arrays(alloc, n_pods, seed=7):
    """NUMA inventories over a node table: capacity = allocatable, free a
    random 30-100% of it (never above it), 40% of pods and half the
    nodes declaring a topology policy. Returns ``(numa_cap, numa_free,
    has_numa_policy, node_policy)``; draws as the reference's kernel
    tests do."""
    rng = np.random.default_rng(seed)
    cap = np.asarray(alloc)
    free = (cap * rng.uniform(0.3, 1.0, cap.shape)).astype(np.int32)
    has_policy = rng.uniform(size=n_pods) < 0.4
    node_policy = rng.uniform(size=cap.shape[0]) < 0.5
    return cap, free, has_policy, node_policy


def extras_arrays(n_nodes, n_pods, *, selector_frac=0.2, scored_frac=0.05,
                  deferred_frac=0.0, n_zones=4, seed=13):
    """Compact host extras rows as the model builds them: node-selector
    pods share one mask row per zone (``n_zones`` zones drawn over the
    nodes), fine-grained pods have their own row (a 60% mask and a
    DeviceShare-style score in [0, 100]), and deferred host-port
    claimants share an all-False row. Returns ``(row_of_pod [P] int32,
    mask [X,N] bool, score [X,N] int32)``; the other pods read -1."""
    rng = np.random.default_rng(seed)
    zone = rng.integers(0, n_zones, n_nodes)
    masks = [zone == z for z in range(n_zones)]
    scores = [np.zeros(n_nodes, np.int32) for _ in range(n_zones)]
    row = np.full(n_pods, -1, np.int32)
    draw = rng.uniform(size=n_pods)
    sel = draw < selector_frac
    row[sel] = rng.integers(0, n_zones, int(sel.sum()))
    fine = (draw >= selector_frac) & (draw < selector_frac + scored_frac)
    for p in np.flatnonzero(fine):
        mask = rng.uniform(size=n_nodes) < 0.6
        masks.append(mask)
        scores.append(np.where(mask, rng.integers(0, 101, n_nodes),
                               0).astype(np.int32))
        row[p] = len(masks) - 1
    lo = selector_frac + scored_frac
    deferred = (draw >= lo) & (draw < lo + deferred_frac)
    if deferred.any():
        masks.append(np.zeros(n_nodes, bool))
        scores.append(np.zeros(n_nodes, np.int32))
        row[deferred] = len(masks) - 1
    return row, np.stack(masks), np.stack(scores)


def dense_extras(row_of_pod, mask, score):
    """:func:`extras_arrays`' rows as the reference's dense ``[P,N]``
    ``(mask, score)``."""
    has = row_of_pod >= 0
    idx = np.maximum(row_of_pod, 0)
    return (np.where(has[:, None], mask[idx], True),
            np.where(has[:, None], score[idx], 0).astype(np.int32))


def full_features_arrays(n_nodes, n_pods, seed=8):
    """The reference's bench config #8 (``bench_full_features``) at its own
    shape: quota admission (50 groups), Strict gangs (up to 100 x 16, at
    most a quarter of the pods, members sharing their gang's request),
    NUMA inventories on every node (half declaring a policy, 40% of pods
    carrying one) and reservations (one per gang, up to 64, owned by the
    gang's members) fused into one solve. Draws as the bench does.

    Returns ``(nodes, pods, params, quota_kwargs, gang_kwargs, resv,
    node_policy)``: numpy dicts (``nodes``/``pods`` with their NUMA
    columns), ``QuotaState.build``/``GangState.build`` arguments, a
    ``ResvArrays`` dict and the ``NumaAux`` node policy."""
    members, n_quota = 16, 50
    n_gangs = min(100, max(1, n_pods // (4 * members)))
    n_resv = min(64, n_gangs)
    nodes, pods, params = example_problem_arrays(n_nodes, n_pods, seed)
    rng = np.random.default_rng(seed)
    cap = nodes["alloc"]
    nodes["numa_cap"] = cap
    nodes["numa_free"] = (cap * rng.uniform(0.3, 1.0, cap.shape)).astype(
        np.int32)
    node_policy = rng.uniform(size=n_nodes) < 0.5
    gang_id = np.full(n_pods, -1, np.int32)
    gang_id[:n_gangs * members] = np.repeat(
        np.arange(n_gangs, dtype=np.int32), members)
    req, est = pods["req"].copy(), pods["est"].copy()
    for g in range(n_gangs):
        lo = g * members
        req[lo:lo + members] = req[lo]
        est[lo:lo + members] = est[lo]
    node_of = rng.integers(0, n_nodes, n_resv).astype(np.int32)
    rfree = np.zeros((n_resv, NUM_RESOURCES), np.int32)
    rfree[:, CPU] = rng.integers(500, 4000, n_resv)
    rfree[:, MEM] = rng.integers(500, 4000, n_resv)
    match = np.zeros((n_pods, n_resv), bool)
    for v in range(n_resv):
        match[v * members:(v + 1) * members, v] = True
    resv = dict(node=node_of, free=rfree,
                allocate_once=rng.uniform(size=n_resv) < 0.5, match=match)
    qid = rng.integers(0, n_quota, n_pods).astype(np.int32)
    total = cap.astype(np.int64).sum(axis=0)
    mn = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    mx = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    for r in (CPU, MEM):
        mn[:, r] = total[r] // (2 * n_quota)
        mx[:, r] = total[r] // 8
    child_request = np.zeros((n_quota, NUM_RESOURCES), np.int64)
    np.add.at(child_request, qid, req.astype(np.int64))
    quota = dict(min=mn, max=mx, weight=mx, allow_lent=np.ones(n_quota, bool),
                 total=total, child_request=child_request)
    gang = dict(min_member=[members] * n_gangs)
    pods.update(req=req, est=est, quota_id=qid,
                non_preemptible=rng.uniform(size=n_pods) < 0.3,
                gang_id=gang_id,
                has_numa_policy=rng.uniform(size=n_pods) < 0.4)
    return nodes, pods, params, quota, gang, resv, node_policy


def full_features_problem(n_nodes, n_pods, seed=8, device: DeviceLike = None):
    """:func:`full_features_arrays` as the port's ``(NodeState, PodBatch,
    ScoreParams, QuotaState, GangState, ResvArrays, NumaAux)`` on
    ``device``."""
    device = resolve_device(device)
    nodes, pods, params, quota, gang, resv, node_policy = full_features_arrays(
        n_nodes, n_pods, seed)
    return (convert.node_state(nodes, device), convert.pod_batch(pods, device),
            convert.score_params(params, device),
            QuotaState.build(**quota, device=device),
            GangState.build(**gang, device=device),
            convert.resv_arrays(resv, device),
            convert.numa_aux(dict(node_policy=node_policy), device))


def churn_world(n_nodes, *, assigned_per_node=2, seed=42,
                with_tracker=False):
    """The typed churn world: ``n_nodes`` uniform nodes, ``assigned_per_node
    * n_nodes`` randomly bound pods, a metric on every node at t=10, the
    snapshot at now=20, with a ``ClusterDeltaTracker`` when
    ``with_tracker``. Returns ``(snapshot, tracker)``. Draws as the
    reference's ``testing.churn_world``."""
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
    tracker = ClusterDeltaTracker() if with_tracker else None
    snap = ClusterSnapshot(nodes=nodes, pods=pods, pending_pods=[],
                           node_metrics=metrics, now=20.0,
                           delta_tracker=tracker)
    return snap, tracker


def churn_tick_events(snap, tracker, rng, *, dirty, pending, t, now):
    """One churn tick's events, applied to ``snap`` in place: ``dirty``
    random nodes get a fresh metric (pod usages kept, ``tracker`` marked)
    and a ``pending``-pod wave replaces ``snap.pending_pods``; ``snap.now``
    moves to ``now``. Returns ``{uid: pod}`` of the wave. The rng draw
    order is the reference's ``testing.churn_tick_events``, so a seed
    gives the same ticks in both packages."""
    n_nodes = len(snap.nodes)
    for i in rng.choice(n_nodes, dirty, replace=False):
        name = snap.nodes[int(i)].name
        old = snap.node_metrics[name]
        snap.node_metrics[name] = NodeMetric(
            node_name=name,
            node_usage={CPU: int(rng.integers(500, 30000)),
                        MEM: int(rng.integers(512, 65536))},
            update_time=now,
            pod_usages=old.pod_usages,
        )
        if tracker is not None:
            tracker.mark_node(name)
    snap.pending_pods = [
        PodSpec(
            name=f"t{t}p{j}",
            requests={CPU: int(rng.integers(200, 1500)),
                      MEM: int(rng.integers(128, 1024))},
        )
        for j in range(pending)
    ]
    snap.now = now
    return {p.uid: p for p in snap.pending_pods}


def fold_churn_binds(snap, tracker, result, by_uid, now):
    """Fold one tick's committed placements back into ``snap``: the
    placed pods become assigned pods (``tracker`` marked per node)."""
    for uid, node in result.items():
        if node is not None:
            pod = by_uid[uid]
            pod.node_name = node
            pod.assign_time = now
            snap.pods.append(pod)
            if tracker is not None:
                tracker.mark_node(node)


def feed_scheduler(scheduler, snap: ClusterSnapshot) -> None:
    """Feed a copy of ``snap``'s contents into a ``Scheduler`` through
    its intake methods, in the order an informer would deliver them:
    nodes, metrics, quotas, gangs and reservations before the pods that
    name them; assigned pods, then pending pods in snapshot order (the
    cache keeps insertion order, so the scheduler's snapshots list them
    as ``snap`` does). Copies, so schedulers fed the same snapshot share
    no object."""
    for node in snap.nodes:
        scheduler.add_node(copy.deepcopy(node))
    for metric in snap.node_metrics.values():
        scheduler.update_node_metric(copy.deepcopy(metric))
    for quota in snap.quotas.values():
        scheduler.update_quota(copy.deepcopy(quota))
    for gang in snap.gangs.values():
        scheduler.update_gang(copy.deepcopy(gang))
    for resv in snap.reservations:
        scheduler.update_reservation(copy.deepcopy(resv))
    for pod in list(snap.pods) + list(snap.pending_pods):
        scheduler.add_pod(copy.deepcopy(pod))


def feed_churn_tick(schedulers, snap, rng, *, dirty, pending, t, now,
                    aggregated_rng=None):
    """One churn tick (:func:`churn_tick_events` on the source ``snap``),
    fed into every scheduler of ``schedulers`` as intake events: the
    fresh metrics and the pending wave, copied per scheduler. Binds are
    not folded into ``snap``: each scheduler assumes its own. With
    ``aggregated_rng`` every fresh metric first gets seeded percentiles
    from it (``plugin_chain.set_aggregated``; ``rng``'s draws stay the
    reference's)."""
    before = dict(snap.node_metrics)
    by_uid = churn_tick_events(snap, None, rng, dirty=dirty,
                               pending=pending, t=t, now=now)
    fresh = [m for name, m in snap.node_metrics.items()
             if m is not before.get(name)]
    if aggregated_rng is not None:
        for metric in fresh:
            set_aggregated(metric, aggregated_rng)
    for scheduler in schedulers:
        for metric in fresh:
            scheduler.update_node_metric(copy.deepcopy(metric))
        for pod in by_uid.values():
            scheduler.add_pod(copy.deepcopy(pod))
    return by_uid


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


def add_fine_grained(snap: ClusterSnapshot, *, n_cpuset, n_gpu, n_ports,
                     n_selector, n_distinct_ports=20, topology_every=4,
                     gpu_every=10, n_zones=4, node_policy="", seed=17):
    """Make the fine-grained manager's work out of a snapshot with a
    pending wave (:func:`add_pending_wave`), in place:
    - every node gets a ``zone`` label, ``z<i % n_zones>``;
    - every ``topology_every``-th node a NUMA topology: 2 sockets x 1
      NUMA node x 16 cores x 2 threads = 64 CPUs (the churn world's
      64,000 mCPU), 32,000 mCPU and 65,536 MiB per NUMA node, node
      policy ``node_policy``;
    - every ``gpu_every``-th node 8 GPUs (gpu-core 100, gpu-memory
      16,384, gpu-memory-ratio 100), 4 on each NUMA node;
    - of the pending pods, by one seeded permutation: ``n_cpuset`` LSR
      pods asking 2-8 whole CPUs (a cpuset), ``n_gpu`` asking 1-2
      ``nvidia.com/gpu``, ``n_ports`` claiming one host port of
      ``n_distinct_ports``, ``n_selector`` with a required ``zone``
      selector.
    Returns ``(topologies, devices)``: the ``TopologyOptions`` and the
    ``DeviceEntry`` lists by node name, for ``update_node_topology`` and
    ``update_node_devices`` (:func:`feed_fine_grained`)."""
    from koordinator_tpu_torch.device.cache import (
        DeviceEntry,
        DeviceResourceName,
        DeviceType,
    )
    from koordinator_tpu_torch.numa.hints import NUMATopologyPolicy
    from koordinator_tpu_torch.numa.manager import TopologyOptions
    from koordinator_tpu_torch.numa.topology import CPUTopology

    rng = np.random.default_rng(seed)
    topologies, devices = {}, {}
    gpu = {DeviceResourceName.GPU_CORE: 100,
           DeviceResourceName.GPU_MEMORY: 16384,
           DeviceResourceName.GPU_MEMORY_RATIO: 100}
    for i, node in enumerate(snap.nodes):
        node.labels["zone"] = f"z{i % n_zones}"
        if i % topology_every == 0:
            topologies[node.name] = TopologyOptions(
                cpu_topology=CPUTopology.build(
                    sockets=2, nodes_per_socket=1, cores_per_node=16,
                    threads_per_core=2),
                policy=NUMATopologyPolicy(node_policy),
                numa_node_resources={k: {CPU: 32000, MEM: 65536}
                                     for k in (0, 1)})
        if i % gpu_every == 0:
            devices[node.name] = [
                DeviceEntry(minor=k, device_type=DeviceType.GPU,
                            resources=dict(gpu), numa_node=k // 4,
                            pcie_id=str(k // 2))
                for k in range(8)]
    order = rng.permutation(len(snap.pending_pods))
    cuts = np.cumsum([n_cpuset, n_gpu, n_ports, n_selector])
    for k, j in enumerate(order[:cuts[-1]]):
        pod = snap.pending_pods[int(j)]
        if k < cuts[0]:
            pod.qos = QoSClass.LSR
            pod.requests = dict(pod.requests)
            pod.requests[CPU] = 1000 * int(rng.integers(2, 9))
        elif k < cuts[1]:
            pod.device_requests = {"nvidia.com/gpu": int(rng.integers(1, 3))}
        elif k < cuts[2]:
            pod.host_ports = [9000 + int(rng.integers(0, n_distinct_ports))]
        else:
            pod.node_selector = {"zone": f"z{int(rng.integers(0, n_zones))}"}
    return topologies, devices


def feed_fine_grained(scheduler, topologies, devices) -> None:
    """Feed :func:`add_fine_grained`'s topologies and device inventories
    into a ``Scheduler`` (copies, so schedulers share no object)."""
    for name, options in topologies.items():
        scheduler.update_node_topology(name, copy.deepcopy(options))
    for name, entries in devices.items():
        scheduler.update_node_devices(name, copy.deepcopy(entries))


def add_reservations(snap: ClusterSnapshot, n_label, n_migration, *,
                     seed=11) -> ClusterSnapshot:
    """Put ``n_label + n_migration`` Available reservations into a snapshot
    with a pending wave (:func:`add_pending_wave`), each on its own node:
    reservation k < ``n_label`` is owned by label ``gang=g<k>`` (and gang
    g<k>'s pending members get that label); each migration reservation
    names one pending pod outside any gang by uid. Half are
    ``allocate_once``; free remainders are 2,000-16,000 m CPU and
    2,048-16,384 MiB (a quarter of them with part already allocated)."""
    rng = np.random.default_rng(seed)
    n = n_label + n_migration
    nodes = rng.choice(len(snap.nodes), n, replace=False)
    solo = [p for p in snap.pending_pods if p.gang is None]
    owners = rng.choice(len(solo), n_migration, replace=False)
    for pod in snap.pending_pods:
        if pod.gang is not None and int(pod.gang[1:]) < n_label:
            pod.labels["gang"] = pod.gang
    resvs = []
    for k in range(n):
        free = {CPU: int(rng.integers(2000, 16001)),
                MEM: int(rng.integers(2048, 16385))}
        taken = {}
        if rng.uniform() < 0.25:
            taken = {CPU: int(rng.integers(100, 2000)),
                     MEM: int(rng.integers(100, 2000))}
        resvs.append(ReservationSpec(
            name=f"r{k}",
            requests=dict(free),
            allocatable={r: free[r] + taken.get(r, 0) for r in free},
            allocated=taken,
            node_name=snap.nodes[int(nodes[k])].name,
            state=ReservationState.AVAILABLE,
            allocate_once=bool(rng.uniform() < 0.5),
            owner_labels={"gang": f"g{k}"} if k < n_label else {},
            owner_pod_uids=([] if k < n_label
                            else [solo[int(owners[k - n_label])].uid]),
        ))
    snap.reservations = resvs
    return snap


def mixed_snapshot_spec(seed=0, n_nodes=40, n_assigned=60, n_pending=120,
                        selectors=False, reservations=False):
    """A seeded snapshot as plain data, for building the same snapshot
    with either package's types (:func:`build_snapshot`). It carries what
    lowering and placement branch on: fresh, stale and missing metrics,
    reported and unreported pod usage inside and outside the report
    interval, prod/mid/batch pods, limits above requests, zero requests,
    an unschedulable node, DaemonSet and non-preemptible pods, a
    two-level quota tree plus a root-level group, Strict and NonStrict
    gangs in a gang group, members already bound, and a pod of an
    unknown gang. ``selectors`` adds node-selector and host-port pods.
    ``reservations`` adds owner labels to pending pods and a reservation
    table (:func:`_mixed_reservations`)."""
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
    spec = dict(now=now, nodes=nodes, assigned=assigned, pending=pending,
                metrics=metrics, quotas=quotas, gangs=gangs)
    if reservations:
        _mixed_reservations(spec, np.random.default_rng(seed + 100))
    return spec


def _mixed_reservations(spec, rng):
    """Owner labels on pending pods and reservations of every kind
    lowering and matching branch on: label and pod-uid owners, gang
    members as owners (Strict gangs that get rejected give their
    consumption back), two equal reservations on one node matching the
    same pods (the first-max pick), ``allocate_once`` and not, part
    allocated, allocated above allocatable on one resource, fully
    allocated, not Available, unbound, on an unknown node, without
    owners, and a reservation probe pod that must match nothing."""
    pending = spec["pending"]
    for j, p in enumerate(pending):
        labels = {"app": f"a{j % 5}"}
        if p["gang"] in ("g0", "g2"):
            labels["gang"] = p["gang"]
        p["labels"] = labels
    probe = dict(pending[0])
    probe.update(name="probe", uid="__resv__probe", gang=None, quota=None,
                 labels={"app": "a0"})
    pending.append(probe)
    n_nodes = len(spec["nodes"])

    def req():
        return {int(CPU): int(rng.integers(1000, 6000)),
                int(MEM): int(rng.integers(1000, 6000))}

    def resv(name, node, **kw):
        r = req()
        out = dict(name=name, requests=r, allocatable={}, allocated={},
                   node_name=node, state="Available", allocate_once=False,
                   owner_labels={}, owner_pod_uids=[])
        out.update(kw)
        return out

    def node():
        return f"n{int(rng.integers(0, n_nodes))}"

    table = [resv(f"app{k}", node(), owner_labels={"app": f"a{k}"},
                  allocate_once=bool(k % 2)) for k in range(5)]
    twin = req()
    table += [resv("dup0", "n5", requests=dict(twin),
                   owner_labels={"app": "a1"}),
              resv("dup1", "n5", requests=dict(twin),
                   owner_labels={"app": "a1"}, allocate_once=True)]
    table += [
        resv("uid", node(), owner_pod_uids=[f"default/{pending[3]['name']}",
                                            f"default/{pending[7]['name']}"]),
        resv("gang0", node(), owner_labels={"gang": "g0"}),
        resv("gang2", node(), owner_labels={"gang": "g2"},
             allocate_once=True),
        resv("partial", node(), owner_labels={"app": "a2"},
             allocatable={int(CPU): 8000, int(MEM): 8000},
             allocated={int(CPU): 3000}),
        resv("over", node(), owner_labels={"app": "a3"},
             allocatable={int(CPU): 8000, int(MEM): 8000},
             allocated={int(CPU): 9000}),
        resv("full", node(), owner_labels={"app": "a4"},
             allocatable={int(CPU): 2000, int(MEM): 2000},
             allocated={int(CPU): 2000, int(MEM): 2000}),
        resv("pending", node(), owner_labels={"app": "a0"}, state="Pending"),
        resv("succeeded", node(), owner_labels={"app": "a0"},
             state="Succeeded"),
        resv("unbound", None, owner_labels={"app": "a0"}),
        resv("ghost", "n-missing", owner_labels={"app": "a0"}),
        resv("no-owner", node()),
    ]
    spec["reservations"] = table


def build_snapshot(spec, types, resource_name):
    """A ``types.ClusterSnapshot`` from :func:`mixed_snapshot_spec` data
    (or a rebalance world's: :func:`rebalance_world_spec`,
    :func:`rebalance_storm_spec`, :func:`random_cluster_spec`); ``types``
    is either package's ``apis.types`` module and ``resource_name`` its
    ``ResourceName``. Pods carry every field the spec gives (QoS as an
    int, owner, restart count, creation time among them); metrics carry
    the aggregated fields of ``plugin_chain.aggregated_fields`` when the
    spec has them (``plugin_chain.chain_world_spec``)."""
    def res(d):
        return {resource_name(k): v for k, v in d.items()}

    def pod(d):
        d = dict(d)
        d["requests"], d["limits"] = res(d["requests"]), res(d["limits"])
        d["labels"] = dict(d.get("labels", {}))
        d["annotations"] = dict(d.get("annotations", {}))
        if "qos" in d:
            d["qos"] = types.QoSClass(d["qos"])
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
                report_interval=m["report_interval"],
                **(typed_aggregated(m, resource_name)
                   if "aggregated_usage" in m else {}))
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
        reservations=[
            types.ReservationSpec(
                **{**r, "requests": res(r["requests"]),
                   "allocatable": res(r["allocatable"]),
                   "allocated": res(r["allocated"]),
                   "state": types.ReservationState(r["state"]),
                   "owner_labels": dict(r["owner_labels"]),
                   "owner_pod_uids": list(r["owner_pod_uids"])})
            for r in spec.get("reservations", ())
        ],
        now=spec["now"],
    )


def preemption_storm(seed: int, n_nodes: int = 24,
                     residents_per_node: int = 4, n_arrivals: int = 12,
                     quota=None):
    """The seeded preemption-storm world (the reference's bench config
    #19 at ``preemption_storm(11, 1250, 4, 1000)``): every node packed
    tight with low-priority preemptible BE residents, then a wave of
    higher-priority PROD LS arrivals sized so plain fit fails, each
    placeable only by evicting more than one resident. The same seed
    gives the same storm as the reference's.

    Returns ``(nodes, residents, arrivals)``; residents carry
    ``node_name``, arrivals are pending. With ``quota`` every pod shares
    that quota group, arming the ElasticQuota reprieve gate."""
    rng = random.Random(seed)
    nodes, residents, arrivals = [], [], []
    for i in range(n_nodes):
        nodes.append(NodeSpec(name=f"storm-n{i}",
                              allocatable={CPU: 16000, MEM: 65536}))
        for j in range(residents_per_node):
            # each resident a share of the node with a little jitter:
            # no room for an arrival without eviction
            residents.append(PodSpec(
                name=f"storm-be-{i}-{j}",
                node_name=f"storm-n{i}",
                requests={
                    CPU: 16000 // residents_per_node,
                    MEM: rng.randrange(49152 // residents_per_node,
                                       65536 // residents_per_node + 1),
                },
                qos=QoSClass.BE,
                priority=rng.randrange(100, 400),
                quota=quota,
                assign_time=float(rng.randrange(0, 1000)),
            ))
    for k in range(n_arrivals):
        # an arrival needs more than any one resident frees: the least
        # victim set has more than one pod, so the reprieve order matters
        arrivals.append(PodSpec(
            name=f"storm-ls-{k}",
            requests={CPU: (16000 // residents_per_node) * 2,
                      MEM: (49152 // residents_per_node) * 2},
            qos=QoSClass.LS,
            priority_class=PriorityClass.PROD,
            priority=rng.randrange(5000, 9000),
            quota=quota,
        ))
    return nodes, residents, arrivals


def _rebalance_spec(nodes, pods, metrics, now=120.0):
    return dict(now=now, nodes=nodes, assigned=pods, pending=[],
                metrics=metrics, quotas=[], gangs=[])


def rebalance_world_spec(n_nodes: int = 5000, n_pods: int = 30000,
                         seed: int = 5):
    """The reference's rebalance world, bench config #5 (``bench.py``
    ``bench_rebalance``, draw for draw): ``n_pods`` running pods placed on
    ``n_nodes`` nodes of 64 CPUs / 128 GiB by a squared uniform, so a
    tail of nodes crosses the high threshold; a node's usage is the sum
    of its pods' usage (= requests) plus a system share, capped at
    allocatable. Plain data for :func:`build_snapshot`; the pool of
    config #5 is low ``{CPU: 45, MEM: 60}``, high ``{CPU: 65, MEM: 80}``."""
    rng = np.random.default_rng(seed)
    pod_node = (rng.random(n_pods) ** 2 * n_nodes).astype(np.int64)
    pod_cpu = rng.integers(200, 4000, n_pods)
    pod_mem = rng.integers(128, 4096, n_pods)
    qos_pool = [int(QoSClass.NONE), int(QoSClass.LS), int(QoSClass.BE)]
    pods = []
    usages = [{} for _ in range(n_nodes)]
    for j in range(n_pods):
        cpu, mem, i = int(pod_cpu[j]), int(pod_mem[j]), int(pod_node[j])
        pods.append(dict(name=f"p{j}", node_name=f"n{i}",
                         requests={int(CPU): cpu, int(MEM): mem}, limits={},
                         qos=qos_pool[j % 3], priority=int((j % 4) * 1000),
                         creation_time=float(j % 977)))
        usages[i][f"default/p{j}"] = {int(CPU): cpu, int(MEM): mem}
    cpu_sum = np.bincount(pod_node, weights=pod_cpu, minlength=n_nodes)
    mem_sum = np.bincount(pod_node, weights=pod_mem, minlength=n_nodes)
    nodes, metrics = [], []
    for i in range(n_nodes):
        nodes.append(dict(name=f"n{i}",
                          alloc={int(CPU): 64000, int(MEM): 131072},
                          labels={}, unschedulable=False))
        metrics.append(dict(
            node_name=f"n{i}",
            node_usage={int(CPU): min(int(cpu_sum[i]) + 500, 64000),
                        int(MEM): min(int(mem_sum[i]) + 1024, 131072)},
            pod_usages=usages[i], update_time=100.0, report_interval=60.0))
    return _rebalance_spec(nodes, pods, metrics)


def rebalance_storm_spec(n_nodes: int = 400, ppn: int = 10, seed: int = 22):
    """The reference's rebalance storm, bench config #22 (``bench.py``
    ``bench_rebalance_storm``, draw for draw): every other node of 32
    CPUs / 64 GiB runs hot (27-31 CPUs, 56-64 GiB used) with ``ppn`` BE
    pods that each use 1.5-3.2 CPUs, the rest idle. Plain data for
    :func:`build_snapshot`; the pool of config #22 is low ``{CPU: 30,
    MEM: 30}``, high ``{CPU: 60, MEM: 60}``."""
    rng = np.random.default_rng(seed)
    nodes, pods, metrics = [], [], []
    for i in range(n_nodes):
        hot = i % 2 == 0
        name = f"rb-n{i}"
        nodes.append(dict(name=name, alloc={int(CPU): 32000, int(MEM): 65536},
                          labels={}, unschedulable=False))
        pod_usages = {}
        if hot:
            for j in range(ppn):
                pod = dict(name=f"rb-p{i}-{j}", node_name=name,
                           requests={int(CPU): 200, int(MEM): 256},
                           limits={}, qos=int(QoSClass.BE),
                           priority=int(rng.integers(0, 3) * 1000),
                           creation_time=float(rng.integers(0, 50)))
                pods.append(pod)
                pod_usages[f"default/{pod['name']}"] = {
                    int(CPU): int(rng.integers(1500, 3200)),
                    int(MEM): int(rng.integers(2048, 6000))}
        usage = ({int(CPU): int(rng.integers(27000, 31000)),
                  int(MEM): int(rng.integers(56000, 64000))}
                 if hot else
                 {int(CPU): int(rng.integers(500, 3000)),
                  int(MEM): int(rng.integers(1024, 6000))})
        metrics.append(dict(node_name=name, node_usage=usage,
                            pod_usages=pod_usages, update_time=100.0,
                            report_interval=60.0))
    return _rebalance_spec(nodes, pods, metrics)


#: the Koordinator QoS classes a random cluster's pods draw from
RANDOM_CLUSTER_QOS = (QoSClass.NONE, QoSClass.LS, QoSClass.LSR, QoSClass.BE)


def random_cluster_spec(rng, n_nodes=24, n_pods=120, metric_gap=0.2,
                        stale_frac=0.1, unsched_frac=0.1):
    """A small random cluster for the rebalance differentials, draw for
    draw the reference's ``tests/test_rebalance_oracle.py::
    random_cluster`` from the same ``rng``: priority, QoS (Kubernetes and
    Koordinator) and cost-annotation diversity, pods missing from the
    metric, stale metrics, unschedulable nodes and DaemonSet pods."""
    nodes, pods, metrics = [], [], []
    for i in range(n_nodes):
        nodes.append(dict(
            name=f"n{i}",
            alloc={int(CPU): int(rng.integers(8000, 64000)),
                   int(MEM): int(rng.integers(16384, 131072))},
            labels={}, unschedulable=bool(rng.random() < unsched_frac)))
    for j in range(n_pods):
        node = nodes[int(rng.integers(n_nodes))]
        annotations = {}
        if rng.random() < 0.3:
            annotations["controller.kubernetes.io/pod-deletion-cost"] = str(
                int(rng.integers(-5, 5)))
        if rng.random() < 0.3:
            annotations["koordinator.sh/eviction-cost"] = str(
                int(rng.integers(-5, 5)))
        req_cpu = int(rng.integers(100, 3000))
        shape = rng.random()
        if shape < 0.3:
            requests = {int(CPU): req_cpu, int(MEM): 512}
            limits = dict(requests)            # guaranteed
        elif shape < 0.45:
            requests = {int(CPU): req_cpu}
            limits = {int(CPU): req_cpu}       # cpu only: burstable
        elif shape < 0.7:
            requests = {int(CPU): req_cpu, int(MEM): 512}
            limits = {int(CPU): req_cpu * 2}   # burstable
        else:
            requests = {int(CPU): req_cpu, int(MEM): 512}
            limits = {}                        # burstable (has requests)
        qos = int(RANDOM_CLUSTER_QOS[int(rng.integers(len(RANDOM_CLUSTER_QOS)))])
        pods.append(dict(
            name=f"p{j}", node_name=node["name"], requests=requests,
            limits=limits, qos=qos,
            priority=int(rng.integers(0, 3) * 1000),
            is_daemonset=bool(rng.random() < 0.1),
            creation_time=float(rng.integers(0, 50)),
            annotations=annotations))
    for node in nodes:
        pod_usages = {}
        for pod in pods:
            if pod["node_name"] == node["name"] and rng.random() > metric_gap:
                pod_usages[f"default/{pod['name']}"] = {
                    int(CPU): int(rng.integers(50, 4000)),
                    int(MEM): int(rng.integers(64, 2048))}
        cap = node["alloc"]
        metrics.append(dict(
            node_name=node["name"],
            node_usage={int(CPU): int(rng.integers(0, int(cap[int(CPU)] * 1.1))),
                        int(MEM): int(rng.integers(0, int(cap[int(MEM)] * 1.1)))},
            pod_usages=pod_usages,
            update_time=-1000.0 if rng.random() < stale_frac else 100.0,
            report_interval=60.0))
    return _rebalance_spec(nodes, pods, metrics)


def sweep_batch_arrays(seed, k, *, headroom=None, blocked_frac=0.1,
                       metric_gap=0.15, invalid_frac=0.05, exhausted=True):
    """A seeded balance-sweep batch for the sweep's tests, ``(arrays,
    available, res_mask, blocked)`` with ``arrays`` the fields of
    ``ops/rebalance.SweepBatch`` (int64, bool): ``k`` candidates on nodes
    of 1-12 candidates each, nodes over their high quantities by a few
    pods' usage, some candidates blocked, metric-less or invalid. With
    ``headroom`` the pool's headroom is that many pods' usage, so it runs
    out part way through; with ``exhausted`` a column may start at 0."""
    rng = np.random.default_rng(seed)
    starts = np.zeros(k, bool)
    i = 0
    while i < k:
        starts[i] = True
        i += int(rng.integers(1, 13))
    n_nodes = int(starts.sum())
    node = np.cumsum(starts) - 1
    hq_node = rng.integers(10_000, 60_000, (n_nodes, NUM_RESOURCES))
    u0_node = hq_node + rng.integers(-2_000, 8_000, (n_nodes, NUM_RESOURCES))
    metric = rng.integers(0, 3_000, (k, NUM_RESOURCES))
    has_metric = rng.random(k) >= metric_gap
    metric[~has_metric] = 0
    res_mask = rng.random(NUM_RESOURCES) < 0.5
    res_mask[int(MEM)] = True
    if headroom is None:
        available = rng.integers(5_000, 200_000, NUM_RESOURCES)
    else:
        available = np.full(NUM_RESOURCES, 1_500 * headroom)
    if exhausted:
        available[rng.random(NUM_RESOURCES) < 0.2] = 0  # exhausted column
    arrays = dict(
        node_start=starts, usage0=u0_node[node].astype(np.int64),
        high_q=hq_node[node].astype(np.int64), metric=metric.astype(np.int64),
        has_metric=has_metric, valid=rng.random(k) >= invalid_frac)
    blocked = rng.random(k) < blocked_frac
    return arrays, available.astype(np.int64), res_mask, blocked


def sweep_rows(nodes, columns=(int(MEM),)):
    """A balance-sweep batch from ``nodes``, each ``(usage, high,
    [metric of each candidate])``, those values on each of ``columns``
    and 0 on the others, every candidate valid and with a metric:
    ``(arrays, res_mask)`` with ``res_mask`` true on ``columns``."""
    cols = np.zeros(NUM_RESOURCES, np.int64)
    cols[list(columns)] = 1
    start, u0, hq, metric = [], [], [], []
    for usage, high, pods in nodes:
        for j, m in enumerate(pods):
            start.append(j == 0)
            u0.append(cols * usage)
            hq.append(cols * high)
            metric.append(cols * m)
    k = len(start)
    arrays = dict(node_start=np.array(start, bool),
                  usage0=np.array(u0, np.int64).reshape(k, NUM_RESOURCES),
                  high_q=np.array(hq, np.int64).reshape(k, NUM_RESOURCES),
                  metric=np.array(metric, np.int64).reshape(k,
                                                            NUM_RESOURCES),
                  has_metric=np.ones(k, bool), valid=np.ones(k, bool))
    return arrays, cols.astype(bool)


def sweep_cut_across_tile(edge, columns=(int(MEM),), before=6):
    """A sweep batch whose node A is cut ``before`` candidates short of
    candidate ``edge`` (a tile edge of the scan kernel), holds a negative
    metric after its cut (eligible, never proposed) and runs on past the
    edge, where node B then exhausts the headroom: the case in which a
    tile must carry A's usage as it stood at the cut, not the running
    sum of every eligible metric. ``(arrays, available, res_mask,
    blocked)``; the headroom runs out at B's second candidate, after the
    edge. Nodes before A are at their high quantities (never over)."""
    a_pods = [60, -1000] + [1] * (before + 2)
    filler = [(0, 100, [7])] * (edge - before + 1 - 2)
    arrays, res_mask = sweep_rows(
        filler + [(100, 50, a_pods), (200, 50, [5, 5, 5])], columns)
    available = np.where(res_mask, 65, 10**6).astype(np.int64)
    return arrays, available, res_mask, np.zeros(len(arrays["valid"]), bool)


# -- solver-sidecar requests -------------------------------------------------

#: the request cases :func:`service_request_groups` builds
SERVICE_CASES = ("plain", "quota_gang", "resv", "numa_least", "numa_most",
                 "extras", "weights")


def service_request_groups(case: str, n_nodes: int = 32, n_pods: int = 24,
                           seed: int = 0) -> dict:
    """The wire groups (numpy) of one seeded solve request, as either
    package's ``SolveRequest(**groups)`` takes them: ``node``, ``pods``,
    ``params`` and, by ``case`` (:data:`SERVICE_CASES`), ``quota`` and
    ``gang`` (built states, the wire form), ``resv`` (8 reservations),
    ``numa`` (with the node group's inventories; ``config`` names the
    scorer), dense ``extras``, or non-unit plugin weights (``config``:
    the loop route)."""
    nodes, pods, params, quota, gang = quota_gang_arrays(
        n_nodes, n_pods - 2 * 4, 3, 2, 4, seed=seed)
    groups = dict(node={k: nodes[k] for k in (
        "alloc", "used_req", "usage", "prod_usage", "est_extra",
        "prod_base", "metric_fresh", "schedulable")},
        pods=dict(pods), params=params)
    if case == "plain":
        for k in ("quota_id", "non_preemptible", "gang_id", "blocked"):
            del groups["pods"][k]
    elif case == "quota_gang":
        def wire(state):
            return {k: v.numpy() for k, v in state._asdict().items()
                    if v is not None}

        groups["quota"] = wire(QuotaState.build(**quota, device="cpu"))
        groups["gang"] = wire(GangState.build(**gang, device="cpu"))
    elif case == "resv":
        groups["resv"] = resv_table_arrays(n_nodes, n_pods, 8, seed=seed + 8)
    elif case in ("numa_least", "numa_most"):
        cap, free, has_policy, node_policy = numa_arrays(
            nodes["alloc"], n_pods, seed=seed + 7)
        groups["node"].update(numa_cap=cap, numa_free=free)
        groups["pods"]["has_numa_policy"] = has_policy
        groups["numa"] = dict(node_policy=node_policy)
        groups["config"] = dict(numa_most_allocated=np.asarray(
            case == "numa_most"))
    elif case == "extras":
        mask, score = dense_extras(*extras_arrays(
            n_nodes, n_pods, selector_frac=0.3, scored_frac=0.2,
            seed=seed + 13))
        groups["extras"] = dict(mask=mask, score=score)
    elif case == "weights":
        groups["config"] = dict(fit_weight=np.asarray(2),
                                loadaware_weight=np.asarray(3))
    else:
        raise ValueError(f"unknown case {case!r}")
    return groups


def concurrent_solve_groups(n_nodes: int = 500, n_pods: int = 32) -> dict:
    """The reference's bench config #10 request (``bench.py``
    ``bench_concurrent_solve``): one plain full-state request every
    client sends, drawn as the bench draws it."""
    rng = np.random.default_rng(0)
    alloc = np.zeros((n_nodes, NUM_RESOURCES), np.int32)
    alloc[:, CPU] = 64000
    alloc[:, MEM] = 131072
    used = np.zeros_like(alloc)
    used[:, CPU] = rng.integers(0, 30000, n_nodes)
    used[:, MEM] = rng.integers(0, 65536, n_nodes)
    node = {"alloc": alloc, "used_req": used,
            "usage": np.zeros_like(alloc), "prod_usage": np.zeros_like(alloc),
            "est_extra": np.zeros_like(alloc),
            "prod_base": np.zeros_like(alloc),
            "metric_fresh": np.ones(n_nodes, bool),
            "schedulable": np.ones(n_nodes, bool)}
    return dict(node=node, pods=_concurrent_pods(rng, n_pods),
                params=_bench_params())


def concurrent_pod_sets(counts: Sequence[int], seed: int = 1) -> list:
    """Pod groups for lanes on :func:`concurrent_solve_groups`' base, one
    of each count, drawn as that request's pods are, each from its own
    stream (``seed + i``): K different requests that coalesce."""
    return [_concurrent_pods(np.random.default_rng(seed + i), p)
            for i, p in enumerate(counts)]


def _concurrent_pods(rng, n_pods: int) -> dict:
    req = np.zeros((n_pods, NUM_RESOURCES), np.int32)
    req[:, CPU] = rng.integers(200, 2000, n_pods)
    req[:, MEM] = rng.integers(128, 2048, n_pods)
    return {"req": req, "est": (req * 85) // 100,
            "is_prod": np.zeros(n_pods, bool),
            "is_daemonset": np.zeros(n_pods, bool)}


def _bench_params() -> dict:
    weights = np.zeros(NUM_RESOURCES, np.int32)
    weights[[CPU, MEM]] = 1
    thresholds = np.zeros(NUM_RESOURCES, np.int32)
    thresholds[CPU], thresholds[MEM] = 65, 95
    return {"weights": weights, "thresholds": thresholds,
            "prod_thresholds": np.zeros(NUM_RESOURCES, np.int32)}


def tenant_stream(tenant_i: int, rounds: int, n_nodes: int = 1024,
                  n_pods: int = 64) -> list:
    """The reference's bench config #16 (``bench.py``
    ``bench_multi_tenant_pool``) round stream of one tenant on the
    wire-delta protocol, as wire groups per round: round 0 establishes
    the tenant's own world (full node group, ``node_delta`` epoch 0),
    every later round patches 16 dirty rows of it (``base_epoch`` r - 1,
    ``epoch`` r) beside that tick's pod burst. Drawn as the bench draws
    it; the caller adds the tenant's ``admission`` group."""
    rng = np.random.default_rng(1000 + tenant_i)
    alloc = np.zeros((n_nodes, NUM_RESOURCES), np.int32)
    alloc[:, CPU] = 64000
    alloc[:, MEM] = 131072
    used = np.zeros_like(alloc)
    used[:, CPU] = rng.integers(0, 30000, n_nodes)
    used[:, MEM] = rng.integers(0, 65536, n_nodes)
    node = {"alloc": alloc, "used_req": used,
            "usage": np.zeros_like(alloc), "prod_usage": np.zeros_like(alloc),
            "est_extra": np.zeros_like(alloc),
            "prod_base": np.zeros_like(alloc),
            "metric_fresh": np.ones(n_nodes, bool),
            "schedulable": np.ones(n_nodes, bool)}
    params = _bench_params()

    def tick_pods(r):
        rng = np.random.default_rng(7_000_000 + tenant_i * 10_000 + r)
        req = np.zeros((n_pods, NUM_RESOURCES), np.int32)
        req[:, CPU] = rng.integers(200, 2000, n_pods)
        req[:, MEM] = rng.integers(128, 2048, n_pods)
        return {"req": req, "est": (req * 85) // 100,
                "is_prod": np.zeros(n_pods, bool),
                "is_daemonset": np.zeros(n_pods, bool)}

    out = [dict(node={k: v.copy() for k, v in node.items()}, params=params,
                pods=tick_pods(0),
                node_delta={"epoch": np.asarray(0, np.int64)})]
    for r in range(1, rounds):
        rng = np.random.default_rng(7_000_000 + tenant_i * 10_000 + r)
        idx = rng.choice(n_nodes, 16, replace=False)
        node["used_req"][idx, CPU] = rng.integers(0, 40000, idx.size)
        delta = {"idx": idx.astype(np.int32),
                 "base_epoch": np.asarray(r - 1, np.int64),
                 "epoch": np.asarray(r, np.int64)}
        delta.update({f: node[f][idx] for f in node})
        out.append(dict(node={}, params=params, pods=tick_pods(r),
                        node_delta=delta))
    return out


# -- the colocation loop (the manager's overcommit PATCH, then the BE wave
# placed against the batch columns) -------------------------------------------

#: the colocation world's node-selector strategy override: the nodes
#: labelled ``pool=aggressive`` take maxUsageRequest and other reclaim
#: percents
COLOCATION_POOL = {"pool": "aggressive"}
COLOCATION_OVERRIDES = {
    "cpu_calculate_policy": "maxUsageRequest",
    "memory_calculate_policy": "maxUsageRequest",
    "cpu_reclaim_threshold_percent": 70,
    "memory_reclaim_threshold_percent": 80,
}
#: the node-reservation annotation of the reserving nodes
COLOCATION_RESERVATION = '{"resources": {"cpu": 2000, "memory": 4096}}'


def colocation_world_spec(seed: int = 11, n_nodes: int = 5000,
                          pods_per_node: int = 10, n_dangling: int = 2000,
                          n_pending: int = 10000, now: float = 1000.0,
                          override_frac: float = 0.1,
                          normalized_frac: float = 0.02,
                          reserving_frac: float = 0.02,
                          stale_frac: float = 0.05,
                          host_app_frac: float = 0.05) -> dict:
    """A seeded colocation world as plain data (resource columns as int
    keys), for :func:`colocation_objects` to build with either package's
    types. Nodes carry native CPU and memory only; ``override_frac`` of
    them match the node-selector override (``COLOCATION_OVERRIDES``),
    ``normalized_frac`` carry a cpu-normalization ratio and
    ``reserving_frac`` a node-reservation annotation. ``pods_per_node``
    running pods a node: 60% prod LS, 10% prod LSE, 30% BE (batch
    requests) or free (native requests); 20% of the prod pods have no
    usage in their node's metric. ``n_dangling`` usage entries name pods
    that are not in the pod list (a quarter of them recorded as batch).
    Every node has a metric with system usage, prod reclaimable and pod
    usages; ``host_app_frac`` of them a BE host application and
    ``stale_frac`` an update older than the degrade window. Then
    ``n_pending`` BE pods requesting batch CPU and memory."""
    rng = np.random.default_rng(seed)
    cpu, mem = int(CPU), int(MEM)
    bcpu, bmem = int(ResourceName.BATCH_CPU), int(ResourceName.BATCH_MEMORY)
    node_cpu = rng.choice([32000, 64000, 96000], n_nodes)
    node_mem = rng.choice([131072, 262144, 393216], n_nodes)
    draw = rng.uniform(size=(n_nodes, 5))
    nodes, metrics, pods = [], [], []
    for i in range(n_nodes):
        name = f"n{i}"
        annotations = {}
        if draw[i, 1] < normalized_frac:
            annotations[ANNOTATION_CPU_NORMALIZATION_RATIO] = (
                "1.5" if i % 2 else "1.25")
        if draw[i, 2] < reserving_frac:
            annotations[ANNOTATION_NODE_RESERVATION] = COLOCATION_RESERVATION
        nodes.append(dict(
            name=name, alloc={cpu: int(node_cpu[i]), mem: int(node_mem[i])},
            labels=dict(COLOCATION_POOL) if draw[i, 0] < override_frac else {},
            annotations=annotations))
        usages, sum_use = {}, np.zeros(2, np.int64)
        kinds = rng.uniform(size=pods_per_node)
        reqs = np.stack([rng.integers(500, 4000, pods_per_node),
                         rng.integers(1024, 8192, pods_per_node)], axis=1)
        use_frac = rng.uniform(0.2, 0.9, size=(pods_per_node, 2))
        no_usage = rng.uniform(size=pods_per_node) < 0.2
        for j in range(pods_per_node):
            pod_name = f"r{i}-{j}"
            req = {cpu: int(reqs[j, 0]), mem: int(reqs[j, 1])}
            if kinds[j] < 0.6:
                kind = dict(priority=9500, qos=int(QoSClass.LS))
            elif kinds[j] < 0.7:
                kind = dict(priority=9500, qos=int(QoSClass.LSE))
            elif kinds[j] < 0.9:
                kind = dict(priority=5500, qos=int(QoSClass.BE))
                req = {bcpu: req[cpu], bmem: req[mem]}
            else:
                kind = dict(priority=3500, qos=int(QoSClass.BE))
            pods.append(dict(name=pod_name, node_name=name, requests=req,
                             **kind))
            if kind["priority"] == 9500 and no_usage[j]:
                continue
            use = (reqs[j] * use_frac[j]).astype(np.int64)
            usages[f"default/{pod_name}"] = {cpu: int(use[0]),
                                             mem: int(use[1])}
            sum_use += use
        sys_use = np.array([rng.integers(500, 2000), rng.integers(1024, 4096)])
        host_apps, host_qos = {}, {}
        if draw[i, 3] < host_app_frac:
            host_apps["miner"] = {cpu: int(rng.integers(200, 1500)),
                                  mem: int(rng.integers(256, 2048))}
            host_qos["miner"] = int(QoSClass.BE)
        reclaim = (np.array([node_cpu[i], node_mem[i]])
                   * rng.uniform(0.1, 0.3, 2)).astype(np.int64)
        metrics.append(dict(
            node_name=name,
            node_usage={cpu: int(sum_use[0] + sys_use[0]),
                        mem: int(sum_use[1] + sys_use[1])},
            sys_usage={cpu: int(sys_use[0]), mem: int(sys_use[1])},
            prod_reclaimable={cpu: int(reclaim[0]), mem: int(reclaim[1])},
            pod_usages=usages, pod_priority_class={},
            host_app_usages=host_apps, host_app_qos=host_qos,
            update_time=now - (1200.0 if draw[i, 4] < stale_frac else 30.0)))
    ghost_nodes = rng.integers(0, n_nodes, n_dangling)
    ghost_use = np.stack([rng.integers(100, 1500, n_dangling),
                          rng.integers(128, 2048, n_dangling)], axis=1)
    ghost_batch = rng.uniform(size=n_dangling) < 0.25
    for k in range(n_dangling):
        m = metrics[int(ghost_nodes[k])]
        uid = f"ghost-{k}"
        m["pod_usages"][uid] = {cpu: int(ghost_use[k, 0]),
                                mem: int(ghost_use[k, 1])}
        if ghost_batch[k]:
            m["pod_priority_class"][uid] = int(PriorityClass.BATCH)
    pending = [
        dict(name=f"be{k}", priority=5500, qos=int(QoSClass.BE),
             requests={bcpu: int(c), bmem: int(m_)})
        for k, (c, m_) in enumerate(zip(
            rng.choice([4000, 8000, 16000, 24000], n_pending),
            rng.choice([4096, 8192, 16384, 32768], n_pending)))
    ]
    return dict(nodes=nodes, pods=pods, metrics=metrics, pending=pending,
                now=now, pool=dict(COLOCATION_POOL),
                overrides=dict(COLOCATION_OVERRIDES))


def colocation_metric_changes(spec: dict, frac: float = 0.01,
                              seed: int = 12, now: float = None) -> list:
    """Changed NodeMetric data for ``frac`` of the world's nodes, reported
    at ``now`` (default the spec's ``now`` plus 60 s): every other one
    with a large system-usage rise (a fifth of the node's CPU: past the
    diff threshold where batch CPU is not already zero), the rest with a
    rise of 1% (below it)."""
    rng = np.random.default_rng(seed)
    now = spec["now"] + 60.0 if now is None else now
    n = len(spec["nodes"])
    picked = sorted(rng.choice(n, max(int(n * frac), 1), replace=False))
    out = []
    for k, i in enumerate(picked):
        m = copy.deepcopy(spec["metrics"][int(i)])
        cap = spec["nodes"][int(i)]["alloc"][int(CPU)]
        rise = cap // 5 if k % 2 == 0 else cap // 100
        m["sys_usage"][int(CPU)] += rise
        m["node_usage"][int(CPU)] += rise
        m["update_time"] = now
        out.append(m)
    return out


def colocation_metric(m: dict, types):
    """One NodeMetric of :func:`colocation_world_spec` data, built with
    ``types`` (either package's ``apis.types`` module)."""
    rn = types.ResourceName

    def res(d):
        return {rn(k): v for k, v in d.items()}

    return types.NodeMetric(
        node_name=m["node_name"], node_usage=res(m["node_usage"]),
        sys_usage=res(m["sys_usage"]),
        prod_reclaimable=res(m["prod_reclaimable"]),
        pod_usages={u: res(v) for u, v in m["pod_usages"].items()},
        pod_priority_class={u: types.PriorityClass(c) for u, c
                            in m["pod_priority_class"].items()},
        host_app_usages={a: res(v) for a, v in m["host_app_usages"].items()},
        host_app_qos={a: types.QoSClass(q)
                      for a, q in m["host_app_qos"].items()},
        update_time=m["update_time"])


def colocation_objects(spec: dict, types) -> dict:
    """The world's objects built with ``types``: ``{"nodes", "pods",
    "metrics", "pending"}`` (lists; fresh objects on every call)."""
    rn = types.ResourceName

    def res(d):
        return {rn(k): v for k, v in d.items()}

    def pod(d):
        d = dict(d)
        d["requests"] = res(d["requests"])
        d["qos"] = types.QoSClass(d["qos"])
        return types.PodSpec(**d)

    return dict(
        nodes=[types.NodeSpec(name=n["name"], allocatable=res(n["alloc"]),
                              labels=dict(n["labels"]),
                              annotations=dict(n["annotations"]))
               for n in spec["nodes"]],
        pods=[pod(p) for p in spec["pods"]],
        metrics=[colocation_metric(m, types) for m in spec["metrics"]],
        pending=[pod(p) for p in spec["pending"]])


def colocation_snapshot(spec: dict, types):
    """The world as one ``types.ClusterSnapshot`` at the spec's ``now``
    (the manager's view: assigned pods and metrics)."""
    objs = colocation_objects(spec, types)
    return types.ClusterSnapshot(
        nodes=objs["nodes"], pods=objs["pods"],
        node_metrics={m.node_name: m for m in objs["metrics"]},
        now=spec["now"])


def colocation_config(spec: dict, sloconfig):
    """The world's ``ColocationConfig`` built with ``sloconfig`` (either
    package's ``manager.sloconfig`` module): colocation enabled, with the
    node-selector override."""
    return sloconfig.ColocationConfig(
        cluster_strategy=sloconfig.ColocationStrategy(enable=True),
        node_strategies=[sloconfig.NodeStrategySelector(
            match_labels=dict(spec["pool"]),
            overrides=dict(spec["overrides"]))])


def apply_colocation(bus, kind, spec: dict, types) -> None:
    """Apply the world to an ``APIServer`` (either package's, with its
    ``Kind``): nodes, metrics, the running pods, then the BE wave."""
    objs = colocation_objects(spec, types)
    for node in objs["nodes"]:
        bus.apply(kind.NODE, node.name, node)
    for metric in objs["metrics"]:
        bus.apply(kind.NODE_METRIC, metric.node_name, metric)
    for pod in objs["pods"] + objs["pending"]:
        bus.apply(kind.POD, pod.uid, pod)


# -- the pipelined and streaming loops' worlds (bench configs #13 and #18) ------

def loop_world(bus, kind, n_nodes: int, *, assigned: bool = True,
               seed: int = 42) -> None:
    """Bench config #13's world (and, with ``assigned=False``, config
    #18's) applied to an ``APIServer`` and its ``Kind``, drawn as the
    reference bench draws it from ``default_rng(seed)``: ``n_nodes`` nodes
    of 64,000 mCPU and 131,072 MiB, a NodeMetric each, and (``assigned``)
    ``n_nodes`` pods already placed on random nodes."""
    rng = np.random.default_rng(seed)
    for i in range(n_nodes):
        bus.apply(kind.NODE, f"n{i}", NodeSpec(
            name=f"n{i}", allocatable={CPU: 64000, MEM: 131072}))
        if not assigned:
            bus.apply(kind.NODE_METRIC, f"n{i}", _loop_metric(rng, i, 10.0))
    if not assigned:
        return
    for i in range(n_nodes):
        bus.apply(kind.NODE_METRIC, f"n{i}", _loop_metric(rng, i, 10.0))
    for j in range(n_nodes):
        node_i = int(rng.integers(0, n_nodes))
        pod = PodSpec(name=f"a{j}", node_name=f"n{node_i}", assign_time=5.0,
                      requests={CPU: int(rng.integers(200, 2000)),
                                MEM: int(rng.integers(128, 2048))})
        bus.apply(kind.POD, pod.uid, pod)


def _loop_metric(rng, i: int, now: float) -> NodeMetric:
    return NodeMetric(node_name=f"n{i}",
                      node_usage={CPU: int(rng.integers(500, 30000)),
                                  MEM: int(rng.integers(512, 65536))},
                      update_time=now)


def loop_tick(bus, kind, rng, t: int, now: float, n_nodes: int, *,
              dirty: int = 50, pending: int = 64) -> None:
    """One tick of bench config #13's stream: ``dirty`` NodeMetric
    refreshes on distinct random nodes, then ``pending`` new pods."""
    for i in rng.choice(n_nodes, dirty, replace=False):
        bus.apply(kind.NODE_METRIC, f"n{int(i)}",
                  _loop_metric(rng, int(i), now))
    for j in range(pending):
        pod = PodSpec(name=f"t{t}p{j}",
                      requests={CPU: int(rng.integers(200, 1500)),
                                MEM: int(rng.integers(128, 1024))})
        bus.apply(kind.POD, pod.uid, pod)
