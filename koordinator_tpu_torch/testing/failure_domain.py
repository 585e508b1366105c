"""The serving failure domain's bench configurations, drawn as the
reference's ``bench.py`` draws them, for the port's tests and
``chip_smoke.py``:

- config #11, the outage-failover churn (``bench_outage_failover_churn``):
  :func:`outage_churn` drives a model through churn ticks of a world of
  ``n_nodes`` nodes (``dirty`` node metrics and ``pending`` pods a tick);
- config #20, the SLO convergence (``bench_slo_convergence``):
  :func:`slo_arm` serves one arrival trace through a streaming loop on a
  fake-clock grid, with or without the SLO controller;
- config #21, the tenant-density curve of the HBM working set
  (``bench_tenant_density``): :func:`density_stream` is one tenant's
  wire-delta round stream and :func:`density_arm` serves every stream
  under one budget line.

Each runner takes the package it drives as arguments (types, modules or
callables), so one draw feeds the port and the reference alike.
"""

from __future__ import annotations

import hashlib
import time
from types import SimpleNamespace
from typing import Callable, List, Optional, Sequence

import numpy as np

from koordinator_tpu_torch.apis.extension import NUM_RESOURCES, ResourceName
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS

CPU, MEM = int(ResourceName.CPU), int(ResourceName.MEMORY)

# -- config #11: the outage-failover churn -----------------------------------

#: bench config #11's sizes: the kill lands at tick ``ticks // 3``
OUTAGE = SimpleNamespace(n_nodes=512, dirty=16, pending=32, ticks=40,
                         failure_threshold=2, recovery_probes=2,
                         deadline_s=0.5, backoff_s=8.0)


def outage_churn(model, types, tracker_cls, resource_name, *,
                 n_nodes: int = OUTAGE.n_nodes, ticks: int = OUTAGE.ticks,
                 dirty: int = OUTAGE.dirty, pending: int = OUTAGE.pending,
                 on_tick: Optional[Callable[[int], None]] = None,
                 warm: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.time,
                 keep: Optional[list] = None):
    """One churn run of config #11 through ``model.schedule``: a warm-up
    solve of the empty queue (then ``warm()``), then ``ticks`` ticks,
    each re-reporting ``dirty`` node metrics and submitting ``pending``
    pods, binding what was placed. ``types`` is a package's
    ``apis.types`` module, ``tracker_cls`` its ``ClusterDeltaTracker``,
    ``resource_name`` its ``ResourceName``; ``on_tick(t)`` runs before
    tick t's solve. Returns ``(log, walls, modes, done_at)``: each tick's
    sorted placements, solve wall, ``model.last_solver`` and completion
    time; with ``keep``, the final snapshot is appended to it."""
    cpu, mem = resource_name.CPU, resource_name.MEMORY
    rng = np.random.default_rng(42)
    nodes = [types.NodeSpec(name=f"n{i}",
                            allocatable={cpu: 64000, mem: 131072})
             for i in range(n_nodes)]
    metrics = {
        f"n{i}": types.NodeMetric(
            node_name=f"n{i}",
            node_usage={cpu: int(rng.integers(500, 30000)),
                        mem: int(rng.integers(512, 65536))},
            update_time=10.0)
        for i in range(n_nodes)}
    tracker = tracker_cls()
    snap = types.ClusterSnapshot(nodes=nodes, pods=[], pending_pods=[],
                                 node_metrics=metrics, now=20.0,
                                 delta_tracker=tracker)
    rng = np.random.default_rng(7)
    model.schedule(snap)
    if warm is not None:
        warm()
    log, walls, modes, done_at = [], [], [], []
    for t in range(ticks):
        now = 20.0 + t
        for i in rng.choice(n_nodes, dirty, replace=False):
            name = f"n{int(i)}"
            snap.node_metrics[name] = types.NodeMetric(
                node_name=name,
                node_usage={cpu: int(rng.integers(500, 30000)),
                            mem: int(rng.integers(512, 65536))},
                update_time=now)
            tracker.mark_node(name)
        snap.pending_pods = [
            types.PodSpec(name=f"t{t}p{j}",
                          requests={cpu: int(rng.integers(200, 1500)),
                                    mem: int(rng.integers(128, 1024))})
            for j in range(pending)]
        snap.now = now
        if on_tick is not None:
            on_tick(t)
        by_uid = {p.uid: p for p in snap.pending_pods}
        t0 = clock()
        result = model.schedule(snap)
        walls.append(clock() - t0)
        done_at.append(clock())
        modes.append(model.last_solver)
        log.append(sorted(result.items()))
        for uid, node in result.items():
            if node is not None:
                pod = by_uid[uid]
                pod.node_name = node
                pod.assign_time = now
                snap.pods.append(pod)
                tracker.mark_node(node)
        snap.pending_pods = []
    if keep is not None:
        keep.append(snap)
    return log, walls, modes, done_at


def mode_runs(modes: Sequence[Optional[str]]) -> List[str]:
    """``last_mode`` as its sequence of runs (consecutive equal modes
    folded): a clean outage reads remote, local-fallback, local-degraded,
    remote."""
    out: List[str] = []
    for m in modes:
        if not out or out[-1] != m:
            out.append(m)
    return out


# -- config #20: the SLO convergence -----------------------------------------

#: bench config #20's sizes and controller parameters
SLO = SimpleNamespace(
    n_nodes=16, duration_s=6.0, rate=50.0, target_s=0.005, step_s=0.001,
    seed=13, start_deadlines=(0.002, 0.016, 0.050),
    ctl_params=dict(window_s=0.4, reconcile_interval_s=0.05,
                    cooldown_s=0.45, min_samples=2, breach_rounds=2,
                    relax_rounds=8, relax_frac=0.5, waste_threshold=0.5))


class _NullHist:
    def observe(self, *a, **k):
        pass


def slo_arm(ns, trace, deadlines, with_controller: bool, *,
            n_nodes: int = SLO.n_nodes, target_s: float = SLO.target_s,
            step_s: float = SLO.step_s, device=None,
            ctl_params: Optional[dict] = None) -> dict:
    """One fake-clock serve of ``trace`` (config #20's ``run_arm``): a
    wired streaming loop over ``n_nodes`` nodes pumped every ``step_s``,
    with the SLO controller (declared ``ls`` p99 ``target_s``) when
    ``with_controller``. ``ns`` names the package's pieces: ``APIServer``,
    ``Kind``, ``wire_scheduler``, ``Scheduler``, ``model()`` (a new
    PlacementModel), ``PodTimelines``, ``StreamingLoop``,
    ``StreamingConfig``, ``ServingSLOController``, ``SLOSpec``,
    ``NodeSpec``, ``NodeMetric``, ``ResourceName`` and ``trace_pods``;
    ``device`` goes to the controller (its device source). Returns the
    arm's record, with the controller's ``decisions_log`` and
    ``observations`` when it ran."""
    params = dict(SLO.ctl_params if ctl_params is None else ctl_params)
    cpu, mem = ns.ResourceName.CPU, ns.ResourceName.MEMORY
    clock = [100.0]
    bus = ns.APIServer()
    sched = ns.Scheduler(model=ns.model())
    sched.timelines = ns.PodTimelines(clock=lambda: clock[0],
                                      histogram=_NullHist())
    ns.wire_scheduler(bus, sched)
    for i in range(n_nodes):
        bus.apply(ns.Kind.NODE, f"n{i}", ns.NodeSpec(
            name=f"n{i}", allocatable={cpu: 64000, mem: 131072}))
        bus.apply(ns.Kind.NODE_METRIC, f"n{i}", ns.NodeMetric(
            node_name=f"n{i}", node_usage={}, update_time=90.0))
    loop = ns.StreamingLoop(
        sched, apply_fn=lambda pod: bus.apply(ns.Kind.POD, pod.uid, pod),
        delete_fn=lambda uid: bus.delete(ns.Kind.POD, uid),
        config=ns.StreamingConfig(watermark=64, lane_deadline_s=deadlines),
        clock=lambda: clock[0], now_fn=lambda: clock[0],
        log=lambda *a: None)
    ctl = None
    if with_controller:
        ctl = ns.ServingSLOController(
            loop, ns.SLOSpec(ls=target_s), clock=lambda: clock[0],
            device=device, log=lambda *a: None, **params)
        loop.attach_controller(ctl)
    pairs, _ = ns.trace_pods(trace)
    i, t = 0, 0.0
    end = trace.duration_s + 0.1
    while t <= end + 1e-9:
        clock[0] = 100.0 + t
        while i < len(pairs) and pairs[i][0] <= t + 1e-12:
            loop.submit(pairs[i][1], now=clock[0])
            i += 1
        loop.pump(clock[0])
        t = round(t + step_s, 6)
    final = sched.timelines.stats(window_s=max(0.5, 0.25 * trace.duration_s))
    status = loop.status()
    gate = status["gate"]
    p99 = (final.get("ls") or {}).get("p99_s")
    out = {
        "final_ls_p99_s": p99,
        "attained": p99 is not None and p99 <= target_s,
        "rounds": status["rounds"],
        "bound": gate["bound"],
        "submitted": gate["submitted"],
        "capacity_shed": gate["shed"]["capacity"],
    }
    if ctl is not None:
        out["decisions"] = ctl.decisions_total()
        out["final_lane_deadline_s"] = list(loop.cfg.lane_deadline_s)
        out["decisions_log"] = ctl.decisions()
        out["observations"] = ctl.observations()
    loop.stop()
    return out


# -- config #21: the tenant-density curve ------------------------------------

#: bench config #21's sizes: budget lines in resident worlds of 16
DENSITY = SimpleNamespace(n_tenants=16, n_nodes=1024, n_pods=64, warmup=2,
                          lines={"f100": 16, "f50": 8, "f25": 4})


def density_stream(tenant_i: int, rounds: int,
                   n_nodes: int = DENSITY.n_nodes,
                   n_pods: int = DENSITY.n_pods):
    """One tenant's config #21 round stream on the wire-delta protocol as
    ``SolveRequest`` keyword groups: ``(establish, [delta per round
    1..rounds-1])``, each delta patching 16 rows of ``used_req`` beside
    that round's pod burst (the bench's draws)."""
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
    weights = np.zeros(NUM_RESOURCES, np.int32)
    weights[CPU] = weights[MEM] = 1
    thresholds = np.zeros(NUM_RESOURCES, np.int32)
    thresholds[CPU] = 65
    thresholds[MEM] = 95
    params = {"weights": weights, "thresholds": thresholds,
              "prod_thresholds": np.zeros(NUM_RESOURCES, np.int32)}

    def tick_pods(r):
        rng = np.random.default_rng(8_000_000 + tenant_i * 10_000 + r)
        req = np.zeros((n_pods, NUM_RESOURCES), np.int32)
        req[:, CPU] = rng.integers(200, 2000, n_pods)
        req[:, MEM] = rng.integers(128, 2048, n_pods)
        return {"req": req, "est": (req * 85) // 100,
                "is_prod": np.zeros(n_pods, bool),
                "is_daemonset": np.zeros(n_pods, bool)}

    establish = dict(node={k: v.copy() for k, v in node.items()},
                     params=params, pods=tick_pods(0),
                     node_delta={"epoch": np.asarray(0, np.int64)})
    deltas = []
    for r in range(1, rounds):
        rng = np.random.default_rng(8_000_000 + tenant_i * 10_000 + r)
        idx = np.sort(rng.choice(n_nodes, 16, replace=False))
        node["used_req"][idx, CPU] = rng.integers(0, 40000, idx.size)
        delta = {"idx": idx.astype(np.int32),
                 "base_epoch": np.asarray(r - 1, np.int64),
                 "epoch": np.asarray(r, np.int64)}
        delta.update({f: node[f][idx].copy() for f in STAGED_NODE_FIELDS})
        deltas.append(dict(node={}, params=params, pods=tick_pods(r),
                           node_delta=delta))
    return establish, deltas


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def density_arm(streams, request_cls, solve: Callable, make_cache: Callable,
                manager, budget_worlds: Optional[int], world_bytes: int, *,
                warmup: int = DENSITY.warmup,
                clock: Callable[[], float] = time.perf_counter,
                on_round: Optional[Callable[[int], None]] = None):
    """One serve of every stream under ``budget_worlds`` resident worlds
    (None: unbudgeted), config #21's ``run_arm``: ``manager`` is the
    package's ``WORKING_SET``, ``make_cache(i)`` a tenant's
    ``NodeStateCache`` (best-effort lane), ``solve(request, cache)`` its
    ``solve_from_request``, ``request_cls`` its ``SolveRequest``.
    ``on_round(r)`` runs before each timed round. Returns ``(pods/s over
    the timed rounds, per-(tenant, round) digests of the placements and
    used_req, ladder counts)``."""
    manager.reset()
    if budget_worlds is not None:
        # half a world of slack keeps the line strictly between K and
        # K+1 resident worlds
        manager.set_budget(budget_worlds * world_bytes + world_bytes // 2)
    caches = [make_cache(i) for i in range(len(streams))]
    digests = []
    try:
        for i, (establish, _) in enumerate(streams):
            resp = solve(request_cls(**establish), caches[i])
            if resp.error:
                raise RuntimeError(f"tenant {i} establish: {resp.error}")
        before = manager.status()
        t0 = None
        placed = 0
        rounds = len(streams[0][1])
        for r in range(rounds):
            if r == warmup:
                before = manager.status()
                t0 = clock()
            if t0 is not None and on_round is not None:
                on_round(r)
            for i, (_, deltas) in enumerate(streams):
                resp = solve(request_cls(**deltas[r]), caches[i])
                if resp.error:
                    raise RuntimeError(
                        f"tenant {i} round {r + 1}: {resp.error}")
                if t0 is not None:
                    a = np.asarray(resp.assignments)
                    placed += int(np.sum(a >= 0))
                    digests.append((i, r, int(a.astype(np.int64).sum()),
                                    _sha(a),
                                    _sha(np.asarray(resp.node_used_req))))
        wall = clock() - t0
        st = manager.status()
        ladder = {
            "restages": sum(st["restages"].values())
            - sum(before["restages"].values()),
            "demotions": sum(st["demotions"].values())
            - sum(before["demotions"].values()),
            "resident_device": st["residents"]["device"],
        }
        return (placed / wall if wall > 0 else 0.0), digests, ladder
    finally:
        for cache in caches:
            cache.close()
        manager.reset()
