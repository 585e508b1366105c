"""The port's joint place+evict (``ops/preempt.py``, the resident-pod world,
the model's ``*_device`` methods and the host oracle) against the JAX
package, bit for bit, on seeded worlds built identically for both
packages (counterpart of ``tests/test_preempt_device.py`` and the oracle
half of ``tests/test_quota_preemption.py``): priorities, quota groups and
preemptible flags drawn per resident, stale and missing metrics,
unschedulable nodes, quotas with and over their runtime, the LoadAware
.5 boundary, and requests near ``2**31 - 1`` where the int32 sums wrap."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import PriorityClass as JPriorityClass
from koordinator_tpu.apis.extension import QoSClass as JQoSClass
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu.ops import preempt as jpreempt
from koordinator_tpu.ops.binpack import SolverConfig as JSolverConfig
from koordinator_tpu.scheduler import preemption as jpreemption
from koordinator_tpu.state import cluster as jcluster
from koordinator_tpu_torch import convert
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import PriorityClass as TPriorityClass
from koordinator_tpu_torch.apis.extension import QoSClass as TQoSClass
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops import preempt as tpreempt
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.scheduler import preemption as tpreemption
from koordinator_tpu_torch.state import cluster as tcluster

CPU, MEM = 0, 1
QUOTAS = [None, "team-a", "team-b"]
I32 = np.iinfo(np.int32)
CONFIG = JSolverConfig()
j_select = jax.jit(jpreempt.select_victims, static_argnums=0)
j_scan = jax.jit(jpreempt.preempt_scan, static_argnums=0)
j_repack = jax.jit(jpreempt.headroom_repack, static_argnums=0)


class Pkg:
    """One package's typed objects and functions, built from plain data."""

    def __init__(self, types, resource, prio, qos, cluster, preemption):
        self.types, self.resource = types, resource
        self.prio, self.qos = prio, qos
        self.cluster, self.preemption = cluster, preemption

    def res(self, d):
        return {self.resource(k): v for k, v in d.items()}

    def snapshot(self, spec):
        t = self.types
        nodes = [t.NodeSpec(name=n["name"], allocatable=self.res(n["alloc"]),
                            unschedulable=n["unsched"])
                 for n in spec["nodes"]]
        pods = [self.pod(p) for p in spec["pods"]]
        metrics = {m["node"]: t.NodeMetric(
            node_name=m["node"], node_usage=self.res(m["usage"]),
            update_time=m["t"]) for m in spec["metrics"]}
        return t.ClusterSnapshot(nodes=nodes, pods=pods,
                                 node_metrics=metrics, now=120.0)

    def pod(self, d):
        return self.types.PodSpec(
            name=d["name"], node_name=d.get("node"),
            requests=self.res(d["req"]), qos=self.qos(d.get("qos", 0)),
            priority_class=(self.prio.PROD if d.get("prod")
                            else None if "prod" not in d else self.prio.NONE),
            priority=d["prio"], preemptible=d.get("preemptible", True),
            quota=d.get("quota"), is_daemonset=d.get("ds", False),
            assign_time=d.get("at", 0.0))


REF = Pkg(jtypes, JResourceName, JPriorityClass, JQoSClass, jcluster,
          jpreemption)
PORT = Pkg(ttypes, TResourceName, TPriorityClass, TQoSClass, tcluster,
           tpreemption)


def storm_spec(rng, n_nodes=12, n_residents=60, stale_frac=0.15,
               unsched_frac=0.1, metric_frac=0.8):
    """A diverse resident world as plain data (``storm_cluster`` of
    ``tests/test_preempt_device.py``, drawn in the same order)."""
    nodes, pods, metrics = [], [], []
    for i in range(n_nodes):
        nodes.append(dict(
            name=f"n{i}",
            alloc={CPU: int(rng.integers(8000, 32000)),
                   MEM: int(rng.integers(16384, 65536))},
            unsched=bool(rng.random() < unsched_frac)))
    for j in range(n_residents):
        node = nodes[int(rng.integers(n_nodes))]
        pods.append(dict(
            name=f"p{j}", node=node["name"],
            req={CPU: int(rng.integers(500, 6000)),
                 MEM: int(rng.integers(512, 8192))},
            qos=int(JQoSClass.BE), prio=int(rng.integers(0, 6) * 500),
            preemptible=bool(rng.random() < 0.8),
            quota=QUOTAS[int(rng.integers(len(QUOTAS)))],
            at=float(rng.integers(0, 40))))
    for node in nodes:
        if rng.random() < metric_frac:
            cap = node["alloc"]
            metrics.append(dict(
                node=node["name"],
                usage={CPU: int(rng.integers(0, int(cap[CPU] * 1.05))),
                       MEM: int(rng.integers(0, int(cap[MEM] * 1.05)))},
                t=-1000.0 if rng.random() < stale_frac else 100.0))
    return dict(nodes=nodes, pods=pods, metrics=metrics)


def preemptor_spec(rng, k=0):
    return dict(
        name=f"ls{k}",
        req={CPU: int(rng.integers(2000, 12000)),
             MEM: int(rng.integers(2048, 16384))},
        qos=int(JQoSClass.LS), prod=bool(rng.random() < 0.5),
        prio=int(rng.integers(1000, 4000)),
        quota=QUOTAS[int(rng.integers(len(QUOTAS)))],
        ds=bool(rng.random() < 0.1))


class World:
    """Both packages' snapshot, node arrays and resident world of one
    spec, with a model of each (CPU)."""

    def __init__(self, spec, **model_kw):
        self.spec = spec
        self.jm = JPlacementModel(use_pallas=False, **{
            k: REF.res(v) for k, v in model_kw.items()})
        self.tm = PlacementModel(device="cpu", **{
            k: PORT.res(v) for k, v in model_kw.items()})
        self.jsnap, self.tsnap = REF.snapshot(spec), PORT.snapshot(spec)
        self.jarr = jcluster.lower_nodes(self.jsnap,
                                         **self.jm.lowering_kwargs())
        self.tarr = tcluster.lower_nodes(self.tsnap,
                                         **self.tm.lowering_kwargs())
        self.jres = self.jm.lower_residents(self.jsnap, self.jarr)
        self.tres = self.tm.lower_residents(self.tsnap, self.tarr)

    def thresholds(self):
        return (np.asarray(self.jm.params.thresholds),
                np.asarray(self.jm.params.prod_thresholds))

    def oracle(self, pkg, pod_d, quota_used=None, used_limit=None):
        snap, arr = ((self.jsnap, self.jarr) if pkg is REF
                     else (self.tsnap, self.tarr))
        thr, pthr = self.thresholds()
        want = pkg.preemption.find_preemption(
            snap, pkg.pod(pod_d), quota_used=quota_used,
            used_limit=used_limit, arrays=arr, thresholds=thr,
            prod_thresholds=pthr)
        return None if want is None else (want[0], [v.uid for v in want[1]])

    def device(self, pod_d, quota_used=None, used_limit=None):
        """The JAX and the port model's ``select_victims_device``."""
        got_j = self.jm.select_victims_device(
            self.jarr, self.jres, REF.pod(pod_d), quota_used=quota_used,
            used_limit=used_limit)
        got_t = self.tm.select_victims_device(
            self.tarr, self.tres, PORT.pod(pod_d), quota_used=quota_used,
            used_limit=used_limit)
        return got_j, got_t


def _world_dict(res):
    return dict(req=res.req, priority=res.priority, quota_id=res.quota_id,
                preemptible=res.preemptible, valid=res.valid)


def _node_args(arr):
    return (arr.alloc, arr.used_req, arr.usage, arr.prod_usage,
            arr.metric_fresh, arr.schedulable)


def _same(got, want, ctx=""):
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(np.zeros(0, w.dtype)).dtype, (
            ctx, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{ctx} out {k}")


def _select_both(jres, arrays, pod_args, thr):
    """``select_victims`` of both packages on the same numpy inputs."""
    want = j_select(CONFIG, *pod_args, *_node_args(arrays),
                    jres.node_rank, *thr, jpreempt.ResidentWorld(
                        **_world_dict(jres)))
    t = [torch.as_tensor(np.array(a)) for a in (
        *pod_args, *_node_args(arrays), jres.node_rank, *thr)]
    got = tpreempt.select_victims(
        *t, convert.resident_world(_world_dict(jres), device="cpu"))
    return got, want


def _pod_args(jres, pod_d, quota_used=None, used_limit=None):
    req = jcluster._clip_i32(jtypes.resources_to_vector(
        REF.res(pod_d["req"])))
    zeros = np.zeros_like(req)
    is_prod = REF.pod(pod_d).priority_class == JPriorityClass.PROD
    return (req, np.int32(pod_d["prio"]),
            np.int32(jres.quota_id_of(pod_d.get("quota"))),
            np.bool_(pod_d.get("ds", False)), np.bool_(is_prod),
            zeros if quota_used is None else quota_used.astype(np.int32),
            zeros if used_limit is None else used_limit.astype(np.int32),
            np.bool_(quota_used is not None))


@pytest.mark.parametrize("seed", range(6))
def test_select_victims_matches_reference(seed):
    """``select_victims`` (every output), the model's
    ``select_victims_device`` and the host oracle, without the quota gate:
    the port == the JAX package == the oracle."""
    rng = np.random.default_rng(seed)
    w = World(storm_spec(rng))
    hits = 0
    for k in range(6):
        pod_d = preemptor_spec(rng, k)
        got, want = _select_both(w.jres, w.jarr, _pod_args(w.jres, pod_d),
                                 w.thresholds())
        _same(got, want, f"seed {seed} pod {k}")
        got_j, got_t = w.device(pod_d)
        assert got_t == got_j == w.oracle(REF, pod_d) == w.oracle(
            PORT, pod_d), (seed, k)
        hits += got_t is not None
    assert hits > 0


@pytest.mark.parametrize("seed", range(4))
def test_quota_gate_matches_reference(seed):
    """The reprieve gate armed: with headroom the reprieve runs; over the
    runtime nothing is reprieved (every candidate evicted)."""
    rng = np.random.default_rng(100 + seed)
    w = World(storm_spec(rng, stale_frac=0.0, unsched_frac=0.0))
    for k in range(6):
        pod_d = preemptor_spec(rng, k)
        pod_d["quota"] = pod_d["quota"] or "team-a"
        headroom = bool(rng.random() < 0.5)
        req = jtypes.resources_to_vector(REF.res(pod_d["req"]))
        quota_used = np.full(len(req), int(rng.integers(0, 20000)),
                             dtype=np.int64)
        used_limit = quota_used + req + 10000 if headroom else quota_used
        got, want = _select_both(
            w.jres, w.jarr, _pod_args(w.jres, pod_d, quota_used, used_limit),
            w.thresholds())
        _same(got, want, f"seed {seed} pod {k} headroom {headroom}")
        got_j, got_t = w.device(pod_d, quota_used, used_limit)
        assert got_t == got_j == w.oracle(
            PORT, pod_d, quota_used, used_limit), (seed, k, headroom)


def test_quota_over_runtime_evicts_every_candidate_in_order():
    spec = dict(
        nodes=[dict(name="n0", alloc={CPU: 10000, MEM: 65536},
                    unsched=False)],
        pods=[dict(name=f"b{j}", node="n0", req={CPU: 2000, MEM: 1024},
                   prio=[300, 100, 300, 200][j],
                   at=[5.0, 1.0, 2.0, 9.0][j], quota="q")
              for j in range(4)],
        metrics=[])
    w = World(spec)
    pod_d = dict(name="ls", req={CPU: 4000, MEM: 2048}, prio=900, quota="q")
    quota_used = np.full(len(jtypes.resources_to_vector({})), 100)
    got_j, got_t = w.device(pod_d, quota_used, quota_used)
    assert got_t == got_j == w.oracle(PORT, pod_d, quota_used, quota_used)
    assert got_t[1] == ["default/b2", "default/b0", "default/b3",
                        "default/b1"]


def test_loadaware_half_boundary_matches_reference():
    """used=23 of 40 is exactly 57.5%, rounded to 58: at a threshold of 58
    the node fails (eviction cannot help), at 59 it passes."""
    spec = dict(
        nodes=[dict(name="n0", alloc={CPU: 40, MEM: 65536}, unsched=False)],
        pods=[dict(name=f"b{j}", node="n0", req={CPU: 10, MEM: 16384},
                   prio=100, at=float(j)) for j in range(3)],
        metrics=[dict(node="n0", usage={CPU: 23, MEM: 0}, t=100.0)])
    pod_d = dict(name="ls", req={CPU: 25, MEM: 1024}, prio=900)
    for thr, hit in ((58, False), (59, True)):
        w = World(spec, usage_thresholds={CPU: thr})
        got, want = _select_both(w.jres, w.jarr, _pod_args(w.jres, pod_d),
                                 w.thresholds())
        _same(got, want, f"threshold {thr}")
        got_j, got_t = w.device(pod_d)
        assert got_t == got_j == w.oracle(PORT, pod_d)
        assert (got_t is not None) == hit


def _batch(jres, pod_ds, rows):
    k = len(pod_ds)
    args = [_pod_args(jres, d, *(rows[i] or (None, None)))
            for i, d in enumerate(pod_ds)]
    return dict(
        req=np.stack([a[0] for a in args]),
        priority=np.array([a[1] for a in args], np.int32),
        quota_id=np.array([a[2] for a in args], np.int32),
        is_daemonset=np.array([a[3] for a in args]),
        is_prod=np.array([a[4] for a in args]),
        quota_used=np.stack([a[5] for a in args]),
        used_limit=np.stack([a[6] for a in args]),
        quota_enabled=np.array([a[7] for a in args]),
        active=np.arange(k) < k - 1)   # the last row is a padding no-op


@pytest.mark.parametrize("seed", range(4))
def test_preempt_scan_matches_reference(seed):
    """``preempt_scan`` (a quota group per preemptor, so no two overlap)
    == the JAX scan, and the model's ``preempt_scan_device`` == the JAX
    model's == the per-pod path with evictions in between."""
    rng = np.random.default_rng(300 + seed)
    w = World(storm_spec(rng))
    pod_ds = [preemptor_spec(rng, k) for k in range(6)]
    rows = []
    for i, d in enumerate(pod_ds):
        # disjoint quotas: a pod with a group gets a row of its own
        if d["quota"] is not None and i % 2 == 0:
            req = jtypes.resources_to_vector(REF.res(d["req"]))
            used = np.full(len(req), 1000, dtype=np.int64)
            rows.append((used, used + (req if i % 4 else 0) + 5))
        else:
            rows.append(None)
    batch = _batch(w.jres, pod_ds, rows)
    thr = w.thresholds()
    want = j_scan(CONFIG, jpreempt.PreemptorBatch(**batch),
                  *_node_args(w.jarr), w.jres.node_rank, *thr,
                  jpreempt.ResidentWorld(**_world_dict(w.jres)))
    t = [torch.as_tensor(np.array(a)) for a in (
        *_node_args(w.jarr), w.jres.node_rank, *thr)]
    got = tpreempt.preempt_scan(
        convert.preemptor_batch(batch, device="cpu"), *t,
        convert.resident_world(_world_dict(w.jres), device="cpu"))
    _same(got, want, f"seed {seed}")
    assert int(got[0][-1]) == -1 and not bool(got[1][-1].any())

    scanned_j = w.jm.preempt_scan_device(
        w.jarr, w.jres, [REF.pod(d) for d in pod_ds], quota_rows=rows)
    scanned_t = w.tm.preempt_scan_device(
        w.tarr, w.tres, [PORT.pod(d) for d in pod_ds], quota_rows=rows)
    assert scanned_t == scanned_j
    assert any(s is not None for s in scanned_t)
    # the per-pod path with the evictions applied in turn
    seq = World(w.spec)
    for k, d in enumerate(pod_ds):
        r = rows[k] or (None, None)
        got_k = seq.tm.select_victims_device(seq.tarr, seq.tres, PORT.pod(d),
                                             quota_used=r[0],
                                             used_limit=r[1])
        assert got_k == scanned_t[k], k
        if got_k is not None:
            tcluster.evict_resident_rows(seq.tsnap, seq.tarr, seq.tres,
                                         *got_k, **seq.tm.lowering_kwargs())


@pytest.mark.parametrize("seed", range(4))
def test_headroom_repack_matches_reference(seed):
    """``headroom_repack`` (every output), ``plan_defrag_device`` and the
    host ``plan_defrag``: the port == the JAX package == the oracle,
    including the no-drain answer when the hole already fits."""
    rng = np.random.default_rng(400 + seed)
    w = World(storm_spec(rng))
    for k in range(4):
        target_d = {CPU: int(rng.integers(4000, 20000)),
                    MEM: int(rng.integers(4096, 32768))}
        max_prio = int(rng.integers(500, 3000))
        target = jtypes.resources_to_vector(REF.res(target_d))
        args = (target.astype(np.int32), np.int32(max_prio),
                w.jarr.alloc, w.jarr.used_req, w.jarr.schedulable,
                w.jres.node_rank)
        want = j_repack(CONFIG, *args, jpreempt.ResidentWorld(
            **_world_dict(w.jres)))
        got = tpreempt.headroom_repack(
            *[torch.as_tensor(np.array(a)) for a in args],
            convert.resident_world(_world_dict(w.jres), device="cpu"))
        _same(got, want, f"seed {seed} target {k}")
        got_j = w.jm.plan_defrag_device(w.jarr, w.jres, target, max_prio)
        got_t = w.tm.plan_defrag_device(w.tarr, w.tres, target, max_prio)
        plans = [pkg.preemption.plan_defrag(snap, target, max_prio,
                                            arrays=arr)
                 for pkg, snap, arr in ((REF, w.jsnap, w.jarr),
                                        (PORT, w.tsnap, w.tarr))]
        want_j, want_t = [None if p is None else (p[0], [v.uid for v in p[1]])
                          for p in plans]
        assert got_t == got_j == want_t == want_j, (seed, k)


def test_int32_wrap_matches_reference():
    """Requests near ``2**31 - 1``: ``removed`` and ``n_victims`` of
    ``select_victims``, ``freed`` of ``preempt_scan`` and both prefix
    sums of ``headroom_repack`` wrap in int32 as in the JAX package (the
    host oracle sums in int64 and differs here: a known disagreement
    inside the reference, so no oracle on this input)."""
    n, p, r = 3, 4, len(jtypes.resources_to_vector({}))
    big = I32.max - 5
    req = np.zeros((n, p, r), np.int32)
    req[:, :, CPU] = big
    req[:, :, MEM] = [[big, 7, big, 3]] * n
    world = dict(req=req, priority=np.full((n, p), 10, np.int32),
                 quota_id=np.zeros((n, p), np.int32),
                 preemptible=np.ones((n, p), bool),
                 valid=np.array([[1, 1, 1, 1], [1, 1, 0, 1], [1, 1, 1, 0]],
                                bool))
    alloc = np.full((n, r), I32.max, np.int32)
    used = np.full((n, r), big, np.int32)
    usage = np.zeros((n, r), np.int32)
    fresh = np.ones(n, bool)
    sched = np.ones(n, bool)
    rank = np.arange(n, dtype=np.int32)
    thr = (np.zeros(r, np.int32), np.zeros(r, np.int32))
    pod_req = np.zeros(r, np.int32)
    pod_req[CPU] = 9
    pod_args = (pod_req, np.int32(100), np.int32(0), np.bool_(False),
                np.bool_(False), np.zeros(r, np.int32), np.zeros(r, np.int32),
                np.bool_(False))
    node_args = (alloc, used, usage, usage, fresh, sched)
    want = j_select(CONFIG, *pod_args, *node_args, rank, *thr,
                    jpreempt.ResidentWorld(**world))
    tw = convert.resident_world(world, device="cpu")
    t = [torch.as_tensor(np.array(a)) for a in (*pod_args, *node_args, rank,
                                                *thr)]
    got = tpreempt.select_victims(*t, tw)
    _same(got, want, "select_victims")
    # the removed sum wrapped: kept0 = used - removed is far from int64's
    removed64 = (req.astype(np.int64) * world["valid"][..., None]).sum(1)
    assert (removed64 > I32.max).any()

    batch = dict(req=np.stack([pod_req] * 3), priority=np.full(3, 100,
                                                               np.int32),
                 quota_id=np.zeros(3, np.int32),
                 is_daemonset=np.zeros(3, bool), is_prod=np.zeros(3, bool),
                 quota_used=np.zeros((3, r), np.int32),
                 used_limit=np.zeros((3, r), np.int32),
                 quota_enabled=np.zeros(3, bool), active=np.ones(3, bool))
    want = j_scan(CONFIG, jpreempt.PreemptorBatch(**batch), *node_args, rank,
                  *thr, jpreempt.ResidentWorld(**world))
    got = tpreempt.preempt_scan(convert.preemptor_batch(batch, device="cpu"),
                                *t[8:], tw)
    _same(got, want, "preempt_scan")

    for target_cpu in (9, big, I32.max):
        target = np.zeros(r, np.int32)
        target[CPU] = target_cpu
        args = (target, np.int32(50), alloc, used, sched, rank)
        want = j_repack(CONFIG, *args, jpreempt.ResidentWorld(**world))
        got = tpreempt.headroom_repack(
            *[torch.as_tensor(np.array(a)) for a in args], tw)
        _same(got, want, f"headroom_repack {target_cpu}")


def _resident_fields(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


def _pad_residents(res, p):
    """``res`` with its P axis padded to ``p`` columns as the reference's
    bucket pads it: no requests, priority 0, quota id -3, not preemptible,
    not valid."""
    width = ((0, 0), (0, p - res.p))
    return dataclasses.replace(
        res,
        req=np.pad(res.req, width + ((0, 0),)),
        priority=np.pad(res.priority, width),
        quota_id=np.pad(res.quota_id, width, constant_values=-3),
        preemptible=np.pad(res.preemptible, width),
        valid=np.pad(res.valid, width))


def _same_residents(tres, jres, ctx=""):
    """Every field of the port's world equals the reference's (which also
    keeps the widest row's count, for its padding statistics)."""
    t, j = _resident_fields(tres), _resident_fields(jres)
    assert t.keys() == j.keys() - {"max_residents"}
    for name in t:
        if isinstance(j[name], np.ndarray):
            assert t[name].dtype == j[name].dtype, (ctx, name)
            np.testing.assert_array_equal(t[name], j[name],
                                          err_msg=f"{ctx}: {name}")
        else:
            assert t[name] == j[name], (ctx, name)


@pytest.mark.parametrize("seed", range(3))
def test_resident_lowering_and_eviction_match_reference(seed):
    """``lower_resident_pods`` (every field, unpadded and padded to the
    reference's bucket) and ``evict_resident_rows``: the resident world,
    the snapshot, the tracker's mark and the re-lowered node row equal
    the JAX package's in-place row and a fresh lowering, eviction after
    eviction."""
    rng = np.random.default_rng(200 + seed)
    w = World(storm_spec(rng))
    _same_residents(_pad_residents(w.tres, w.jres.p), w.jres, "bucketed")
    jres = jcluster.lower_resident_pods(w.jsnap, w.jarr)
    _same_residents(w.tres, jres)
    assert w.tres.quota_id_of("nobody") == -2
    w.tsnap.delta_tracker = tcluster.ClusterDeltaTracker()
    evictions = 0
    for k in range(6):
        pod_d = preemptor_spec(rng, k)
        got = w.tm.select_victims_device(w.tarr, w.tres, PORT.pod(pod_d))
        if got is None:
            continue
        node, uids = got
        assert w.tres.columns_of(w.tarr.index()[node], uids) == \
            jres.columns_of(w.jarr.index()[node], uids)
        rows_t = tcluster.evict_resident_rows(w.tsnap, w.tarr, w.tres, node,
                                              uids, **w.tm.lowering_kwargs())
        rows_j = jcluster.evict_resident_rows(w.jsnap, w.jarr, jres, node,
                                              uids, **w.jm.lowering_kwargs())
        np.testing.assert_array_equal(rows_t, rows_j)
        assert node in w.tsnap.delta_tracker.dirty_since(0)
        assert [p.uid for p in w.tsnap.pods] == [p.uid for p in w.jsnap.pods]
        _same_residents(w.tres, jres, f"eviction {k}")
        fresh = tcluster.lower_nodes(w.tsnap, **w.tm.lowering_kwargs())
        for f in STAGED_NODE_FIELDS:
            np.testing.assert_array_equal(getattr(w.tarr, f),
                                          getattr(w.jarr, f), err_msg=f)
            np.testing.assert_array_equal(getattr(w.tarr, f),
                                          getattr(fresh, f), err_msg=f)
        evictions += 1
    assert evictions > 0


def test_staged_world_copies_the_host_arrays():
    """A CPU world shares no memory with the resident arrays: an eviction
    writes ``resident.valid`` in place, and a staged world must keep the
    value it was staged with until it is restaged."""
    rng = np.random.default_rng(5)
    w = World(storm_spec(rng, unsched_frac=0.0))
    world = w.tm.resident_world(w.tres)
    for name in world._fields:
        assert not np.shares_memory(getattr(world, name).numpy(),
                                    getattr(w.tres, name)), name
    before = world.valid.clone()
    w.tres.valid[:] = False
    assert torch.equal(world.valid, before)


@pytest.mark.parametrize("seed", range(2))
def test_victim_padding_is_inert(seed):
    """The same world with its P axis padded (as the reference's bucket
    pads it, here wider) and unpadded gives the same answers on every
    device method."""
    rng = np.random.default_rng(7 + seed)
    w = World(storm_spec(rng, stale_frac=0.0, unsched_frac=0.0))
    padded = _pad_residents(w.tres, 2 * w.tres.p + 3)
    assert padded.p > w.tres.p
    pods = [PORT.pod(preemptor_spec(rng, k)) for k in range(4)]
    for pod in pods:
        assert (w.tm.select_victims_device(w.tarr, padded, pod)
                == w.tm.select_victims_device(w.tarr, w.tres, pod))
    assert (w.tm.preempt_scan_device(w.tarr, padded, pods)
            == w.tm.preempt_scan_device(w.tarr, w.tres, pods))
    target = jtypes.resources_to_vector(REF.res({CPU: 9000, MEM: 9000}))
    assert (w.tm.plan_defrag_device(w.tarr, padded, target, 2000)
            == w.tm.plan_defrag_device(w.tarr, w.tres, target, 2000))


@pytest.mark.parametrize("seed", range(3))
def test_host_oracle_matches_reference(seed):
    """The port's ``find_preemption`` (with and without quota rows, with
    its own lowering when given no arrays), ``can_preempt`` and
    ``plan_defrag`` == the reference's, eviction after eviction."""
    rng = np.random.default_rng(500 + seed)
    spec = storm_spec(rng)
    jsnap, tsnap = REF.snapshot(spec), PORT.snapshot(spec)
    for k in range(5):
        pod_d = preemptor_spec(rng, k)
        jp, tp = REF.pod(pod_d), PORT.pod(pod_d)
        assert ([tpreemption.can_preempt(tp, v) for v in tsnap.pods]
                == [jpreemption.can_preempt(jp, v) for v in jsnap.pods])
        rows = (None, None)
        if k % 2:
            used = np.full(len(jtypes.resources_to_vector({})), 500)
            rows = (used, used + int(rng.integers(0, 8000)))
        want = jpreemption.find_preemption(jsnap, jp, *rows)
        got = tpreemption.find_preemption(tsnap, tp, *rows)
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert got[0] == want[0]
        assert [v.uid for v in got[1]] == [v.uid for v in want[1]]
        gone = {v.uid for v in got[1]}
        jsnap.pods = [p for p in jsnap.pods if p.uid not in gone]
        tsnap.pods = [p for p in tsnap.pods if p.uid not in gone]
        target = jtypes.resources_to_vector(REF.res(pod_d["req"]))
        for prio in (1000, 3000):
            want = jpreemption.plan_defrag(jsnap, target, prio)
            got = tpreemption.plan_defrag(tsnap, target, prio)
            assert (None if got is None else (got[0], [v.uid for v in got[1]])
                    ) == (None if want is None
                          else (want[0], [v.uid for v in want[1]]))
