"""Delta lowering and the staging cache of the port, held against a full
lowering and staging and against the JAX package on the same seeded
event streams (counterpart of ``tests/test_state_delta.py``).

One world is kept as plain data and built into each package's snapshot
every round; each random event is drawn once, applied to the data and
marked on both packages' trackers, so both see the same stream."""

import numpy as np
import pytest
import torch

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import PriorityClass as JPriorityClass
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.models import placement as jplacement
from koordinator_tpu.state import cluster as jcluster
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import PriorityClass as TPriorityClass
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.models.placement import (
    NodeStagingDelta,
    PlacementModel,
    StagedStateCache,
    merge_staging_deltas,
)
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.state import cluster as tcluster
from koordinator_tpu_torch.state.cluster import (
    ClusterDeltaTracker,
    lower_nodes,
    lower_nodes_delta,
)

CPU, MEM = 0, 1
REF = (jtypes, JResourceName, JPriorityClass)
PORT = (ttypes, TResourceName, TPriorityClass)


# -- the world as data ---------------------------------------------------------

def _node(i, rng, unsched_p=0.05):
    return dict(name=f"n{i}",
                alloc={CPU: int(rng.integers(8000, 64000)),
                       MEM: int(rng.integers(8192, 131072))},
                unsched=bool(rng.random() < unsched_p))


def _pod(j, rng, node_name=None):
    prod = bool(rng.random() < 0.4)
    return dict(name=f"p{j}", node=node_name,
                req={CPU: int(rng.integers(100, 4000)),
                     MEM: int(rng.integers(64, 4096))},
                lim=({CPU: int(rng.integers(100, 5000))}
                     if rng.random() < 0.3 else {}),
                prod=prod,
                at=float(rng.integers(0, 400)) if node_name else 0.0)


def _metric(now, rng, pods=()):
    return dict(usage={CPU: int(rng.integers(0, 32000)),
                       MEM: int(rng.integers(0, 65536))},
                t=float(now - rng.integers(0, 300)),
                pod_usages={f"default/{p['name']}": {
                    CPU: int(rng.integers(0, 2000)),
                    MEM: int(rng.integers(0, 2048))}
                    for p in pods if rng.random() < 0.7})


def _world(rng, n_nodes=24):
    nodes = [_node(i, rng) for i in range(n_nodes)]
    pods = [_pod(j, rng, nodes[int(rng.integers(0, n_nodes))]["name"])
            for j in range(3 * n_nodes)]
    metrics = {}
    for node in nodes:
        if rng.random() < 0.8:
            on = [p for p in pods if p["node"] == node["name"]]
            metrics[node["name"]] = _metric(400.0, rng, on)
    resvs = [dict(name=f"r{k}",
                  node=nodes[int(rng.integers(0, n_nodes))]["name"],
                  req={CPU: int(rng.integers(500, 4000)),
                       MEM: int(rng.integers(256, 4096))},
                  allocated={}, state="Available")
             for k in range(6)]
    return dict(nodes=nodes, pods=pods, metrics=metrics, resvs=resvs,
                pending=[], now=400.0)


def _snap(pkg, w, tracker):
    types, resource, prio = pkg

    def res(d):
        return {resource(k): v for k, v in d.items()}

    def pod(p):
        return types.PodSpec(
            name=p["name"], node_name=p["node"], requests=res(p["req"]),
            limits=res(p["lim"]), assign_time=p["at"],
            priority_class=prio.PROD if p["prod"] else prio.NONE,
            quota=p.get("quota"), gang=p.get("gang"))

    return types.ClusterSnapshot(
        nodes=[types.NodeSpec(name=n["name"], allocatable=res(n["alloc"]),
                              unschedulable=n["unsched"])
               for n in w["nodes"]],
        pods=[pod(p) for p in w["pods"]],
        pending_pods=[pod(p) for p in w["pending"]],
        node_metrics={
            name: types.NodeMetric(
                node_name=name, node_usage=res(m["usage"]),
                update_time=m["t"],
                pod_usages={u: res(v) for u, v in m["pod_usages"].items()})
            for name, m in w["metrics"].items()},
        quotas={name: types.QuotaSpec(name=name, parent="root",
                                      min=res(q["min"]), max=res(q["max"]))
                for name, q in w.get("quotas", {}).items()},
        gangs={name: types.GangSpec(name=name, min_member=g["min"],
                                    mode=types.GangMode(g["mode"]))
               for name, g in w.get("gangs", {}).items()},
        reservations=[types.ReservationSpec(
            name=r["name"], node_name=r["node"], requests=res(r["req"]),
            allocated=res(r["allocated"]),
            state=types.ReservationState(r["state"])) for r in w["resvs"]],
        now=w["now"], delta_tracker=tracker)


def _mutate(w, trackers, rng, counters):
    """One random event on the data world, marked on every tracker as a
    correct producer (the scheduler cache) would mark it."""
    kind = rng.choice([
        "node_spec", "node_add", "node_remove", "pod_assign", "pod_remove",
        "metric", "metric_drop", "resv_alloc", "resv_expire", "advance_now",
    ])
    nodes = w["nodes"]

    def mark(name):
        for t in trackers:
            t.mark_node(name)

    def structure():
        for t in trackers:
            t.mark_structure()

    if kind == "node_spec":
        i = int(rng.integers(0, len(nodes)))
        nodes[i] = dict(_node(0, rng, unsched_p=0.2), name=nodes[i]["name"])
        mark(nodes[i]["name"])
    elif kind == "node_add":
        counters["node"] += 1
        nodes.append(_node(1000 + counters["node"], rng))
        structure()
    elif kind == "node_remove" and len(nodes) > 4:
        gone = nodes.pop(int(rng.integers(0, len(nodes))))
        w["pods"] = [p for p in w["pods"] if p["node"] != gone["name"]]
        w["metrics"].pop(gone["name"], None)
        structure()
    elif kind == "pod_assign":
        counters["pod"] += 1
        node = nodes[int(rng.integers(0, len(nodes)))]["name"]
        w["pods"].append(_pod(2000 + counters["pod"], rng, node))
        mark(node)
    elif kind == "pod_remove" and w["pods"]:
        gone = w["pods"].pop(int(rng.integers(0, len(w["pods"]))))
        mark(gone["node"])
    elif kind == "metric":
        node = nodes[int(rng.integers(0, len(nodes)))]["name"]
        on = [p for p in w["pods"] if p["node"] == node]
        w["metrics"][node] = _metric(w["now"], rng, on)
        mark(node)
    elif kind == "metric_drop" and w["metrics"]:
        name = list(w["metrics"])[int(rng.integers(0, len(w["metrics"])))]
        del w["metrics"][name]
        mark(name)
    elif kind == "resv_alloc":
        resv = w["resvs"][int(rng.integers(0, len(w["resvs"])))]
        resv["allocated"] = {CPU: int(rng.integers(0, 2000))}
        mark(resv["node"])
    elif kind == "resv_expire":
        resv = w["resvs"][int(rng.integers(0, len(w["resvs"])))]
        resv["state"] = "Expired"
        mark(resv["node"])
    elif kind == "advance_now":
        # no mark: the delta path must see expiry from the update times
        w["now"] += float(rng.integers(1, 120))


def _assert_arrays_equal(got, want, context, host_only=True):
    assert got.names == want.names, context
    fields = STAGED_NODE_FIELDS + (("metric_update_time",) if host_only
                                   else ())
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{context}: {f}")


def _assert_staged_equal(state, want, context):
    for f in STAGED_NODE_FIELDS:
        got_t, want_t = getattr(state, f), getattr(want, f)
        assert got_t.dtype == want_t.dtype, f"{context}: {f}"
        assert torch.equal(got_t, want_t), f"{context}: {f}"


def _fresh_staging(model, snap):
    return model.stage_nodes(lower_nodes(snap, **model.lowering_kwargs()))


# -- delta lowering --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_lowering_matches_full_and_reference(seed):
    """Random marked events: the port's ``lower_nodes_delta`` patches its
    arrays to a full ``lower_nodes``, bit for bit, returns the rows the
    reference's does, and leaves the arrays equal to the reference's."""
    rng = np.random.default_rng(seed)
    w = _world(rng)
    jt, tt = jcluster.ClusterDeltaTracker(), ClusterDeltaTracker()
    counters = {"node": 0, "pod": 0}
    tarr = lower_nodes(_snap(PORT, w, tt))
    jarr = jcluster.lower_nodes(_snap(REF, w, jt))
    seen, delta_rounds = tt.epoch, 0
    for r in range(30):
        for _ in range(int(rng.integers(1, 6))):
            _mutate(w, (jt, tt), rng, counters)
        tsnap, jsnap = _snap(PORT, w, tt), _snap(REF, w, jt)
        moved = tt.structure_epoch > seen
        tidx = lower_nodes_delta(tsnap, tarr, tt.dirty_since(seen))
        jidx = jcluster.lower_nodes_delta(jsnap, jarr, jt.dirty_since(seen))
        assert (tidx is None) == (jidx is None) == moved, f"round {r}"
        if tidx is None:
            tarr, jarr = lower_nodes(tsnap), jcluster.lower_nodes(jsnap)
        else:
            delta_rounds += 1
            np.testing.assert_array_equal(tidx, jidx)
            assert tidx.dtype == np.int32
        seen = tt.epoch
        _assert_arrays_equal(tarr, lower_nodes(tsnap), f"seed {seed} r {r}")
        _assert_arrays_equal(tarr, jarr, f"seed {seed} r {r} vs reference")
    assert delta_rounds > 10


def test_lower_node_rows_matches_reference():
    rng = np.random.default_rng(5)
    w = _world(rng)
    names = [n["name"] for n in w["nodes"]][::3]
    got = tcluster.lower_node_rows(_snap(PORT, w, None), names)
    want = jcluster.lower_node_rows(_snap(REF, w, None), names)
    full = lower_nodes(_snap(PORT, w, None))
    rows = [full.names.index(n) for n in names]
    for f in STAGED_NODE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_array_equal(got[f], getattr(full, f)[rows],
                                      err_msg=f)


def test_delta_refuses_stale_node_order():
    w = _world(np.random.default_rng(9), n_nodes=6)
    arrays = lower_nodes(_snap(PORT, w, None))
    w["nodes"].reverse()  # the same set in another order
    assert lower_nodes_delta(_snap(PORT, w, None), arrays, []) is None


def test_freshness_drift_without_marks():
    """``now`` moving past the expiration window flips ``metric_fresh``
    on rows nobody marked, and back."""
    w = _world(np.random.default_rng(4), n_nodes=10)
    arrays = lower_nodes(_snap(PORT, w, None))
    w["now"] += 10_000.0
    snap = _snap(PORT, w, None)
    idx = lower_nodes_delta(snap, arrays, [])
    assert idx is not None and idx.size > 0
    _assert_arrays_equal(arrays, lower_nodes(snap), "expired")
    assert not arrays.metric_fresh.any()
    w["now"] -= 10_000.0
    snap = _snap(PORT, w, None)
    idx = lower_nodes_delta(snap, arrays, [])
    assert idx is not None and idx.size > 0
    _assert_arrays_equal(arrays, lower_nodes(snap), "fresh again")


def test_tracker_semantics():
    t = ClusterDeltaTracker()
    e0 = t.epoch
    t.mark_node("a")
    t.mark_nodes(["b", "c"])
    assert set(t.dirty_since(e0)) == {"a", "b", "c"}
    mid = t.epoch
    t.mark_node("d")
    assert set(t.dirty_since(mid)) == {"d"}
    t.mark_structure()
    assert t.structure_epoch == t.epoch
    assert t.dirty_since(mid) == []  # a structure change resets the marks
    t.mark_node(None)  # a no-op


# -- the staging cache --------------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 12])
def test_staged_cache_matches_fresh_staging_and_reference(seed):
    """After every round of events, the cached staged state equals a
    fresh ``stage_nodes(lower_nodes(snapshot))`` and the reference
    cache's staged state; both caches take the same paths."""
    rng = np.random.default_rng(seed)
    w = _world(rng)
    jt, tt = jcluster.ClusterDeltaTracker(), ClusterDeltaTracker()
    counters = {"node": 0, "pod": 0}
    model = PlacementModel(device="cpu")
    cache = StagedStateCache(model)
    jcache = jplacement.StagedStateCache(
        jplacement.PlacementModel(use_pallas=False))
    paths = []
    for r in range(12):
        for _ in range(int(rng.integers(1, 5))):
            _mutate(w, (jt, tt), rng, counters)
        tsnap = _snap(PORT, w, tt)
        _, state, _, (epoch, delta) = cache.ensure(tsnap)
        _, jstate, _, (jepoch, jdelta) = jcache.ensure(_snap(REF, w, jt))
        paths.append(cache.last_path)
        assert cache.last_path == jcache.last_path, f"round {r}"
        assert epoch == jepoch
        assert (delta.base_epoch is None) == (jdelta.base_epoch is None)
        _assert_staged_equal(state, _fresh_staging(model, tsnap), f"r {r}")
        for f in STAGED_NODE_FIELDS:
            np.testing.assert_array_equal(
                getattr(state, f).numpy(), np.asarray(getattr(jstate, f)),
                err_msg=f"round {r} vs reference: {f}")
    assert "delta" in paths and paths[0] == "full"


def test_staged_tensors_do_not_share_host_memory():
    """On the CPU, staging copies: the staged tensors share no memory with
    the host arrays the cache patches in place, on the full path and on
    the delta path's re-established state."""
    rng = np.random.default_rng(3)
    w = _world(rng, n_nodes=8)
    tracker = ClusterDeltaTracker()
    model = PlacementModel(device="cpu")
    cache = model.staged_cache
    arrays, state, _, _ = cache.ensure(_snap(PORT, w, tracker))
    before = {f: getattr(state, f).clone() for f in STAGED_NODE_FIELDS}
    for f in STAGED_NODE_FIELDS:
        assert not np.shares_memory(getattr(state, f).numpy(),
                                    getattr(arrays, f)), f
    # a host-side patch with no scatter must not reach the staged state
    arrays.used_req += 1
    arrays.metric_fresh[:] = ~arrays.metric_fresh
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(state, f), before[f]), f
    cache.invalidate()
    _, _, _, _ = cache.ensure(_snap(PORT, w, tracker), want_device=False)
    w["nodes"][2]["alloc"] = {CPU: 1234, MEM: 5678}
    tracker.mark_node("n2")
    arrays, state, _, _ = cache.ensure(_snap(PORT, w, tracker))
    assert cache.last_path == "delta"
    for f in STAGED_NODE_FIELDS:
        assert not np.shares_memory(getattr(state, f).numpy(),
                                    getattr(arrays, f)), f


def test_pinned_generation_untouched_by_delta_ensure():
    """A generation a dispatched solve holds is never written: a delta
    ``ensure`` writes a new generation beside it; once unpinned, the next
    delta writes in place."""
    rng = np.random.default_rng(8)
    w = _world(rng, n_nodes=12)
    tracker = ClusterDeltaTracker()
    model = PlacementModel(device="cpu")
    cache = model.staged_cache
    _, pinned, _, _ = cache.ensure(_snap(PORT, w, tracker))
    cache.pin(pinned)
    kept = {f: getattr(pinned, f).clone() for f in STAGED_NODE_FIELDS}
    w["nodes"][3]["alloc"] = {CPU: 1111, MEM: 2222}
    w["metrics"]["n5"] = _metric(w["now"], rng)
    tracker.mark_nodes(["n3", "n5"])
    snap = _snap(PORT, w, tracker)
    _, state, _, _ = cache.ensure(snap)
    assert cache.last_path == "delta" and state is not pinned
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(pinned, f), kept[f]), f
        assert getattr(state, f).data_ptr() != getattr(pinned, f).data_ptr()
    _assert_staged_equal(state, _fresh_staging(model, snap), "new generation")
    assert cache.device_bytes() == 2 * sum(
        getattr(state, f).nbytes for f in STAGED_NODE_FIELDS)
    cache.unpin(pinned)
    w["nodes"][4]["unsched"] = not w["nodes"][4]["unsched"]
    tracker.mark_node("n4")
    snap = _snap(PORT, w, tracker)
    _, again, _, _ = cache.ensure(snap)
    assert again is state  # unpinned: written in place
    _assert_staged_equal(again, _fresh_staging(model, snap), "in place")
    assert cache.audit_view()[1] is again


def test_staged_cache_device_half_skip_and_reestablish():
    """``want_device=False`` keeps only the host half current; the staged
    half comes back, bit-identical, from the host arrays."""
    rng = np.random.default_rng(33)
    w = _world(rng, n_nodes=8)
    tracker = ClusterDeltaTracker()
    model = PlacementModel(device="cpu")
    cache = StagedStateCache(model)
    _, state, _, _ = cache.ensure(_snap(PORT, w, tracker), want_device=False)
    assert state is None and cache.last_path == "full"
    w["nodes"][0] = dict(_node(0, rng, unsched_p=0.2), name="n0")
    tracker.mark_node("n0")
    _, state, _, _ = cache.ensure(_snap(PORT, w, tracker), want_device=False)
    assert state is None and cache.last_path == "delta"
    snap = _snap(PORT, w, tracker)
    _, state, _, _ = cache.ensure(snap)
    assert state is not None and cache.last_path == "delta"
    _assert_staged_equal(state, _fresh_staging(model, snap), "re-established")


def test_snapshot_epoch_sync_point():
    """``ensure`` syncs to the snapshot's captured epoch: a mark that
    lands after the capture is re-lowered on the next ``ensure``."""
    rng = np.random.default_rng(55)
    w = _world(rng, n_nodes=8)
    tracker = ClusterDeltaTracker()
    cache = StagedStateCache(PlacementModel(device="cpu"))
    snap = _snap(PORT, w, tracker)
    snap.delta_epoch = tracker.epoch
    cache.ensure(snap)
    w["nodes"][2] = dict(_node(0, rng, unsched_p=0.5), name="n2")
    raced = _snap(PORT, w, tracker)
    raced.delta_epoch = tracker.epoch       # captured before the mark
    tracker.mark_node("n2")                 # the racing mark
    cache.ensure(raced)                     # lowers n2 only if marked
    assert cache.seen_epoch == raced.delta_epoch
    snap = _snap(PORT, w, tracker)
    snap.delta_epoch = tracker.epoch
    arrays, _, _, (_, delta) = cache.ensure(snap)
    assert cache.last_path == "delta" and 2 in delta.idx.tolist()
    _assert_arrays_equal(arrays, lower_nodes(snap), "after the race")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_staging_deltas_matches_reference(seed):
    """Random chains of deltas and full restages fold the same way."""
    rng = np.random.default_rng(seed)

    def draw(epoch):
        if rng.random() < 0.15:
            return (epoch, None, None, None)
        k = int(rng.integers(0, 6))
        idx = np.sort(rng.choice(20, k, replace=False)).astype(np.int32)
        rows = {f: rng.integers(0, 100, (k, 8)).astype(np.int32)
                for f in ("alloc", "used_req")}
        return (epoch, epoch - 1, idx, rows)

    tprev = jprev = None
    for epoch in range(1, 25):
        e, base, idx, rows = draw(epoch)
        tprev = merge_staging_deltas(tprev, NodeStagingDelta(e, base, idx,
                                                             rows))
        jprev = jplacement.merge_staging_deltas(
            jprev, jplacement.NodeStagingDelta(e, base, idx, rows))
        assert (tprev.epoch, tprev.base_epoch) == (jprev.epoch,
                                                   jprev.base_epoch)
        if jprev.idx is None:
            assert tprev.idx is None
            continue
        np.testing.assert_array_equal(tprev.idx, jprev.idx)
        for f in jprev.rows or {}:
            np.testing.assert_array_equal(tprev.rows[f], jprev.rows[f])


# -- solves through the cache -----------------------------------------------------------

def _wave(w, rng, r, n=14):
    """A pending wave with quota and gang members (some Strict gangs fail
    and release their holds)."""
    w["quotas"] = {"qa": dict(min={CPU: 4000}, max={CPU: 30000,
                                                   MEM: 10 ** 6}),
                   "qb": dict(min={}, max={CPU: 8000, MEM: 10 ** 6})}
    w["gangs"] = {"gs": dict(min=4, mode="Strict"),
                  "gn": dict(min=3, mode="NonStrict")}
    wave = []
    for j in range(n):
        pod = _pod(5000 + 100 * r + j, rng)
        pod["quota"] = ("qa", "qb", None)[j % 3]
        pod["gang"] = ("gs", "gn", None, None)[j % 4]
        wave.append(pod)
    w["pending"] = wave


@pytest.mark.parametrize("route", ["kernel", "loop"])
def test_solve_never_writes_its_staged_inputs(route):
    """After every solve through the cache (the kernel twin or the loop
    solver; quota, gangs and rejected releases included), the cached
    staged state still equals a fresh staging of the snapshot it was
    staged from: the solve wrote nothing into its inputs."""
    rng = np.random.default_rng(21)
    w = _world(rng, n_nodes=16)
    tracker = ClusterDeltaTracker()
    counters = {"node": 0, "pod": 0}
    kwargs = ({} if route == "kernel"
              else {"prod_usage_thresholds": {TResourceName.CPU: 60}})
    model = PlacementModel(device="cpu", **kwargs)
    paths = []
    for r in range(5):
        for _ in range(3):
            _mutate(w, (tracker,), rng, counters)
        _wave(w, rng, r)
        snap = _snap(PORT, w, tracker)
        want = _fresh_staging(model, snap)
        inflight = model.schedule_async(snap)
        assert model.staged_cache._pinned is inflight.pinned is not None
        got = inflight.finalize()
        assert model.staged_cache._pinned is None
        assert model.last_solver == route
        paths.append(model.last_staging)
        _assert_staged_equal(model.staged_cache.state, want, f"round {r}")
        assert any(v is not None for v in got.values())
        for p in w["pending"]:
            node = got.get(f"default/{p['name']}")
            if node is not None:
                p["node"], p["at"] = node, w["now"]
                w["pods"].append(p)
                tracker.mark_node(node)
        w["pending"] = []
    assert "delta" in paths


def test_schedule_with_tracker_matches_without_and_reference():
    """Tick for tick, ``PlacementModel.schedule`` through the staging
    cache equals the same model without a tracker and the reference's
    model with its tracker; placed pods are folded back as binds."""
    rng = np.random.default_rng(21)
    w = _world(rng, n_nodes=16)
    jt, tt = jcluster.ClusterDeltaTracker(), ClusterDeltaTracker()
    counters = {"node": 0, "pod": 0}
    delta_model = PlacementModel(device="cpu")
    full_model = PlacementModel(device="cpu")
    ref_model = jplacement.PlacementModel(use_pallas=False)
    paths = []
    for r in range(6):
        for _ in range(3):
            _mutate(w, (jt, tt), rng, counters)
        _wave(w, rng, r)
        got = delta_model.schedule(_snap(PORT, w, tt))
        paths.append(delta_model.last_staging)
        full = full_model.schedule(_snap(PORT, w, None))
        assert full_model.last_staging is None
        want = ref_model.schedule(_snap(REF, w, jt))
        assert ref_model.staged_cache.last_path == delta_model.last_staging
        assert dict(got) == dict(full) == dict(want), f"round {r}"
        assert got.waiting == full.waiting == want.waiting
        for p in w["pending"]:
            node = got.get(f"default/{p['name']}")
            if node is not None:
                p["node"], p["at"] = node, w["now"]
                w["pods"].append(p)
                jt.mark_node(node)
                tt.mark_node(node)
        w["pending"] = []
        w["now"] += 30.0
    assert paths[0] == "full" and "delta" in paths[1:]
    timings = delta_model.last_timings
    assert set(timings) == {"lower_s", "stage_s", "solve_s"}
