"""The port's HBM working set (``state/workingset.py``) against the JAX
package's: one register / touch / admit / enforce / squeeze /
``run_staged`` script, with injected allocation failures at the stage and
scatter boundaries, drives both managers over scripted residents and must
give equal event rings, counts, rungs and statuses. Then the two staged
caches on the CPU: ``NodeStateCache`` serves bench config #21 cut small
(4 tenants, 64-node worlds) at the f100, f50 and f25 budget lines with
every (tenant, round) answer equal to the unbudgeted arm and to the
reference's, and answers a cold base with the reference's typed mismatch;
``StagedStateCache`` answers every churn tick equally whether its world
was demoted to the host or the cold rung before it, against an
unbudgeted run and the reference's. A pinned or locked world is never
demoted, and ``is_alloc_failure`` takes a ``torch.cuda.OutOfMemoryError``.
"""

import numpy as np
import pytest
import torch

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu.service import codec as jcodec
from koordinator_tpu.service import server as jserver
from koordinator_tpu.state import workingset as jws
from koordinator_tpu.state.cluster import ClusterDeltaTracker as JTracker
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.service import codec, server
from koordinator_tpu_torch.state import workingset as ws
from koordinator_tpu_torch.state.cluster import ClusterDeltaTracker
from koordinator_tpu_torch.testing.chaos import FaultSchedule, HBMSaboteur
from koordinator_tpu_torch.testing.failure_domain import (
    density_arm,
    density_stream,
    outage_churn,
)


@pytest.fixture(autouse=True)
def fresh_managers():
    ws.WORKING_SET.reset()
    jws.WORKING_SET.reset()
    yield
    ws.WORKING_SET.reset()
    jws.WORKING_SET.reset()
    ws.WORKING_SET.migration_hook = None


class World:
    """A scripted resident: its bytes, and whether its owner is busy."""

    def __init__(self, nbytes):
        self.nbytes = nbytes
        self.rung = "device"
        self.busy = False

    def device_bytes(self):
        return self.nbytes if self.rung == "device" else 0

    def demote_device(self):
        if self.busy or self.rung != "device":
            return False
        self.rung = "host"
        return True

    def demote_cold(self):
        if self.busy or self.rung == "cold":
            return False
        self.rung = "cold"
        return True

    def restage(self):
        self.rung = "device"
        return self.nbytes


def manager_script(module):
    m = module.WorkingSetManager(max_alloc_retries=2)
    notes = []
    m.migration_hook = lambda key, lane, reason: notes.append(
        (key, lane, reason))
    worlds = {}
    for key, tenant, lane, weight, nbytes in [
            ("a", "t1", "be", 1.0, 400), ("b", "t2", "ls", 2.0, 300),
            ("c", "t3", "ls", 1.0, 300), ("d", "t4", "system", 1.0, 200),
            ("e", "t5", "be", 3.0, 100)]:
        worlds[key] = World(nbytes)
        m.register(key, worlds[key], tenant=tenant, lane=lane,
                   weight=weight)
    trail = []

    def snap(label, out=None):
        st = m.status()
        trail.append((label, out, st, {k: w.rung for k, w in worlds.items()},
                      list(notes)))

    for key in "abcde":
        m.touch(key)
    snap("touched")
    m.set_budget(1000)
    snap("budget")
    worlds["c"].busy = True          # mid-solve: skipped, never waited on
    m.admit("e", 500)
    snap("admit")
    worlds["c"].busy = False
    m.touch("a", nbytes=worlds["a"].restage())
    snap("restage-a")
    snap("squeeze", m.squeeze(0.5))
    m.arm_fault("stage")
    out = m.run_staged("b", "stage", lambda: worlds["b"].restage(),
                       estimate=300)
    m.touch("b")
    snap("run-staged-stage", out)
    m.arm_fault("scatter", 2)
    out = m.run_staged("d", "scatter", lambda: "scattered")
    snap("run-staged-scatter", out)
    m.arm_fault("stage", 5)
    with pytest.raises(module.WorkingSetExhausted):
        m.run_staged("a", "stage", lambda: "never")
    snap("exhausted")
    snap("demote-named", m.demote("e", "cold"))
    m.enforce()
    m.drop("c")
    snap("dropped")
    trail.append(("flight", m.flight_payload(), m.pressure()))
    return trail


def test_manager_script_matches_reference():
    port, ref = manager_script(ws), manager_script(jws)
    assert port == ref
    final = port[-2][2]
    assert final["alloc_failures"] == {"stage": 4, "scatter": 2}
    assert final["demotions"]["alloc-failure"] >= 1
    assert final["restages"]["host"] >= 1


def test_saboteur_drives_the_same_ladder():
    """An ``HBMSaboteur`` schedule against the port's manager gives the
    same ladder as arming the reference's by hand."""
    port = ws.WorkingSetManager()
    ref = jws.WorkingSetManager()
    for m in (port, ref):
        for key, nbytes in (("x", 100), ("y", 100), ("z", 100)):
            w = World(nbytes)
            m.register(key, w, lane="be")
            m.touch(key)
            m.__dict__.setdefault("_worlds", {})[key] = w
        m.set_budget(400)
    sab = HBMSaboteur(FaultSchedule({1: "alloc-fail-stage",
                                     2: "budget-squeeze-mid-churn",
                                     3: "alloc-fail-scatter"}),
                      manager=port)
    for tick in range(5):
        sab.inject(tick)
        if tick == 1:
            ref.arm_fault("stage")
        if tick == 2:
            ref.squeeze(0.5)
        if tick == 3:
            ref.arm_fault("scatter")
        for m in (port, ref):
            m.run_staged("x", "stage", lambda: None)
            m.run_staged("x", "scatter", lambda: None)
    assert port.status() == ref.status()
    assert port.flight_payload() == ref.flight_payload()
    assert sab.injected == {"alloc-fail-stage": 1,
                            "budget-squeeze-mid-churn": 1,
                            "alloc-fail-scatter": 1}
    assert FaultSchedule.generate(3, 40).events == \
        FaultSchedule.generate(3, 40).events


def test_is_alloc_failure_takes_cuda_oom():
    assert ws.is_alloc_failure(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert ws.is_alloc_failure(ws.InjectedAllocFailure("x"))
    assert ws.is_alloc_failure(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert not ws.is_alloc_failure(ValueError("bad shape"))
    calls = []

    def stage():
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "staged"

    m = ws.WorkingSetManager()
    assert m.run_staged(None, "stage", stage) == "staged"
    assert calls == [1, 1]
    assert m.status()["alloc_failures"] == {"stage": 1}


# -- NodeStateCache: config #21 cut small ------------------------------------

TENANTS, DENSITY_NODES, DENSITY_PODS, ROUNDS = 4, 64, 8, 6


def density_curve(server_mod, codec_mod, manager, make_cache):
    streams = [density_stream(i, ROUNDS, DENSITY_NODES, DENSITY_PODS)
               for i in range(TENANTS)]
    solve = lambda req, cache: server_mod.solve_from_request(
        req, node_cache=cache)
    probe = make_cache("probe")
    resp = solve(codec_mod.SolveRequest(**streams[0][0]), probe)
    assert not resp.error
    world = probe.device_bytes()
    probe.close()
    arms = {}
    for line, worlds in (("none", None), ("f100", TENANTS),
                         ("f50", TENANTS // 2), ("f25", TENANTS // 4)):
        arms[line] = density_arm(streams, codec_mod.SolveRequest, solve,
                                 make_cache, manager, worlds, world)
    return world, arms


def test_node_state_cache_rungs_match_unbudgeted_and_reference():
    p_world, port = density_curve(
        server, codec, ws.WORKING_SET,
        lambda i: server.NodeStateCache("cpu", tenant=f"d{i}", lane="be"))
    r_world, ref = density_curve(
        jserver, jcodec, jws.WORKING_SET,
        lambda i: jserver.NodeStateCache(tenant=f"d{i}", lane="be"))
    assert p_world == r_world > 0
    for line in port:
        assert port[line][1] == port["none"][1], line
        assert port[line][1] == ref[line][1], line
        assert port[line][2] == ref[line][2], line
    assert port["f100"][2]["demotions"] == 0
    # round-robin tenants under any line below the fleet: every tenant's
    # world was the least recently used when its turn came
    assert port["f25"][2]["restages"] >= port["f50"][2]["restages"] > 0


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_cold_base_answers_the_typed_mismatch(pkg):
    srv, cod, manager = ((server, codec, ws.WORKING_SET) if pkg == "port"
                         else (jserver, jcodec, jws.WORKING_SET))
    cache = (srv.NodeStateCache("cpu", tenant="t") if pkg == "port"
             else srv.NodeStateCache(tenant="t"))
    establish, deltas = density_stream(0, 3, 32, 4)
    assert not srv.solve_from_request(cod.SolveRequest(**establish),
                                      node_cache=cache).error
    assert manager.demote(cache._ws_key, "cold")
    resp = srv.solve_from_request(cod.SolveRequest(**deltas[0]),
                                  node_cache=cache)
    assert resp.error.startswith("delta-base-mismatch")
    assert manager.status()["residents"]["cold"] == 1
    cache.close()
    assert manager.status()["residents"] == {"device": 0, "host": 0,
                                             "cold": 0}


def test_pinned_or_locked_base_is_never_demoted():
    cache = server.NodeStateCache("cpu", tenant="t")
    establish, deltas = density_stream(0, 3, 32, 4)
    assert not server.solve_from_request(codec.SolveRequest(**establish),
                                         node_cache=cache).error
    cache.pin(cache.state)
    assert not cache.demote_device() and not cache.demote_cold()
    assert not ws.WORKING_SET.demote(cache._ws_key, "host")
    cache.unpin(cache.state)
    with cache._lock:
        assert not cache.demote_device() and not cache.demote_cold()
    assert cache.demote_device()
    assert cache.state is None and cache.host is not None
    cache.close()


# -- StagedStateCache: the churn world at every rung -------------------------

CHURN_NODES, CHURN_TICKS = 40, 6


def staged_churn(model, types, tracker, resource, manager, rungs):
    """The config #11 churn on ``model``, its staged world demoted to
    ``rungs[t]`` (None: left alone) before tick t's solve."""
    def on_tick(t):
        rung = rungs.get(t)
        if rung is not None:
            assert manager.demote(model.staged_cache._ws_key, rung)

    log, _, _, _ = outage_churn(model, types, tracker, resource,
                                n_nodes=CHURN_NODES, ticks=CHURN_TICKS,
                                on_tick=on_tick)
    return log


def test_staged_cache_rungs_match_unbudgeted_and_reference():
    rungs = {1: "host", 2: "cold", 4: "host"}
    plain = staged_churn(PlacementModel(device="cpu"), ttypes,
                         ClusterDeltaTracker, TResourceName, ws.WORKING_SET,
                         {})
    model = PlacementModel(device="cpu")
    port = staged_churn(model, ttypes, ClusterDeltaTracker, TResourceName,
                        ws.WORKING_SET, rungs)
    ref_model = JPlacementModel(use_pallas=False)
    ref = staged_churn(ref_model, jtypes, JTracker, JResourceName,
                       jws.WORKING_SET, rungs)
    assert port == plain == ref
    st, jst = ws.WORKING_SET.status(), jws.WORKING_SET.status()
    assert st["restages"] == jst["restages"] == {"host": 2, "cold": 1}
    assert st["demotions"] == jst["demotions"]
    # back on the device rung, staged by its last solve
    assert model.staged_cache.state is not None
    assert model.staged_cache.device_bytes() > 0


def test_staged_cache_refuses_demotion_while_pinned():
    model = PlacementModel(device="cpu")
    outage_churn(model, ttypes, ClusterDeltaTracker, TResourceName,
                 n_nodes=8, ticks=1, dirty=2, pending=3)
    cache = model.staged_cache
    cache.pin(cache.state)
    assert not cache.demote_device() and not cache.demote_cold()
    cache.unpin(cache.state)
    with cache._lock:
        assert not cache.demote_device()
    assert cache.demote_cold()
    assert cache.arrays is None and cache.state is None


def test_touch_prices_outside_the_ledger_lock():
    """``touch`` asks a resident for its ``device_bytes`` without holding
    the manager's lock: a staged cache takes its own lock there, and a
    thread inside that cache's ``ensure`` holds it while it enters
    ``run_staged`` (the manager's lock), so pricing under the manager's
    lock deadlocks the two threads (the pipelined streaming loop's
    prestage against the publisher's)."""
    m = ws.WorkingSetManager()
    held = []

    class Probe(World):
        def device_bytes(self):
            free = m._lock.acquire(blocking=False)
            if free:
                m._lock.release()
            held.append(not free)
            return super().device_bytes()

    world = Probe(4096)
    key = m.register("probe", world, tenant="t0", lane="ls")
    m.touch(key)
    assert held == [False]
    assert m.status()["rows"][0]["bytes"] == m.device_bytes() == 4096
