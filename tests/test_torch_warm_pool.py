"""The port's warm pool (``service/warmpool.py``) on the CPU: the cases of
``tests/test_warm_pool.py`` on the port's pool, where a restored row runs
its program through the pool's copy-in and copy-out (no CUDA graph: the
capture itself is held on the card by ``test_torch_warm_pool_cuda.py``).

The reference's pool cannot serve on a machine whose XLA:CPU refuses its
restored executables, so the port is held against the reference where the
reference is sound here: every restored-and-served solve equals the
reference's ``solve_batch`` on the same inputs, the supervisor's
probe-budget decisions equal the reference supervisor's under the same
fake children and clock, and ``served`` is checked against the port's own
contract. Also: an unknown signature, an inert pool, a poisoned entry,
each of the six store faults (typed reason, count, quarantine, no retry,
a correct cold solve), a corrupt manifest, the metric series, the
aliasing rule and the staged-row case, the library entry, the flight
dump's and ``PlacementService``'s sections, the promotion restore, the
failover twin's prewarm from the sidecar's program, a new tenant's first
bucket, and ``--no-warm-pool`` on both binaries."""

import importlib
import os
import shutil
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import binpack as jbp
from koordinator_tpu.ops.gang import GangState as JGangState
from koordinator_tpu.ops.quota import QuotaState as JQuotaState
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.metrics import components
from koordinator_tpu_torch.obs.device import DEVICE_OBS, _MAX_WARM
from koordinator_tpu_torch.ops.binpack import SolverConfig
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.service import failover, server, tenancy
from koordinator_tpu_torch.service import warmpool as wp
from koordinator_tpu_torch.testing import chaos

#: the reject reason each store fault must be typed as
FAULT_REASONS = {
    "truncated-entry": "truncated",
    "bitflipped-entry": "fingerprint",
    "stale-host-fingerprint": "stale-host",
    "torn-concurrent-write": "fingerprint",
    "wrong-magic": "corrupt",
    "oversize-entry": "oversized",
}


@pytest.fixture(autouse=True)
def _fresh():
    """A fresh observatory per test (the process-global manifest would
    otherwise carry every other module's signatures), and the module
    bindings back in the process pool afterwards."""
    DEVICE_OBS.reset()
    adopted = [(b, b._warm) for b in (
        server._jit_solve, failover._local_solve, tenancy._jit_tenant,
        tenancy._jit_tenant_full)]
    yield
    for b, pool in adopted:
        b._warm = pool
    DEVICE_OBS.reset()


def _pool(root, name="store"):
    return wp.WarmPool().configure(str(root / name), force_single_device=True)


def _problem(seed=2, n_nodes=40):
    return testing.quota_gang_problem(n_nodes, 30, 4, 3, 4, seed=seed,
                                      device="cpu")


def _reference(seed=2, n_nodes=40):
    nodes, pods, params, quota, gang = testing.quota_gang_arrays(
        n_nodes, 30, 4, 3, 4, seed=seed)
    a = {k: jnp.asarray(v) for k, v in nodes.items()}
    return jbp.solve_batch(
        jbp.NodeState(**a), jbp.PodBatch(**{k: jnp.asarray(v)
                                            for k, v in pods.items()}),
        jbp.ScoreParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        jbp.SolverConfig(), quota_state=JQuotaState.build(**quota),
        gang_state=JGangState.build(**gang))


def flat(x):
    """A result tree as numpy copies (None and scalars kept)."""
    if isinstance(x, torch.Tensor):
        return x.numpy().copy()
    if isinstance(x, tuple):
        return [flat(v) for v in x]
    return x


def assert_same(got, want):
    for g, w in zip(flat(got), flat(want)):
        if isinstance(g, list):
            assert_same(g, w)
        elif g is None:
            assert w is None
        else:
            np.testing.assert_array_equal(g, w)


def solve(binding, problem):
    return bk.run_solve(binding, *problem)


def seed_store(root, name="toy_solve"):
    """One pool, one binding, one solve recorded and persisted. Returns
    ``(binding, problem, want)``."""
    pool = _pool(root)
    binding = DEVICE_OBS.bind(name, bk.solve_program)
    pool.adopt(binding, config_argpos=3)
    problem = _problem()
    want = solve(binding, problem)
    report = pool.persist()
    assert report == {"persisted": 1, "library": None}
    assert pool.persist()["persisted"] == 0  # idempotent
    return binding, problem, want


def restored(root, name="toy_solve"):
    """A fresh pool and a fresh binding (the restart shape), restored."""
    pool = _pool(root)
    binding = DEVICE_OBS.bind(name, bk.solve_program)
    pool.adopt(binding, config_argpos=3)
    return pool, binding, pool.restore()


def test_persist_restore_serve_equals_reference(tmp_path):
    _b, problem, want = seed_store(tmp_path)
    pool, binding, report = restored(tmp_path)
    assert report["restored"] == 1 and report["failed"] == 0, report
    assert report["rows"] == 1 and pool.serving
    got = solve(binding, problem)
    assert_same(got, want)
    ref = _reference()
    for f in ("assign", "commit", "waiting", "rejected"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(got.node_state.used_req.numpy(),
                                  np.asarray(ref.node_state.used_req))
    status = pool.status()
    assert (status["hits"], status["served"], status["misses"]) == (1, 1, 0)
    assert status["rejects"] == {} and status["quarantined"] == 0
    assert status["executables"] == 1 and status["graphs"] == 0
    assert status["manifest_programs"] == {
        "koordinator_tpu_torch.ops.binpack_kernel.solve_program": 1}
    # the caller's quota state keeps its runtime field
    assert got.quota_state.runtime is None


def test_unknown_signature_falls_through(tmp_path):
    seed_store(tmp_path)
    pool, binding, _ = restored(tmp_path)
    other = _problem(n_nodes=41)  # a shape the store never saw
    assert_same(solve(binding, other),
                bk.kernel_solve_batch(*_problem(n_nodes=41)))
    assert pool.status()["served"] == 0


def test_inert_pool_never_serves(tmp_path, monkeypatch):
    monkeypatch.setenv("KTPU_COMPILATION_CACHE_DIR", "")
    pool = wp.WarmPool().configure(None)
    binding = DEVICE_OBS.bind("toy_solve", bk.solve_program)
    pool.adopt(binding, config_argpos=3)
    assert not pool.active and not pool.serving and not pool.recording
    assert pool.restore()["skipped"] == "inactive"
    assert pool.persist() == {"persisted": 0, "skipped": "inactive"}
    assert_same(solve(binding, _problem()), bk.kernel_solve_batch(
        *_problem()))
    # an inert pool keeps no sample of the call's arguments
    assert [s for _f, _sig, s in DEVICE_OBS.warm_manifest()] == [None]


def test_poisoned_entry_ejected_not_fatal(tmp_path):
    _b, problem, want = seed_store(tmp_path)
    pool, binding, _ = restored(tmp_path)

    class Poisoned:
        def run(self, arrays):
            raise RuntimeError("poisoned entry")

    with pool._lock:
        key = next(iter(pool._execs))
        pool._execs[key] = Poisoned()
    assert_same(solve(binding, problem), want)  # the program answered
    status = pool.status()
    assert status["executables"] == 0 and not pool.serving
    assert "poisoned" in status["last_error"]
    assert status["quarantined"] == 1 and status["served"] == 0
    # ejected for good, and its disk entry is gone: a restart is cold
    assert_same(solve(binding, problem), want)
    assert restored(tmp_path)[2]["failed"] == 1


@pytest.mark.parametrize("kind", chaos.WARM_POOL_FAULT_KINDS)
def test_store_fault_typed_counted_quarantined(tmp_path, kind):
    _b, problem, want = seed_store(tmp_path)
    assert chaos.sabotage_store(str(tmp_path / "store"), kind, seed=3)
    pool, binding, report = restored(tmp_path)
    reason = FAULT_REASONS[kind]
    assert report["failed"] == 1 and report["restored"] == 0, report
    status = pool.status()
    assert status["rejects"] == {reason: 1}
    assert status["quarantined"] == 1
    assert any(f.endswith(".quarantined") for _d, _s, files in os.walk(
        tmp_path / "store") for f in files)
    # the solve runs cold, and equal
    assert_same(solve(binding, problem), want)
    assert pool.status()["served"] == 0
    # no retry in a loop: the next restart finds a clean miss
    again, _b2, report2 = restored(tmp_path)
    assert report2["failed"] == 1
    assert again.status()["rejects"] == {} and again.status()["misses"] == 1
    # and compile_missing captures the row again from zero-filled inputs
    report3 = again.restore(compile_missing=True)
    assert report3["compiled"] == 1 and again.serving


def test_corrupt_manifest_degrades_to_cold(tmp_path):
    _b, problem, want = seed_store(tmp_path)
    assert chaos.sabotage_store(str(tmp_path / "store"), "wrong-magic",
                                manifest=True)
    pool, binding, report = restored(tmp_path)
    assert report["rows"] == 0 and report["restored"] == 0
    assert pool.status()["rejects"] == {"corrupt": 1}
    assert pool.status()["quarantined"] == 1
    assert_same(solve(binding, problem), want)


def test_metrics_series_move(tmp_path):
    seed_store(tmp_path)
    hits = components.WARM_POOL_HITS.value()
    rejects = components.WARM_POOL_REJECTS.value({"reason": "fingerprint"})
    quarantined = components.WARM_POOL_QUARANTINED.value()
    misses = components.WARM_POOL_MISSES.value()
    restored(tmp_path)
    assert components.WARM_POOL_HITS.value() == hits + 1
    chaos.sabotage_store(str(tmp_path / "store"), "bitflipped-entry", seed=1)
    restored(tmp_path)
    assert components.WARM_POOL_REJECTS.value(
        {"reason": "fingerprint"}) == rejects + 1
    assert components.WARM_POOL_QUARANTINED.value() == quarantined + 1
    restored(tmp_path)
    assert components.WARM_POOL_MISSES.value() == misses + 1
    assert components.WARM_RESTORE_SECONDS.count() >= 4


def test_served_results_never_alias(tmp_path):
    """A second served call at the signature leaves the first call's
    result unchanged, and nothing served shares memory with the entry."""
    seed_store(tmp_path)
    pool, binding, _ = restored(tmp_path)
    first_in, second_in = _problem(seed=2), _problem(seed=5)
    first = solve(binding, first_in)
    kept = flat(first)
    second = solve(binding, second_in)
    assert pool.status()["served"] == 2
    assert_same(first, kept)
    assert_same(first, bk.kernel_solve_batch(*_problem(seed=2)))
    assert_same(second, bk.kernel_solve_batch(*_problem(seed=5)))
    (entry,) = pool._execs.values()
    static = {t.untyped_storage().data_ptr() for t in entry.static_leaves}
    for t in wp._tensors(second):
        assert t.untyped_storage().data_ptr() not in static
    # an output that is an input stays the caller's own tensor
    assert second.node_state.alloc is second_in[0].alloc


def test_staged_row_changed_between_served_calls(tmp_path):
    """The staging cache scatters its tensors in place: each served call
    reads what the caller's tensors hold at that call."""
    seed_store(tmp_path)
    pool, binding, _ = restored(tmp_path)
    problem = _problem()
    first = flat(solve(binding, problem))
    problem[0].used_req[3] += 5000
    problem[0].schedulable[7] = False
    second = solve(binding, problem)
    assert pool.status()["served"] == 2
    assert_same(second, bk.kernel_solve_batch(*problem))
    changed = _problem()
    assert_same(first, bk.kernel_solve_batch(*changed))
    assert not np.array_equal(first[2], second.assign.numpy())


def test_library_entry_restored_without_nvcc(tmp_path, monkeypatch):
    """The kernel library's entry: stored when built, restored into an
    empty build directory by a rename, its digest checked (another
    sources' library is version skew), never built with
    ``compile_missing=False``."""
    build = tmp_path / "build"
    build.mkdir()
    monkeypatch.setattr(bk, "BUILD_DIR", build)
    monkeypatch.setattr(bk, "build_library", lambda: pytest.fail("nvcc"))
    lib = bk.library_path()
    lib.write_bytes(b"\x7fELF" + bytes(range(256)) * 8)
    pool = _pool(tmp_path)
    assert pool.persist()["library"] == "stored"
    assert pool.persist()["library"] == "stored"
    body = lib.read_bytes()
    lib.unlink()
    report = {"compiled": 0}
    fresh = _pool(tmp_path)
    assert fresh._ensure_library(fresh._cache, False, report)
    assert report["library"] == "restored" and lib.read_bytes() == body
    assert fresh.status()["hits"] == 1
    assert not list(build.glob("*.tmp"))
    # a library of other sources under this key: version skew
    lib.unlink()
    key = wp._library_key(bk._digest())
    fresh._cache.store(key, body, {"kind": "library", "digest": "other"})
    report = {"compiled": 0}
    assert not fresh._ensure_library(fresh._cache, False, report)
    assert report["library"] == "missing" and not lib.exists()
    assert fresh.status()["rejects"] == {"version-skew": 1}
    assert fresh.status()["quarantined"] == 1


def test_device_obs_manifest_records_signatures(tmp_path):
    pool = _pool(tmp_path)
    binding = DEVICE_OBS.bind("toy_solve", bk.solve_program)
    pool.adopt(binding, config_argpos=3)
    solve(binding, _problem())
    solve(binding, _problem(seed=3))  # the same signature: one row
    solve(binding, _problem(n_nodes=41))
    rows = DEVICE_OBS.warm_manifest()
    assert [fn for fn, _s, _x in rows] == ["toy_solve"] * 2
    sig = rows[0][1]
    assert sig[0].alloc == (( 40, 8), torch.int32, "cpu")
    assert isinstance(sig[3], bk.ProgramConfig) and sig[3].route.kind == "block"
    assert all(sample is not None for _f, _s, sample in rows)
    for n in range(_MAX_WARM + 4):
        DEVICE_OBS._record_call("many", (torch.zeros(n + 1),), False)
    assert len(DEVICE_OBS.warm_manifest()) == _MAX_WARM


def test_background_persister_stops(tmp_path):
    pool = _pool(tmp_path)
    pool.start_background(interval_s=0.01)
    thread = pool._bg_thread
    assert thread.is_alive()
    pool.stop_background()
    assert not thread.is_alive()
    pool.restore(background=True)
    pool.wait_restored(10)
    assert pool.status()["last_restore"]["rows"] == 0
    pool.reset()
    assert pool.status()["executables"] == 0


def test_persister_wakes_on_a_new_signature(tmp_path):
    """A binding that keeps a new signature's sample wakes the background
    persister at once, long before its interval."""
    import time

    pool = _pool(tmp_path)
    binding = DEVICE_OBS.bind("toy_solve", bk.solve_program)
    pool.adopt(binding, config_argpos=3)
    pool.start_background(interval_s=600.0)
    try:
        solve(binding, _problem())
        deadline = time.monotonic() + 30
        while pool.status()["manifest_rows"] < 1:
            assert time.monotonic() < deadline, pool.status()
            time.sleep(0.01)
    finally:
        pool.stop_background()
    assert restored(tmp_path)[2]["restored"] == 1


# -- the supervisor's probe-budget split, held against the reference's -------

def _probe_budget(module, warm_value, script):
    """A supervisor of ``module`` over fake children reporting
    ``warm_value``, booted healthy, crashed and respawned; then
    ``script`` (a list of ops) on a fake clock. Returns the outcomes and
    statuses."""
    sup_mod = importlib.import_module(f"{module}.service.supervisor")
    now = [0.0]
    spawned = []
    alive = {"ok": True}

    class Handle:
        def __init__(self):
            self.returncode = None
            self.killed = 0
            self.pid = 777
            self.warm_restored = warm_value

        def poll(self):
            return self.returncode

        def kill(self):
            self.killed += 1
            self.returncode = -9

    def spawn():
        spawned.append(Handle())
        return spawned[-1]

    sup = sup_mod.SolverSupervisor(
        ("127.0.0.1", 1), spawn_fn=spawn, probe_fn=lambda: alive["ok"],
        sleep=lambda _s: None, clock=lambda: now[0], probe_interval_s=0.01,
        backoff_base_s=0.0, backoff_cap_s=0.0, probe_failure_threshold=3,
        ready_timeout_s=120.0, warm_ready_timeout_s=10.0)
    out = []
    try:
        sup.start(wait_ready=True, monitor=False)
        alive["ok"] = False
        spawned[-1].returncode = 1
        out.append(sup.check_once())
        for op in script:
            if op[0] == "advance":
                now[0] += op[1]
            elif op[0] == "resolve":
                spawned[-1].warm_restored = op[1]
            else:
                out.append(sup.check_once())
            st = sup.status()
            out.append((st["respawn_warm"], st["respawns_warm_total"],
                        st["ready_grace_s"], st["state"]))
        out.append([h.killed for h in spawned])
    finally:
        sup.stop()
    return out


CHECK = ("check",)


@pytest.mark.parametrize("warm_value, script", [
    # a warm respawn is probed on the tight grace: past it, the hung
    # child is killed after the probe threshold
    (True, [CHECK, ("advance", 11.0), CHECK, CHECK, CHECK]),
    # a cold respawn keeps the generous grace, then is hung past it
    (False, [("advance", 11.0)] + [CHECK] * 5
     + [("advance", 121.0), CHECK]),
    # undecided stays generous; resolving warm mid-wait tightens it
    (None, [("advance", 30.0), CHECK, ("resolve", True), CHECK]),
], ids=["warm", "cold", "undecided"])
def test_probe_budget_equals_reference(warm_value, script):
    before = components.SUPERVISOR_RESPAWN_WARM.value()
    got = _probe_budget("koordinator_tpu_torch", warm_value, script)
    assert got == _probe_budget("koordinator_tpu", warm_value, script)
    assert components.SUPERVISOR_RESPAWN_WARM.value() - before == int(
        warm_value is not False)


def test_debug_port_warm_outcome_equals_reference():
    """Both packages' ``debug_port_warm_outcome`` read the same mux
    answers the same way."""
    from koordinator_tpu.service.supervisor import (
        debug_port_warm_outcome as ref_outcome,
    )
    from koordinator_tpu_torch.scheduler.monitor import DebugServices
    from koordinator_tpu_torch.service.supervisor import (
        debug_port_warm_outcome,
    )
    from koordinator_tpu_torch.utils.debug_http import DebugHTTPServer

    payload = {"active": True, "executables": 0, "last_restore": None}
    services = DebugServices()
    services.register("warm-pool", lambda: dict(payload))
    http = DebugHTTPServer(services=services, port=0).start()
    seen = []
    try:
        outcomes = (debug_port_warm_outcome(http.port),
                    ref_outcome(http.port))
        for change in ({}, {"executables": 3},
                       {"executables": 0,
                        "last_restore": {"restored": 0, "failed": 1}},
                       {"active": False}):
            payload.update(change)
            seen.append([o() for o in outcomes])
    finally:
        http.stop()
    seen.append([o() for o in outcomes])
    assert seen == [[None] * 2, [True] * 2, [False] * 2, [False] * 2,
                    [None] * 2]


# -- the surfaces and the recovery paths ----------------------------------------

def test_flight_and_service_sections(tmp_path):
    from koordinator_tpu_torch.obs.flight import FLIGHT

    FLIGHT.configure(dump_dir=str(tmp_path / "flight"), min_interval_s=0.0)
    path = FLIGHT.trigger("manual", detail="warm")
    import json

    dump = json.loads(open(path).read())
    assert dump["warm"] == json.loads(json.dumps(
        wp.WARM_POOL.flight_payload()))
    addr = os.path.join(tempfile.mkdtemp(prefix="wp"), "s.sock")
    service = server.PlacementService(addr, device="cpu", admission=False)
    try:
        section = service.status()["warm_pool"]
        assert section["active"] is False and section["served"] == 0
        assert "warm_pool" not in service.status()["not_ported"]
    finally:
        service.stop()
        shutil.rmtree(os.path.dirname(addr), ignore_errors=True)


@pytest.mark.parametrize("started_before", [False, True],
                         ids=["by-the-service", "by-an-entry-point"])
def test_service_stops_the_persister_it_started(tmp_path, started_before):
    """A ``PlacementService`` over an active pool stops the persister its
    constructor started; one that an entry point started before it stays
    with its starter."""
    d = tempfile.mkdtemp(prefix="wp")
    wp.WARM_POOL.configure(str(tmp_path / "store"), force_single_device=True)
    try:
        if started_before:
            assert wp.WARM_POOL.start_background()
        service = server.PlacementService(os.path.join(d, "s.sock"),
                                          device="cpu", admission=False)
        assert wp.WARM_POOL._bg_thread.is_alive()
        service.stop()
        assert (wp.WARM_POOL._bg_thread is None) is not started_before
    finally:
        wp.WARM_POOL.configure("")
        wp.WARM_POOL.reset()
        shutil.rmtree(d, ignore_errors=True)
    assert wp.WARM_POOL._bg_thread is None


def test_promotion_restore_never_raises(tmp_path):
    from test_torch_auditor import auditor_cls, wired
    from test_torch_colocation import PORT

    class Broken:
        def restore(self, compile_missing=False):
            raise RuntimeError("store on fire")

    seed_store(tmp_path)
    for warm_pool, check in (
            (Broken(), lambda w: "store on fire" in w["pool"]["error"]),
            (restored(tmp_path)[0],
             lambda w: w["pool"]["restored"] == 1)):
        bus, sched, (elector,) = wired(PORT, elector_ids=("a",))
        aud = auditor_cls(PORT)(sched, bus, interval_rounds=0,
                                warm_pool=warm_pool)
        elector.on_started_leading = aud.note_promotion
        assert elector.tick(0.0)
        warm = aud.on_round(now=0.0)["warm"]
        assert check(warm), warm
        assert "error" not in warm["prestage"]


def test_failover_twin_prewarms_from_sidecar_program(tmp_path):
    """Signatures the sidecar's binding persisted warm the failover twin
    (one program): its first local solve is served, and equal."""
    from koordinator_tpu_torch.service.client import SolverUnavailable

    pool = _pool(tmp_path)
    pool.adopt(server._jit_solve, config_argpos=3)
    state, pods, params, quota, gang = _problem()
    want, _ = server._dispatch_solve(
        state, pods, params, SolverConfig(), quota, gang, None, None,
        None, True, True, True)
    assert pool.persist()["persisted"] == 1

    class DeadRemote:
        address = "/nonexistent"
        supports_staging_delta = False

        def solve_result(self, *a, **k):
            raise SolverUnavailable("dead")

    twin = _pool(tmp_path)
    twin.adopt(failover._local_solve, config_argpos=3)
    fs = failover.FailoverSolver(DeadRemote(), failure_threshold=1,
                                 probe_fn=lambda: False, prewarm=False,
                                 device="cpu")
    report = fs.prewarm(background=False)
    assert report["restored"] == 1 and report["loaded"], report
    got = fs.solve_result(*_problem()[:3], SolverConfig(),
                          *_problem()[3:])
    assert fs.last_mode == "local-fallback"
    assert twin.status()["served"] == 1
    assert_same(got, want)
    assert fs.status()["prewarm"]["restored"] == 1


def _tenant(i, n_nodes=48, n_pods=12):
    rng = np.random.default_rng(i)
    alloc = np.zeros((n_nodes, 8), np.int32)
    alloc[:, 0], alloc[:, 1] = 32000, 65536
    used = np.zeros_like(alloc)
    used[:, 0] = rng.integers(0, 20000, n_nodes)
    node = {"alloc": alloc, "used_req": used, "usage": np.zeros_like(alloc),
            "prod_usage": np.zeros_like(alloc),
            "est_extra": np.zeros_like(alloc),
            "prod_base": np.zeros_like(alloc),
            "metric_fresh": np.ones(n_nodes, bool),
            "schedulable": np.ones(n_nodes, bool)}
    req = np.zeros((n_pods, 8), np.int32)
    req[:, 0] = rng.integers(200, 4000, n_pods)
    req[:, 1] = rng.integers(128, 4096, n_pods)
    pods = {"req": req, "est": (req * 85) // 100,
            "is_prod": np.zeros(n_pods, bool),
            "is_daemonset": np.zeros(n_pods, bool)}
    w = np.zeros(8, np.int32)
    w[:2] = 1
    t = np.zeros(8, np.int32)
    t[:2] = (65, 95)
    params = {"weights": w, "thresholds": t,
              "prod_thresholds": np.zeros(8, np.int32)}
    return tenancy.wire_state(node, "cpu"), pods, params


@pytest.mark.parametrize("want_state", [False, True],
                         ids=["assign", "full"])
def test_new_tenant_first_bucket_restores_warm(tmp_path, want_state):
    """Tenant A's lane batch persisted; a fresh pool restored; tenant B
    (another world of the same shapes) is served warm, equal to its
    lane solved with no pool."""
    binding = (tenancy._jit_tenant_full if want_state
               else tenancy._jit_tenant)

    def lanes(i):
        base, pods, params = _tenant(i)
        return tenancy.solve_lanes([base], [pods], [params],
                                   SolverConfig(), want_state,
                                   torch.device("cpu"))

    want = lanes(2)
    pool = _pool(tmp_path)
    pool.adopt(binding, config_argpos=1)
    lanes(1)
    assert pool.persist()["persisted"] == 1
    fresh = _pool(tmp_path)
    fresh.adopt(binding, config_argpos=1)
    assert fresh.restore()["restored"] == 1
    got = lanes(2)
    assert fresh.status()["served"] == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.assignments, w.assignments)
        if want_state:
            np.testing.assert_array_equal(g.node_used_req, w.node_used_req)


def test_binaries_take_no_warm_pool(tmp_path, capsys, monkeypatch):
    from koordinator_tpu_torch.cmd import scheduler as sched_cmd
    from koordinator_tpu_torch.cmd import solver

    monkeypatch.setenv("KTPU_COMPILATION_CACHE_DIR", str(tmp_path / "store"))
    try:
        d = tempfile.mkdtemp(prefix="wp")
        ready = os.path.join(d, "ready")
        assert solver.main(["--listen", os.path.join(d, "s.sock"),
                            "--device", "cpu", "--once", "--ready-file",
                            ready, "--no-warm-pool"]) == 0
        shutil.rmtree(d, ignore_errors=True)
        assert not wp.WARM_POOL.active
        assert sched_cmd.main(["--once", "--device", "cpu",
                               "--no-warm-pool"]) == 0
        assert not wp.WARM_POOL.active
        # SchedulerConfig(warm_pool=False) leaves the pool inert; the
        # default configures it from the environment
        wp.WARM_POOL.configure("")
        sched_cmd.build_scheduler(sched_cmd.SchedulerConfig(
            warm_pool=False, host_fallback_cells=0), device="cpu")
        assert not wp.WARM_POOL.active
        sched_cmd.build_scheduler(sched_cmd.SchedulerConfig(
            host_fallback_cells=0), device="cpu")
        assert wp.WARM_POOL.active
        assert wp.WARM_POOL.status()["last_restore"]["rows"] == 0
    finally:
        monkeypatch.setenv("KTPU_COMPILATION_CACHE_DIR", "")
        wp.WARM_POOL.configure("")
        wp.WARM_POOL.reset()
