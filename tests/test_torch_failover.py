"""The port's ``FailoverSolver`` against the JAX package's: bench config
#11 (the outage-failover churn) cut small, 48 nodes and 12 ticks with the
sidecar killed at tick 4, through each package's ``FailoverSolver`` over
its own ``InProcessSidecar`` under its own ``SolverSupervisor``. The kill
and the supervised respawn are driven at fixed ticks, and a healthy solve
has no deadline to miss (only the outage's refused connections spend a
retry budget), so the ``last_mode`` sequence follows the kill and the
respawn alone and is equal across the packages; every tick's placements
equal the JAX failover run and both in-process runs (exact).
Also: the state machine's flips and hysteresis step for step against the
reference, the overloaded-past-budget fallback, a failed local kernel
raising, and ``build_scheduler`` wiring ``on_flip_back``. Unix sockets
under ``tmp_path``; every client has a bounded socket timeout."""

import numpy as np
import pytest
import torch

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu.ops import binpack as jbinpack
from koordinator_tpu.service import client as jclient
from koordinator_tpu.service import failover as jfailover
from koordinator_tpu.service import supervisor as jsupervisor
from koordinator_tpu.state.cluster import ClusterDeltaTracker as JTracker
from koordinator_tpu.testing import chaos as jchaos
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.cmd.scheduler import (
    SchedulerConfig,
    build_scheduler,
)
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.obs.flight import FLIGHT
from koordinator_tpu_torch.ops.binpack import (
    NodeState,
    PodBatch,
    ScoreParams,
    SolverConfig,
)
from koordinator_tpu_torch.service import client, failover, server, supervisor
from koordinator_tpu_torch.state.cluster import ClusterDeltaTracker
from koordinator_tpu_torch.state.workingset import WORKING_SET
from koordinator_tpu_torch.testing import chaos
from koordinator_tpu_torch.testing.failure_domain import (
    mode_runs,
    outage_churn,
)

NODES, TICKS, KILL, RESPAWN = 48, 12, 4, 8
#: the retry budget of a failing remote solve after warm-up: a killed
#: sidecar refuses the connection at once, so each outage tick fails
#: after this budget. No per-solve deadline is set: on a loaded host a
#: healthy solve (the JAX sidecar's first delta solve compiles) can take
#: longer than any deadline that keeps the outage short, and would then
#: flip the mode sequence on the host's load instead of on the kill
RETRY_BUDGET_S = 0.5


class Side:
    """One package's failover stack, built the same way."""

    def __init__(self, name, types, tracker, resource, model, remote,
                 failover_cls, supervisor_cls, sidecar):
        self.name, self.types, self.tracker = name, types, tracker
        self.resource, self.model_cls = resource, model
        self.remote_cls, self.failover_cls = remote, failover_cls
        self.supervisor_cls, self.sidecar = supervisor_cls, sidecar


PORT = Side("port", ttypes, ClusterDeltaTracker, TResourceName,
            lambda **kw: PlacementModel(device="cpu", **kw),
            client.RemoteSolver,
            lambda remote, **kw: failover.FailoverSolver(
                remote, device="cpu", **kw),
            supervisor.SolverSupervisor,
            lambda addr: chaos.InProcessSidecar(addr, device="cpu"))
REF = Side("ref", jtypes, JTracker, JResourceName,
           lambda **kw: JPlacementModel(use_pallas=False, **kw),
           jclient.RemoteSolver,
           lambda remote, **kw: jfailover.FailoverSolver(
               remote, prewarm=False, **kw),
           jsupervisor.SolverSupervisor,
           lambda addr: jchaos.InProcessSidecar(addr))


def outage_run(side, addr):
    """Config #11 cut small: the kill at tick KILL, the supervised
    respawn at tick RESPAWN (``check_once``, no backoff)."""
    handles = []

    def spawn():
        handles.append(side.sidecar(addr))
        return handles[-1]

    sup = side.supervisor_cls(addr, spawn_fn=spawn, backoff_base_s=0.0,
                              backoff_cap_s=0.0, ready_timeout_s=10.0)
    sup.start(wait_ready=True, monitor=False)
    remote = side.remote_cls(addr, timeout=10.0, backoff_base_s=0.01,
                             backoff_cap_s=0.05)
    backend = side.failover_cls(remote, failure_threshold=2,
                                recovery_probes=2)
    model = side.model_cls(backend=backend)
    backend.on_flip_back = model.reset_staging
    restarts = []

    def on_tick(t):
        if t == KILL:
            handles[-1].kill()
        elif t == RESPAWN:
            restarts.append(sup.check_once())

    try:
        log, _, modes, _ = outage_churn(
            model, side.types, side.tracker, side.resource, n_nodes=NODES,
            ticks=TICKS, on_tick=on_tick,
            warm=lambda: setattr(remote, "retry_total_s", RETRY_BUDGET_S))
        return log, modes, restarts, sup.status(), backend.status()
    finally:
        sup.stop()
        backend.close()


def inprocess_run(side):
    log, _, modes, _ = outage_churn(side.model_cls(), side.types,
                                    side.tracker, side.resource,
                                    n_nodes=NODES, ticks=TICKS)
    return log, modes


def test_outage_churn_matches_reference(tmp_path):
    p_log, p_modes, p_restarts, p_sup, p_status = outage_run(
        PORT, str(tmp_path / "port.sock"))
    r_log, r_modes, r_restarts, r_sup, r_status = outage_run(
        REF, str(tmp_path / "ref.sock"))
    pi_log, pi_modes = inprocess_run(PORT)
    ri_log, _ = inprocess_run(REF)
    assert p_log == r_log == pi_log == ri_log
    assert any(node is not None for tick in p_log for _, node in tick)
    # every tick placed: no round skipped, the kill answered locally
    assert len(p_log) == TICKS
    assert p_modes == r_modes
    assert mode_runs(p_modes) == ["remote", "local-fallback",
                                  "local-degraded", "remote"]
    assert p_modes.index("local-fallback") == KILL
    assert set(pi_modes) == {"kernel"}
    assert p_restarts == r_restarts == ["restarted"]
    assert p_sup["restarts_total"] == r_sup["restarts_total"] == 1
    assert p_sup["state"] == r_sup["state"]
    keys = ("flips_to_degraded", "flips_to_remote", "local_solves",
            "degraded", "consecutive_failures", "last_mode")
    assert {k: p_status[k] for k in keys} == {k: r_status[k] for k in keys}
    assert p_status["flips_to_degraded"] == p_status["flips_to_remote"] == 1


def wire_problem(n_nodes=6, n_pods=9, seed=5):
    """One plain solve as numpy arrays (both packages build from them)."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n_nodes, 8), np.int32)
    alloc[:, 0] = 16000
    alloc[:, 1] = 32768
    used = (alloc * rng.uniform(0, 0.6, (n_nodes, 1))).astype(np.int32)
    state = dict(alloc=alloc, used_req=used, usage=used.copy(),
                 prod_usage=np.zeros_like(alloc),
                 est_extra=np.zeros_like(alloc),
                 prod_base=np.zeros_like(alloc),
                 metric_fresh=np.ones(n_nodes, bool),
                 schedulable=np.ones(n_nodes, bool))
    req = np.zeros((n_pods, 8), np.int32)
    req[:, 0] = rng.integers(500, 4000, n_pods)
    req[:, 1] = rng.integers(256, 4096, n_pods)
    pods = dict(req=req, est=(req * 85) // 100,
                is_prod=np.zeros(n_pods, bool),
                is_daemonset=np.zeros(n_pods, bool))
    weights = np.zeros(8, np.int32)
    weights[:2] = 1
    thresholds = np.zeros(8, np.int32)
    thresholds[0], thresholds[1] = 65, 95
    params = dict(weights=weights, thresholds=thresholds,
                  prod_thresholds=np.zeros(8, np.int32))
    return state, pods, params


def port_args(problem):
    state, pods, params = problem
    t = torch.as_tensor
    return (NodeState(**{k: t(v) for k, v in state.items()}),
            PodBatch.build(**{k: t(v) for k, v in pods.items()}),
            ScoreParams(**{k: t(v) for k, v in params.items()}),
            SolverConfig())


def ref_args(problem):
    import jax.numpy as jnp

    state, pods, params = problem
    return (jbinpack.NodeState(**{k: jnp.asarray(v)
                                  for k, v in state.items()}),
            jbinpack.PodBatch.build(**{k: jnp.asarray(v)
                                       for k, v in pods.items()}),
            jbinpack.ScoreParams(**{k: jnp.asarray(v)
                                    for k, v in params.items()}),
            jbinpack.SolverConfig())


def fast_remote(side, addr):
    return side.remote_cls(addr, retry_total_s=0.05, backoff_base_s=0.01,
                           backoff_cap_s=0.02)


def test_flips_and_hysteresis_step_for_step(tmp_path):
    """The same scripted probes and solves against a dead sidecar drive
    both state machines through the same statuses; the flip back resets
    the remote base and fires on_flip_back once."""
    problem = wire_problem()
    want = jbinpack.solve_batch(*ref_args(problem))
    trails = {}
    for side, args in ((PORT, port_args(problem)), (REF, ref_args(problem))):
        probes = {"ok": False}
        flips = []
        backend = side.failover_cls(
            fast_remote(side, str(tmp_path / f"{side.name}-gone.sock")),
            failure_threshold=2, recovery_probes=2,
            probe_fn=lambda probes=probes: probes["ok"],
            on_flip_back=lambda flips=flips: flips.append(1))
        trail = []
        for step in ("solve", "solve", "solve", "recover", "up", "recover",
                     "down", "recover", "up", "recover", "recover"):
            if step == "solve":
                result = backend.solve_result(*args)
                np.testing.assert_array_equal(np.asarray(result.assign),
                                              np.asarray(want.assign))
                np.testing.assert_array_equal(
                    np.asarray(result.node_state.used_req),
                    np.asarray(want.node_state.used_req))
            elif step == "recover":
                trail.append(("recovered", backend.maybe_recover()))
            else:
                probes["ok"] = step == "up"
            st = backend.status()
            trail.append({k: st[k] for k in (
                "degraded", "consecutive_failures", "healthy_probes",
                "flips_to_degraded", "flips_to_remote", "local_solves",
                "last_mode")})
        trails[side.name] = (trail, flips)
        backend.close()
    assert trails["port"] == trails["ref"]
    assert trails["port"][1] == [1]


@pytest.mark.parametrize("side", [PORT, REF], ids=["port", "ref"])
def test_overloaded_past_budget_falls_back_local(side):
    """A sidecar shedding this caller past its retry budget is an outage
    from the scheduler's seat: answered locally, flipped to degraded."""
    overloaded = (client.SolverOverloaded if side is PORT
                  else jclient.SolverOverloaded)

    class Shedding:
        address = "/nowhere"
        supports_staging_delta = False

        def solve_result(self, *a, **kw):
            raise overloaded("overloaded: scripted")

    problem = wire_problem(seed=9)
    backend = side.failover_cls(Shedding(), failure_threshold=1,
                                recovery_probes=2, probe_fn=lambda: False)
    args = port_args(problem) if side is PORT else ref_args(problem)
    result = backend.solve_result(*args)
    want = jbinpack.solve_batch(*ref_args(problem))
    assert backend.last_mode == "local-fallback"
    assert backend.status()["degraded"]
    np.testing.assert_array_equal(np.asarray(result.assign),
                                  np.asarray(want.assign))


def test_local_solve_is_the_sidecars_kernel_dispatch(monkeypatch):
    """The local path is the sidecar's dispatch to the routed kernel
    (its CPU twin here); a failed kernel raises, with no fallback."""
    calls = []
    real = server.kernel_solve_batch

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(server, "kernel_solve_batch", spy)
    backend = failover.FailoverSolver(
        fast_remote(PORT, "/nowhere.sock"), failure_threshold=1,
        probe_fn=lambda: False, device="cpu")
    problem = wire_problem(seed=11)
    backend.solve_result(*port_args(problem))
    assert calls == [1]
    assert backend.last_mode == "local-fallback"

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed: scripted")

    monkeypatch.setattr(server, "kernel_solve_batch", broken)
    with pytest.raises(RuntimeError, match="scripted"):
        backend.solve_result(*port_args(problem))
    assert backend.status()["local_solves"] == 1


def test_prewarm_only_for_cuda():
    backend = failover.FailoverSolver(fast_remote(PORT, "/nowhere.sock"),
                                      device="cpu")
    assert backend.wait_prewarm(0)
    assert backend.prewarm_report is None
    assert backend.status()["prewarm"] is None


def test_build_scheduler_wires_failover(tmp_path):
    cfg = SchedulerConfig(placement_backend="sidecar",
                          solver_address=str(tmp_path / "none.sock"),
                          solver_failover=True, solver_failover_threshold=4,
                          solver_failover_recovery_probes=3)
    try:
        scheduler = build_scheduler(cfg, device="cpu")
        backend = scheduler.model.backend
        assert isinstance(backend, failover.FailoverSolver)
        assert (backend.failure_threshold, backend.recovery_probes) == (4, 3)
        # the flip-back is wired to the model's full-restage reset
        assert backend.on_flip_back == scheduler.model.reset_staging
        assert scheduler.migration_arbiter is not None
        assert WORKING_SET.migration_hook is not None
        assert "migration" in FLIGHT._payload_hooks
        assert {"workingset", "migration"} <= set(
            scheduler.services.names())
        plain = build_scheduler(SchedulerConfig(host_fallback_cells=0),
                                device="cpu")
        assert plain.model.backend is None
    finally:
        # the process singletons outlive this test
        WORKING_SET.migration_hook = None
        FLIGHT.unregister_payload("migration")


@pytest.mark.parametrize("field, value, item", [
    # ROADMAP item 8, the host route, is ported: its cutoff is taken as
    # given
    ("host_fallback_cells", 4096, None),
    ("node_shards", 2, "item 10"),
])
def test_build_scheduler_refuses_what_is_not_ported(field, value, item):
    if item is None:
        sched = build_scheduler(SchedulerConfig(**{field: value}),
                                device="cpu")
        assert sched.model.host_fallback_cells == value
        return
    with pytest.raises(NotImplementedError, match=item):
        build_scheduler(SchedulerConfig(**{field: value}), device="cpu")
