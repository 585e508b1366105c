"""The wire under faults: the port's ``ChaosProxy``, ``RemoteSolver``,
``FailoverSolver`` and ``SolverSupervisor`` against the JAX package's,
each package through its own proxy, client and in-process sidecar, and
the codec fuzz.

- The three-fault smoke (``tests/test_chaos.py``'s
  ``test_chaos_smoke_transport_faults``): a torn, a corrupted and a
  base-dropping frame over a 10-tick churn, absorbed by the client's
  retries.
- The six-fault outage property (``test_chaos_property_outage_failover_
  recovery``), off the clock: every fault of ``FAULT_KINDS`` scripted on
  a 36-tick churn. The stall is the only wait (``STALL_S`` against a
  shorter per-solve deadline set for that one request), the killed
  sidecar is respawned by the supervisor's ``check_once()`` at a fixed
  tick with no backoff and no monitor thread, and the failover flips
  degraded and back on its probes. Both packages must complete every
  tick with equal placements, failover modes and typed outcomes, equal to
  the fault-free in-process run, with equal staged node accounting.
- The seeded codec fuzz (``tests/test_wire_hardening.py``'s
  ``TestCodecFuzz``): the same malformed bytes give the same typed error
  class (or the same decoded arrays) in both packages.

Unix sockets under ``tmp_path``; no supervisor thread, no backoff
sleep."""

import importlib
import io
import struct

import numpy as np
import pytest


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.port = root == "koordinator_tpu_torch"
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.chaos = mod("testing.chaos")
        self.client = mod("service.client")
        self.failover = mod("service.failover")
        self.supervisor = mod("service.supervisor")
        self.codec = mod("service.codec")
        self.cluster = mod("state.cluster")
        self.binpack = mod("ops.binpack")
        self._model = mod("models.placement").PlacementModel

    def model(self, **kw):
        if self.port:
            return self._model(device="cpu", **kw)
        return self._model(use_pallas=False, **kw)

    def sidecar(self, addr):
        if self.port:
            return self.chaos.InProcessSidecar(addr, device="cpu")
        return self.chaos.InProcessSidecar(addr)

    def failover_solver(self, remote, **kw):
        if self.port:
            return self.failover.FailoverSolver(remote, device="cpu", **kw)
        return self.failover.FailoverSolver(remote, prewarm=False, **kw)


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")

N_NODES = 16
PENDING_PER_TICK = 8
DIRTY_PER_TICK = 3
WARMUP_TICKS = 2


def run_churn(P, model, ticks, seed, hooks=None):
    """The reference's seeded churn (``tests/test_chaos.py::_run_churn``)
    with package ``P``'s types: per tick a few node metrics refreshed, a
    pending queue scheduled, the placements bound. ``hooks[t]()`` runs
    before tick t's solve. Returns (per-tick placements, modes, final
    staged node accounting)."""
    CPU, MEM = P.X.ResourceName.CPU, P.X.ResourceName.MEMORY
    rng = np.random.default_rng(seed)
    nodes = [P.T.NodeSpec(name=f"n{i}", allocatable={
        CPU: int(rng.integers(16000, 64000)),
        MEM: int(rng.integers(32768, 131072))}) for i in range(N_NODES)]
    metrics = {n.name: P.T.NodeMetric(
        node_name=n.name, node_usage={CPU: int(rng.integers(0, 8000)),
                                      MEM: int(rng.integers(0, 16384))},
        update_time=10.0) for n in nodes}
    tracker = P.cluster.ClusterDeltaTracker()
    snap = P.T.ClusterSnapshot(nodes=nodes, pods=[], pending_pods=[],
                               node_metrics=metrics, now=20.0,
                               delta_tracker=tracker)
    rng = np.random.default_rng(seed + 1)
    for _ in range(WARMUP_TICKS):
        snap.pending_pods = []
        model.schedule(snap)
    log, modes = [], []
    for t in range(ticks):
        now = 30.0 + t
        for i in rng.choice(N_NODES, DIRTY_PER_TICK, replace=False):
            name = f"n{int(i)}"
            snap.node_metrics[name] = P.T.NodeMetric(
                node_name=name, node_usage={CPU: int(rng.integers(0, 12000)),
                                            MEM: int(rng.integers(0, 32768))},
                update_time=now)
            tracker.mark_node(name)
        snap.pending_pods = [P.T.PodSpec(name=f"t{t}p{j}", requests={
            CPU: int(rng.integers(200, 2000)),
            MEM: int(rng.integers(128, 2048))})
            for j in range(PENDING_PER_TICK)]
        snap.now = now
        if hooks and t in hooks:
            hooks[t]()
        by_uid = {p.uid: p for p in snap.pending_pods}
        result = model.schedule(snap)
        modes.append(model.last_solver)
        log.append(sorted(result.items()))
        for uid, node in result.items():
            if node is not None:
                pod = by_uid[uid]
                pod.node_name, pod.assign_time = node, now
                snap.pods.append(pod)
                tracker.mark_node(node)
        snap.pending_pods = []
    arrays = P.cluster.lower_nodes(snap)
    accounting = [list(arrays.names)] + [
        np.asarray(getattr(arrays, f)).tolist()
        for f in P.binpack.STAGED_NODE_FIELDS]
    return log, modes, accounting


def smoke(P, tmp_path):
    solver_addr = str(tmp_path / f"{P.root}-solver.sock")
    proxy_addr = str(tmp_path / f"{P.root}-proxy.sock")
    sidecar = P.sidecar(solver_addr)
    schedule = P.chaos.FaultSchedule({4: "torn-response",
                                      6: "corrupt-response",
                                      8: "drop-base"})
    proxy = P.chaos.ChaosProxy(proxy_addr, solver_addr, schedule).start()
    remote = P.client.RemoteSolver(proxy_addr, timeout=30.0,
                                   retry_total_s=5.0, backoff_base_s=0.01,
                                   backoff_cap_s=0.05)
    try:
        out = run_churn(P, P.model(backend=remote), ticks=10, seed=11)
        return out, dict(proxy.faults_injected), proxy.requests_seen
    finally:
        remote.close()
        proxy.stop()
        sidecar.kill()


def test_three_fault_smoke_matches_reference(tmp_path):
    got = smoke(PORT, tmp_path)
    want = smoke(REF, tmp_path)
    assert got == want
    (log, modes, accounting), faults, _ = got
    # bit-identical to the fault-free in-process run of both packages
    p_log, _, p_acc = run_churn(PORT, PORT.model(), ticks=10, seed=11)
    r_log, _, r_acc = run_churn(REF, REF.model(), ticks=10, seed=11)
    assert log == p_log == r_log
    assert accounting == p_acc == r_acc
    assert faults == {"torn-response": 1, "corrupt-response": 1,
                      "drop-base": 1}
    assert any(node is not None for tick in log for _, node in tick)


#: the six wire faults at the reference's request ordinals
OUTAGE_FAULTS = {6: "torn-response", 10: "corrupt-response", 14: "stall",
                 18: "drop-base", 22: "reset-request", 26: "kill-server"}
OUTAGE_TICKS = 36
RESPAWN_TICK = 26
#: the stalled response's delay, and the per-solve deadline set for that
#: one request (a healthy solve never runs under a deadline here)
STALL_S = 0.6
STALL_DEADLINE_S = 0.25


def outage(P, tmp_path):
    solver_addr = str(tmp_path / f"{P.root}-solver.sock")
    proxy_addr = str(tmp_path / f"{P.root}-proxy.sock")
    handles = []

    def spawn():
        handles.append(P.sidecar(solver_addr))
        return handles[-1]

    now = [0.0]
    sup = P.supervisor.SolverSupervisor(
        solver_addr, spawn_fn=spawn, ready_timeout_s=30.0,
        backoff_base_s=0.0, backoff_cap_s=0.0, clock=lambda: now[0])
    sup.start(wait_ready=True, monitor=False)
    proxy = P.chaos.ChaosProxy(
        proxy_addr, solver_addr, P.chaos.FaultSchedule(OUTAGE_FAULTS),
        kill_fn=lambda: handles[-1].kill(), stall_s=STALL_S).start()
    remote = P.client.RemoteSolver(proxy_addr, timeout=30.0, retries=1,
                                   retry_total_s=0.2, backoff_base_s=0.01,
                                   backoff_cap_s=0.05)
    backend = P.failover_solver(remote, failure_threshold=2,
                                recovery_probes=2)
    model = P.model(backend=backend)
    backend.on_flip_back = model.reset_staging
    checks, deadlines = [], []

    def arm():
        # the deadline only on the request the proxy will stall
        stalled = proxy.requests_seen == 14
        remote.deadline_s = STALL_DEADLINE_S if stalled else None
        deadlines.append(stalled)

    def respawn():
        arm()
        now[0] += 1.0
        checks.append(sup.check_once())

    hooks = {t: arm for t in range(OUTAGE_TICKS)}
    hooks[RESPAWN_TICK] = respawn
    try:
        log, modes, accounting = run_churn(P, model, OUTAGE_TICKS, seed=29,
                                           hooks=hooks)
        status = backend.status()
        keys = ("flips_to_degraded", "flips_to_remote", "local_solves",
                "degraded", "consecutive_failures", "last_mode")
        return dict(
            log=log, modes=modes, accounting=accounting, checks=checks,
            stalled_tick=deadlines.index(True),
            faults=dict(proxy.faults_injected),
            status={k: status[k] for k in keys},
            restarts=sup.status()["restarts_total"], spawned=len(handles),
            last_request=remote.last_request)
    finally:
        proxy.stop()
        sup.stop()
        backend.close()


def test_six_fault_outage_matches_reference(tmp_path):
    got = outage(PORT, tmp_path)
    want = outage(REF, tmp_path)
    assert got == want
    # every tick completed, bit-identical to the fault-free runs
    p_log, p_modes, p_acc = run_churn(PORT, PORT.model(), OUTAGE_TICKS, 29)
    r_log, _, r_acc = run_churn(REF, REF.model(), OUTAGE_TICKS, 29)
    assert len(got["log"]) == OUTAGE_TICKS
    assert got["log"] == p_log == r_log
    assert got["accounting"] == p_acc == r_acc
    assert set(p_modes) == {"kernel"}
    # every scripted fault fired, the machinery went through its states
    assert got["faults"] == {k: 1 for k in OUTAGE_FAULTS.values()}
    assert got["checks"] == ["restarted"]
    assert got["restarts"] == 1 and got["spawned"] == 2
    assert got["status"]["flips_to_degraded"] >= 1
    assert got["status"]["flips_to_remote"] >= 1
    assert not got["status"]["degraded"]
    modes = got["modes"]
    assert modes[got["stalled_tick"]] == "local-fallback"
    assert "local-degraded" in modes and modes[-1] == "remote"
    assert got["last_request"] in ("establish", "delta")


# -- the codec fuzz ---------------------------------------------------------------


def problem(P, n_nodes=4, n_pods=6):
    """``tests/test_wire_hardening.py::_problem`` as package ``P``'s
    ``SolveRequest``."""
    R, NR = P.X.ResourceName, P.X.NUM_RESOURCES
    rng = np.random.default_rng(0)
    alloc = np.zeros((n_nodes, NR), np.int32)
    alloc[:, R.CPU] = 16000
    alloc[:, R.MEMORY] = 32768
    node = {"alloc": alloc, "used_req": np.zeros_like(alloc),
            "usage": np.zeros_like(alloc),
            "prod_usage": np.zeros_like(alloc),
            "est_extra": np.zeros_like(alloc),
            "prod_base": np.zeros_like(alloc),
            "metric_fresh": np.ones(n_nodes, bool),
            "schedulable": np.ones(n_nodes, bool)}
    req = np.zeros((n_pods, NR), np.int32)
    req[:, R.CPU] = rng.choice([1000, 2000], n_pods)
    pods = {"req": req, "est": (req * 85) // 100,
            "is_prod": np.zeros(n_pods, bool),
            "is_daemonset": np.zeros(n_pods, bool)}
    weights = np.zeros(NR, np.int32)
    weights[R.CPU] = 1
    thresholds = np.zeros(NR, np.int32)
    thresholds[R.CPU] = 65
    params = {"weights": weights, "thresholds": thresholds,
              "prod_thresholds": np.zeros(NR, np.int32)}
    return P.codec.SolveRequest(node=node, pods=pods, params=params)


def outcome(fn, *args, **kw):
    """"ok" with the value's arrays, or the raised error's class name."""
    try:
        out = fn(*args, **kw)
    except Exception as e:  # the class is what is compared
        return type(e).__name__
    if out is None or isinstance(out, bytes):
        return ("ok", out)
    groups = {}
    for name, group in vars(out).items():
        if isinstance(group, dict):
            groups[name] = {k: np.asarray(v).tolist()
                            for k, v in group.items()}
        elif group is not None:
            groups[name] = np.asarray(group).tolist()
    return ("ok", groups)


def fuzzed_payloads(seed, req_payload, resp_payload):
    """The reference's decoder fuzz, trial for trial: truncations, flipped
    bytes, random garbage, and both."""
    rng = np.random.default_rng(seed)
    for trial in range(200):
        base = req_payload if trial % 2 else resp_payload
        buf = bytearray(base)
        kind = trial % 4
        if kind == 0:
            buf = buf[: int(rng.integers(0, len(buf)))]
        elif kind == 1:
            for _ in range(int(rng.integers(1, 16))):
                buf[int(rng.integers(0, len(buf)))] ^= int(
                    rng.integers(1, 256))
        elif kind == 2:
            buf = bytes(rng.integers(0, 256, int(rng.integers(0, 512)),
                                     dtype=np.uint8))
        else:
            buf = buf[: int(rng.integers(1, len(buf)))]
            if buf:
                buf[int(rng.integers(0, len(buf)))] ^= 0xFF
        yield trial % 2, bytes(buf)


@pytest.fixture
def fixed_clock(monkeypatch):
    import time

    # np.savez stamps each zip member with the current second
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decoder_fuzz_matches_reference(seed, fixed_clock):
    payloads = {}
    for P in (PORT, REF):
        resp = P.codec.SolveResponse(
            assignments=np.array([0, 1, -1], np.int32),
            node_used_req=np.ones((2, P.X.NUM_RESOURCES), np.int32))
        payloads[P.root] = (P.codec.encode_request(problem(P)),
                            P.codec.encode_response(resp))
    assert payloads[PORT.root] == payloads[REF.root]
    typed = {"CodecError", "FrameTooLarge"}
    seen = set()
    for is_request, buf in fuzzed_payloads(seed, *payloads[PORT.root]):
        got = [outcome(P.codec.decode_request if is_request
                       else P.codec.decode_response, buf)
               for P in (PORT, REF)]
        assert got[0] == got[1], buf[:64]
        assert isinstance(got[0], tuple) or got[0] in typed, got[0]
        seen.add(got[0] if isinstance(got[0], str) else "ok")
    assert "CodecError" in seen


@pytest.mark.parametrize("seed", [0, 1])
def test_read_frame_fuzz_matches_reference(seed, fixed_clock):
    payload = PORT.codec.encode_request(problem(PORT, n_nodes=2, n_pods=2))
    frame = struct.pack(">I", len(payload)) + payload
    rng = np.random.default_rng(seed)
    typed = {"TruncatedFrame", "FrameTooLarge"}
    seen = set()
    for trial in range(200):
        buf = bytearray(frame)
        kind = trial % 3
        if kind == 0:
            buf = buf[: int(rng.integers(0, len(buf)))]
        elif kind == 1:
            buf[int(rng.integers(0, 4))] ^= int(rng.integers(1, 256))
        else:
            buf[int(rng.integers(4, len(buf)))] ^= 0xFF
        got = [outcome(P.codec.read_frame, io.BytesIO(bytes(buf)),
                       max_frame=len(payload) * 4) for P in (PORT, REF)]
        assert got[0] == got[1], trial
        assert isinstance(got[0], tuple) or got[0] in typed, got[0]
        seen.add(got[0] if isinstance(got[0], str) else "ok")
    assert seen >= {"TruncatedFrame", "FrameTooLarge", "ok"}


@pytest.mark.parametrize("frame, error", [
    (b"", None), (b"\x00\x00", None),
    (struct.pack(">I", 100) + b"x" * 10, "TruncatedFrame"),
    (struct.pack(">I", 5000) + b"x" * 5000, "FrameTooLarge")])
def test_framing_errors_are_the_same_class(frame, error):
    """A short header is a clean close (None), a short payload
    ``TruncatedFrame``, a prefix past the cap ``FrameTooLarge`` read from
    the 4 header bytes alone, in both packages."""
    for P in (PORT, REF):
        stream = io.BytesIO(frame)
        got = outcome(P.codec.read_frame, stream, max_frame=4096)
        assert got == (error or ("ok", None)), (P.root, got)
        if error == "FrameTooLarge":
            assert stream.tell() == 4
