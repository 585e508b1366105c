"""The port's ``SolverSupervisor`` and ``RestartBreaker`` against the JAX
package's: scripted child handles and probes on a fake clock drive both
supervisors' ``check_once`` through the same script, and every outcome
and every ``status()`` must be equal (the probe-budget split's keys
included; ``tests/test_torch_warm_pool.py`` drives the split itself). Cases: a crash, a child hung past the probe threshold, a fresh
child inside its ready grace, and a restart storm that opens the breaker
and then allows one half-open respawn per cooldown. Also
``connection_probe`` against the port's real ``PlacementService``."""

import pytest

from koordinator_tpu.service import supervisor as jsupervisor
from koordinator_tpu_torch.service import server, supervisor



class FakeProc:
    def __init__(self, pid):
        self.returncode = None
        self.killed = 0
        self.pid = pid

    def poll(self):
        return self.returncode

    def kill(self):
        self.killed += 1
        self.returncode = -9


class Harness:
    """One package's supervisor over scripted children, probe and clock."""

    def __init__(self, module, breaker=None, **kw):
        self.now = [0.0]
        self.alive = {"ok": True}
        self.spawned = []
        clock = lambda: self.now[0]

        def spawn():
            self.spawned.append(FakeProc(4242 + len(self.spawned)))
            return self.spawned[-1]

        if breaker is not None:
            kw["breaker"] = module.RestartBreaker(clock=clock, **breaker)
        kw.setdefault("probe_interval_s", 0.01)
        self.sup = module.SolverSupervisor(
            ("127.0.0.1", 1), spawn_fn=spawn,
            probe_fn=lambda: self.alive["ok"], sleep=lambda _s: None,
            clock=clock, backoff_base_s=0.0, backoff_cap_s=0.0, **kw)

    def status(self):
        return dict(self.sup.status())

    def step(self, op):
        """Apply one script step; returns what it observed."""
        kind, arg = op
        if kind == "check":
            return (self.sup.check_once(), self.status())
        if kind == "crash":
            self.spawned[-1].returncode = arg
        elif kind == "probe":
            self.alive["ok"] = arg
        elif kind == "clock":
            self.now[0] = arg
        return (kind, len(self.spawned),
                [p.killed for p in self.spawned])


CHECK = ("check", None)

SCRIPTS = {
    "crash": dict(wait_ready=True, kw={}, ops=[
        CHECK, ("crash", 1), CHECK, CHECK, ("crash", 3), CHECK, CHECK]),
    "hung-past-threshold": dict(
        wait_ready=True, kw=dict(probe_failure_threshold=3), ops=[
            ("probe", False), CHECK, CHECK, CHECK, ("probe", True), CHECK]),
    "ready-grace": dict(
        wait_ready=True,
        kw=dict(probe_failure_threshold=3, ready_timeout_s=60.0), ops=[
            ("probe", False), ("crash", 1), CHECK] + [CHECK] * 6 + [
            ("probe", True), CHECK, ("probe", False), CHECK, CHECK, CHECK,
            ("clock", 100.0), CHECK, CHECK]),
    "storm-breaker-half-open": dict(
        wait_ready=False,
        breaker=dict(threshold=3, window_s=60.0, cooldown_s=30.0),
        kw=dict(probe_failure_threshold=1), ops=[
            ("probe", False),
            ("crash", 1), CHECK, ("crash", 1), CHECK, ("crash", 1), CHECK,
            ("crash", 1), CHECK, CHECK, ("clock", 20.0), CHECK,
            ("clock", 31.0), CHECK, ("crash", 1), CHECK,
            ("clock", 62.0), CHECK, ("probe", True), CHECK, CHECK]),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_check_once_sequences_match_reference(case):
    script = SCRIPTS[case]
    runs = {}
    for name, module in (("port", supervisor), ("ref", jsupervisor)):
        h = Harness(module, breaker=script.get("breaker"), **script["kw"])
        h.sup.start(wait_ready=script["wait_ready"], monitor=False)
        try:
            runs[name] = [h.step(op) for op in script["ops"]]
            runs[name].append(("final", h.status()))
        finally:
            h.sup.stop()
        runs[name].append(("stopped", h.status()["state"]))
    assert runs["port"] == runs["ref"]
    outcomes = [r[0] for r in runs["port"] if isinstance(r[0], str)]
    assert "restarted" in outcomes


def test_check_once_outcomes_cover_every_case():
    """What each script is for: the outcomes it must reach (port)."""
    want = {
        "crash": {"running", "restarted"},
        "hung-past-threshold": {"probe-failed", "restarted"},
        "ready-grace": {"starting", "running", "probe-failed", "restarted"},
        "storm-breaker-half-open": {"restarted", "breaker-open"},
    }
    for case, script in SCRIPTS.items():
        h = Harness(supervisor, breaker=script.get("breaker"),
                    **script["kw"])
        h.sup.start(wait_ready=script["wait_ready"], monitor=False)
        try:
            seen = {h.sup.check_once() if op == CHECK else h.step(op)[0]
                    for op in script["ops"]}
        finally:
            h.sup.stop()
        assert want[case] <= seen, case


def test_breaker_alone_matches_reference():
    trails = {}
    for name, module in (("port", supervisor), ("ref", jsupervisor)):
        now = [0.0]
        b = module.RestartBreaker(threshold=2, window_s=10.0, cooldown_s=5.0,
                                  clock=lambda: now[0])
        trail = []
        for t, op in [(0, "restart"), (1, "allow"), (2, "restart"),
                      (3, "allow"), (7, "allow"), (8, "allow"), (13, "allow"),
                      (14, "healthy"), (15, "allow"), (30, "restart")]:
            now[0] = float(t)
            if op == "restart":
                trail.append(b.record_restart())
            elif op == "allow":
                trail.append(b.allow())
            else:
                b.record_healthy()
            trail.append(b.status())
        trails[name] = trail
    assert trails["port"] == trails["ref"]


def test_connection_probe_against_the_ports_service(tmp_path):
    addr = str(tmp_path / "probe.sock")
    assert not supervisor.connection_probe(addr, timeout_s=0.2)
    service = server.PlacementService(addr, device="cpu")
    service.start()
    try:
        assert supervisor.connection_probe(addr, timeout_s=0.5)
        # the reference's probe agrees on the port's service
        assert jsupervisor.connection_probe(addr, timeout_s=0.5)
    finally:
        service.stop()
    assert not supervisor.connection_probe(addr, timeout_s=0.2)


def test_default_spawn_runs_the_ports_solver(monkeypatch):
    seen = {}

    class Popen:
        def __init__(self, argv, **kw):
            seen["argv"] = argv

    import subprocess

    monkeypatch.setattr(subprocess, "Popen", Popen)
    sup = supervisor.SolverSupervisor("/tmp/s.sock",
                                      extra_argv=("--device", "cpu"))
    sup._spawn_fn()
    assert seen["argv"][1:] == ["-m", "koordinator_tpu_torch.cmd.solver",
                                "--listen", "/tmp/s.sock", "--device", "cpu"]
