"""The port's binaries (``cmd/scheduler.main`` and
``cmd/descheduler.main``) against the JAX package's, in process on the
CPU (``--device cpu`` for the port).

The cluster-spec seeding (``seed_bus_from_json``: the same bus), the
scheduler's ``--once`` round in process, through a sidecar, with the
sidecar down, under ``--leader-elect`` as leader and as standby (a lease
already held on the bus the binary builds), and the descheduler's
``--once`` cycle, leader and standby: each package's exit code, printed
lines (the port's own startup and exit lines aside) and resulting bus
must be equal. Then what only the port runs here: ``--solver-supervise``
(a real ``cmd.solver`` child on the CPU), a failing ``build_scheduler``
that must stop that child, the debug mux's services while the loop
runs, the auditor's sweeps through ``main``, and the refused flags."""

import importlib
import json
import time

import pytest

from koordinator_tpu_torch.service.supervisor import connection_probe

ROOTS = ("koordinator_tpu_torch", "koordinator_tpu")


@pytest.fixture(autouse=True)
def pinned_host_cutoff():
    """``main()`` has no flag for the host cutoff: both packages' probes
    are pinned to 0, as the reference's tests pin
    ``host_fallback_cells=0``, so no round here takes the host route."""
    with pytest.MonkeyPatch.context() as mp:
        for root in ROOTS:
            mp.setattr(mod(root, "models.placement"),
                       "measure_host_fallback_cells", lambda *a, **k: 0)
        yield


def cluster_json(tmp_path, nodes=2):
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps({
        "nodes": [{"name": f"n{i}", "cpu": 16000, "memory": 32768}
                  for i in range(nodes)],
        "pods": [{"name": "a", "cpu": 2000, "memory": 1024},
                 {"name": "b", "cpu": 1000, "memory": 512},
                 {"name": "busy", "cpu": 4000, "memory": 2048, "node": "n0"}],
    }))
    return str(path)


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def capture_bus(monkeypatch, root, held_by=None):
    """Make the binary's bus observable: the next ``APIServer()`` is
    recorded (and, with ``held_by``, starts with that identity holding
    the ``held_by[0]`` lease)."""
    bus_mod = mod(root, "client.bus")
    made = []
    real = bus_mod.APIServer

    def factory():
        bus = real()
        if held_by is not None:
            le = mod(root, "client.leaderelection")
            assert le.LeaderElector(bus, held_by[0], held_by[1]).tick(
                time.time())
        made.append(bus)
        return bus

    monkeypatch.setattr(bus_mod, "APIServer", factory)
    return made


def bus_record(root, bus):
    Kind = mod(root, "client.bus").Kind
    return (
        sorted((k, {int(r): v for r, v in n.allocatable.items()})
               for k, n in bus.list(Kind.NODE).items()),
        sorted((k, p.node_name, {int(r): v for r, v in p.requests.items()})
               for k, p in bus.list(Kind.POD).items()),
        sorted(bus.list(Kind.NODE_METRIC)),
        sorted(bus.list(Kind.RESERVATION)),
        sorted(bus.list(Kind.MIGRATION_JOB)),
    )


def printed(capsys, binary):
    """The printed lines, less the port's own startup and exit lines."""
    return [line for line in capsys.readouterr().out.splitlines()
            if not line.startswith(f"{binary}: wired")
            and not line.startswith(f"{binary}: loop returned")]


def run_main(root, binary, argv, monkeypatch, capsys, held_by=None):
    made = capture_bus(monkeypatch, root, held_by)
    if root == "koordinator_tpu_torch":
        argv = [*argv, "--device", "cpu"]
    rc = mod(root, f"cmd.{binary}").main(argv)
    lines = printed(capsys, f"koord-{binary}")
    monkeypatch.undo()
    return rc, lines, bus_record(root, made[0])


def both(case):
    got = [case(root) for root in ROOTS]
    assert got[0] == got[1]
    return got[0]


def test_seed_bus_from_json(tmp_path):
    path = cluster_json(tmp_path, nodes=3)

    def case(root):
        bus = mod(root, "client.bus").APIServer()
        mod(root, "cmd.scheduler").seed_bus_from_json(bus, path)
        Kind = mod(root, "client.bus").Kind
        metrics = [(m.node_name, dict(m.node_usage))
                   for m in bus.list(Kind.NODE_METRIC).values()]
        return bus_record(root, bus), metrics

    record, metrics = both(case)
    assert len(record[0]) == 3 and len(record[1]) == 3
    assert metrics == [(f"n{i}", {}) for i in range(3)]


@pytest.mark.parametrize("extra", [[], ["--leader-elect"],
                                   ["--audit-interval-rounds", "1"],
                                   ["--pipelined-ticks"]],
                         ids=["plain", "leader", "audit-every-round",
                              "pipelined"])
def test_scheduler_main_once(tmp_path, monkeypatch, capsys, extra):
    path = cluster_json(tmp_path)
    rc, lines, record = both(lambda root: run_main(
        root, "scheduler", ["--once", "--cluster-json", path, *extra],
        monkeypatch, capsys))
    assert rc == 0
    assert lines == ["round: 2/2 placed, 0 waiting"]
    assert dict((k, n) for k, n, _ in record[1])["default/busy"] == "n0"
    assert all(n is not None for _, n, _ in record[1])


def test_scheduler_main_leader_standby(tmp_path, monkeypatch, capsys):
    """A lease already held on the bus: ``--once`` returns 3 as standby
    and places nothing."""
    path = cluster_json(tmp_path)
    rc, lines, record = both(lambda root: run_main(
        root, "scheduler", ["--once", "--cluster-json", path,
                            "--leader-elect"],
        monkeypatch, capsys, held_by=("koord-scheduler", "other")))
    assert rc == 3
    assert lines == ["standby: lease held elsewhere"]
    assert [n for _, n, _ in record[1]] == [None, None, "n0"]


def test_scheduler_main_sidecar_backend(tmp_path, monkeypatch, capsys):
    path = cluster_json(tmp_path)

    def case(root):
        server = mod(root, "service.server")
        addr = str(tmp_path / f"{root}.sock")
        service = (server.PlacementService(addr, device="cpu")
                   if root == "koordinator_tpu_torch"
                   else server.PlacementService(addr))
        service.start()
        try:
            return run_main(root, "scheduler", [
                "--once", "--cluster-json", path,
                "--placement-backend", "sidecar", "--solver-address", addr],
                monkeypatch, capsys)
        finally:
            service.stop()

    rc, lines, _ = both(case)
    assert rc == 0 and lines == ["round: 2/2 placed, 0 waiting"]


def test_scheduler_main_sidecar_down_skips_round(tmp_path, monkeypatch,
                                                 capsys):
    path = cluster_json(tmp_path)
    got = {}
    for root in ROOTS:
        got[root] = run_main(root, "scheduler", [
            "--once", "--cluster-json", path, "--placement-backend",
            "sidecar", "--solver-address", str(tmp_path / "nothing.sock")],
            monkeypatch, capsys)
    (p_rc, p_lines, p_bus), (r_rc, r_lines, r_bus) = got.values()
    assert p_rc == r_rc == 1
    assert p_bus == r_bus
    # the skip line names the client's error, whose text is each
    # package's own
    assert [line.split(":")[0] for line in p_lines] == \
        [line.split(":")[0] for line in r_lines] == ["round skipped (1 "
                                                     "skipped so far)"]


def test_descheduler_main_once(tmp_path, monkeypatch, capsys):
    path = cluster_json(tmp_path)
    rc, lines, _ = both(lambda root: run_main(
        root, "descheduler", ["--once", "--cluster-json", path],
        monkeypatch, capsys))
    assert rc == 0
    assert lines[-1] == "descheduling cycle: migrated 0 pods"


def test_descheduler_main_leader_standby(tmp_path, monkeypatch, capsys):
    path = cluster_json(tmp_path)
    rc, lines, _ = both(lambda root: run_main(
        root, "descheduler", ["--once", "--cluster-json", path,
                              "--leader-elect"],
        monkeypatch, capsys, held_by=("koord-descheduler", "other")))
    assert rc == 3 and lines[-1] == "standby: lease held elsewhere"


# -- what only the port runs here ----------------------------------------------

sched_cmd = importlib.import_module("koordinator_tpu_torch.cmd.scheduler")


@pytest.mark.parametrize("flag, text", [
    (["--node-shards", "2"], "--node-shards above 1")])
def test_scheduler_main_refuses_flags_not_ported(tmp_path, capsys, flag,
                                                 text):
    with pytest.raises(SystemExit) as exc:
        sched_cmd.main(["--once", "--device", "cpu", *flag])
    assert exc.value.code == 2
    assert "not ported yet: " + text in capsys.readouterr().err


def test_scheduler_main_supervises_sidecar(tmp_path, capsys):
    """``--solver-supervise``: a real ``cmd.solver`` child on the CPU
    serves the round; the child is stopped when main returns."""
    addr = str(tmp_path / "sup.sock")
    rc = sched_cmd.main([
        "--once", "--cluster-json", cluster_json(tmp_path), "--device",
        "cpu", "--placement-backend", "sidecar", "--solver-address", addr,
        "--solver-supervise"])
    assert rc == 0
    assert "round: 2/2 placed, 0 waiting" in capsys.readouterr().out
    assert not connection_probe(addr, 0.5)


def test_scheduler_main_wiring_failure_stops_the_child(tmp_path,
                                                      monkeypatch):
    """A failing ``build_scheduler`` after the supervisor spawned its
    child: main raises, and the child is stopped, its socket closed."""
    from koordinator_tpu_torch.service import supervisor as sup_mod

    made = []
    real = sup_mod.SolverSupervisor

    class Recorded(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    def broken(config, device=None):
        assert made and made[0].status()["state"] == "running"
        raise RuntimeError("wiring failed")

    monkeypatch.setattr(sup_mod, "SolverSupervisor", Recorded)
    monkeypatch.setattr(sched_cmd, "build_scheduler", broken)
    addr = str(tmp_path / "sup.sock")
    with pytest.raises(RuntimeError, match="wiring failed"):
        sched_cmd.main(["--once", "--device", "cpu", "--placement-backend",
                        "sidecar", "--solver-address", addr,
                        "--solver-supervise"])
    assert made[0].status()["state"] == "stopped"
    assert not connection_probe(addr, 0.5)


def test_scheduler_main_debug_mux_and_auditor(tmp_path, monkeypatch,
                                              capsys):
    """``--debug-port`` with ``--leader-elect``: while the loop runs, the
    mux serves the state auditor (the promotion sweep ran before the
    round), the flight recorder, the trace and the device observatory,
    and ``/explain`` answers for a seeded pod."""
    import urllib.request

    seen = {}
    real = sched_cmd.run_loop

    def probing(scheduler, config, **kwargs):
        rc = real(scheduler, config, **kwargs)
        port = seen["port"]
        for name in ("state-auditor", "flight-recorder", "trace",
                     "device-observatory", "migration", "workingset"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/apis/v1/plugins/{name}",
                    timeout=10) as r:
                seen[name] = json.loads(r.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/explain?pod=default/a",
                timeout=10) as r:
            seen["explain"] = json.loads(r.read())
        return rc

    monkeypatch.setattr(sched_cmd, "run_loop", probing)
    real_server = importlib.import_module(
        "koordinator_tpu_torch.utils.debug_http").DebugHTTPServer

    class Recorded(real_server):
        def start(self):
            out = super().start()
            seen["port"] = self.port
            return out

    monkeypatch.setattr(importlib.import_module(
        "koordinator_tpu_torch.utils.debug_http"), "DebugHTTPServer",
        Recorded)
    rc = sched_cmd.main(["--once", "--cluster-json", cluster_json(tmp_path),
                         "--device", "cpu", "--leader-elect",
                         "--debug-port", "0"])
    assert rc == 0
    assert seen["state-auditor"]["sweeps"] == {"promotion": 1}
    assert seen["state-auditor"]["last"]["warm"]["prestage"]
    assert "explain" in seen and seen["explain"]
    assert "round: 2/2 placed, 0 waiting" in capsys.readouterr().out
