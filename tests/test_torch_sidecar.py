"""The solver sidecar end to end over a unix socket under ``tmp_path``:
the reference's ``PlacementModel(backend=RemoteSolver)`` driving the
port's ``PlacementService(device="cpu")``, the port's ``RemoteSolver``
driving the reference's service, and the port's ``Scheduler`` on a remote
model, each round equal to the in-process solves (exact). Every socket
wait is bounded: client timeouts of at most 10 s, ``stop()`` in
``finally``."""

import os

import numpy as np
import pytest

from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu.scheduler.scheduler import Scheduler as JScheduler
from koordinator_tpu.service import client as ref_client
from koordinator_tpu.service import server as ref_server
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.cmd import solver
from koordinator_tpu_torch.service import client, server
from test_torch_scheduler import PORT, REF, TOTAL, _apply, _stream

TIMEOUT_S = 10.0


def ref_scheduler(model):
    return JScheduler(model=model, cluster_total=REF.res(TOTAL),
                      enable_preemption=False)


def port_scheduler(model):
    return Scheduler(model=model, cluster_total=PORT.res(TOTAL),
                     enable_preemption=False)


def drive(schedulers, rounds, check):
    """Feed ``schedulers`` (``[(scheduler, package)]``) one stream; after
    each round ``check(r, results)``."""
    for r, (now, events) in enumerate(_stream(seed=3, rounds=rounds)):
        for event in events:
            for sched, pkg in schedulers:
                _apply(sched, pkg, event)
        results = [sched.schedule_pending(now=now) for sched, _ in schedulers]
        check(r, results)
        for (sched, _), got in zip(schedulers, results):
            for uid, node in got.items():
                if node is not None:
                    sched.cache.finish_binding(uid)


def same_rounds(results):
    want = results[0]
    assert any(n is not None for n in want.values())
    for got in results[1:]:
        assert dict(got) == dict(want)
        assert got.waiting == want.waiting


def test_reference_model_drives_the_port_service(tmp_path):
    addr = str(tmp_path / "solver.sock")
    service = server.PlacementService(addr, device="cpu")
    service.start()
    remote = ref_client.RemoteSolver(addr, timeout=TIMEOUT_S)
    try:
        sidecar = ref_scheduler(JPlacementModel(use_pallas=False,
                                                backend=remote))
        local = ref_scheduler(JPlacementModel(use_pallas=False))
        shapes = []

        def check(r, results):
            same_rounds(results)
            assert sidecar.model.last_solver == "remote"
            shapes.append(remote.last_request)

        drive([(local, REF), (sidecar, REF)], 2, check)
        assert shapes == ["establish", "delta"]
    finally:
        remote.close()
        service.stop()


def test_port_remote_solver_drives_the_reference_service(tmp_path):
    addr = str(tmp_path / "solver.sock")
    service = ref_server.PlacementService(addr)
    service.start()
    remote = client.RemoteSolver(addr, timeout=TIMEOUT_S)
    try:
        sidecar = port_scheduler(PlacementModel(device="cpu", backend=remote))
        local = port_scheduler(PlacementModel(device="cpu"))
        shapes = []

        def check(r, results):
            same_rounds(results)
            assert sidecar.model.last_solver == "remote"
            shapes.append(remote.last_request)

        drive([(local, PORT), (sidecar, PORT)], 2, check)
        assert shapes == ["establish", "delta"]
    finally:
        remote.close()
        service.stop()


def test_port_scheduler_on_the_port_sidecar(tmp_path):
    """Three rounds through the gate: the port's Scheduler on a remote
    model equals it in process and the reference's Scheduler."""
    addr = str(tmp_path / "solver.sock")
    service = server.PlacementService(addr, device="cpu")
    service.start()
    remote = client.RemoteSolver(addr, timeout=TIMEOUT_S, tenant="t1",
                                 lane="ls")
    try:
        sidecar = port_scheduler(PlacementModel(device="cpu", backend=remote))
        local = port_scheduler(PlacementModel(device="cpu"))
        ref = ref_scheduler(JPlacementModel(use_pallas=False))
        shapes = []

        def check(r, results):
            same_rounds(results)
            shapes.append(remote.last_request)

        drive([(ref, REF), (local, PORT), (sidecar, PORT)], 3, check)
        assert shapes == ["establish", "delta", "delta"]
        stats = service.status()["admission"]
        assert stats["requests_total"] == 3
        assert stats["tenants"]["t1"]["dispatched"] == 3
    finally:
        remote.close()
        service.stop()


def _plain_request(codec_mod):
    return codec_mod.SolveRequest(
        **testing.service_request_groups("plain", 16, 12))


def test_secret_handshake(tmp_path):
    from koordinator_tpu_torch.service import codec

    addr = str(tmp_path / "solver.sock")
    service = server.PlacementService(addr, secret=b"s3cret", device="cpu")
    service.start()
    try:
        with client.PlacementClient(addr, timeout=TIMEOUT_S,
                                    secret=b"s3cret") as c:
            ok = c.solve(_plain_request(codec))
        want = server.solve_from_request(_plain_request(codec), device="cpu")
        np.testing.assert_array_equal(ok.assignments, want.assignments)
        for secret in (b"wrong", None):
            with client.PlacementClient(addr, timeout=TIMEOUT_S,
                                        secret=secret) as c:
                with pytest.raises(client.SolverUnavailable):
                    c.solve(_plain_request(codec))
    finally:
        service.stop()


def test_restart_resends_the_full_state(tmp_path):
    """The sidecar restarts between two rounds: the delta the model would
    send meets a new server, and the solve transparently re-establishes."""
    addr = str(tmp_path / "solver.sock")
    service = server.PlacementService(addr, device="cpu")
    service.start()
    remote = client.RemoteSolver(addr, timeout=TIMEOUT_S, retries=3,
                                 retry_total_s=5.0)
    sidecar = port_scheduler(PlacementModel(device="cpu", backend=remote))
    local = port_scheduler(PlacementModel(device="cpu"))
    shapes = []
    try:
        def check(r, results):
            nonlocal service
            same_rounds(results)
            shapes.append(remote.last_request)
            if r == 0:
                service.stop()
                service = server.PlacementService(addr, device="cpu")
                service.start()

        drive([(local, PORT), (sidecar, PORT)], 2, check)
        assert shapes == ["establish", "establish"]
        assert sidecar.model.last_staging == "delta"
    finally:
        remote.close()
        service.stop()


@pytest.mark.parametrize("flag", [
    ["--debug-port", "0"], ["--profile-dir", "prof"],
    ["--hbm-budget-bytes", "4096"]])
def test_solver_binary_takes_lifted_flags(tmp_path, capsys, monkeypatch,
                                          flag):
    """The flags whose subsystems are ported start the solver, which
    answers a solve before ``--once`` returns."""
    from koordinator_tpu_torch.apis.extension import ResourceName
    from koordinator_tpu_torch.apis.types import (
        ClusterSnapshot,
        NodeSpec,
        PodSpec,
    )
    from koordinator_tpu_torch.obs.device import DEVICE_OBS
    from koordinator_tpu_torch.state.workingset import WORKING_SET

    CPU, MEM = ResourceName.CPU, ResourceName.MEMORY
    if flag[0] == "--profile-dir":
        flag = ["--profile-dir", str(tmp_path / "prof")]
    ready = tmp_path / "ready"
    addr = str(tmp_path / "solver.sock")
    answered = []
    real_start = server.PlacementService.start

    def start_and_answer(service):
        real_start(service)
        model = PlacementModel(backend=client.RemoteSolver(
            addr, timeout=TIMEOUT_S), device="cpu")
        snap = ClusterSnapshot(
            nodes=[NodeSpec(name=f"n{i}", allocatable={CPU: 8000,
                                                       MEM: 16384})
                   for i in range(3)],
            pods=[], pending_pods=[PodSpec(name=f"p{j}",
                                           requests={CPU: 1000})
                                   for j in range(4)], now=20.0)
        answered.append(model.schedule(snap))

    monkeypatch.setattr(server.PlacementService, "start", start_and_answer)
    try:
        assert solver.main(["--listen", addr, "--device", "cpu", "--once",
                            "--ready-file", str(ready), *flag]) == 0
        out = capsys.readouterr().out
        assert f"serving on {addr} (cpu)" in out
        assert ready.read_text() == str(os.getpid())
        assert answered and any(v is not None
                                for v in answered[0].values())
        if flag[0] == "--debug-port":
            assert "debug port" in out
        elif flag[0] == "--profile-dir":
            assert DEVICE_OBS.status()["profile"]["dir"] == flag[1]
        else:
            assert WORKING_SET.budget_bytes() == 4096
            assert WORKING_SET.status()["used_bytes"] == 0  # base closed
    finally:
        WORKING_SET.reset()
        DEVICE_OBS.configure(profile_dir="")


def test_solver_binary_once_writes_its_ready_file(tmp_path, capsys):
    ready = tmp_path / "ready"
    addr = str(tmp_path / "solver.sock")
    assert solver.main(["--listen", addr, "--device", "cpu", "--once",
                        "--ready-file", str(ready)]) == 0
    assert ready.read_text() == str(os.getpid())
    assert f"serving on {addr} (cpu)" in capsys.readouterr().out
    assert solver.parse_address(addr) == addr
    assert solver.parse_address("localhost:7070") == ("localhost", 7070)
    assert solver.parse_address(":7070") == ("127.0.0.1", 7070)


class _RaisingBackend:
    """A remote backend whose every solve fails at the connection."""

    supports_staging_delta = False

    def solve_result(self, *args, **kwargs):
        raise ConnectionError("sidecar down")


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_failed_remote_solve_keeps_the_remote_tag(pkg):
    """A backend that raises leaves ``last_solver`` naming the solver
    that failed ("remote", set before the call), in both packages, after
    one round through the package's Scheduler."""
    P = PORT if pkg == "port" else REF
    if pkg == "port":
        model = PlacementModel(backend=_RaisingBackend(), device="cpu")
        sched = port_scheduler(model)
    else:
        model = JPlacementModel(backend=_RaisingBackend())
        sched = ref_scheduler(model)
    sched.add_node(P.node({"name": "n0", "alloc": {0: 16000, 1: 32768}}))
    sched.add_pod(P.pod({"name": "p", "req": {0: 1000}}))
    assert model.last_solver is None
    with pytest.raises(ConnectionError, match="sidecar down"):
        sched.schedule_pending(now=10.0)
    assert model.last_solver == "remote"
