"""The wire under faults, the eviction storm and the manager binary on the
card (``cuda``: skipped without an NVIDIA GPU), each against the same run
on the CPU.

- Config #11 cut to 64 nodes through a ``ChaosProxy`` with the six wire
  faults, ``RemoteSolver`` -> ``FailoverSolver`` on the card -> an
  ``InProcessSidecar`` on the card, the supervisor's respawn by
  ``check_once()``: every tick equal to the fault-free CPU run.
- The eviction storm at 10 nodes under the reference's schedule with the
  preemption on the card: rounds, decisions and placements equal the CPU
  run's, within the budgets.
- ``cmd/manager.main --once --device cuda`` against ``--device cpu``, and
  the admitted round (``build_manager`` on the card, a ``BE`` half through
  the webhooks, a wired scheduler's round) against the CPU.

This file imports no JAX, so it runs on a machine with a GPU and no JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_manager_cuda.py``."""

import json
import os

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import QoSClass, ResourceName
from koordinator_tpu_torch.client import APIServer, Kind, wire_manager
from koordinator_tpu_torch.client.wiring import (
    wire_pod_webhook,
    wire_scheduler,
)
from koordinator_tpu_torch.cmd import manager as cmd_manager
from koordinator_tpu_torch.cmd.scheduler import (
    SchedulerConfig,
    build_scheduler,
    run_loop,
    seed_bus_from_json,
)
from koordinator_tpu_torch.control.migration import (
    MigrationArbiter,
    MigrationBudget,
)
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.service.client import RemoteSolver
from koordinator_tpu_torch.service.failover import FailoverSolver
from koordinator_tpu_torch.service.supervisor import SolverSupervisor
from koordinator_tpu_torch.state.cluster import ClusterDeltaTracker
from koordinator_tpu_torch.testing import chaos
from koordinator_tpu_torch.testing.failure_domain import outage_churn
from koordinator_tpu_torch.webhook import ClusterColocationProfile

pytestmark = pytest.mark.cuda

# the warm pool stays inert unless a test configures its store, as
# tests/conftest.py keeps it for the CPU suite (these files also run
# under --noconftest, where a default store in the home directory
# would restore earlier runs' entries and count their launches)
os.environ.setdefault("KTPU_COMPILATION_CACHE_DIR", "")


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


FAULTS = {6: "torn-response", 10: "corrupt-response", 14: "stall",
          18: "drop-base", 22: "reset-request", 26: "kill-server"}


def test_wire_faults_on_the_card_equal_the_cpu(tmp_path):
    _needs_gpu()
    solver, proxy_addr = str(tmp_path / "s.sock"), str(tmp_path / "p.sock")
    handles, now = [], [0.0]

    def spawn():
        handles.append(chaos.InProcessSidecar(solver, device="cuda"))
        return handles[-1]

    sup = SolverSupervisor(solver, spawn_fn=spawn, backoff_base_s=0.0,
                           backoff_cap_s=0.0, clock=lambda: now[0])
    sup.start(wait_ready=True, monitor=False)
    proxy = chaos.ChaosProxy(proxy_addr, solver, chaos.FaultSchedule(FAULTS),
                             kill_fn=lambda: handles[-1].kill(),
                             stall_s=0.6).start()
    remote = RemoteSolver(proxy_addr, timeout=60.0, retry_total_s=0.2,
                          backoff_base_s=0.01, backoff_cap_s=0.05)
    backend = FailoverSolver(remote, failure_threshold=2, recovery_probes=2,
                             prewarm=False, device="cuda")
    model = PlacementModel(backend=backend, device="cuda")
    backend.on_flip_back = model.reset_staging

    def on_tick(t):
        remote.deadline_s = 0.25 if proxy.requests_seen == 14 else None
        if t == 28:
            now[0] += 1.0
            assert sup.check_once() == "restarted"

    try:
        log, _, modes, _ = outage_churn(
            model, ttypes, ClusterDeltaTracker, ResourceName, n_nodes=64,
            dirty=4, pending=16, ticks=36, on_tick=on_tick)
        faults = dict(proxy.faults_injected)
    finally:
        proxy.stop()
        sup.stop()
        backend.close()
    want, _, _, _ = outage_churn(
        PlacementModel(device="cpu"), ttypes, ClusterDeltaTracker,
        ResourceName, n_nodes=64, dirty=4, pending=16, ticks=36)
    assert log == want
    assert faults == {k: 1 for k in FAULTS.values()}
    assert "local-degraded" in modes and modes[-1] == "remote"


def _storm(device):
    nodes, residents, arrivals = chaos.eviction_storm_world(seed=11,
                                                            n_nodes=10)
    sched = Scheduler(model=PlacementModel(device=device),
                      preemption_backend="device")
    arb = MigrationArbiter(MigrationBudget(max_per_round=4, max_per_node=2,
                                           max_per_tenant=6, window_s=3.0))
    sched.migration_arbiter = arb
    for node in nodes:
        sched.add_node(node)
    for pod in residents + arrivals:
        sched.add_pod(pod)
    log = []
    for t in range(14):
        if t == 7:
            arb.set_budget(MigrationBudget(max_per_round=2, max_per_node=1,
                                           max_per_tenant=3, window_s=3.0))
        out = sched.schedule_pending(now=100.0 + 2.0 * t)
        log.append((sorted(out.items()), sorted(out.nominations.items())))
    placed = sorted((p.name, p.node_name)
                    for p in sched.cache.pods.values() if p.node_name)
    return log, arb.decisions(), placed


def test_eviction_storm_on_the_card_equals_the_cpu():
    _needs_gpu()
    for kind in bk.LAUNCHES:
        bk.LAUNCHES[kind] = 0
    got = _storm("cuda")
    assert bk.LAUNCHES["block"] >= 1, bk.LAUNCHES
    assert got == _storm("cpu")
    assert got[2] == sorted((f"evstorm-ls-{i}", f"evstorm-n{i}")
                            for i in range(10))


def _cluster_json(tmp_path, n_nodes=1200, n_pending=800):
    path = tmp_path / "cluster.json"
    rng = np.random.default_rng(3)
    path.write_text(json.dumps({
        "nodes": [{"name": f"n{i}", "cpu": 32000, "memory": 65536}
                  for i in range(n_nodes)],
        "pods": [{"name": f"a{i}", "cpu": 4000, "memory": 4096,
                  "node": f"n{i}"} for i in range(n_nodes)]
        + [{"name": f"p{j}", "cpu": int(rng.integers(100, 3000)),
            "memory": int(rng.integers(128, 4096))}
           for j in range(n_pending)],
    }))
    return str(path)


def test_manager_main_on_the_card_equals_the_cpu(tmp_path, capsys):
    _needs_gpu()
    path = _cluster_json(tmp_path)
    out = {}
    for device in ("cuda", "cpu"):
        rc = cmd_manager.main(["--once", "--cluster-json", path, "--device",
                               device])
        lines = capsys.readouterr().out.splitlines()
        assert lines[1].startswith(f"koord-manager: wired on {device}")
        out[device] = (rc, [x for x in lines
                            if not x.startswith("koord-manager:")])
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0] == 0
    assert out["cuda"][1][-1] == "noderesource reconcile: 1200 nodes synced"


def _admitted_round(path, device):
    bus = APIServer()
    sched = build_scheduler(SchedulerConfig(host_fallback_cells=0),
                            device=device)
    wire_scheduler(bus, sched)
    manager = cmd_manager.build_manager(cmd_manager.ManagerConfig(),
                                        device=device)
    wire_pod_webhook(bus, manager.mutating_webhook)
    manager.mutating_webhook.update_profile(ClusterColocationProfile(
        name="be", selector={"colocation": "be"}, qos_class=QoSClass.BE,
        priority=5500))
    loop = wire_manager(bus, manager.noderesource)
    with open(path) as f:
        spec = json.load(f)
    running = dict(spec, pods=[p for p in spec["pods"] if "node" in p])
    running_path = path + f".{device}.running"
    with open(running_path, "w") as f:
        json.dump(running, f)
    seed_bus_from_json(bus, running_path)
    synced = loop.reconcile(now=1000.0)
    for j, p in enumerate(x for x in spec["pods"] if "node" not in x):
        pod, violations = manager.admit_pod(ttypes.PodSpec(
            name=p["name"], labels={"colocation": "be"} if j % 2 else {},
            requests={ResourceName.CPU: p["cpu"],
                      ResourceName.MEMORY: p["memory"]}))
        assert violations == []
        bus.apply(Kind.POD, pod.uid, pod)
    logs = []
    assert run_loop(sched, SchedulerConfig(), once=True,
                    log=logs.append) == 0
    return synced, logs, sorted(
        (p.uid, p.node_name, p.qos.name) for p in bus.list(Kind.POD).values())


def test_admitted_round_on_the_card_equals_the_cpu(tmp_path):
    _needs_gpu()
    path = _cluster_json(tmp_path)
    for kind in bk.LAUNCHES:
        bk.LAUNCHES[kind] = 0
    got = _admitted_round(path, "cuda")
    assert sum(bk.LAUNCHES.values()) == 1, bk.LAUNCHES
    assert got == _admitted_round(path, "cpu")
    assert any(q == "BE" and node for _, node, q in got[2])
