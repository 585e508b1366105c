"""Rules of the PyTorch/CUDA port: it imports neither ``jax`` nor the JAX
package, its entry points default to CUDA and never quietly run on the
CPU, and a CUDA tensor never takes the kernel's plain twin.

This file imports no JAX, so the ``cuda`` cases can run on a machine with
a GPU and no JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_hygiene.py``."""

import os
import pkgutil
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.ops import binpack_kernel

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "koordinator_tpu_torch"


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PACKAGE)],
                                              "koordinator_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "koordinator_tpu_torch.models.placement" in mods
    assert "koordinator_tpu_torch.parallel.mesh" in mods
    # the fine-grained slice: its own copies of numa/ and device/
    for m in ("models.finegrained", "numa.accumulator", "numa.manager",
              "device.allocator", "scheduler.framework",
              "scheduler.plugins.nodenumaresource",
              "scheduler.plugins.deviceshare", "scheduler.plugins.nodeports",
              # the descheduling slice: the descheduler package, the
              # balance sweep, its oracle, the eviction control plane and
              # the copies of the metrics registry and the QoS lanes
              "descheduler.anomaly", "descheduler.sorter",
              "descheduler.framework", "descheduler.loadaware",
              "descheduler.migration", "descheduler.kubernetes",
              "ops.rebalance", "oracle.rebalance", "control.migration",
              "metrics.registry", "metrics.components", "obs.timeline",
              # the serving slice: the sidecar, its gate and lanes, the
              # client and the solver binary
              "service.codec", "service.tenancy", "service.admission",
              "service.server", "service.client", "cmd.solver",
              # the colocation slice: overcommit, the manager, the bus,
              # leader election, the wiring and the trace
              "ops.overcommit", "manager.sloconfig", "manager.noderesource",
              "client.bus", "client.leaderelection", "client.wiring",
              "obs.trace",
              # the loops slice: the pipelined and streaming loops, the
              # loop half of cmd/scheduler.py, the monitor, the flight
              # recorder, the device observatory and the arrival traces
              "scheduler.pipeline", "scheduler.streaming",
              "scheduler.monitor", "cmd.scheduler", "obs.flight",
              "obs.device", "testing", "testing.arrivals",
              # the failure-domain slice: the supervisor, the failover,
              # the HBM working set, the SLO controller, the debug mux
              # and the chaos and bench-configuration helpers
              "service.supervisor", "service.failover", "state.workingset",
              "control.slo", "utils.debug_http", "testing.chaos",
              "testing.failure_domain",
              # the binaries slice: the auditor, the NodeSLO renderer and
              # the descheduler binary
              "scheduler.auditor", "manager.nodeslo", "cmd.descheduler",
              # the host route: the scalar and vectorized oracles
              "oracle.placement", "oracle.vectorized",
              # the koordlet's reporting half: the system layer, the
              # audit log, the cgroup executor, the metric cache, the
              # collectors and the states informer with its reporters
              "koordlet.system", "koordlet.system.cgroup",
              "koordlet.system.cpuinfo", "koordlet.system.kidled",
              "koordlet.audit", "koordlet.audit.auditor",
              "koordlet.resourceexecutor",
              "koordlet.resourceexecutor.executor",
              "koordlet.metriccache", "koordlet.metriccache.metric_cache",
              "koordlet.metricsadvisor",
              "koordlet.metricsadvisor.framework",
              "koordlet.metricsadvisor.collectors",
              "koordlet.metricsadvisor.devices",
              "koordlet.statesinformer",
              "koordlet.statesinformer.states_informer",
              "koordlet.statesinformer.nodemetric_reporter",
              "koordlet.statesinformer.reporters",
              # the koordlet's actuation half: core scheduling, resctrl,
              # the qosmanager's strategies and the PLEG
              "koordlet.system.core_sched", "koordlet.system.resctrl",
              "koordlet.qosmanager", "koordlet.qosmanager.framework",
              "koordlet.qosmanager.cpusuppress",
              "koordlet.qosmanager.evictors",
              "koordlet.qosmanager.cpuburst",
              "koordlet.qosmanager.resctrl",
              "koordlet.qosmanager.cgreconcile",
              "koordlet.qosmanager.blkio",
              "koordlet.qosmanager.sysreconcile",
              "koordlet.pleg", "koordlet.pleg.pleg",
              # the koordlet binary: the runtime hooks, the perf-group
              # reader, the CPI collector and cmd/koordlet
              "koordlet.runtimehooks", "koordlet.runtimehooks.protocol",
              "koordlet.runtimehooks.hooks",
              "koordlet.runtimehooks.groupidentity",
              "koordlet.runtimehooks.cpuset",
              "koordlet.runtimehooks.devices",
              "koordlet.runtimehooks.batchresource",
              "koordlet.runtimehooks.cpunormalization",
              "koordlet.runtimehooks.terwayqos",
              "koordlet.runtimehooks.reconciler",
              "koordlet.runtimehooks.server", "koordlet.runtimehooks.nri",
              "native", "native.perf",
              "koordlet.metricsadvisor.performance", "cmd.koordlet",
              # the CRI proxy and the warm pool
              "runtimeproxy", "runtimeproxy.criserver", "cmd.runtimeproxy",
              "utils.compilation_cache", "service.warmpool"):
        assert f"koordinator_tpu_torch.{m}" in mods, m
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'koordinator_tpu' or k.startswith('koordinator_tpu.')"
        " for k in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(.*)$")
_REFERENCE = re.compile(r"\bkoordinator_tpu\b(?!_torch)|\bjax\b")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_reference_or_jax_import(path):
    for n, line in enumerate((ROOT / path).read_text().splitlines(), 1):
        m = _IMPORT.match(line)
        assert not (m and _REFERENCE.search(m.group(1))), f"{path}:{n}: {line}"


def _entry_points():
    """Each public constructor of the port that takes ``device``, as
    ``(name, call(**device_kwargs) -> a tensor it built)``."""
    from koordinator_tpu_torch import convert, testing
    from koordinator_tpu_torch.apis.extension import ResourceName
    from koordinator_tpu_torch.apis.types import (
        ClusterSnapshot,
        NodeSpec,
        PodSpec,
    )
    from koordinator_tpu_torch.manager.noderesource import (
        NodeResourceController,
    )
    from koordinator_tpu_torch.models.placement import PlacementModel
    from koordinator_tpu_torch.state.cluster import lower_nodes
    from koordinator_tpu_torch.ops import rebalance
    from koordinator_tpu_torch.ops.gang import GangState
    from koordinator_tpu_torch.ops.rebalance import DeviceSweep
    from koordinator_tpu_torch.ops.quota import QuotaState
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler

    def scheduler_model(enable_preemption=False, **kw):
        # Scheduler() builds its own model, on the default device
        model = PlacementModel(**kw) if kw else None
        return Scheduler(model=model,
                         enable_preemption=enable_preemption).model

    def resident_world(**kw):
        # the resident world stages on its model's device
        snap = ClusterSnapshot(
            nodes=[NodeSpec(name="n0", allocatable={ResourceName.CPU: 8})],
            pods=[PodSpec(name="p", node_name="n0", priority=1)])
        model = PlacementModel(**kw)
        arrays = lower_nodes(snap, **model.lowering_kwargs())
        return model.resident_world(model.lower_residents(snap, arrays))

    res_world = dict(req=np.zeros((2, 3, 8), np.int32),
                     priority=np.zeros((2, 3), np.int32),
                     quota_id=np.zeros((2, 3), np.int32),
                     preemptible=np.ones((2, 3), bool),
                     valid=np.ones((2, 3), bool))
    batch = dict(req=np.zeros((4, 8), np.int32),
                 priority=np.zeros(4, np.int32), quota_id=np.zeros(4, np.int32),
                 is_daemonset=np.zeros(4, bool), is_prod=np.zeros(4, bool),
                 quota_used=np.zeros((4, 8), np.int32),
                 used_limit=np.zeros((4, 8), np.int32),
                 quota_enabled=np.zeros(4, bool), active=np.ones(4, bool))

    nodes, pods, params, quota, gang = testing.quota_gang_arrays(
        6, 5, 2, 2, 3, seed=0)
    sweep, sweep_avail, sweep_mask, _ = testing.sweep_batch_arrays(0, 5)

    def as_numpy(state):
        return {k: None if v is None else v.numpy()
                for k, v in state._asdict().items()}

    def sidecar(**kw):
        # the service binds its socket only after resolving its device
        from types import SimpleNamespace

        from koordinator_tpu_torch.service.server import PlacementService

        with tempfile.TemporaryDirectory() as d:
            service = PlacementService(os.path.join(d, "s.sock"), **kw)
            service.stop()
        return SimpleNamespace(device=service.device)

    def gate(**kw):
        from types import SimpleNamespace

        from koordinator_tpu_torch.service.admission import AdmissionGate

        g = AdmissionGate(lambda *a: None, **kw)
        g.shutdown(timeout=5.0)
        return SimpleNamespace(device=g.device)

    def node_cache(**kw):
        from koordinator_tpu_torch.service.server import NodeStateCache

        return NodeStateCache(**kw)

    def failover_solver(**kw):
        from types import SimpleNamespace

        from koordinator_tpu_torch.service.client import RemoteSolver
        from koordinator_tpu_torch.service.failover import FailoverSolver

        backend = FailoverSolver(RemoteSolver("/nowhere.sock"),
                                 prewarm=False, **kw)
        return SimpleNamespace(device=backend.device)

    def built_scheduler(**kw):
        from koordinator_tpu_torch.cmd.scheduler import (
            SchedulerConfig,
            build_scheduler,
        )

        return build_scheduler(SchedulerConfig(host_fallback_cells=0),
                               **kw).model.params.weights

    def host_probe(**kw):
        # the device the probe's device round staged its problem on
        from types import SimpleNamespace

        from koordinator_tpu_torch.models import placement

        placement.measure_host_fallback_cells(**kw)
        return SimpleNamespace(
            device=placement.host_probe(kw.get("device"))["device"])

    def wired_manager(**kw):
        from koordinator_tpu_torch.client import APIServer, wire_manager

        return wire_manager(APIServer(), **kw).controller

    def wired_descheduler(**kw):
        from koordinator_tpu_torch.client import APIServer, wire_descheduler
        from koordinator_tpu_torch.cmd.descheduler import (
            DeschedulerConfig,
            build_descheduler,
        )

        loop = wire_descheduler(APIServer(),
                                build_descheduler(DeschedulerConfig()), **kw)
        return loop._model.params.weights

    def rebalance_plugin(**kw):
        from types import SimpleNamespace

        from koordinator_tpu_torch.cmd.scheduler import (
            SchedulerConfig,
            build_rebalance_plugin,
        )
        from koordinator_tpu_torch import resolve_device

        plugin = build_rebalance_plugin(SchedulerConfig(
            rebalance_interval_s=1.0, rebalance_backend="device"), **kw)
        return SimpleNamespace(device=resolve_device(plugin.args.device))

    oc_nodes = dict(capacity=np.zeros((2, 8), np.int32),
                    system_used=np.zeros((2, 8), np.int32),
                    reserved=np.zeros((2, 8), np.int32),
                    prod_reclaimable=np.zeros((2, 8), np.int32),
                    metric_fresh=np.ones(2, bool))
    oc_params = dict(reclaim_percent=np.zeros(8, np.int32),
                     mid_threshold_percent=np.zeros(8, np.int32),
                     cpu_policy=np.zeros((), np.int32),
                     memory_policy=np.zeros((), np.int32))
    oc_pods = dict(node_idx=np.zeros(3, np.int32),
                   req=np.zeros((3, 8), np.int32),
                   usage=np.zeros((3, 8), np.int32),
                   has_metric=np.ones(3, bool), is_hp=np.ones(3, bool),
                   is_lse=np.zeros(3, bool), active=np.ones(3, bool))

    return [
        ("manager.NodeResourceController",
         lambda **kw: NodeResourceController(**kw)),
        ("client.wire_manager", wired_manager),
        ("client.wire_descheduler (its probes' PlacementModel)",
         wired_descheduler),
        ("cmd.scheduler.build_rebalance_plugin", rebalance_plugin),
        ("convert.overcommit_nodes",
         lambda **kw: convert.overcommit_nodes(oc_nodes, **kw).capacity),
        ("convert.overcommit_pods",
         lambda **kw: convert.overcommit_pods(oc_pods, **kw).req),
        ("convert.overcommit_params",
         lambda **kw: convert.overcommit_params(oc_params, **kw).cpu_policy),
        ("service.PlacementService", sidecar),
        ("service.AdmissionGate", gate),
        ("service.NodeStateCache", node_cache),
        ("service.FailoverSolver", failover_solver),
        ("cmd.scheduler.build_scheduler", built_scheduler),
        ("models.placement.measure_host_fallback_cells", host_probe),
        ("PlacementModel", lambda **kw: PlacementModel(**kw).params.weights),
        ("Scheduler", lambda **kw: scheduler_model(**kw).params.weights),
        ("Scheduler() with the reference's defaults (preemption on the "
         "device)",
         lambda **kw: scheduler_model(enable_preemption=True,
                                      **kw).params.weights),
        ("PlacementModel.resident_world",
         lambda **kw: resident_world(**kw).req),
        ("convert.resident_world",
         lambda **kw: convert.resident_world(res_world, **kw).req),
        ("convert.preemptor_batch",
         lambda **kw: convert.preemptor_batch(batch, **kw).req),
        ("convert.node_state", lambda **kw: convert.node_state(nodes, **kw).alloc),
        ("convert.pod_batch", lambda **kw: convert.pod_batch(pods, **kw).req),
        ("convert.score_params",
         lambda **kw: convert.score_params(params, **kw).weights),
        ("convert.quota_state",
         lambda **kw: convert.quota_state(
             as_numpy(QuotaState.build(**quota, device="cpu")), **kw).min),
        ("convert.gang_state",
         lambda **kw: convert.gang_state(
             as_numpy(GangState.build(**gang, device="cpu")),
             **kw).min_member),
        ("QuotaState.build", lambda **kw: QuotaState.build(**quota, **kw).min),
        ("GangState.build",
         lambda **kw: GangState.build(**gang, **kw).min_member),
        ("testing.example_problem",
         lambda **kw: testing.example_problem(6, 5, **kw)[0].alloc),
        ("testing.quota_gang_problem",
         lambda **kw: testing.quota_gang_problem(6, 5, 2, 2, 3, **kw)[3].min),
        ("testing.full_features_problem",
         lambda **kw: testing.full_features_problem(6, 64, **kw)[5].free),
        ("convert.resv_arrays",
         lambda **kw: convert.resv_arrays(
             testing.resv_table_arrays(6, 5, 2), **kw).free),
        ("convert.numa_aux",
         lambda **kw: convert.numa_aux(
             dict(node_policy=np.ones(6, bool)), **kw).node_policy),
        ("convert.sweep_batch",
         lambda **kw: convert.sweep_batch(sweep, **kw).usage0),
        ("ops.rebalance.DeviceSweep (run_balance_sweep, the LowNodeLoad "
         "device backend)",
         lambda **kw: DeviceSweep(rebalance.SweepBatch(**sweep),
                                  sweep_avail, sweep_mask, **kw).available),
    ]


def test_default_device_is_cuda():
    """With no device, every entry point builds on ``cuda``, and raises
    where there is none; ``device="cpu"`` is the only way onto the CPU."""
    for name, build in _entry_points():
        if torch.cuda.is_available():
            assert build().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
        assert build(device="cpu").device.type == "cpu", name


def _cuda_problem(n_nodes=300, n_pods=700, seed=3):
    from koordinator_tpu_torch import testing

    return testing.quota_gang_problem(n_nodes, n_pods, 9, 20, 8, seed=seed,
                                      device="cuda")


@pytest.mark.cuda
def test_cuda_tensor_without_library_raises(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")

    def no_build():
        raise RuntimeError("library unavailable")

    monkeypatch.setattr(binpack_kernel, "_LIB", None)
    monkeypatch.setattr(binpack_kernel, "build_library", no_build)
    state, pods, params, _, _ = _cuda_problem()
    inp = binpack_kernel.kernel_inputs(state, pods, params)
    with pytest.raises(RuntimeError, match="library unavailable"):
        binpack_kernel.binpack(inp)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    state, pods, params, quota, gang = _cuda_problem()
    from koordinator_tpu_torch.ops.quota import quota_runtime

    inp = binpack_kernel.kernel_inputs(
        state, pods, params,
        (quota.min, quota_runtime(quota), quota.used, quota.np_used))
    before = binpack_kernel.LAUNCHES["block"]
    got = binpack_kernel.binpack(inp)
    torch.cuda.synchronize()
    assert binpack_kernel.LAUNCHES["block"] == before + 1
    want = binpack_kernel.binpack_plain(inp)
    for g, w, name in zip(got, want, got._fields):
        if w is None:   # outputs of variants this solve does not use
            assert g is None, name
        else:
            assert torch.equal(g, w), name
    solved = binpack_kernel.kernel_solve_batch(state, pods, params, quota,
                                               gang)
    assert int((solved.assign >= 0).sum()) > 0


def _edge_inputs(n_nodes, n_pods, n_quota, seed, dev="cuda"):
    """Kernel inputs with every branch the kernel takes: stale metrics,
    unschedulable nodes, zero allocatable, DaemonSet, blocked and
    never-fitting pods, non-unit resource weights, quota groups."""
    from koordinator_tpu_torch.ops.binpack import NodeState, PodBatch, ScoreParams

    rng = np.random.default_rng(seed)
    alloc = np.zeros((n_nodes, 8), np.int32)
    alloc[:, 0] = rng.choice([0, 4000, 16000, 64000], n_nodes)
    alloc[:, 1] = rng.choice([8192, 32768], n_nodes)
    alloc[:, 6] = rng.choice([0, 400], n_nodes)
    usage = (alloc * rng.uniform(0, 0.9, alloc.shape)).astype(np.int32)
    req = np.zeros((n_pods, 8), np.int32)
    req[:, 0] = rng.choice([0, 500, 1000, 4000, 100000], n_pods)
    req[:, 1] = rng.choice([0, 1024, 4096], n_pods)
    req[:, 6] = rng.choice([0, 0, 100], n_pods)

    def t(a):
        return torch.as_tensor(a, device=dev)

    state = NodeState(
        alloc=t(alloc),
        used_req=t((alloc * rng.uniform(0, 0.3, alloc.shape)).astype(np.int32)),
        usage=t(usage), prod_usage=t(usage // 2), est_extra=t(usage // 4),
        prod_base=t(usage // 3),
        metric_fresh=t(rng.uniform(size=n_nodes) > 0.2),
        schedulable=t(rng.uniform(size=n_nodes) > 0.1),
    )
    pods = PodBatch.build(
        req=t(req), est=t((req * 85) // 100),
        is_prod=t(rng.uniform(size=n_pods) < 0.5),
        is_daemonset=t(rng.uniform(size=n_pods) < 0.2),
        quota_id=t(rng.integers(-1, max(n_quota, 1), n_pods).astype(np.int32)),
        non_preemptible=t(rng.uniform(size=n_pods) < 0.3),
        blocked=t(rng.uniform(size=n_pods) < 0.1),
    )
    thresholds = np.zeros(8, np.int32)
    thresholds[0], thresholds[1] = 65, 95
    params = ScoreParams(weights=t(rng.integers(0, 4, 8).astype(np.int32)),
                         thresholds=t(thresholds),
                         prod_thresholds=t(np.zeros(8, np.int32)))
    quota = None
    if n_quota:
        total = alloc.astype(np.int64).sum(axis=0)
        runtime = np.tile(total // (2 * n_quota), (n_quota, 1)).astype(np.int32)
        quota = (t(runtime // 3), t(runtime),
                 t(np.zeros((n_quota, 8), np.int32)),
                 t(np.zeros((n_quota, 8), np.int32)))
    return binpack_kernel.kernel_inputs(state, pods, params, quota)


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,n_pods,n_quota", [
    (1, 5, 0), (31, 200, 0), (1025, 300, 3), (3000, 700, 12), (65536, 20, 4),
])
def test_cuda_kernel_edge_shapes_match_plain_twin(n_nodes, n_pods, n_quota):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    inp = _edge_inputs(n_nodes, n_pods, n_quota, seed=n_nodes + n_pods)
    got = binpack_kernel.binpack(inp)
    torch.cuda.synchronize()
    want = binpack_kernel.binpack_plain(inp)
    for g, w, name in zip(got, want, got._fields):
        if w is None:
            assert g is None, name
        else:
            assert torch.equal(g, w), name


def _resv_numa_inputs(n_nodes, n_pods, n_quota, layout, numa, seed,
                      dev="cuda"):
    """:func:`_edge_inputs` plus NUMA inventories (``numa``: None, "least"
    or "most") and a reservation table laid out as ``layout``: "one"
    reservation, "same-node" (40 on one node), "ends" (on the first and
    the last node) or "many" (600 on random nodes)."""
    inp = _edge_inputs(n_nodes, n_pods, n_quota, seed, dev)
    rng = np.random.default_rng(seed + 1)
    if layout == "one":
        node = rng.integers(0, n_nodes, 1)
    elif layout == "same-node":
        node = np.full(40, n_nodes // 2)
    elif layout == "ends":
        node = np.array([n_nodes - 1, 0, n_nodes - 1, 0, n_nodes - 1])
    else:
        node = rng.integers(0, n_nodes, 600)
    v = node.shape[0]
    free = np.zeros((v, 8), np.int32)
    free[:, 0] = rng.integers(0, 4000, v)
    free[:, 1] = rng.integers(0, 8192, v)
    free[:, 6] = rng.choice([0, 100], v)

    def t(a):
        return torch.as_tensor(a, device=dev)

    node_t = t(node.astype(np.int32))
    assert binpack_kernel.kernel_resv_score_safe(node_t, free, inp.alloc)
    offsets, ids = binpack_kernel.resv_csr(node_t, n_nodes)
    blocked = inp.req[:, 0] == binpack_kernel.BLOCKED_REQ
    match = t(rng.uniform(size=(n_pods, v)) < 0.3) & ~blocked[:, None]
    resv = (t(free), t((rng.uniform(size=v) < 0.5).astype(np.int32)),
            offsets, ids, match.to(torch.uint8).contiguous())
    numa_in = None
    if numa is not None:
        cap = inp.alloc.cpu().numpy()
        numa_in = (inp.alloc,
                   t((cap * rng.uniform(0, 1, cap.shape)).astype(np.int32)),
                   t((rng.uniform(size=n_nodes) < 0.5).astype(np.int32)),
                   t((rng.uniform(size=n_pods) < 0.4).astype(np.int32)))
    return inp._replace(numa=numa_in, resv=resv,
                        most_allocated=numa == "most")


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,n_pods,n_quota,layout,numa", [
    (1, 5, 0, "one", None),
    (31, 200, 0, "same-node", "least"),
    (1025, 300, 3, "ends", "most"),
    (3000, 700, 12, "many", "least"),
    (65536, 20, 4, "ends", "most"),
    (65536, 20, 0, "one", None),
])
def test_cuda_resv_numa_edge_shapes_match_plain_twin(n_nodes, n_pods, n_quota,
                                                     layout, numa):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    inp = _resv_numa_inputs(n_nodes, n_pods, n_quota, layout, numa,
                            seed=n_nodes + n_pods)
    route = binpack_kernel.route_of(inp)
    before = binpack_kernel.LAUNCHES[route.kind]
    got = binpack_kernel.binpack(inp)
    torch.cuda.synchronize()
    assert binpack_kernel.LAUNCHES[route.kind] == before + 1   # routed
    want = binpack_kernel.binpack_plain(inp)
    for g, w, name in zip(got, want, got._fields):
        if w is None:
            assert g is None, name
        else:
            assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("seed,selectors,reservations", [
    (0, False, False), (2, True, False), (1, False, True)])
def test_cuda_model_matches_cpu_model(seed, selectors, reservations):
    """The kernel on the card, with the host extras rows of node-selector
    and host-port pods in compact form, equals the CPU run, reservation
    bookkeeping included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from koordinator_tpu_torch import testing
    from koordinator_tpu_torch.apis import types
    from koordinator_tpu_torch.apis.extension import ResourceName
    from koordinator_tpu_torch.models.placement import PlacementModel

    spec = testing.mixed_snapshot_spec(seed, selectors=selectors,
                                       reservations=reservations)
    gpu, cpu = PlacementModel(), PlacementModel(device="cpu")
    gsnap = testing.build_snapshot(spec, types, ResourceName)
    csnap = testing.build_snapshot(spec, types, ResourceName)
    got, want = gpu.schedule(gsnap), cpu.schedule(csnap)
    assert gpu.last_solver == cpu.last_solver == "kernel"
    assert dict(got) == dict(want) and got.waiting == want.waiting
    assert got.resv_committed.keys() == want.resv_committed.keys()
    assert ([(r.allocated, r.allocated_pod_uids, r.state)
             for r in gsnap.reservations]
            == [(r.allocated, r.allocated_pod_uids, r.state)
                for r in csnap.reservations])


def _with_extras(inp, seed):
    """``inp`` with compact host extras rows: shared selector rows,
    scored fine-grained rows and a deferred all-False row."""
    from koordinator_tpu_torch import testing

    n, p = inp.alloc.shape[0], inp.req.shape[0]
    row, mask, score = testing.extras_arrays(
        n, p, selector_frac=0.3, scored_frac=0.2, deferred_frac=0.05,
        seed=seed)
    dev = inp.alloc.device
    return inp._replace(extras=(
        torch.as_tensor(row, device=dev),
        torch.as_tensor(mask.astype(np.uint8), device=dev),
        torch.as_tensor(score, device=dev)))


@pytest.mark.cuda
@pytest.mark.parametrize("shards,n_nodes,n_pods,n_quota,layout,numa", [
    (None, 1, 5, 0, None, None),
    (None, 31, 200, 0, "same-node", "least"),
    (None, 1000, 400, 3, None, "most"),
    (None, 3000, 700, 12, "many", "least"),
    (2, 1025, 300, 3, "ends", "most"),
    (5, 5000, 300, 12, None, None),
    (16, 65536, 20, 4, "ends", "most"),
])
def test_cuda_extras_match_twin(shards, n_nodes, n_pods, n_quota, layout,
                                numa):
    """Extras rows on every route: the routed kernel (``shards`` None:
    one block or a cluster) and the cluster kernel at an explicit CTA
    count (the L2 form at 65,536 nodes), each equal to its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    inp = _with_extras(_cluster_inputs(n_nodes, n_pods, n_quota, layout,
                                       numa, seed=n_nodes + 7), n_nodes)
    if shards is not None:
        _cluster_matches_twin(inp, shards)
        return
    route = binpack_kernel.route_of(inp)
    got = binpack_kernel.binpack(inp)
    torch.cuda.synchronize()
    want = (binpack_kernel.binpack_plain(inp) if route.kind == "block"
            else binpack_kernel.binpack_sharded_plain(inp, route.shards))
    for g, w, name in zip(got, want, got._fields):
        if w is None:
            assert g is None, name
        else:
            assert torch.equal(g, w), name


@pytest.mark.cuda
def test_cuda_fine_grained_scheduler_matches_cpu():
    """The fine-grained burst at a small size through two Schedulers, on
    the card and on the CPU: placements, annotations, NUMA and device
    holds equal, every solve on the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import copy

    from koordinator_tpu_torch import testing
    from koordinator_tpu_torch.models.placement import PlacementModel
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler

    snap, _ = testing.churn_world(80, seed=3)
    testing.add_pending_wave(snap, 200, n_quota=4, n_gangs=6, gang_size=6)
    topo, dev = testing.add_fine_grained(
        snap, n_cpuset=10, n_gpu=10, n_ports=6, n_selector=40,
        n_distinct_ports=4)
    outs = []
    for device in ("cuda", "cpu"):
        sched = Scheduler(model=PlacementModel(device=device),
                          enable_preemption=False)
        testing.feed_scheduler(sched, copy.deepcopy(snap))
        testing.feed_fine_grained(sched, topo, dev)
        solvers = []
        dispatch = sched.model._dispatch_solve

        def record(*a, _d=dispatch, _s=sched, _l=solvers, **k):
            out = _d(*a, **k)
            _l.append(_s.model.last_solver)
            return out

        sched.model._dispatch_solve = record
        rounds = [sched.schedule_pending(now=20.0 + r) for r in range(2)]
        assert set(solvers) == {"kernel"}, solvers
        outs.append((
            [(dict(r), r.waiting) for r in rounds],
            {u: (p.node_name, dict(p.annotations))
             for u, p in {**sched.cache.pods, **sched.cache.pending}.items()},
            {n: {u: [int(c) for c in a.cpuset] for u, a in na.pods.items()}
             for n, na in sched.numa_manager.node_allocations.items()},
            {n: sorted(nd.allocations) for n, nd in
             sched.device_cache.nodes.items()}))
    assert outs[0] == outs[1]
    assert any(outs[0][2].values()) and any(outs[0][3].values())


class _FakeClusterLibrary:
    """The library's cluster entry points, answering as told: the launch's
    return code, the occupancy query's return code and cluster count."""

    def __init__(self, launch_rc=0, query_rc=0, clusters=1):
        self.launch_rc, self.query_rc, self.clusters = (launch_rc, query_rc,
                                                        clusters)
        self.launches = 0

    def binpack_cluster_launch(self, *args):
        self.launches += 1
        return self.launch_rc

    def binpack_cluster_occupancy(self, shards, resident, resv, numa, most,
                                  smem, clusters):
        clusters._obj.value = self.clusters
        return self.query_rc

    def binpack_error_string(self, rc):
        return f"refused by the fake library {rc}".encode()


def test_cluster_failures_raise_and_never_run_the_twin(monkeypatch):
    """On the CPU, with the library's cluster entry points replaced: a
    refused cluster launch raises with CUDA's message and counts no
    launch; a failed occupancy query raises; a zero occupancy answer
    makes ``cluster_kernel_supported`` False and the solver raise before
    any launch; the plain twins never run on that route."""
    from koordinator_tpu_torch import testing
    from koordinator_tpu_torch.parallel import mesh

    def twin(*args, **kwargs):
        raise AssertionError("the plain twin ran")

    monkeypatch.setattr(binpack_kernel, "binpack_sharded_plain", twin)
    monkeypatch.setattr(binpack_kernel, "binpack_plain", twin)
    monkeypatch.setattr(binpack_kernel, "_on_device",
                        lambda dev, call: call(0))
    state, pods, params, quota, gang = testing.quota_gang_problem(
        40, 30, 3, 2, 4, seed=1, device="cpu")
    inp = binpack_kernel.kernel_inputs(state, pods, params,
                                       binpack_kernel.quota_inputs(quota))

    lib = _FakeClusterLibrary(launch_rc=719)
    monkeypatch.setattr(binpack_kernel, "_library", lambda: lib)
    before = dict(binpack_kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="refused by the fake library 719"):
        binpack_kernel._launch(inp, binpack_kernel.route_of(inp, 4))
    assert lib.launches == 1 and binpack_kernel.LAUNCHES == before

    lib = _FakeClusterLibrary(query_rc=1)
    monkeypatch.setattr(binpack_kernel, "_library", lambda: lib)
    with pytest.raises(RuntimeError, match="occupancy query failed"):
        mesh.cluster_kernel_supported(16, "cuda")

    lib = _FakeClusterLibrary(clusters=0)
    monkeypatch.setattr(binpack_kernel, "_library", lambda: lib)
    assert not mesh.cluster_kernel_supported(16, "cuda")
    solve = mesh.shard_kernel_solver(16, device="cuda")
    with pytest.raises(RuntimeError, match="cannot be resident"):
        solve(state, pods, params, quota, gang)
    assert lib.launches == 0

    # a resident cluster, but inputs the solver's device does not hold
    lib = _FakeClusterLibrary(clusters=3)
    monkeypatch.setattr(binpack_kernel, "_library", lambda: lib)
    assert mesh.cluster_kernel_supported(16, "cuda")
    with pytest.raises(ValueError, match="inputs on cpu"):
        mesh.shard_kernel_solver(8, device="cuda")(state, pods, params)
    assert lib.launches == 0


def _cluster_inputs(n_nodes, n_pods, n_quota, layout, numa, seed):
    """:func:`_resv_numa_inputs` on the card; ``layout`` None drops the
    reservation table."""
    inp = _resv_numa_inputs(n_nodes, n_pods, n_quota, layout or "one", numa,
                            seed)
    return inp if layout else inp._replace(resv=None)


def _cluster_matches_twin(inp, shards):
    route = binpack_kernel.route_of(inp, shards)   # shared memory or L2
    before = binpack_kernel.LAUNCHES[route.kind]
    got = binpack_kernel.binpack_sharded(inp, shards)
    torch.cuda.synchronize()
    assert binpack_kernel.LAUNCHES[route.kind] == before + 1
    want = binpack_kernel.binpack_sharded_plain(inp, shards)
    for g, w, name in zip(got, want, got._fields):
        if w is None:
            assert g is None, name
        else:
            assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("shards,n_nodes,n_pods,n_quota,layout,numa", [
    (2, 1, 5, 0, "one", None),
    (8, 1, 40, 2, None, None),
    (16, 1, 30, 0, None, "least"),
    (2, 1025, 300, 3, "ends", "most"),
    (8, 31, 200, 0, "same-node", "least"),
    (8, 3000, 700, 12, "many", "least"),
    (16, 3000, 400, 5, "many", "most"),
    (16, 65536, 20, 4, "ends", "most"),
    (16, 65536, 20, 0, None, None),
])
def test_cuda_cluster_kernel_edge_shapes_match_sharded_twin(
        shards, n_nodes, n_pods, n_quota, layout, numa):
    """1 node, 65,536 nodes over 16 CTAs, 600 reservations ("many"),
    reservations on the first and last node ("ends"), both NUMA scorers,
    at 2, 8 and 16 CTAs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _cluster_matches_twin(_cluster_inputs(n_nodes, n_pods, n_quota, layout,
                                          numa, seed=n_nodes + n_pods),
                          shards)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 8, 16])
def test_cuda_cluster_kernel_one_node_per_shard(shards):
    """One schedulable node at the first row of each CTA's range, the rest
    unschedulable: every placement crosses the cluster merge."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    inp = _cluster_inputs(128 * shards, 300, 3, "ends", "most", seed=shards)
    sched = torch.zeros_like(inp.sched)
    sched[::128] = 1
    alloc = inp.alloc.clone()
    alloc[::128, 0], alloc[::128, 1] = 64000, 32768
    _cluster_matches_twin(inp._replace(sched=sched, alloc=alloc), shards)


def _same(got, want):
    for g, w, name in zip(got, want, got._fields):
        if w is None:
            assert g is None, name
        else:
            assert torch.equal(g, w), name


def _routed_matches_twins(inp, shards=None):
    """The kernel the route names (or the cluster kernel at ``shards``)
    launches once and equals both the one-block twin and the twin of the
    chosen kernel on every output. Returns the route."""
    route = binpack_kernel.route_of(inp, shards)
    before = dict(binpack_kernel.LAUNCHES)
    got = (binpack_kernel.binpack(inp) if shards is None
           else binpack_kernel.binpack_sharded(inp, shards))
    torch.cuda.synchronize()
    before[route.kind] += 1
    assert binpack_kernel.LAUNCHES == before
    _same(got, binpack_kernel.binpack_plain(inp))
    if route.kind != "block":
        _same(got, binpack_kernel.binpack_sharded_plain(inp, route.shards))
    return route


def _one_block_rows(numa, n_resv, n_quota):
    """The most nodes the route gives the one-block kernel."""
    n = 1
    while (binpack_kernel.kernel_route(n + 1, numa, n_resv, n_quota).kind
           == "block"):
        n += 1
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("numa,layout,n_quota", [
    (None, None, 0), (None, "many", 5), ("least", None, 4),
    ("most", "many", 3)])
def test_cuda_one_block_capacity_edge(numa, layout, n_quota):
    """N at the one-block kernel's last row and one row over (the
    cluster kernel), every output equal to the twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n_resv = 600 if layout else 0
    edge = _one_block_rows(numa is not None, n_resv, n_quota)
    for n, kind in ((edge, "block"), (edge + 1, "cluster")):
        inp = _cluster_inputs(n, 150, n_quota, layout, numa, seed=n)
        assert _routed_matches_twins(inp).kind == kind


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 5, 16])
def test_cuda_cluster_capacity_edge(shards):
    """The largest node count whose slices fit at ``shards`` CTAs (in
    shared memory) and the next 128 rows over (the L2 form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bk = binpack_kernel
    n = 128 * shards
    while bk.kernel_route(n + 128 * shards, False, 0, 3,
                          shards=shards).kind == "cluster":
        n += 128 * shards
    for nodes, kind in ((n, "cluster"), (n + 1, "l2")):
        inp = _cluster_inputs(nodes, 60, 3, None, None, seed=nodes)
        assert _routed_matches_twins(inp, shards).kind == kind


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4, 16])
def test_cuda_tie_across_cta_edge(shards):
    """Two identical empty nodes, the last row of CTA 0 and the first of
    CTA 1, everything else unschedulable: every pod's best score ties
    across the CTA edge and must go to the smaller index."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    inp = _cluster_inputs(128 * shards, 200, 2, None, None, seed=shards)
    edge = binpack_kernel.kernel_route(128 * shards, shards=shards).n_loc
    sched = torch.zeros_like(inp.sched)
    sched[edge - 1:edge + 1] = 1
    used0 = inp.used0.clone()
    used0[edge - 1:edge + 1] = 0
    usage = inp.usage.clone()
    usage[edge - 1:edge + 1] = 0
    alloc = inp.alloc.clone()
    alloc[edge - 1:edge + 1] = torch.tensor(
        [64000, 32768, 0, 0, 0, 0, 400, 0], dtype=alloc.dtype,
        device=alloc.device)
    inp = inp._replace(sched=sched, used0=used0, usage=usage, alloc=alloc,
                       est0=torch.zeros_like(inp.est0))
    _routed_matches_twins(inp, shards)


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,shards", [(1, 16), (130, 16), (300, 8)])
def test_cuda_padding_only_ctas(n_nodes, shards):
    """CTAs whose slice holds no node at all (n_loc is 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    inp = _cluster_inputs(n_nodes, 120, 3, "ends", "least", seed=n_nodes)
    _routed_matches_twins(inp, shards)


@pytest.mark.cuda
@pytest.mark.parametrize("shards,numa", [(2, None), (4, "most"), (8, "least")])
def test_cuda_reservations_on_cta_edges(shards, numa):
    """Reservations on the first and last row of every CTA's slice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = 128 * shards
    inp = _cluster_inputs(n, 300, 4, "one", numa, seed=n)
    rng = np.random.default_rng(n)
    nodes = np.array([j for s in range(shards)
                      for j in (128 * s, 128 * s + 127)] * 3, np.int32)
    v = nodes.shape[0]
    free = np.zeros((v, 8), np.int32)
    free[:, 0] = rng.integers(0, 4000, v)
    free[:, 1] = rng.integers(0, 8192, v)
    dev = inp.alloc.device
    node_t = torch.as_tensor(nodes, device=dev)
    offsets, ids = binpack_kernel.resv_csr(node_t, n)
    blocked = inp.req[:, 0] == binpack_kernel.BLOCKED_REQ
    match = (torch.as_tensor(rng.uniform(size=(300, v)) < 0.4, device=dev)
             & ~blocked[:, None])
    resv = (torch.as_tensor(free, device=dev),
            torch.as_tensor((rng.uniform(size=v) < 0.5).astype(np.int32),
                            device=dev),
            offsets, ids, match.to(torch.uint8).contiguous())
    out = binpack_kernel.binpack_plain(inp._replace(resv=resv))
    assert int((out.vstar >= 0).sum()) > 0
    _routed_matches_twins(inp._replace(resv=resv), shards)


@pytest.mark.cuda
@pytest.mark.parametrize("weights,n_nodes", [
    ((-3, 1, 0, 0, 0, 0, 2, 0), 700),    # negative sums, positive wsum
    ((-3, 1, 0, 0, 0, 0, 0, 0), 700),    # wsum < 0: no division constant
    ((-3, 1, 0, 0, 0, 0, 2, 0), 3000),
])
def test_cuda_negative_score_dividends(weights, n_nodes):
    """Negative resource weights make the score sums negative, so the
    floor of a negative dividend runs (through ~x, or through the plain
    division when the weight sum is not positive); with NUMA most and a
    free carry above capacity the NUMA numerator goes negative too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    inp = _cluster_inputs(n_nodes, 300, 3, "many", "most", seed=n_nodes)
    w = torch.tensor(weights, dtype=inp.weight.dtype, device=inp.weight.device)
    ncap, nfree, npol, ppol = inp.numa
    nfree = nfree.clone()
    nfree[::7] = ncap[::7] + 5000
    inp = inp._replace(weight=w, wsum=int(w.sum()) or 1,
                       numa=(ncap, nfree, npol, ppol))
    _routed_matches_twins(inp)


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,n_quota,layout,numa,shards,kind", [
    (1000, 2000, None, None, None, "block"),
    (3000, 2000, "many", "least", None, "cluster"),
    (3000, 2000, None, "most", 2, "l2"),
    (20000, 1000, None, None, None, "cluster"),
])
def test_cuda_quota_tables_in_device_memory(n_nodes, n_quota, layout, numa,
                                            shards, kind):
    """Quota tables too large for shared memory beside the slices (1,000
    and 2,000 groups): each CTA keeps its carries in device memory, on
    every kernel and form, equal to the twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    inp = _cluster_inputs(n_nodes, 200, n_quota, layout, numa, seed=n_quota)
    route = _routed_matches_twins(inp, shards)
    assert route.kind == kind and not route.quota_shared, route


def _staged_equals_fresh(model, snap, state):
    from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
    from koordinator_tpu_torch.state.cluster import lower_nodes

    want = model.stage_nodes(lower_nodes(snap, **model.lowering_kwargs()))
    for f in STAGED_NODE_FIELDS:
        assert getattr(state, f).device.type == "cuda", f
        assert torch.equal(getattr(state, f), getattr(want, f)), f


@pytest.mark.cuda
def test_cuda_staged_state_after_delta_ticks_equals_fresh_staging():
    """Churn ticks through the staging cache on the card: after every
    tick the staged tensors equal a fresh staging of that tick's
    snapshot, every tick after the first takes the delta path, and the
    placements equal the CPU model's on the same ticks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from koordinator_tpu_torch import testing
    from koordinator_tpu_torch.models.placement import PlacementModel

    runs = []
    for device in ("cuda", "cpu"):
        snap, tracker = testing.churn_world(1500, with_tracker=True)
        model = PlacementModel(device=device)
        rng = np.random.default_rng(7)
        log = []
        for t in range(6):
            now = 20.0 + t
            by_uid = testing.churn_tick_events(
                snap, tracker, rng, dirty=30, pending=48, t=t, now=now)
            result = model.schedule(snap)
            assert model.last_staging == ("full" if t == 0 else "delta")
            if device == "cuda":
                _staged_equals_fresh(model, snap, model.staged_cache.state)
            log.append(sorted(result.items()))
            testing.fold_churn_binds(snap, tracker, result, by_uid, now)
        runs.append(log)
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_cuda_kernel_solve_leaves_staged_inputs_unchanged():
    """A kernel-routed solve (quota, gangs, rejected releases) reads its
    staged inputs and writes none of them: after read-back the pinned
    generation still equals a fresh staging of the snapshot."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from koordinator_tpu_torch import testing
    from koordinator_tpu_torch.models.placement import PlacementModel
    from koordinator_tpu_torch.state.cluster import ClusterDeltaTracker

    for n_nodes in (800, 3000):   # one block, then the cluster kernel
        snap, _ = testing.churn_world(n_nodes, seed=5)
        snap = testing.add_pending_wave(snap, 2000, n_quota=8, n_gangs=30,
                                        gang_size=8)
        snap.delta_tracker = ClusterDeltaTracker()
        model = PlacementModel()
        inflight = model.schedule_async(snap)
        staged = inflight.pinned
        assert staged is model.staged_cache.state
        result = inflight.finalize()
        assert model.last_solver == "kernel"
        assert any(n is not None for n in result.values())
        _staged_equals_fresh(model, snap, staged)
