"""The host route for tiny solves (``PlacementModel(host_fallback_cells=)``,
``measure_host_fallback_cells`` and ``build_scheduler``'s cutoff rule)
against the JAX package's, on the CPU.

The reference's ``test_host_fallback_identical_and_routed``; the route of
every round of one seeded stream (``last_solver``) and its placements
equal to the reference's at fixed cutoffs (the reference's model with
``pod_bucketing=False``: its default pads the pod axis to a bucket of at
least 64, and its gate counts the padded pods, where the port, which
pads nothing, counts the real ones); a host-routed round equal to the
same round routed to the kernel twin, before and after a
``desync-staged-row``, its ``SolveResult`` CPU tensors equal to the
kernel's carries, and nothing of a host-routed round staged on the
device (the next kernel round stages again); ``build_scheduler``'s -1/0/positive rule, the sidecar
backend and ``BatchedPlacement`` off, held against the reference's where
no probe runs; the port's probe on ``cpu``. No test here compares routes
at a measured cutoff (it depends on the clock), and the reference's probe
(a JAX compile) runs in none."""

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.cmd import scheduler as cmd
from koordinator_tpu_torch.models import placement
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.testing.chaos import FaultSchedule, StateSaboteur
from test_torch_colocation import CPU, MEM, PORT, REF


def model(P, cutoff):
    if P.port:
        return P._model(device="cpu", host_fallback_cells=cutoff)
    return P._model(use_pallas=False, pod_bucketing=False,
                    host_fallback_cells=cutoff)


def reference_snapshot(P):
    """The snapshot of the reference's
    ``test_host_fallback_identical_and_routed``."""
    return P.T.ClusterSnapshot(
        nodes=[P.node(f"n{i}", cpu=16000, mem=32768) for i in range(20)],
        pending_pods=[P.pod(f"p{i}", {CPU: 500 + 100 * (i % 7)},
                            is_daemonset=(i % 11 == 0))
                      for i in range(100)],
        node_metrics={f"n{i}": P.metric(f"n{i}", usage={CPU: 900 * (i % 3)},
                                        update_time=99.0)
                      for i in range(20)},
        now=100.0)


def test_host_fallback_identical_and_routed():
    """Tiny plain solves take the host route when the cutoff allows: the
    same placements as the kernel (and as the reference's host and scan
    routes); a quota'd solve never takes it."""
    got = {}
    for P in (PORT, REF):
        host, device = model(P, 16384), model(P, 0)
        got[P.root, "host"] = dict(host.schedule(reference_snapshot(P)))
        got[P.root, "device"] = dict(device.schedule(reference_snapshot(P)))
        assert host.last_solver == "host"
        assert device.last_solver == ("kernel" if P.port else "scan")
        s = reference_snapshot(P)
        s.quotas = {"t": P.T.QuotaSpec(name="t", min=P.res({CPU: 1000}),
                                       max=P.res({CPU: 90000}))}
        for pod in s.pending_pods:
            pod.quota = "t"
        host.schedule(s)
        assert host.last_solver != "host"
    first = next(iter(got.values()))
    assert all(v == first for v in got.values())
    assert sum(n is not None for n in first.values()) == 100


#: pods arriving per round of the stream (20 nodes: 20 cells a pod)
ARRIVALS = (1, 2, 5, 3, 20, 8, 1, 40, 2)


def stream(P, cutoff, saboteur_at=None):
    """One seeded stream through a Scheduler at a fixed cutoff: per round,
    ``(host-routed, placements, waiting)``. A pod of an unobserved gang
    (blocked) arrives in round 3; with ``saboteur_at`` a seeded
    ``desync-staged-row`` hits the staging cache before that round."""
    rng = np.random.default_rng(5)
    sched = P._sched(model=model(P, cutoff))
    for i in range(20):
        sched.add_node(P.node(f"n{i}", cpu=int(rng.choice([8000, 16000])),
                              mem=32768))
        sched.update_node_metric(P.metric(
            f"n{i}", usage={CPU: int(rng.integers(0, 6000))},
            update_time=99.0))
    out = []
    for r, k in enumerate(ARRIVALS):
        for j in range(k):
            extra = {"gang": "never-seen"} if (r, j) == (3, 0) else {}
            sched.add_pod(P.pod(f"r{r}p{j}", {
                CPU: int(rng.integers(200, 3000)),
                MEM: int(rng.integers(128, 4096))},
                is_daemonset=bool(rng.uniform() < 0.1), **extra))
        if r == saboteur_at and P.port:
            sab = StateSaboteur(FaultSchedule({r: "desync-staged-row"}),
                                sched, seed=3)
            assert sab.inject(r) == "desync-staged-row"
        result = sched.schedule_pending(now=100.0 + r)
        out.append((sched.model.last_solver == "host", dict(result),
                    dict(result.waiting)))
    return out


@pytest.mark.parametrize("cutoff", [0, 60, 400, 1 << 18])
def test_route_sequence_equals_reference_at_fixed_cutoffs(cutoff):
    """At a fixed cutoff every round takes the same route in both
    packages (host when its nodes x pending pods are at most the cutoff)
    and places the same pods."""
    got, want = stream(PORT, cutoff), stream(REF, cutoff)
    assert got == want
    routes = [host for host, _, _ in got]
    assert any(routes) == (cutoff > 0)
    if cutoff == 60:
        assert routes[:4] == [True, True, False, True] and not all(routes)


def test_host_round_equals_kernel_round_before_and_after_desync():
    """The host route reads what the kernel reads: the same stream all on
    the host and all on the kernel twin gives the same rounds, with no
    fault and with a staged row desynced (the host arrays, and the staged
    tensor where there is one, no tracker mark) before round 4."""
    for at in (None, 4):
        host = stream(PORT, 1 << 18, saboteur_at=at)
        kernel = stream(PORT, 0, saboteur_at=at)
        assert all(h for h, _, _ in host) and not any(h for h, _, _ in kernel)
        assert [r[1:] for r in host] == [r[1:] for r in kernel]


def tracked_round(cutoff):
    """A Scheduler's staged round (a tracker snapshot), dispatched but not
    read back: ``(model, in-flight schedule)``."""
    sched = PORT.scheduler()
    sched.model.host_fallback_cells = cutoff
    for i in range(6):
        sched.add_node(PORT.node(f"n{i}"))
        sched.update_node_metric(PORT.metric(f"n{i}", usage={CPU: 300 * i}))
    for j in range(4):
        sched.add_pod(PORT.pod(f"p{j}", {CPU: 1500 + 500 * j, MEM: 1024},
                               priority=9000 if j % 2 else 0))
    snapshot = sched.cache.snapshot(now=100.0)
    return sched.model, sched.model.schedule_async(snapshot)


def test_host_result_is_cpu_tensors_equal_to_the_kernel_and_unpins():
    """A host-routed solve returns CPU tensors whose assignments and
    carries equal the kernel twin's. It pins and stages nothing; a kernel
    round's ``finalize`` releases the staged generation it pinned."""
    results = {}
    for cutoff in (0, 1 << 18):
        m, flight = tracked_round(cutoff)
        assert m.last_solver == ("host" if cutoff else "kernel")
        cache = m.staged_cache
        if cutoff:
            assert flight.pinned is None and cache._pinned is None
            assert cache.state is None
        else:
            assert flight.pinned is not None
            assert cache._pinned is flight.pinned
            staged_prod_base = flight.pinned.prod_base.clone()
        flight.finalize()
        assert cache._pinned is None
        results[cutoff] = flight.result
    host, kernel = results[1 << 18], results[0]
    for name in ("assign", "commit", "waiting", "rejected", "raw_assign"):
        assert getattr(host, name).device.type == "cpu"
        assert torch.equal(getattr(host, name), getattr(kernel, name)), name
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(host.node_state, f),
                           getattr(kernel.node_state, f)), f
    # the prod pods' estimates moved the prod-mode carry
    assert bool(host.commit.all())
    assert not torch.equal(host.node_state.prod_base, staged_prod_base)


def test_host_round_stages_nothing(monkeypatch):
    """A host-routed round puts neither its node state nor its pod batch
    on the device, and neither does its prestage (the staging cache's
    device half is skipped); the next kernel round stages again from the
    host arrays. Placements equal a scheduler pinned to the kernel's."""
    calls = []
    for name in ("stage_nodes", "stage_pods"):
        orig = getattr(placement.PlacementModel, name)
        monkeypatch.setattr(
            placement.PlacementModel, name,
            lambda self, *a, _o=orig, _n=name, **k: (
                calls.append(_n), _o(self, *a, **k))[1])
    scheds = [PORT.scheduler(), PORT.scheduler()]
    scheds[0].model.host_fallback_cells = 8   # 4 nodes: 2 pods or fewer
    for sched in scheds:
        for i in range(4):
            sched.add_node(PORT.node(f"n{i}"))
            sched.update_node_metric(PORT.metric(f"n{i}",
                                                 usage={CPU: 700 * i}))
    routes = []
    for r, k in enumerate((1, 3, 2, 2, 4, 1)):
        for sched in scheds:
            for j in range(k):
                sched.add_pod(PORT.pod(f"r{r}p{j}", {CPU: 900 + 300 * j}))
        m = scheds[0].model
        del calls[:]
        m.prestage(scheds[0].cache.snapshot(now=100.0 + r))
        got = scheds[0].schedule_pending(now=100.0 + r)
        host = m.last_solver == "host"
        routes.append(host)
        if host:
            assert calls == [] and m.staged_cache.state is None, r
        else:
            assert m.last_solver == "kernel"
            assert "stage_nodes" in calls and "stage_pods" in calls, r
        assert dict(got) == dict(scheds[1].schedule_pending(now=100.0 + r))
        assert scheds[1].model.last_solver == "kernel"
    assert routes == [True, False, True, True, False, True]


def test_host_route_is_by_size_only():
    """A solve of at most the cutoff's cells takes the host route, one
    cell more does not; neither do a round with no pending pod nor a
    direct ``_dispatch_solve`` call."""
    from koordinator_tpu_torch import testing

    m, flight = tracked_round(24)  # 6 nodes x 4 pods = 24 cells
    flight.finalize()
    assert m.last_solver == "host"
    m, flight = tracked_round(23)
    flight.finalize()
    assert m.last_solver == "kernel"
    m.host_fallback_cells = 1 << 18
    m.schedule(PORT.T.ClusterSnapshot(nodes=[PORT.node("n0")], now=1.0))
    assert m.last_solver != "host"
    s, p, _ = testing.example_problem(4, 3, seed=1, device="cpu")
    m._dispatch_solve(s, p, None, None, None)
    assert m.last_solver == "kernel"


# -- build_scheduler's rule ----------------------------------------------------

@pytest.mark.parametrize("case", ["positive", "zero", "sidecar",
                                  "gate-off"])
def test_build_scheduler_cutoff_rule_matches_reference(case, monkeypatch,
                                                       tmp_path):
    """0 stays 0, a positive cutoff is passed through, and a sidecar
    backend or ``BatchedPlacement`` off turn the route off even at -1,
    without a probe: the port's model and the reference's take the same
    cutoff."""
    import importlib

    kw = {"positive": dict(host_fallback_cells=4096),
          "zero": dict(host_fallback_cells=0),
          "sidecar": dict(placement_backend="sidecar",
                          solver_address=str(tmp_path / "none.sock")),
          "gate-off": dict(feature_gates="BatchedPlacement=false")}[case]

    def no_probe(*a, **k):
        raise AssertionError("the probe ran")

    cells = []
    for P in (PORT, REF):
        mod = importlib.import_module(f"{P.root}.cmd.scheduler")
        monkeypatch.setattr(
            importlib.import_module(f"{P.root}.models.placement"),
            "measure_host_fallback_cells", no_probe)
        extra = {"device": "cpu"} if P.port else {}
        conf = dict(kw) if P.port else dict(kw, warm_pool=False)
        sched = mod.build_scheduler(mod.SchedulerConfig(**conf), **extra)
        cells.append(sched.model.host_fallback_cells)
    assert cells[0] == cells[1] == (4096 if case == "positive" else 0)


def test_build_scheduler_measures_at_minus_one_on_its_device():
    """At -1 (the default) the port's build_scheduler runs the probe on
    the scheduler's device and hands its cutoff to the model."""
    sched = cmd.build_scheduler(cmd.SchedulerConfig(), device="cpu")
    want = placement.measure_host_fallback_cells(device="cpu")
    assert sched.model.host_fallback_cells == want
    assert placement.host_probe("cpu")["cells"] == want


def test_probe_on_cpu_is_bounded_memoised_and_cuda_by_default():
    """The port's probe on ``cpu``: an int in [0, ceiling], measured once
    per device and arguments (a second call returns the memo; another
    ceiling is its own probe); with no device it runs on ``cuda``, and
    raises without one."""
    cells = placement.measure_host_fallback_cells(device="cpu")
    record = placement.host_probe("cpu")
    assert isinstance(cells, int) and 0 <= cells <= 1 << 18
    assert record["device"] == torch.device("cpu")
    assert record["host_ns_per_cell"] > 0 and record["device_best_ms"] > 0
    assert record["cells"] == cells
    assert placement.measure_host_fallback_cells(device="cpu") == cells
    assert placement.host_probe("cpu") is record
    low = placement.measure_host_fallback_cells(device="cpu", rounds=1,
                                                ceiling=1)
    assert low in (0, 1)
    assert placement.host_probe("cpu", rounds=1, ceiling=1)["cells"] == low
    assert placement.host_probe("cpu") is record
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            placement.measure_host_fallback_cells()
