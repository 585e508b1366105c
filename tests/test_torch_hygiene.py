"""Rules of the PyTorch/CUDA port: it imports neither ``jax`` nor the JAX
package, its entry points default to CUDA and never quietly run on the
CPU, and a CUDA tensor never takes the kernel's plain twin.

This file imports no JAX, so the ``cuda`` cases can run on a machine with
a GPU and no JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_hygiene.py``."""

import pkgutil
import re
import subprocess
import sys
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
    from koordinator_tpu_torch.models.placement import PlacementModel
    from koordinator_tpu_torch.ops.gang import GangState
    from koordinator_tpu_torch.ops.quota import QuotaState

    nodes, pods, params, quota, gang = testing.quota_gang_arrays(
        6, 5, 2, 2, 3, seed=0)

    def as_numpy(state):
        return {k: None if v is None else v.numpy()
                for k, v in state._asdict().items()}

    return [
        ("PlacementModel", lambda **kw: PlacementModel(**kw).params.weights),
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
    before = binpack_kernel.LAUNCHES
    got = binpack_kernel.binpack(inp)
    torch.cuda.synchronize()
    assert binpack_kernel.LAUNCHES == before + 1
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
    before = binpack_kernel.LAUNCHES
    got = binpack_kernel.binpack(inp)
    torch.cuda.synchronize()
    assert binpack_kernel.LAUNCHES == before + 1
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
    """Both routes on the card (the kernel, and the per-pod loop for
    node-selector and host-port pods) equal the CPU run, reservation
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
    assert gpu.last_solver == cpu.last_solver == (
        "loop" if selectors else "kernel")
    assert dict(got) == dict(want) and got.waiting == want.waiting
    assert got.resv_committed.keys() == want.resv_committed.keys()
    assert ([(r.allocated, r.allocated_pod_uids, r.state)
             for r in gsnap.reservations]
            == [(r.allocated, r.allocated_pod_uids, r.state)
                for r in csnap.reservations])


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

    def binpack_cluster_occupancy(self, shards, resv, numa, most, clusters):
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
    before = binpack_kernel.CLUSTER_LAUNCHES
    with pytest.raises(RuntimeError, match="refused by the fake library 719"):
        binpack_kernel._launch(inp, 4)
    assert lib.launches == 1 and binpack_kernel.CLUSTER_LAUNCHES == before

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
    before = binpack_kernel.CLUSTER_LAUNCHES
    got = binpack_kernel.binpack_sharded(inp, shards)
    torch.cuda.synchronize()
    assert binpack_kernel.CLUSTER_LAUNCHES == before + 1
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
