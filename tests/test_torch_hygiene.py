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


@pytest.mark.cuda
@pytest.mark.parametrize("seed,selectors", [(0, False), (2, True)])
def test_cuda_model_matches_cpu_model(seed, selectors):
    """Both routes on the card (the kernel, and the per-pod loop for
    node-selector and host-port pods) equal the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from koordinator_tpu_torch import testing
    from koordinator_tpu_torch.apis import types
    from koordinator_tpu_torch.apis.extension import ResourceName
    from koordinator_tpu_torch.models.placement import PlacementModel

    spec = testing.mixed_snapshot_spec(seed, selectors=selectors)
    gpu, cpu = PlacementModel(), PlacementModel(device="cpu")
    got = gpu.schedule(testing.build_snapshot(spec, types, ResourceName))
    want = cpu.schedule(testing.build_snapshot(spec, types, ResourceName))
    assert gpu.last_solver == cpu.last_solver == (
        "loop" if selectors else "kernel")
    assert dict(got) == dict(want) and got.waiting == want.waiting
