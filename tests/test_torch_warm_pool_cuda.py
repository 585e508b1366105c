"""The warm pool's CUDA graphs on the card (``cuda``: skipped without an
NVIDIA GPU).

A restored row captures its solve as a ``torch.cuda.CUDAGraph`` on static
buffers and a served call replays it (``service/warmpool.py``). Held
here: the capture and replay on the one-block, cluster and lane routes
(and the reservation and NUMA instance), each equal to the ordinary
launch and to the plain twin on the CPU, each replay counted as one
launch of its kernel and the capture as none; the aliasing rule and the
staged-row case; two threads serving one signature; and the kernel
library's entry restored into an empty build directory, loaded, and
equal in digest to the built one. This file imports no JAX, so it runs
on a machine with a GPU and no JAX: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_warm_pool_cuda.py``."""

import ctypes
import hashlib
import os
import threading

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.obs.device import DEVICE_OBS
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import SolverConfig
from koordinator_tpu_torch.service import server, tenancy
from koordinator_tpu_torch.service import warmpool as wp

pytestmark = pytest.mark.cuda

# the warm pool stays inert unless a test configures its store, as
# tests/conftest.py keeps it for the CPU suite (these files also run
# under --noconftest, where a default store in the home directory
# would restore earlier runs' entries and count their launches)
os.environ.setdefault("KTPU_COMPILATION_CACHE_DIR", "")


@pytest.fixture(autouse=True)
def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    DEVICE_OBS.reset()
    adopted = [(b, b._warm) for b in (tenancy._jit_tenant,
                                      tenancy._jit_tenant_full)]
    yield
    for b, pool in adopted:
        b._warm = pool
    DEVICE_OBS.reset()


def _pool(root):
    return wp.WarmPool().configure(str(root / "store"),
                                   force_single_device=True)


def flat(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    if isinstance(x, tuple):
        return [flat(v) for v in x]
    return x


def assert_same(got, want):
    for g, w in zip(flat(got), flat(want)):
        if isinstance(g, list):
            assert_same(g, w)
        elif g is None:
            assert w is None
        else:
            np.testing.assert_array_equal(g, w)


def to_cpu(tree):
    return wp._map_tensors(tree, lambda t: t.cpu())


def call(binding, problem):
    """``run_solve`` of a ``quota_gang_problem`` (state, pods, params,
    quota, gang) or a ``full_features_problem`` (... resv, numa)."""
    state, pods, params, quota, gang = problem[:5]
    resv, numa = (problem[5], problem[6]) if len(problem) > 5 else (None,
                                                                    None)
    return bk.run_solve(binding, state, pods, params, quota, gang,
                        numa_aux=numa, resv=resv)


def restored_binding(tmp_path, problem):
    """Persist ``problem``'s solve through one pool and restore it into a
    fresh pool and binding; returns ``(pool, binding, ordinary result)``."""
    seed = _pool(tmp_path)
    first = DEVICE_OBS.bind("toy_solve", bk.solve_program)
    seed.adopt(first, config_argpos=3)
    want = call(first, problem)
    torch.cuda.synchronize()
    assert seed.persist()["persisted"] == 1
    pool = _pool(tmp_path)
    binding = DEVICE_OBS.bind("toy_solve", bk.solve_program)
    pool.adopt(binding, config_argpos=3)
    report = pool.restore()
    assert report["restored"] == 1 and report["failed"] == 0, (
        report, pool.status()["last_error"])
    assert pool.status()["graphs"] == 1
    return pool, binding, want


PROBLEMS = {
    "block": lambda: testing.quota_gang_problem(800, 400, 6, 4, 8,
                                                device="cuda"),
    "cluster": lambda: testing.quota_gang_problem(3000, 400, 6, 4, 8,
                                                  device="cuda"),
    "resv-numa": lambda: testing.full_features_problem(700, 600,
                                                       device="cuda"),
}


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_capture_replays_each_route(tmp_path, name):
    problem = PROBLEMS[name]()
    resv, numa = (problem[5], problem[6]) if len(problem) > 5 else (None,
                                                                    None)
    config = bk.program_config(problem[0], problem[2], problem[3], numa,
                               resv)
    pool, binding, want = restored_binding(tmp_path, problem)
    before = dict(bk.LAUNCHES)
    got = call(binding, problem)
    torch.cuda.synchronize()
    assert pool.status()["served"] == 1
    # one replay is one launch of the route's kernel, nothing else
    assert {k: v - before[k] for k, v in bk.LAUNCHES.items()} == {
        k: int(k == config.route.kind) for k in bk.LAUNCHES}
    assert config.route.kind == ("cluster" if name == "cluster" else "block")
    assert_same(got, want)
    assert_same(got, call(_plain_binding(), to_cpu(problem)))


def _plain_binding():
    return DEVICE_OBS.bind("plain_twin", bk.solve_program)


@pytest.mark.parametrize("n_nodes", [500, 3000], ids=["block", "cluster"])
def test_capture_replays_lane_route(tmp_path, n_nodes):
    rng = np.random.default_rng(n_nodes)

    def tenant():
        node = {f: np.zeros((n_nodes, 8), np.int32) for f in (
            "alloc", "used_req", "usage", "prod_usage", "est_extra",
            "prod_base")}
        node["alloc"][:, :2] = (32000, 65536)
        node["used_req"][:, 0] = rng.integers(0, 20000, n_nodes)
        node.update(metric_fresh=np.ones(n_nodes, bool),
                    schedulable=np.ones(n_nodes, bool))
        req = np.zeros((24, 8), np.int32)
        req[:, 0] = rng.integers(200, 4000, 24)
        req[:, 1] = rng.integers(128, 4096, 24)
        pods = {"req": req, "est": (req * 85) // 100,
                "is_prod": np.zeros(24, bool),
                "is_daemonset": np.zeros(24, bool)}
        w = np.zeros(8, np.int32)
        w[:2] = 1
        return node, pods, {"weights": w, "thresholds": np.zeros(8, np.int32),
                            "prod_thresholds": np.zeros(8, np.int32)}

    worlds = [tenant() for _ in range(4)]

    def lanes(device, picks):
        bases = [tenancy.wire_state(worlds[i][0], device) for i in picks]
        return tenancy.solve_lanes(bases, [worlds[i][1] for i in picks],
                                   [worlds[i][2] for i in picks],
                                   SolverConfig(), True, torch.device(device))

    seed = _pool(tmp_path)
    seed.adopt(tenancy._jit_tenant_full, config_argpos=1)
    lanes("cuda", (0, 1))
    assert seed.persist()["persisted"] == 1
    pool = _pool(tmp_path)
    pool.adopt(tenancy._jit_tenant_full, config_argpos=1)
    assert pool.restore()["restored"] == 1
    before = bk.LAUNCHES["lanes"]
    got = lanes("cuda", (2, 3))
    assert pool.status()["served"] == 1
    assert bk.LAUNCHES["lanes"] == before + 1
    tenancy._jit_tenant_full._warm = None
    ordinary = lanes("cuda", (2, 3))
    twin = lanes("cpu", (2, 3))
    for g, o, t in zip(got, ordinary, twin):
        np.testing.assert_array_equal(g.assignments, o.assignments)
        np.testing.assert_array_equal(g.assignments, t.assignments)
        np.testing.assert_array_equal(g.node_used_req, t.node_used_req)


def test_served_results_never_alias_and_staged_rows(tmp_path):
    problem = PROBLEMS["cluster"]()
    pool, binding, _ = restored_binding(tmp_path, problem)
    other = testing.quota_gang_problem(3000, 400, 6, 4, 8, seed=9,
                                       device="cuda")
    first = call(binding, problem)
    kept = flat(first)
    second = call(binding, other)
    assert pool.status()["served"] == 2
    assert_same(first, kept)  # the second replay left the first alone
    (entry,) = pool._execs.values()
    static = {t.untyped_storage().data_ptr() for t in entry.static_leaves}
    static |= {t.untyped_storage().data_ptr()
               for t in wp._tensors(entry.out)}
    for t in wp._tensors(second):
        if t.device.type == "cuda" and not any(
                t is x for x in wp._tensors(other)):
            assert t.untyped_storage().data_ptr() not in static
    # a staged row scattered in place between two served calls
    problem[0].used_req[11] += 3000
    problem[0].schedulable[12] = False
    third = call(binding, problem)
    assert_same(third, call(_plain_binding(), to_cpu(problem)))


def test_two_threads_serve_one_signature(tmp_path):
    problem = PROBLEMS["block"]()
    pool, binding, _ = restored_binding(tmp_path, problem)
    seeds = list(range(20, 28))
    inputs = {s: testing.quota_gang_problem(800, 400, 6, 4, 8, seed=s,
                                            device="cuda") for s in seeds}
    got = {}

    def serve(mine):
        for s in mine:
            got[s] = flat(call(binding, inputs[s]))

    threads = [threading.Thread(target=serve, args=(seeds[i::2],))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert pool.status()["served"] == len(seeds)
    for s in seeds:
        assert_same(got[s], call(_plain_binding(), to_cpu(inputs[s])))


def test_library_entry_restored_into_empty_build_dir(tmp_path, monkeypatch):
    built = bk.build_library()
    pool = _pool(tmp_path)
    assert pool.persist()["library"] == "stored"
    empty = tmp_path / "build"
    empty.mkdir()
    monkeypatch.setattr(bk, "BUILD_DIR", empty)
    monkeypatch.setattr(bk, "build_library", lambda: pytest.fail("nvcc"))
    fresh = _pool(tmp_path)
    report = {"compiled": 0}
    assert fresh._ensure_library(fresh._cache, False, report)
    assert report["library"] == "restored"
    path = bk.library_path()
    assert path.name == built.name
    digest = lambda p: hashlib.sha256(p.read_bytes()).hexdigest()  # noqa
    assert digest(path) == digest(built)
    lib = ctypes.CDLL(str(path))
    assert lib.binpack_error_string(0)
