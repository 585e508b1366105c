"""The koordlet acting on the card's placements (``cuda``: skipped without
an NVIDIA GPU), against the same run on the CPU, at the small size of
``tests/test_torch_koordlet_hooks_e2e.py`` (phase 23 of ``chip_smoke.py``
runs it on phase 21's 200-node world): a wired ``build_scheduler`` on the
card places both waves of cpuset and GPU pods, every solve on the
one-block kernel with extras rows; the ``build_koordlet`` agents pin the
cpusets and name the GPUs. The placements, annotations, trees, the
executors' writes in order, the server responses, the audit events and
the NRI counts equal the CPU run's, and the last solve's kernel input
gives the same result on the kernel and on its plain twin.

This file imports no JAX, so it runs on a machine with a GPU and no JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_koordlet_hooks_cuda.py``."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_koordlet_hooks_e2e import Pkg, plain, run  # noqa: E402

from koordinator_tpu_torch.ops import binpack_kernel as bk  # noqa: E402

pytestmark = pytest.mark.cuda

# the warm pool stays inert unless a test configures its store, as
# tests/conftest.py keeps it for the CPU suite (these files also run
# under --noconftest, where a default store in the home directory
# would restore earlier runs' entries and count their launches)
os.environ.setdefault("KTPU_COMPILATION_CACHE_DIR", "")


def map_args(x, fn):
    """``fn`` applied to every tensor of a solve's inputs (NamedTuples and
    tuples of tensors)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(map_args(v, fn) for v in x))
    if isinstance(x, tuple):
        return tuple(map_args(v, fn) for v in x)
    return x


def test_hooks_act_on_the_card_placements(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    P = Pkg("koordinator_tpu_torch")
    captured = []
    launch = bk.binpack

    def capture(inp, *args):
        # a copy: a later round scatters the staged state in place
        captured.append((map_args(inp, torch.Tensor.clone), args))
        return launch(inp, *args)

    bk.binpack = capture
    try:
        for kind in bk.LAUNCHES:
            bk.LAUNCHES[kind] = 0
        card = run(P, str(tmp_path / "cuda"), device="cuda")
        torch.cuda.synchronize()
        launches = dict(bk.LAUNCHES)
    finally:
        bk.binpack = launch
    cpu = run(P, str(tmp_path / "cpu"), device="cpu")
    assert launches["block"] == sum(launches.values()) == len(captured) >= 2
    a, b = plain(cpu), plain(card)
    for key in a:
        assert b[key] == a[key], key
    inp, args = captured[-1]
    assert inp.extras is not None, "the wave's solve had no extras rows"
    assert bk.route_of(inp, *args).kind == "block"
    got = launch(inp, *args)
    want = bk.binpack_plain(map_args(inp, torch.Tensor.cpu))
    for g, w_, name in zip(got, want, got._fields):
        if g is None and w_ is None:
            continue
        assert torch.equal(g.cpu(), w_), name
