"""The node agent's actuation half closing the loop on the card (``cuda``:
skipped without an NVIDIA GPU), against the same run on the CPU, at the
small size of ``tests/test_torch_koordlet_actuation_e2e.py`` (phase 22 of
``chip_smoke.py`` runs it at the main path's width): the manager on the
card and a wired ``build_scheduler`` on the card; the agents' QoS
strategies evict, the victims are re-created and re-placed. The victims
in order, the trees, the reports, the PATCHed batch allocatable and both
rounds' placements equal the CPU run's; the re-placement round launched
the placement kernel, and its kernel input gives the same assignments on
the kernel and on its plain twin.

This file imports no JAX, so it runs on a machine with a GPU and no JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_koordlet_qos_cuda.py``."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_koordlet_actuation_e2e import (  # noqa: E402
    Pkg,
    check_fits,
    comparable,
    run,
)

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


def test_actuation_round_on_the_card(tmp_path):
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
    check_fits(P, card, card["before"])
    assert sum(launches.values()) >= 2, launches  # round 1 and the round
    assert card["victims"] and card["pending"]
    a, b = comparable(cpu), comparable(card)
    for key in a:
        assert b[key] == a[key], key
    inp, args = captured[-1]
    got = launch(inp, *args)
    route = bk.route_of(inp, *args)
    cpu_inp = map_args(inp, torch.Tensor.cpu)
    want = (bk.binpack_plain(cpu_inp) if route.kind == "block"
            else bk.binpack_sharded_plain(cpu_inp, route.shards))
    for g, w_, name in zip(got, want, got._fields):
        if g is None and w_ is None:
            continue
        assert torch.equal(g.cpu(), w_), name
