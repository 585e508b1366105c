"""The port's ``solve_from_request`` against the reference's on the same
seeded wire requests: every ``SolveResponse`` field equal (integer
arithmetic: exact). The reference runs its scan on the CPU, as its own
tests run it; the port runs on the CPU, where a kernel route takes the
chosen kernel's plain version."""

import dataclasses

import numpy as np
import pytest

from koordinator_tpu.service import codec as ref_codec
from koordinator_tpu.service import server as ref_server
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.service import codec, server

RESPONSE_FIELDS = [f.name for f in dataclasses.fields(codec.SolveResponse)]


def same_response(got, want):
    for f in RESPONSE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f == "error":
            assert g == w, (g, w)
        elif w is None:
            assert g is None, f
        else:
            assert g is not None, f
            assert np.asarray(g).dtype == np.asarray(w).dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


def requests(groups):
    return codec.SolveRequest(**groups), ref_codec.SolveRequest(**groups)


@pytest.mark.parametrize("case", testing.SERVICE_CASES)
def test_solve_from_request_matches_reference(case):
    port_req, ref_req = requests(testing.service_request_groups(case))
    got = server.solve_from_request(port_req, device="cpu")
    want = ref_server.solve_from_request(ref_req)
    assert not want.error and (want.assignments >= 0).any()
    same_response(got, want)


def test_wire_config_ignores_the_reference_unroll_fields():
    groups = testing.service_request_groups("plain")
    groups["config"] = {"unroll": np.asarray(32),
                        "kernel_unroll": np.asarray(4),
                        "fit_weight": np.asarray(1)}
    port_req, ref_req = requests(groups)
    same_response(server.solve_from_request(port_req, device="cpu"),
                  ref_server.solve_from_request(ref_req))


def _delta_chain():
    """Establish (epoch 1), three deltas, then a delta on a stale base."""
    groups = testing.service_request_groups("plain")
    node = {k: np.array(v, copy=True) for k, v in groups["node"].items()}
    rng = np.random.default_rng(5)
    out = [dict(groups, node_delta={"epoch": np.asarray(1, np.int64)})]
    for epoch in (2, 3, 4):
        idx = np.sort(rng.choice(node["alloc"].shape[0], 3, replace=False))
        node["used_req"][idx, 0] = rng.integers(0, 20000, 3)
        node["schedulable"][idx[0]] = bool(epoch % 2)
        delta = {"idx": idx.astype(np.int32),
                 "base_epoch": np.asarray(epoch - 1, np.int64),
                 "epoch": np.asarray(epoch, np.int64),
                 **{f: node[f][idx] for f in STAGED_NODE_FIELDS}}
        out.append(dict(groups, node={}, node_delta=delta))
    stale = dict(out[-1])
    stale["node_delta"] = dict(stale["node_delta"],
                               base_epoch=np.asarray(2, np.int64),
                               epoch=np.asarray(9, np.int64))
    out.append(stale)
    return out


def test_delta_chain_matches_reference():
    port_cache = server.NodeStateCache(device="cpu")
    ref_cache = ref_server.NodeStateCache()
    try:
        for i, groups in enumerate(_delta_chain()):
            port_req, ref_req = requests(groups)
            got = server.solve_from_request(port_req, node_cache=port_cache)
            want = ref_server.solve_from_request(ref_req, node_cache=ref_cache)
            same_response(got, want)
            assert port_cache.epoch == ref_cache.epoch
            if i < 4:
                assert not got.error
        assert got.error.startswith("delta-base-mismatch")
    finally:
        ref_cache.close()


def test_delta_scatter_leaves_a_pinned_generation():
    cache = server.NodeStateCache(device="cpu")
    chain = _delta_chain()
    server.solve_from_request(codec.SolveRequest(**chain[0]),
                              node_cache=cache)
    held = cache.state
    before = held.used_req.clone()
    cache.pin(held)
    cache.apply(chain[1]["node_delta"])
    assert cache.state is not held
    assert np.array_equal(held.used_req.numpy(), before.numpy())
    cache.unpin(held)
    current = cache.state
    cache.apply(chain[2]["node_delta"])
    assert cache.state is current       # unpinned: written in place


def test_malformed_payload_matches_reference():
    groups = testing.service_request_groups("plain")
    del groups["node"]["alloc"]
    port_req, ref_req = requests(groups)
    got = server.solve_from_request(port_req, device="cpu")
    want = ref_server.solve_from_request(ref_req)
    assert got.error.startswith("KeyError") and want.error.startswith(
        "KeyError")
    assert got.assignments.shape == want.assignments.shape == (0,)


def test_compact_extras_is_the_dense_rows():
    row_of_pod, mask, score = testing.extras_arrays(16, 40, seed=3)
    dense_mask, dense_score = testing.dense_extras(row_of_pod, mask, score)
    rows, xmask, xscore = server.compact_extras(dense_mask, dense_score)
    back_mask, back_score = testing.dense_extras(rows, xmask, xscore)
    np.testing.assert_array_equal(back_mask, dense_mask)
    np.testing.assert_array_equal(back_score, dense_score)
    assert xmask.shape[0] == len({(m.tobytes(), s.tobytes())
                                  for m, s, r in zip(dense_mask, dense_score,
                                                     rows) if r >= 0})
