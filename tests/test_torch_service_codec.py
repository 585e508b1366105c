"""The port's wire codec against the reference's: the same arrays encode
to the same bytes (requests with every group, responses), each package
decodes the other's frames, and framing faults raise the same error
types."""

import dataclasses
import io
import time

import numpy as np
import pytest

from koordinator_tpu.service import codec as ref
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.service import codec


@pytest.fixture(autouse=True)
def _fixed_clock(monkeypatch):
    # np.savez stamps each zip member with the current second
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def every_group() -> dict:
    """One request carrying all twelve groups."""
    g = testing.service_request_groups("quota_gang", seed=4)
    g["resv"] = testing.service_request_groups("resv", seed=4)["resv"]
    numa = testing.service_request_groups("numa_most", seed=4)
    g["node"] = numa["node"]
    g["pods"]["has_numa_policy"] = numa["pods"]["has_numa_policy"]
    g["numa"], g["config"] = numa["numa"], numa["config"]
    g["extras"] = testing.service_request_groups("extras", seed=4)["extras"]
    idx = np.array([1, 5], np.int32)
    g["node_delta"] = {"idx": idx, "base_epoch": np.asarray(3, np.int64),
                       "epoch": np.asarray(4, np.int64),
                       **{f: g["node"][f][idx] for f in STAGED_NODE_FIELDS}}
    g["admission"] = {"deadline_s": np.asarray(0.25, np.float64),
                      "lane": np.asarray(2, np.int64),
                      "tenant": np.frombuffer(b"tenant-a", np.uint8)}
    g["trace"] = {"round": np.asarray(7, np.int64),
                  "span": np.asarray(11, np.int64)}
    return g


def response_arrays(rng) -> dict:
    p, n = 9, 5
    return dict(
        assignments=rng.integers(-1, n, p).astype(np.int32),
        node_used_req=rng.integers(0, 1000, (n, 8)).astype(np.int32),
        commit=rng.uniform(size=p) < 0.5, waiting=rng.uniform(size=p) < 0.2,
        rejected=rng.uniform(size=p) < 0.1,
        raw_assign=rng.integers(-1, n, p).astype(np.int32),
        resv_vstar=rng.integers(-1, 3, p).astype(np.int32),
        resv_delta=rng.integers(0, 50, (p, 8)).astype(np.int32))


def same_request(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None:
            assert g is None, f.name
            continue
        assert set(g) == set(w), f.name
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{f.name}.{k}")
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype


def test_request_bytes_match_and_cross_decode():
    groups = every_group()
    assert len(groups) == 12
    ours = codec.encode_request(codec.SolveRequest(**groups))
    theirs = ref.encode_request(ref.SolveRequest(**groups))
    assert ours == theirs
    same_request(codec.decode_request(theirs), ref.SolveRequest(**groups))
    same_request(ref.decode_request(ours), codec.SolveRequest(**groups))


@pytest.mark.parametrize("error", ["", "delta-base-mismatch: epoch 3"])
def test_response_bytes_match_and_cross_decode(error):
    arrays = response_arrays(np.random.default_rng(1))
    if error:
        arrays = dict(assignments=np.empty(0, np.int32))
    ours = codec.encode_response(codec.SolveResponse(**arrays, error=error))
    theirs = ref.encode_response(ref.SolveResponse(**arrays, error=error))
    assert ours == theirs
    for decoded in (codec.decode_response(theirs),
                    ref.decode_response(ours)):
        assert decoded.error == error
        for k, v in arrays.items():
            np.testing.assert_array_equal(getattr(decoded, k), v)


def test_frames_and_faults_match():
    buf, ref_buf = io.BytesIO(), io.BytesIO()
    codec.write_frame(buf, b"payload")
    ref.write_frame(ref_buf, b"payload")
    assert buf.getvalue() == ref_buf.getvalue()
    assert codec.MAX_FRAME == ref.MAX_FRAME
    assert codec.PROTOCOL_VERSION == ref.PROTOCOL_VERSION
    cut = io.BytesIO(buf.getvalue()[:-2])
    with pytest.raises(codec.TruncatedFrame):
        codec.read_frame(cut)
    assert issubclass(codec.TruncatedFrame, EOFError)
    big = io.BytesIO((5000).to_bytes(4, "big") + b"x" * 10)
    with pytest.raises(codec.FrameTooLarge):
        codec.read_frame(big, max_frame=4096)
    assert issubclass(codec.FrameTooLarge, codec.CodecError)
    assert issubclass(codec.CodecError, ValueError)
    with pytest.raises(codec.CodecError):
        codec.decode_request(b"not an npz archive")
    with pytest.raises(codec.CodecError):
        codec.decode_response(codec.encode_request(
            codec.SolveRequest(node={}, pods={}, params={})))
    assert codec.read_frame(io.BytesIO(b"")) is None
