"""Wire format for the solver boundary (counterpart of
``koordinator_tpu/service/codec.py``, a copy: the port keeps its own).

Framing: 4-byte big-endian payload length, then the payload. Payloads are
npz archives (a zip of npy buffers), a language-neutral container a Go or
C++ control plane can read. The request carries the batched solve's
inputs (NodeState/PodBatch/ScoreParams columns and the optional feature
groups); the response carries the assignments and the mutated node
accounting columns. For the same arrays the frames are byte for byte the
reference's (``np.savez`` stamps each member with the current second,
so two encodings agree within one second), which is what lets the
reference's client drive this package's server and the other way round.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import BinaryIO, Dict, Optional

import numpy as np

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30
#: wire protocol revision: 2 added the optional ``admission`` group
#: (deadline + QoS lane) and unknown-prefix-tolerant request decoding;
#: 3 added the optional ``trace`` group (round + span id) so
#: sidecar-side spans join the scheduler's trace — tolerated as an
#: unknown prefix by v2 servers exactly like ``admission`` was by v1.
PROTOCOL_VERSION = 3


class CodecError(ValueError):
    """The payload is not a well-formed wire message (not an npz
    archive, wrong member types, required arrays missing). The FRAME
    boundary was still read cleanly, so the caller knows exactly how
    many bytes the bad message occupied — a server keeps the
    connection, a client may retry after reconnecting."""


class FrameTooLarge(CodecError):
    """The length prefix exceeds the frame cap. Raised BEFORE any
    payload allocation: a hostile or corrupted 4-byte header can never
    make the peer buffer gigabytes."""


class TruncatedFrame(EOFError):
    """The peer died (or was cut) mid-frame: the length prefix promised
    more bytes than the stream delivered. Subclasses ``EOFError`` so
    pre-existing handlers keep working; new code should catch this and
    treat the connection as lost, never the payload as data."""


@dataclasses.dataclass
class SolveRequest:
    """One batched solve: the scan's inputs as host arrays.

    The optional groups mirror ``solve_batch``'s optional feature states
    (quota admission, gang resolution, host extras, reservation credit,
    NUMA aux) plus the static SolverConfig scalars — absent groups mean
    the plain path, so old plain requests decode unchanged."""

    node: Dict[str, np.ndarray]    # alloc/used_req/usage/... [N,R]+masks
    pods: Dict[str, np.ndarray]    # req/est/is_prod/... [P,...]
    params: Dict[str, np.ndarray]  # weights/thresholds/prod_thresholds [R]
    quota: Optional[Dict[str, np.ndarray]] = None   # QuotaState fields
    gang: Optional[Dict[str, np.ndarray]] = None    # GangState fields
    extras: Optional[Dict[str, np.ndarray]] = None  # Extras fields
    resv: Optional[Dict[str, np.ndarray]] = None    # ResvArrays fields
    numa: Optional[Dict[str, np.ndarray]] = None    # NumaAux fields
    config: Optional[Dict[str, np.ndarray]] = None  # SolverConfig scalars
    #: incremental node staging (the steady-state bandwidth win): with a
    #: full ``node`` group, ``{"epoch": k}`` asks the server to cache the
    #: staged state as delta base k; WITHOUT a ``node`` group it carries
    #: ``idx [D]`` + a row update per node field + ``base_epoch``/
    #: ``epoch``, patching the server's cached base instead of
    #: re-shipping all eight [N,R] arrays. A server that lost the base
    #: answers with a ``delta-base-mismatch`` error and the client
    #: re-establishes with a full request.
    node_delta: Optional[Dict[str, np.ndarray]] = None
    #: admission-gate metadata (wire v2): ``deadline_s`` (float64 scalar,
    #: the caller's remaining latency budget — the server sheds the
    #: request with a typed ``deadline-exceeded`` error instead of
    #: solving work the caller already abandoned) and ``lane`` (int64
    #: QoS-lane code, service/admission.py LANE_*). Absent means "no
    #: deadline, latency-sensitive lane", so v1 clients ride through
    #: unchanged; from v2 on, decode skips unknown prefixes so future
    #: groups degrade the same way (a v2 client against a v1 server
    #: gets that server's typed "decode failed" error, not a hang).
    #: The multi-tenant pool (DESIGN §20) adds ``tenant`` (utf-8 bytes
    #: as a uint8 array, service/tenancy.tenant_wire_value): the
    #: front-end's identity, scoping coalescing / delta bases /
    #: fair-share accounting per tenant. Absent means the implicit
    #: single-tenant ``default`` — an unknown key inside a known group
    #: is simply extra npz members to old servers, so this needed no
    #: protocol revision.
    admission: Optional[Dict[str, np.ndarray]] = None
    #: trace context (wire v3): ``round`` (int64, the scheduler's trace
    #: round number) and ``span`` (int64, a scheduler-unique span id).
    #: The sidecar tags its queue-wait/solve spans with the pair so one
    #: Perfetto load shows the scheduler round AND its sidecar half as
    #: one trace (obs/trace.py). Absent means an untraced (or older)
    #: client; like ``admission``, unknown to old servers and skipped.
    trace: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass
class SolveResponse:
    """Everything the control plane's epilogue consumes (the SolveResult
    columns models/placement.py reads after a solve)."""

    assignments: np.ndarray              # [P] int32 node index or -1
    node_used_req: Optional[np.ndarray] = None  # [N,R] post-solve
    error: str = ""
    commit: Optional[np.ndarray] = None      # [P] bool
    waiting: Optional[np.ndarray] = None     # [P] bool
    rejected: Optional[np.ndarray] = None    # [P] bool
    raw_assign: Optional[np.ndarray] = None  # [P] int32 pre-gang placement
    resv_vstar: Optional[np.ndarray] = None  # [P] int32 consumed resv, -1
    resv_delta: Optional[np.ndarray] = None  # [P,R] consumed amount


def write_frame(stream: BinaryIO, payload: bytes) -> None:
    stream.write(_LEN.pack(len(payload)))
    stream.write(payload)


def read_frame(stream: BinaryIO,
               max_frame: int = MAX_FRAME) -> Optional[bytes]:
    header = stream.read(_LEN.size)
    if len(header) < _LEN.size:
        return None  # peer closed
    (length,) = _LEN.unpack(header)
    if length > max_frame:
        raise FrameTooLarge(f"frame too large: {length} > {max_frame}")
    chunks = []
    remaining = length
    while remaining:
        chunk = stream.read(remaining)
        if not chunk:
            raise TruncatedFrame(
                f"truncated frame: peer closed {remaining} bytes short "
                f"of the {length}-byte payload"
            )
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def _pack(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack(payload: bytes) -> Dict[str, np.ndarray]:
    # any payload defect — not a zip, bad npy headers, members whose
    # declared shape outruns their data — must surface as ONE typed
    # error, never a hang or a raw zipfile/numpy internal
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:
        raise CodecError(
            f"malformed npz payload: {type(e).__name__}: {e}"
        ) from e


#: request group -> wire prefix (single-char + "."); optional groups are
#: simply absent from the archive when None
_REQ_GROUPS = (
    ("node", "n."), ("pods", "p."), ("params", "s."), ("quota", "q."),
    ("gang", "g."), ("extras", "x."), ("resv", "r."), ("numa", "u."),
    ("config", "c."), ("node_delta", "d."), ("admission", "a."),
    ("trace", "t."),
)

_RESP_OPTIONAL = (
    "node_used_req", "commit", "waiting", "rejected", "raw_assign",
    "resv_vstar", "resv_delta",
)


def encode_request(req: SolveRequest) -> bytes:
    arrays: Dict[str, np.ndarray] = {}
    for field, prefix in _REQ_GROUPS:
        group = getattr(req, field)
        if group is None:
            continue
        for key, value in group.items():
            arrays[prefix + key] = np.asarray(value)
    return _pack(arrays)


def decode_request(payload: bytes) -> SolveRequest:
    by_prefix = {prefix: field for field, prefix in _REQ_GROUPS}
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in _unpack(payload).items():
        prefix, name = key[:2], key[2:]
        field = by_prefix.get(prefix)
        if field is None:
            continue  # newer-protocol group this server doesn't speak
        groups.setdefault(field, {})[name] = value
    return SolveRequest(
        node=groups.get("node", {}),
        pods=groups.get("pods", {}),
        params=groups.get("params", {}),
        **{f: groups.get(f) for f, _p in _REQ_GROUPS[3:]},
    )


def encode_response(resp: SolveResponse) -> bytes:
    arrays = {
        "assignments": np.asarray(resp.assignments, dtype=np.int32),
        "error": np.frombuffer(resp.error.encode(), dtype=np.uint8),
    }
    for field in _RESP_OPTIONAL:
        value = getattr(resp, field)
        if value is not None:
            arrays[field] = np.asarray(value)
    return _pack(arrays)


def decode_response(payload: bytes) -> SolveResponse:
    arrays = _unpack(payload)
    if "assignments" not in arrays:
        raise CodecError("response payload missing 'assignments'")
    try:
        error = bytes(arrays["error"]).decode() if "error" in arrays else ""
    except UnicodeDecodeError as e:
        raise CodecError(f"undecodable error string: {e}") from e
    return SolveResponse(
        assignments=arrays["assignments"],
        error=error,
        **{f: arrays.get(f) for f in _RESP_OPTIONAL},
    )
