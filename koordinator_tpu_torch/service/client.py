"""Control-plane client for the solver sidecar (counterpart of
``koordinator_tpu/service/client.py``).

Speaks the framed npz protocol. :class:`RemoteSolver` is the
``PlacementModel(backend=...)`` backend: it ships every feature state of
a solve (host extras rows go as the dense ``[P,N]`` ``Extras``, as the
reference sends them), sends only the dirty node rows once the connected
sidecar holds the model's staging base, reconnects transparently when
the sidecar restarts, re-sends the full state after a
``delta-base-mismatch``, and raises :class:`SolverUnavailable` when the
sidecar stays down. It talks to this package's ``PlacementService`` and
to the reference's alike.

A traced solve sends the wire ``trace`` group (the tracer's round and a
span id), so the sidecar's queue-wait and solve spans join this
process's trace, and records a ``wire_solve`` span; a spent client-side
deadline fires the flight recorder's ``deadline-exceeded`` trigger.
"""

from __future__ import annotations

import random
import socket
import time
from typing import Dict, Optional

import numpy as np
import torch

from koordinator_tpu_torch.obs.flight import FLIGHT
from koordinator_tpu_torch.obs.trace import TRACER
from koordinator_tpu_torch.service.codec import (
    CodecError,
    SolveRequest,
    SolveResponse,
    decode_response,
    encode_request,
    read_frame,
    write_frame,
)


class SolverUnavailable(ConnectionError):
    """The sidecar cannot be reached (after reconnect attempts)."""


class SolverOverloaded(RuntimeError):
    """The sidecar's admission gate shed this request (typed
    ``overloaded`` response); the connection stays usable."""


class SolverDeadlineExceeded(RuntimeError):
    """The request expired in the sidecar's queue (typed
    ``deadline-exceeded``) or its client-side budget ran out. Not
    retried."""


class SolverShuttingDown(ConnectionError):
    """The sidecar is draining for shutdown (typed ``shutting-down``)."""


def jittered_backoff(base_s: float, cap_s: float, attempt: int,
                     rng: random.Random) -> float:
    """Exponential from ``base_s`` capped at ``cap_s``, times a uniform
    [0.5, 1.0) jitter."""
    return min(cap_s, base_s * (2 ** attempt)) * (0.5 + 0.5 * rng.random())


class PlacementClient:
    def __init__(self, address, timeout: float = 60.0, secret=None):
        if isinstance(address, str):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        try:
            self._sock.connect(address)
        except OSError:
            self._sock.close()
            raise
        self._stream = self._sock.makefile("rwb")
        #: bytes of the last request payload sent
        self.last_bytes = 0
        if secret is not None:
            write_frame(self._stream, secret)   # the shared-secret hello
            self._stream.flush()

    def solve(self, request: SolveRequest) -> SolveResponse:
        # an encoding failure is a local bug, not a transport fault
        encoded = encode_request(request)
        self.last_bytes = len(encoded)
        try:
            write_frame(self._stream, encoded)
            self._stream.flush()
            payload = read_frame(self._stream)
        except (EOFError, OSError, ValueError) as e:
            raise SolverUnavailable(
                f"solver connection failed mid-frame: "
                f"{type(e).__name__}: {e}") from e
        if payload is None:
            raise SolverUnavailable("solver closed the connection")
        response = decode_response(payload)
        if response.error:
            if response.error.startswith("overloaded"):
                raise SolverOverloaded(response.error)
            if response.error.startswith("deadline-exceeded"):
                raise SolverDeadlineExceeded(response.error)
            if response.error.startswith("shutting-down"):
                raise SolverShuttingDown(response.error)
            raise RuntimeError(f"solver error: {response.error}")
        return response

    def solve_arrays(self, node: Dict[str, np.ndarray],
                     pods: Dict[str, np.ndarray],
                     params: Dict[str, np.ndarray]) -> SolveResponse:
        return self.solve(SolveRequest(node=node, pods=pods, params=params))

    def set_timeout(self, timeout: float) -> None:
        self._sock.settimeout(timeout)

    def close(self) -> None:
        try:
            self._stream.close()
        except OSError:
            pass
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _group(nt) -> Optional[Dict[str, np.ndarray]]:
    """NamedTuple of tensors -> wire group (None fields dropped)."""
    if nt is None:
        return None
    return {f: _host(v) for f, v in zip(nt._fields, nt) if v is not None}


class RemoteSolver:
    """Routes ``PlacementModel``'s solves through the sidecar.

    ``deadline_s`` is the per-solve budget (on the wire, capping each
    attempt's socket wait, bounding retries); ``lane`` the QoS lane
    (``"system"``/``"ls"``/``"be"``, a lane code or a ``QoSClass``);
    ``tenant`` this front-end's name in a multi-tenant pool. Reconnects
    and ``overloaded`` sheds retry with jittered exponential backoff
    under ``deadline_s`` or ``retry_total_s``; ``retries`` is the
    guaranteed minimum."""

    #: PlacementModel passes ``staging=`` to a backend that says so
    supports_staging_delta = True

    def __init__(self, address, secret: Optional[bytes] = None,
                 timeout: float = 120.0, retries: int = 1,
                 deadline_s: Optional[float] = None, lane=None,
                 tenant: Optional[str] = None, retry_total_s: float = 2.0,
                 backoff_base_s: float = 0.025, backoff_cap_s: float = 0.5,
                 rng: Optional[random.Random] = None):
        from koordinator_tpu_torch.apis.extension import QoSClass
        from koordinator_tpu_torch.service.admission import (
            LANE_BY_NAME,
            lane_for_qos,
        )

        self.address = address
        self.secret = secret
        self.timeout = timeout
        self.retries = retries
        self.deadline_s = deadline_s
        self.retry_total_s = retry_total_s
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rng = rng if rng is not None else random.Random()
        if lane is None:
            self.lane: Optional[int] = None
        elif isinstance(lane, QoSClass):
            self.lane = lane_for_qos(lane)
        elif isinstance(lane, str):
            self.lane = LANE_BY_NAME[lane]
        else:
            self.lane = int(lane)
        self.tenant = tenant
        self._client: Optional[PlacementClient] = None
        #: the staging epoch the connected sidecar holds as its delta base
        self._server_epoch: Optional[int] = None
        #: the wire shape of the last solve: "full", "establish", "delta"
        self.last_request: Optional[str] = None
        #: bytes of the last request frame's payload
        self.last_request_bytes = 0

    def _connect(self, remaining: Optional[float] = None) -> PlacementClient:
        timeout = self.timeout
        if remaining is not None:
            timeout = max(0.05, min(self.timeout, remaining))
        if self._client is None:
            self._client = PlacementClient(self.address, timeout=timeout,
                                           secret=self.secret)
        else:
            self._client.set_timeout(timeout)
        return self._client

    def _drop(self) -> None:
        if self._client is not None:
            try:
                self._client.close()
            except OSError:
                pass
            self._client = None
        # a new connection lands on a handler with no delta base
        self._server_epoch = None

    def close(self) -> None:
        self._drop()

    def reset_base(self) -> None:
        """Drop the connection and the believed base: the next solve
        re-establishes with a full request."""
        self._drop()

    def solve_result(self, state, batch, params, config, quota_state=None,
                     gang_state=None, extras=None, resv=None, numa=None,
                     staging=None):
        """``solve_batch`` over the wire; returns a ``SolveResult`` whose
        node state is ``state`` with the sidecar's ``used_req`` and whose
        per-pod outputs are CPU tensors. ``staging`` is the model's
        ``(epoch, NodeStagingDelta)``: when the sidecar holds the delta's
        base only the dirty rows are sent, else the full node group,
        which establishes the base."""
        from koordinator_tpu_torch.ops.binpack import ExtrasRows, SolveResult

        if isinstance(extras, ExtrasRows):
            extras = extras.dense()
        common = dict(
            pods=_group(batch), params=_group(params),
            quota=_group(quota_state), gang=_group(gang_state),
            extras=_group(extras), resv=_group(resv), numa=_group(numa),
            config={f: np.asarray(v) for f, v in zip(config._fields,
                                                     config)},
        )
        # the trace context rides the wire: the sidecar tags its
        # queue-wait and solve spans with this (round, span) pair
        span_id = TRACER.next_span_id() if TRACER.enabled else None
        trace_group = None
        if span_id is not None:
            trace_group = {"round": np.asarray(TRACER.round_id, np.int64),
                           "span": np.asarray(span_id, np.int64)}

        def build_request(remaining: Optional[float]) -> SolveRequest:
            admission = None
            if (remaining is not None or self.lane is not None
                    or self.tenant is not None):
                admission = {}
                if remaining is not None:
                    admission["deadline_s"] = np.asarray(
                        max(0.0, remaining), np.float64)
                if self.lane is not None:
                    admission["lane"] = np.asarray(self.lane, np.int64)
                if self.tenant is not None:
                    from koordinator_tpu_torch.service.tenancy import (
                        tenant_wire_value,
                    )

                    admission["tenant"] = tenant_wire_value(self.tenant)
            delta = staging[1] if staging is not None else None
            if (delta is not None and delta.base_epoch is not None
                    and self._server_epoch == delta.base_epoch):
                node_delta = {
                    "idx": np.asarray(
                        delta.idx if delta.idx is not None else [], np.int32),
                    "base_epoch": np.asarray(delta.base_epoch, np.int64),
                    "epoch": np.asarray(delta.epoch, np.int64),
                }
                node_delta.update(delta.rows or {})
                self.last_request = "delta"
                return SolveRequest(node={}, node_delta=node_delta,
                                    admission=admission, trace=trace_group,
                                    **common)
            node_delta = None
            if staging is not None:
                node_delta = {"epoch": np.asarray(staging[0], np.int64)}
            self.last_request = "establish" if node_delta else "full"
            return SolveRequest(node=_group(state), node_delta=node_delta,
                                admission=admission, trace=trace_group,
                                **common)

        start = time.monotonic()
        t_wire = TRACER.now()
        budget = (self.deadline_s if self.deadline_s is not None
                  else self.retry_total_s)
        last_error: Optional[Exception] = None
        attempt = 0
        mismatch_retry = True
        while True:
            remaining = None
            if self.deadline_s is not None:
                remaining = self.deadline_s - (time.monotonic() - start)
                if remaining <= 0:
                    last = (type(last_error).__name__ if last_error
                            else None)
                    FLIGHT.trigger("deadline-exceeded",
                                   detail=f"client budget {self.deadline_s}s "
                                          f"spent (last: {last})")
                    raise SolverDeadlineExceeded(
                        f"deadline-exceeded: {self.deadline_s}s budget "
                        f"spent client-side (last: {last})")
            try:
                client = self._connect(remaining)
                response = client.solve(build_request(remaining))
                self.last_request_bytes = client.last_bytes
                break
            except SolverDeadlineExceeded as e:
                # the budget is gone by definition: no retry
                FLIGHT.trigger("deadline-exceeded", detail=str(e))
                raise
            except SolverOverloaded as e:
                last_error = e   # the connection stays in sync: back off
            except (ConnectionError, OSError, EOFError) as e:
                last_error = e
                self._drop()
            except CodecError as e:
                last_error = e   # garbage on the wire: reconnect, re-send
                self._drop()
            except RuntimeError as e:
                if "delta-base-mismatch" in str(e) and mismatch_retry:
                    # the stream is in sync: re-send the full state
                    mismatch_retry = False
                    self._server_epoch = None
                    continue
                self._drop()
                raise
            except Exception:
                self._drop()
                raise
            delay = jittered_backoff(self.backoff_base_s, self.backoff_cap_s,
                                     attempt, self._rng)
            attempt += 1
            elapsed = time.monotonic() - start
            if attempt > self.retries and elapsed + delay >= budget:
                if isinstance(last_error, SolverOverloaded):
                    raise last_error
                raise SolverUnavailable(
                    f"placement sidecar at {self.address!r} unreachable: "
                    f"{type(last_error).__name__}: {last_error}")
            time.sleep(delay)
        TRACER.emit("wire_solve", cat="wire", t0=t_wire, args={
            "span": span_id, "request": self.last_request,
            "retries": attempt})
        if staging is not None:
            self._server_epoch = int(staging[0])
        new_state = state
        if response.node_used_req is not None:
            new_state = state._replace(used_req=torch.as_tensor(
                response.node_used_req, device=state.alloc.device))

        def t(a):
            return None if a is None else torch.as_tensor(a)

        return SolveResult(
            node_state=new_state, quota_state=None,
            assign=t(response.assignments), commit=t(response.commit),
            waiting=t(response.waiting), rejected=t(response.rejected),
            raw_assign=t(response.raw_assign), resv_free=None,
            resv_vstar=t(response.resv_vstar),
            resv_delta=t(response.resv_delta), numa_consumed=None)
