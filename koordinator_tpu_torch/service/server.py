"""The solver sidecar (counterpart of ``koordinator_tpu/service/server.py``):
the batched placement solve behind the wire boundary, on one device
(``cuda`` unless ``device`` says otherwise).

One thread per connection reads request frames; every solve passes
through the admission gate (``service/admission.py``), a bounded,
QoS-laned queue drained by one executor thread that batches same-base
and same-shape plain requests into one lane-batched kernel launch
(``PlacementService(admission=False)`` solves inline on the handler
thread instead). A solve routes as the in-process model does: the
hand-written kernel ``ops/binpack_kernel.kernel_route`` names when
``kernel_supported`` and ``kernel_routing_ok`` accept it, else the loop
``solve_batch``. A kernel build or launch failure is answered with the
boundary's typed error response; it never runs the loop or a plain
version in its place (the reference's ``KernelBreaker`` and its scan
fallback are not ported, on purpose).

The wire ``extras`` group is the dense ``[P,N]`` ``Extras``; the server
compacts it into ``ExtrasRows`` (pods with equal rows share one) before
the kernel. The wire ``config`` is read by ``tenancy.decode_config`` (the
reference's ``_decode_config``). The delta protocol (``node_delta``)
patches a per-tenant, per-connection base (:class:`NodeStateCache`) with
``scatter_node_rows``; the reference's ``bucket_row_update`` and its
donated/copied scatters exist to share XLA compiles and are not needed.

Security: a UDS inherits filesystem permissions; TCP is for trusted
networks unless ``secret=`` is set, in which case the first frame of
every connection must carry the shared secret or the connection is
dropped before any solve runs.

Every per-(connection, tenant) base is a resident of the HBM working
set (``state/workingset.py``): its stagings and scatters run under the
demote-and-retry ladder. A solve calls ``DEVICE_OBS.on_round()`` (an
armed profiler window counts sidecar solves) and records a
``sidecar_solve`` span tagged with the wire ``trace`` group, and
:meth:`PlacementService.status` carries the ``device`` and
``workingset`` sections. The kernel solve is the binding
``sidecar_solve_batch`` adopted into the warm pool
(``service/warmpool.py``): a service restores the pool's entries when it
starts (when the pool is configured, as ``cmd/solver`` does before it
binds) and keeps persisting new signatures; its status has a
``warm_pool`` section.
"""

from __future__ import annotations

import functools
import hmac
import os
import socket
import socketserver
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.ops.binpack import (
    STAGED_NODE_FIELDS,
    ExtrasRows,
    NodeState,
    NumaAux,
    PodBatch,
    ResvArrays,
    ScoreParams,
    SolverConfig,
    scatter_node_rows,
    solve_batch,
)
from koordinator_tpu_torch.ops.binpack_kernel import (
    BASE_SCORE_WORST,
    LAUNCHES,
    kernel_extras_score_safe,
    kernel_resv_score_safe,
    kernel_routing_ok,
    resv_score_worst,
    run_solve,
    solve_program,
)
from koordinator_tpu_torch.ops.gang import GangState
from koordinator_tpu_torch.ops.quota import QuotaState
from koordinator_tpu_torch.obs.device import DEVICE_OBS
from koordinator_tpu_torch.obs.trace import TRACER
from koordinator_tpu_torch.service.admission import (
    LANE_NAMES,
    AdmissionConfig,
    AdmissionGate,
    request_lane,
)
from koordinator_tpu_torch.service.codec import (
    SolveRequest,
    SolveResponse,
    decode_request,
    encode_response,
    read_frame,
    write_frame,
)
from koordinator_tpu_torch.service.tenancy import (
    decode_config,
    request_tenant,
    wire_kernel_supported,
)
from koordinator_tpu_torch.service.warmpool import WARM_POOL
from koordinator_tpu_torch.state.workingset import WORKING_SET

#: the wire NodeState columns: exactly the staged columns the delta
#: protocol patches
NODE_FIELDS = STAGED_NODE_FIELDS
POD_FIELDS = (
    "req", "est", "is_prod", "is_daemonset", "quota_id", "non_preemptible",
    "gang_id", "blocked", "has_numa_policy",
)

#: per-connection delta bases are LRU-bounded: a connection cycling
#: tenant ids cannot grow the sidecar's memory without bound (an evicted
#: tenant's next delta gets the typed mismatch and re-establishes)
MAX_CONNECTION_TENANTS = 32


def _put(a, device) -> torch.Tensor:
    """A wire array on ``device``, always a copy (a CPU tensor must never
    share memory with a host array the cache patches)."""
    return torch.tensor(np.asarray(a), device=device)


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """A result tensor as a host array of its own."""
    return None if t is None else t.cpu().numpy().copy()


#: node counts of the warm-up solves: one each for the one-block and the
#: cluster route of ``kernel_route``
WARM_NODES = (2, 1025)


def warm_up(device: DeviceLike = None) -> None:
    """One small solve on each kernel route a sidecar's solves take on
    ``device``, with a staging from host arrays and a delta scatter on
    the way, before a solver serves: the first launch of each kernel
    loads its module and the first call of each torch op on the solve
    path loads its kernels, which a respawned sidecar's first request
    would otherwise pay under its client's deadline. Launches count as
    any other (``LAUNCHES``)."""
    device = resolve_device(device)
    for n in WARM_NODES:
        alloc = np.zeros((n, 8), np.int32)
        alloc[:, :2] = (16000, 32768)
        zeros = np.zeros_like(alloc)
        host = dict(alloc=alloc, used_req=zeros, usage=zeros,
                    prod_usage=zeros, est_extra=zeros, prod_base=zeros,
                    metric_fresh=np.ones(n, bool), schedulable=np.ones(n, bool))
        state = NodeState(**{f: _put(host[f], device)
                             for f in STAGED_NODE_FIELDS})
        state = scatter_node_rows(
            state, torch.zeros(1, dtype=torch.int64, device=device),
            {f: _put(host[f][:1], device) for f in STAGED_NODE_FIELDS},
            in_place=True)
        req = np.zeros((1, 8), np.int32)
        req[0, 0] = 100
        pods = PodBatch.build(req=_put(req, device), est=_put(req, device),
                              is_prod=_put(np.zeros(1, bool), device),
                              is_daemonset=_put(np.zeros(1, bool), device))
        weights = np.zeros(8, np.int32)
        weights[:2] = 1
        params = ScoreParams(weights=_put(weights, device),
                             thresholds=_put(np.full(8, 100, np.int32),
                                             device),
                             prod_thresholds=_put(np.zeros(8, np.int32),
                                                  device))
        result, _ = _dispatch_solve(state, pods, params, SolverConfig(),
                                    None, None, None, None, None, True, True,
                                    True)
        _host(result.assign)


class NodeStateCache:
    """Per-(connection, tenant) staged node state for the delta protocol.

    A full request carrying ``node_delta["epoch"]`` establishes the base:
    the host arrays (the eligibility checks read them) and the staged
    ``NodeState`` on ``device``. A delta request patches both: the host
    rows by assignment, the staged ones by ``scatter_node_rows``. The
    generation rule is the staging cache's (``StagedStateCache.pin``):
    while a solve holds the staged state (:meth:`pin`), the scatter
    writes a new generation beside it; otherwise in place.

    Every cache is a resident of the HBM working set
    (``state/workingset.WORKING_SET``), registered with its tenant's QoS
    lane and fair-share weight and dropped on :meth:`close`. Under
    pressure it demotes to the host rung (the staged state dropped, the
    host rows kept: the next delta stages them again in :meth:`apply`)
    or cold (the host rows dropped too: the next delta gets the typed
    ``delta-base-mismatch`` and the client re-establishes). Both rungs
    rebuild the rows the base carried, so answers are the same. A
    demotion refuses a cache mid-patch (its lock held) or one whose
    generation a solve holds (pinned), since the scatter writes in
    place."""

    def __init__(self, device: DeviceLike = None, tenant: str = "default",
                 lane: str = "ls", weight: float = 1.0):
        self.device = resolve_device(device)
        self.host: Optional[Dict[str, np.ndarray]] = None
        self.state: Optional[NodeState] = None
        self.epoch: Optional[int] = None
        self._pinned: Optional[NodeState] = None
        self._lock = threading.Lock()
        self._ws_key = WORKING_SET.register_auto(
            "base", self, tenant=tenant, lane=lane, weight=weight)

    def device_bytes(self) -> int:
        """Bytes of the staged generations held (the working-set price):
        the current one and a pinned one beside it."""
        state, pinned = self.state, self._pinned
        gens = [state] + ([pinned] if pinned is not None
                          and pinned is not state else [])
        return int(sum(t.nbytes for g in gens if g is not None
                       for t in g if t is not None))

    def demote_device(self) -> bool:
        """-> host: drop the staged state, keep the host rows. False when
        the cache is busy or pinned, or holds no staged state."""
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if self.state is None or self._pinned is not None:
                return False
            self.state = None
            return True
        finally:
            self._lock.release()

    def demote_cold(self) -> bool:
        """-> cold: drop the host rows too. The epoch survives, so the
        client's next delta fails the base check (typed mismatch, then a
        full re-send)."""
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if self._pinned is not None:
                return False
            if self.host is None and self.state is None:
                return False
            self.host = None
            self.state = None
            return True
        finally:
            self._lock.release()

    def establish(self, node_group, state: NodeState, epoch: int) -> None:
        with self._lock:
            self.host = {f: np.array(node_group[f], copy=True)
                         for f in STAGED_NODE_FIELDS}
            self.state = state
            self.epoch = epoch
        WORKING_SET.touch(self._ws_key)

    def apply(self, delta) -> NodeState:
        """Patch the base with the delta's rows; returns the staged state
        of the new epoch. A host-rung base is staged again first, under
        the working set's admission and retry ladder."""
        with self._lock:
            if self.state is None:
                host = self.host
                self.state = WORKING_SET.run_staged(
                    self._ws_key, "stage",
                    lambda: NodeState(**{f: _put(host[f], self.device)
                                         for f in STAGED_NODE_FIELDS}),
                    estimate=int(sum(host[f].nbytes
                                     for f in STAGED_NODE_FIELDS)))
            idx = np.asarray(delta["idx"], np.int64)
            if idx.size:
                rows = {f: np.asarray(delta[f]) for f in STAGED_NODE_FIELDS}
                for f in STAGED_NODE_FIELDS:
                    self.host[f][idx] = rows[f]
                base = self.state
                # the second allocation boundary: an injected failure
                # raises before the scatter runs, and an in-place scatter
                # retried after a real one writes the same rows again
                self.state = WORKING_SET.run_staged(
                    self._ws_key, "scatter",
                    lambda: scatter_node_rows(
                        base, torch.as_tensor(idx, device=self.device),
                        {f: _put(rows[f], self.device) for f in rows},
                        in_place=base is not self._pinned))
            self.epoch = int(np.asarray(delta["epoch"]).item())
            state = self.state
        WORKING_SET.touch(self._ws_key)
        return state

    def pin(self, state: Optional[NodeState]) -> None:
        """``state`` is read by a solve that has not been read back."""
        with self._lock:
            self._pinned = state

    def unpin(self, state: Optional[NodeState]) -> None:
        with self._lock:
            if self._pinned is state:
                self._pinned = None

    def close(self) -> None:
        """Drop the base (the connection is gone) and its working-set
        entry."""
        with self._lock:
            self.host = self.state = self._pinned = None
        WORKING_SET.drop(self._ws_key)


def _state_group(cls, group, device):
    """A NamedTuple-of-tensors feature state from its wire group (fields
    absent on the wire stay None)."""
    if group is None:
        return None
    return cls(**{f: (_put(group[f], device) if f in group else None)
                  for f in cls._fields})


def compact_extras(mask: np.ndarray, score: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense ``[P,N]`` extras as compact rows ``(row_of_pod [P], mask
    [X,N], score [X,N])``: pods with equal (mask, score) rows share one,
    and a pod whose row is all feasible with score 0 has none (-1)."""
    mask = np.ascontiguousarray(mask, bool)
    score = np.ascontiguousarray(score, np.int32)
    p = mask.shape[0]
    if p == 0:
        return (np.zeros(0, np.int32), np.zeros((0,) + mask.shape[1:], bool),
                np.zeros((0,) + score.shape[1:], np.int32))
    trivial = mask.all(axis=1) & (score == 0).all(axis=1)
    keyed = np.concatenate([mask.view(np.uint8),
                            score.view(np.uint8).reshape(p, -1)], axis=1)
    row_of_pod = np.full(p, -1, np.int32)
    keep = np.flatnonzero(~trivial)
    if keep.size == 0:
        return row_of_pod, mask[:0], score[:0]
    _, first, inverse = np.unique(keyed[keep], axis=0, return_index=True,
                                  return_inverse=True)
    row_of_pod[keep] = inverse.reshape(-1)
    return row_of_pod, mask[keep[first]], score[keep[first]]


#: the sidecar's kernel solve, adopted into the warm pool: its program is
#: ``solve_program``, shared with the model's and the failover twin's
_jit_solve = DEVICE_OBS.bind("sidecar_solve_batch", solve_program)
WARM_POOL.adopt(_jit_solve, config_argpos=3)


def _dispatch_solve(state, pods, params, config, quota, gang, extras, resv,
                    numa, resv_score_safe: bool, extras_score_safe: bool,
                    params_ok: bool, binding=None):
    """Eligible solves go to the kernel ``kernel_route`` names (the same
    routing as the in-process model) through ``binding`` (the sidecar's
    unless given); the rest take the loop ``solve_batch``. A kernel
    failure raises to the caller, which answers with a typed error.
    Returns ``(result, "kernel" | "loop")``."""
    if params_ok and kernel_routing_ok(state, pods, extras, resv,
                                       resv_score_safe, numa,
                                       extras_score_safe):
        return run_solve(
            _jit_solve if binding is None else binding, state, pods,
            params, quota, gang, numa, resv, extras,
            config.numa_most_allocated), "kernel"
    return solve_batch(state, pods, params, config, quota, gang, extras,
                       resv, numa), "loop"


def trace_args(req: SolveRequest) -> Optional[Dict[str, int]]:
    """The wire trace context as span args (None when the client sent
    none; malformed scalars are skipped)."""
    group = req.trace
    if not group:
        return None
    out: Dict[str, int] = {}
    for key in ("round", "span"):
        if key in group:
            try:
                out[key] = int(np.asarray(group[key]).item())
            except (TypeError, ValueError):
                pass
    return out or None


def solve_from_request(req: SolveRequest,
                       config: SolverConfig = SolverConfig(),
                       node_cache: Optional[NodeStateCache] = None,
                       device: DeviceLike = None) -> SolveResponse:
    """Run one batched solve from wire arrays (the handler's body) on
    ``device`` (the node cache's when one is given, else ``cuda`` unless
    named). The optional groups map onto ``solve_batch``'s feature
    states; a wire config overrides ``config``. ``node_cache`` serves
    the delta protocol. Any failure, a kernel's included, is answered
    with ``SolveResponse.error``."""
    # the sidecar's "round" is a solve: an armed profiler window wraps
    # the next K requests (one flag read when no window is in play)
    DEVICE_OBS.on_round()
    t_solve = TRACER.now()
    try:
        device = (node_cache.device if node_cache is not None
                  else resolve_device(device))
        delta = req.node_delta
        node_host = req.node
        pinned = None
        if delta is not None and "idx" in delta:
            base = int(np.asarray(delta["base_epoch"]).item())
            if (node_cache is None or node_cache.host is None
                    or node_cache.epoch != base):
                have = None if node_cache is None else node_cache.epoch
                return SolveResponse(
                    assignments=np.empty(0, np.int32),
                    error=(f"delta-base-mismatch: server holds epoch "
                           f"{have}, request expects {base}"))
            state = pinned = node_cache.apply(delta)
            node_host = node_cache.host
        else:
            def stage():
                return NodeState(
                    **{f: _put(req.node[f], device) for f in NODE_FIELDS},
                    **{f: _put(req.node[f], device)
                       for f in ("numa_cap", "numa_free") if f in req.node})

            if node_cache is not None:
                # a full staging is the first allocation boundary:
                # headroom first, then the demote-and-retry ladder
                state = WORKING_SET.run_staged(
                    node_cache._ws_key, "stage", stage,
                    estimate=int(sum(np.asarray(req.node[f]).nbytes
                                     for f in NODE_FIELDS)))
            else:
                state = stage()
            if (delta is not None and "epoch" in delta
                    and node_cache is not None
                    and "numa_cap" not in req.node):  # numa restages in full
                node_cache.establish(
                    req.node, state, int(np.asarray(delta["epoch"]).item()))
                pinned = state
        pods = PodBatch.build(**{f: _put(req.pods[f], device)
                                 for f in POD_FIELDS if f in req.pods})
        params = ScoreParams(**{f: _put(req.params[f], device)
                                for f in ScoreParams._fields})
        if req.config is not None:
            config = decode_config(req.config)
        resv = _state_group(ResvArrays, req.resv, device)
        resv_safe = True
        worst = BASE_SCORE_WORST
        if req.resv is not None:
            alloc = np.asarray(node_host["alloc"])
            resv_safe = kernel_resv_score_safe(req.resv["node"],
                                               req.resv["free"], alloc)
            worst = resv_score_worst(req.resv["node"], req.resv["free"],
                                     alloc)
        extras = None
        extras_safe = True
        if req.extras is not None:
            row_of_pod, xmask, xscore = compact_extras(req.extras["mask"],
                                                       req.extras["score"])
            extras = ExtrasRows(row_of_pod=_put(row_of_pod, device),
                                mask=_put(xmask, device),
                                score=_put(xscore, device))
            extras_safe = kernel_extras_score_safe(xscore, worst)
        if pinned is not None:
            node_cache.pin(pinned)
        try:
            result, _ = _dispatch_solve(
                state, pods, params, config,
                _state_group(QuotaState, req.quota, device),
                _state_group(GangState, req.gang, device),
                extras, resv, _state_group(NumaAux, req.numa, device),
                resv_safe, extras_safe,
                wire_kernel_supported(req.params, config))
            # the sidecar's half of the round trip, tagged with the wire
            # trace context so it joins the scheduler's trace
            TRACER.emit("sidecar_solve", cat="sidecar", t0=t_solve,
                        args=trace_args(req))
            return SolveResponse(
                assignments=_host(result.assign),
                node_used_req=_host(result.node_state.used_req),
                commit=_host(result.commit),
                waiting=_host(result.waiting),
                rejected=_host(result.rejected),
                raw_assign=_host(result.raw_assign),
                resv_vstar=_host(result.resv_vstar),
                resv_delta=_host(result.resv_delta),
            )
        finally:
            if pinned is not None:
                node_cache.unpin(pinned)
    except Exception as e:  # the boundary returns errors, never crashes
        return SolveResponse(assignments=np.empty(0, np.int32),
                             error=f"{type(e).__name__}: {e}")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        stream = self.request.makefile("rwb")
        server = self.server
        server.active_connections.add(self.request)
        #: per-connection delta bases, one per tenant, LRU by dict order
        node_caches: Dict[str, NodeStateCache] = {}
        try:
            secret = server.shared_secret
            if secret is not None:
                # cap the pre-auth frame: an unauthenticated peer cannot
                # make the server buffer a large frame
                try:
                    hello = read_frame(stream, max_frame=4096)
                except (ValueError, EOFError, OSError):
                    return
                if hello is None or not hmac.compare_digest(hello, secret):
                    return  # unauthenticated peer: dropped before any solve
            while True:
                try:
                    payload = read_frame(stream)
                except (EOFError, ValueError, OSError):
                    return  # a dead or hostile peer, not a server fault
                if payload is None:
                    return
                entry = None
                try:
                    request = decode_request(payload)
                except Exception as e:
                    response = SolveResponse(
                        assignments=np.empty(0, np.int32),
                        error=f"decode failed: {type(e).__name__}: {e}")
                else:
                    tenant = request_tenant(request)
                    node_cache = node_caches.pop(tenant, None)
                    if node_cache is None:
                        # the working set wants the QoS lane and the
                        # fair-share weight: best-effort tenants demote
                        # first, heavier tenants last
                        gate = server.admission_gate
                        node_cache = NodeStateCache(
                            server.device, tenant=tenant,
                            lane=LANE_NAMES[request_lane(request)],
                            weight=(1.0 if gate is None
                                    else gate.tenants.weight(tenant)))
                        while len(node_caches) >= MAX_CONNECTION_TENANTS:
                            node_caches.pop(next(iter(node_caches))).close()
                    node_caches[tenant] = node_cache
                    gate = server.admission_gate
                    if gate is None:
                        response = solve_from_request(
                            request, server.solver_config, node_cache)
                    else:
                        entry = gate.submit(request, server.solver_config,
                                            node_cache)
                        response = entry.wait()
                try:
                    try:
                        write_frame(stream, encode_response(response))
                        stream.flush()
                    except OSError:
                        return  # the peer left before the reply landed
                finally:
                    if entry is not None:
                        entry.delivered()
        finally:
            for cache in node_caches.values():
                cache.close()
            server.active_connections.discard(self.request)
            stream.close()


class PlacementService:
    """The sidecar server on ``device`` (``cuda`` unless given): a UDS
    path, or a ``(host, port)`` for TCP (trusted networks only unless
    ``secret`` is set).

    ``admission`` is True (the gate at its defaults), an
    :class:`AdmissionConfig`, or False (inline solves on the handler
    threads). ``tenants`` is the pool's ``TenantRegistry``."""

    def __init__(self, address, config: SolverConfig = SolverConfig(),
                 secret: Optional[bytes] = None, admission=True,
                 tenants=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.address = address
        if isinstance(address, str):
            # a dead predecessor leaves its socket file behind: unlink it
            # iff nothing is accepting there
            if os.path.exists(address):
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    probe.connect(address)
                except OSError:
                    os.unlink(address)
                else:
                    probe.close()
                    raise OSError(f"address in use: {address}")
            server_cls = type(
                "_UnixServer", (socketserver.ThreadingUnixStreamServer,),
                {"daemon_threads": True, "request_queue_size": 64})
        else:
            server_cls = type(
                "_TCPServer", (socketserver.ThreadingTCPServer,),
                {"daemon_threads": True, "allow_reuse_address": True,
                 "request_queue_size": 64})
        self._server = server_cls(address, _Handler)
        self._server.solver_config = config
        self._server.shared_secret = secret
        self._server.device = self.device
        self._server.active_connections = set()
        if admission:
            gate_cfg = (admission if isinstance(admission, AdmissionConfig)
                        else AdmissionConfig())
            self.gate: Optional[AdmissionGate] = AdmissionGate(
                functools.partial(solve_from_request, device=self.device),
                gate_cfg,
                peer_count=self._server.active_connections.__len__,
                tenants=tenants, device=self.device)
        else:
            self.gate = None
        self._server.admission_gate = self.gate
        self._thread: Optional[threading.Thread] = None
        # the warm pool: a service built without a cmd entry point
        # configures it from the environment (empty: inert); an active
        # pool installs its entries before the first solve (unless an
        # entry point restored it already: its report stays the last)
        # and keeps persisting new signatures (a persister it started,
        # it stops)
        WARM_POOL.ensure_configured()
        self._persister = False
        if WARM_POOL.active:
            if WARM_POOL.last_restore is None:
                WARM_POOL.restore(compile_missing=False)
            self._persister = WARM_POOL.start_background()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def status(self) -> dict:
        """The address served, live connections, the solve device and the
        kernel launches so far, the admission gate's stats, the device
        observatory's status, the HBM working-set ledger, the warm pool,
        and what of the reference's status is not ported."""
        return {
            "address": self.address,
            "active_connections": len(self._server.active_connections),
            "solve_device": str(self.device),
            "kernel_launches": dict(LAUNCHES),
            "admission": None if self.gate is None else self.gate.stats(),
            "device": DEVICE_OBS.status(),
            "workingset": WORKING_SET.status(),
            "warm_pool": WARM_POOL.status(),
            "not_ported": ["kernel_breaker (a kernel failure is a typed "
                           "error response)", "preemption"],
        }

    def stop(self) -> None:
        # drain the gate first: queued requests get a typed shutting-down
        # frame before the connections are severed
        if self.gate is not None:
            self.gate.shutdown()
            self.gate.wait_delivered(timeout=2.0)
        if self._thread is not None:
            # waits for serve_forever to return: only once it was started
            self._server.shutdown()
        for conn in list(self._server.active_connections):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._persister:
            WARM_POOL.stop_background()
            self._persister = False
