"""Admission gate: the QoS-laned, deadline-aware micro-batching front end
of the solver sidecar (counterpart of
``koordinator_tpu/service/admission.py``).

Every solve passes through a bounded priority queue drained by one
executor thread:

- **Lanes.** Three FIFO lanes in strict priority order, ``system`` >
  ``ls`` > ``be`` (apis/extension.QoSClass). A request's lane rides the
  wire ``admission`` group; absent means ``ls``.
- **Deadlines.** ``deadline_s`` is the caller's remaining budget; a
  request still queued when it runs out is answered with a typed
  ``deadline-exceeded`` error.
- **Shedding.** Past ``AdmissionConfig.capacity`` best-effort work is
  shed first: an arrival evicts the newest entry of the lowest lane
  strictly below it whose tenant is over its fair share (or is the
  arrival's own tenant); an arrival that outranks nothing is refused.
  Both get a typed ``overloaded`` error.
- **Coalescing and tenant lanes.** Plain requests of one tenant with a
  byte-identical base (:func:`coalesce_key`) and plain or delta requests
  of any tenant in one shape bucket (``tenancy.shape_bucket_key``) are
  claimed into one batch, weighted-fair across tenants. Both become one
  launch of the placement kernel with a lane per request
  (``ops/binpack_kernel.binpack_lanes``): one shared base for a coalesced
  batch (:func:`solve_coalesced`), a base per lane for a tenant batch
  (``tenancy.solve_entry_lanes``). Lanes are bit-identical to solving
  each request alone.

Observability: the gate publishes the reference's series
(``SOLVER_QUEUE_DEPTH``, ``SOLVER_ADMISSION_SHED``,
``SOLVER_ADMISSION_WAIT``, ``SOLVER_SOLVE_DURATION``,
``SOLVER_ADMISSION_BATCHES``, ``SOLVER_ADMISSION_REQUESTS`` in
``metrics/components.SOLVER_METRICS``, served by the solver's
``--debug-port``) and records a ``queue_wait`` span per request and an
``admission_dispatch`` span per batch, tagged with the wire ``trace``
group; :meth:`AdmissionGate.stats` carries the same counters.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.metrics.components import (
    SOLVER_ADMISSION_BATCHES,
    SOLVER_ADMISSION_REQUESTS,
    SOLVER_ADMISSION_SHED,
    SOLVER_ADMISSION_WAIT,
    SOLVER_QUEUE_DEPTH,
    SOLVER_SOLVE_DURATION,
)
from koordinator_tpu_torch.obs.device import DEVICE_OBS
from koordinator_tpu_torch.obs.trace import TRACER
from koordinator_tpu_torch.ops.binpack import (
    STAGED_NODE_FIELDS,
    SolverConfig,
)
from koordinator_tpu_torch.ops.binpack_kernel import (
    lanes_assign_program,
    lanes_program,
)
from koordinator_tpu_torch.service.codec import SolveRequest, SolveResponse
from koordinator_tpu_torch.service.tenancy import (
    DEFAULT_TENANT,
    MAX_TRACKED_TENANTS,
    OVERFLOW_TENANT,
    TenantRegistry,
    allocate_fair_lanes,
    decode_config,
    delta_shape_key,
    fair_share,
    plain_request,
    request_tenant,
    shape_bucket_key,
    solve_entry_lanes,
    solve_lanes,
    wire_state,
)
from koordinator_tpu_torch.service.warmpool import WARM_POOL

# -- lanes ------------------------------------------------------------------

LANE_SYSTEM = 0
LANE_LS = 1
LANE_BE = 2
LANE_NAMES = ("system", "ls", "be")
LANE_BY_NAME = {name: i for i, name in enumerate(LANE_NAMES)}

# -- typed shed/overload errors (SolveResponse.error prefixes) --------------

ERR_OVERLOADED = "overloaded"
ERR_DEADLINE = "deadline-exceeded"
ERR_SHUTDOWN = "shutting-down"
ERR_INTERNAL = "internal"


def lane_for_qos(qos: QoSClass) -> int:
    """QoSClass -> admission lane (system > latency-sensitive > BE)."""
    if qos == QoSClass.SYSTEM:
        return LANE_SYSTEM
    if qos == QoSClass.BE:
        return LANE_BE
    return LANE_LS


def error_response(kind: str, detail: str) -> SolveResponse:
    """A typed error frame; ``kind`` is the prefix the client reads."""
    return SolveResponse(
        assignments=np.empty(0, np.int32), error=f"{kind}: {detail}"
    )


def request_lane(req: SolveRequest) -> int:
    """The wire lane code, latency-sensitive when absent or bad."""
    adm = req.admission
    if not adm or "lane" not in adm:
        return LANE_LS
    try:
        lane = int(np.asarray(adm["lane"]).item())
    except (TypeError, ValueError):
        return LANE_LS
    return lane if 0 <= lane < len(LANE_NAMES) else LANE_LS


def request_deadline_s(req: SolveRequest) -> Optional[float]:
    adm = req.admission
    if not adm or "deadline_s" not in adm:
        return None
    try:
        d = float(np.asarray(adm["deadline_s"]).item())
    except (TypeError, ValueError):
        return None
    return d if d >= 0 else 0.0


# -- coalescing -------------------------------------------------------------

def coalesce_key(req: SolveRequest) -> Optional[bytes]:
    """Full-state fingerprint of a plain request (the reference's bytes),
    or None when it must ride solo: equal keys mean byte-identical
    staged bases, params, config and pod schema, and the same tenant."""
    if not plain_request(req):
        return None
    h = hashlib.blake2b(digest_size=16)
    h.update(b"tenant:")
    h.update(request_tenant(req).encode("utf-8"))

    def feed(tag: str, a: np.ndarray) -> None:
        h.update(tag.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())

    for f in STAGED_NODE_FIELDS:
        feed(f, np.asarray(req.node[f]))
    for f in sorted(req.params):
        feed("s." + f, np.asarray(req.params[f]))
    if req.config is not None:
        for f in sorted(req.config):
            feed("c." + f, np.asarray(req.config[f]))
    for f in sorted(req.pods):
        # pod schema only: the values differ per caller
        a = np.asarray(req.pods[f])
        h.update(("p." + f).encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape[1:]).encode())
    return h.digest()


def coalesce_pod_bucket(p: int) -> int:
    """The reference's coalesced pod-axis bucket (next power of two, floor
    8), kept for API parity: the port pads a batch only to its largest
    request."""
    return max(8, 1 << max(0, p - 1).bit_length())


#: the gate's coalesced lane solves (one base every lane reads), adopted
#: into the warm pool
_jit_coalesced = DEVICE_OBS.bind("coalesced_solve", lanes_program)
_jit_coalesced_assign = DEVICE_OBS.bind("coalesced_solve_assign",
                                        lanes_assign_program)
WARM_POOL.adopt(_jit_coalesced, config_argpos=1)
WARM_POOL.adopt(_jit_coalesced_assign, config_argpos=1)


def solve_coalesced(
    requests: Sequence[SolveRequest],
    config: Optional[SolverConfig] = SolverConfig(),
    want_state: bool = False,
    device: DeviceLike = None,
) -> List[SolveResponse]:
    """Solve K same-base plain requests as one lane-batched launch against
    the head's base (one upload, read by every lane) and split the
    results back per caller; each response equals ``solve_from_request``
    of that request alone. ``want_state=True`` adds each lane's final
    ``node_used_req``."""
    device = resolve_device(device)
    head = requests[0]
    if head.config is not None:
        config = decode_config(head.config)
    elif config is None:
        config = SolverConfig()
    return solve_lanes([wire_state(head.node, device)],
                       [r.pods for r in requests],
                       [head.params] * len(requests), config, want_state,
                       device, (_jit_coalesced_assign, _jit_coalesced))


# -- the gate ---------------------------------------------------------------

def _publish_depth(depths: Dict[str, List[int]]) -> None:
    """Per-(lane, tenant) depth gauges from a snapshot taken under the
    gate lock; tenants with nothing queued publish zeros, so a drained
    tenant's series falls back to 0."""
    for tenant, lanes in depths.items():
        for i, n in enumerate(lanes):
            SOLVER_QUEUE_DEPTH.set(n, {"lane": LANE_NAMES[i],
                                       "tenant": tenant})


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Gate sizing (the reference's defaults). ``capacity`` bounds the
    queued entries across lanes; ``max_coalesce`` caps requests per batch
    (1 disables batching); ``max_coalesced_pods`` caps a batch's summed
    pods; ``coalesce_window_s`` is how long a batchable head lingers for
    stragglers; ``tenant_lanes`` lets different tenants' requests of one
    shape bucket share a batch."""

    capacity: int = 128
    max_coalesce: int = 16
    max_coalesced_pods: int = 4096
    coalesce_window_s: float = 0.010
    tenant_lanes: bool = True


class AdmissionEntry:
    """One queued request: the handler thread parks on :meth:`wait`
    while the executor (or the shed path) fills :attr:`response`."""

    __slots__ = (
        "request", "config", "node_cache", "lane", "deadline",
        "enqueued_at", "key", "pods_n", "response", "_done", "_gate",
        "tenant", "shape_key", "trace_t0",
    )

    def __init__(self, request, config, node_cache, lane, deadline,
                 key, pods_n, enqueued_at, gate, tenant=DEFAULT_TENANT,
                 shape_key=None):
        self.request = request
        self.config = config
        self.node_cache = node_cache
        self.lane = lane
        self.deadline = deadline
        self.enqueued_at = enqueued_at
        self.key = key
        self.pods_n = pods_n
        self.tenant = tenant
        self.shape_key = shape_key
        self.response: Optional[SolveResponse] = None
        self._done = threading.Event()
        self._gate = gate
        #: tracer-clock enqueue stamp (the gate's ``clock`` may be a
        #: test fake): the queue-wait span is emitted from it at dispatch
        self.trace_t0 = TRACER.now()

    def wait(self, timeout: Optional[float] = None) -> Optional[SolveResponse]:
        """Block until the gate answers (None only on timeout)."""
        self._done.wait(timeout)
        return self.response

    def finish(self, response: SolveResponse) -> None:
        self.response = response
        self._done.set()

    def delivered(self) -> None:
        """The handler wrote this entry's frame."""
        self._gate._mark_delivered()


class AdmissionGate:
    """The bounded, QoS-laned queue and its single executor thread.

    ``solve_fn(request, solver_config, node_cache) -> SolveResponse`` is
    the solo dispatch (the sidecar passes ``solve_from_request``);
    batches of two or more take :func:`solve_coalesced` (one tenant, one
    base) or ``tenancy.solve_entry_lanes`` (a base per lane) on
    ``device``. One thread launches every batch, so every launch and
    every delta scatter of a staged base is ordered on one stream.
    """

    def __init__(self, solve_fn: Callable,
                 config: AdmissionConfig = AdmissionConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 peer_count: Optional[Callable[[], int]] = None,
                 tenants: Optional[TenantRegistry] = None,
                 device: DeviceLike = None):
        self.cfg = config
        self.device = resolve_device(device)
        self._solve_fn = solve_fn
        self._clock = clock
        #: live-connection probe: with <= 1 peer nobody can coalesce, so
        #: the micro-batching window is skipped
        self._peer_count = peer_count
        self.tenants = tenants if tenants is not None else TenantRegistry()
        #: one Condition guards every mutable structure below
        self._lock = threading.Condition()
        self._lanes = [deque(), deque(), deque()]
        self._closed = False
        self._undelivered = 0
        self._stats = {
            "requests": 0, "batches": 0, "coalesced_requests": 0,
            "lane_batches": 0, "lane_requests": 0,
            "shed_overloaded": 0, "shed_deadline": 0, "shed_shutdown": 0,
            "solve_s": 0.0,
        }
        self._tenant_stats: Dict[str, Dict[str, int]] = {}
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="admission-gate"
        )
        self._thread.start()

    def _fold_tenant(self, tenant: str) -> str:
        """Past :data:`MAX_TRACKED_TENANTS` distinct ids, unregistered
        newcomers fold into :data:`OVERFLOW_TENANT` (under the lock)."""
        if tenant in self._tenant_stats:
            return tenant
        if len(self._tenant_stats) < MAX_TRACKED_TENANTS:
            return tenant
        if tenant in self.tenants.snapshot():
            return tenant
        return OVERFLOW_TENANT

    def _tstat(self, tenant: str) -> Dict[str, int]:
        row = self._tenant_stats.get(tenant)
        if row is None:
            row = self._tenant_stats[tenant] = {
                "requests": 0, "dispatched": 0, "coalesced": 0,
                "lane_batched": 0, "shed_overloaded": 0,
                "shed_deadline": 0, "shed_shutdown": 0,
            }
        return row

    def _depth_snapshot(self, only=None) -> Dict[str, List[int]]:
        """Per-(tenant, lane) queue depths (under the lock). ``only``
        restricts it to the named tenants: a submit publishes just the
        tenants it touched, the executor every tenant it has seen."""
        depths = {t: [0] * len(LANE_NAMES)
                  for t in (self._tenant_stats if only is None else only)}
        for i, q in enumerate(self._lanes):
            for e in q:
                if only is not None and e.tenant not in depths:
                    continue
                depths.setdefault(e.tenant, [0] * len(LANE_NAMES))
                depths[e.tenant][i] += 1
        return depths

    # -- enqueue (handler threads) -----------------------------------------

    def submit(self, request: SolveRequest, solver_config: SolverConfig,
               node_cache=None) -> AdmissionEntry:
        """Admit (or shed) one request; the returned entry's
        :meth:`AdmissionEntry.wait` always yields a response, typed error
        responses included."""
        now = self._clock()
        d = request_deadline_s(request)
        tenant = request_tenant(request)
        key = coalesce_key(request) if self.cfg.max_coalesce > 1 else None
        shape_key = None
        if self.cfg.max_coalesce > 1 and self.cfg.tenant_lanes:
            shape_key = shape_bucket_key(request)
            if shape_key is None:
                shape_key = delta_shape_key(request, node_cache)
        try:
            pods_n = int(np.asarray(request.pods["req"]).shape[0])
        except (KeyError, IndexError, AttributeError):
            pods_n = 0
        entry = AdmissionEntry(
            request, solver_config, node_cache, request_lane(request),
            None if d is None else now + d, key, pods_n, now, self,
            tenant=tenant, shape_key=shape_key,
        )
        victim: Optional[AdmissionEntry] = None
        rejected: Optional[str] = None
        with self._lock:
            self._undelivered += 1
            tenant = entry.tenant = self._fold_tenant(tenant)
            self._tstat(tenant)["requests"] += 1
            if self._closed:
                rejected = ERR_SHUTDOWN
            else:
                if sum(len(q) for q in self._lanes) >= self.cfg.capacity:
                    victim = self._pick_victim(entry)
                    if victim is None:
                        rejected = ERR_OVERLOADED
                if rejected is None:
                    self._lanes[entry.lane].append(entry)
                    self._lock.notify_all()
            if victim is not None:
                self._stats["shed_overloaded"] += 1
                self._tstat(victim.tenant)["shed_overloaded"] += 1
            elif rejected == ERR_OVERLOADED:
                self._stats["shed_overloaded"] += 1
                self._tstat(tenant)["shed_overloaded"] += 1
            elif rejected == ERR_SHUTDOWN:
                self._stats["shed_shutdown"] += 1
                self._tstat(tenant)["shed_shutdown"] += 1
            touched = {tenant}
            if victim is not None:
                touched.add(victim.tenant)
            depths = self._depth_snapshot(only=touched)
        _publish_depth(depths)
        if victim is not None:
            SOLVER_ADMISSION_SHED.inc(
                {"lane": LANE_NAMES[victim.lane], "reason": "overloaded",
                 "tenant": victim.tenant})
            victim.finish(error_response(
                ERR_OVERLOADED,
                f"queue full ({self.cfg.capacity}); shed for a "
                f"{LANE_NAMES[entry.lane]}-lane arrival",
            ))
        if rejected is not None:
            SOLVER_ADMISSION_SHED.inc(
                {"lane": LANE_NAMES[entry.lane],
                 "reason": ("shutdown" if rejected == ERR_SHUTDOWN
                            else "overloaded"),
                 "tenant": tenant})
            detail = (
                "sidecar stopping; request not solved"
                if rejected == ERR_SHUTDOWN
                else f"queue full ({self.cfg.capacity}) and no "
                     f"sheddable lower-priority entry (fair shares "
                     f"respected)"
            )
            entry.finish(error_response(rejected, detail))
        return entry

    def _pick_victim(self, entry: AdmissionEntry
                     ) -> Optional[AdmissionEntry]:
        """Newest entry of the lowest non-empty lane strictly below the
        arrival whose tenant is over its fair share or is the arrival's
        own; removed from its lane (under the lock)."""
        queued: Dict[str, int] = {}
        for q in self._lanes:
            for e in q:
                queued[e.tenant] = queued.get(e.tenant, 0) + 1
        weights = self.tenants.weights_for(set(queued) | {entry.tenant})
        shares = fair_share(self.cfg.capacity, weights)
        for shed_lane in (LANE_BE, LANE_LS):
            if shed_lane <= entry.lane:
                continue
            for victim in reversed(self._lanes[shed_lane]):
                if (victim.tenant == entry.tenant
                        or queued.get(victim.tenant, 0)
                        > shares.get(victim.tenant, 0)):
                    self._lanes[shed_lane].remove(victim)
                    return victim
        return None

    # -- drain (the executor thread) ---------------------------------------

    def _poll(self):
        """Block for work; returns ``(expired, batch)`` (batch is [] when
        everything claimable had expired), or None once closed."""
        with self._lock:
            while not self._closed and not any(self._lanes):
                self._lock.wait()
            if self._closed:
                return None
            now = self._clock()
            expired: List[AdmissionEntry] = []
            for q in self._lanes:
                if not q:
                    continue
                kept = deque()
                while q:
                    e = q.popleft()
                    if e.deadline is not None and e.deadline <= now:
                        expired.append(e)
                    else:
                        kept.append(e)
                q.extend(kept)
            batch: List[AdmissionEntry] = []
            for q in self._lanes:  # strict lane priority order
                if q:
                    batch.append(q.popleft())
                    break
            if batch and (batch[0].key is not None
                          or batch[0].shape_key is not None):
                head = batch[0]
                room = self.cfg.max_coalesced_pods - head.pods_n
                window = self.cfg.coalesce_window_s
                if self._peer_count is not None and self._peer_count() <= 1:
                    window = 0.0  # lone client: no one to wait for
                window_end = now + window
                hard_end = now + 3 * window  # a trickle can't stall forever
                while True:
                    before = len(batch)
                    room = self._claim_batch(head, batch, room)
                    if len(batch) >= self.cfg.max_coalesce or self._closed:
                        break
                    if (self._peer_count is not None
                            and len(batch) >= self._peer_count()):
                        # every connection already has its one request
                        # in this batch: nobody can join
                        break
                    if len(batch) > before:
                        window_end = min(hard_end, self._clock() + window)
                    remaining = window_end - self._clock()
                    if remaining <= 0:
                        break
                    self._lock.wait(remaining)
            if expired:
                self._stats["shed_deadline"] += len(expired)
                for e in expired:
                    self._tstat(e.tenant)["shed_deadline"] += 1
            depths = self._depth_snapshot()
        _publish_depth(depths)
        return expired, batch

    def _claim_batch(self, head: AdmissionEntry,
                     batch: List[AdmissionEntry], room: int) -> int:
        """Move every queued entry that can join ``head``'s batch (same
        coalesce key, or with ``tenant_lanes`` the same shape bucket)
        into ``batch``, weighted-fair across tenants; returns the pod
        room left (under the lock)."""
        budget = self.cfg.max_coalesce - len(batch)
        if budget <= 0:
            return room
        candidates: Dict[str, List[AdmissionEntry]] = {}
        for q in self._lanes:
            for e in q:
                same_base = e.key is not None and e.key == head.key
                same_bucket = (self.cfg.tenant_lanes
                               and e.shape_key is not None
                               and e.shape_key == head.shape_key)
                if same_base or same_bucket:
                    candidates.setdefault(e.tenant, []).append(e)
        if not candidates:
            return room
        preloaded: Dict[str, int] = {}
        for e in batch:
            preloaded[e.tenant] = preloaded.get(e.tenant, 0) + 1
        take = allocate_fair_lanes(
            candidates, self.tenants.weight, budget, room,
            lambda e: e.pods_n, preloaded,
        )
        for e in take:
            self._lanes[e.lane].remove(e)
            batch.append(e)
            room -= e.pods_n
        return room

    def _run(self) -> None:
        while True:
            try:
                polled = self._poll()
                if polled is None:
                    return
                expired, batch = polled
                for e in expired:
                    SOLVER_ADMISSION_SHED.inc(
                        {"lane": LANE_NAMES[e.lane], "reason": "deadline",
                         "tenant": e.tenant})
                    e.finish(error_response(
                        ERR_DEADLINE,
                        "request expired in the admission queue before "
                        "dispatch",
                    ))
                if batch:
                    self._dispatch(batch)
            except Exception as exc:  # the drainer must never die
                warnings.warn(
                    f"admission gate executor error: "
                    f"{type(exc).__name__}: {exc}",
                    RuntimeWarning,
                )

    def _dispatch(self, batch: List[AdmissionEntry]) -> None:
        # server imports this module at top level: the reverse edge is
        # imported here
        from koordinator_tpu_torch.service.server import trace_args

        t0 = self._clock()
        t_dispatch = TRACER.now()
        for e in batch:
            SOLVER_ADMISSION_WAIT.observe(
                max(0.0, t0 - e.enqueued_at),
                {"lane": LANE_NAMES[e.lane], "tenant": e.tenant})
            # the queue-wait span, joined to the caller's trace through
            # the wire trace context
            TRACER.emit("queue_wait", cat="admission", t0=e.trace_t0,
                        t1=t_dispatch,
                        args={"lane": LANE_NAMES[e.lane],
                              **(trace_args(e.request) or {})})
        # solo (one request, any feature set), coalesced (one tenant, one
        # shared base) or tenant lanes (a base per lane)
        if len(batch) == 1:
            mode = "solo"
        elif all(e.key is not None and e.key == batch[0].key
                 for e in batch):
            mode = "coalesced"
        else:
            mode = "lanes"
        try:
            if mode == "solo":
                e = batch[0]
                responses = [self._solve_fn(e.request, e.config,
                                            e.node_cache)]
            elif mode == "coalesced":
                responses = solve_coalesced(
                    [e.request for e in batch], batch[0].config,
                    device=self.device)
            else:
                responses = solve_entry_lanes(batch, batch[0].config,
                                              device=self.device)
        except Exception as exc:  # callers still get a typed frame
            responses = [
                error_response(ERR_INTERNAL, f"{type(exc).__name__}: {exc}")
            ] * len(batch)
        solve_s = max(0.0, self._clock() - t0)
        SOLVER_SOLVE_DURATION.observe(solve_s)
        TRACER.emit("admission_dispatch", cat="admission", t0=t_dispatch,
                    args={"coalesced": len(batch), "mode": mode,
                          **(trace_args(batch[0].request) or {})})
        SOLVER_ADMISSION_BATCHES.inc()
        SOLVER_ADMISSION_REQUESTS.inc({"mode": mode}, amount=len(batch))
        with self._lock:
            self._stats["batches"] += 1
            self._stats["requests"] += len(batch)
            self._stats["solve_s"] += solve_s
            if mode == "coalesced":
                self._stats["coalesced_requests"] += len(batch)
            elif mode == "lanes":
                self._stats["lane_batches"] += 1
                self._stats["lane_requests"] += len(batch)
            for e in batch:
                row = self._tstat(e.tenant)
                row["dispatched"] += 1
                if mode == "coalesced":
                    row["coalesced"] += 1
                elif mode == "lanes":
                    row["lane_batched"] += 1
        for e, r in zip(batch, responses):
            e.finish(r)

    # -- status / shutdown -------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Per-lane depth, coalesce ratio, shed counts and the per-tenant
        rows (the reference's status keys), and the seconds spent solving
        batches (what the reference observes into its solve-duration
        series)."""
        with self._lock:
            depth = {LANE_NAMES[i]: len(q) for i, q in enumerate(self._lanes)}
            s = dict(self._stats)
            closed = self._closed
            tenant_rows = {t: dict(row) for t, row in self._tenant_stats.items()}
            depths = self._depth_snapshot()
        weights = self.tenants.weights_for(tenant_rows)
        for t, row in tenant_rows.items():
            row["queued"] = sum(depths.get(t, ()))
            row["weight"] = weights[t]
        return {
            "queue_depth": depth,
            "capacity": self.cfg.capacity,
            "max_coalesce": self.cfg.max_coalesce,
            "tenant_lanes": self.cfg.tenant_lanes,
            "requests_total": s["requests"],
            "batches_total": s["batches"],
            "coalesced_requests_total": s["coalesced_requests"],
            "lane_batches_total": s["lane_batches"],
            "lane_requests_total": s["lane_requests"],
            "coalesce_ratio": (
                s["requests"] / s["batches"] if s["batches"] else 0.0
            ),
            "solve_seconds_total": s["solve_s"],
            "shed": {
                "overloaded": s["shed_overloaded"],
                "deadline-exceeded": s["shed_deadline"],
                "shutting-down": s["shed_shutdown"],
            },
            "tenants": tenant_rows,
            "closed": closed,
        }

    def shutdown(self, timeout: float = 5.0) -> List[AdmissionEntry]:
        """Fail every queued entry with a typed ``shutting-down`` error and
        stop the executor (an in-flight solve still answers its callers).
        Returns the failed entries."""
        with self._lock:
            self._closed = True
            drained = [e for q in self._lanes for e in q]
            for q in self._lanes:
                q.clear()
            self._stats["shed_shutdown"] += len(drained)
            for e in drained:
                self._tstat(e.tenant)["shed_shutdown"] += 1
            depths = self._depth_snapshot()
            self._lock.notify_all()
        _publish_depth(depths)
        for e in drained:
            SOLVER_ADMISSION_SHED.inc(
                {"lane": LANE_NAMES[e.lane], "reason": "shutdown",
                 "tenant": e.tenant})
            e.finish(error_response(
                ERR_SHUTDOWN, "sidecar stopping; request not solved"
            ))
        self._thread.join(timeout=timeout)
        return drained

    def wait_delivered(self, timeout: float = 2.0) -> bool:
        """Block (bounded) until every answered entry's frame was
        written by its handler."""
        deadline = self._clock() + timeout
        with self._lock:
            while self._undelivered > 0:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return False
                self._lock.wait(remaining)
            return True

    def _mark_delivered(self) -> None:
        with self._lock:
            self._undelivered -= 1
            if self._undelivered <= 0:
                self._lock.notify_all()
