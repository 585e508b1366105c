"""Streaming serving mode: continuous arrivals, adaptively-fired rounds
(a copy of ``koordinator_tpu/scheduler/streaming.py`` over the port's
Scheduler, pipeline, trace and series).

``run_loop`` fires ``schedule_pending`` on a fixed cadence. A production
scheduler serving heavy traffic sees a CONTINUOUS pod stream, and the
metric that matters is per-pod submit→bind latency at a sustained
arrival rate. This module is the front end for that:

- **QoS-laned intake** (:class:`ArrivalGate`). Pods arrive on an
  open-loop process into three lanes — ``system`` > ``ls`` > ``be``,
  the same mapping as the solver sidecar's admission gate — each lane carrying a *latency target*: the deadline by which a
  queued pod should be in a firing round. The intake is bounded:
  past ``capacity``, best-effort entries are shed first (an arriving
  higher-lane pod evicts the newest queued entry of the lowest lane
  strictly below it; an arrival that outranks nothing is itself
  refused, typed and counted — never silence).

- **Adaptive round triggering.** A round fires when EITHER the queued
  batch reaches the ``watermark`` (a burst amortizes into one
  dispatch instead of fragmenting into tiny ones) OR the oldest
  queued pod's lane deadline arrives (a lone urgent pod does not wait
  out a fixed cadence), whichever comes first. This is the tunable
  latency-vs-batch-efficiency trade; the trigger decides *when*
  rounds fire, never *what* they decide — replaying the same arrival
  batches through the fixed-cadence loop is bit-identical by
  construction (property-tested).

- **The round body is unchanged.** A fired round runs the existing
  ``begin_tick``/``commit_tick`` split — through a
  :class:`~koordinator_tpu_torch.scheduler.pipeline.TickPipeline` when
  pipelined (solve N in flight while arrivals land, publish off the
  critical path) or the serial composition otherwise. Placement
  semantics, epilogues, publish fencing: all shared code.

- **Every submitted pod resolves.** ``bound`` when its bind publishes
  (the timeline closes — ``scheduler_pod_e2e_seconds`` is the
  headline histogram), ``shed-capacity`` when refused/evicted at
  intake, ``deadline-exceeded`` when ``max_pod_rounds`` retries are
  exhausted. Outcome accounting is the zero-silent-drop invariant:
  submitted == bound + shed + expired + in-flight.

Concurrency: handler/submitter threads call :meth:`StreamingLoop.
submit`; the loop thread (or a test's :meth:`StreamingLoop.pump`)
fires rounds; the pipeline's publisher thread resolves outcomes.
``ArrivalGate``'s mutable state is guarded by its condition; the loop's
own bookkeeping by ``_lock``. The gate lock never nests inside any other
lock of the loop.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from koordinator_tpu_torch.metrics.components import (
    ROUNDS_SKIPPED,
    STREAM_ARRIVALS,
    STREAM_BATCH_PODS,
    STREAM_QUEUE_DEPTH,
    STREAM_SHED,
    STREAM_TRIGGERS,
)
from koordinator_tpu_torch.obs.timeline import LANES, lane_of
from koordinator_tpu_torch.obs.trace import TRACER

#: lane indices, mirroring service/admission (system > ls > be)
LANE_BY_NAME = {name: i for i, name in enumerate(LANES)}

#: terminal outcomes
OUTCOME_BOUND = "bound"
OUTCOME_SHED = "shed-capacity"
OUTCOME_EXPIRED = "deadline-exceeded"


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Trigger + intake tuning.

    ``watermark`` is the batch-size trigger: a round fires as soon as
    this many arrivals are queued. ``lane_deadline_s`` is the per-lane
    latency target (system, ls, be): the oldest queued pod's
    ``submit + lane deadline`` is the deadline trigger. The two
    together are the whole policy — watermark bounds dispatch
    amortization from below, deadlines bound queue wait from above.

    ``capacity`` bounds queued arrivals (shed past it, BE first);
    ``max_pod_rounds`` bounds how many rounds an unplaceable pod
    retries before resolving ``deadline-exceeded`` (0 = retry forever
    — the production default: capacity frees as churn evicts);
    ``idle_wake_s`` is the periodic backstop that re-fires a round
    while the scheduler still holds pending pods the intake no longer
    tracks (gang WaitTime releases, externally-applied pods);
    ``min_round_interval_s`` floors the inter-round gap so a trickle
    of deadline-armed singletons cannot drive the dispatch rate
    unboundedly (0 = no floor)."""

    watermark: int = 64
    lane_deadline_s: Tuple[float, float, float] = (0.002, 0.010, 0.050)
    capacity: int = 4096
    max_pod_rounds: int = 0
    idle_wake_s: float = 0.25
    min_round_interval_s: float = 0.0


class _Entry:
    __slots__ = ("uid", "lane", "submitted_at", "deadline_at",
                 "rounds_seen", "seq")

    def __init__(self, uid: str, lane: int, submitted_at: float,
                 deadline_at: float, seq: int = 0):
        self.uid = uid
        self.lane = lane
        self.submitted_at = submitted_at
        self.deadline_at = deadline_at
        self.rounds_seen = 0
        #: admission ordinal — the bus APPLICATION order, which the
        #: round log preserves so a fixed-round replay re-applies
        #: arrivals in exactly the order the pending queue saw them
        self.seq = seq


class ArrivalGate:
    """The QoS-laned, deadline-armed, bounded streaming intake.

    Pure bookkeeping — it never touches the bus or the scheduler; the
    :class:`StreamingLoop` owns those side effects. Every mutable
    attribute below is read and written under ``_lock`` (a Condition,
    shared with the loop's trigger wait).
    """

    def __init__(self, config: StreamingConfig = StreamingConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 shed_hook: Optional[Callable] = None):
        self.cfg = config
        self._clock = clock
        #: optional (lane_name, reason, uid) callback fired OUTSIDE the
        #: lock for every shed/expired resolution — the loop wires the
        #: pod-timeline registry's failure fold here so the rolling
        #: stats surface sees the failure tail beside the survivor p99
        self._shed_hook = shed_hook
        self._lock = threading.Condition()
        #: per-lane FIFO of queued entries (arrival order per lane)
        self._lanes: List[deque] = [deque() for _ in LANES]
        self._by_uid: Dict[str, _Entry] = {}
        #: uid -> entry taken into the currently-firing round
        self._inflight: Dict[str, _Entry] = {}
        #: uid -> entry held at a gang Permit barrier (no deadline —
        #: a waiting pod fires no rounds; its siblings' arrivals do)
        self._waiting: Dict[str, _Entry] = {}
        #: terminal outcome per uid, bounded (oldest evicted)
        self._resolved: "deque" = deque(maxlen=8192)
        self._resolved_map: Dict[str, str] = {}
        self._stats = {
            "submitted": 0, "bound": 0, "shed_capacity": 0,
            "expired": 0, "timeline_dropped": 0,
        }
        self._seq = 0

    # -- intake (submitter threads) -----------------------------------------

    def admit(self, uid: str, lane: int,
              now: Optional[float] = None) -> Tuple[str, Optional[str]]:
        """Admit one arrival. Returns ``("queued", evicted_uid|None)``
        or ``("shed", None)`` — the caller applies the bus side
        effects (apply the admitted pod, delete the evicted one) and
        publishes the typed refusal."""
        at = self._clock() if now is None else now
        deadline = at + self.cfg.lane_deadline_s[lane]
        victim: Optional[_Entry] = None
        refused = False
        with self._lock:
            self._stats["submitted"] += 1
            queued = len(self._by_uid)
            if queued >= self.cfg.capacity:
                victim = self._pick_victim(lane)
                if victim is None:
                    refused = True
                    self._stats["shed_capacity"] += 1
                    self._resolve_locked(uid, OUTCOME_SHED)
                else:
                    self._by_uid.pop(victim.uid, None)
                    # _pick_victim always chose a lane TAIL: pop() is
                    # O(1) where remove() would scan the whole lane
                    # under the gate lock on the overload hot path
                    self._lanes[victim.lane].pop()
                    self._stats["shed_capacity"] += 1
                    self._resolve_locked(victim.uid, OUTCOME_SHED)
            if not refused:
                self._seq += 1
                entry = _Entry(uid, lane, at, deadline, seq=self._seq)
                self._by_uid[uid] = entry
                self._lanes[lane].append(entry)
                self._lock.notify_all()
            depths = self._depths_locked()
        # metric publishing rides OUTSIDE the gate lock (the admission
        # gate's _publish_depth discipline): registries have their own
        # locks and must never nest inside this one
        self._publish_depths(depths)
        if refused:
            STREAM_SHED.inc({"lane": LANES[lane], "reason": "capacity"})
            if self._shed_hook is not None:
                self._shed_hook(LANES[lane], "capacity", uid)
            return "shed", None
        STREAM_ARRIVALS.inc({"lane": LANES[lane]})
        if victim is not None:
            STREAM_SHED.inc({"lane": LANES[victim.lane],
                             "reason": "capacity"})
            if self._shed_hook is not None:
                self._shed_hook(LANES[victim.lane], "capacity", victim.uid)
        return "queued", victim.uid if victim is not None else None

    def _pick_victim(self, lane: int) -> Optional[_Entry]:
        """Overload eviction (call under ``_lock``): newest queued
        entry of the lowest-priority non-empty lane strictly below the
        arrival — the admission gate's policy applied at the
        scheduler's front door."""
        for shed_lane in (LANE_BY_NAME["be"], LANE_BY_NAME["ls"]):
            if shed_lane <= lane:
                continue
            if self._lanes[shed_lane]:
                return self._lanes[shed_lane][-1]
        return None

    def note_timeline_drop(self, uid: str) -> None:
        """The pod timeline registry refused a sample at capacity
        (obs/timeline.py). The pod still schedules — but the refusal
        is BACKPRESSURE, so it lands in the shed accounting (reason
        ``timeline-capacity``) instead of vanishing into a silent
        counter."""
        with self._lock:
            entry = self._by_uid.get(uid)
            lane = entry.lane if entry is not None else LANE_BY_NAME["ls"]
            self._stats["timeline_dropped"] += 1
        STREAM_SHED.inc({"lane": LANES[lane],
                         "reason": "timeline-capacity"})

    # -- knob retuning (an SLO controller) ------------------------------------

    def retune(self, watermark: Optional[int] = None,
               lane_deadline_s: Optional[Tuple[float, float, float]] = None,
               capacity: Optional[int] = None) -> StreamingConfig:
        """Replace the trigger/intake knobs live (an SLO controller's
        actuator; the reference's ``control/slo.py`` is not ported yet).
        The config object is frozen, so a retune swaps in a
        ``dataclasses.replace`` copy under the gate lock — every reader
        already takes ``self.cfg`` under ``_lock``.

        A lane-deadline change re-stamps every QUEUED entry's
        ``deadline_at`` by the per-lane delta: entries were stamped
        ``t_i + old`` with a monotone clock, so a uniform shift to
        ``t_i + new`` preserves the per-lane deadline monotonicity the
        O(1) head-min trigger depends on. In-flight/waiting entries
        keep their stamps (their next requeue uses the new constant).
        Wakes a parked loop: a tightened deadline or lowered watermark
        may be due NOW."""
        with self._lock:
            old = self.cfg
            fields = {}
            if watermark is not None:
                fields["watermark"] = int(watermark)
            if lane_deadline_s is not None:
                fields["lane_deadline_s"] = tuple(lane_deadline_s)
            if capacity is not None:
                fields["capacity"] = int(capacity)
            if not fields:
                return old
            cfg = dataclasses.replace(old, **fields)
            if lane_deadline_s is not None:
                for lane, q in enumerate(self._lanes):
                    delta = (cfg.lane_deadline_s[lane]
                             - old.lane_deadline_s[lane])
                    if delta:
                        for e in q:
                            e.deadline_at += delta
            self.cfg = cfg
            self._lock.notify_all()
        return cfg

    def note_bound(self, uid: str) -> None:
        """A bind for a tracked pod landed on the bus from OUTSIDE this
        gate's own round resolution — the HA case: a standby's gate
        tracks the watch-fed intake while the leader places it.
        Queued/Permit-waiting entries resolve ``bound`` (the submission
        succeeded cluster-wide); an IN-FLIGHT entry is left alone — it
        belongs to this seat's firing round and resolves exactly once
        through :meth:`resolve_round`."""
        with self._lock:
            e = self._by_uid.pop(uid, None)
            if e is not None:
                try:
                    self._lanes[e.lane].remove(e)
                except ValueError:
                    pass
            elif uid in self._waiting:
                self._waiting.pop(uid)
            elif uid in self._inflight:
                return
            else:
                return
            self._stats["bound"] += 1
            self._resolve_locked(uid, OUTCOME_BOUND)
            depths = self._depths_locked()
        self._publish_depths(depths)

    # -- triggering ----------------------------------------------------------

    def due(self, now: Optional[float] = None) -> Optional[str]:
        """The trigger decision: ``"watermark"`` | ``"deadline"`` |
        None (nothing fires yet). Watermark outranks deadline in the
        report (both may hold at once). O(1): each lane's deque is
        deadline-ordered (every append stamps ``now + lane constant``
        with a monotone clock — requeues included), so the lane head
        carries the lane minimum."""
        at = self._clock() if now is None else now
        with self._lock:
            if len(self._by_uid) >= self.cfg.watermark:
                return "watermark"
            for q in self._lanes:
                if q and q[0].deadline_at <= at:
                    return "deadline"
        return None

    def next_deadline(self) -> Optional[float]:
        """The earliest queued deadline (the loop's wake-up time);
        None when nothing is queued. O(1) — see :meth:`due`."""
        with self._lock:
            heads = [q[0].deadline_at for q in self._lanes if q]
        return min(heads) if heads else None

    def wait_for_work(self, timeout: Optional[float],
                      depth: Optional[int] = None) -> None:
        """Park the loop until the queued depth CHANGES from ``depth``
        (an arrival landed — it may have crossed the watermark) or
        ``timeout`` passes. ``depth=None`` means "wait only while
        empty"."""
        with self._lock:
            if depth is None:
                if self._by_uid:
                    return
            elif len(self._by_uid) != depth:
                return
            self._lock.wait(timeout)

    def wake(self) -> None:
        """Nudge a parked loop (shutdown, config pokes)."""
        with self._lock:
            self._lock.notify_all()

    def take_round(self) -> List[_Entry]:
        """Claim every queued entry into the firing round (lane
        priority order, FIFO within a lane)."""
        with self._lock:
            batch: List[_Entry] = []
            for q in self._lanes:
                while q:
                    batch.append(q.popleft())
            for e in batch:
                self._by_uid.pop(e.uid, None)
                self._inflight[e.uid] = e
            depths = self._depths_locked()
        self._publish_depths(depths)
        return batch

    # -- round resolution (loop / publisher thread) -------------------------

    def resolve_round(self, result, now: Optional[float] = None
                      ) -> Dict[str, int]:
        """Fold one round's :class:`ScheduleResult` into outcomes:
        placed in-flight entries resolve ``bound``; entries the gang
        Permit barrier holds move to ``waiting``; unplaced entries
        requeue with a fresh lane deadline (or expire past
        ``max_pod_rounds``). Returns ``{bound, waiting, requeued,
        expired}`` counts."""
        at = self._clock() if now is None else now
        counts = {"bound": 0, "waiting": 0, "requeued": 0, "expired": 0}
        expired: List[_Entry] = []
        with self._lock:
            # a previously-waiting pod whose gang completed reports as
            # a committed placement in a later round's result
            for uid in list(self._waiting):
                node = result.get(uid)
                if node is not None and uid not in result.waiting:
                    e = self._waiting.pop(uid)
                    self._stats["bound"] += 1
                    self._resolve_locked(uid, OUTCOME_BOUND)
                    counts["bound"] += 1
            # a QUEUED entry the result covers: in pipelined mode round
            # N+1's batch is taken BEFORE round N retires, so a pod
            # round N's resolution requeued can be placed by round N+1
            # (whose snapshot spans ALL pending pods) while it sits in
            # the queue — without this scan its bound outcome would be
            # missed and the entry would leak in-flight forever
            for uid in list(self._by_uid):
                if uid not in result:
                    continue
                e = self._by_uid[uid]
                node = result[uid]
                if uid in result.waiting:
                    self._pop_queued_locked(e)
                    self._waiting[uid] = e
                    counts["waiting"] += 1
                elif node is not None:
                    self._pop_queued_locked(e)
                    self._stats["bound"] += 1
                    self._resolve_locked(uid, OUTCOME_BOUND)
                    counts["bound"] += 1
                # unplaced: stays queued with its existing deadline
            for uid, e in list(self._inflight.items()):
                if uid not in result:
                    continue  # not in this round (should not happen)
                self._inflight.pop(uid)
                node = result[uid]
                if uid in result.waiting:
                    self._waiting[uid] = e
                    counts["waiting"] += 1
                elif node is not None:
                    self._stats["bound"] += 1
                    self._resolve_locked(uid, OUTCOME_BOUND)
                    counts["bound"] += 1
                else:
                    e.rounds_seen += 1
                    if (self.cfg.max_pod_rounds
                            and e.rounds_seen >= self.cfg.max_pod_rounds):
                        self._stats["expired"] += 1
                        self._resolve_locked(uid, OUTCOME_EXPIRED)
                        expired.append(e)
                        counts["expired"] += 1
                    else:
                        e.deadline_at = at + self.cfg.lane_deadline_s[e.lane]
                        self._by_uid[uid] = e
                        self._lanes[e.lane].append(e)
                        counts["requeued"] += 1
            depths = self._depths_locked()
        for e in expired:
            STREAM_SHED.inc({"lane": LANES[e.lane], "reason": "deadline"})
            if self._shed_hook is not None:
                self._shed_hook(LANES[e.lane], "deadline-exceeded", e.uid)
        self._publish_depths(depths)
        return counts

    def requeue_taken(self, entries: List[_Entry],
                      now: Optional[float] = None) -> None:
        """A fired round FAILED (typed solver outage, fencing abort):
        its taken entries go back to the queue unharmed — the pods are
        still pending on the bus, the next round re-solves them."""
        at = self._clock() if now is None else now
        with self._lock:
            for e in entries:
                self._inflight.pop(e.uid, None)
                if e.uid in self._by_uid:
                    continue
                e.deadline_at = at + self.cfg.lane_deadline_s[e.lane]
                self._by_uid[e.uid] = e
                self._lanes[e.lane].append(e)
            depths = self._depths_locked()
            self._lock.notify_all()
        self._publish_depths(depths)

    def _pop_queued_locked(self, e: "_Entry") -> None:
        """Remove a queued entry from its lane + index (call under
        ``self._lock``)."""
        self._by_uid.pop(e.uid, None)
        try:
            self._lanes[e.lane].remove(e)
        except ValueError:
            pass

    def forget(self, uid: str) -> None:
        """A tracked pod vanished (deleted/evicted on the bus): drop
        it from intake bookkeeping without an outcome — the deletion
        is its own resolution."""
        with self._lock:
            e = self._by_uid.pop(uid, None)
            if e is not None:
                self._lanes[e.lane].remove(e)
            self._inflight.pop(uid, None)
            self._waiting.pop(uid, None)

    # -- read side -----------------------------------------------------------

    def _resolve_locked(self, uid: str, outcome: str) -> None:
        if len(self._resolved) == self._resolved.maxlen:
            old = self._resolved[0]
            self._resolved_map.pop(old, None)
        self._resolved.append(uid)
        self._resolved_map[uid] = outcome

    def outcome(self, uid: str) -> Optional[str]:
        """Terminal outcome for ``uid`` (None while still in flight or
        unknown/evicted-from-the-ring)."""
        with self._lock:
            return self._resolved_map.get(uid)

    def tracks(self, uid: str) -> bool:
        """Whether ``uid`` is ACTIVELY tracked — queued, in a firing
        round, or Permit-waiting. Deliberately excludes the resolved
        history: a pod deleted and re-created under the same
        namespace/name (the ordinary k8s recreate flow) is a NEW
        arrival and must re-enter the intake, not be skipped because
        its predecessor once resolved."""
        with self._lock:
            return (uid in self._by_uid or uid in self._inflight
                    or uid in self._waiting)

    def _depths_locked(self) -> List[int]:
        return [len(q) for q in self._lanes]

    @staticmethod
    def _publish_depths(depths: List[int]) -> None:
        for i, n in enumerate(depths):
            STREAM_QUEUE_DEPTH.set(n, {"lane": LANES[i]})

    def depth(self) -> int:
        with self._lock:
            return len(self._by_uid)

    def unresolved(self) -> int:
        """Entries not yet terminally resolved (queued + in-flight +
        Permit-waiting) — 0 when every submitted pod has an outcome."""
        with self._lock:
            return (len(self._by_uid) + len(self._inflight)
                    + len(self._waiting))

    def status(self) -> dict:
        with self._lock:
            return {
                "depth": {
                    LANES[i]: len(q) for i, q in enumerate(self._lanes)
                },
                "inflight": len(self._inflight),
                "waiting_permit": len(self._waiting),
                "capacity": self.cfg.capacity,
                "watermark": self.cfg.watermark,
                "lane_deadline_s": list(self.cfg.lane_deadline_s),
                "submitted": self._stats["submitted"],
                "bound": self._stats["bound"],
                "shed": {
                    "capacity": self._stats["shed_capacity"],
                    "deadline-exceeded": self._stats["expired"],
                    # backpressure, not a drop: the pod scheduled but
                    # its latency sample was refused at capacity
                    "timeline-capacity": self._stats["timeline_dropped"],
                },
            }


class StreamingLoop:
    """The adaptive serving loop over a wired scheduler.

    ``apply_fn(pod)`` lands an admitted arrival on the bus (the wiring
    wraps ``bus.apply``); ``delete_fn(uid)`` removes a shed victim /
    expired pod. ``pipelined=True`` builds a
    :class:`~koordinator_tpu_torch.scheduler.pipeline.TickPipeline` owned by
    this loop (rounds overlap; outcomes resolve on the publisher
    thread); otherwise rounds run the serial
    ``scheduler.schedule_pending`` inline.

    Two drive modes: :meth:`run` (a real thread pacing itself on the
    trigger — production/bench) and :meth:`pump` (single-step with an
    injected ``now`` — the fake-clock determinism tests). Both share
    :meth:`fire_round`, so the tested trigger ordering IS the served
    one."""

    def __init__(self, scheduler, apply_fn: Callable,
                 delete_fn: Optional[Callable] = None,
                 config: StreamingConfig = StreamingConfig(),
                 pipelined: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 now_fn: Callable[[], float] = time.time,
                 auditor=None, log: Callable = print):
        self.scheduler = scheduler
        # the timeline registry's failure fold (obs/timeline.py): every
        # shed/expired resolution lands in the same rolling stats
        # surface the survivor percentiles come from
        _timelines = getattr(scheduler, "timelines", None)
        shed_hook = getattr(_timelines, "note_shed", None)
        self.gate = ArrivalGate(config, clock=clock, shed_hook=shed_hook)
        self._apply = apply_fn
        self._delete = delete_fn
        self._clock = clock
        self._now_fn = now_fn
        self._auditor = auditor
        self._log = log
        self._lock = threading.Lock()
        self._rounds = 0
        self._skipped = 0
        self._last_trigger: Optional[str] = None
        self._last_fired_at: Optional[float] = None
        #: bounded per-round batch log: (trigger, now, uid tuple) —
        #: what the bit-identity replay (the property test, chip_smoke
        #: phase 15) re-drives through the fixed-round loop
        self.round_log: deque = deque(maxlen=4096)
        self._stopped = threading.Event()
        #: set while no run() invocation is active — stop() waits on it
        #: so the pipeline is never torn down under a mid-round loop
        #: (run() may execute on a caller's thread, not only _thread)
        self._run_done = threading.Event()
        self._run_done.set()
        self._thread: Optional[threading.Thread] = None
        self.pipeline = None
        self._hooked_backend = None
        self._prev_flip = self._prev_degraded = None
        #: HA composition: when an elector is attached the
        #: trigger loop fires rounds only while the lease is held; a
        #: promoted standby adopts the watch-fed intake + knob state
        self._elector = None
        self._prev_started = None
        #: an SLO controller (any object with ``maybe_reconcile(now=)``;
        #: ``on_promoted()`` and ``decisions_total()`` are called when it
        #: has them): when attached, the loop drives its reconcile cadence
        self._controller = None
        if pipelined:
            from koordinator_tpu_torch.scheduler.pipeline import TickPipeline

            self.pipeline = TickPipeline(
                scheduler, log=log,
                on_result=self._on_round_result,
            )
            # failover flips quiesce the pipeline (run_loop's contract): the epoch reset / full restage a flip
            # triggers must never race an in-flight tick's retire.
            # Originals restored on stop() — a re-wired scheduler must
            # not chain into a stopped loop's pipeline.
            backend = getattr(getattr(scheduler, "model", None),
                              "backend", None)
            if backend is not None and hasattr(backend, "on_flip_back"):
                self._hooked_backend = backend
                self._prev_flip = backend.on_flip_back

                def _flip_back(prev=self._prev_flip, p=self.pipeline):
                    p.drain("failover-flip", raise_deferred=False)
                    if prev is not None:
                        prev()

                backend.on_flip_back = _flip_back
                if hasattr(backend, "on_flip_degraded"):
                    self._prev_degraded = backend.on_flip_degraded

                    def _flip_degraded(prev=self._prev_degraded,
                                       p=self.pipeline):
                        p.drain("failover-flip", raise_deferred=False)
                        if prev is not None:
                            prev()

                    backend.on_flip_degraded = _flip_degraded
        # a pod deleted/evicted on the bus must leave intake
        # bookkeeping too; the scheduler's remove path already forgets
        # the timeline — chain the gate's forget beside it
        self._prev_remove = scheduler.remove_pod

        def _remove_pod(pod, _prev=self._prev_remove):
            _prev(pod)
            self.gate.forget(pod.uid)

        scheduler.remove_pod = _remove_pod
        # backpressure wiring: the timeline registry's capacity
        # refusals land in the gate's shed accounting
        timelines = getattr(scheduler, "timelines", None)
        if timelines is not None and hasattr(timelines, "set_drop_hook"):
            timelines.set_drop_hook(self.gate.note_timeline_drop)

    @property
    def cfg(self) -> StreamingConfig:
        """The LIVE trigger/intake config. The gate owns the object —
        an SLO controller retunes it through :meth:`ArrivalGate.
        retune` — so the loop reads through rather than caching the
        construction-time copy."""
        return self.gate.cfg

    # -- HA composition (lease gate + promotion handoff) ---------------------

    def attach_elector(self, elector) -> None:
        """Fold the ``--leader-elect`` lease gate into the trigger
        loop: rounds fire only while ``elector.tick`` reports the
        lease held; a standby parks (draining deferred pipeline
        errors) and a promotion adopts the watch-fed intake + the
        controller's knob state via the chained
        ``on_started_leading``."""
        self._elector = elector
        self._prev_started = elector.on_started_leading

        def _promoted(_prev=self._prev_started):
            if _prev is not None:
                _prev()
            self.on_promoted()

        elector.on_started_leading = _promoted

    def attach_controller(self, controller) -> None:
        """Attach an SLO controller: the loop drives its reconcile
        cadence (leader-only under HA) and a promotion adopts the
        published knob state before the first post-failover round."""
        self._controller = controller

    def on_promoted(self) -> None:
        """Lease acquired: inherit the previous leader's convergence
        (knob state published on the bus) FIRST — the adopted deadlines
        govern how the swept intake re-arms — then sweep pending pods
        the watch fed while standby into the gate."""
        on_promoted = getattr(self._controller, "on_promoted", None)
        if on_promoted is not None:
            on_promoted()
        self.adopt_intake()

    def adopt_intake(self, now: Optional[float] = None) -> int:
        """Admit every pending pod the scheduler cache holds that the
        gate does not already track (idempotent: ``observe`` skips
        tracked uids, so a watch-fed standby whose gate mirrored every
        arrival adopts zero). Returns the number adopted."""
        adopted = 0
        for pod in list(self.scheduler.cache.pending.values()):
            if self.gate.tracks(pod.uid):
                continue
            self.observe(pod, now=now)
            adopted += 1
        return adopted

    def _lease_held(self, now: Optional[float] = None) -> bool:
        """Tick the lease gate (no elector = always leading). A tick
        both renews a held lease and attempts acquisition on an
        expired one — promotion fires inside it."""
        if self._elector is None:
            return True
        return self._elector.tick(
            self._now_fn() if now is None else now
        )

    def _standby_step(self) -> None:
        """Lease held elsewhere: fire nothing, but surface deferred
        publish-side errors the pipeline may still hold from the
        rounds fired while leading (run_loop's standby discipline) —
        a fencing abort forgets assumed-but-unbound pods."""
        from koordinator_tpu_torch.client.leaderelection import FencingError

        if self.pipeline is None:
            return
        try:
            self.pipeline.drain("standby")
        except FencingError as e:
            forgotten = self.scheduler.forget_assumed_unbound()
            self._log(f"streaming standby: fenced publish surfaced: "
                      f"{e}; forgot {len(forgotten)} assumed pod(s)")

    # -- intake --------------------------------------------------------------

    def submit(self, pod, now: Optional[float] = None) -> str:
        """One open-loop arrival: admit (or shed) and land on the bus.
        Returns ``"queued"`` or ``"shed"`` — a shed pod never touches
        the bus, so the refusal is typed at the front door."""
        lane = LANE_BY_NAME[lane_of(pod)]
        verdict, evicted = self.gate.admit(pod.uid, lane, now=now)
        if evicted is not None and self._delete is not None:
            # the victim was already on the bus: evict it (DELETED
            # re-enters Scheduler.remove_pod → timeline forgotten)
            self._delete(evicted)
        if verdict == "queued":
            self._apply(pod)
        return verdict

    def observe(self, pod, now: Optional[float] = None) -> None:
        """Intake for a pending pod ANOTHER component applied to the
        bus (the wiring's watch routes them here): it is already in
        the scheduler's queue, so a shed verdict evicts it back off
        the bus — typed and observed, never a silent drop."""
        if self.gate.tracks(pod.uid):
            return  # loop.submit() already admitted it
        lane = LANE_BY_NAME[lane_of(pod)]
        verdict, evicted = self.gate.admit(pod.uid, lane, now=now)
        if evicted is not None and self._delete is not None:
            self._delete(evicted)
        if verdict == "shed" and self._delete is not None:
            self._delete(pod.uid)

    def observe_bound(self, pod) -> None:
        """A bind for ``pod`` landed on the bus (the wiring's watch
        routes assigned-pod events here). Resolves a queued/waiting
        gate entry ``bound`` — the HA standby's accounting: its
        watch-fed intake mirrors every arrival, and the LEADER's bind
        must resolve the mirror or the entry would leak unresolved
        forever. A uid in this loop's own firing round is left to
        :meth:`ArrivalGate.resolve_round` (exactly-once outcomes)."""
        self.gate.note_bound(pod.uid)

    # -- firing --------------------------------------------------------------

    def due(self, now: Optional[float] = None) -> Optional[str]:
        """The loop's trigger decision (gate triggers + the idle
        backstop + the min-interval floor)."""
        at = self._clock() if now is None else now
        with self._lock:
            last = self._last_fired_at
        if (last is not None and self.cfg.min_round_interval_s
                and at - last < self.cfg.min_round_interval_s):
            return None
        reason = self.gate.due(at)
        if reason is not None:
            return reason
        # backstop: pods pending in the scheduler but INVISIBLE to the
        # intake (gang WaitTime releases, pods applied before the loop
        # wired) — while the gate tracks anything, its own deadlines
        # govern and the backstop stays quiet
        if self.gate.depth() == 0 \
                and (last is None or at - last >= self.cfg.idle_wake_s) \
                and self.scheduler.cache.pending:
            return "idle"
        return None

    def fire_round(self, reason: str,
                   now: Optional[float] = None) -> List:
        """Fire one adaptively-triggered round through the shared tick
        machinery. Returns the taken arrival entries (requeued on a
        typed round failure)."""
        from koordinator_tpu_torch.client.leaderelection import FencingError
        from koordinator_tpu_torch.service.client import (
            SolverOverloaded,
            SolverUnavailable,
        )

        at = self._clock() if now is None else now
        bus_now = self._now_fn()
        if self._auditor is not None:
            if self.pipeline is not None and self._auditor.sweep_due():
                self.pipeline.drain("auditor-sweep")
            self._auditor.on_round(now=bus_now)
        batch = self.gate.take_round()
        STREAM_TRIGGERS.inc({"reason": reason})
        STREAM_BATCH_PODS.observe(len(batch))
        with self._lock:
            self._rounds += 1
            self._last_trigger = reason
            self._last_fired_at = at
            self.round_log.append((
                reason, bus_now,
                # admission (= bus application) order, NOT the lane-
                # priority claim order: the replay re-applies these in
                # the order the pending queue originally saw them
                tuple(e.uid for e in sorted(batch, key=lambda e: e.seq)),
            ))
        try:
            if self.pipeline is not None:
                self.pipeline.submit_round(now=bus_now, trigger=reason)
                self.pipeline.prestage(now=bus_now)
            else:
                out = self.scheduler.schedule_pending(now=bus_now,
                                                      trigger=reason)
                self._on_round_result(out)
        except (SolverUnavailable, SolverOverloaded) as e:
            with self._lock:
                self._skipped += 1
            ROUNDS_SKIPPED.inc({
                "reason": "solver-overloaded"
                if isinstance(e, SolverOverloaded)
                else "solver-unavailable"
            })
            self.gate.requeue_taken(batch, now=at)
            self._log(f"streaming round skipped: {e}")
        except FencingError as e:
            with self._lock:
                self._skipped += 1
            ROUNDS_SKIPPED.inc({"reason": "leadership-lost"})
            forgotten = self.scheduler.forget_assumed_unbound()
            self.gate.requeue_taken(batch, now=at)
            self._log(f"streaming round fenced: {e}; forgot "
                      f"{len(forgotten)} assumed-but-unbound pod(s)")
        except BaseException:
            # an UNTYPED failure (a deferred publish-side bug surfacing
            # at this round boundary, a stopped pipeline) still fails
            # loudly — but the taken batch goes back first, or its
            # entries would leak in-flight forever and break the
            # zero-silent-drop accounting
            self.gate.requeue_taken(batch, now=at)
            raise
        return batch

    def _on_round_result(self, result) -> None:
        """Round retired (publisher thread in pipelined mode, inline
        otherwise): fold outcomes, evict expired pods from the bus."""
        counts = self.gate.resolve_round(result)
        if counts["expired"] and self._delete is not None:
            for uid, node in result.items():
                if node is None and uid not in result.waiting \
                        and self.gate.outcome(uid) == OUTCOME_EXPIRED:
                    self._delete(uid)

    # -- drive modes ---------------------------------------------------------

    def pump(self, now: Optional[float] = None,
             drain: bool = True) -> Optional[str]:
        """Deterministic single step (fake-clock tests): fire at most
        one round if the trigger is due at ``now``; with ``drain``,
        wait the pipelined round out so outcomes are resolved on
        return. Returns the trigger reason or None. Under HA the step
        first ticks the lease gate — a standby pumps nothing (and
        surfaces deferred publish errors); the tick itself is the
        acquisition path, so a pump on an expired lease IS the
        promotion."""
        if not self._lease_held(now):
            self._standby_step()
            return None
        if self._controller is not None:
            self._controller.maybe_reconcile(now=now)
        reason = self.due(now)
        if reason is None:
            return None
        self.fire_round(reason, now=now)
        if drain and self.pipeline is not None:
            self.pipeline.drain("streaming-pump")
        return reason

    def run(self) -> None:
        """The serving loop body (blocks; use :meth:`start` for a
        thread). Paces itself on the trigger: sleeps to the earliest
        queued deadline, wakes early on arrivals (watermark), fires,
        repeats."""
        monitor = getattr(self.scheduler, "monitor", None)
        self._run_done.clear()
        try:
            self._run_body(monitor)
        finally:
            self._run_done.set()

    def _run_body(self, monitor) -> None:
        while not self._stopped.is_set():
            now = self._clock()
            if monitor is not None:
                monitor.check_stuck()
            if not self._lease_held():
                # standby: hold no rounds, keep the intake watch-fed,
                # retry on the elector's cadence (wake early on stop)
                self._standby_step()
                self._stopped.wait(self._elector.retry_period)
                continue
            if self._controller is not None:
                self._controller.maybe_reconcile(now=now)
            reason = self.due(now)
            if reason is not None:
                self.fire_round(reason, now=now)
                continue
            deadline = self.gate.next_deadline()
            if deadline is None:
                timeout = self.cfg.idle_wake_s
            else:
                timeout = max(0.0, deadline - now)
                if self.cfg.min_round_interval_s:
                    with self._lock:
                        last = self._last_fired_at
                    if last is not None:
                        floor = (last + self.cfg.min_round_interval_s
                                 - now)
                        timeout = max(timeout, floor)
            # parks on the gate condition keyed to the CURRENT depth:
            # an arrival notifies, so a watermark-crossing burst fires
            # immediately instead of waiting out the old deadline
            self.gate.wait_for_work(
                min(timeout, self.cfg.idle_wake_s),
                depth=self.gate.depth(),
            )

    def start(self) -> "StreamingLoop":
        self._thread = threading.Thread(
            target=self.run, daemon=True, name="koord-streaming"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        self.gate.wake()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # run() may be executing on a CALLER's thread (run_loop's
        # streaming branch): wait it out before tearing the pipeline
        # down under a mid-round loop. Idempotent second stops sail
        # through (the event is set whenever no run() is active).
        self._run_done.wait(timeout=10.0)
        if self._hooked_backend is not None:
            self._hooked_backend.on_flip_back = self._prev_flip
            if hasattr(self._hooked_backend, "on_flip_degraded"):
                self._hooked_backend.on_flip_degraded = \
                    self._prev_degraded
            self._hooked_backend = None
        if self.pipeline is not None:
            try:
                self.pipeline.drain("streaming-stop",
                                    raise_deferred=False)
            finally:
                self.pipeline.stop()
        # unchain the remove_pod hook: a re-wired scheduler must not
        # keep forgetting into a stopped loop's gate
        self.scheduler.remove_pod = self._prev_remove
        # unchain the promotion hook likewise — a later promotion of
        # this elector must not adopt into a stopped loop
        if self._elector is not None:
            self._elector.on_started_leading = self._prev_started
            self._elector = None
        timelines = getattr(self.scheduler, "timelines", None)
        if timelines is not None and hasattr(timelines, "set_drop_hook"):
            timelines.set_drop_hook(None)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Fire rounds until every tracked arrival resolves (or the
        wall timeout passes). Benches/tests call this after the last
        submission; returns True when fully drained. While the loop
        THREAD is running it stays the only round-firer (submit_round
        is coordinator-side single-threaded): this just wakes it and
        waits."""
        deadline = time.monotonic() + timeout_s
        running = self._thread is not None and self._thread.is_alive()
        while time.monotonic() < deadline:
            if not running and self.pipeline is not None:
                self.pipeline.drain("streaming-drain")
            if self.gate.unresolved() == 0 \
                    and not self.scheduler.cache.pending:
                if self.pipeline is not None:
                    # the last round may still be retiring: outcomes
                    # resolve on the publisher, so wait it out
                    self.pipeline.drain("streaming-drain")
                    if self.gate.unresolved() != 0 \
                            or self.scheduler.cache.pending:
                        continue
                return True
            if running:
                self.gate.wake()
                time.sleep(0.002)
            elif self.gate.depth() or self.scheduler.cache.pending:
                self.fire_round("idle")
            else:
                time.sleep(0.001)
        return self.gate.unresolved() == 0 \
            and not self.scheduler.cache.pending

    # -- read side -----------------------------------------------------------

    def status(self) -> dict:
        """Debug-mux payload (registered as ``streaming``): intake
        depths + shed accounting, trigger counters, and the rolling
        submit→bind p50/p99 the serving mode is judged on."""
        with self._lock:
            rounds = self._rounds
            skipped = self._skipped
            last = self._last_trigger
        out = {
            "rounds": rounds,
            "rounds_skipped": skipped,
            "last_trigger": last,
            "gate": self.gate.status(),
        }
        if self._elector is not None:
            out["leader"] = self._elector.is_leader()
        decisions = getattr(self._controller, "decisions_total", None)
        if decisions is not None:
            out["slo"] = {"decisions": decisions()}
        timelines = getattr(self.scheduler, "timelines", None)
        if timelines is not None:
            # the headline serving numbers: rolling-window submit→bind
            # percentiles + the dropped-sample backpressure counter
            out["latency"] = timelines.status()
        return out
