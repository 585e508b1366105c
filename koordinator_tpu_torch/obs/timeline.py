"""Per-pod timelines: submit → staged → solved → published (counterpart
of ``koordinator_tpu/obs/timeline.py``).

Round-level histograms say how fast ROUNDS are; a latency-SLO serving
mode needs to know how fast PODS are — the wall time from a pod entering the pending
queue to its bind publishing on the bus, per QoS lane. This module
keeps a bounded registry of in-flight pod timelines, stamped at the
four scheduler-side lifecycle points:

- **submit**    — the pod entered the pending queue (``Scheduler.
  add_pod``; the in-process bus has no separate intake hop, so submit
  and enqueue collapse to one stamp here).
- **staged**    — a round's snapshot picked the pod up
  (``begin_tick``).
- **solved**    — the device solve placed it (``commit_tick`` — the
  epilogue's assume).
- **published** — the bind landed on the bus (the wiring's
  ``publish_result``). This closes the timeline: the e2e wall is
  observed into ``scheduler_pod_e2e_seconds{lane}`` and the record
  moves to a bounded completed ring that p50/p99 are read from.

A pod deleted or evicted while pending is ``forget``-ten without
observing — an abandoned submit is not a latency sample.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import QoSClass

#: lane names, mirroring service/admission.LANE_NAMES (not imported:
#: the timeline layer stays free of torch)
LANES = ("system", "ls", "be")


def lane_of(pod) -> str:
    """QoS lane label for a pod (system > latency-sensitive > BE) —
    the same mapping as service/admission.lane_for_qos."""
    qos = getattr(pod, "qos", None)
    if qos == QoSClass.SYSTEM:
        return "system"
    if qos == QoSClass.BE:
        return "be"
    return "ls"


class PodTimelines:
    """Bounded per-pod stage-stamp registry + completed-latency ring.

    ``histogram`` defaults to the global ``scheduler_pod_e2e_seconds``;
    tests inject their own (and a fake ``clock``) to check the observed
    buckets exactly. Every mutable attribute below is read and written
    under ``_lock``."""

    STAGES = ("submit", "staged", "solved", "published")

    def __init__(self, capacity: int = 8192,
                 completed_capacity: int = 4096,
                 clock=time.perf_counter, histogram=None):
        if histogram is None:
            from koordinator_tpu_torch.metrics.components import POD_E2E

            histogram = POD_E2E
        self._histogram = histogram
        self._clock = clock
        self._capacity = capacity
        self._lock = threading.Lock()
        #: uid -> (lane, {stage: t}) — at capacity new submits are
        #: refused (counted in ``_dropped``), the waiting tail is kept
        self._active: Dict[str, tuple] = {}
        #: (lane, e2e_s, {stage: t}) for published pods
        self._completed: deque = deque(maxlen=completed_capacity)
        #: submits refused at capacity (the backlog cost samples)
        self._dropped = 0
        #: optional backpressure hook, called (outside the lock) with
        #: the refused uid whenever a submit is dropped at capacity —
        #: the streaming intake wires its shed accounting here so a
        #: refused sample is visible as backpressure, not silence
        self._on_drop = None
        #: (lane, reason, t) for pods the intake RESOLVED as failures
        #: (shed at capacity / expired past their lane deadline): the
        #: failure tail folded into the same rolling surface the
        #: survivor percentiles come from — a dashboard (or the SLO
        #: controller) reading stats(window_s=) must see a lane that
        #: sheds half its arrivals, not just the p99 of the half that
        #: made it through
        self._failures: deque = deque(maxlen=completed_capacity)

    # -- stamps --------------------------------------------------------------

    def set_drop_hook(self, hook) -> None:
        """Wire (or clear, with None) the capacity-refusal hook: called
        with the refused uid, outside the lock, once per drop."""
        with self._lock:
            self._on_drop = hook

    def submit(self, uid: str, lane: str = "ls") -> None:
        """Open a timeline (idempotent: informer refreshes of a pending
        pod must not reset its submit stamp)."""
        t = self._clock()
        with self._lock:
            if uid in self._active:
                return
            if len(self._active) >= self._capacity:
                # refuse the NEW timeline, never evict the oldest: the
                # longest-waiting pods are exactly the p99 tail the
                # histogram exists to observe, so a backlog past
                # capacity must cost the newest samples, not the tail
                # (and never memory) — counted so the gap is visible
                self._dropped += 1
                hook = self._on_drop
            else:
                self._active[uid] = (lane, {"submit": t})
                return
        if hook is not None:
            hook(uid)

    def mark(self, uid: str, stage: str) -> None:
        t = self._clock()
        with self._lock:
            entry = self._active.get(uid)
            if entry is not None:
                entry[1].setdefault(stage, t)

    def mark_many(self, uids, stage: str) -> None:
        t = self._clock()
        with self._lock:
            for uid in uids:
                entry = self._active.get(uid)
                if entry is not None:
                    entry[1].setdefault(stage, t)

    def published(self, uid: str) -> Optional[float]:
        """Close a timeline: observe submit→published into the lane
        histogram, move the record to the completed ring. Returns the
        e2e seconds (None for an unknown uid)."""
        t = self._clock()
        with self._lock:
            entry = self._active.pop(uid, None)
            if entry is None:
                return None
            lane, stamps = entry
            stamps["published"] = t
            e2e = t - stamps["submit"]
            self._completed.append((lane, e2e, stamps))
        self._histogram.observe(e2e, {"lane": lane})
        return e2e

    def forget(self, uid: str) -> None:
        """Drop a timeline without observing (pod deleted/evicted while
        pending — not a latency sample)."""
        with self._lock:
            self._active.pop(uid, None)

    def note_shed(self, lane: str, reason: str, uid: Optional[str] = None) -> None:
        """Record an intake failure resolution (``capacity`` /
        ``deadline-exceeded``) into the rolling failure ring, and close
        the pod's active timeline without observing — a shed pod is a
        FAILURE sample for the window counters, never a latency one."""
        t = self._clock()
        with self._lock:
            self._failures.append((lane, reason, t))
            if uid is not None:
                self._active.pop(uid, None)

    @contextmanager
    def preserved(self, uid: str):
        """Carry a timeline across a forget/submit round-trip. The
        scheduler's accounted-field refresh of a PENDING pod re-runs
        remove_pod + add_pod for the quota/gang side effects, but the
        pod never left the queue — its original stamps (the submit
        above all) must survive, or the e2e histogram reports only the
        post-refresh tail of the wait. The refreshed pod's lane wins
        (a QoS change relabels the sample); original stamps win over
        the round-trip's fresh ones."""
        with self._lock:
            entry = self._active.get(uid)
            kept = (entry[0], dict(entry[1])) if entry is not None else None
        try:
            yield
        finally:
            if kept is not None:
                with self._lock:
                    cur = self._active.get(uid)
                    if cur is not None:
                        stamps = dict(cur[1])
                        stamps.update(kept[1])
                        self._active[uid] = (cur[0], stamps)
                    else:
                        # the re-add was refused at capacity (or never
                        # happened): the pre-existing sample keeps its
                        # slot rather than being silently dropped
                        self._active[uid] = kept

    # -- read side -----------------------------------------------------------

    def stats(self, window_s: Optional[float] = None) -> dict:
        """p50/p99 submit→published over the completed ring, overall
        and per lane. With
        ``window_s``, only samples PUBLISHED within the trailing
        window count: the rolling view a serving dashboard needs (the
        all-time ring mixes a cold start's tail into steady state)."""
        cutoff = None if window_s is None else self._clock() - window_s
        with self._lock:
            samples = [
                (lane, e2e) for lane, e2e, stamps in self._completed
                if cutoff is None or stamps.get("published", 0) >= cutoff
            ]
            failures = [
                (lane, reason) for lane, reason, t in self._failures
                if cutoff is None or t >= cutoff
            ]

        def pct(xs: List[float]) -> dict:
            if not xs:
                return {"count": 0, "p50_s": None, "p99_s": None}
            xs = sorted(xs)
            hi = min(len(xs) - 1, -(-99 * (len(xs) - 1) // 100))
            return {
                "count": len(xs),
                "p50_s": xs[len(xs) // 2],
                "p99_s": xs[hi],
            }

        def shed_counts(fs) -> dict:
            counts: dict = {}
            for _, reason in fs:
                counts[reason] = counts.get(reason, 0) + 1
            return counts

        out = {"all": pct([e for _, e in samples])}
        out["all"]["shed"] = shed_counts(failures)
        for lane in LANES:
            lane_samples = [e for l, e in samples if l == lane]
            lane_failures = [(l, r) for l, r in failures if l == lane]
            if lane_samples or lane_failures:
                out[lane] = pct(lane_samples)
                out[lane]["shed"] = shed_counts(lane_failures)
        return out

    #: rolling-window width served by status() (seconds of the
    #: timeline clock — the trailing view beside the all-time ring)
    ROLLING_WINDOW_S = 30.0

    def status(self) -> dict:
        """Debug-mux payload: in-flight depth, the dropped-sample
        backpressure counter, all-time AND rolling-window latency
        percentiles."""
        with self._lock:
            inflight = len(self._active)
            completed = len(self._completed)
            dropped = self._dropped
        return {
            "inflight": inflight,
            "completed": completed,
            "dropped": dropped,
            "latency": self.stats(),
            "rolling": {
                "window_s": self.ROLLING_WINDOW_S,
                **self.stats(window_s=self.ROLLING_WINDOW_S),
            },
        }

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._completed.clear()
            self._failures.clear()
            self._dropped = 0
            self._on_drop = None
