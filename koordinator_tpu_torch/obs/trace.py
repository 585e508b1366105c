"""SpanTracer: the low-overhead span layer under the trace fabric (a
copy of ``koordinator_tpu/obs/trace.py``; the port's ``TRACER`` is its
own process-global object, apart from the reference's).

Design constraints:

- **Hot-path cost is one append.** Emitting a span is a lock acquire +
  a tuple append into a bounded ``deque`` — no dict churn, no string
  formatting, no I/O. Timestamps come from one monotonic clock
  (``time.perf_counter``), the SAME base the solve path already uses
  for its timing dicts, so retroactive spans (lower/stage, the device
  solve) can be emitted from measurements the hot path took anyway.
- **Tracing never changes scheduling.** Spans record wall time only;
  there is no device read-back, no blocking, and a disabled tracer's
  ``emit`` returns after one attribute read — ticks are bit-identical
  with tracing on or off.
- **Bounded by construction.** The ring drops the oldest span at
  capacity; a tracer can run for weeks without growing.

Two extra facilities ride the same lock:

- **Open marks** (``mark_open``/``mark_closed``): coarse round/publish
  lifetime markers the stuck-cycle watchdog reads
  (``scheduler/monitor.SchedulerMonitor``) — a mark that stays open
  past the timeout is a stuck round/publish. Marks are tracked even when span
  recording is disabled, so the watchdog never goes blind.
- **Round/span ids**: ``begin_round`` numbers scheduling rounds; every
  span carries the current round id so cross-thread (and, via the
  codec's ``trace`` group, cross-process) spans join one trace.

Export is Chrome trace event format (``chrome_trace()``): load the
JSON at https://ui.perfetto.dev and each thread (scheduler coordinator,
tick publisher, admission gate, sidecar handler) renders as its own
track — the pipelined overlap of stage(N+1) against solve(N) is
directly visible as overlapping slices.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple


class SpanTracer:
    """Thread-safe bounded span ring + open-mark registry.

    Every mutable attribute below is read and written under ``_lock``;
    ``enabled`` is a plain flag read without the lock (a torn read costs
    at most one span).
    """

    def __init__(self, capacity: int = 16384,
                 clock=time.perf_counter, enabled: bool = True):
        self.enabled = enabled
        self._clock = clock
        self._lock = threading.Lock()
        #: span tuples (name, cat, t0, dur, track, round_id, args);
        #: dur < 0 marks an instant event
        self._events: deque = deque(maxlen=capacity)
        #: open coarse marks: key -> (t0, track, round_id)
        self._open: Dict[str, Tuple[float, str, int]] = {}
        #: open marks already counted stuck (scheduler/monitor.py) —
        #: lives WITH the mark so N watchdogs over one tracer
        #: (leader + standby in one process) count a stuck mark once
        self._stuck: set = set()
        self._round = 0
        self._next_span = 0
        self._emitted = 0

    # -- clock / ids ---------------------------------------------------------

    def now(self) -> float:
        """The tracer clock (monotonic; same base as perf_counter
        timings taken by the solve path, so retro spans line up)."""
        return self._clock()

    def begin_round(self) -> int:
        """Number a new scheduling round; spans emitted until the next
        call carry this id."""
        with self._lock:
            self._round += 1
            return self._round

    @property
    def round_id(self) -> int:
        with self._lock:
            return self._round

    def next_span_id(self) -> int:
        """A process-unique span id (wire trace context: the sidecar
        tags its spans with the scheduler's (round, span) pair)."""
        with self._lock:
            self._next_span += 1
            return self._next_span

    def set_enabled(self, on: bool) -> None:
        self.enabled = bool(on)

    # -- recording -----------------------------------------------------------

    def emit(self, name: str, cat: str = "", t0: float = 0.0,
             t1: Optional[float] = None, track: Optional[str] = None,
             round_id: Optional[int] = None, args=None) -> None:
        """Record one complete span [t0, t1] (tracer-clock seconds).
        Retro-friendly: the hot path measures with perf_counter anyway,
        so spans are emitted AFTER the fact from those timestamps."""
        if not self.enabled:
            return
        if track is None:
            track = threading.current_thread().name
        if t1 is None:
            t1 = self._clock()
        with self._lock:
            if round_id is None:
                round_id = self._round
            self._emitted += 1
            self._events.append(
                (name, cat, t0, t1 - t0, track, round_id, args)
            )

    def instant(self, name: str, cat: str = "",
                track: Optional[str] = None,
                round_id: Optional[int] = None, args=None) -> None:
        """Record a point event (state transitions: failover flips,
        breaker trips, supervisor restarts, fencing aborts)."""
        if not self.enabled:
            return
        if track is None:
            track = threading.current_thread().name
        t = self._clock()
        with self._lock:
            if round_id is None:
                round_id = self._round
            self._emitted += 1
            self._events.append((name, cat, t, -1.0, track, round_id, args))

    @contextmanager
    def span(self, name: str, cat: str = "", args=None):
        """Convenience context manager for non-hot callers (cmd-level
        wiring, tests). Hot code uses explicit emit() with timestamps
        it already measured."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.emit(name, cat, t0, self._clock(), args=args)

    # -- open marks (the watchdog's food) ------------------------------------

    def mark_open(self, key: str, round_id: Optional[int] = None) -> None:
        """Open a coarse lifetime mark (``round:<id>``/``publish:<id>``).
        Tracked even when span recording is disabled — the stuck-cycle
        watchdog must work with tracing off."""
        track = threading.current_thread().name
        t = self._clock()
        with self._lock:
            if round_id is None:
                round_id = self._round
            self._open[key] = (t, track, round_id)
            self._stuck.discard(key)

    def mark_closed(self, key: str, name: Optional[str] = None,
                    cat: str = "", args=None) -> Optional[float]:
        """Close a mark; with ``name`` set, also emit the covered span.
        Returns the mark's duration (None for an unknown key)."""
        t1 = self._clock()
        with self._lock:
            entry = self._open.pop(key, None)
            self._stuck.discard(key)
            if entry is None:
                return None
            t0, track, round_id = entry
            if name is not None and self.enabled:
                self._emitted += 1
                self._events.append(
                    (name, cat, t0, t1 - t0, track, round_id, args)
                )
        return t1 - t0

    def open_marks(self) -> Dict[str, Tuple[float, str, int]]:
        with self._lock:
            return dict(self._open)

    def flag_stuck(self, key: str) -> bool:
        """Atomically flag an open mark as counted-stuck. True only for
        the FIRST flagging of a still-open mark — the flag lives with
        the mark so N watchdogs over one tracer (leader + standby in
        one process, plus debug-mux status() readers) count a stuck
        mark once, and a mark that closed between the caller's snapshot
        and this call is never flagged (close drops the flag)."""
        with self._lock:
            if key not in self._open or key in self._stuck:
                return False
            self._stuck.add(key)
            return True

    # -- read side -----------------------------------------------------------

    @property
    def span_count(self) -> int:
        """Total spans emitted over the tracer's lifetime (the ring may
        hold fewer)."""
        with self._lock:
            return self._emitted

    def events(self, tail: Optional[int] = None) -> List[dict]:
        """Structured snapshot of the ring (tests, debug payloads).
        ``tail`` bounds the snapshot to the newest N spans — the flight
        recorder's dumps slice under the lock instead of materializing
        a 16k-span ring to keep 200 entries."""
        with self._lock:
            if tail is not None and len(self._events) > tail:
                from itertools import islice

                snap = list(islice(
                    self._events, len(self._events) - tail, None
                ))
            else:
                snap = list(self._events)
        return [
            {
                "name": name, "cat": cat, "t0": t0,
                "dur": (None if dur < 0 else dur), "track": track,
                "round": rid, "args": args,
            }
            for name, cat, t0, dur, track, rid, args in snap
        ]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._open.clear()
            self._stuck.clear()

    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace event object (Perfetto-loadable).

        Complete spans become ``ph: "X"`` duration events, instants
        become ``ph: "i"``; each distinct track gets a stable tid plus
        a ``thread_name`` metadata record so Perfetto labels the
        coordinator / publisher / gate / sidecar tracks."""
        with self._lock:
            snap = list(self._events)
        tids: Dict[str, int] = {}
        trace_events: List[dict] = []
        for name, cat, t0, dur, track, rid, args in snap:
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
            ev_args = {"round": rid}
            if args:
                ev_args.update(args)
            ev = {
                "name": name, "cat": cat or "span", "pid": 1, "tid": tid,
                "ts": int(t0 * 1e6), "args": ev_args,
            }
            if dur < 0:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = max(int(dur * 1e6), 1)
            trace_events.append(ev)
        for track, tid in tids.items():
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": track},
            })
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def status(self) -> dict:
        """Debug-mux summary (the full export lives at /debug/trace)."""
        with self._lock:
            buffered = len(self._events)
            emitted = self._emitted
            opens = {
                k: {"age_s": self._clock() - t0, "track": track,
                    "round": rid}
                for k, (t0, track, rid) in self._open.items()
            }
            rnd = self._round
        return {
            "enabled": self.enabled,
            "rounds": rnd,
            "spans_emitted": emitted,
            "spans_buffered": buffered,
            "open_marks": opens,
        }


#: the process tracer every component records into (one trace per
#: process, like the metric registries)
TRACER = SpanTracer()
