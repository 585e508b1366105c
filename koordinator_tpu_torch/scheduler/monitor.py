"""Scheduler monitor + debug services (a copy of
``koordinator_tpu/scheduler/monitor.py``; the monitor reads the port's
own ``TRACER`` and counts into the port's ``STUCK_CYCLES``).

- SchedulerMonitor: a span-fed stuck-cycle watchdog (reference:
  pkg/scheduler/frameworkext/scheduler_monitor.go:44-103). The
  watchdog reads the trace fabric's open marks (``round:<id>``/
  ``publish:<id>``, opened by ``begin_tick`` and the tick publisher —
  obs/trace.py), so "stuck"
  means the thing that actually matters — a round that never retired
  or a publish wedged on a half-open connection — and every detection
  counts into ``scheduler_stuck_cycles_total{kind}``.
- DebugRecorder: runtime-togglable score/filter dumps (reference:
  pkg/scheduler/frameworkext/debug.go and the /debug/flags HTTP
  toggles), extended with a bounded ring of placement-explain payloads
  (``obs/explain.PlacementExplainer`` records every answer there).
- DebugServices: per-plugin debug endpoints as plain dict payloads
  (reference: frameworkext/services/services.go — there gin HTTP, here
  an in-process registry any HTTP layer can front).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional


class SchedulerMonitor:
    """Watchdog over the tracer's open round/publish marks.

    ``check_stuck`` is cheap (one dict snapshot) and side-effect-safe
    to call from anywhere: the scheduling loop calls it at round start,
    and the debug mux's ``monitor`` service calls it on GET — which is
    the path that still works when the loop itself is wedged behind a
    stuck publish. Each stuck mark is counted ONCE
    (``scheduler_stuck_cycles_total{kind}``) no matter how many
    monitors watch the tracer — the counted-stuck flag lives with the
    mark itself (``SpanTracer.flag_stuck``), so a leader + standby in
    one process, or a mux status() reader racing the loop's check,
    never double-count — and the flag clears when the mark closes."""

    def __init__(self, tracer=None, timeout_seconds: float = 10.0,
                 log=print):
        if tracer is None:
            from koordinator_tpu_torch.obs.trace import TRACER

            tracer = TRACER
        self.tracer = tracer
        self.timeout = timeout_seconds
        self.log = log

    def check_stuck(self, now: Optional[float] = None) -> List[str]:
        """Open marks older than the timeout right now. Newly-stuck
        marks are logged and counted; a mark is never double-counted."""
        stuck, _ = self._check(now)
        return stuck

    def _check(self, now: Optional[float] = None):
        """One pass over one open-marks snapshot: returns (stuck keys,
        the snapshot) so status() reports ages consistent with the
        verdict instead of re-snapshotting the tracer."""
        from koordinator_tpu_torch.metrics.components import STUCK_CYCLES

        if now is None:
            now = self.tracer.now()
        newly: List[tuple] = []
        open_marks = self.tracer.open_marks()
        stuck: List[str] = []
        for key, (t0, track, _rid) in open_marks.items():
            age = now - t0
            if age <= self.timeout:
                continue
            stuck.append(key)
            # flag_stuck is the tracer-level test-and-set: True only
            # for the first flagging of a still-open mark, across ALL
            # monitors sharing the tracer (a mark that closed since
            # our snapshot is never flagged)
            if self.tracer.flag_stuck(key):
                newly.append((key, age, track))
        for key, age, track in newly:
            kind = key.split(":", 1)[0]
            STUCK_CYCLES.inc({"kind": kind})
            self.log(
                f"scheduler monitor: {kind} stuck for {age:.1f}s "
                f"(> {self.timeout}s): {key} on {track}"
            )
        return stuck, (now, open_marks)

    def status(self) -> Dict[str, object]:
        """Debug-mux payload — running the check on read is the point:
        the mux thread observes a wedge the blocked loop cannot."""
        stuck, (now, open_marks) = self._check()
        return {
            "timeout_s": self.timeout,
            "stuck": stuck,
            "open_marks": {
                k: {"age_s": now - t0, "track": track, "round": rid}
                for k, (t0, track, rid) in open_marks.items()
            },
        }


class DebugRecorder:
    """Score/filter/explain dump collection, toggled at runtime."""

    #: bounded explain history (every /explain answer lands here)
    MAX_EXPLAINS = 64

    def __init__(self) -> None:
        self.dump_scores = False
        self.dump_filters = False
        self.scores: List[Dict] = []
        self.filters: List[Dict] = []
        self.explains: deque = deque(maxlen=self.MAX_EXPLAINS)

    def record_scores(self, pod_uid: str, scores: Dict[str, int]) -> None:
        if self.dump_scores:
            self.scores.append({"pod": pod_uid, "scores": dict(scores)})

    def record_filter(self, pod_uid: str, node: str, plugin: str, status) -> None:
        if self.dump_filters:
            self.filters.append(
                {
                    "pod": pod_uid,
                    "node": node,
                    "plugin": plugin,
                    "reason": status.reason,
                }
            )

    def record_explain(self, payload: Dict) -> None:
        """Explain answers are always kept (bounded): by the time an
        operator asks "why", a toggle-first flow would have lost the
        interesting one."""
        self.explains.append(payload)


class DebugServices:
    """Named debug endpoints: plugins register callables returning dicts."""

    def __init__(self) -> None:
        self._services: Dict[str, Callable[[], Dict]] = {}

    def register(self, plugin_name: str, fn: Callable[[], Dict]) -> None:
        self._services[plugin_name] = fn

    def query(self, plugin_name: str) -> Optional[Dict]:
        fn = self._services.get(plugin_name)
        return fn() if fn is not None else None

    def names(self) -> List[str]:
        return sorted(self._services)
