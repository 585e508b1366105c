"""Anomaly flight recorder: recent rounds, dumped on trigger (a copy of
``koordinator_tpu/obs/flight.py``; the port's ``FLIGHT`` is its own
process-global object).

When the auditor detects drift, the failover flips, a fenced publish
aborts, a pipelined publish defers an error, or a solve blows its
deadline, the question is always "what were the last N rounds doing?"
— and by the time a human is looking, the answer is gone. This module
keeps a bounded ring of per-round records (stage durations, staged
epoch, solver mode, breaker/failover state, placement counts) that the
tick paths append to every round, and dumps the whole ring — plus the
trace ring's tail — to a JSON file the moment a trigger fires:

- ``fencing-abort``           (cmd/scheduler.py run_loop: FencingError)
- ``pipeline-deferred-error`` (scheduler/pipeline.py: a publish-side
  failure was deferred to the next round boundary)
- ``manual``                  (an operator or a test)
- ``failover-flip``           (service/failover.py: the failover backend
  flipped to degraded or back)
- ``deadline-exceeded``       (service/client.py: a solve's client-side
  budget ran out)
- ``auditor-detection``       (scheduler/auditor.py: a sweep found
  drift)

A dump's ``device`` section comes from the port's
``DEVICE_OBS.flight_payload()``, and hooks add the ``workingset``,
``migration`` and ``slo`` sections; its ``warm`` section is the warm
pool's counters (``WARM_POOL.flight_payload()``: was the round served
warm or cold, and is the store healthy).

Dumps are rate-limited per trigger (a flapping failover must not write
a dump storm), counted in ``scheduler_flight_dumps_total{trigger}``,
and indexed in memory for the debug mux. Recording costs one lock +
ring append per round; a dump does file I/O but only ever fires on an
anomaly — never on the healthy path.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from koordinator_tpu_torch.obs.trace import TRACER

#: trace-ring tail included in every dump (enough to see the anomalous
#: round's span structure without shipping the whole ring)
_TRACE_TAIL = 200


def _default_dump_dir() -> str:
    return os.environ.get(
        "KTPU_FLIGHT_DIR",
        os.path.join(tempfile.gettempdir(), "koord-flight"),
    )


class FlightRecorder:
    """Bounded round-record ring + triggered JSON dumps.

    Every mutable attribute below is mapped to ``_lock`` in
    graftcheck's lock-discipline registry."""

    TRIGGERS = (
        "auditor-detection", "failover-flip", "fencing-abort",
        "pipeline-deferred-error", "deadline-exceeded", "manual",
    )

    def __init__(self, capacity: int = 64,
                 dump_dir: Optional[str] = None,
                 min_interval_s: float = 1.0,
                 max_files: int = 64,
                 clock=time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        #: {path, trigger, at, detail} per dump, newest last
        self._dumps: deque = deque(maxlen=32)
        self._last_dump: Dict[str, float] = {}
        self._dump_dir = dump_dir
        self._min_interval_s = min_interval_s
        #: dump files THIS recorder wrote, oldest first; beyond
        #: max_files the oldest is unlinked (disk-bounded by
        #: construction, like every ring in the fabric)
        self._files: List[str] = []
        self._max_files = max_files
        self._seq = 0
        #: name -> zero-arg payload fn stamped into every dump as a
        #: top-level section (the SLO controller registers its
        #: decision-ring tail here; hooks must be cheap and cached-only
        #: — a dump never compiles). A raising hook degrades to a typed
        #: error section, never a lost dump.
        self._payload_hooks: Dict[str, object] = {}

    def configure(self, dump_dir: Optional[str] = None,
                  capacity: Optional[int] = None,
                  min_interval_s: Optional[float] = None) -> None:
        """Runtime configuration (cmd flags / tests)."""
        with self._lock:
            if dump_dir is not None:
                self._dump_dir = dump_dir
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=capacity)
            if min_interval_s is not None:
                self._min_interval_s = min_interval_s

    def register_payload(self, name: str, fn) -> None:
        """Stamp ``fn()``'s dict into every future dump under ``name``
        (reserved section names are refused loudly — a hook must not
        shadow the core dump sections)."""
        if name in ("trigger", "at", "detail", "extra", "rounds",
                    "device", "warm", "open_spans", "trace_tail"):
            raise ValueError(f"flight payload name {name!r} is reserved")
        with self._lock:
            self._payload_hooks[name] = fn

    def unregister_payload(self, name: str) -> None:
        with self._lock:
            self._payload_hooks.pop(name, None)

    # -- the per-round feed --------------------------------------------------

    def record_round(self, record: dict) -> None:
        """Append one round record (the tick paths call this every
        round — keep records small and host-only)."""
        with self._lock:
            self._ring.append(record)

    # -- triggers ------------------------------------------------------------

    def trigger(self, reason: str, detail: Optional[str] = None,
                extra: Optional[dict] = None) -> Optional[str]:
        """An anomaly fired: dump the ring (+ trace tail) to JSON.
        Returns the dump path, or None when rate-limited or the write
        failed (a failed dump is recorded in memory — observability
        must never crash the scheduler)."""
        from koordinator_tpu_torch.metrics.components import FLIGHT_DUMPS

        at = self._clock()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and at - last < self._min_interval_s:
                return None
            self._last_dump[reason] = at
            self._seq += 1
            seq = self._seq
            rounds = list(self._ring)
            dump_dir = self._dump_dir or _default_dump_dir()
            hooks = dict(self._payload_hooks)
        TRACER.instant("flight-dump", cat="flight",
                       args={"trigger": reason})
        # the device observatory's cached snapshot: "did the kernel
        # library just build / how much is live" answered from the dump
        # alone (counters only — a dump never builds or syncs; imported
        # here to keep obs.device free to import the flight recorder)
        from koordinator_tpu_torch.obs.device import DEVICE_OBS

        try:
            device = DEVICE_OBS.flight_payload()
        except Exception as e:  # a dump must land even if CUDA is upset
            device = {"error": f"{type(e).__name__}: {e}"}
        # the warm pool's counters: was the anomalous round served warm
        # or cold, and is the store healthy (a dump never captures or
        # touches the store)
        try:
            from koordinator_tpu_torch.service.warmpool import WARM_POOL

            warm = WARM_POOL.flight_payload()
        except Exception as e:
            warm = {"error": f"{type(e).__name__}: {e}"}
        payload = {
            "trigger": reason,
            "at": at,
            "detail": detail,
            "extra": extra,
            "rounds": rounds,
            "device": device,
            "warm": warm,
            "open_spans": TRACER.status()["open_marks"],
            "trace_tail": TRACER.events(tail=_TRACE_TAIL),
        }
        for name in sorted(hooks):
            try:
                payload[name] = hooks[name]()
            except Exception as e:  # a broken hook never loses a dump
                payload[name] = {"error": f"{type(e).__name__}: {e}"}
        path = os.path.join(dump_dir, f"flight-{reason}-{seq:04d}.json")
        error = None
        pruned = None
        try:
            os.makedirs(dump_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, default=str)
        except OSError as e:
            error, path = f"{type(e).__name__}: {e}", None
        if error is None:
            # counted AFTER the write lands: the metric says "dumps
            # written", and the runbook sends operators from a nonzero
            # count to the dump directory — a failed write must not
            # point them at a file that does not exist (it is still
            # recorded, with its error, in the in-memory dump log)
            FLIGHT_DUMPS.inc({"trigger": reason})
        with self._lock:
            self._dumps.append({
                "path": path, "trigger": reason, "at": at,
                "detail": detail, "error": error,
            })
            if path is not None:
                # disk retention: the rate limit bounds the RATE, this
                # bounds the TOTAL — a trigger flapping for a week must
                # not fill the disk with dump files
                self._files.append(path)
                if len(self._files) > self._max_files:
                    pruned = self._files.pop(0)
        if pruned is not None:
            try:
                os.unlink(pruned)
            except OSError:
                pass
        return path

    # -- read side -----------------------------------------------------------

    def dumps(self) -> List[dict]:
        with self._lock:
            return list(self._dumps)

    def recent_rounds(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def status(self) -> dict:
        with self._lock:
            return {
                "rounds_buffered": len(self._ring),
                "dump_dir": self._dump_dir or _default_dump_dir(),
                "min_interval_s": self._min_interval_s,
                "dumps": list(self._dumps),
            }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dumps.clear()
            self._last_dump.clear()
            self._files.clear()


#: the process flight recorder (one per process, like the tracer)
FLIGHT = FlightRecorder()
