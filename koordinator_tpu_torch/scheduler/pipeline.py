"""TickPipeline: the overlapped stage/solve/publish scheduling loop (a
copy of ``koordinator_tpu/scheduler/pipeline.py`` over the port's
Scheduler, trace, flight recorder and series).

The serial loop serializes one round end to end — lower + stage, device
solve (blocking read-back), typed epilogue, bus publish — so the round
floor is the SUM of the stages even though a CUDA launch is already
asynchronous and the publish needs nothing from the next round. This is
the scheduling-cycle/binding-cycle split of kube-scheduler (binding runs
in a goroutine off the scheduling loop):

  coordinator (run_loop):  retire-wait → begin_tick (catch-up stage +
                           async dispatch) → prestage the overlap window
  publisher (ONE worker):  finalize (the read-back) → epilogue →
                           publish → post-epilogue prestage

Ordering contract — the reason placements stay bit-identical to the
serial loop by construction: ``begin_tick(N+1)`` runs strictly after
tick N RETIRED (epilogue applied, binds published), so every solve
consumes the same truth-lowered staged state and pending queue the
serial loop would have. What overlaps is everything the next round does
NOT depend on: the device compute's wall time, the read-back, the bus
publish, and the re-lowering of rows dirtied by informer traffic (the
prestage — any row the retiring epilogue later touches is re-marked by
its tracker mark and re-lowered from settled truth at the next
``begin_tick``'s catch-up ensure, so a stale prestage can never
survive into a solve).

Failure containment: a publish-side failure (FencingError from a fenced
eviction, a typed solver error) is recorded and re-raised at the NEXT
round boundary (``submit_round``/``drain``), where ``run_loop``'s
existing handlers — including the fencing-forget rollback
(``Scheduler.forget_assumed_unbound``) — treat it exactly like a serial
round's failure. The already-staged next round is safe either way: the
forget's tracker marks force its rows back through truth-lowering.

On the card both threads launch on the device's current stream, which is
the default stream in each: the publisher's read-back is ordered after
the solve it reads, and the prestage's scatters write a new generation
while the dispatched one is pinned (``StagedStateCache.pin``). The
worker makes the model's device current before it retires a tick.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import torch

from koordinator_tpu_torch.metrics.components import (
    PIPELINE_DEFERRED_ERRORS,
    PIPELINE_DRAINS,
    PIPELINE_INFLIGHT,
    ROUND_CRITICAL_PATH,
    TICK_STAGE_DURATION,
)
from koordinator_tpu_torch.obs.flight import FLIGHT
from koordinator_tpu_torch.obs.trace import TRACER

#: publisher-queue shutdown sentinel
_STOP = object()


class TickPipeline:
    """Depth-1 tick pipeline over a :class:`~koordinator_tpu_torch.scheduler.
    Scheduler`: one dispatched-but-unretired tick at most, retired by a
    bounded single-worker publisher.

    ``publish`` defaults to the scheduler's wiring-bound
    ``publish_result`` (None on a standalone scheduler — the epilogue
    still runs, nothing is published). ``on_result`` is a per-round
    result hook for benches/tests (called on the publisher thread, in
    round order).

    Concurrency: the coordinator thread calls ``submit_round`` /
    ``prestage`` / ``drain`` / ``stop``; the publisher worker retires
    ticks. Every mutable attribute below is read and written under
    ``_lock``; the retire handoff itself rides ``_retired`` (an Event)
    and the bounded queue.
    """

    def __init__(self, scheduler, publish: Optional[Callable] = None,
                 log: Callable = print,
                 on_result: Optional[Callable] = None):
        self.scheduler = scheduler
        self._publish = (
            publish if publish is not None
            else getattr(scheduler, "publish_result", None)
        )
        self._log = log
        self._on_result = on_result
        self._lock = threading.Lock()
        self._retired = threading.Event()
        self._retired.set()
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._inflight = False
        self._pending_error: Optional[BaseException] = None
        self._rounds = 0
        self._last: Optional[dict] = None
        self._stopped = False
        device = getattr(getattr(scheduler, "model", None), "device", None)
        #: the CUDA device index the worker retires on (None off CUDA),
        #: resolved here on the coordinator: ``cuda`` means its current
        #: device
        self._cuda_index = None
        if isinstance(device, torch.device) and device.type == "cuda":
            self._cuda_index = (device.index if device.index is not None
                                else torch.cuda.current_device())
        self._worker = threading.Thread(
            target=self._run, name="koord-tick-publisher", daemon=True
        )
        self._worker.start()

    # -- coordinator side ----------------------------------------------------

    def submit_round(self, now: Optional[float] = None,
                     trigger: Optional[str] = None) -> float:
        """One pipelined round's critical path: wait for the previous
        tick to retire (surfacing any deferred publish-side error at
        this round boundary), then stage + dispatch this round and hand
        it to the publisher. Returns the critical-path seconds — what
        the round actually cost the loop; the solve compute and publish
        drain in the background. ``trigger`` annotates why the round
        fired (the streaming mode's adaptive triggers) onto its trace
        spans."""
        t0 = time.perf_counter()
        self._surface(wait=True)
        TRACER.emit("retire_wait", cat="pipeline", t0=t0)
        with self._lock:
            if self._stopped:
                raise RuntimeError("tick pipeline is stopped")
            self._rounds += 1
        tick = self.scheduler.begin_tick(now, trigger=trigger)
        with self._lock:
            self._inflight = True
        self._retired.clear()
        PIPELINE_INFLIGHT.set(1)
        self._queue.put(tick)
        wall = time.perf_counter() - t0
        ROUND_CRITICAL_PATH.observe(wall)
        return wall

    def prestage(self, now: Optional[float] = None) -> None:
        """The overlap window: warm the next round's staging from
        current truth while the in-flight solve computes. The staging
        cache double-buffers (the dispatched generation is pinned), and
        bit-identity is free — see the module docstring."""
        self.scheduler.model.prestage(
            self.scheduler.cache.snapshot(now=now)
        )

    def drain(self, reason: str = "drain",
              raise_deferred: bool = True) -> None:
        """Quiesce: block until no tick is in flight (epilogue applied,
        publish done). The auditor's sweeps and the failover flip hooks
        call this so neither ever observes a half-retired round;
        ``raise_deferred=False`` (the hook form) leaves any deferred
        error pending for the next round boundary instead of raising it
        from inside a flip."""
        PIPELINE_DRAINS.inc({"reason": reason})
        if raise_deferred:
            self._surface(wait=True)
        else:
            self._retired.wait()

    #: how long stop() waits for a retire before abandoning the worker
    #: (a daemon thread) — shutdown must complete even if a publish is
    #: wedged on a half-open connection or a hung device
    STOP_TIMEOUT_S = 30.0

    def stop(self) -> None:
        """Drain and stop the publisher worker. A deferred error still
        pending at shutdown is logged, not raised — callers that care
        drain first. The retire wait is BOUNDED: a wedged publisher is
        logged and abandoned (the worker is a daemon thread), never
        allowed to hang process exit."""
        retired = self._retired.wait(timeout=self.STOP_TIMEOUT_S)
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            err = self._pending_error
        if not retired:
            self._log(f"tick pipeline stop: publisher still retiring "
                      f"after {self.STOP_TIMEOUT_S}s — abandoning the "
                      f"worker (wedged publish?)")
            # the retire may have completed in the instant between the
            # timeout and _stopped being set above — the worker would
            # then loop back to the queue having read _stopped=False.
            # Feed it _STOP so it exits on either interleaving (a truly
            # wedged worker exits on its own _stopped check instead,
            # leaving the sentinel unread in a dead pipeline's queue).
            try:
                self._queue.put_nowait(_STOP)
            except queue.Full:
                pass
            return
        if err is not None:
            self._log(f"tick pipeline stop: dropping deferred error: "
                      f"{err!r}")
        self._queue.put(_STOP)
        self._worker.join(timeout=5.0)

    def status(self) -> dict:
        """Debug-mux surface (registered as ``tick-pipeline``)."""
        with self._lock:
            return {
                "inflight": self._inflight,
                "rounds": self._rounds,
                "last_round": self._last,
                "pending_error": (
                    repr(self._pending_error)
                    if self._pending_error is not None else None
                ),
                "stopped": self._stopped,
            }

    def _surface(self, wait: bool) -> None:
        """Surface a deferred publish-side error at a round boundary."""
        if wait:
            self._retired.wait()
        with self._lock:
            err, self._pending_error = self._pending_error, None
        if err is not None:
            raise err

    # -- publisher side ------------------------------------------------------

    def _run(self) -> None:
        from koordinator_tpu_torch.client.leaderelection import FencingError
        from koordinator_tpu_torch.service.client import (
            SolverOverloaded,
            SolverUnavailable,
        )

        if self._cuda_index is not None:
            # the read-back and the post-publish prestage run here, on
            # the model's card (a fresh thread's current device is 0)
            torch.cuda.set_device(self._cuda_index)
        while True:
            tick = self._queue.get()
            if tick is _STOP:
                return
            try:
                self._retire(tick)
            except Exception as e:
                kind = "other"
                if isinstance(e, FencingError):
                    kind = "fencing"
                elif isinstance(e, (SolverUnavailable, SolverOverloaded)):
                    kind = "solver"
                PIPELINE_DEFERRED_ERRORS.inc({"kind": kind})
                TRACER.instant("pipeline-deferred-error", cat="pipeline",
                               args={"kind": kind})
                # the round that FAILED never reached _retire's
                # record_round — put it in the ring (error-flagged,
                # whatever stage timings it got to) so the dump this
                # very failure triggers contains the anomalous round,
                # not just the rounds leading up to it
                inflight = getattr(tick, "inflight", None)
                FLIGHT.record_round({
                    "round": getattr(tick, "round_id", None),
                    "at": getattr(tick, "at", None),
                    "error": f"{type(e).__name__}: {e}",
                    **(dict(inflight.timings)
                       if inflight is not None else {}),
                })
                # anomaly: the flight recorder preserves the rounds that
                # led up to the deferred publish-side failure
                FLIGHT.trigger(
                    "pipeline-deferred-error",
                    detail=f"{type(e).__name__}: {e}",
                )
                with self._lock:
                    self._pending_error = e
            finally:
                with self._lock:
                    self._inflight = False
                    stopped = self._stopped
                if not stopped:
                    # an abandoned worker must NOT touch the global
                    # gauge: a re-invoked loop's fresh pipeline owns it
                    # by now, and clobbering it to 0 would hide that
                    # pipeline's in-flight tick from the runbook's
                    # wedged-publisher signal
                    PIPELINE_INFLIGHT.set(0)
                self._retired.set()
            if stopped:
                # an abandoning stop() already returned without queueing
                # _STOP — exit now rather than block on the queue forever
                return

    def _abandoned(self, stage: str) -> bool:
        """True once ``stop()`` timed out and walked away from this
        worker mid-wedge. In the clean shutdown path ``_stopped`` is
        only ever set while no tick is retiring, so observing it here
        means abandonment: every later side effect — publish, metrics,
        prestage — must be dropped, because a re-invoked loop's fresh
        pipeline may own the scheduler's shared state by now. (A call
        the worker is already wedged INSIDE cannot be un-run — this
        gate bounds what happens after the current blocking call
        returns.)"""
        with self._lock:
            if not self._stopped:
                return False
        self._log(f"tick pipeline: late {stage} after an abandoning "
                  f"stop — dropping the rest of the retire")
        return True

    def _retire(self, tick) -> None:
        """Materialize + epilogue + publish one tick (the binding-cycle
        half of the round), then prestage the rows the epilogue just
        dirtied so they're off the next round's critical path."""
        result = self.scheduler.commit_tick(tick)
        if self._abandoned("epilogue"):
            return
        rid = getattr(tick, "round_id", 0)
        # watchdog mark: a publish wedged on a half-open connection is
        # exactly what the span-fed monitor exists to flag
        TRACER.mark_open(f"publish:{rid}", round_id=rid)
        t_pub = time.perf_counter()
        try:
            if self._publish is not None:
                self._publish(result)
        finally:
            # a FAILED publish (fenced, solver died) is not a STUCK
            # publish: its error defers to the round boundary, so the
            # mark must close or the watchdog flags a ghost forever
            publish_s = time.perf_counter() - t_pub
            TRACER.mark_closed(f"publish:{rid}")
        if self._abandoned("publish"):
            return
        timings = (
            dict(tick.inflight.timings) if tick.inflight is not None
            else {}
        )
        timings["publish_s"] = publish_s
        for stage in ("lower", "stage", "solve"):
            v = timings.get(f"{stage}_s")
            if v is not None:
                TICK_STAGE_DURATION.observe(v, {"stage": stage})
        TICK_STAGE_DURATION.observe(publish_s, {"stage": "publish"})
        placed = sum(1 for v in result.values() if v is not None)
        with self._lock:
            self._last = {
                "placed": placed, "total": len(result),
                "waiting": len(result.waiting), **timings,
            }
        model = getattr(self.scheduler, "model", None)
        backend = getattr(model, "backend", None)
        FLIGHT.record_round({
            "round": rid,
            "at": tick.at,
            "trigger": getattr(tick, "trigger", None),
            "placed": placed,
            "total": len(result),
            "waiting": len(result.waiting),
            "staged_epoch": getattr(
                getattr(model, "staged_cache", None), "epoch", None
            ),
            "solver": getattr(model, "last_solver", None),
            "degraded": getattr(backend, "degraded", None),
            **timings,
        })
        if self._on_result is not None:
            self._on_result(result)
        self._log(f"round: {placed}/{len(result)} placed, "
                  f"{len(result.waiting)} waiting")
        # re-lower the bind-dirty rows right after the epilogue lands,
        # so the next round's catch-up ensure starts near-empty
        if not self._abandoned("prestage"):
            self.scheduler.model.prestage(
                self.scheduler.cache.snapshot(now=tick.at)
            )
