"""SolverSupervisor: the sidecar's failure domain gets an owner
(counterpart of ``koordinator_tpu/service/supervisor.py``).

This module owns the solver child's whole lifecycle:

- **Spawn.** ``spawn_fn`` produces a process-like handle (``poll()``/
  ``kill()``/``pid``). The default spawns ``python -m
  koordinator_tpu_torch.cmd.solver --listen <spec>``; tests and the
  chaos harness pass :class:`~koordinator_tpu_torch.testing.chaos.
  InProcessSidecar` handles, so that a restart costs milliseconds.
- **Probing.** Liveness is the child process alive AND the solve address
  accepting (and holding) a connection: :func:`connection_probe`, shared
  with the failover layer so both sides agree on "healthy".
  ``probe_fn`` swaps in the child's debug-port ``/healthz``
  (:func:`debug_port_probe`) when it serves one.
- **Restart.** A dead or hung child is respawned after a jittered
  exponential backoff (reset once a child probes healthy), counted in
  ``solver_supervisor_restarts_total``.
- **Restart-storm breaker.** ``threshold`` restarts inside ``window_s``
  open the breaker: the supervisor stops respawning a child that dies on
  arrival and tries ONE half-open respawn per ``cooldown_s``. While it is
  open the control plane rides the failover backend
  (``service/failover.py``).

A cold child gets ``ready_timeout_s`` of grace after a spawn before
failed probes count toward "hung" (a fresh child imports PyTorch and
loads the kernel library, which it builds with ``nvcc`` when no built
copy is in ``koordinator_tpu_torch/_build/``). A child known to have
restored from the warm pool (``service/warmpool.py``: its solves replay
CUDA graphs it captured before it bound) gets the tight
``warm_ready_timeout_s`` instead: the probe-budget split.
``warm_outcome_fn`` reports the child's outcome
(:func:`debug_port_warm_outcome` reads a real child's debug mux);
``respawns_warm_total`` and ``SUPERVISOR_RESPAWN_WARM`` count the warm
spawns.

Every state transition is visible: :meth:`SolverSupervisor.status` is the
machine-readable snapshot, and the gauges and counters are in
``metrics/components.py`` (the scheduler's registry: the supervisor runs
in the control-plane process).
"""

from __future__ import annotations

import random
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from koordinator_tpu_torch.metrics.components import (
    SUPERVISOR_BREAKER_OPEN,
    SUPERVISOR_RESPAWN_WARM,
    SUPERVISOR_RESTARTS,
    SUPERVISOR_UP,
)
from koordinator_tpu_torch.obs.trace import TRACER


def connection_probe(address, timeout_s: float = 1.0,
                     hold_s: float = 0.05) -> bool:
    """True iff ``address`` accepts a connection AND keeps it open.

    The hold matters: a proxy (or a half-dead server) can accept() from
    its listen backlog and immediately drop — connect success alone
    would report a corpse as healthy. The solve protocol never sends
    unsolicited bytes, so recv() returning ``b""`` inside ``hold_s``
    means the peer hung up; a timeout means the connection is being
    held — alive."""
    family = (socket.AF_UNIX if isinstance(address, str)
              else socket.AF_INET)
    sock = socket.socket(family, socket.SOCK_STREAM)
    try:
        sock.settimeout(timeout_s)
        sock.connect(address)
        sock.settimeout(hold_s)
        try:
            return sock.recv(1) != b""
        except socket.timeout:
            return True  # connection held open: listening and alive
    except OSError:
        return False
    finally:
        try:
            sock.close()
        except OSError:
            pass


def debug_port_probe(port: int, timeout_s: float = 1.0
                     ) -> Callable[[], bool]:
    """A ``probe_fn`` hitting the sidecar's ``--debug-port /healthz``
    (deeper than a connect probe: the HTTP thread answering proves the
    process is scheduling work, not just holding a listen socket)."""
    import urllib.request

    def probe() -> bool:
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=timeout_s
            ) as resp:
                return resp.status == 200
        except OSError:
            return False

    return probe


def debug_port_warm_outcome(port: int, timeout_s: float = 1.0
                            ) -> Callable[[], Optional[bool]]:
    """A ``warm_outcome_fn`` reading the sidecar's warm-pool status off
    its debug mux (``/apis/v1/plugins/warm-pool``): True once the child
    reports restored/serving executables (probe it on the tight warm
    ready grace), False once it reports an active pool that restored
    nothing (cold — keep the cold-compile allowance), None while the
    child can't answer yet (undecided: stay generous)."""
    import json
    import urllib.request

    def outcome() -> Optional[bool]:
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/apis/v1/plugins/warm-pool",
                timeout=timeout_s,
            ) as resp:
                if resp.status != 200:
                    return None
                status = json.load(resp)
        except (OSError, ValueError):
            return None
        if not isinstance(status, dict) or not status.get("active"):
            return False  # no pool: every respawn is a cold respawn
        if status.get("executables"):
            return True
        report = status.get("last_restore")
        if isinstance(report, dict) and "restored" in report:
            return report["restored"] > 0
        return None  # boot restore still in flight

    return outcome


class RestartBreaker:
    """Restart-storm circuit breaker: ``threshold`` restarts inside
    ``window_s`` opens it; while open, :meth:`allow` grants ONE
    half-open respawn per ``cooldown_s``. A child that stays healthy
    closes it via :meth:`record_healthy`."""

    def __init__(self, threshold: int = 5, window_s: float = 60.0,
                 cooldown_s: float = 120.0, clock=time.monotonic):
        self.threshold = threshold
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._restarts: deque = deque()
        self._tripped_at: Optional[float] = None
        self._last_probe_at: Optional[float] = None
        self._total_trips = 0

    def record_restart(self) -> bool:
        """Count one respawn; returns True when this one tripped."""
        with self._lock:
            now = self._clock()
            self._restarts.append(now)
            while self._restarts and self._restarts[0] < now - self.window_s:
                self._restarts.popleft()
            if (
                self._tripped_at is None
                and len(self._restarts) >= self.threshold
            ):
                self._tripped_at = now
                self._total_trips += 1
                return True
            return False

    def record_healthy(self) -> None:
        with self._lock:
            self._tripped_at = None
            self._last_probe_at = None
            self._restarts.clear()

    def allow(self) -> bool:
        with self._lock:
            if self._tripped_at is None:
                return True
            now = self._clock()
            since = now - (self._last_probe_at or self._tripped_at)
            if since >= self.cooldown_s:
                self._last_probe_at = now  # one half-open respawn
                return True
            return False

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "open": self._tripped_at is not None,
                "restarts_in_window": len(self._restarts),
                "threshold": self.threshold,
                "window_s": self.window_s,
                "cooldown_s": self.cooldown_s,
                "total_trips": self._total_trips,
            }


def _default_spawn(listen_spec: str, extra_argv=()):
    """Spawn a real koord-solver subprocess serving ``listen_spec``."""
    import subprocess
    import sys

    return subprocess.Popen(
        [sys.executable, "-m", "koordinator_tpu_torch.cmd.solver",
         "--listen", listen_spec, *extra_argv],
        stdin=subprocess.DEVNULL,
    )


class SolverSupervisor:
    """Owns one sidecar child: spawn → probe → restart (with backoff
    and the storm breaker) → repeat, on a background monitor thread.

    ``address`` is the solve address probed for readiness/liveness
    (UDS path or (host, port)); ``listen_spec`` is the string form the
    default spawn passes to ``--listen`` (defaults to ``address`` when
    that is already a string). ``check_once()`` is the whole
    supervision step as a synchronous call — the monitor thread loops
    it, and deterministic tests drive it directly."""

    def __init__(self, address, listen_spec: Optional[str] = None,
                 spawn_fn: Optional[Callable[[], object]] = None,
                 probe_fn: Optional[Callable[[], bool]] = None,
                 extra_argv=(),
                 probe_interval_s: float = 1.0,
                 probe_timeout_s: float = 1.0,
                 probe_failure_threshold: int = 3,
                 ready_timeout_s: float = 120.0,
                 warm_ready_timeout_s: float = 15.0,
                 warm_outcome_fn: Optional[
                     Callable[[], Optional[bool]]] = None,
                 backoff_base_s: float = 0.25,
                 backoff_cap_s: float = 8.0,
                 breaker: Optional[RestartBreaker] = None,
                 clock=time.monotonic,
                 sleep=time.sleep,
                 rng: Optional[random.Random] = None):
        self.address = address
        if listen_spec is None and isinstance(address, str):
            listen_spec = address
        self.listen_spec = listen_spec
        if spawn_fn is None:
            if listen_spec is None:
                raise ValueError(
                    "spawn_fn is required for TCP addresses without a "
                    "listen_spec"
                )
            spawn_fn = lambda: _default_spawn(listen_spec, extra_argv)
        self._spawn_fn = spawn_fn
        self._probe_fn = probe_fn or (
            lambda: connection_probe(address, probe_timeout_s)
        )
        self.probe_interval_s = probe_interval_s
        self.probe_failure_threshold = probe_failure_threshold
        self.ready_timeout_s = ready_timeout_s
        #: the probe-budget split: a child that restored from the warm
        #: pool has no kernel-library build to hide behind, so its ready
        #: grace is this tight budget and a hung warm child is killed in
        #: seconds. ``warm_outcome_fn`` reports the current child's
        #: restore outcome (True warm / False cold / None undecided:
        #: undecided keeps the generous grace); the default reads the
        #: spawn handle's ``warm_restored`` attribute
        #: (``testing.chaos.InProcessSidecar`` carries it), and
        #: :func:`debug_port_warm_outcome` wires a real child's debug
        #: mux. May do I/O: never called under the lock.
        self.warm_ready_timeout_s = warm_ready_timeout_s
        self._warm_outcome_fn = warm_outcome_fn
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.breaker = breaker or RestartBreaker(clock=clock)
        self._clock = clock
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._proc: Optional[object] = None
        self.state = "new"
        self.restarts_total = 0
        self.consecutive_probe_failures = 0
        self.last_exit_code: Optional[int] = None
        self._backoff_attempt = 0
        #: when the current child was spawned, and whether it has EVER
        #: probed healthy since: a fresh child gets ``ready_timeout_s``
        #: of grace before failed probes count toward "hung" (a real
        #: solver imports PyTorch and loads the kernel library on every
        #: spawn; counting that as ill-health would kill each respawn
        #: before it ever served)
        self._spawned_at = self._clock()
        self._ready_since_spawn = False

        #: the current child's warm/cold restore outcome (None until
        #: resolved; reset on every spawn) and how many spawns resolved
        #: warm over this supervisor's lifetime
        self._respawn_warm: Optional[bool] = None
        self.respawns_warm_total = 0
        #: last time the EXTERNAL warm_outcome_fn was invoked while
        #: undecided — paces its I/O (an HTTP round trip against a
        #: booting child) at probe_interval_s even from _wait_ready's
        #: tight 50 ms poll loop
        self._warm_probe_at: Optional[float] = None

    def _resolve_warm_outcome(self) -> Optional[bool]:
        """The current child's warm/cold restore outcome, resolved at
        most once per spawn (lazily — a booting child may only know
        after its background restore lands). May do I/O
        (``warm_outcome_fn`` hits the child's debug mux), so this runs
        OUTSIDE the lock; the recorded outcome is guarded against a
        concurrent respawn swapping the handle."""
        with self._lock:
            known = self._respawn_warm
            proc = self._proc
        if known is not None or proc is None:
            return known
        if self._warm_outcome_fn is not None:
            now = self._clock()
            with self._lock:
                last = self._warm_probe_at
                if last is not None and \
                        now - last < self.probe_interval_s:
                    return None  # still undecided; don't hammer the mux
                self._warm_probe_at = now
            try:
                outcome = self._warm_outcome_fn()
            except Exception:
                outcome = None
        else:
            outcome = getattr(proc, "warm_restored", None)
        if outcome is None:
            return None
        recorded_warm = False
        with self._lock:
            if self._respawn_warm is None and self._proc is proc:
                self._respawn_warm = bool(outcome)
                if outcome:
                    self.respawns_warm_total += 1
                    recorded_warm = True
        if recorded_warm:
            SUPERVISOR_RESPAWN_WARM.inc()
            TRACER.instant("supervisor-respawn-warm", cat="supervisor")
        return bool(outcome)

    def _ready_grace_s(self, warm: Optional[bool]) -> float:
        """The ready grace the current child is entitled to: the tight
        warm budget once it is KNOWN to have warm-restored, the
        generous cold-compile allowance otherwise (cold or undecided —
        an undecided child must never be infanticided on the tight
        clock)."""
        return self.warm_ready_timeout_s if warm else self.ready_timeout_s

    # -- lifecycle -----------------------------------------------------------

    def start(self, wait_ready: bool = True,
              monitor: bool = True) -> "SolverSupervisor":
        """Spawn the child (optionally blocking until it probes ready)
        and start the background monitor. ``monitor=False`` skips the
        thread — deterministic tests then drive :meth:`check_once`
        themselves."""
        handle = self._spawn_fn()
        with self._lock:
            self._proc = handle
            self.state = "starting"
            self._spawned_at = self._clock()
            self._ready_since_spawn = False
            self._respawn_warm = None
            self._warm_probe_at = None
        if wait_ready and not self._wait_ready():
            raise TimeoutError(
                f"solver at {self.address!r} not ready within "
                f"{self.ready_timeout_s}s"
            )
        if monitor:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="solver-supervisor"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._lock:
            proc, self._proc = self._proc, None
            self.state = "stopped"
        if proc is not None:
            try:
                proc.kill()
            except OSError:
                pass
            wait = getattr(proc, "wait", None)
            if wait is not None:
                try:
                    # reap: a long-lived scheduler must not accumulate
                    # zombie children across supervisor lifecycles
                    wait(timeout=5)
                except Exception:
                    pass
        SUPERVISOR_UP.set(0)

    def _wait_ready(self) -> bool:
        t0 = self._clock()
        while True:
            if self._probe_fn():
                with self._lock:
                    self.state = "running"
                    self.consecutive_probe_failures = 0
                    self._backoff_attempt = 0
                    self._ready_since_spawn = True
                self.breaker.record_healthy()
                SUPERVISOR_UP.set(1)
                return True
            # the grace is re-evaluated per probe: a child that reports
            # a warm restore mid-wait drops to the tight budget
            warm = self._resolve_warm_outcome()
            if self._clock() - t0 >= self._ready_grace_s(warm):
                return False
            self._sleep(min(0.05, self.probe_interval_s))

    def _run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.check_once()
            except Exception:
                # the monitor must never die: a dead supervisor is the
                # exact failure mode this module exists to remove
                pass
            self._stop_event.wait(self.probe_interval_s)

    # -- one supervision step ------------------------------------------------

    def check_once(self) -> str:
        """Probe the child once and restart it if dead/hung. Returns the
        outcome ("running" | "probe-failed" | "restarted" |
        "breaker-open" | "stopped") — the monitor thread ignores it;
        deterministic tests assert on it."""
        with self._lock:
            if self.state == "stopped":
                return "stopped"
            proc = self._proc
        exit_code = None if proc is None else proc.poll()
        if proc is not None and exit_code is None:
            if self._probe_fn():
                with self._lock:
                    self.consecutive_probe_failures = 0
                    self._backoff_attempt = 0
                    self._ready_since_spawn = True
                    self.state = "running"
                self.breaker.record_healthy()
                SUPERVISOR_UP.set(1)
                SUPERVISOR_BREAKER_OPEN.set(0)
                return "running"
            # probe-budget split: resolved OUTSIDE the lock (the
            # outcome fn may hit the child's debug mux)
            warm = self._resolve_warm_outcome()
            with self._lock:
                # a fresh child that has never probed healthy is still
                # STARTING (PyTorch import, kernel-library load), not
                # hung: failed probes only count once it served, or its
                # ready grace expired. A WARM-restored child gets only
                # the tight warm budget: it has no build to hide behind,
                # so a hung warm respawn dies in seconds
                if (
                    not self._ready_since_spawn
                    and self._clock() - self._spawned_at
                    < self._ready_grace_s(warm)
                ):
                    self.state = "starting"
                    return "starting"
                self.consecutive_probe_failures += 1
                hung = (self.consecutive_probe_failures
                        >= self.probe_failure_threshold)
                if not hung:
                    self.state = "probe-failed"
            SUPERVISOR_UP.set(0)
            if not hung:
                return "probe-failed"
            # alive but unreachable past the threshold: treat as hung —
            # kill, then fall through to the restart path
            try:
                proc.kill()
            except OSError:
                pass
            reason = "hung"
        else:
            reason = "crashed" if proc is not None else "down"
            SUPERVISOR_UP.set(0)
        return self._restart(reason, exit_code)

    def _restart(self, reason: str, exit_code: Optional[int]) -> str:
        from koordinator_tpu_torch.service.client import jittered_backoff

        with self._lock:
            self.last_exit_code = exit_code
            if not self.breaker.allow():
                was_open = self.state == "breaker-open"
                self.state = "breaker-open"
                SUPERVISOR_BREAKER_OPEN.set(1)
                if not was_open:
                    # transition only — a refused respawn repeats every
                    # probe interval and must not spam the span ring
                    TRACER.instant("supervisor-breaker-open",
                                   cat="supervisor")
                return "breaker-open"
            attempt = self._backoff_attempt
            self._backoff_attempt += 1
            self.state = "restarting"
        delay = jittered_backoff(
            self.backoff_base_s, self.backoff_cap_s, attempt, self._rng
        )
        # the backoff wait must honor stop(): a plain sleep here could
        # outlive stop()'s bounded join and then spawn an ORPHAN child
        # nobody supervises or kills
        if self._stop_event.wait(delay):
            return "stopped"
        handle = self._spawn_fn()
        self.breaker.record_restart()
        with self._lock:
            self._proc = handle
            self.restarts_total += 1
            self.consecutive_probe_failures = 0
            self.state = "starting"
            self._spawned_at = self._clock()
            self._ready_since_spawn = False
            self._respawn_warm = None  # fresh child: outcome unknown
            self._warm_probe_at = None
        SUPERVISOR_RESTARTS.inc({"reason": reason})
        TRACER.instant("supervisor-restart", cat="supervisor",
                       args={"reason": reason})
        # from live state, not the trip transition: a half-open respawn
        # leaves the breaker OPEN and the gauge must keep saying so
        SUPERVISOR_BREAKER_OPEN.set(
            1 if self.breaker.status()["open"] else 0
        )
        return "restarted"

    # -- observability -------------------------------------------------------

    def status(self) -> Dict[str, object]:
        with self._lock:
            proc = self._proc
            out = {
                "state": self.state,
                "restarts_total": self.restarts_total,
                "consecutive_probe_failures":
                    self.consecutive_probe_failures,
                "last_exit_code": self.last_exit_code,
                "backoff_attempt": self._backoff_attempt,
                # the probe-budget split: which grace the current child
                # is on, and how many spawns warm-restored
                "respawn_warm": self._respawn_warm,
                "respawns_warm_total": self.respawns_warm_total,
                "ready_grace_s": self._ready_grace_s(self._respawn_warm),
            }
        out["child_pid"] = getattr(proc, "pid", None)
        out["breaker"] = self.breaker.status()
        return out
