"""FailoverSolver: degraded-mode placement through a solver outage
(counterpart of ``koordinator_tpu/service/failover.py``).

``--placement-backend=sidecar`` makes the sidecar the only road to the
device, and one failure domain: ``run_loop`` skips the round whenever
:class:`~koordinator_tpu_torch.service.client.RemoteSolver` gives up.
This backend wraps the remote solver with the failure-domain state
machine:

- **Per-solve fallback.** A remote attempt that ends in
  ``SolverUnavailable``, ``SolverDeadlineExceeded`` or
  ``SolverOverloaded`` is answered by the in-process solve instead of
  raising, so the control plane places pods on every tick, outage or
  not. The local solve is the sidecar's own dispatch
  (``service/server._dispatch_solve``) on the model's device: the
  hand-written placement kernel that ``ops/binpack_kernel.kernel_route``
  names for an eligible solve, the loop ``solve_batch`` for the rest,
  exactly as the sidecar would have solved it. Integer arithmetic end to
  end, so placements are bit-identical. A failed local kernel build or
  launch raises: there is no fallback behind the fallback.
- **Degraded mode.** ``failure_threshold`` consecutive remote failures
  flip the machine to degraded: solves stop paying the remote timeout
  and go straight to the local path, while each solve spends one cheap
  liveness probe (:func:`~koordinator_tpu_torch.service.supervisor.
  connection_probe`) on the sidecar address.
- **Hysteresis.** ``recovery_probes`` consecutive healthy probes flip
  back; one blip during recovery resets the count.
- **Epoch reset on flip-back.** Recovery calls
  ``RemoteSolver.reset_base()`` (the restarted sidecar holds no delta
  base) and the ``on_flip_back`` hook, which the control plane wires to
  ``PlacementModel.reset_staging``: the first request after recovery
  re-establishes the wire base from a full restage.

**Prewarm.** What the first local solve would pay in a scheduler process
is loading the kernel library (``ops/binpack_kernel._library``, which
builds it with ``nvcc`` only when no built copy of these sources is in
``koordinator_tpu_torch/_build/``), making the CUDA context current, and
the first launch of each kernel and each torch op on the solve path
(their modules load lazily). :meth:`FailoverSolver.prewarm` does all of
it in a background thread when the solver is constructed for a CUDA
device (``service/server.warm_up``: one small solve on each kernel
route), and, when the warm pool is active, restores the local twin's
entries (``failover_local_solve``, whose program is the sidecar's: the
signatures a sidecar persisted capture here), so the first degraded
round pays none of it on its critical path.

The flip counters and gauge are in ``metrics/components.py``;
``last_mode`` ("remote" | "local-fallback" | "local-degraded") is what
the model reports as ``last_solver``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.metrics.components import (
    SOLVER_DEGRADED,
    SOLVER_FAILOVERS,
    SOLVER_LOCAL_SOLVES,
)
from koordinator_tpu_torch.obs.device import DEVICE_OBS
from koordinator_tpu_torch.obs.flight import FLIGHT
from koordinator_tpu_torch.obs.trace import TRACER
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import ExtrasRows
from koordinator_tpu_torch.service.client import (
    SolverDeadlineExceeded,
    SolverOverloaded,
    SolverUnavailable,
)
from koordinator_tpu_torch.service.server import (
    _dispatch_solve,
    compact_extras,
    warm_up,
)
from koordinator_tpu_torch.service.supervisor import connection_probe
from koordinator_tpu_torch.service.warmpool import WARM_POOL


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


#: the local twin's kernel solve, adopted into the warm pool with the
#: sidecar's program: a sidecar's persisted signatures warm it
_local_solve = DEVICE_OBS.bind("failover_local_solve", bk.solve_program)
WARM_POOL.adopt(_local_solve, config_argpos=3)


def local_solve(state, batch, params, config, quota_state=None,
                gang_state=None, extras=None, resv=None, numa=None):
    """The in-process solve: the sidecar's ``_dispatch_solve`` on the
    tensors' own device, with the eligibility checks the sidecar makes
    on the wire arrays made here on host copies of the same arrays (the
    reservation and extras score budgets, the kernel's configuration).
    Dense extras are compacted into rows first, as the sidecar does."""
    device = state.alloc.device
    if extras is not None and not isinstance(extras, ExtrasRows):
        row_of_pod, xmask, xscore = compact_extras(_host(extras.mask),
                                                   _host(extras.score))
        extras = ExtrasRows(
            row_of_pod=torch.as_tensor(row_of_pod, device=device),
            mask=torch.as_tensor(xmask, device=device),
            score=torch.as_tensor(xscore, device=device))
    resv_safe = True
    worst = bk.BASE_SCORE_WORST
    if resv is not None:
        node, free, alloc = _host(resv.node), _host(resv.free), \
            _host(state.alloc)
        resv_safe = bk.kernel_resv_score_safe(node, free, alloc)
        worst = bk.resv_score_worst(node, free, alloc)
    extras_safe = True
    if extras is not None:
        extras_safe = bk.kernel_extras_score_safe(_host(extras.score), worst)
    result, _ = _dispatch_solve(
        state, batch, params, config, quota_state, gang_state, extras,
        resv, numa, resv_safe, extras_safe,
        bk.kernel_supported(params, config), binding=_local_solve)
    return result


class FailoverSolver:
    """A PlacementModel backend wrapping :class:`RemoteSolver` with
    degraded-mode failover: a sidecar outage must not skip rounds.
    Drop-in: same ``solve_result`` signature, same
    ``supports_staging_delta`` advertisement. ``device`` is the model's
    (``cuda`` unless given): with a CUDA device and ``prewarm``, the
    kernel library and the CUDA context are loaded in the background at
    construction."""

    def __init__(self, remote,
                 failure_threshold: int = 3,
                 recovery_probes: int = 2,
                 probe_fn: Optional[Callable[[], bool]] = None,
                 probe_timeout_s: float = 0.5,
                 on_flip_back: Optional[Callable[[], None]] = None,
                 clock=time.monotonic,
                 prewarm: bool = True,
                 device: DeviceLike = None):
        self._remote = remote
        self.failure_threshold = failure_threshold
        self.recovery_probes = recovery_probes
        self._probe_fn = probe_fn or (
            lambda: connection_probe(remote.address, probe_timeout_s)
        )
        #: wired post-construction by the control plane (build_scheduler
        #: points it at PlacementModel.reset_staging); set-once wiring,
        #: read-only afterwards, so it is not guarded by the lock
        self.on_flip_back = on_flip_back
        #: fired (outside the lock) right after the machine flips TO
        #: degraded. The pipelined tick loop wires both flip hooks to a
        #: pipeline drain so a mode transition never interleaves with an
        #: in-flight tick's publish; set-once wiring like on_flip_back
        self.on_flip_degraded: Optional[Callable[[], None]] = None
        self._clock = clock
        #: delta staging rides through to the remote solver; the local
        #: path solves the full staged state it is handed anyway
        self.supports_staging_delta = getattr(
            remote, "supports_staging_delta", False
        )
        self._lock = threading.Lock()
        self.degraded = False
        self.degraded_since: Optional[float] = None
        self.consecutive_failures = 0
        self.healthy_probes = 0
        self.flips_to_degraded = 0
        self.flips_to_remote = 0
        self.local_solves = 0
        self.last_error: Optional[str] = None
        #: which path answered the last solve: "remote" |
        #: "local-fallback" (remote tried and failed this solve) |
        #: "local-degraded" (machine flipped, remote not attempted)
        self.last_mode: Optional[str] = None
        self.device = resolve_device(device)
        #: what the background prewarm did (set once by its thread; read
        #: for status)
        self.prewarm_report: Optional[dict] = None
        self._prewarm_done = threading.Event()
        if prewarm and (self.device.type == "cuda"
                        or self._warm_pool().active):
            self.prewarm()
        else:
            self._prewarm_done.set()

    @staticmethod
    def _warm_pool():
        """The pool the local twin is adopted into (tests adopt the
        binding into their own pools; the process uses the singleton)."""
        return getattr(_local_solve, "_warm", None) or WARM_POOL

    def prewarm(self, background: bool = True) -> Optional[dict]:
        """On a CUDA device: load the kernel library, make the CUDA
        context current and run one small solve on each kernel route
        (``service/server.warm_up``); with an active warm pool, restore
        the local twin's entries (the report's ``restored`` and the rest
        of ``WarmPool.restore``'s keys). The first local solve then pays
        none of it. Synchronous when ``background=False``; returns the
        report then."""
        def _go():
            t0 = time.perf_counter()
            try:
                report = {}
                if self.device.type == "cuda":
                    bk._library()
                pool = self._warm_pool()
                if pool.active:
                    report.update(pool.restore(
                        fns=("failover_local_solve",)))
                if self.device.type == "cuda":
                    warm_up(self.device)
                    torch.cuda.synchronize(self.device)
                report.update(loaded=True,
                              wall_s=time.perf_counter() - t0)
            except Exception as e:  # the first local solve raises it
                report = {"loaded": False,
                          "error": f"{type(e).__name__}: {e}"}
            self.prewarm_report = report
            self._prewarm_done.set()
            return report

        self._prewarm_done.clear()
        if not background:
            return _go()
        threading.Thread(target=_go, daemon=True,
                         name="failover-prewarm").start()
        return None

    def wait_prewarm(self, timeout: Optional[float] = None) -> bool:
        """Block until a started prewarm has finished (tests, benches)."""
        return self._prewarm_done.wait(timeout)

    # -- the backend call ----------------------------------------------------

    def solve_result(self, state, batch, params, config,
                     quota_state=None, gang_state=None, extras=None,
                     resv=None, numa=None, staging=None):
        with self._lock:
            degraded = self.degraded
        if degraded:
            if self.maybe_recover():
                return self._remote_solve(
                    state, batch, params, config, quota_state,
                    gang_state, extras, resv, numa, staging,
                )
            return self._local(
                state, batch, params, config, quota_state, gang_state,
                extras, resv, numa, mode="local-degraded",
            )
        return self._remote_solve(
            state, batch, params, config, quota_state, gang_state,
            extras, resv, numa, staging,
        )

    def _remote_solve(self, state, batch, params, config, quota_state,
                      gang_state, extras, resv, numa, staging):
        kwargs = {}
        if staging is not None and getattr(
            self._remote, "supports_staging_delta", False
        ):
            kwargs["staging"] = staging
        try:
            result = self._remote.solve_result(
                state, batch, params, config, quota_state, gang_state,
                extras, resv, numa, **kwargs,
            )
        except (SolverUnavailable, SolverDeadlineExceeded,
                SolverOverloaded) as e:
            # overloaded counts too: the sidecar is alive but SHEDDING
            # this caller past its retry budget — from the scheduler's
            # seat that is indistinguishable from an outage, and
            # letting it escape would crash the round loop outright
            flipped = False
            with self._lock:
                self.consecutive_failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
                if (
                    not self.degraded
                    and self.consecutive_failures >= self.failure_threshold
                ):
                    self.degraded = True
                    self.degraded_since = self._clock()
                    self.healthy_probes = 0
                    self.flips_to_degraded += 1
                    flipped = True
            if flipped:
                SOLVER_FAILOVERS.inc({"direction": "to-degraded"})
                SOLVER_DEGRADED.set(1)
                TRACER.instant("failover-flip", cat="failover",
                               args={"direction": "to-degraded"})
                FLIGHT.trigger(
                    "failover-flip",
                    detail=f"to-degraded: {type(e).__name__}: {e}",
                )
                if self.on_flip_degraded is not None:
                    self.on_flip_degraded()
            return self._local(
                state, batch, params, config, quota_state, gang_state,
                extras, resv, numa, mode="local-fallback",
            )
        with self._lock:
            self.consecutive_failures = 0
            self.last_mode = "remote"
        return result

    def _local(self, state, batch, params, config, quota_state,
               gang_state, extras, resv, numa, mode: str):
        result = local_solve(
            state, batch, params, config, quota_state, gang_state,
            extras, resv, numa,
        )
        with self._lock:
            self.local_solves += 1
            self.last_mode = mode
        SOLVER_LOCAL_SOLVES.inc({"mode": mode})
        return result

    # -- recovery ------------------------------------------------------------

    def maybe_recover(self) -> bool:
        """One hysteresis step: spend a probe on the sidecar; after
        ``recovery_probes`` consecutive healthy ones, flip back to
        remote (with the epoch reset). Called automatically by every
        degraded solve; idle loops may call it between ticks to recover
        without waiting for traffic. Returns True iff this call flipped
        the machine back."""
        with self._lock:
            if not self.degraded:
                return False
        ok = self._probe_fn()
        recovered = False
        with self._lock:
            if not self.degraded:
                return False
            if ok:
                self.healthy_probes += 1
                if self.healthy_probes >= self.recovery_probes:
                    self.degraded = False
                    self.degraded_since = None
                    self.healthy_probes = 0
                    self.consecutive_failures = 0
                    self.flips_to_remote += 1
                    recovered = True
            else:
                self.healthy_probes = 0
        if recovered:
            # the restarted sidecar holds no delta base: drop ours, and
            # let the model rebuild its staged world from scratch so the
            # re-established base starts from a full restage
            reset = getattr(self._remote, "reset_base", None)
            if reset is not None:
                reset()
            if self.on_flip_back is not None:
                self.on_flip_back()
            SOLVER_FAILOVERS.inc({"direction": "to-remote"})
            SOLVER_DEGRADED.set(0)
            TRACER.instant("failover-flip", cat="failover",
                           args={"direction": "to-remote"})
            FLIGHT.trigger("failover-flip", detail="to-remote: recovered")
        return recovered

    # -- plumbing ------------------------------------------------------------

    def close(self) -> None:
        close = getattr(self._remote, "close", None)
        if close is not None:
            close()

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "degraded": self.degraded,
                "degraded_for_s": (
                    None if self.degraded_since is None
                    else self._clock() - self.degraded_since
                ),
                "consecutive_failures": self.consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "healthy_probes": self.healthy_probes,
                "recovery_probes": self.recovery_probes,
                "flips_to_degraded": self.flips_to_degraded,
                "flips_to_remote": self.flips_to_remote,
                "local_solves": self.local_solves,
                "last_mode": self.last_mode,
                "last_error": self.last_error,
                "prewarm": self.prewarm_report,
            }
