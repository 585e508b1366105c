"""Deterministic fault injection for the solver boundary and the HBM
working set: the port's copy of what its tests and ``chip_smoke.py``
need of ``koordinator_tpu/testing/chaos.py``.

- :class:`FaultSchedule` maps ordinals (ticks) to fault kinds, scripted
  or generated from a seed.
- :class:`HBMSaboteur` executes the scheduled device-memory-pressure
  faults (:data:`HBM_FAULT_KINDS`) against the working-set manager.
- :class:`InProcessSidecar` wraps a :class:`PlacementService` in a
  subprocess-like handle (``poll``/``kill``/``pid``), so a
  :class:`~koordinator_tpu_torch.service.supervisor.SolverSupervisor`
  can supervise, and a test can kill and restart, a sidecar without a
  process start per respawn.

The reference's wire proxy (``ChaosProxy``), its state saboteur and the
fault kinds they execute are not ported yet; a schedule here takes the
HBM kinds only.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional

#: device-memory-pressure fault kinds: every one must degrade through the
#: typed demote-and-retry ladder with counted outcomes, and placements
#: stay bit-identical to a fault-free run
HBM_FAULT_KINDS = (
    "alloc-fail-stage",          # an allocation failure at the next staging
    "alloc-fail-scatter",        # an allocation failure at the next scatter
    "budget-squeeze-mid-churn",  # budget transiently halved: forced
                                 # demotions under live multi-tenant load
)


class FaultSchedule:
    """Ordinal (0-based) -> fault kind. ``events`` pins faults
    explicitly; :meth:`generate` derives a schedule from a seed."""

    def __init__(self, events: Optional[Dict[int, str]] = None):
        self.events = dict(events or {})
        for kind in self.events.values():
            if kind not in HBM_FAULT_KINDS:
                raise ValueError(f"unknown fault kind: {kind!r}")

    @classmethod
    def generate(cls, seed: int, n_requests: int, rate: float = 0.2,
                 kinds=HBM_FAULT_KINDS, start: int = 0) -> "FaultSchedule":
        """A seeded schedule over ``[start, start+n_requests)``: each
        ordinal faulted with probability ``rate``, the kind drawn
        uniformly (the reference's draws: same seed, same schedule)."""
        rng = random.Random(seed)
        events: Dict[int, str] = {}
        for i in range(start, start + n_requests):
            if rng.random() < rate:
                events[i] = kinds[rng.randrange(len(kinds))]
        return cls(events)

    def fault_for(self, ordinal: int) -> Optional[str]:
        return self.events.get(ordinal)


class HBMSaboteur:
    """Executes a schedule's :data:`HBM_FAULT_KINDS` against a
    working-set manager (``WORKING_SET`` unless given):

    - ``alloc-fail-stage`` / ``alloc-fail-scatter``: arm one injected
      allocation failure at that boundary; the next staging (or scatter)
      raises before any device work runs, forcing the typed
      demote-and-retry ladder, whose retry runs the callable once.
    - ``budget-squeeze-mid-churn``: the budget is halved and enforced
      (residents demote, best-effort lanes first), then restored.

    ``inject(tick)`` returns the kind applied (None when nothing was
    scheduled); ``injected`` counts per kind and ``log`` keeps ``(tick,
    kind, detail)``."""

    def __init__(self, schedule: FaultSchedule, manager=None):
        from koordinator_tpu_torch.state.workingset import WORKING_SET

        self.schedule = schedule
        self.manager = manager if manager is not None else WORKING_SET
        self.injected: Dict[str, int] = {}
        self.log: list = []

    def inject(self, tick: int) -> Optional[str]:
        kind = self.schedule.fault_for(tick)
        if kind is None:
            return None
        detail = getattr(self, "_" + kind.replace("-", "_"))()
        self.injected[kind] = self.injected.get(kind, 0) + 1
        self.log.append((tick, kind, detail))
        return kind

    def _alloc_fail_stage(self) -> str:
        self.manager.arm_fault("stage")
        return "armed:stage"

    def _alloc_fail_scatter(self) -> str:
        self.manager.arm_fault("scatter")
        return "armed:scatter"

    def _budget_squeeze_mid_churn(self) -> str:
        demoted = self.manager.squeeze(0.5)
        return f"squeezed:demoted={demoted}"


class InProcessSidecar:
    """A :class:`PlacementService` behind a subprocess-like handle:
    ``kill()`` severs every live connection and stops serving (what a
    SIGKILL looks like at the wire), ``poll()`` reports the exit code,
    and a respawn is a fresh handle on the same address.
    ``service_kwargs`` go to the service (``device="cpu"`` on a machine
    without CUDA)."""

    _next_pid = [1000]

    def __init__(self, address, **service_kwargs):
        from koordinator_tpu_torch.service.server import PlacementService

        self._service = PlacementService(address, **service_kwargs)
        self._service.start()
        self._returncode: Optional[int] = None
        self._lock = threading.Lock()
        InProcessSidecar._next_pid[0] += 1
        self.pid = InProcessSidecar._next_pid[0]

    def poll(self) -> Optional[int]:
        with self._lock:
            return self._returncode

    def kill(self) -> None:
        with self._lock:
            if self._returncode is not None:
                return
            self._returncode = -9
        self._service.stop()

    terminate = kill

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        return self.poll()

    @property
    def service(self):
        return self._service
