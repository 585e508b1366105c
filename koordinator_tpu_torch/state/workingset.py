"""HBM working-set manager: graceful degradation for staged worlds
(counterpart of ``koordinator_tpu/state/workingset.py``).

Every staged world (the in-process ``models.placement.StagedStateCache``,
the sidecar's per-(connection, tenant) ``NodeStateCache``) registers here
under one process-wide byte budget (``--hbm-budget-bytes``), priced by
its ``device_bytes()`` (the bytes of its staged tensors, as the device
observatory's owner attribution counts them), and a three-rung residency
ladder governs device memory:

- **device**: fully staged; solves run against the live generation.
- **host**: the staged tensors are dropped, the host arrays (and the
  delta-protocol epoch) are kept: the next solve re-uploads through the
  existing staging path, bit-identical, with no re-lower and no epoch
  movement.
- **cold**: the host arrays are dropped too; the next solve re-lowers
  from typed truth (``state.cluster.lower_nodes`` in-process; the typed
  ``delta-base-mismatch`` -> re-establish handshake over the wire).

Demotion is policy, never a crash: victims are chosen best-effort lane
first, then lightest ``TenantRegistry`` weight, then least recently
used, and a world whose owner is mid-solve or holds a pinned generation
is skipped (the owners' demotion hooks take their locks without
blocking and refuse a pinned world: the port scatters delta rows in
place, so dropping a generation a solve still reads would hand it freed
rows). Admission of a new world demotes victims instead of allocating
past the line. An allocation failure at the stage or scatter boundary, a
real ``torch.cuda.OutOfMemoryError`` or an injected one, caught by
:meth:`WorkingSetManager.run_staged`, triggers the same demotion plus a
bounded retry ladder; every outcome is typed and counted
(``scheduler_workingset_*`` in ``metrics/components.py``), and
placements are bit-identical at every rung because each rung re-enters a
staging path the delta tests already hold.

The budget is priced by ``device_bytes()``, as in the reference, not by
the CUDA caching allocator: a demotion lowers
``torch.cuda.memory_allocated()`` by the world's bytes, while
``memory_reserved()`` may stay where it was (the allocator keeps the
blocks for the next staging).

Determinism: the manager keeps a logical clock (a counter bumped per
touch), not wall time, so victim order is a pure function of the
registration and touch history.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from typing import Callable, Dict, Optional

import torch

from koordinator_tpu_torch.metrics.components import (
    HBM_BUDGET_BYTES,
    HBM_USED_BYTES,
    TENANT_RESIDENCY,
    WORKINGSET_ALLOC_FAILURES,
    WORKINGSET_DEMOTIONS,
    WORKINGSET_RESTAGES,
)

RUNG_DEVICE = "device"
RUNG_HOST = "host"
RUNG_COLD = "cold"
RUNGS = (RUNG_DEVICE, RUNG_HOST, RUNG_COLD)

#: victim precedence per QoS lane — best-effort worlds demote first,
#: system worlds (the scheduler's own staged cluster) demote last,
#: mirroring the admission gate's shed policy in reverse
_LANE_DEMOTE_RANK = {"be": 0, "ls": 1, "system": 2}

#: alloc-failure boundaries — the ``reason`` label domain of
#: ``scheduler_workingset_alloc_failures_total``
FAIL_STAGE = "stage"
FAIL_SCATTER = "scatter"
FAIL_WHERE = (FAIL_STAGE, FAIL_SCATTER)


class WorkingSetError(RuntimeError):
    """Base of the typed working-set failure family."""


class InjectedAllocFailure(WorkingSetError):
    """A chaos-armed allocation failure, raised at the same boundary a
    real ``torch.cuda.OutOfMemoryError`` surfaces (before the staging
    callable runs, so a retry after demotion re-executes it exactly
    once)."""


class WorkingSetExhausted(WorkingSetError):
    """The bounded demote+retry ladder ran out: allocation still fails
    with nothing left to demote. Callers surface this as a typed error
    response (the sidecar's never-crash boundary) — a solve may fail
    loudly under true exhaustion, it may never be dropped silently."""


def is_alloc_failure(exc: BaseException) -> bool:
    """Whether ``exc`` is a device allocation failure the demote+retry
    ladder should absorb: the chaos-injected kind, a
    ``torch.cuda.OutOfMemoryError`` (its message is "CUDA out of
    memory"), or a runtime error whose message carries the XLA
    out-of-memory vocabulary."""
    if isinstance(exc, (InjectedAllocFailure, torch.cuda.OutOfMemoryError)):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return "RESOURCE_EXHAUSTED" in text or "Out of memory" in text \
        or "out of memory" in text


class _Resident:
    """One registered staged world (bookkeeping only — the world itself
    is held by weakref so an abandoned cache can never be kept alive,
    or demoted, by its accounting entry)."""

    __slots__ = ("key", "ref", "tenant", "lane", "weight", "rung",
                 "bytes", "last_use")

    def __init__(self, key: str, obj, tenant: str, lane: str,
                 weight: float):
        self.key = key
        self.ref = weakref.ref(obj)
        self.tenant = tenant
        self.lane = lane if lane in _LANE_DEMOTE_RANK else "ls"
        self.weight = float(weight)
        self.rung = RUNG_DEVICE
        self.bytes = 0
        self.last_use = 0

    def order_key(self):
        # demote best-effort first, then lightest weight, then LRU;
        # the key breaks exact ties deterministically
        return (_LANE_DEMOTE_RANK[self.lane], self.weight,
                self.last_use, self.key)


class WorkingSetManager:
    """The process-wide residency ledger and demotion engine.

    Lock shape: every mutable attribute below is
    guarded by ``_lock``, and the manager NEVER holds ``_lock`` while
    calling into a resident — victim lists are collected under the
    lock, the residents' ``demote_device()``/``demote_cold()`` hooks
    (which take their OWN locks, non-blocking) run outside it, and the
    accounting is re-entered afterwards. A resident calling back into
    the manager while holding its own lock (``touch`` from inside
    ``StagedStateCache.ensure``) therefore cannot deadlock: the only
    cross-object acquisition order is resident → manager."""

    def __init__(self, budget_bytes: Optional[int] = None, *,
                 max_alloc_retries: int = 4):
        self._lock = threading.Lock()
        self._residents: Dict[str, _Resident] = {}
        self._budget: Optional[int] = None
        self._squeeze: float = 1.0
        self._clock = 0
        self._auto = 0
        self._seq = 0
        self._events: deque = deque(maxlen=64)
        self._counts: Dict[str, Dict[str, int]] = {
            "demotions": {}, "restages": {}, "alloc_failures": {},
        }
        self._faults: Dict[str, int] = {}
        self._oversubscribed = 0
        self.max_alloc_retries = int(max_alloc_retries)
        #: migration-arbiter notification hook, ``(key, lane, reason)``
        #: (set by ``cmd/scheduler.build_scheduler`` to
        #: ``arbiter.note``). Demotions are UNDEFERRABLE — they are
        #: the memory-pressure safety valve, so they are recorded and
        #: counted against the disruption windows but never refused.
        #: Called with no lock held (beside the demotion counter).
        self.migration_hook: Optional[Callable[[str, str, str], None]] = None
        if budget_bytes:
            self.set_budget(budget_bytes)

    # -- registration --------------------------------------------------------

    def register(self, key: str, obj, *, tenant: str = "default",
                 lane: str = "ls", weight: float = 1.0) -> str:
        """Track ``obj`` (anything with ``device_bytes()`` /
        ``demote_device()`` / ``demote_cold()``) under ``key``. A new
        world starts on the device rung with 0 priced bytes — its first
        :meth:`touch` prices it and enforces the budget."""
        with self._lock:
            self._residents[key] = _Resident(key, obj, tenant, lane,
                                             weight)
        self._publish()
        return key

    def register_auto(self, prefix: str, obj, **kw) -> str:
        """Register under a generated ``prefix-N`` key (N monotone per
        process — deterministic given construction order)."""
        with self._lock:
            self._auto += 1
            n = self._auto
        return self.register(f"{prefix}-{n}", obj, **kw)

    def drop(self, key: str) -> None:
        """Forget a world (connection closed, cache LRU-evicted). The
        bytes come off the ledger; the arrays die with their owner."""
        with self._lock:
            self._residents.pop(key, None)
        self._publish()

    # -- budget --------------------------------------------------------------

    def set_budget(self, budget_bytes: Optional[int]) -> None:
        """(Re)set the byte line; 0/None means unlimited. Shrinking the
        line enforces immediately (demotions count ``budget``)."""
        budget = int(budget_bytes) if budget_bytes else None
        with self._lock:
            self._budget = budget
        HBM_BUDGET_BYTES.set(budget or 0)
        self.enforce(reason="budget")

    def squeeze(self, fraction: float) -> int:
        """One transient budget squeeze to ``fraction`` of the line
        (the ``budget-squeeze-mid-churn`` chaos fault): demote down to
        the squeezed line NOW, then restore the configured budget.
        Returns how many demotions it forced."""
        fraction = min(max(float(fraction), 0.0), 1.0)
        with self._lock:
            self._squeeze = fraction
        try:
            return self.enforce(reason="budget")
        finally:
            with self._lock:
                self._squeeze = 1.0

    def budget_bytes(self) -> Optional[int]:
        with self._lock:
            return self._budget

    def device_bytes(self) -> int:
        """Priced bytes currently on the device rung (the ledger view —
        repriced at each owner's last touch, no sync)."""
        with self._lock:
            return self._used_locked()

    def _used_locked(self) -> int:
        return sum(r.bytes for r in self._residents.values()
                   if r.rung == RUNG_DEVICE)

    def _effective_budget_locked(self) -> Optional[int]:
        if self._budget is None:
            return None
        return int(self._budget * self._squeeze)

    # -- the residency ledger ------------------------------------------------

    def touch(self, key: Optional[str], nbytes: Optional[int] = None,
              lane: Optional[str] = None) -> None:
        """Mark ``key`` used now and reprice it. A demoted world coming
        back with device bytes is a RESTAGE (counted by the rung it
        returns from); going over the line afterwards demotes victims
        (never ``key`` itself — the world just used is the protected
        one)."""
        if key is None:
            return
        with self._lock:
            r = self._residents.get(key)
            obj = None if r is None else r.ref()
        if nbytes is None and obj is not None:
            # priced outside the ledger's lock: ``device_bytes`` takes the
            # resident's own lock, which a thread inside its ``ensure``
            # holds while it enters ``run_staged`` (and so this lock);
            # taking them in the other order here would deadlock the two
            try:
                nbytes = int(obj.device_bytes())
            except Exception:
                nbytes = None
        with self._lock:
            r = self._residents.get(key)
            if r is None:
                return
            self._clock += 1
            r.last_use = self._clock
            if lane in _LANE_DEMOTE_RANK:
                r.lane = lane
            if nbytes is not None:
                r.bytes = int(nbytes)
            if r.bytes > 0 and r.rung != RUNG_DEVICE:
                self._count_locked("restages", r.rung)
                WORKINGSET_RESTAGES.inc({"reason": r.rung})
                self._event_locked(r, r.rung, RUNG_DEVICE, "restage")
                r.rung = RUNG_DEVICE
        self.enforce(protect=key, reason="budget")

    def admit(self, key: Optional[str], nbytes: int) -> None:
        """Make headroom for ``nbytes`` about to be staged under
        ``key``: demote victims until the line holds, BEFORE the
        allocation — never allocate past the line and hope."""
        with self._lock:
            budget = self._effective_budget_locked()
            if budget is None:
                return
            need = self._used_locked() + int(nbytes) - budget
        if need > 0:
            self._demote_until(protect=key, reason="admission",
                               over_bytes=need)

    def enforce(self, protect: Optional[str] = None,
                reason: str = "budget") -> int:
        """Demote device-rung victims until priced usage fits the
        (possibly squeezed) line. Returns demotions applied."""
        with self._lock:
            budget = self._effective_budget_locked()
            if budget is None:
                self._publish_locked()
                return 0
            over = self._used_locked() - budget
        n = 0
        if over > 0:
            n = self._demote_until(protect=protect, reason=reason,
                                   over_bytes=over)
        self._publish()
        return n

    def _demote_until(self, protect: Optional[str], reason: str,
                      over_bytes: int) -> int:
        """Demote device→host victims (policy order) until
        ``over_bytes`` is freed or no victim remains; residents whose
        owner is busy (lock held) or gone are skipped. Oversubscription
        — the protected world alone is over the line — is counted, not
        fought: the solve proceeds and the NEXT admission re-balances."""
        freed = 0
        demoted = 0
        skipped: set = set()
        while freed < over_bytes:
            with self._lock:
                candidates = sorted(
                    (r for r in self._residents.values()
                     if r.rung == RUNG_DEVICE and r.key != protect
                     and r.key not in skipped),
                    key=_Resident.order_key,
                )
            if not candidates:
                with self._lock:
                    self._oversubscribed += 1
                break
            victim = candidates[0]
            obj = victim.ref()
            if obj is None:
                # owner gone: the entry's bytes were phantom charge —
                # prune and credit them without a demotion hook call
                with self._lock:
                    self._residents.pop(victim.key, None)
                freed += victim.bytes
                continue
            ok = False
            try:
                ok = bool(obj.demote_device())
            except Exception:
                ok = False
            if not ok:
                skipped.add(victim.key)
                continue
            with self._lock:
                freed += victim.bytes
                victim.bytes = 0
                self._count_locked("demotions", reason)
                self._event_locked(victim, RUNG_DEVICE, RUNG_HOST,
                                   reason)
                victim.rung = RUNG_HOST
            WORKINGSET_DEMOTIONS.inc({"reason": reason})
            if self.migration_hook is not None:
                self.migration_hook(victim.key, victim.lane, reason)
            demoted += 1
        self._publish()
        return demoted

    def demote(self, key: str, rung: str = RUNG_HOST,
               reason: str = "budget") -> bool:
        """Demote ONE named resident through its hooks with full
        ledger bookkeeping (tests and operator actions — the policy
        paths above pick their own victims). Returns False when the
        resident is unknown, gone, already at/below ``rung``, or its
        owner refuses (busy / pinned)."""
        if rung not in (RUNG_HOST, RUNG_COLD):
            raise ValueError(f"cannot demote to rung {rung!r}")
        with self._lock:
            r = self._residents.get(key)
            obj = None if r is None else r.ref()
            rung_from = None if r is None else r.rung
            lane = None if r is None else r.lane
        if obj is None or rung_from == RUNG_COLD or rung_from == rung:
            return False
        try:
            ok = bool(obj.demote_cold() if rung == RUNG_COLD
                      else obj.demote_device())
        except Exception:
            ok = False
        if not ok:
            return False
        with self._lock:
            r = self._residents.get(key)
            if r is not None:
                r.bytes = 0
                self._count_locked("demotions", reason)
                self._event_locked(r, rung_from, rung, reason)
                r.rung = rung
        WORKINGSET_DEMOTIONS.inc({"reason": reason})
        if self.migration_hook is not None:
            self.migration_hook(key, lane, reason)
        self._publish()
        return True

    def _demote_for_failure(self, protect: Optional[str]) -> int:
        """The allocation-failure response: free aggressively — demote
        every idle device-rung victim, and when the device rung is
        already empty, escalate the coldest host-rung world to cold
        (dropping host arrays can be what lets a host-RAM-backed device
        allocator breathe, and cold is the ladder's typed last rung)."""
        n = self._demote_until(protect=protect, reason="alloc-failure",
                               over_bytes=1 << 62)
        if n:
            return n
        with self._lock:
            hosts = sorted(
                (r for r in self._residents.values()
                 if r.rung == RUNG_HOST and r.key != protect),
                key=_Resident.order_key,
            )
        for victim in hosts:
            obj = victim.ref()
            if obj is None:
                with self._lock:
                    self._residents.pop(victim.key, None)
                continue
            try:
                ok = bool(obj.demote_cold())
            except Exception:
                ok = False
            if not ok:
                continue
            with self._lock:
                self._count_locked("demotions", "alloc-failure")
                self._event_locked(victim, RUNG_HOST, RUNG_COLD,
                                   "alloc-failure")
                victim.rung = RUNG_COLD
            WORKINGSET_DEMOTIONS.inc({"reason": "alloc-failure"})
            if self.migration_hook is not None:
                self.migration_hook(victim.key, victim.lane,
                                    "alloc-failure")
            self._publish()
            return 1
        return 0

    # -- the stage/scatter boundary ------------------------------------------

    def run_staged(self, key: Optional[str], where: str,
                   fn: Callable, estimate: Optional[int] = None):
        """Run ``fn`` — a device allocation: a full world staging
        (``where="stage"``) or a delta row scatter (``"scatter"``) —
        under the demote+retry contract. ``estimate`` (bytes about to
        land) makes headroom FIRST via :meth:`admit`; an allocation
        failure (a real ``torch.cuda.OutOfMemoryError`` or chaos-armed)
        is counted typed, answered by demotion, and retried a bounded
        number of times; exhaustion raises :class:`WorkingSetExhausted` — loud,
        typed, never silent."""
        if where not in FAIL_WHERE:
            raise ValueError(f"unknown staging boundary {where!r}")
        if estimate:
            self.admit(key, estimate)
        attempts = 0
        while True:
            try:
                self._consume_fault(where)
                return fn()
            except Exception as e:
                if not is_alloc_failure(e):
                    raise
                with self._lock:
                    self._count_locked("alloc_failures", where)
                WORKINGSET_ALLOC_FAILURES.inc({"reason": where})
                attempts += 1
                if attempts > self.max_alloc_retries:
                    raise WorkingSetExhausted(
                        f"device allocation at the {where} boundary "
                        f"still failing after {attempts} attempts with "
                        f"demotion between each; nothing left to evict"
                    ) from e
                self._demote_for_failure(protect=key)

    # -- chaos ---------------------------------------------------------------

    def arm_fault(self, where: str, n: int = 1) -> None:
        """Arm ``n`` injected allocation failures at ``where`` — each
        :meth:`run_staged` call there consumes one and raises BEFORE
        invoking its callable, so the post-demotion retry replays the
        staging exactly once (bit-identity by construction)."""
        if where not in FAIL_WHERE:
            raise ValueError(f"unknown staging boundary {where!r}")
        with self._lock:
            self._faults[where] = self._faults.get(where, 0) + int(n)

    def _consume_fault(self, where: str) -> None:
        with self._lock:
            pending = self._faults.get(where, 0)
            if pending <= 0:
                return
            self._faults[where] = pending - 1
        raise InjectedAllocFailure(
            f"injected allocation failure at the {where} boundary"
        )

    # -- accounting internals ------------------------------------------------

    def _count_locked(self, family: str, reason: str) -> None:
        c = self._counts[family]
        c[reason] = c.get(reason, 0) + 1

    def _event_locked(self, r: _Resident, rung_from: str, rung_to: str,
                      reason: str) -> None:
        self._seq += 1
        self._events.append({
            "seq": self._seq, "key": r.key, "tenant": r.tenant,
            "lane": r.lane, "from": rung_from, "to": rung_to,
            "reason": reason, "bytes": r.bytes,
        })

    def _publish_locked(self):
        used = self._used_locked()
        by_rung = {rung: 0 for rung in RUNGS}
        for r in self._residents.values():
            by_rung[r.rung] += 1
        return used, by_rung

    def _publish(self) -> None:
        with self._lock:
            used, by_rung = self._publish_locked()
        HBM_USED_BYTES.set(used)
        for rung, n in by_rung.items():
            TENANT_RESIDENCY.set(n, {"rung": rung})

    # -- read side -----------------------------------------------------------

    def status(self) -> dict:
        """The debug-mux / ``status()["workingset"]`` body: the budget
        line, per-rung census, typed counters, and the heaviest
        residents (bounded rows — 256 tenants do not serialize 256
        rows on every status poll)."""
        with self._lock:
            used, by_rung = self._publish_locked()
            rows = sorted(
                self._residents.values(),
                key=lambda r: (-r.bytes, r.key),
            )[:32]
            return {
                "budget_bytes": self._budget or 0,
                "effective_budget_bytes":
                    self._effective_budget_locked() or 0,
                "used_bytes": used,
                "residents": by_rung,
                "demotions": dict(self._counts["demotions"]),
                "restages": dict(self._counts["restages"]),
                "alloc_failures": dict(self._counts["alloc_failures"]),
                "oversubscribed": self._oversubscribed,
                "armed_faults": {
                    k: v for k, v in self._faults.items() if v
                },
                "rows": [
                    {"key": r.key, "tenant": r.tenant, "lane": r.lane,
                     "rung": r.rung, "bytes": r.bytes,
                     "weight": r.weight, "last_use": r.last_use}
                    for r in rows
                ],
            }

    def flight_payload(self) -> dict:
        """The flight recorder's ``workingset`` section: who got
        demoted and why — the bounded event ring plus the headline
        ledger, cached-only (a dump never walks live arrays)."""
        with self._lock:
            used, by_rung = self._publish_locked()
            return {
                "budget_bytes": self._budget or 0,
                "used_bytes": used,
                "residents": by_rung,
                "demotions": dict(self._counts["demotions"]),
                "restages": dict(self._counts["restages"]),
                "alloc_failures": dict(self._counts["alloc_failures"]),
                "events": list(self._events),
            }

    def pressure(self) -> dict:
        """The device observatory's compact section (obs/device.py
        ``live_snapshot``): line, charge, census — one lock hold."""
        with self._lock:
            used, by_rung = self._publish_locked()
            return {
                "budget_bytes": self._budget or 0,
                "used_bytes": used,
                "residents": by_rung,
            }

    def reset(self) -> None:
        """Forget every resident, fault, and local count (tests; the
        process singleton is shared). The global metric counters are
        monotone by contract and deliberately not reset."""
        with self._lock:
            self._residents.clear()
            self._budget = None
            self._squeeze = 1.0
            self._clock = 0
            self._seq = 0
            self._events.clear()
            self._counts = {
                "demotions": {}, "restages": {}, "alloc_failures": {},
            }
            self._faults = {}
            self._oversubscribed = 0
        HBM_BUDGET_BYTES.set(0)
        self._publish()


#: the process singleton every staged-world cache registers with —
#: unlimited until cmd wiring (or a test) sets ``--hbm-budget-bytes``
WORKING_SET = WorkingSetManager()


def _register_surfaces() -> None:
    # the flight recorder's `workingset` section and the observatory's
    # pressure view, registered once per process (last registration wins)
    from koordinator_tpu_torch.obs.device import DEVICE_OBS
    from koordinator_tpu_torch.obs.flight import FLIGHT

    FLIGHT.register_payload("workingset", WORKING_SET.flight_payload)
    DEVICE_OBS.set_pressure_source(WORKING_SET.pressure)


_register_surfaces()
