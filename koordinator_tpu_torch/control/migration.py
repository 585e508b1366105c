"""The arbitrated eviction control plane (docs/DESIGN.md §27; a copy of
``koordinator_tpu/control/migration.py``).

Reference: the Koordinator descheduler's MigrationController arbitration
(pkg/descheduler/controllers/migration: filter chain + per-node /
per-namespace eviction quotas + workload max-unavailable), which exists
so that re-placement pressure — however many strategies generate it —
never becomes an outage. Our repro has four independent eviction
sources: the device preemption solve (§24), the operator-called
``defrag_headroom`` API, the LoadAware rebalance sweep
(``descheduler/loadaware.py``), and working-set demotions (§26). The
:class:`MigrationArbiter` is the single choke point all of them pass
through before a victim is actually evicted.

Contract (mirrors the quota semantics of the reference's
``arbitrator`` + ``EvictionLimiter``):

- Declared disruption budgets: per-node, per-tenant (QoS lane), and
  per-round eviction caps, each over a rolling ``window_s`` window,
  plus a per-node cooldown after an admitted eviction and a gang
  min-available guard (a request may carry per-gang headroom — how many
  more members the gang can lose before violating ``min_member``).
- Over-budget requests are **deferred with a typed, counted refusal**
  — never dropped silently: the caller gets the admitted prefix and a
  ``(uid, reason)`` list for the rest, every deferral lands in the
  ``scheduler_migration_deferrals_total{source,reason}`` counter, and
  the whole decision is a typed record in a bounded ring.
- ``dry_run`` classifies without acting: the verdict reports what WOULD
  be admitted, ``apply`` is False, and no window bookkeeping commits.
- The unlimited default budget admits everything with zero bookkeeping
  effects beyond the record — every legacy path stays bit-identical.
- Working-set demotions are **undeferrable**: demotion is the memory
  safety valve (refusing one trades an SLO wobble for an OOM), so they
  flow through :meth:`MigrationArbiter.note` — recorded and counted
  against the same windows, never deferred.

Replay determinism: like the SLO controller (§25), decisions must
re-derive bit-for-bit from the recorded requests alone —
:func:`replay_requests` re-drives a fresh arbiter over a recorded ring
and the chaos suite asserts equality. No wall clock or ambient
randomness may leak into the policy; ``now`` is injected (ctor
``clock`` for defaults, explicit per call for the schedulers).

:class:`DefragController` closes the loop on ``defrag_headroom``: the
reconcile-on-the-pump pattern from ``control/slo.py`` watching a
fragmentation signal — the largest schedulable hole vs the smallest
pending gang's member demand — and applying ONE bounded repack per
cooldown through the arbiter, with hysteretic confirmation against
thrash.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.metrics.components import (
    DEFRAG_DECISIONS,
    MIGRATION_ADMITTED,
    MIGRATION_DEFERRALS,
    MIGRATION_REQUESTS,
)

#: every eviction source that may pass through the arbiter — the
#: ``source`` metric label domain (graftcheck metrics-hygiene audits
#: this enumeration against the emit sites)
SOURCES = ("preemption", "defrag", "rebalance", "workingset")

#: every typed deferral reason, in CHECK PRECEDENCE ORDER: a victim
#: violating several budgets is counted under the first — the
#: ``reason`` values the deferral counter may emit
REASONS = ("cooldown", "round-budget", "node-budget", "tenant-budget",
           "gang-min-available")


@dataclasses.dataclass(frozen=True)
class MigrationBudget:
    """Declared disruption budgets. ``None`` caps are unlimited; the
    all-``None`` default is the bit-identical legacy configuration
    (every request admits in full, no cooldowns, no deferral)."""

    #: admitted evictions per scheduling round (all sources combined)
    max_per_round: Optional[int] = None
    #: admitted evictions per node within ``window_s``
    max_per_node: Optional[int] = None
    #: admitted evictions per tenant/QoS lane within ``window_s``
    max_per_tenant: Optional[int] = None
    #: rolling budget window in seconds
    window_s: float = 60.0
    #: per-node quiet period after an admitted eviction on that node
    node_cooldown_s: float = 0.0
    #: classify-only mode: verdicts report, nothing commits
    dry_run: bool = False

    @property
    def unlimited(self) -> bool:
        return (
            self.max_per_round is None
            and self.max_per_node is None
            and self.max_per_tenant is None
            and self.node_cooldown_s <= 0.0
            and not self.dry_run
        )


class MigrationVerdict(NamedTuple):
    """One request's outcome: the admitted prefix (in request order),
    the typed deferrals, and whether the caller may act (``apply`` is
    False under ``dry_run``)."""

    admitted: Tuple[str, ...]
    deferred: Tuple[Tuple[str, str], ...]   # (uid, reason)
    apply: bool
    record: dict


class MigrationArbiter:
    """The choke point. Thread contract: schedulers request from loop
    threads, the chaos saboteur squeezes budgets from test drivers,
    debug-mux/flight readers snapshot the rings — one ``_lock`` over
    the budget, every window deque, and both bounded rings. The lock
    is a leaf: nothing is called out to while holding it."""

    def __init__(
        self,
        budget: Optional[MigrationBudget] = None,
        clock: Callable[[], float] = time.monotonic,
        ring_capacity: int = 512,
    ):
        self._clock = clock
        self._lock = threading.Lock()
        self._budget = budget or MigrationBudget()
        #: bounded decision ring: every verdict, replay-deterministic
        self._ring: deque = deque(maxlen=ring_capacity)
        #: admitted-eviction timestamps per node / lane / gang (purged
        #: past ``window_s``)
        self._node_times: Dict[str, deque] = {}
        self._lane_times: Dict[str, deque] = {}
        self._gang_times: Dict[str, deque] = {}
        #: last admitted-eviction time per node (cooldown gate)
        self._node_last: Dict[str, float] = {}
        #: the current round key + its admitted count
        self._round_key: Optional[int] = None
        self._round_count = 0
        self._requests_total = 0
        self._admitted_total = 0
        self._deferred_total = 0
        self._deferred_reasons: Dict[str, int] = {}
        self._seq = 0

    # -- budget ---------------------------------------------------------------

    def set_budget(self, budget: MigrationBudget) -> None:
        """Swap the declared budget live (operator retune, or the
        chaos ``budget-squeeze-mid-wave`` fault). Window history is
        KEPT: a squeeze mid-wave judges the new caps against the
        evictions already admitted in the window."""
        with self._lock:
            self._budget = budget

    def budget(self) -> MigrationBudget:
        with self._lock:
            return self._budget

    def begin_round(self, round_key: int) -> None:
        """Start a scheduling round: the per-round cap counts admitted
        evictions (all sources) until the next ``begin_round``."""
        with self._lock:
            if round_key != self._round_key:
                self._round_key = round_key
                self._round_count = 0

    # -- the decision ---------------------------------------------------------

    def request(
        self,
        source: str,
        node: Optional[str],
        uids: Sequence[str],
        lanes: Optional[Sequence[Optional[str]]] = None,
        gangs: Optional[Sequence[Optional[str]]] = None,
        gang_headroom: Optional[Dict[str, int]] = None,
        now: Optional[float] = None,
        all_or_nothing: bool = False,
    ) -> MigrationVerdict:
        """Arbitrate one eviction batch. ``uids`` are judged in order
        (partial admission: the caller evicts exactly the admitted
        list). ``lanes[i]``/``gangs[i]`` annotate victim i;
        ``gang_headroom[g]`` is how many more members gang ``g`` may
        lose before violating its min-available. ``all_or_nothing``
        defers the WHOLE batch when any member would be deferred (the
        preemption contract: a preemptor's victim set is indivisible —
        a partial evict would burn budget without freeing the hole)."""
        if source not in SOURCES:
            raise ValueError(f"unknown migration source {source!r}")
        uids = tuple(uids)
        lanes = tuple(lanes) if lanes is not None else (None,) * len(uids)
        gangs = tuple(gangs) if gangs is not None else (None,) * len(uids)
        if len(lanes) != len(uids) or len(gangs) != len(uids):
            raise ValueError("lanes/gangs must align with uids")
        if now is None:
            now = self._clock()
        with self._lock:
            return self._request_locked(
                source, node, uids, lanes, gangs,
                dict(gang_headroom or {}), float(now), all_or_nothing,
            )

    def _request_locked(self, source, node, uids, lanes, gangs,
                        gang_headroom, now, all_or_nothing):
        budget = self._budget
        self._purge_locked(now)
        admitted: List[str] = []
        admitted_lanes: List[Optional[str]] = []
        admitted_gangs: List[Optional[str]] = []
        deferred: List[Tuple[str, str]] = []
        # tentative in-request increments so one batch can't overshoot
        lane_inc: Dict[str, int] = {}
        gang_inc: Dict[str, int] = {}
        node_inc = 0
        for uid, lane, gang in zip(uids, lanes, gangs):
            reason = self._refusal_locked(
                budget, now, node, lane, gang, gang_headroom,
                node_inc, lane_inc.get(lane, 0), gang_inc.get(gang, 0),
                len(admitted),
            )
            if reason is None:
                admitted.append(uid)
                admitted_lanes.append(lane)
                admitted_gangs.append(gang)
                node_inc += 1
                if lane is not None:
                    lane_inc[lane] = lane_inc.get(lane, 0) + 1
                if gang is not None:
                    gang_inc[gang] = gang_inc.get(gang, 0) + 1
            else:
                deferred.append((uid, reason))
        if all_or_nothing and deferred:
            # the batch refusal is typed by the FIRST violation; members
            # that would have been admitted defer under the same reason
            reason = deferred[0][1]
            deferred = [(uid, reason) for uid in uids]
            admitted, admitted_lanes, admitted_gangs = [], [], []
        apply = not budget.dry_run
        if apply and admitted:
            for lane, gang in zip(admitted_lanes, admitted_gangs):
                self._commit_locked(now, node, lane, gang)
            self._round_count += len(admitted)
        self._seq += 1
        record = {
            "seq": self._seq,
            "now": now,
            "source": source,
            "node": node,
            "round": self._round_key,
            "uids": list(uids),
            "lanes": list(lanes),
            "gangs": list(gangs),
            "gang_headroom": dict(gang_headroom),
            "all_or_nothing": bool(all_or_nothing),
            "admitted": list(admitted),
            "deferred": [{"uid": u, "reason": r} for u, r in deferred],
            "dry_run": budget.dry_run,
        }
        self._ring.append(record)
        self._requests_total += len(uids)
        if apply:
            self._admitted_total += len(admitted)
        self._deferred_total += len(deferred)
        for _, r in deferred:
            self._deferred_reasons[r] = self._deferred_reasons.get(r, 0) + 1
        MIGRATION_REQUESTS.inc({"source": source}, len(uids))
        if apply and admitted:
            MIGRATION_ADMITTED.inc({"source": source}, len(admitted))
        for _, r in deferred:
            MIGRATION_DEFERRALS.inc({"source": source, "reason": r})
        return MigrationVerdict(
            tuple(admitted), tuple(deferred), apply, record
        )

    def _refusal_locked(self, budget, now, node, lane, gang,
                        gang_headroom, node_inc, lane_n, gang_n,
                        batch_admitted):
        """The typed refusal for ONE victim, or None to admit — checks
        in REASONS precedence order, counting both the committed window
        state and this batch's tentative admissions."""
        if budget.node_cooldown_s > 0.0 and node is not None:
            last = self._node_last.get(node)
            # a within-batch admission also arms the cooldown: one
            # admitted victim per node per request under a cooldown
            if node_inc > 0 or (
                last is not None and now - last < budget.node_cooldown_s
            ):
                return "cooldown"
        if budget.max_per_round is not None:
            if self._round_count + batch_admitted >= budget.max_per_round:
                return "round-budget"
        if budget.max_per_node is not None and node is not None:
            have = len(self._node_times.get(node, ())) + node_inc
            if have >= budget.max_per_node:
                return "node-budget"
        if budget.max_per_tenant is not None and lane is not None:
            have = len(self._lane_times.get(lane, ())) + lane_n
            if have >= budget.max_per_tenant:
                return "tenant-budget"
        if gang is not None and gang in gang_headroom:
            lost = len(self._gang_times.get(gang, ())) + gang_n
            if lost >= max(int(gang_headroom[gang]), 0):
                return "gang-min-available"
        return None

    def _commit_locked(self, now, node, lane, gang) -> None:
        if node is not None:
            self._node_times.setdefault(node, deque()).append(now)
            self._node_last[node] = now
        if lane is not None:
            self._lane_times.setdefault(lane, deque()).append(now)
        if gang is not None:
            self._gang_times.setdefault(gang, deque()).append(now)

    def _purge_locked(self, now: float) -> None:
        horizon = now - self._budget.window_s
        for times in (self._node_times, self._lane_times,
                      self._gang_times):
            for key in list(times):
                dq = times[key]
                while dq and dq[0] <= horizon:
                    dq.popleft()
                if not dq:
                    del times[key]

    # -- the undeferrable source ---------------------------------------------

    def note(self, source: str, node: Optional[str], uids: Sequence[str],
             lanes: Optional[Sequence[Optional[str]]] = None,
             now: Optional[float] = None) -> None:
        """Record an eviction that already happened and MUST happen
        (working-set demotions: the memory-pressure safety valve —
        refusing one trades an SLO wobble for an OOM). Counted against
        the same windows so budget views stay whole-truth; never
        deferred."""
        if source not in SOURCES:
            raise ValueError(f"unknown migration source {source!r}")
        uids = tuple(uids)
        lanes = tuple(lanes) if lanes is not None else (None,) * len(uids)
        if now is None:
            now = self._clock()
        with self._lock:
            self._purge_locked(now)
            for lane in lanes:
                self._commit_locked(float(now), node, lane, None)
            self._seq += 1
            record = {
                "seq": self._seq,
                "now": float(now),
                "source": source,
                "node": node,
                "round": self._round_key,
                "uids": list(uids),
                "lanes": list(lanes),
                "gangs": [None] * len(uids),
                "gang_headroom": {},
                "all_or_nothing": False,
                "admitted": list(uids),
                "deferred": [],
                "dry_run": False,
                "undeferrable": True,
            }
            self._ring.append(record)
            self._requests_total += len(uids)
            self._admitted_total += len(uids)
        MIGRATION_REQUESTS.inc({"source": source}, len(uids))
        MIGRATION_ADMITTED.inc({"source": source}, len(uids))

    # -- observability --------------------------------------------------------

    def decisions(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def status(self) -> dict:
        """The debug-mux ``migration`` service payload."""
        with self._lock:
            budget = self._budget
            return {
                "budget": dataclasses.asdict(budget),
                "unlimited": budget.unlimited,
                "requests_total": self._requests_total,
                "admitted_total": self._admitted_total,
                "deferred_total": self._deferred_total,
                "deferred_by_reason": dict(self._deferred_reasons),
                "round": self._round_key,
                "round_admitted": self._round_count,
                "window_nodes": {
                    k: len(v) for k, v in self._node_times.items()
                },
                "window_lanes": {
                    k: len(v) for k, v in self._lane_times.items()
                },
                "decisions": list(self._ring)[-16:],
            }

    def flight_payload(self) -> dict:
        """Flight-recorder hook: the compact decision tail."""
        with self._lock:
            return {
                "deferred_total": self._deferred_total,
                "deferred_by_reason": dict(self._deferred_reasons),
                "decisions": list(self._ring)[-32:],
            }


def replay_requests(budget: MigrationBudget,
                    records: Sequence[dict]) -> List[dict]:
    """Re-drive a fresh arbiter over a recorded decision ring and
    return the re-derived records: the replay-determinism contract is
    that they equal the originals field-for-field (modulo ``seq``
    origin, which restarts at 1 — compare rings recorded from a fresh
    arbiter). ``begin_round`` transitions are reconstructed from the
    recorded ``round`` keys; undeferrable notes replay as notes."""
    fresh = MigrationArbiter(budget=budget, clock=lambda: 0.0)
    out: List[dict] = []
    for rec in records:
        if rec.get("round") is not None:
            fresh.begin_round(rec["round"])
        if rec.get("undeferrable"):
            fresh.note(rec["source"], rec["node"], rec["uids"],
                       lanes=rec["lanes"], now=rec["now"])
        else:
            fresh.request(
                rec["source"], rec["node"], rec["uids"],
                lanes=rec["lanes"], gangs=rec["gangs"],
                gang_headroom=rec.get("gang_headroom") or {},
                now=rec["now"],
                all_or_nothing=rec.get("all_or_nothing", False),
            )
        out.append(fresh.decisions()[-1])
    return out


# -- the closed defrag loop ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DefragPolicy:
    """The defrag controller's declared behavior (all knobs bounded,
    mirroring the SLO controller's shape)."""

    #: reconcile cadence gate (maybe_reconcile no-ops inside it)
    interval_s: float = 5.0
    #: quiet period between applied repacks: ONE bounded action per
    #: cooldown
    cooldown_s: float = 30.0
    #: hysteresis: consecutive fragmented observations before acting
    confirm: int = 2
    #: classify and record without calling defrag_headroom
    dry_run: bool = False


class DefragController:
    """Close the loop on ``defrag_headroom`` (docs/DESIGN.md §27).

    Reconcile-on-the-pump (the §25 pattern): each reconcile observes
    the whole truth — the fragmentation signal is *largest schedulable
    hole vs pending gang demand*: a pending gang whose member shape
    fits NO schedulable node even though aggregate free capacity could
    hold it is fragmentation the repack can fix. The pure policy step
    (streak + confirm + cooldown) then decides at most one action; the
    action is ``scheduler.defrag_headroom(..., apply=True)``, which
    itself routes its drains through the arbiter — the controller
    never out-evicts the declared budgets.

    Thread contract: the loop thread reconciles, debug-mux/flight
    readers snapshot the rings — one ``_lock`` over policy state and
    both rings, never held across the scheduler's locks (observe and
    apply run outside it)."""

    def __init__(
        self,
        scheduler,
        policy: Optional[DefragPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        ring_capacity: int = 256,
        observation_capacity: int = 2048,
    ):
        self.scheduler = scheduler
        self.policy = policy or DefragPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring_capacity)
        self._obs_ring: deque = deque(maxlen=observation_capacity)
        self._streak = 0
        self._last_decision_now: Optional[float] = None
        self._last_reconcile_at: Optional[float] = None
        self._decisions_total = 0
        self._seq = 0

    # -- observe --------------------------------------------------------------

    def observe(self, now: float) -> dict:
        """One whole-truth observation. Free capacity is requests-based
        (allocatable minus the request vectors of assigned pods — the
        same arithmetic the solver packs against); demand is the
        elementwise-max member request of each pending gang."""
        from koordinator_tpu_torch.apis.extension import NUM_RESOURCES
        from koordinator_tpu_torch.apis.types import resources_to_vector

        snapshot = self.scheduler.cache.snapshot(now=now)
        used: Dict[str, np.ndarray] = {}
        for pod in snapshot.pods:
            if not pod.node_name:
                continue
            vec = resources_to_vector(pod.requests)
            if pod.node_name in used:
                used[pod.node_name] = used[pod.node_name] + vec
            else:
                used[pod.node_name] = vec.copy()
        zeros = np.zeros(NUM_RESOURCES, dtype=np.int64)
        free_rows = []
        for node in snapshot.nodes:
            if node.unschedulable:
                continue
            free_rows.append(
                resources_to_vector(node.allocatable)
                - used.get(node.name, zeros)
            )
        free = (np.stack(free_rows) if free_rows
                else np.zeros((0, NUM_RESOURCES), dtype=np.int64))
        total_free = free.sum(axis=0) if free.size else zeros
        # pending gang demand: per gang, the elementwise-max member
        # request (the hole one member needs) + the min member priority
        # (drains must stay strictly below the preemptor's band)
        demands: Dict[str, np.ndarray] = {}
        floors: Dict[str, int] = {}
        for pod in snapshot.pending_pods:
            if not pod.gang:
                continue
            vec = resources_to_vector(pod.requests)
            if pod.gang in demands:
                demands[pod.gang] = np.maximum(demands[pod.gang], vec)
                floors[pod.gang] = min(floors[pod.gang], pod.priority)
            else:
                demands[pod.gang] = vec
                floors[pod.gang] = pod.priority
        frag_gang = None
        frag_demand = None
        for gang in sorted(demands):
            demand = demands[gang]
            fits_now = bool(
                free.size and (demand[None, :] <= free).all(axis=1).any()
            )
            capacity_exists = bool((demand <= total_free).all())
            if not fits_now and capacity_exists:
                if frag_demand is None or (
                    int(demand.sum()) < int(frag_demand.sum())
                ):
                    frag_gang = gang
                    frag_demand = demand
        obs = {
            "seq": 0,
            "now": float(now),
            "frag": frag_gang is not None,
            "gang": frag_gang,
            "demand": (
                None if frag_demand is None else frag_demand.tolist()
            ),
            "max_victim_priority": (
                None if frag_gang is None else floors[frag_gang]
            ),
            "pending_gangs": len(demands),
            "total_free": total_free.tolist(),
        }
        with self._lock:
            self._seq += 1
            obs["seq"] = self._seq
            self._obs_ring.append(obs)
        return obs

    # -- the pure policy step -------------------------------------------------

    def step(self, obs: dict) -> Optional[dict]:
        with self._lock:
            return self._step_locked(obs)

    def _step_locked(self, obs: dict) -> Optional[dict]:
        # streak bookkeeping EVERY reconcile, decision gates after
        if obs["frag"]:
            self._streak += 1
        else:
            self._streak = 0
            return None
        if self._streak < max(int(self.policy.confirm), 1):
            return None
        now = obs["now"]
        if (
            self._last_decision_now is not None
            and now - self._last_decision_now < self.policy.cooldown_s
        ):
            return None
        self._last_decision_now = now
        self._streak = 0
        self._decisions_total += 1
        decision = {
            "seq": obs["seq"],
            "now": now,
            "signal": "frag-over",
            "gang": obs["gang"],
            "demand": obs["demand"],
            "max_victim_priority": obs["max_victim_priority"],
            "dry_run": self.policy.dry_run,
        }
        self._ring.append(decision)
        return decision

    # -- reconcile ------------------------------------------------------------

    def reconcile(self, now: Optional[float] = None,
                  force: bool = False) -> Optional[dict]:
        if now is None:
            now = self._clock()
        with self._lock:
            if not force and self._last_reconcile_at is not None and (
                now - self._last_reconcile_at < self.policy.interval_s
            ):
                return None
            self._last_reconcile_at = now
        obs = self.observe(now)
        decision = self.step(obs)
        if decision is None:
            return None
        DEFRAG_DECISIONS.inc({"signal": "frag-over"})
        if not self.policy.dry_run:
            got = self.scheduler.defrag_headroom(
                np.asarray(decision["demand"], dtype=np.int64),
                decision["max_victim_priority"],
                apply=True,
                now=now,
            )
            outcome = {
                "node": None if got is None else got[0],
                "drains": [] if got is None else list(got[1]),
            }
        else:
            outcome = {"node": None, "drains": [], "skipped": "dry-run"}
        with self._lock:
            decision["outcome"] = outcome
        return decision

    def maybe_reconcile(self, now: Optional[float] = None):
        return self.reconcile(now=now, force=False)

    # -- observability --------------------------------------------------------

    def decisions_total(self) -> int:
        with self._lock:
            return self._decisions_total

    def status(self) -> dict:
        with self._lock:
            return {
                "policy": dataclasses.asdict(self.policy),
                "streak": self._streak,
                "decisions_total": self._decisions_total,
                "last_decision_now": self._last_decision_now,
                "decisions": list(self._ring)[-16:],
                "observations": len(self._obs_ring),
            }

    def flight_payload(self) -> dict:
        with self._lock:
            return {
                "decisions": list(self._ring)[-16:],
                "observations": list(self._obs_ring)[-16:],
            }

    def replay_decisions(self) -> List[dict]:
        """Re-drive a FRESH policy over the recorded observation ring
        (the §25 replay contract): the re-derived decision stream must
        equal the recorded ring bit-for-bit (modulo the post-hoc
        ``outcome`` annotation, which is the applied world's answer,
        not the policy's)."""
        with self._lock:
            observations = list(self._obs_ring)
        fresh = DefragController(
            scheduler=None, policy=self.policy, clock=lambda: 0.0,
        )
        out: List[dict] = []
        for obs in observations:
            d = fresh._step_locked(dict(obs))
            if d is not None:
                out.append(d)
        return out
