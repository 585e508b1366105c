"""ServingSLOController: the serving path's NodeSLO reconcile loop
(counterpart of ``koordinator_tpu/control/slo.py``).

Reference: koord-manager's slo-controller re-derives node policy from a
declared SLO plus observed metrics. This module closes that loop on the
streaming serving mode's knobs (``scheduler/streaming.py``: the
watermark, the per-lane deadlines, the intake capacity):

- **Inputs** (one :meth:`ServingSLOController.observe` snapshot per
  reconcile): the rolling per-lane submit→bind p99 and the folded
  shed/deadline-exceeded counts from ``PodTimelines.stats(window_s=)``,
  the current knob values, and the device observatory's kernel-library
  build count and padding waste. The port never pads a batch, so its
  observation carries a padding waste of 0.0 and the ``padding-waste``
  signal cannot fire from its own observations; :meth:`step` is the
  reference's policy on any observation, a non-zero waste included.
- **Policy** (:meth:`ServingSLOController.step`, a pure function of the
  observation and the controller's own state): bounded, hysteretic, at
  most one knob per reconcile, each move followed by a cooldown. A
  confirmed lane p99 breach tightens that lane's deadline (halving,
  floored, then the watermark halves instead); window shed pressure
  doubles the intake capacity (capped); high padding waste while
  comfortably in-SLO doubles the watermark (only until the first
  latency-driven watermark cut); a sustained comfortably-under lane
  relaxes its deadline back toward the configured base. A relax that
  breaches burns its ceiling, so the moves are bounded on the halving
  ladder and the loop cannot oscillate.
- **Auditability**: every decision is a typed record (signal, observed
  vs target, knob, old→new) in a bounded ring served on the debug mux
  (``/apis/v1/plugins/slo``) and stamped into flight-recorder dumps; the
  observation ring beside it makes the sequence replay-deterministic:
  :func:`replay_decisions` re-drives a fresh policy over the recorded
  observations and reproduces the decision log bit for bit.
- **HA**: the applied knob state is published (fenced while leading) as
  a ``Kind.NODE_SLO`` bus object; a promoted standby adopts it before
  its first round (``StreamingLoop.on_promoted`` ->
  :meth:`ServingSLOController.on_promoted`).

Concurrency: the loop thread drives :meth:`maybe_reconcile`; the debug
mux and flight recorder read :meth:`status` / :meth:`flight_payload`.
``_lock`` guards the rings and the policy state; it is never held across
the gate's, the timelines' or the bus's locks (observe and apply run
outside it).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from koordinator_tpu_torch.metrics.components import (
    SLO_DECISIONS,
    SLO_LANE_P99_RATIO,
)
from koordinator_tpu_torch.obs.timeline import LANES

#: decision trigger signals (bounded label domain)
SIGNALS = ("p99-over", "p99-under", "shed-capacity", "padding-waste")
#: the knobs the controller may move (bounded label domain)
KNOBS = ("watermark", "deadline", "capacity")

#: the bus object carrying the applied knob state across failover
DEFAULT_STATE_NAME = "koord-serving-slo"


def _parse_lane_slo(spec) -> Optional[float]:
    """One lane's declared target: ``None``/``""`` (lane ungoverned),
    a float (p99 seconds), or the flag string ``"p99=0.02"``."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, (int, float)):
        return float(spec)
    text = str(spec).strip()
    if "=" in text:
        key, _, value = text.partition("=")
        if key.strip() != "p99":
            raise ValueError(
                f"unknown SLO objective {key.strip()!r} (only p99=<s>)"
            )
        return float(value)
    return float(text)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declared per-lane submit→bind p99 targets (seconds). ``None``
    leaves a lane ungoverned — its knobs still move when OTHER signals
    (shed, padding) fire, but no latency target is enforced."""

    system: Optional[float] = None
    ls: Optional[float] = None
    be: Optional[float] = None

    @classmethod
    def parse(cls, system=None, ls=None, be=None) -> "SLOSpec":
        """Build from ``--slo-{system,ls,be}`` flag strings
        (``"p99=0.02"`` or a bare float literal)."""
        return cls(
            system=_parse_lane_slo(system),
            ls=_parse_lane_slo(ls),
            be=_parse_lane_slo(be),
        )

    def target(self, lane: str) -> Optional[float]:
        return getattr(self, lane)

    def any(self) -> bool:
        return any(self.target(lane) is not None for lane in LANES)

    def as_dict(self) -> Dict[str, Optional[float]]:
        return {lane: self.target(lane) for lane in LANES}


@dataclasses.dataclass(frozen=True)
class KnobBounds:
    """Hard actuator bounds — the controller NEVER steps a knob past
    these, whatever the signals say."""

    watermark_min: int = 1
    watermark_max: int = 4096
    #: the deadline halving floor: below this a round per pod is
    #: already firing as fast as the dispatch path can go
    deadline_floor_s: float = 0.0005
    capacity_max: int = 65536


class ServingSLOController:
    """The reconcile loop closing declared per-lane SLOs onto the
    streaming knobs. See the module docstring for the contract;
    ``loop=None`` builds a policy-only instance (what
    :func:`replay_decisions` drives)."""

    def __init__(self, loop=None, spec: SLOSpec = SLOSpec(),
                 *, bounds: KnobBounds = KnobBounds(),
                 bus=None, elector=None,
                 state_name: str = DEFAULT_STATE_NAME,
                 clock: Callable[[], float] = time.monotonic,
                 window_s: float = 5.0,
                 reconcile_interval_s: float = 0.25,
                 cooldown_s: float = 1.0,
                 min_samples: int = 8,
                 breach_rounds: int = 2,
                 relax_rounds: int = 8,
                 relax_frac: float = 0.5,
                 waste_threshold: float = 0.5,
                 ring_capacity: int = 256,
                 observation_capacity: int = 2048,
                 device=None, log: Callable = print):
        self._loop = loop
        self.spec = spec
        self.bounds = bounds
        self.bus = bus
        self.elector = elector
        self.state_name = state_name
        self._clock = clock
        self.window_s = window_s
        self.reconcile_interval_s = reconcile_interval_s
        self.cooldown_s = cooldown_s
        self.min_samples = min_samples
        self.breach_rounds = breach_rounds
        self.relax_rounds = relax_rounds
        self.relax_frac = relax_frac
        self.waste_threshold = waste_threshold
        self._log = log
        if device is None:
            from koordinator_tpu_torch.obs.device import DEVICE_OBS

            device = DEVICE_OBS
        self._device = device
        #: the relax ceiling starts at the CONFIGURED base deadline —
        #: the controller tightens below it and relaxes back toward
        #: it, never above (captured at attach, before any retune)
        base = (None if loop is None
                else tuple(loop.cfg.lane_deadline_s))
        self._lock = threading.Lock()
        #: typed decision records, bounded (the debug-mux/flight ring)
        self._ring: deque = deque(maxlen=ring_capacity)
        #: one observation per reconcile — the replay substrate
        self._obs_ring: deque = deque(maxlen=observation_capacity)
        self._decisions_total = 0
        self._last_reconcile_at: Optional[float] = None
        self._adopted = False
        # -- pure policy state (advanced only by step()) -----------------
        self._seq = 0
        self._breach = {lane: 0 for lane in LANES}
        self._under = {lane: 0 for lane in LANES}
        #: per-lane max deadline a relax may reach; a relax whose value
        #: then breaches BURNS this down to the tightened value, so the
        #: failed rung is never retried (the anti-oscillation bound)
        self._relax_cap = {
            lane: (base[i] if base is not None else None)
            for i, lane in enumerate(LANES)
        }
        self._last_relax: Dict[str, float] = {}
        #: padding-driven watermark raises are permitted only until the
        #: first latency-driven watermark cut (one-way ratchet)
        self._wm_raise_ok = True
        self._last_decision_now: Optional[float] = None

    # -- observation ---------------------------------------------------------

    def observe(self, now: Optional[float] = None) -> dict:
        """Snapshot every input the policy is allowed to see. The
        returned dict is the WHOLE truth for :meth:`step` — replaying
        recorded observations reproduces the decisions bit-for-bit."""
        at = self._clock() if now is None else now
        knobs = self._knobs()
        lanes: Dict[str, dict] = {}
        timelines = getattr(getattr(self._loop, "scheduler", None),
                            "timelines", None)
        if timelines is not None:
            stats = timelines.stats(window_s=self.window_s)
            for lane in LANES:
                st = stats.get(lane)
                if st is not None:
                    lanes[lane] = {
                        "count": st["count"],
                        "p99_s": st["p99_s"],
                        "shed": dict(st.get("shed", {})),
                    }
        # the kernel-library builds this process recorded (the same
        # events DEVICE_COMPILES counts); the port never pads a batch,
        # so its padding waste is 0.0
        device = {"compiles": 0, "padding_waste": 0.0}
        if self._device is not None:
            try:
                device = {"compiles": int(self._device.compiles_total),
                          "padding_waste": 0.0}
            except Exception:
                pass
        with self._lock:
            self._seq += 1
            seq = self._seq
        return {
            "seq": seq,
            "now": at,
            "window_s": self.window_s,
            "lanes": lanes,
            "knobs": knobs,
            "device": device,
        }

    def _knobs(self) -> dict:
        if self._loop is None:
            return {}
        cfg = self._loop.cfg
        return {
            "watermark": cfg.watermark,
            "lane_deadline_s": list(cfg.lane_deadline_s),
            "capacity": cfg.capacity,
        }

    # -- the pure policy step ------------------------------------------------

    def step(self, obs: dict) -> Optional[dict]:
        """Advance the policy on one observation; returns at most one
        typed decision (NOT yet applied). Pure with respect to
        ``(obs, controller state)`` — no clocks, no gate, no bus —
        which is what makes the decision log replay-deterministic."""
        with self._lock:
            return self._step_locked(obs)

    def _step_locked(self, obs: dict) -> Optional[dict]:
        lanes = obs.get("lanes", {})
        knobs = obs.get("knobs", {})
        deadlines = list(knobs.get("lane_deadline_s", ()))
        if not deadlines:
            return None

        def lane_shed(st: dict) -> int:
            return sum(st.get("shed", {}).values())

        # 1. streak bookkeeping — EVERY reconcile, cooldown or not:
        # hysteresis counts consecutive confirmations, and a cooldown
        # window's observations still confirm or refute
        for i, lane in enumerate(LANES):
            target = self.spec.target(lane)
            if target is None:
                continue
            st = lanes.get(lane)
            sampled = (st is not None and st["count"] >= self.min_samples
                       and st["p99_s"] is not None)
            breached = sampled and st["p99_s"] > target
            under = (sampled and st["p99_s"] <= self.relax_frac * target
                     and lane_shed(st) == 0)
            self._breach[lane] = self._breach[lane] + 1 if breached else 0
            self._under[lane] = self._under[lane] + 1 if under else 0
        # 2. cooldown: one knob per window, hysteresis keeps counting
        if (self._last_decision_now is not None
                and obs["now"] - self._last_decision_now
                < self.cooldown_s):
            return None

        def decide(signal: str, lane: Optional[str], knob: str,
                   observed, target, old, new) -> dict:
            self._last_decision_now = obs["now"]
            return {
                "seq": obs["seq"],
                "now": obs["now"],
                "signal": signal,
                "lane": lane,
                "knob": knob,
                "observed": observed,
                "target": target,
                "old": old,
                "new": new,
            }

        # 3. confirmed p99 breach: tighten that lane's deadline
        # (system outranks ls outranks be), then the watermark
        for i, lane in enumerate(LANES):
            target = self.spec.target(lane)
            if target is None or self._breach[lane] < self.breach_rounds:
                continue
            observed = lanes[lane]["p99_s"]
            old_d = deadlines[i]
            new_d = max(self.bounds.deadline_floor_s, old_d / 2.0)
            if new_d < old_d:
                if abs(self._last_relax.get(lane, -1.0) - old_d) < 1e-12:
                    # this value was reached by a relax and breached:
                    # burn the ceiling so it is never retried
                    self._relax_cap[lane] = new_d
                self._breach[lane] = 0
                return decide("p99-over", lane, "deadline",
                              observed, target, old_d, new_d)
            watermark = knobs.get("watermark", 0)
            if watermark > self.bounds.watermark_min:
                new_w = max(self.bounds.watermark_min, watermark // 2)
                self._wm_raise_ok = False
                self._breach[lane] = 0
                return decide("p99-over", lane, "watermark",
                              observed, target, watermark, new_w)
            # both actuators floored: nothing left to tighten
            self._breach[lane] = 0
        # 4. window shed pressure: the intake is refusing arrivals —
        # grow it (bounded; BE-first shedding still protects the lanes)
        shed_cap = sum(
            st.get("shed", {}).get("capacity", 0)
            for st in lanes.values()
        )
        capacity = knobs.get("capacity", 0)
        if shed_cap > 0 and capacity < self.bounds.capacity_max:
            new_c = min(self.bounds.capacity_max, capacity * 2)
            return decide("shed-capacity", None, "capacity",
                          shed_cap, 0, capacity, new_c)
        # 5. padding waste while comfortably in-SLO: bigger batches
        # fill the pow2 buckets (one-way: never after a latency-driven
        # watermark cut)
        waste = obs.get("device", {}).get("padding_waste", 0.0)
        watermark = knobs.get("watermark", 0)
        in_slo = all(
            self._breach[lane] == 0
            and (lanes.get(lane) is None
                 or lanes[lane]["p99_s"] is None
                 or lanes[lane]["p99_s"] <= self.spec.target(lane))
            for lane in LANES if self.spec.target(lane) is not None
        )
        if (self._wm_raise_ok and waste > self.waste_threshold
                and shed_cap == 0 and in_slo
                and watermark < self.bounds.watermark_max):
            new_w = min(self.bounds.watermark_max, watermark * 2)
            return decide("padding-waste", None, "watermark",
                          waste, self.waste_threshold, watermark, new_w)
        # 6. sustained comfortably-under: relax the most-expendable
        # tightened lane back toward its base (be first — relaxing the
        # strictest lane last), capped by the (possibly burned) ceiling
        for i, lane in reversed(list(enumerate(LANES))):
            target = self.spec.target(lane)
            cap = self._relax_cap[lane]
            if (target is None or cap is None
                    or self._under[lane] < self.relax_rounds):
                continue
            old_d = deadlines[i]
            new_d = min(cap, old_d * 2.0)
            if new_d > old_d:
                self._last_relax[lane] = new_d
                self._under[lane] = 0
                return decide("p99-under", lane, "deadline",
                              lanes[lane]["p99_s"], target, old_d, new_d)
        return None

    # -- reconcile (the loop thread) -----------------------------------------

    def maybe_reconcile(self, now: Optional[float] = None
                        ) -> Optional[dict]:
        """Reconcile if the interval elapsed (the StreamingLoop calls
        this every pump/trigger iteration)."""
        return self.reconcile(now=now, force=False)

    def reconcile(self, now: Optional[float] = None,
                  force: bool = True) -> Optional[dict]:
        """One observe → step → apply → record pass. Returns the
        applied decision (None when held)."""
        at = self._clock() if now is None else now
        with self._lock:
            if (not force and self._last_reconcile_at is not None
                    and at - self._last_reconcile_at
                    < self.reconcile_interval_s):
                return None
            self._last_reconcile_at = at
        obs = self.observe(now=at)
        with self._lock:
            self._obs_ring.append(obs)
            decision = self._step_locked(obs)
            if decision is not None:
                self._ring.append(decision)
                self._decisions_total += 1
        if decision is not None:
            self._apply(decision)
            self._publish_state(obs["seq"])
            SLO_DECISIONS.inc({
                "knob": decision["knob"], "signal": decision["signal"],
            })
            self._log(
                f"slo: {decision['signal']} "
                f"lane={decision['lane']} {decision['knob']} "
                f"{decision['old']} -> {decision['new']} "
                f"(observed {decision['observed']} vs "
                f"target {decision['target']})"
            )
        self._publish_gauges(obs)
        return decision

    def _apply(self, decision: dict) -> None:
        if self._loop is None:
            return
        gate = self._loop.gate
        knob = decision["knob"]
        if knob == "watermark":
            gate.retune(watermark=decision["new"])
        elif knob == "capacity":
            gate.retune(capacity=decision["new"])
        elif knob == "deadline":
            lane_idx = LANES.index(decision["lane"])
            deadlines = list(gate.cfg.lane_deadline_s)
            deadlines[lane_idx] = decision["new"]
            gate.retune(lane_deadline_s=tuple(deadlines))

    def _publish_gauges(self, obs: dict) -> None:
        for lane in LANES:
            target = self.spec.target(lane)
            st = obs.get("lanes", {}).get(lane)
            if target is None or st is None or st["p99_s"] is None:
                continue
            SLO_LANE_P99_RATIO.set(st["p99_s"] / target, {"lane": lane})

    # -- HA: knob-state handoff over the bus ---------------------------------

    def _publish_state(self, seq: int) -> None:
        """Publish the applied knob state as a ``Kind.NODE_SLO`` bus
        object (the reference slo-controller's output object), fenced
        while leading — a deposed zombie's late publish must not
        clobber the new leader's convergence."""
        if self.bus is None:
            return
        from koordinator_tpu_torch.client.bus import Kind

        state = {"seq": seq, "knobs": self._knobs(),
                 "decisions_total": self.decisions_total()}

        def _apply_state():
            self.bus.apply(Kind.NODE_SLO, self.state_name, state)

        if self.elector is not None:
            from koordinator_tpu_torch.client.leaderelection import (
                FencingError,
            )

            try:
                self.elector.fenced(_apply_state)
            except FencingError:
                self._log("slo: knob-state publish fenced "
                          "(lease lost); dropping")
        else:
            _apply_state()

    def on_promoted(self) -> bool:
        """Adopt the previous leader's published knob state (called
        from StreamingLoop.on_promoted before the intake sweep).
        Returns True when state was adopted."""
        if self.bus is None or self._loop is None:
            return False
        from koordinator_tpu_torch.client.bus import Kind

        state = self.bus.get(Kind.NODE_SLO, self.state_name)
        if not state:
            return False
        knobs = state.get("knobs", {})
        self._loop.gate.retune(
            watermark=knobs.get("watermark"),
            lane_deadline_s=(
                tuple(knobs["lane_deadline_s"])
                if knobs.get("lane_deadline_s") else None
            ),
            capacity=knobs.get("capacity"),
        )
        with self._lock:
            self._adopted = True
        self._log(f"slo: adopted knob state seq={state.get('seq')} "
                  f"on promotion")
        return True

    # -- read side -----------------------------------------------------------

    def decisions_total(self) -> int:
        with self._lock:
            return self._decisions_total

    def decisions(self) -> List[dict]:
        with self._lock:
            return [dict(d) for d in self._ring]

    def observations(self) -> List[dict]:
        with self._lock:
            return [dict(o) for o in self._obs_ring]

    def status(self) -> dict:
        """Debug-mux payload (registered as ``slo``): the declared
        spec, live knobs, policy state, and the decision-ring tail."""
        with self._lock:
            ring = [dict(d) for d in list(self._ring)[-32:]]
            total = self._decisions_total
            adopted = self._adopted
            policy = {
                "breach": dict(self._breach),
                "under": dict(self._under),
                "relax_cap": dict(self._relax_cap),
                "wm_raise_ok": self._wm_raise_ok,
            }
        return {
            "spec": self.spec.as_dict(),
            "knobs": self._knobs(),
            "window_s": self.window_s,
            "cooldown_s": self.cooldown_s,
            "decisions_total": total,
            "adopted_state": adopted,
            "policy": policy,
            "decisions": ring,
        }

    def flight_payload(self) -> dict:
        """The flight recorder's ``slo`` section: what was the policy
        doing when the anomaly dumped."""
        with self._lock:
            ring = [dict(d) for d in list(self._ring)[-16:]]
            total = self._decisions_total
        return {
            "spec": self.spec.as_dict(),
            "knobs": self._knobs(),
            "decisions_total": total,
            "decisions": ring,
        }


def replay_decisions(spec: SLOSpec, observations: List[dict],
                     *, bounds: KnobBounds = KnobBounds(),
                     base_deadlines: Optional[Tuple[float, ...]] = None,
                     **params) -> List[dict]:
    """Re-drive a FRESH policy over recorded observations; the returned
    decision list must equal the original controller's decision ring
    bit-for-bit (the replay-determinism contract — decisions depend
    only on observations, never on wall clocks or live state).
    ``base_deadlines`` seeds the relax ceilings the live controller
    captured from its loop's configured base; pass the same values the
    original saw (defaults to the first observation's knobs)."""
    ctl = ServingSLOController(loop=None, spec=spec, bounds=bounds,
                               log=lambda *_a, **_k: None, **params)
    if base_deadlines is None and observations:
        base_deadlines = tuple(
            observations[0].get("knobs", {}).get("lane_deadline_s", ())
        ) or None
    if base_deadlines is not None:
        ctl._relax_cap = {
            lane: base_deadlines[i] for i, lane in enumerate(LANES)
        }
    out: List[dict] = []
    for obs in observations:
        decision = ctl.step(obs)
        if decision is not None:
            out.append(decision)
    return out
