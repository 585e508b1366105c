"""Deterministic fault injection for the solver boundary and the HBM
working set: the port's copy of what its tests and ``chip_smoke.py``
need of ``koordinator_tpu/testing/chaos.py``.

- :class:`FaultSchedule` maps ordinals (ticks) to fault kinds, scripted
  or generated from a seed.
- :class:`StateSaboteur` executes the scheduled state corruptions
  (:data:`STATE_FAULT_KINDS`, the drift classes the anti-entropy auditor
  ``scheduler/auditor.StateAuditor`` detects and repairs) against a live
  scheduler's caches, its staged CUDA generation included.
- :class:`HBMSaboteur` executes the scheduled device-memory-pressure
  faults (:data:`HBM_FAULT_KINDS`) against the working-set manager.
- :func:`drive_audited_cluster` is the reference's kill-the-leader chaos
  drive (``tests/test_chaos.py``'s ``_drive_cluster``): seeded churn over
  a bus, two leader-elected schedulers with auditors, the leader killed
  mid-churn and corruptions planted in the standby. It takes a package's
  modules (:func:`port_env` for this one), so one drive runs through
  either package.
- :class:`InProcessSidecar` wraps a :class:`PlacementService` in a
  subprocess-like handle (``poll``/``kill``/``pid``), so a
  :class:`~koordinator_tpu_torch.service.supervisor.SolverSupervisor`
  can supervise, and a test can kill and restart, a sidecar without a
  process start per respawn.

The reference's wire half comes next (ROADMAP.md): the frame-level proxy
``ChaosProxy`` and its wire fault kinds (``FAULT_KINDS``); a schedule
here takes the state and HBM kinds.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional

import numpy as np

#: state-corruption fault kinds, injected by :class:`StateSaboteur` into a
#: live scheduler's caches: the drift classes the runtime auditor
#: (scheduler/auditor.py) exists to detect and repair
STATE_FAULT_KINDS = (
    "corrupt-cache-cell",   # a cached pod's placement silently rewritten
    "orphan-assume",        # an assume entry with no pod behind it
    "desync-staged-row",    # a staged row moved with no delta-tracker mark
)

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
            if kind not in STATE_FAULT_KINDS and kind not in HBM_FAULT_KINDS:
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


class StateSaboteur:
    """Executes a schedule's :data:`STATE_FAULT_KINDS` against a live
    scheduler, the victims drawn from ``seed`` as the reference draws
    them (same seed, same victims):

    - ``corrupt-cache-cell``: a cached assigned pod is replaced by a copy
      claiming another node; the cache now disagrees with the bus and no
      event will heal it (auditor: ``stale-pod``).
    - ``orphan-assume``: an assume entry with no pod behind it, what a
      crashed round can leave (auditor: ``orphan-assume``).
    - ``desync-staged-row``: one staged node row, the host arrays and the
      staged generation on the model's device (on CUDA, the card's
      tensor), moved 777 m CPU of usage away from typed truth with no
      delta-tracker mark: the missed-mark class only the device <-> host
      parity probe sees (auditor: ``staged-host-drift`` /
      ``staged-device-drift``). Typed truth is untouched, so a corrupted
      then repaired run stays equal to a fault-free one.

    ``inject(tick)`` returns the kind applied, or None when nothing was
    scheduled or its precondition (an assigned pod, a staged row) does
    not hold yet; ``injected`` counts per kind and ``log`` keeps ``(tick,
    kind, detail)``."""

    def __init__(self, schedule: FaultSchedule, scheduler, seed: int = 0):
        self.schedule = schedule
        self.scheduler = scheduler
        self._rng = random.Random(seed)
        self.injected: Dict[str, int] = {}
        self.log: list = []

    def inject(self, tick: int) -> Optional[str]:
        kind = self.schedule.fault_for(tick)
        if kind is None or kind not in STATE_FAULT_KINDS:
            return None
        detail = getattr(self, "_" + kind.replace("-", "_"))()
        if detail is None:
            return None  # precondition unmet: nothing corrupted
        self.injected[kind] = self.injected.get(kind, 0) + 1
        self.log.append((tick, kind, detail))
        return kind

    def _corrupt_cache_cell(self) -> Optional[str]:
        import dataclasses

        cache = self.scheduler.cache
        nodes = sorted(cache.nodes)
        if len(nodes) < 2:
            return None
        candidates = sorted(
            uid for uid, pod in cache.pods.items()
            if pod.node_name is not None
            and not getattr(pod, "waiting_permit", False))
        if not candidates:
            return None
        uid = candidates[self._rng.randrange(len(candidates))]
        pod = cache.pods[uid]
        others = [n for n in nodes if n != pod.node_name]
        wrong = others[self._rng.randrange(len(others))]
        # a copy, so the bus's object keeps the true placement: the
        # cache-missed-an-event shape
        cache.pods[uid] = dataclasses.replace(pod, node_name=wrong)
        return f"{uid}:{pod.node_name}->{wrong}"

    def _orphan_assume(self) -> Optional[str]:
        cache = self.scheduler.cache
        uid = f"__ghost__{self._rng.randrange(1 << 30)}"
        cache.assumed[uid] = 0.0  # ancient: expired by any TTL
        return uid

    def _desync_staged_row(self) -> Optional[str]:
        model = getattr(self.scheduler, "model", None)
        staged = getattr(model, "staged_cache", None)
        if staged is None:
            return None
        arrays, state, tracker, seen_epoch, _now = staged.audit_view()
        if arrays is None or tracker is None:
            return None
        dirty = set(tracker.dirty_since(seen_epoch))
        cache = self.scheduler.cache
        candidates = [name for name in arrays.names
                      if name not in dirty and name in cache.node_metrics]
        if not candidates:
            return None
        name = candidates[self._rng.randrange(len(candidates))]
        i = arrays.names.index(name)
        if (state is not None and state.usage.device.type == "cpu"
                and np.shares_memory(state.usage.numpy(), arrays.usage)):
            # one buffer would take both writes: 1,554, not 777 a half
            raise RuntimeError("the staged usage shares memory with the "
                               "host arrays")
        # both halves drift, no tracker mark: nothing event-driven will
        # re-lower this row; only the parity probe sees it
        arrays.usage[i, 0] += 777
        if state is not None:
            state.usage[i, 0] += 777
        return name


#: the kill-the-leader drive: nodes, ticks (4 pods each), the tick from
#: which the leader no longer ticks, and the auditor cadence in rounds
AUDIT_NODES = 8
AUDIT_TICKS = 24
KILL_TICK = 10
SWEEP_EVERY = 4


def state_fault_schedule(seed: int) -> FaultSchedule:
    """A seeded schedule over all three :data:`STATE_FAULT_KINDS` for
    :func:`drive_audited_cluster`: one ``corrupt-cache-cell`` and one
    ``orphan-assume`` on distinct ticks of the standby before the kill
    (the promotion sweep audits them), and one ``desync-staged-row`` on a
    tick of the promoted leader's periodic sweep (its staged cache exists
    from its first round on; the sweep runs before that tick's solve)."""
    rng = random.Random(seed)
    cache_ticks = rng.sample(range(1, KILL_TICK), 2)
    sweep_ticks = list(range(KILL_TICK + SWEEP_EVERY, AUDIT_TICKS,
                             SWEEP_EVERY))
    return FaultSchedule({
        cache_ticks[0]: "corrupt-cache-cell",
        cache_ticks[1]: "orphan-assume",
        sweep_ticks[rng.randrange(len(sweep_ticks))]: "desync-staged-row",
    })


def port_env():
    """This package's modules as :func:`drive_audited_cluster` takes
    them."""
    from types import SimpleNamespace

    from koordinator_tpu_torch.apis import types
    from koordinator_tpu_torch.apis.extension import ResourceName
    from koordinator_tpu_torch.client import bus, leaderelection, wiring
    from koordinator_tpu_torch.scheduler.auditor import StateAuditor
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler

    return SimpleNamespace(
        APIServer=bus.APIServer, Kind=bus.Kind, EventType=bus.EventType,
        NodeSpec=types.NodeSpec, NodeMetric=types.NodeMetric,
        PodSpec=types.PodSpec, ResourceName=ResourceName,
        Scheduler=Scheduler, LeaderElector=leaderelection.LeaderElector,
        StateAuditor=StateAuditor, wire_scheduler=wiring.wire_scheduler,
        StateSaboteur=StateSaboteur, FaultSchedule=FaultSchedule)


def drive_audited_cluster(env, seed: int, *, kill_leader: bool, sabotage,
                          make_model, cutoff_of_tick=None):
    """Seeded churn over a wired bus (the reference's ``_drive_cluster``).

    ``kill_leader=True`` runs two leader-elected schedulers with
    auditors (a sweep every SWEEP_EVERY rounds, every row probed), stops
    ticking the leader at KILL_TICK (what a SIGKILL looks like from the
    bus) and lets the standby promote; ``sabotage`` (a FaultSchedule's
    events over STATE_FAULT_KINDS) is injected into the standby, the
    state a promoted leader inherits. ``kill_leader=False`` is the
    crash-free single scheduler. A tick gap of 2 s over a 1 s lease makes
    the failover cost no round, so the placements equal the crash-free
    run's. ``make_model()`` builds each scheduler's PlacementModel;
    ``cutoff_of_tick(t)``, when given, sets every model's
    ``host_fallback_cells`` before tick ``t``. Returns ``(per-tick
    placement log, bus, info)``; ``info["solvers"]`` is each tick's
    ``last_solver``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bus = env.APIServer()
    binds: Dict[str, int] = {}
    prev_node: Dict[str, Optional[str]] = {}

    def bind_watch(event, name, pod):
        node = getattr(pod, "node_name", None)
        if event is env.EventType.DELETED:
            prev_node.pop(pod.uid, None)
            return
        if node is not None and prev_node.get(pod.uid) != node:
            binds[pod.uid] = binds.get(pod.uid, 0) + 1
        prev_node[pod.uid] = node

    bus.watch(env.Kind.POD, bind_watch)
    info: dict = {"binds": binds, "solvers": []}
    if kill_leader:
        sched_a = env.Scheduler(model=make_model())
        sched_b = env.Scheduler(model=make_model())
        ea = env.LeaderElector(bus, "koord-scheduler", "a",
                               lease_duration=1.0)
        eb = env.LeaderElector(bus, "koord-scheduler", "b",
                               lease_duration=1.0)
        aud_a = env.StateAuditor(sched_a, bus, interval_rounds=SWEEP_EVERY,
                                 probe_rows=AUDIT_NODES)
        aud_b = env.StateAuditor(sched_b, bus, interval_rounds=SWEEP_EVERY,
                                 probe_rows=AUDIT_NODES)
        ea.on_started_leading = aud_a.note_promotion
        eb.on_started_leading = aud_b.note_promotion
        env.wire_scheduler(bus, sched_a, elector=ea)
        env.wire_scheduler(bus, sched_b, elector=eb)
        saboteur = env.StateSaboteur(env.FaultSchedule(sabotage), sched_b,
                                     seed=seed)
        seats = [(ea, sched_a, aud_a), (eb, sched_b, aud_b)]
        info.update(aud_a=aud_a, aud_b=aud_b, saboteur=saboteur,
                    sched_b=sched_b)
    else:
        sched = env.Scheduler(model=make_model())
        env.wire_scheduler(bus, sched)
        saboteur = None
        seats = [(None, sched, None)]

    cpu, mem = env.ResourceName.CPU, env.ResourceName.MEMORY
    for i in range(AUDIT_NODES):
        bus.apply(env.Kind.NODE, f"n{i}", env.NodeSpec(
            name=f"n{i}", allocatable={cpu: 64000, mem: 131072}))
        bus.apply(env.Kind.NODE_METRIC, f"n{i}", env.NodeMetric(
            node_name=f"n{i}",
            node_usage={cpu: int(rng.integers(0, 8000)),
                        mem: int(rng.integers(0, 16384))},
            update_time=90.0))

    log = []
    for t in range(AUDIT_TICKS):
        now = 100.0 + 2.0 * t
        for i in rng.choice(AUDIT_NODES, 2, replace=False):
            name = f"n{int(i)}"
            bus.apply(env.Kind.NODE_METRIC, name, env.NodeMetric(
                node_name=name,
                node_usage={cpu: int(rng.integers(0, 12000)),
                            mem: int(rng.integers(0, 32768))},
                update_time=now))
        for j in range(4):
            pod = env.PodSpec(
                name=f"t{t}p{j}",
                requests={cpu: int(rng.integers(200, 2000)),
                          mem: int(rng.integers(128, 2048))})
            bus.apply(env.Kind.POD, pod.uid, pod)
        if cutoff_of_tick is not None:
            for _, s, _ in seats:
                s.model.host_fallback_cells = cutoff_of_tick(t)
        if saboteur is not None:
            saboteur.inject(t)
        out = None
        for elector, sched, auditor in seats:
            if elector is None:
                out = sched.schedule_pending(now=now)
                info["solvers"].append(sched.model.last_solver)
                continue
            if kill_leader and elector is seats[0][0] and t >= KILL_TICK:
                continue  # killed: the deposed leader never ticks again
            if elector.tick(now):
                auditor.on_round(now=now)
                out = sched.schedule_pending(now=now)
                info["solvers"].append(sched.model.last_solver)
        if out is None:
            raise AssertionError(f"no leader ran tick {t}")
        log.append((t, sorted(out.items())))
    return log, bus, info


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
        if kind is None or kind not in HBM_FAULT_KINDS:
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
