"""koord-scheduler: the scheduler binary, its wiring and its loop
(counterpart of ``koordinator_tpu/cmd/scheduler.py``).

    python -m koordinator_tpu_torch.cmd.scheduler --once --cluster-json c.json

:func:`main` parses the reference's flags (and ``--device``: ``cuda``
unless given), loads the kernel library on a CUDA device, builds the
scheduler (:func:`build_scheduler`), the bus, the leader elector, the
anti-entropy auditor (``scheduler/auditor.StateAuditor``; its promotion
sweep chained onto ``on_started_leading``), the streaming loop and SLO
controller, the defrag controller and the in-loop rebalance plugin, a
supervised solver sidecar (``--solver-supervise``) and the debug mux
(``--debug-port``: the state-auditor, solver-supervisor,
solver-failover, flight-recorder, trace and device-observatory services,
``/explain`` through ``obs/explain.PlacementExplainer``), seeds the bus
from ``--cluster-json`` (:func:`seed_bus_from_json`) and runs
:func:`run_loop`. Flags whose subsystem is not ported are refused
(:data:`NOT_PORTED`).

:func:`build_scheduler` is Setup: a wired Scheduler, configured by the
``--feature-gates`` spec (``BatchedPlacement`` False: every round runs
the per-pod plugin chain; ``ElasticQuotaPreemption``) and the LoadAware
aggregated (percentile) mode (``aggregated_*``, an ``AggregatedArgs``),
whose model solves in process or, with ``placement_backend="sidecar"``, through a
:class:`~koordinator_tpu_torch.service.client.RemoteSolver` (wrapped in
a :class:`~koordinator_tpu_torch.service.failover.FailoverSolver` with
``solver_failover``, its flip-back wired to the model's
``reset_staging``), with the HBM working-set budget and its debug
service, the always-built migration arbiter and its working-set hook,
the trace, flight-recorder and device-observatory settings and the
stuck-cycle watchdog's timeout. :func:`build_slo_controller` closes the
loop on the streaming knobs when a lane SLO is declared.

:func:`run_loop` drives a wired Scheduler in one of three ways: the
serial loop on a fixed, absolute-deadline cadence; the pipelined loop
(``pipelined_ticks``: a :class:`~koordinator_tpu_torch.scheduler.
pipeline.TickPipeline` overlaps round N+1's staging with round N's
solve, read-back and publish); or the streaming loop (``streaming``: a
:class:`~koordinator_tpu_torch.scheduler.streaming.StreamingLoop` built
by :func:`build_streaming_loop` fires rounds on the adaptive trigger).
Placements are the same in all three, tick for tick. With ``auditor``,
a sweep runs before the round every ``audit_interval_rounds`` rounds.

:class:`SchedulerConfig` has the reference's names and defaults. The
host route for tiny solves follows ``host_fallback_cells``: at -1 (the
default) ``build_scheduler`` measures the cutoff on the scheduler's
device (``models/placement.measure_host_fallback_cells``, once per device
and solver configuration in a process, so it is part of :func:`main`'s
start), a positive value is
taken as given, and 0, a sidecar backend or ``BatchedPlacement`` off
leave it off. Not ported, and queued in ROADMAP.md: the scan unroll (its
field is absent), the AOT warm pool (``warm_pool`` is accepted and has no
effect; ``--no-warm-pool`` is refused) and node-sharded staging
(``build_scheduler`` raises ``NotImplementedError`` for it, naming its
ROADMAP item; ``--node-shards`` above 1 is refused).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from koordinator_tpu_torch import DeviceLike
from koordinator_tpu_torch.features import SCHEDULER_GATES


@dataclasses.dataclass
class SchedulerConfig:
    """The KubeSchedulerConfiguration-equivalent component config (the
    reference's field names and defaults)."""

    #: the ``--feature-gates`` spec ("BatchedPlacement=false,...")
    feature_gates: str = ""
    #: batched solve cadence (the churn loop period)
    schedule_interval_seconds: float = 1.0
    fit_weight: int = 1
    loadaware_weight: int = 1
    score_according_prod: bool = False
    #: LoadAware aggregated (percentile) mode, the reference's
    #: LoadAwareSchedulingAggregatedArgs: the filter substitutes the
    #: percentile usage and these thresholds when both are set; the score
    #: substitutes the percentile base when aggregated_score_pct is set
    aggregated_usage_thresholds: Optional[dict] = None
    aggregated_usage_pct: Optional[int] = None
    aggregated_usage_duration_seconds: Optional[float] = None
    aggregated_score_pct: Optional[int] = None
    aggregated_score_duration_seconds: Optional[float] = None
    cluster_total: Optional[dict] = None
    #: the backend selector: ``inprocess`` solves in this process;
    #: ``sidecar`` routes every batched solve through a koord-solver
    #: process at solver_address
    placement_backend: str = "inprocess"
    solver_address: str = "/tmp/koord-solver.sock"
    solver_secret: Optional[bytes] = None
    #: degraded-mode failover (service/failover.py): K consecutive
    #: failures flip to the in-process solve; M consecutive healthy
    #: probes flip back with a full-restage epoch reset
    solver_failover: bool = False
    solver_failover_threshold: int = 3
    solver_failover_recovery_probes: int = 2
    #: plain solves with pods x nodes up to this run on the host route
    #: (the numpy oracle; a launch and a read-back cost more there).
    #: -1 = measure at start-up on the scheduler's device
    #: (models/placement.measure_host_fallback_cells), 0 = off
    host_fallback_cells: int = -1
    #: anti-entropy auditor (scheduler/auditor.py): a sweep every N
    #: scheduling rounds. 0 disables the auditor entirely, the promotion
    #: sweep on lease acquisition included (main() wires none at 0)
    audit_interval_rounds: int = 16
    #: staged rows the device <-> host parity probe re-lowers and
    #: compares per sweep (round-robin: every row within
    #: ceil(n / probe_rows) sweeps)
    audit_probe_rows: int = 64
    #: pipelined tick path (scheduler/pipeline.py): overlap staging for
    #: round N+1 with round N's in-flight solve and move the read-back +
    #: epilogue + bus publish onto a bounded publisher worker.
    #: Placements stay bit-identical to the serial loop
    pipelined_ticks: bool = False
    #: anomaly flight-recorder dump directory (obs/flight.py). None =
    #: $KTPU_FLIGHT_DIR or <tmp>/koord-flight
    flight_dir: Optional[str] = None
    #: device observatory (obs/device.py): directory for on-demand
    #: torch.profiler windows. None = $KTPU_PROFILE_DIR or
    #: <tmp>/koord-profile
    profile_dir: Optional[str] = None
    #: stuck-cycle watchdog threshold (scheduler/monitor.py): an open
    #: round/publish mark older than this reads as stuck (the mark
    #: covers the whole round, a first round's kernel-library build
    #: included)
    monitor_timeout_seconds: float = 10.0
    #: streaming serving mode (scheduler/streaming.py): pods arrive on
    #: an open-loop stream into the QoS-laned intake and rounds fire
    #: ADAPTIVELY — batch-size watermark OR oldest-pod lane deadline,
    #: whichever comes first — instead of on the fixed cadence
    streaming: bool = False
    #: batch-size trigger: a round fires as soon as this many arrivals
    #: are queued (a burst amortizes into one dispatch)
    stream_watermark: int = 64
    #: per-lane queue-wait targets (system, ls, be) in seconds: the
    #: oldest queued pod's submit + lane deadline is the other trigger
    stream_deadline_system_s: float = 0.002
    stream_deadline_ls_s: float = 0.010
    stream_deadline_be_s: float = 0.050
    #: intake bound: arrivals past this shed (BE first, typed + counted)
    stream_capacity: int = 4096
    #: floor between adaptively-fired rounds (0 = none)
    stream_min_interval_s: float = 0.0
    #: periodic LoadAware Balance sweep inside the fixed-cadence loop
    #: (``run_loop(rebalance=plugin)`` through scheduler.rebalance_sweep)
    rebalance_interval_s: float = 0.0
    #: scheduling trace fabric (obs/trace.py): span recording into the
    #: bounded ring served at /debug/trace
    trace: bool = True
    #: node-axis shard count: sharded staging is not ported (one card;
    #: ROADMAP Queue 1 item 10); > 1 raises
    node_shards: int = 1
    #: per-lane serving SLOs (control/slo.py): ``p99=<seconds>`` (or a
    #: bare float) per lane; any set target turns on the
    #: ServingSLOController in streaming mode, starting from the stream_*
    #: knobs above
    slo_system: Optional[str] = None
    slo_ls: Optional[str] = None
    slo_be: Optional[str] = None
    #: controller cadence: the rolling window the lane p99 is read over,
    #: and the per-decision cooldown
    slo_window_s: float = 5.0
    slo_cooldown_s: float = 1.0
    #: the AOT warm pool: accepted, no effect until it is ported
    #: (ROADMAP Queue 1 item 10)
    warm_pool: bool = True
    #: HBM working-set budget (state/workingset.py) over every staged
    #: world; 0 = unlimited
    hbm_budget_bytes: int = 0
    #: migration arbiter disruption budgets (control/migration.py); the
    #: all-None default admits everything
    migration_max_per_round: Optional[int] = None
    migration_max_per_node: Optional[int] = None
    migration_max_per_tenant: Optional[int] = None
    migration_window_s: float = 60.0
    migration_node_cooldown_s: float = 0.0
    migration_dry_run: bool = False
    #: closed-loop defrag controller (control/migration.py): watches the
    #: fragmentation signal (a pending gang whose member fits no node
    #: though the free capacity in all could hold it) and applies one
    #: arbitrated headroom repack per cooldown. Fixed-cadence loop only
    defrag_loop: bool = False
    defrag_interval_s: float = 5.0
    defrag_cooldown_s: float = 30.0
    defrag_confirm: int = 2
    defrag_dry_run: bool = False
    #: the eviction walk of the in-loop Balance sweep: host (the
    #: reference-shaped walk), device (the sweep kernel on the model's
    #: device), verify (both, equality asserted before applying)
    rebalance_backend: str = "host"


def build_scheduler(config: SchedulerConfig, device: DeviceLike = None):
    """Setup: a fully wired Scheduler whose model (and failover backend)
    solve on ``device`` (``cuda`` unless given), under a copy of
    ``SCHEDULER_GATES`` set from ``config.feature_gates``."""
    from koordinator_tpu_torch.models.placement import PlacementModel
    from koordinator_tpu_torch.ops.binpack import SolverConfig
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.state.cluster import AggregatedArgs

    gates = SCHEDULER_GATES.copy()
    gates.set_from_spec(config.feature_gates)
    if config.node_shards > 1:
        raise NotImplementedError(
            "node_shards > 1: sharded staging is not ported yet (ROADMAP "
            "Queue 1 item 10)")
    backend = None
    if config.placement_backend == "sidecar":
        from koordinator_tpu_torch.cmd.solver import parse_address
        from koordinator_tpu_torch.service.client import RemoteSolver

        backend = RemoteSolver(parse_address(config.solver_address),
                               secret=config.solver_secret)
        if config.solver_failover:
            from koordinator_tpu_torch.service.failover import FailoverSolver

            backend = FailoverSolver(
                backend,
                failure_threshold=config.solver_failover_threshold,
                recovery_probes=config.solver_failover_recovery_probes,
                device=device)
    elif config.placement_backend != "inprocess":
        raise ValueError(
            f"unknown placement backend: {config.placement_backend!r}")
    aggregated = None
    if (config.aggregated_usage_pct is not None
            or config.aggregated_score_pct is not None):
        aggregated = AggregatedArgs(
            usage_thresholds=config.aggregated_usage_thresholds,
            usage_pct=config.aggregated_usage_pct,
            usage_duration_seconds=config.aggregated_usage_duration_seconds,
            score_pct=config.aggregated_score_pct,
            score_duration_seconds=config.aggregated_score_duration_seconds)
    solver_config = SolverConfig(
        fit_weight=config.fit_weight,
        loadaware_weight=config.loadaware_weight,
        score_according_prod=config.score_according_prod)
    if backend is not None or not gates.enabled("BatchedPlacement"):
        # the sidecar takes every solve; with the gate off no batched
        # solve consults the cutoff: no probe
        fallback_cells = 0
    elif config.host_fallback_cells < 0:
        from koordinator_tpu_torch.models.placement import (
            measure_host_fallback_cells,
        )

        fallback_cells = measure_host_fallback_cells(solver_config,
                                                     device=device)
    else:
        fallback_cells = config.host_fallback_cells
    model = PlacementModel(
        config=solver_config, aggregated=aggregated, backend=backend,
        device=device, host_fallback_cells=fallback_cells)
    if backend is not None and hasattr(backend, "on_flip_back"):
        # the flip-back forces a full relower and restage, so that the
        # recovered sidecar's delta base is established from scratch
        backend.on_flip_back = model.reset_staging
    scheduler = Scheduler(
        model=model, cluster_total=config.cluster_total,
        enable_preemption=gates.enabled("ElasticQuotaPreemption"))
    # the gate off: every round runs per-pod plugin-chain cycles
    scheduler.batched_placement = gates.enabled("BatchedPlacement")
    scheduler.monitor.timeout = config.monitor_timeout_seconds
    # the observability settings apply at this layer: an embedder calling
    # build_scheduler() + run_loop() gets what the config says
    from koordinator_tpu_torch.obs.device import DEVICE_OBS
    from koordinator_tpu_torch.obs.flight import FLIGHT
    from koordinator_tpu_torch.obs.trace import TRACER

    TRACER.set_enabled(config.trace)
    if config.flight_dir is not None:
        FLIGHT.configure(dump_dir=config.flight_dir)
    if config.profile_dir is not None:
        DEVICE_OBS.configure(profile_dir=config.profile_dir)
    # the HBM working set: budget applied before the first staging, the
    # residency census on the debug services
    from koordinator_tpu_torch.state.workingset import WORKING_SET

    if config.hbm_budget_bytes:
        WORKING_SET.set_budget(config.hbm_budget_bytes)
    scheduler.services.register("workingset", WORKING_SET.status)
    # the migration arbiter is always built: with no caps it admits
    # everything, and its decision ring, service and flight payload stay
    # live
    from koordinator_tpu_torch.control.migration import (
        MigrationArbiter,
        MigrationBudget,
    )

    arbiter = MigrationArbiter(MigrationBudget(
        max_per_round=config.migration_max_per_round,
        max_per_node=config.migration_max_per_node,
        max_per_tenant=config.migration_max_per_tenant,
        window_s=config.migration_window_s,
        node_cooldown_s=config.migration_node_cooldown_s,
        dry_run=config.migration_dry_run))
    scheduler.migration_arbiter = arbiter
    # working-set demotions are the fourth eviction source: recorded
    # against the same windows, never deferred
    WORKING_SET.migration_hook = lambda key, lane, reason: arbiter.note(
        "workingset", None, [key], lanes=[lane])
    scheduler.services.register("migration", arbiter.status)
    FLIGHT.register_payload("migration", arbiter.flight_payload)
    return scheduler


def stream_config(config: SchedulerConfig):
    """The SchedulerConfig's streaming knobs as a StreamingConfig."""
    from koordinator_tpu_torch.scheduler.streaming import StreamingConfig

    return StreamingConfig(
        watermark=config.stream_watermark,
        lane_deadline_s=(
            config.stream_deadline_system_s,
            config.stream_deadline_ls_s,
            config.stream_deadline_be_s,
        ),
        capacity=config.stream_capacity,
        min_round_interval_s=config.stream_min_interval_s,
    )


def build_streaming_loop(scheduler, bus, config: SchedulerConfig,
                         auditor=None, log=print):
    """Wire a :class:`~koordinator_tpu_torch.scheduler.streaming.
    StreamingLoop` over the bus: admitted arrivals land as Pod applies,
    shed victims / expired pods are bus-deleted (typed, observed by
    every wired component), and pending pods applied by OTHER
    components enter the intake through a watch — so the open-loop
    stream and ordinary informer traffic share one trigger."""
    from koordinator_tpu_torch.client.bus import EventType, Kind
    from koordinator_tpu_torch.scheduler.streaming import StreamingLoop

    loop = StreamingLoop(
        scheduler,
        apply_fn=lambda pod: bus.apply(Kind.POD, pod.uid, pod),
        delete_fn=lambda uid: bus.delete(Kind.POD, uid),
        config=stream_config(config),
        pipelined=config.pipelined_ticks,
        auditor=auditor,
        log=log,
    )

    def on_pod(event, name, pod):
        # externally-applied pending pods join the intake (their lane
        # deadline arms the trigger); loop.submit()'s own applies are
        # already tracked and skipped, bound/assigned pods are not
        # arrivals, DELETEs are handled by the remove_pod chain
        if event is EventType.DELETED:
            return
        if getattr(pod, "node_name", None) is not None:
            # a bind — possibly published by ANOTHER seat (HA
            # streaming): resolve the intake's tracked
            # submit→bind span so a standby's timelines and depth
            # gauges stay true without it ever firing a round
            loop.observe_bound(pod)
            return
        loop.observe(pod)

    bus.watch(Kind.POD, on_pod)
    scheduler.services.register("streaming", loop.status)
    return loop


def build_slo_controller(streaming, bus, config: SchedulerConfig,
                         elector=None, log=print):
    """Close the loop on the streaming knobs: when any ``slo_*`` lane
    target is declared, a :class:`~koordinator_tpu_torch.control.slo.
    ServingSLOController` rides the StreamingLoop's trigger loop and
    walks watermark, deadlines and capacity toward the target (bounded,
    hysteretic, one knob per reconcile, every decision on the debug
    services and in flight dumps). None when no target is set."""
    from koordinator_tpu_torch.control.slo import (
        ServingSLOController,
        SLOSpec,
    )
    from koordinator_tpu_torch.obs.flight import FLIGHT

    spec = SLOSpec.parse(config.slo_system, config.slo_ls, config.slo_be)
    if not spec.any():
        return None
    controller = ServingSLOController(
        streaming, spec, bus=bus, elector=elector,
        window_s=config.slo_window_s, cooldown_s=config.slo_cooldown_s,
        log=log)
    streaming.attach_controller(controller)
    streaming.scheduler.services.register("slo", controller.status)
    FLIGHT.register_payload("slo", controller.flight_payload)
    return controller


def build_defrag_controller(scheduler, config: SchedulerConfig, log=print):
    """Close the loop on ``defrag_headroom``: with ``defrag_loop``, a
    :class:`~koordinator_tpu_torch.control.migration.DefragController`
    rides the fixed-cadence loop, reconciling on its pump, watching the
    fragmentation signal and applying one arbitrated repack per
    cooldown. None when the loop is off (the API stays
    operator-called)."""
    from koordinator_tpu_torch.control.migration import (
        DefragController,
        DefragPolicy,
    )
    from koordinator_tpu_torch.obs.flight import FLIGHT

    if not config.defrag_loop:
        return None
    controller = DefragController(scheduler, DefragPolicy(
        interval_s=config.defrag_interval_s,
        cooldown_s=config.defrag_cooldown_s,
        confirm=config.defrag_confirm,
        dry_run=config.defrag_dry_run))
    scheduler.services.register("defrag", controller.status)
    FLIGHT.register_payload("defrag", controller.flight_payload)
    return controller


def build_rebalance_plugin(config: SchedulerConfig,
                           device: DeviceLike = None):
    """The in-loop LoadAware Balance sweep's plugin when
    ``rebalance_interval_s`` is set (run by the loop through
    ``scheduler.rebalance_sweep``: the arbitrated sink, delta-path
    evictions), else None. Its ``device`` and ``verify`` backends sweep
    on ``device`` (``cuda`` unless given)."""
    from koordinator_tpu_torch.descheduler.loadaware import (
        LowNodeLoad,
        LowNodeLoadArgs,
    )

    if config.rebalance_interval_s <= 0:
        return None
    return LowNodeLoad(LowNodeLoadArgs(backend=config.rebalance_backend,
                                       device=device))


def run_loop(scheduler, config: SchedulerConfig, once: bool = False,
             log=print, elector=None, now_fn=time.time,
             max_rounds: Optional[int] = None, auditor=None,
             pipeline=None, sleep_fn=time.sleep, streaming=None,
             defrag=None, rebalance=None) -> int:
    """The scheduling loop over a wired bus: solve the pending queue
    every interval. A sidecar outage without failover skips the round —
    COUNTED and logged, never silent (``scheduler_rounds_skipped_total``
    carries the running total; with the failover backend wired,
    ``--solver-failover``, outages are solved in-process and no round
    skips). With ``elector``, rounds run only while holding the lease
    (the reference gates sched.Run on OnStartedLeading,
    server.go:226-252); losing the lease mid-round surfaces as
    FencingError, demotes to standby, and immediately FORGETS the
    aborted round's assumed-but-unbound pods — they were never
    published, and left in place they would linger until assume expiry
    and poison a later re-election's first snapshot. With ``auditor`` (a
    :class:`~koordinator_tpu_torch.scheduler.auditor.StateAuditor`), an
    anti-entropy sweep runs before the round every
    ``audit_interval_rounds`` rounds, plus the promotion sweep right
    after this instance acquires the lease (wired through the elector's
    ``on_started_leading``). ``max_rounds`` bounds the loop for
    regression tests: after that many attempted rounds the loop returns
    the number of skipped rounds (0 = every round placed).

    Cadence: rounds fire on an ABSOLUTE deadline grid — the sleep is
    computed from round start, not from end-of-work — so a slow round
    (or an overlapped one) does not push every later round back.

    Pipelined mode (``config.pipelined_ticks`` or an explicit
    ``pipeline``): rounds run through a
    :class:`~koordinator_tpu_torch.scheduler.pipeline.TickPipeline` — the
    round's critical path is catch-up staging + async dispatch, while
    the read-back, epilogue, and bus publish retire on the publisher
    worker during the cadence gap. A publish-side failure surfaces at
    the next round boundary and is handled by the SAME handlers below
    (a deferred FencingError still triggers the fencing forget); an
    auditor's sweep drains the pipeline first, so it never reads a
    half-retired round, and failover mode flips quiesce it through the
    flip hooks wired here."""
    from koordinator_tpu_torch.client.leaderelection import FencingError
    from koordinator_tpu_torch.metrics.components import ROUNDS_SKIPPED
    from koordinator_tpu_torch.obs.flight import FLIGHT
    from koordinator_tpu_torch.obs.trace import TRACER
    from koordinator_tpu_torch.service.client import (
        SolverOverloaded,
        SolverUnavailable,
    )

    if config.streaming or streaming is not None:
        # streaming serving mode: the adaptive trigger
        # replaces the fixed cadence entirely — the StreamingLoop owns
        # its own pipeline, auditor cadence and watchdog polls
        if streaming is None:
            raise ValueError(
                "streaming mode needs a bus-wired StreamingLoop — "
                "build one with build_streaming_loop(scheduler, bus, "
                "config) and pass it as streaming="
            )
        if elector is not None:
            # HA streaming: the lease gates the trigger
            # loop itself — a standby seat drains its pipeline and
            # watch-feeds the intake without firing rounds; promotion
            # adopts the deposed leader's knob state FIRST, then
            # sweeps the pending cache into the gate (intake handoff)
            streaming.attach_elector(elector)
        if once:
            raise ValueError("--once is a fixed-cadence concept; "
                             "streaming mode serves continuously")
        try:
            streaming.run()  # blocks until streaming.stop()
        finally:
            streaming.stop()
        return 0

    if pipeline is None and config.pipelined_ticks:
        from koordinator_tpu_torch.scheduler.pipeline import TickPipeline

        pipeline = TickPipeline(scheduler, log=log)
    hooked_backend = None
    prev_flip = prev_degraded = None
    if pipeline is not None:
        scheduler.services.register("tick-pipeline", pipeline.status)
        backend = getattr(scheduler.model, "backend", None)
        if backend is not None and hasattr(backend, "on_flip_back"):
            # degraded-mode flips quiesce the pipeline: the epoch reset
            # (full restage) must never race an in-flight tick's retire.
            # The originals are restored on exit — a re-invoked
            # run_loop must not chain wrappers over stopped pipelines.
            hooked_backend = backend
            prev_flip = backend.on_flip_back

            def _flip_back(prev=prev_flip, p=pipeline):
                p.drain("failover-flip", raise_deferred=False)
                if prev is not None:
                    prev()

            backend.on_flip_back = _flip_back
            if hasattr(backend, "on_flip_degraded"):
                prev_degraded = backend.on_flip_degraded

                def _flip_degraded(prev=prev_degraded, p=pipeline):
                    p.drain("failover-flip", raise_deferred=False)
                    if prev is not None:
                        prev()

                backend.on_flip_degraded = _flip_degraded

    skipped = 0
    rounds = 0
    # in-loop rebalance cadence: first sweep one full interval after
    # loop start (a sweep before any metric lands would be noise)
    last_rebalance = now_fn()

    def on_round_error(e):
        """The one round-failure handler — shared by the main loop's
        except blocks and the standby-branch drain so the skip count,
        metric reasons, fencing forget, and log lines cannot drift
        apart. A FencingError's aborted round placed nothing: it counts
        as skipped (metric AND max_rounds' return value) exactly like a
        solver outage, and the forget releases the aborted round's
        assumed-but-unbound pods — they were never published, and left
        in place they would linger until assume expiry."""
        nonlocal skipped
        skipped += 1
        if isinstance(e, FencingError):
            ROUNDS_SKIPPED.inc({"reason": "leadership-lost"})
            TRACER.instant("fencing-abort", cat="round")
            # anomaly: preserve the rounds that led up to the aborted
            # publish before the forget rewrites the cache
            FLIGHT.trigger("fencing-abort", detail=str(e))
            forgotten = scheduler.forget_assumed_unbound()
            log(f"leadership lost mid-round ({skipped} skipped so "
                f"far): {e}; forgot {len(forgotten)} "
                f"assumed-but-unbound pod(s)")
        else:
            # overloaded past the client's retry budget is an outage
            # from this seat: skip (counted), retry next round
            reason = ("solver-overloaded"
                      if isinstance(e, SolverOverloaded)
                      else "solver-unavailable")
            ROUNDS_SKIPPED.inc({"reason": reason})
            log(f"round skipped ({skipped} skipped so far): {e}")

    monitor = getattr(scheduler, "monitor", None)
    try:
        while True:
            round_start = now_fn()
            deadline = round_start + config.schedule_interval_seconds
            if monitor is not None:
                # span-fed watchdog: flags (and counts) rounds/publishes
                # whose tracer mark is stuck open past the timeout
                monitor.check_stuck()
            if elector is not None and not elector.tick(round_start):
                if pipeline is not None:
                    # a deferred publish-side failure from the round
                    # that deposed us must surface NOW, not after
                    # re-election: until the fencing forget runs, the
                    # aborted round's assumed-but-unbound pods hold
                    # quota/gang/reservation credit that standby
                    # metrics, status, and manual audits all read as
                    # live state
                    st = pipeline.status()
                    if st["inflight"] or st["pending_error"]:
                        try:
                            pipeline.drain("standby")
                        except (FencingError, SolverUnavailable,
                                SolverOverloaded) as e:
                            on_round_error(e)
                log("standby: lease held elsewhere")
                if once:
                    return 3  # distinct from success: no round ran
                sleep_fn(elector.retry_period)
                continue
            rounds += 1
            last = max_rounds is not None and rounds >= max_rounds
            try:
                if auditor is not None:
                    if pipeline is not None and auditor.sweep_due():
                        # quiesce before the sweep: an unretired tick's
                        # assumed-but-unpublished decisions would read as
                        # drift (deferred errors surface here too, into
                        # the handlers below)
                        pipeline.drain("auditor-sweep")
                    # repairs land before the solve, so a drifted cache
                    # never feeds a round (the promotion sweep audits
                    # the deposed leader's leavings before the first
                    # decision)
                    report = auditor.on_round(now=now_fn())
                    if report is not None and report["detections"]:
                        log(f"audit[{report['kind']}]: "
                            f"{sum(report['detections'].values())} "
                            f"drift(s) detected, "
                            f"repairs: {report['repairs']}")
                if pipeline is not None:
                    pipeline.submit_round(now=now_fn())
                    # the overlap window: warm next round's staging
                    # while this round's solve is in flight
                    pipeline.prestage(now=now_fn())
                    if once or last:
                        # surface this round's own publish-side fate
                        # before returning/stopping
                        pipeline.drain("once" if once else "shutdown")
                    out = None
                else:
                    out = scheduler.schedule_pending()
                # post-round control plane: the defrag
                # controller reconciles on the pump (interval-gated
                # internally, one arbitrated repack per cooldown), and
                # the LoadAware Balance sweep fires on its own cadence
                # through the arbitrated sink
                if defrag is not None:
                    defrag.maybe_reconcile(now=now_fn())
                if rebalance is not None and (
                    round_start - last_rebalance
                    >= config.rebalance_interval_s
                ):
                    last_rebalance = round_start
                    swept = scheduler.rebalance_sweep(
                        rebalance, now=now_fn()
                    )
                    if swept:
                        log(f"rebalance: evicted {len(swept)} pod(s)")
            except (FencingError, SolverUnavailable,
                    SolverOverloaded) as e:
                # in pipelined mode this may be a DEFERRED abort from
                # the previous round's publish — the handler is the
                # same safety net either way, and the already-staged
                # next round re-lowers any forgotten rows from truth
                on_round_error(e)
                if once:
                    return 1
            else:
                if out is not None:
                    placed = sum(1 for v in out.values() if v is not None)
                    # the serial loop's flight-recorder feed (the
                    # pipelined loop records from the publisher worker)
                    model = getattr(scheduler, "model", None)
                    FLIGHT.record_round({
                        # this scheduler's round, not the shared
                        # process-global counter (leader + standby)
                        "round": getattr(scheduler, "last_round_id",
                                         None),
                        "at": round_start,
                        "placed": placed,
                        "total": len(out),
                        "waiting": len(out.waiting),
                        "solver": getattr(model, "last_solver", None),
                        **(getattr(model, "last_timings", None) or {}),
                    })
                    log(f"round: {placed}/{len(out)} placed, "
                        f"{len(out.waiting)} waiting")
                if once:
                    return 0
            if last:
                return skipped
            sleep_fn(max(0.0, deadline - now_fn()))
    finally:
        if hooked_backend is not None:
            hooked_backend.on_flip_back = prev_flip
            if hasattr(hooked_backend, "on_flip_degraded"):
                hooked_backend.on_flip_degraded = prev_degraded
        if pipeline is not None:
            pipeline.stop()


def seed_bus_from_json(bus, path: str) -> None:
    """Populate the bus from a cluster-spec JSON file:
    ``{"nodes": [{"name", "cpu", "memory"}],
    "pods": [{"name", "cpu", "memory", "node"?}]}`` (cpu in millicores,
    memory in MiB), each node with an empty usage metric: the in-process
    stand-in for a kubeconfig."""
    import json

    from koordinator_tpu_torch.apis.extension import ResourceName
    from koordinator_tpu_torch.apis.types import NodeMetric, NodeSpec, PodSpec
    from koordinator_tpu_torch.client.bus import Kind

    with open(path) as f:
        spec = json.load(f)
    now = time.time()
    for n in spec.get("nodes", ()):
        bus.apply(Kind.NODE, n["name"], NodeSpec(
            name=n["name"],
            allocatable={
                ResourceName.CPU: int(n.get("cpu", 0)),
                ResourceName.MEMORY: int(n.get("memory", 0)),
            },
        ))
        bus.apply(Kind.NODE_METRIC, n["name"], NodeMetric(
            node_name=n["name"], node_usage={}, update_time=now,
        ))
    for p in spec.get("pods", ()):
        pod = PodSpec(
            name=p["name"],
            requests={
                ResourceName.CPU: int(p.get("cpu", 0)),
                ResourceName.MEMORY: int(p.get("memory", 0)),
            },
            node_name=p.get("node"),
        )
        bus.apply(Kind.POD, pod.uid, pod)


#: the reference's flags whose subsystems this package does not have yet:
#: flag -> (refused when, what it needs)
NOT_PORTED = {
    "no_warm_pool": (lambda v: bool(v),
                     "--no-warm-pool (the AOT warm pool, ROADMAP Queue 1 "
                     "item 10)"),
    "node_shards": (lambda v: v > 1,
                    "--node-shards above 1 (sharded staging, ROADMAP "
                    "Queue 1 item 10)"),
}


def _parser() -> argparse.ArgumentParser:
    """The binary's flags: the reference's, and ``--device``."""
    p = argparse.ArgumentParser("koord-scheduler")
    add = p.add_argument
    add("--feature-gates", default="", help="A=true,B=false gate overrides")
    add("--schedule-interval", type=float, default=1.0)
    add("--once", action="store_true",
        help="run a single scheduling round and exit")
    add("--device", default=None,
        help="torch device the in-process solves (and a supervised "
             "sidecar's) run on (default: cuda)")
    add("--placement-backend", choices=("inprocess", "sidecar"),
        default="inprocess", help="where batched solves run")
    add("--solver-address", default="/tmp/koord-solver.sock")
    add("--solver-secret-file", default=None)
    add("--solver-failover", action="store_true",
        help="degraded-mode failover: a sidecar outage is answered by the "
             "in-process solve instead of a skipped round; flips back with "
             "hysteresis")
    add("--solver-supervise", action="store_true",
        help="spawn the koord-solver sidecar at --solver-address and "
             "supervise it (liveness probes, backoff restarts, a "
             "restart-storm circuit breaker)")
    add("--pipelined-ticks", action="store_true",
        help="overlapped tick path: stage round N+1 while round N's solve "
             "is in flight and publish off the critical path (the same "
             "placements)")
    add("--streaming", action="store_true",
        help="continuous-arrival serving mode: rounds fire adaptively "
             "(batch-size watermark or oldest-pod lane deadline) instead "
             "of on the fixed --schedule-interval cadence")
    add("--stream-watermark", type=int, default=64,
        help="streaming batch-size trigger: fire a round once this many "
             "arrivals are queued")
    add("--stream-deadline-system", type=float, default=0.002,
        help="system-lane queue-wait target in seconds")
    add("--stream-deadline-ls", type=float, default=0.010,
        help="latency-sensitive-lane queue-wait target in seconds")
    add("--stream-deadline-be", type=float, default=0.050,
        help="best-effort-lane queue-wait target in seconds")
    add("--stream-capacity", type=int, default=4096,
        help="streaming intake bound: arrivals past this shed (BE first, "
             "typed and counted)")
    add("--stream-min-interval", type=float, default=0.0,
        help="floor between adaptively fired rounds in seconds (0 = none)")
    add("--slo-system", default=None,
        help="system-lane serving SLO, e.g. 'p99=0.002' (seconds; a bare "
             "float also parses). Any --slo-* target turns on the SLO "
             "controller in --streaming mode, starting from the "
             "--stream-* knobs")
    add("--slo-ls", default=None,
        help="latency-sensitive-lane serving SLO (see --slo-system)")
    add("--slo-be", default=None,
        help="best-effort-lane serving SLO (see --slo-system)")
    add("--slo-window", type=float, default=5.0,
        help="SLO controller rolling window in seconds")
    add("--slo-cooldown", type=float, default=1.0,
        help="SLO controller per-decision cooldown in seconds")
    add("--hbm-budget-bytes", type=int, default=0,
        help="device-memory line for staged worlds: under pressure the "
             "least valuable demote to the host or cold rung; 0 = "
             "unlimited")
    add("--migration-max-per-round", type=int, default=None,
        help="disruption budget: admitted evictions per scheduling round, "
             "all sources combined; unset = unlimited")
    add("--migration-max-per-node", type=int, default=None,
        help="disruption budget: admitted evictions per node within "
             "--migration-window; unset = unlimited")
    add("--migration-max-per-tenant", type=int, default=None,
        help="disruption budget: admitted evictions per QoS lane within "
             "--migration-window; unset = unlimited")
    add("--migration-window", type=float, default=60.0,
        help="rolling window in seconds of the per-node and per-tenant "
             "budgets")
    add("--migration-node-cooldown", type=float, default=0.0,
        help="per-node quiet period in seconds after an admitted eviction")
    add("--migration-dry-run", action="store_true",
        help="classify-only arbitration: every request is judged and "
             "recorded, nothing is evicted")
    add("--defrag-loop", action="store_true",
        help="closed-loop defrag: one arbitrated headroom repack per "
             "cooldown when a pending gang fits nowhere though the free "
             "capacity could hold it; fixed-cadence loop only")
    add("--defrag-interval", type=float, default=5.0,
        help="defrag controller reconcile cadence in seconds")
    add("--defrag-cooldown", type=float, default=30.0,
        help="quiet period in seconds between applied repacks")
    add("--defrag-confirm", type=int, default=2,
        help="consecutive fragmented observations before the controller "
             "acts")
    add("--defrag-dry-run", action="store_true",
        help="defrag decisions are recorded but never applied")
    add("--rebalance-interval", type=float, default=0.0,
        help="run the LoadAware Balance sweep inside the scheduling loop "
             "every this many seconds, evictions through the migration "
             "arbiter (0 = no in-loop sweep)")
    add("--rebalance-backend", choices=("host", "device", "verify"),
        default="host",
        help="the Balance sweep's eviction walk: host, device (the sweep "
             "kernel) or verify (both, equality asserted before applying)")
    add("--cluster-json", default=None,
        help="seed the bus from a cluster-spec JSON file")
    add("--audit-interval-rounds", type=int, default=16,
        help="anti-entropy sweep cadence in scheduling rounds (0 disables "
             "the auditor); a promotion sweep also runs whenever this "
             "instance acquires the lease")
    add("--audit-probe-rows", type=int, default=64,
        help="staged rows the device <-> host parity probe re-lowers and "
             "compares per sweep (round-robin)")
    add("--no-trace", action="store_true",
        help="disable span recording; the stuck-cycle watchdog keeps "
             "working, /debug/trace serves an empty ring")
    add("--flight-dir", default=None,
        help="flight-recorder dump directory (default: $KTPU_FLIGHT_DIR "
             "or <tmp>/koord-flight)")
    add("--profile-dir", default=None,
        help="directory of the on-demand torch.profiler windows "
             "(/debug/profile?rounds=K; default: $KTPU_PROFILE_DIR or "
             "<tmp>/koord-profile)")
    add("--node-shards", type=int, default=1,
        help="not ported above 1: refused")
    add("--no-warm-pool", action="store_true",
        help="not ported yet: refused")
    add("--monitor-timeout", type=float, default=10.0,
        help="stuck-cycle watchdog threshold in seconds")
    add("--leader-elect", action="store_true",
        help="gate scheduling rounds on holding the koord-scheduler lease")
    add("--leader-elect-identity", default=None)
    add("--debug-port", type=int, default=None,
        help="serve /healthz /metrics /apis/v1/plugins /debug /explain on "
             "this port")
    return p


def main(argv=None) -> int:
    t_main = time.perf_counter()
    cli = _parser()
    args = cli.parse_args(argv)
    given = [flag for dest, (refused, flag) in NOT_PORTED.items()
             if refused(getattr(args, dest))]
    if given:
        cli.error("not ported yet: " + ", ".join(given))
    from koordinator_tpu_torch import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        # the kernel library (built by nvcc only when this tree's build
        # is missing) before the wiring: the reference restores its warm
        # pool here, so the first round pays no compile
        from koordinator_tpu_torch.ops import binpack_kernel

        binpack_kernel._library()
    library_s = time.perf_counter() - t0
    secret = None
    if args.solver_secret_file:
        with open(args.solver_secret_file, "rb") as f:
            secret = f.read().strip()
    config = SchedulerConfig(
        feature_gates=args.feature_gates,
        schedule_interval_seconds=args.schedule_interval,
        placement_backend=args.placement_backend,
        solver_address=args.solver_address,
        solver_secret=secret,
        solver_failover=args.solver_failover,
        audit_interval_rounds=args.audit_interval_rounds,
        audit_probe_rows=args.audit_probe_rows,
        pipelined_ticks=args.pipelined_ticks,
        trace=not args.no_trace,
        flight_dir=args.flight_dir,
        profile_dir=args.profile_dir,
        monitor_timeout_seconds=args.monitor_timeout,
        node_shards=args.node_shards,
        warm_pool=not args.no_warm_pool,
        streaming=args.streaming,
        stream_watermark=args.stream_watermark,
        stream_deadline_system_s=args.stream_deadline_system,
        stream_deadline_ls_s=args.stream_deadline_ls,
        stream_deadline_be_s=args.stream_deadline_be,
        stream_capacity=args.stream_capacity,
        stream_min_interval_s=args.stream_min_interval,
        slo_system=args.slo_system,
        slo_ls=args.slo_ls,
        slo_be=args.slo_be,
        slo_window_s=args.slo_window,
        slo_cooldown_s=args.slo_cooldown,
        hbm_budget_bytes=args.hbm_budget_bytes,
        migration_max_per_round=args.migration_max_per_round,
        migration_max_per_node=args.migration_max_per_node,
        migration_max_per_tenant=args.migration_max_per_tenant,
        migration_window_s=args.migration_window,
        migration_node_cooldown_s=args.migration_node_cooldown,
        migration_dry_run=args.migration_dry_run,
        defrag_loop=args.defrag_loop,
        defrag_interval_s=args.defrag_interval,
        defrag_cooldown_s=args.defrag_cooldown,
        defrag_confirm=args.defrag_confirm,
        defrag_dry_run=args.defrag_dry_run,
        rebalance_interval_s=args.rebalance_interval,
        rebalance_backend=args.rebalance_backend,
    )
    from koordinator_tpu_torch.client import bus as bus_mod
    from koordinator_tpu_torch.client.wiring import wire_scheduler
    from koordinator_tpu_torch.obs.flight import FLIGHT
    from koordinator_tpu_torch.obs.trace import TRACER

    supervisor = None
    http_server = None
    # everything after the supervisor's spawn runs under its finally: a
    # wiring or readiness failure must never strand a solver child
    # holding the solve socket
    try:
        if args.solver_supervise and args.placement_backend == "sidecar":
            from koordinator_tpu_torch.cmd.solver import parse_address
            from koordinator_tpu_torch.service.supervisor import (
                SolverSupervisor,
            )

            extra = ()
            if args.solver_secret_file:
                extra += ("--secret-file", args.solver_secret_file)
            if args.device is not None:
                extra += ("--device", args.device)
            supervisor = SolverSupervisor(
                parse_address(args.solver_address),
                listen_spec=args.solver_address, extra_argv=extra)
            supervisor.start()
        scheduler = build_scheduler(config, device=device)
        bus = bus_mod.APIServer()
        elector = None
        if args.leader_elect:
            import os

            from koordinator_tpu_torch.client.leaderelection import (
                LeaderElector,
            )

            elector = LeaderElector(
                bus, "koord-scheduler",
                args.leader_elect_identity
                or f"koord-scheduler-{os.getpid()}")
        wire_scheduler(bus, scheduler, elector=elector)
        auditor = None
        if config.audit_interval_rounds > 0:
            from koordinator_tpu_torch.scheduler.auditor import StateAuditor

            auditor = StateAuditor(
                scheduler, bus,
                interval_rounds=config.audit_interval_rounds,
                probe_rows=config.audit_probe_rows)
            scheduler.services.register("state-auditor", auditor.status)
            if elector is not None:
                # the promotion sweep: audit the deposed leader's
                # leavings once per acquisition, before the first round
                prev_started = elector.on_started_leading

                def _on_started(prev=prev_started, aud=auditor):
                    aud.note_promotion()
                    if prev is not None:
                        prev()

                elector.on_started_leading = _on_started
        streaming = None
        if config.streaming:
            # the continuous-arrival front end, wired over the bus: open
            # loop submissions and informer traffic share one trigger
            streaming = build_streaming_loop(scheduler, bus, config,
                                             auditor=auditor)
            build_slo_controller(streaming, bus, config, elector=elector)
        defrag = None
        rebalance = None
        if not config.streaming:
            defrag = build_defrag_controller(scheduler, config)
            rebalance = build_rebalance_plugin(config, device=device)
        elif config.defrag_loop or config.rebalance_interval_s > 0:
            print("defrag loop / in-loop rebalance ride the "
                  "fixed-cadence scheduling loop; ignored in "
                  "--streaming mode")
        t0 = time.perf_counter()
        if args.cluster_json:
            seed_bus_from_json(bus, args.cluster_json)
        seed_s = time.perf_counter() - t0
        if args.debug_port is not None:
            from koordinator_tpu_torch.metrics.components import (
                DEVICE_METRICS,
                SCHEDULER_METRICS,
                WORKINGSET_METRICS,
            )
            from koordinator_tpu_torch.metrics.registry import MergedGatherer
            from koordinator_tpu_torch.obs.device import DEVICE_OBS
            from koordinator_tpu_torch.obs.explain import PlacementExplainer
            from koordinator_tpu_torch.utils.debug_http import DebugHTTPServer

            if supervisor is not None:
                # the supervisor's state machine beside the scheduler's
                # own services: one GET answers "why is my solver down?"
                scheduler.services.register("solver-supervisor",
                                            supervisor.status)
            if hasattr(scheduler.model.backend, "status"):
                scheduler.services.register(
                    "solver-failover", scheduler.model.backend.status)
            scheduler.services.register("flight-recorder", FLIGHT.status)
            scheduler.services.register("trace", TRACER.status)
            scheduler.services.register("device-observatory",
                                        DEVICE_OBS.status)

            def profile(rounds: int) -> dict:
                # a window on the model's device; a PyTorch without CUDA
                # profiling is a permanent incapacity, not a retry
                try:
                    return DEVICE_OBS.request_profile(rounds, device=device)
                except RuntimeError as e:
                    return {"unsupported": True, "error": str(e)}

            http_server = DebugHTTPServer(
                services=scheduler.services, debug=scheduler.debug,
                metrics=MergedGatherer(
                    [SCHEDULER_METRICS, DEVICE_METRICS, WORKINGSET_METRICS]),
                port=args.debug_port, tracer=TRACER,
                explain=PlacementExplainer(scheduler).explain,
                device=DEVICE_OBS.debug_payload, profile=profile,
            ).start()
            print(f"debug http on 127.0.0.1:{http_server.port}")
        from koordinator_tpu_torch.models.placement import host_probe

        probe = host_probe(device, scheduler.model.config)
        probed = ("" if probe is None else
                  f"host cutoff probe {probe['wall_s']:.3f} s -> "
                  f"{probe['cells']} cells, ")
        print(f"koord-scheduler: wired on {device} in "
              f"{time.perf_counter() - t_main:.3f} s (kernel library "
              f"{library_s:.3f} s, {probed}bus seeding {seed_s:.3f} s)",
              flush=True)
        t0 = time.perf_counter()
        rc = run_loop(scheduler, config, once=args.once, elector=elector,
                      auditor=auditor, streaming=streaming, defrag=defrag,
                      rebalance=rebalance)
        print(f"koord-scheduler: loop returned {rc} after "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        return rc
    finally:
        if http_server is not None:
            http_server.stop()
        if supervisor is not None:
            supervisor.stop()


if __name__ == "__main__":
    raise SystemExit(main())
