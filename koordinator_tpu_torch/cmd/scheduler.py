"""koord-scheduler's wiring and loop (counterpart of
``koordinator_tpu/cmd/scheduler.py`` without ``main()``).

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
Placements are the same in all three, tick for tick.

:class:`SchedulerConfig` holds the loop's fields, with the reference's
names and defaults. Not ported yet, and queued in ROADMAP.md: ``main()``
and its argument parser (with ``--solver-supervise``), the anti-entropy
auditor (``run_loop(auditor=...)`` raises ``NotImplementedError``), the
scan unroll (its field is absent), the AOT warm pool (``warm_pool`` is
accepted and has no effect), the host path for tiny solves and
node-sharded staging (``build_scheduler`` raises ``NotImplementedError``
for the last two, naming their ROADMAP item).
"""

from __future__ import annotations

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
    #: the host path for tiny plain solves: not ported yet (ROADMAP
    #: Queue 1 item 8); -1 (measure) and 0 mean no host path here, and a
    #: positive cutoff raises
    host_fallback_cells: int = -1
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
    if config.host_fallback_cells > 0:
        raise NotImplementedError(
            "host_fallback_cells > 0: the host path for tiny solves is not "
            "ported yet (ROADMAP Queue 1 item 8)")
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
    model = PlacementModel(
        config=SolverConfig(
            fit_weight=config.fit_weight,
            loadaware_weight=config.loadaware_weight,
            score_according_prod=config.score_according_prod),
        aggregated=aggregated, backend=backend, device=device)
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
    and poison a later re-election's first snapshot. ``max_rounds`` bounds the loop for regression tests: after that
    many attempted rounds the loop returns the number of skipped rounds
    (0 = every round placed).

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
    (a deferred FencingError still triggers the fencing forget), and
    failover mode flips quiesce it through the flip hooks wired here.

    ``auditor`` raises ``NotImplementedError``: the anti-entropy auditor
    (whose sweeps would drain the pipeline first) is not ported yet."""
    from koordinator_tpu_torch.client.leaderelection import FencingError
    from koordinator_tpu_torch.metrics.components import ROUNDS_SKIPPED
    from koordinator_tpu_torch.obs.flight import FLIGHT
    from koordinator_tpu_torch.obs.trace import TRACER
    from koordinator_tpu_torch.service.client import (
        SolverOverloaded,
        SolverUnavailable,
    )

    if auditor is not None:
        raise NotImplementedError(
            "run_loop(auditor=...): the anti-entropy auditor "
            "(scheduler/auditor.py) is not ported yet")
    if config.streaming or streaming is not None:
        # streaming serving mode: the adaptive trigger
        # replaces the fixed cadence entirely — the StreamingLoop owns
        # its own pipeline and watchdog polls
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
