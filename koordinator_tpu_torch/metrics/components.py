"""Per-component metric sets (counterpart of
``koordinator_tpu/metrics/components.py``, cut to the series the ported
scheduler round, its preemption and pod timelines, the eviction control
plane, the pipelined and streaming loops, the stuck-cycle monitor, the
flight recorder, the device observatory and the descheduler emit, with
the reference's names, labels and buckets).

Deliberately absent: the XLA-compile, padding-waste and warm-pool series.
The port compiles no XLA program (its one build is the ``nvcc`` build of
the kernel library, counted in ``DEVICE_COMPILES``), never pads a batch
to a bucket, and has no warm pool.

Reference metric names: pkg/scheduler/metrics/metrics.go,
pkg/descheduler/metrics/metrics.go.
"""

from __future__ import annotations

from koordinator_tpu_torch.metrics.registry import Registry

# -- koord-scheduler (pkg/scheduler/metrics) --------------------------------

SCHEDULER_METRICS = Registry("koord-scheduler")
SCHEDULING_ATTEMPTS = SCHEDULER_METRICS.counter(
    "scheduler_schedule_attempts_total",
    "Scheduling attempts by result",
    label_names=("result",),  # scheduled | unschedulable | error | nominated
)
PENDING_PODS = SCHEDULER_METRICS.gauge(
    "scheduler_pending_pods", "Pods waiting to be scheduled",
)
BATCH_SOLVE_DURATION = SCHEDULER_METRICS.histogram(
    "scheduler_batched_solve_duration_seconds",
    "Device solve wall-clock per batched round",
)
PREEMPTION_ATTEMPTS = SCHEDULER_METRICS.counter(
    "scheduler_preemption_attempts_total",
    "PostFilter preemption attempts",
)
PREEMPT_VICTIMS = SCHEDULER_METRICS.counter(
    "scheduler_preempt_victims_total",
    "Joint place+evict victim flow per outcome: candidates the solve "
    "chose (selected), candidates the reprieve loop spared (reprieved), "
    "victims actually evicted (evicted)",
    label_names=("outcome",),  # selected | reprieved | evicted
)
DEFRAG_DRAINS = SCHEDULER_METRICS.counter(
    "scheduler_defrag_drains_total",
    "Headroom-repack drains applied (pods evicted to restore a "
    "gang-sized hole)",
)
MIGRATION_REQUESTS = SCHEDULER_METRICS.counter(
    "scheduler_migration_requests_total",
    "Eviction victims presented to the migration arbiter, per source",
    label_names=("source",),  # preemption | defrag | rebalance | workingset
)
MIGRATION_ADMITTED = SCHEDULER_METRICS.counter(
    "scheduler_migration_admitted_total",
    "Victims the arbiter admitted within the declared disruption "
    "budgets (working-set demotions count here too: undeferrable)",
    label_names=("source",),  # preemption | defrag | rebalance | workingset
)
MIGRATION_DEFERRALS = SCHEDULER_METRICS.counter(
    "scheduler_migration_deferrals_total",
    "Victims deferred by the arbiter, per typed refusal reason — the "
    "never-dropped-silently contract",
    # reason: cooldown | round-budget | node-budget | tenant-budget |
    #         gang-min-available
    label_names=("source", "reason"),
)
DEFRAG_DECISIONS = SCHEDULER_METRICS.counter(
    "scheduler_defrag_decisions_total",
    "Closed-loop defrag controller decisions, per triggering signal",
    label_names=("signal",),  # frag-over
)
GANG_REJECTIONS = SCHEDULER_METRICS.counter(
    "scheduler_gang_rejections_total",
    "Gang-group rejections (strict failures + WaitTime expiry)",
)
ROUNDS_SKIPPED = SCHEDULER_METRICS.counter(
    "scheduler_rounds_skipped_total",
    "Scheduling rounds skipped outright (solver outage, no failover)",
    label_names=("reason",),  # solver-unavailable
)

# -- pipelined tick path (scheduler/pipeline.py) ----------------------------

TICK_STAGE_DURATION = SCHEDULER_METRICS.histogram(
    "scheduler_tick_stage_seconds",
    "Per-stage wall-clock of one scheduling tick",
    label_names=("stage",),  # lower | stage | solve | publish
)
ROUND_CRITICAL_PATH = SCHEDULER_METRICS.histogram(
    "scheduler_round_critical_path_seconds",
    "Host critical path per round: retire-wait + stage + dispatch "
    "(the solve compute and publish ride the pipeline off-path)",
)
PIPELINE_INFLIGHT = SCHEDULER_METRICS.gauge(
    "scheduler_pipeline_inflight",
    "1 while a dispatched tick has not retired (publish pending)",
)
PIPELINE_DRAINS = SCHEDULER_METRICS.counter(
    "scheduler_pipeline_drains_total",
    "Pipeline quiesce events, by reason",
    # run_loop emits auditor-sweep | failover-flip | standby (the
    # deferred-fence surfacing path) | shutdown | once; drain()'s
    # reason is free-form, so benches/tests add their own
    label_names=("reason",),
)
PIPELINE_DEFERRED_ERRORS = SCHEDULER_METRICS.counter(
    "scheduler_pipeline_deferred_errors_total",
    "Publish-side failures surfaced at the next round boundary",
    label_names=("kind",),  # fencing | solver | other
)

# -- scheduling trace fabric (koordinator_tpu_torch/obs/) -------------------

POD_E2E = SCHEDULER_METRICS.histogram(
    "scheduler_pod_e2e_seconds",
    "Per-pod submit→bind end-to-end latency, by QoS lane "
    "(obs/timeline.py: submit at pending intake, closed when the bind "
    "publishes on the bus)",
    label_names=("lane",),  # system | ls | be
)
STUCK_CYCLES = SCHEDULER_METRICS.counter(
    "scheduler_stuck_cycles_total",
    "Rounds/publishes whose tracer mark stayed open past the watchdog "
    "timeout (scheduler/monitor.py — counted once per stuck mark)",
    label_names=("kind",),  # round | publish
)
FLIGHT_DUMPS = SCHEDULER_METRICS.counter(
    "scheduler_flight_dumps_total",
    "Anomaly flight-recorder dumps written, by trigger",
    # auditor-detection | failover-flip | fencing-abort |
    # pipeline-deferred-error | deadline-exceeded | manual
    label_names=("trigger",),
)

# -- streaming serving mode (scheduler/streaming.py) ------------------------

STREAM_ARRIVALS = SCHEDULER_METRICS.counter(
    "scheduler_streaming_arrivals_total",
    "Pod arrivals admitted into the streaming intake, by QoS lane",
    label_names=("lane",),  # system | ls | be
)
STREAM_SHED = SCHEDULER_METRICS.counter(
    "scheduler_streaming_shed_total",
    "Arrivals refused or evicted by the streaming intake — the "
    "backpressure signal (capacity = intake full; timeline-capacity = "
    "the pod scheduled but its latency sample was refused by the "
    "timeline registry; deadline = expired after max_pod_rounds)",
    label_names=("lane", "reason"),
)
STREAM_TRIGGERS = SCHEDULER_METRICS.counter(
    "scheduler_streaming_round_triggers_total",
    "Adaptively-fired scheduling rounds, by what fired them "
    "(watermark = batch-size; deadline = oldest-pod lane deadline; "
    "idle = the periodic backstop re-solving leftover pending pods)",
    label_names=("reason",),
)
STREAM_QUEUE_DEPTH = SCHEDULER_METRICS.gauge(
    "scheduler_streaming_queue_depth",
    "Arrivals queued in the streaming intake awaiting a round, by lane",
    label_names=("lane",),
)
STREAM_BATCH_PODS = SCHEDULER_METRICS.histogram(
    "scheduler_streaming_round_batch_pods",
    "Arrival-batch size per adaptively-fired round (how well the "
    "trigger amortizes dispatches without stretching the tail)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
)

# -- device observatory (koordinator_tpu_torch/obs/device.py) ---------------
# Its own registry, as in the reference: every long-lived process that
# builds or launches the kernels merges it into its /metrics.

DEVICE_METRICS = Registry("device-observatory")
DEVICE_COMPILES = DEVICE_METRICS.counter(
    "solver_device_compile_total",
    "Kernel-library builds (one nvcc per source and a link) observed, "
    "by library — a process that only loads a built library adds 0",
    label_names=("fn",),
)
DEVICE_COMPILE_SECONDS = DEVICE_METRICS.histogram(
    "solver_device_compile_seconds",
    "Wall-clock of each observed kernel-library build",
    label_names=("fn",),
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
)
DEVICE_LIVE_BUFFERS = DEVICE_METRICS.gauge(
    "solver_device_live_buffers",
    "Allocations the CUDA caching allocator holds in this process "
    "(sampled on status/debug reads — never on the solve path)",
)
DEVICE_LIVE_BYTES = DEVICE_METRICS.gauge(
    "solver_device_live_bytes",
    "Bytes the CUDA caching allocator has handed out "
    "(torch.cuda.memory_allocated; no device sync)",
)
DEVICE_PROFILE_WINDOWS = DEVICE_METRICS.counter(
    "solver_device_profile_windows_total",
    "On-demand torch.profiler windows, by outcome",
    label_names=("result",),  # written | error | rate-limited | refused
)

# -- koord-descheduler (pkg/descheduler/metrics) ----------------------------

DESCHEDULER_METRICS = Registry("koord-descheduler")
PODS_EVICTED = DESCHEDULER_METRICS.counter(
    "descheduler_pods_evicted_total",
    "Pods evicted/migrated by descheduling",
    label_names=("strategy", "node"),
)
DESCHEDULE_LOOP_DURATION = DESCHEDULER_METRICS.histogram(
    "descheduler_loop_duration_seconds",
    "One descheduling cycle's latency",
)
