"""Per-component metric sets (counterpart of
``koordinator_tpu/metrics/components.py``, cut to the series the ported
scheduler round, its preemption and pod timelines, the eviction control
plane, the anti-entropy auditor, the pipelined and streaming loops, the
stuck-cycle monitor, the flight recorder, the device observatory, the
serving failure domain (failover, supervisor, SLO controller, HBM working
set, the solver's admission gate), the descheduler and the koordlet's
internal and external sets, and the warm pool emit, with the reference's names, labels and
buckets).

Deliberately absent: the XLA-compile and padding-waste series. The port
compiles no XLA program (its one build is the ``nvcc`` build of the
kernel library, counted in ``DEVICE_COMPILES``) and never pads a batch to
a bucket. The warm-pool series keep the reference's names: the pool's
entries are a kernel library and CUDA graphs (``service/warmpool.py``).

Reference metric names: pkg/scheduler/metrics/metrics.go,
pkg/descheduler/metrics/metrics.go, pkg/koordlet/metrics/.
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

SOLVER_DEGRADED = SCHEDULER_METRICS.gauge(
    "scheduler_solver_degraded",
    "1 while the failover backend answers solves in-process",
)
SOLVER_FAILOVERS = SCHEDULER_METRICS.counter(
    "scheduler_solver_failovers_total",
    "Failover state-machine flips",
    label_names=("direction",),  # to-degraded | to-remote
)
SOLVER_LOCAL_SOLVES = SCHEDULER_METRICS.counter(
    "scheduler_solver_local_solves_total",
    "Solves answered by the in-process fallback instead of the sidecar",
    label_names=("mode",),  # local-fallback | local-degraded
)
SUPERVISOR_RESTARTS = SCHEDULER_METRICS.counter(
    "solver_supervisor_restarts_total",
    "Sidecar restarts performed by the supervisor",
    label_names=("reason",),  # crashed | hung | down
)
SUPERVISOR_RESPAWN_WARM = SCHEDULER_METRICS.counter(
    "solver_supervisor_respawn_warm_total",
    "Supervised child (re)spawns that warm-restored from the warm pool "
    "— probed on the tight warm ready grace instead of the "
    "cold allowance",
)
SUPERVISOR_UP = SCHEDULER_METRICS.gauge(
    "solver_supervisor_child_up",
    "1 while the supervised sidecar passes liveness probes",
)
SUPERVISOR_BREAKER_OPEN = SCHEDULER_METRICS.gauge(
    "solver_supervisor_breaker_open",
    "1 while the restart-storm circuit breaker refuses respawns",
)

# -- anti-entropy auditor (scheduler/auditor.py) ----------------------------
# every drift detection and every repair of the StateAuditor is counted:
# the repair ladder (targeted -> cache-rebuild -> full-restage) never acts
# silently

AUDIT_SWEEPS = SCHEDULER_METRICS.counter(
    "scheduler_audit_sweeps_total",
    "Anti-entropy sweeps run, by trigger",
    label_names=("kind",),  # periodic | promotion | manual
)
AUDIT_DETECTIONS = SCHEDULER_METRICS.counter(
    "scheduler_audit_detections_total",
    "Drift/invariant detections, by trust boundary and drift kind",
    label_names=("boundary", "kind"),  # cache-bus | accounting | device-parity
)
AUDIT_REPAIRS = SCHEDULER_METRICS.counter(
    "scheduler_audit_repairs_total",
    "Repairs applied, by ladder rung",
    label_names=("action",),  # targeted | cache-rebuild | full-restage
)
AUDIT_SWEEP_DURATION = SCHEDULER_METRICS.histogram(
    "scheduler_audit_sweep_seconds",
    "Wall-clock per anti-entropy sweep",
)
AUDIT_LAST_DRIFT = SCHEDULER_METRICS.gauge(
    "scheduler_audit_last_sweep_drift",
    "Detections in the most recent sweep (0 on a healthy tick)",
)
AUDIT_PROBE_ROWS = SCHEDULER_METRICS.counter(
    "scheduler_audit_probe_rows_total",
    "Staged rows re-lowered and compared by the device-parity probe",
)
AUDIT_UNREPAIRED = SCHEDULER_METRICS.gauge(
    "scheduler_audit_unrepaired",
    "Invariant violations that survived the repair ladder (page on >0)",
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

# -- serving SLO controller (control/slo.py) --------------------------------

SLO_DECISIONS = SCHEDULER_METRICS.counter(
    "scheduler_slo_decisions_total",
    "Knob adjustments the serving SLO controller applied, by knob and "
    "trigger signal (one knob per reconcile, cooldown-gated — a high "
    "rate here means the declared SLO fights the offered load)",
    label_names=("knob", "signal"),
    # knob: watermark | deadline | capacity
    # signal: p99-over | p99-under | shed-capacity | padding-waste
)
SLO_LANE_P99_RATIO = SCHEDULER_METRICS.gauge(
    "scheduler_slo_lane_p99_ratio",
    "Rolling-window submit→bind p99 over the declared per-lane target "
    "(<= 1.0 means the lane meets its SLO; only exported for lanes "
    "with a declared target and enough window samples)",
    label_names=("lane",),  # system | ls | be
)

# -- HBM working-set manager (state/workingset.py) --------------------------
# Its own registry, as in the reference: the ledger lives in whichever
# long-lived process stages worlds (the in-process scheduler and the
# solver sidecar), so both muxes merge it.

WORKINGSET_METRICS = Registry("hbm-workingset")
HBM_BUDGET_BYTES = WORKINGSET_METRICS.gauge(
    "scheduler_hbm_budget_bytes",
    "Configured HBM budget for staged tenant worlds (0 = unlimited; "
    "the working-set manager demotes victims instead of staging past "
    "this line)",
)
HBM_USED_BYTES = WORKINGSET_METRICS.gauge(
    "scheduler_hbm_used_bytes",
    "Metadata-summed bytes of device-resident staged worlds currently "
    "charged against the HBM budget",
)
TENANT_RESIDENCY = WORKINGSET_METRICS.gauge(
    "scheduler_tenant_residency",
    "Registered staged worlds per residency rung of the eviction "
    "ladder (device-resident, host-pinned, cold)",
    label_names=("rung",),  # device | host | cold
)
WORKINGSET_DEMOTIONS = WORKINGSET_METRICS.counter(
    "scheduler_workingset_demotions_total",
    "Residency demotions (one rung each) applied by the working-set "
    "manager, by cause: headroom for a new/regrown world (admission), "
    "over the budget line after a touch or squeeze (budget), or the "
    "allocation-failure retry ladder (alloc-failure)",
    label_names=("reason",),  # admission | budget | alloc-failure
)
WORKINGSET_RESTAGES = WORKINGSET_METRICS.counter(
    "scheduler_workingset_restages_total",
    "Demoted worlds re-staged onto the device on their next solve, by "
    "the rung they came back from (host = re-upload of the kept host "
    "arrays; cold = full re-lower from typed truth)",
    label_names=("reason",),  # host | cold
)
WORKINGSET_ALLOC_FAILURES = WORKINGSET_METRICS.counter(
    "scheduler_workingset_alloc_failures_total",
    "Device allocation failures (a real torch.cuda.OutOfMemoryError or "
    "an injected one) caught at the staging boundary, by which boundary "
    "raised: a full world staging (stage) or a delta row scatter "
    "(scatter); each is followed by demotion + bounded retry, never an "
    "unhandled crash",
    label_names=("reason",),  # stage | scatter
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

# -- warm pool (service/warmpool.py) -----------------------------------------
# The restart/promotion/failover warm path's health, in the DEVICE
# registry: both long-lived processes restore from the pool (the scheduler
# on promotion and for its failover twin, the solver child on respawn).

WARM_POOL_HITS = DEVICE_METRICS.counter(
    "scheduler_warm_pool_hits_total",
    "Store entries loaded clean (a kernel library or a signature whose "
    "solve a restore captures as a CUDA graph)",
)
WARM_POOL_MISSES = DEVICE_METRICS.counter(
    "scheduler_warm_pool_misses_total",
    "Clean store misses (no entry for the key): that shape stays cold",
)
WARM_POOL_REJECTS = DEVICE_METRICS.counter(
    "scheduler_warm_pool_rejects_total",
    "Store entries refused by the rejection ladder, by typed reason: "
    "each degrades that shape to a cold solve, never a crash",
    # truncated | corrupt | fingerprint | oversized | stale-host |
    # version-skew
    label_names=("reason",),
)
WARM_RESTORE_SECONDS = DEVICE_METRICS.histogram(
    "scheduler_warm_restore_seconds",
    "Wall-clock per warm-pool restore pass (boot, leader promotion, "
    "failover prewarm): manifest read, entry loads and graph captures",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0),
)
WARM_POOL_QUARANTINED = DEVICE_METRICS.counter(
    "scheduler_warm_pool_quarantined_total",
    "Store entries (or manifests) moved aside after a typed load "
    "failure: never retried in a loop, never a crash",
)

# -- koordlet (pkg/koordlet/metrics: internal + external sets) --------------

KOORDLET_INTERNAL_METRICS = Registry("koordlet-internal")
CGROUP_WRITES = KOORDLET_INTERNAL_METRICS.counter(
    "koordlet_resource_executor_writes_total",
    "Cgroup writes issued by the resource executor",
    label_names=("resource",),
)
COLLECT_DURATION = KOORDLET_INTERNAL_METRICS.histogram(
    "koordlet_collect_duration_seconds",
    "Metrics-advisor collection pass latency",
    label_names=("collector",),
)
PREDICT_DURATION = KOORDLET_INTERNAL_METRICS.histogram(
    "koordlet_predict_duration_seconds",
    "Peak predictor update latency",
)

KOORDLET_EXTERNAL_METRICS = Registry("koordlet-external")
BE_SUPPRESS_CPU_CORES = KOORDLET_EXTERNAL_METRICS.gauge(
    "koordlet_be_suppress_cpu_cores",
    "Current BE CPU suppress target in cores",
)
POD_EVICTIONS = KOORDLET_EXTERNAL_METRICS.counter(
    "koordlet_pod_evictions_total",
    "Pods evicted by QoS strategies",
    label_names=("reason",),
)
NODE_RESOURCE_ALLOCATABLE = KOORDLET_EXTERNAL_METRICS.gauge(
    "koordlet_node_resource_allocatable",
    "Reported node allocatable per resource",
    label_names=("resource",),
)
CONTAINER_CPI_METRIC = KOORDLET_EXTERNAL_METRICS.gauge(
    "koordlet_container_cpi",
    "Latest cycles-per-instruction per container",
    label_names=("pod", "container"),
)

# -- koord-solver sidecar (service/admission.py gate) -----------------------

SOLVER_METRICS = Registry("koord-solver")
# The wait/shed/depth series carry a ``tenant`` label: K front-ends share
# one sidecar, so "which tenant is overloaded / starving / flooding" is
# answerable from /metrics alone. Single-tenant deployments see one
# constant label value ("default").
SOLVER_ADMISSION_WAIT = SOLVER_METRICS.histogram(
    "solver_admission_wait_seconds",
    "Queue wait from enqueue to dispatch, per QoS lane and tenant",
    label_names=("lane", "tenant"),
)
SOLVER_SOLVE_DURATION = SOLVER_METRICS.histogram(
    "solver_batch_solve_seconds",
    "Device solve wall-clock per dispatched admission batch",
)
SOLVER_ADMISSION_SHED = SOLVER_METRICS.counter(
    "solver_admission_shed_total",
    "Requests shed by the admission gate",
    # overloaded | deadline | shutdown
    label_names=("lane", "reason", "tenant"),
)
SOLVER_QUEUE_DEPTH = SOLVER_METRICS.gauge(
    "solver_admission_queue_depth",
    "Currently queued requests per QoS lane and tenant",
    label_names=("lane", "tenant"),
)
SOLVER_ADMISSION_REQUESTS = SOLVER_METRICS.counter(
    "solver_admission_requests_total",
    "Requests dispatched to the device, by batch mode",
    label_names=("mode",),  # coalesced | lanes | solo
)
SOLVER_ADMISSION_BATCHES = SOLVER_METRICS.counter(
    "solver_admission_batches_total",
    "Device dispatches (coalesce ratio = requests_total / this)",
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
