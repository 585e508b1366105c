"""Per-component metric sets (counterpart of
``koordinator_tpu/metrics/components.py``, cut to the series the ported
scheduler round, its preemption and pod timelines, the eviction control
plane and the descheduler emit, with the reference's names and labels).

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
POD_E2E = SCHEDULER_METRICS.histogram(
    "scheduler_pod_e2e_seconds",
    "Per-pod submit→bind end-to-end latency, by QoS lane "
    "(obs/timeline.py: submit at pending intake, closed when the bind "
    "publishes on the bus)",
    label_names=("lane",),  # system | ls | be
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
