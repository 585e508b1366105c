"""Per-component metric sets (counterpart of
``koordinator_tpu/metrics/components.py``, cut to the series the ported
eviction control plane and descheduler emit, with the reference's names
and labels).

Reference metric names: pkg/scheduler/metrics/metrics.go,
pkg/descheduler/metrics/metrics.go.
"""

from __future__ import annotations

from koordinator_tpu_torch.metrics.registry import Registry

# -- koord-scheduler (pkg/scheduler/metrics) --------------------------------

SCHEDULER_METRICS = Registry("koord-scheduler")
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
