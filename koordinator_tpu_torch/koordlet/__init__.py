"""koordlet, the node agent (counterpart of ``koordinator_tpu/koordlet``).

Ported: what a node agent measures and what it publishes. ``system``
(the typed cgroup registry, cpu topology and kidled over configurable
roots), ``audit``, ``resourceexecutor`` (the single cgroup write path),
``metriccache`` (numpy ring buffers with batched aggregation),
``metricsadvisor`` (the collectors over procfs, cgroupfs and the sysfs
accel tree), ``statesinformer`` (the node's state, the NodeMetric
reporter and the NodeResourceTopology and Device reporters) and
``prediction`` (the decaying-histogram peak predictor); and what it
actuates: ``system.core_sched`` (PR_SCHED_CORE cookies over an injectable
prctl), ``system.resctrl`` (the L3 CAT and MBA schemata), ``qosmanager``
(the eight strategies: cpu suppress, memory and cpu eviction, cpu burst,
resctrl, memcg and blkio reconcile, /proc/sys reconcile) and ``pleg``
(the pod lifecycle events of the kubepods tree); and ``runtimehooks``
(the cpuset, device, bvt, batch-resource, cpu-normalization and terway
hooks that turn the scheduler's placements into cgroup state, through
the reconciler or the NRI server). ``metricsadvisor.performance`` reads
CPI through ``native`` (a perf-group reader that ``g++`` builds on first
use), and ``cmd/koordlet`` assembles the agent. All of it is host work
in numpy and files, as in the reference; ``qosmanager``, ``pleg`` and
``runtimehooks`` are imported by path, as there.
"""

from koordinator_tpu_torch.koordlet.metriccache import (  # noqa: F401
    AggregationType,
    MetricCache,
    MetricKind,
)
from koordinator_tpu_torch.koordlet.metricsadvisor import (  # noqa: F401
    CollectorContext,
    MetricsAdvisor,
    PodMeta,
)
from koordinator_tpu_torch.koordlet.prediction import (  # noqa: F401
    HistogramBank,
    PeakPredictServer,
    PredictionConfig,
    prod_reclaimable,
)
from koordinator_tpu_torch.koordlet.statesinformer import (  # noqa: F401
    DeviceReporter,
    NodeMetricReporter,
    NodeTopologyReporter,
    StatesInformer,
)
from koordinator_tpu_torch.koordlet.system import SystemConfig  # noqa: F401
