"""koordlet, the node agent (counterpart of ``koordinator_tpu/koordlet``,
cut to its reporting half and the prediction subsystem).

Ported: what a node agent measures and what it publishes. ``system``
(the typed cgroup registry, cpu topology and kidled over configurable
roots), ``audit``, ``resourceexecutor`` (the single cgroup write path),
``metriccache`` (numpy ring buffers with batched aggregation),
``metricsadvisor`` (the collectors over procfs, cgroupfs and the sysfs
accel tree), ``statesinformer`` (the node's state, the NodeMetric
reporter and the NodeResourceTopology and Device reporters) and
``prediction`` (the decaying-histogram peak predictor). All of it is
host work in numpy and files, as in the reference. The actuation half
(qosmanager, runtimehooks, pleg, core scheduling, resctrl, the perf
collector and the koordlet binary) is ROADMAP Queue 1 item 11(b).
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
