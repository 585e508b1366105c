"""koordlet, the node agent (counterpart of ``koordinator_tpu/koordlet``,
cut to the prediction subsystem).

Only ``koordlet/prediction`` is ported: the decaying-histogram peak
predictor that the manager's recommendation controller reuses at the
cluster level. The rest of the node agent (statesinformer, metriccache,
metricsadvisor, qosmanager, resourceexecutor, runtimehooks, pleg, audit)
is ROADMAP Queue 1 item 11(b).
"""

from koordinator_tpu_torch.koordlet.prediction import (  # noqa: F401
    HistogramBank,
    PeakPredictServer,
    PredictionConfig,
    prod_reclaimable,
)
