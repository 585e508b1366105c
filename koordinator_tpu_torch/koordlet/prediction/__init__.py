"""Peak prediction (counterpart of ``koordinator_tpu/koordlet/prediction``):
decaying histogram banks, the peak predict server with its checkpoint,
and the prod-reclaimable predictor. numpy, float64, bit for bit the
reference's."""

from koordinator_tpu_torch.koordlet.prediction.histogram import HistogramBank
from koordinator_tpu_torch.koordlet.prediction.predict_server import (
    PeakPredictServer,
    PredictionConfig,
)
from koordinator_tpu_torch.koordlet.prediction.predictor import (
    prod_reclaimable,
)

__all__ = [
    "HistogramBank",
    "PeakPredictServer",
    "PredictionConfig",
    "prod_reclaimable",
]
