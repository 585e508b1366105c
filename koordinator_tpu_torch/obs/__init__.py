"""Observability: the scheduling trace fabric (counterpart of
``koordinator_tpu/obs``, cut to the span tracer and the pod timelines;
the flight recorder, the explainer and the device observatory are not
ported yet).

- ``obs.trace``    — thread-safe span tracer (bounded ring, monotonic
  clock, Chrome-trace-event export).
- ``obs.timeline`` — per-pod submit→staged→solved→published timelines
  feeding the ``scheduler_pod_e2e_seconds`` histograms by QoS lane.
"""

from koordinator_tpu_torch.obs.timeline import PodTimelines, lane_of
from koordinator_tpu_torch.obs.trace import TRACER, SpanTracer

__all__ = [
    "PodTimelines",
    "SpanTracer",
    "TRACER",
    "lane_of",
]
