"""Observability: the scheduling trace fabric (counterpart of
``koordinator_tpu/obs``).

- ``obs.trace``    — thread-safe span tracer (bounded ring, monotonic
  clock, Chrome-trace-event export).
- ``obs.timeline`` — per-pod submit→staged→solved→published timelines
  feeding the ``scheduler_pod_e2e_seconds`` histograms by QoS lane.
- ``obs.flight``   — anomaly flight recorder: a bounded ring of recent
  round records dumped to JSON when an anomaly trigger fires (fencing
  abort, deferred pipeline error, manual).
- ``obs.device``   — the device observatory: kernel-library build
  telemetry, the CUDA caching allocator's live bytes, and on-demand
  ``torch.profiler`` windows over the next K rounds.
- ``obs.explain``  — per-node, per-column score breakdowns for one pod
  (``explain_scores``, ``PlacementExplainer``, served at ``/explain``).
"""

from koordinator_tpu_torch.obs.device import DEVICE_OBS, DeviceObservatory
from koordinator_tpu_torch.obs.flight import FLIGHT, FlightRecorder
from koordinator_tpu_torch.obs.timeline import PodTimelines, lane_of
from koordinator_tpu_torch.obs.trace import TRACER, SpanTracer

__all__ = [
    "DEVICE_OBS",
    "DeviceObservatory",
    "FLIGHT",
    "FlightRecorder",
    "PodTimelines",
    "SpanTracer",
    "TRACER",
    "lane_of",
]
