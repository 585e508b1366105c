"""Per-pod QoS lanes (counterpart of ``koordinator_tpu/obs/timeline.py``,
cut to ``lane_of``: the migration arbiter's per-tenant budgets key on
it; the pod timelines themselves are not ported yet)."""

from __future__ import annotations

from koordinator_tpu_torch.apis.extension import QoSClass


def lane_of(pod) -> str:
    """QoS lane label for a pod (system > latency-sensitive > BE)."""
    qos = getattr(pod, "qos", None)
    if qos == QoSClass.SYSTEM:
        return "system"
    if qos == QoSClass.BE:
        return "be"
    return "ls"
