"""Prod-reclaimable predictor: how much prod-requested capacity is idle.

The port's copy of ``koordinator_tpu/koordlet/prediction/predictor.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: pkg/koordlet/prediction/peak_predictor.go — the result that
feeds NodeMetric.ProdReclaimableMetric and, through the manager, the
MID-tier resources:

- podReclaimablePredictor (:128-210): per reclaimable prod pod,
  ``reclaimable += max(request - peak, 0)`` where peak = p95 cpu /
  p98 memory x safety margin; pods in cold start contribute 0.
- priorityReclaimablePredictor (:221-305): per reclaim-supported
  priority class, ``max(Σ request - peak(class usage) - peak(sys), 0)``.
- minPredictor (:307-340): the min of both, per resource.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from koordinator_tpu_torch.koordlet.prediction.predict_server import (
    PeakPredictServer,
    SYS_KEY,
    pod_key,
    priority_key,
)


def prod_reclaimable(
    server: PeakPredictServer,
    pods: Sequence[Tuple[str, int, int]],
    now: float,
) -> Dict[str, int]:
    """``pods`` rows: (uid, cpu_request_mcpu, mem_request_mib) for
    reclaimable prod pods. Returns {"cpu": mCPU, "memory": MiB}."""
    # pod-level view — batch percentile over every pod at once
    keys = [pod_key(uid) for uid, _, _ in pods]
    peaks = server.peaks_batch(keys)
    pod_cpu = 0.0
    pod_mem = 0.0
    prod_cpu_req = 0
    prod_mem_req = 0
    for (uid, cpu_req, mem_req), key, peak in zip(pods, keys, peaks):
        prod_cpu_req += cpu_req
        prod_mem_req += mem_req
        if server.in_cold_start(key, now):
            continue  # cold-start pods reclaim nothing
        if peak["cpu"] is not None:
            pod_cpu += max(cpu_req - peak["cpu"], 0.0)
        if peak["memory"] is not None:
            pod_mem += max(mem_req - peak["memory"], 0.0)

    # priority-class view: requests minus peak class usage minus sys peak
    cls_peak = server.peak(priority_key("prod"))
    sys_peak = server.peak(SYS_KEY)
    pri_cpu = pri_mem = None
    if cls_peak["cpu"] is not None:
        pri_cpu = max(
            prod_cpu_req - cls_peak["cpu"] - (sys_peak["cpu"] or 0.0), 0.0
        )
    if cls_peak["memory"] is not None:
        pri_mem = max(
            prod_mem_req - cls_peak["memory"] - (sys_peak["memory"] or 0.0),
            0.0,
        )

    # min of the two views (minPredictor)
    cpu = pod_cpu if pri_cpu is None else min(pod_cpu, pri_cpu)
    mem = pod_mem if pri_mem is None else min(pod_mem, pri_mem)
    return {"cpu": int(cpu), "memory": int(mem)}
