"""Per-node host filters with the reference's (Go) semantics: the part of
``koordinator_tpu/oracle/scheduler.py`` the host preemption oracle
(``scheduler/preemption.py``) reads, as scalar transliterations (Python
integers where Go uses int64).
"""

from __future__ import annotations

from typing import Sequence


def percent_rounded(used: int, total: int) -> int:
    """``round(used / total * 100)``, half away from zero, in exact
    rational arithmetic: ``floor((200*used + total) / (2*total))``.

    A documented deviation from the reference's float64 form
    (load_aware.go:215, ``math.Round(float64(used)/float64(total)*100)``),
    whose division can land an exact .5 just below the half (used=23,
    total=40 gives 57 there, 58 here); the device path uses the exact form
    too."""
    if total == 0:
        return 0
    return (200 * used + total) // (2 * total)


def fit_filter_node(pod_req: Sequence[int], alloc: Sequence[int],
                    used: Sequence[int]) -> bool:
    """Upstream NodeResourcesFit: every requested resource must fit."""
    for r, req in enumerate(pod_req):
        if req == 0:
            continue
        if used[r] + req > alloc[r]:
            return False
    return True


def loadaware_filter_node(
    alloc: Sequence[int],
    node_usage: Sequence[int],
    prod_usage: Sequence[int],
    metric_fresh: bool,
    thresholds: Sequence[int],
    prod_thresholds: Sequence[int],
    pod_is_daemonset: bool,
    pod_is_prod: bool,
) -> bool:
    """The LoadAware filter for one node (load_aware.go:123-255); True =
    the node passes."""
    if pod_is_daemonset:
        return True
    if not metric_fresh:
        return True
    prod_mode = pod_is_prod and any(t > 0 for t in prod_thresholds)
    if prod_mode:
        usage_vec, thr_vec = prod_usage, prod_thresholds
    else:
        usage_vec, thr_vec = node_usage, thresholds
    for r, threshold in enumerate(thr_vec):
        if threshold == 0:
            continue
        if alloc[r] == 0:
            continue
        if percent_rounded(usage_vec[r], alloc[r]) >= threshold:
            return False
    return True
