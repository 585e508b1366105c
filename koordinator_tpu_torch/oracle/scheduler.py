"""Per-node scheduler decision functions with the reference's (Go)
semantics (counterpart of ``koordinator_tpu/oracle/scheduler.py``), as
scalar transliterations (Python integers where Go uses int64, float64
where the reference uses float64). The host preemption oracle
(``scheduler/preemption.py``) reads the filters; the plugin chain
(``scheduler/plugins/fit.py``, ``loadaware.py``) filters and scores with
all of them.
"""

from __future__ import annotations

import math
from typing import Sequence

MAX_NODE_SCORE = 100


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


def percent_rounded_go_float64(used: int, total: int) -> int:
    """The reference's literal float64 path (load_aware.go:215). The port
    scores with :func:`percent_rounded`; this form pins, in the tests,
    the .5 boundaries where the two differ by one."""
    if total == 0:
        return 0
    return int(math.floor(float(used) / float(total) * 100 + 0.5))


def least_requested_score(requested: int, capacity: int) -> int:
    """load_aware.go:388-397 (also upstream least_allocated semantics)."""
    if capacity == 0:
        return 0
    if requested > capacity:
        return 0
    return (capacity - requested) * MAX_NODE_SCORE // capacity


def fit_filter_node(pod_req: Sequence[int], alloc: Sequence[int],
                    used: Sequence[int]) -> bool:
    """Upstream NodeResourcesFit: every requested resource must fit."""
    for r, req in enumerate(pod_req):
        if req == 0:
            continue
        if used[r] + req > alloc[r]:
            return False
    return True


def least_allocated_score_node(
    pod_req: Sequence[int],
    alloc: Sequence[int],
    used: Sequence[int],
    weights: Sequence[int],
) -> int:
    """Weighted LeastAllocated over requests (upstream
    NodeResourcesFit's LeastAllocated)."""
    node_score = 0
    weight_sum = 0
    for r, w in enumerate(weights):
        node_score += least_requested_score(used[r] + pod_req[r], alloc[r]) * w
        weight_sum += w
    if weight_sum == 0:
        return 0
    return node_score // weight_sum


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


def loadaware_score_node(
    pod_est: Sequence[int],
    alloc: Sequence[int],
    node_usage: Sequence[int],
    est_extra: Sequence[int],
    prod_base: Sequence[int],
    metric_fresh: bool,
    weights: Sequence[int],
    pod_is_prod: bool,
    score_according_prod: bool = False,
) -> int:
    """The LoadAware score for one node (load_aware.go:269-397) given the
    lowering's assigned-pod corrections (``state/cluster.py``): the base
    is ``node_usage + est_extra``, or ``prod_base`` for a prod pod under
    ``score_according_prod``; a node without a fresh metric scores 0."""
    if not metric_fresh:
        return 0
    prod_mode = score_according_prod and pod_is_prod
    node_score = 0
    weight_sum = 0
    for r, w in enumerate(weights):
        base = prod_base[r] if prod_mode else node_usage[r] + est_extra[r]
        estimated_used = base + pod_est[r]
        node_score += least_requested_score(estimated_used, alloc[r]) * w
        weight_sum += w
    if weight_sum == 0:
        return 0
    return node_score // weight_sum
