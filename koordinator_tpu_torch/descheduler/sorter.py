"""Pod/node eviction-order comparators for the descheduler (a copy of
``koordinator_tpu/descheduler/sorter.py``: integer and tuple ordering,
kept exactly).

Semantics oracle: pkg/descheduler/utils/sorter/{pod.go, scorer.go,
helper.go}. The reference sorts with a chain of comparators under
``sort.Sort`` (MultiSorter); each comparator is a total preorder, so the
whole chain collapses into one sort key per pod — which is how it's
expressed here. Eviction order (ascending, first = evicted first):

1. Koordinator PriorityClass (free < batch < mid < prod < none)
2. numeric k8s priority (lower first)
3. Kubernetes QoS class (besteffort < burstable < guaranteed)
4. Koordinator QoS class (BE < LS < LSR < LSE/SYSTEM < NONE)
5. pod deletion cost annotation (lower first)
6. koordinator eviction cost annotation (lower first)
7. usage score, descending (heavier first; pods with no usage metric
   sort after every metered pod — sorter/pod.go:109-113 cmpBool under
   Reverse)
8. creation time, newest first

The reference's ``sort.Sort``/``sort.Slice`` are unstable, so full-tie
order is arbitrary there; both this module and the rebalance oracle
determinize full ties by input order (Python stable sort), which is one
valid refinement of the reference's unspecified order.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

from koordinator_tpu_torch.apis.extension import PriorityClass, QoSClass
from koordinator_tpu_torch.apis.types import PodSpec

#: sorter/pod.go koordPriorityClassOrder
KOORD_PRIORITY_ORDER: Mapping[PriorityClass, int] = {
    PriorityClass.NONE: 5,
    PriorityClass.PROD: 4,
    PriorityClass.MID: 3,
    PriorityClass.BATCH: 2,
    PriorityClass.FREE: 1,
}

#: sorter/pod.go koordQoSClassOrder
KOORD_QOS_ORDER: Mapping[QoSClass, int] = {
    QoSClass.NONE: 5,
    QoSClass.SYSTEM: 4,
    QoSClass.LSE: 4,
    QoSClass.LSR: 3,
    QoSClass.LS: 2,
    QoSClass.BE: 1,
}

#: k8s PodQOSClass order: guaranteed 3, burstable 2, besteffort 1
_KUBE_GUARANTEED, _KUBE_BURSTABLE, _KUBE_BESTEFFORT = 3, 2, 1

ANNOTATION_DELETION_COST = "controller.kubernetes.io/pod-deletion-cost"
ANNOTATION_EVICTION_COST = "koordinator.sh/eviction-cost"


def kube_qos_order(pod: PodSpec) -> int:
    """Kubernetes QoS class from requests/limits (qos.GetPodQOS):
    guaranteed iff requests == limits and BOTH cpu and memory are
    limited; besteffort iff no requests and no limits; else
    burstable."""
    from koordinator_tpu_torch.apis.extension import ResourceName

    reqs = {k: v for k, v in pod.requests.items() if v}
    lims = {k: v for k, v in pod.limits.items() if v}
    if not reqs and not lims:
        return _KUBE_BESTEFFORT
    if (reqs == lims
            and lims.get(ResourceName.CPU)
            and lims.get(ResourceName.MEMORY)):
        return _KUBE_GUARANTEED
    return _KUBE_BURSTABLE


def _annotation_cost(pod: PodSpec, key: str) -> int:
    """Strict int cost parse (extension.GetEvictionCost:69-84 /
    k8s GetDeletionCostFromPodAnnotations): leading '+'/zeros invalid,
    malformed -> 0."""
    value = pod.annotations.get(key)
    if not value:
        return 0
    first_ok = value[0] == "-" or value == "0" or "1" <= value[0] <= "9"
    if not first_ok:
        return 0
    try:
        return int(value)
    except ValueError:
        return 0


def most_requested_score(requested: int, capacity: int) -> int:
    """sorter/scorer.go mostRequestedScore: min(requested, cap)*1000//cap,
    zero capacity scores 0."""
    if capacity == 0:
        return 0
    if requested > capacity:
        requested = capacity
    return requested * 1000 // capacity


def resource_usage_score(
    usage: Mapping, allocatable: Mapping, weights: Mapping
) -> int:
    """sorter/scorer.go ResourceUsageScorer: weighted mean of
    mostRequestedScore over the resources PRESENT IN THE USAGE MAP —
    absent resources contribute neither score nor weight, so pods
    metered on different resource sets normalize differently, exactly
    like the reference."""
    score = 0
    weight_sum = 0
    for r, q in usage.items():
        w = int(weights.get(r, 0))
        score += most_requested_score(int(q), int(allocatable.get(r, 0))) * w
        weight_sum += w
    if weight_sum == 0:
        return 0
    return score // weight_sum


def pod_sort_static(pod: PodSpec) -> Tuple:
    """The node-independent prefix of the PodSorter chain (everything
    but the usage score) — computable once per pod per sweep and cached
    by callers that sort the same pod set against many nodes."""
    return (
        KOORD_PRIORITY_ORDER.get(
            pod.priority_class or PriorityClass.NONE, 5
        ),
        pod.priority,
        kube_qos_order(pod),
        KOORD_QOS_ORDER.get(pod.qos, 5),
        _annotation_cost(pod, ANNOTATION_DELETION_COST),
        _annotation_cost(pod, ANNOTATION_EVICTION_COST),
        -pod.creation_time,
    )


def pod_sort_key_from_static(
    static: Tuple,
    pod_usage: Optional[Mapping],
    node_allocatable: Mapping,
    weights: Mapping,
) -> Tuple:
    """Assemble the full ascending key from a cached
    :func:`pod_sort_static` prefix plus the node-dependent usage score.

    ``pod_usage`` is the pod's metric ResourceList (None = no metric,
    which sorts after all metered pods)."""
    if pod_usage is None:
        usage_key = (1, 0)
    else:
        usage_key = (
            0, -resource_usage_score(pod_usage, node_allocatable, weights)
        )
    # the usage score slots in just before the creation-time tail
    return static[:-1] + (usage_key, static[-1])


def pod_sort_key(
    pod: PodSpec,
    pod_usage: Optional[Mapping],
    node_allocatable: Mapping,
    weights: Mapping,
) -> Tuple:
    """The full PodSorter comparator chain as one ascending key."""
    return pod_sort_key_from_static(
        pod_sort_static(pod), pod_usage, node_allocatable, weights
    )
