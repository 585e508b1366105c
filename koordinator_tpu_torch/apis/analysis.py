"""analysis.koordinator.sh API group: Recommendation.

The port's copy of ``koordinator_tpu/apis/analysis.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: apis/analysis/v1alpha1/recommendation_types.go:55 — a
Recommendation targets a workload (CrossVersionObjectReference) or a
pod label selector (:34-42), and its status carries the most recently
computed recommended resources plus update time and conditions (:77-85).
The reference granularity is per-container; the typed model here is
per-pod (PodSpec is the pod-level scheduling unit throughout this
framework), which is the same information the webhook right-sizer and
noderesource consumers need.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from koordinator_tpu_torch.apis.types import PodSpec, Resources, selector_matches


#: status condition types (metav1.Condition analogue)
CONDITION_READY = "RecommendationProvided"
CONDITION_NO_SAMPLES = "NoObservedSamples"


@dataclasses.dataclass
class RecommendationTarget:
    """What the analysis covers (reference: RecommendationTarget,
    types ``workload`` | ``podSelector``).

    ``workload`` uses the same "Kind/namespace/name" controller-owner
    string as :class:`PodSpec.owner`.
    """

    workload: Optional[str] = None
    pod_selector: Optional[Dict[str, str]] = None

    def matches(self, pod: PodSpec) -> bool:
        if self.workload is not None:
            return pod.owner == self.workload
        if self.pod_selector is not None:
            return selector_matches(self.pod_selector, pod.labels)
        return False


@dataclasses.dataclass
class Recommendation:
    """The Recommendation object: user-created spec (target), controller
    -filled status (recommended resources)."""

    name: str
    target: RecommendationTarget
    #: status: recommended per-pod requests (empty until first compute)
    recommended: Resources = dataclasses.field(default_factory=dict)
    update_time: float = 0.0
    #: condition type -> status (True/False)
    conditions: Dict[str, bool] = dataclasses.field(default_factory=dict)

    @property
    def ready(self) -> bool:
        return bool(self.recommended) and self.conditions.get(
            CONDITION_READY, False
        )
