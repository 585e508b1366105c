"""Pod validating admission.

The port's copy of ``koordinator_tpu/webhook/validating.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: pkg/webhook/pod/validating/cluster_colocation_profile.go:35-140
— required QoS for colocation resources, immutability of QoS/priority on
update, forbidden QoS×priority combinations, and LSR/LSE integer-CPU
requirements.
"""

from __future__ import annotations

from typing import List, Optional

from koordinator_tpu_torch.apis.extension import (
    PriorityClass,
    QoSClass,
    ResourceName,
    priority_class_of,
)
from koordinator_tpu_torch.apis.types import PodSpec

#: QoS class -> priority classes it must NOT combine with
#: (forbidSpecialQoSClassAndPriorityClass calls, :58-59)
_FORBIDDEN = {
    QoSClass.BE: (PriorityClass.NONE, PriorityClass.PROD),
    QoSClass.LSR: (
        PriorityClass.NONE,
        PriorityClass.MID,
        PriorityClass.BATCH,
        PriorityClass.FREE,
    ),
}


class PodValidatingWebhook:
    """Validates pods at create/update; returns the list of violations
    (empty = admitted)."""

    def validate(
        self, pod: PodSpec, old_pod: Optional[PodSpec] = None
    ) -> List[str]:
        errs: List[str] = []
        if old_pod is not None:
            errs += self._validate_immutable(old_pod, pod)
        errs += self._validate_required_qos(pod)
        errs += self._validate_forbidden_combos(pod)
        errs += self._validate_resources(pod)
        return errs

    # update: QoS, priority class, and koordinator priority are immutable
    # (:52-54, validateImmutable*)
    def _validate_immutable(self, old: PodSpec, new: PodSpec) -> List[str]:
        errs = []
        if old.qos != new.qos:
            errs.append("labels.koordinator.sh/qosClass: field is immutable")
        old_pc = old.priority_class or priority_class_of(value=old.priority)
        new_pc = new.priority_class or priority_class_of(value=new.priority)
        if old_pc != new_pc:
            errs.append("spec.priority: field is immutable")
        if old.sub_priority != new.sub_priority:
            errs.append("labels.koordinator.sh/priority: field is immutable")
        return errs

    # batch resources require QoS BE (validateRequiredQoSClass :71-85)
    def _validate_required_qos(self, pod: PodSpec) -> List[str]:
        batch = pod.requests.get(ResourceName.BATCH_CPU, 0) or pod.requests.get(
            ResourceName.BATCH_MEMORY, 0
        )
        if not batch or pod.qos == QoSClass.BE:
            return []
        return [
            "labels.koordinator.sh/qosClass: must specify koordinator QoS "
            "BE with koordinator colocation resources"
        ]

    def _validate_forbidden_combos(self, pod: PodSpec) -> List[str]:
        forbidden = _FORBIDDEN.get(pod.qos)
        if forbidden is None:
            return []
        # __post_init__ guarantees priority_class is populated; it is the
        # authoritative class (the mutator may set it directly)
        pc = pod.priority_class or priority_class_of(value=pod.priority)
        if pc in forbidden:
            return [
                f"Pod: qosClass={pod.qos.name} and priorityClass={pc.name} "
                "cannot be used in combination"
            ]
        return []

    # LSR/LSE pods must declare integer CPUs (validateResources :123-140)
    def _validate_resources(self, pod: PodSpec) -> List[str]:
        if pod.qos not in (QoSClass.LSR, QoSClass.LSE):
            return []
        cpu = pod.requests.get(ResourceName.CPU, 0)
        if cpu == 0:
            return [
                "pod.spec.containers[*].resources.requests: "
                f"{pod.qos.name} Pod must declare the requested CPUs"
            ]
        if cpu % 1000 != 0:
            return [
                "pod.spec.containers[*].resources.requests: the requested "
                f"CPUs of {pod.qos.name} Pod must be integer"
            ]
        return []
