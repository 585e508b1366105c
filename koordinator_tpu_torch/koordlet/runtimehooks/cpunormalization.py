"""CPU-normalization hook: scale cpu-share pods' cfs quota by the ratio.

Reference: pkg/koordlet/runtimehooks/hooks/cpunormalization/
cpu_normalization.go — the manager amplifies node CPU allocatable by the
normalization ratio (manager/noderesource.py CPUNormalizationPlugin), so
a pod's kubelet-derived cfs quota over-grants real cycles by the same
factor; this hook divides the quota back (``ceil(quota / ratio)`` when
ratio > 1, :122-131) for cpu-share pods:

- applies to QoS LS and None pods (podQOSConditions :42), but NOT to a
  None pod pinned via the cpuset annotation (isPodCPUShare :157-171 —
  such a pod is effectively LSR and its quota is unset by the cpuset
  hook);
- the ratio arrives with the node metadata (annotation
  ``koordinator.sh/cpu-normalization-ratio``, parseRule reading
  RegisterTypeNodeMetadata).

The original quota is derived from the pod/container CPU limit exactly
as the kubelet derives it (milli_cpu_to_quota); unlimited (<= 0) pods
are left alone (:118-121).

Counterpart of
``koordinator_tpu/koordlet/runtimehooks/cpunormalization.py``: host work
in files, bit for bit the reference's.
"""

from __future__ import annotations

import math
from typing import Optional

from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_CPU_NORMALIZATION_RATIO,
    QoSClass,
)
from koordinator_tpu_torch.koordlet.runtimehooks.cpuset import cpuset_from_annotation
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import HookRegistry, Stage
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
    ContainerContext,
    PodContext,
    milli_cpu_to_quota,
)

NAME = "CPUNormalization"


def parse_ratio_from_annotations(annotations) -> Optional[float]:
    """extension.GetCPUNormalizationRatio: absent/malformed/<= 1 -> None
    (no scaling)."""
    raw = (annotations or {}).get(ANNOTATION_CPU_NORMALIZATION_RATIO)
    if raw is None:
        return None
    try:
        ratio = float(raw)
    except (TypeError, ValueError):
        return None
    if not ratio > 1.0:
        return None
    return ratio


def is_pod_cpu_share(qos: QoSClass, annotations) -> bool:
    """isPodCPUShare (cpu_normalization.go:157-171): LS or None; a pod
    with a scheduler-pinned cpuset is excluded. (The reference excludes
    pinned pods only for QoS None and still *calls* the hook for pinned
    LS pods — but their cfs quota was unset to -1 by the cpuset hook, so
    its ``originalCFSQuota <= 0`` guard skips them anyway, :118-121.
    This framework derives the quota from the limit rather than the live
    cgroup value, so the exclusion must be explicit to preserve the same
    net behavior.)"""
    if qos not in (QoSClass.LS, QoSClass.NONE):
        return False
    return cpuset_from_annotation(annotations or {}) is None


class CPUNormalizationPlugin:
    name = NAME

    def __init__(self):
        self.ratio: Optional[float] = None  # None/<=1 = disabled
        #: one-shot restore: True between a ratio-removal rule change and
        #: the reconcile pass that writes spec quotas back
        self.restoring: bool = False

    def update_rule(self, node) -> bool:
        """parseRule from the node metadata; returns True on change."""
        new = parse_ratio_from_annotations(
            getattr(node, "annotations", None) if node is not None else None
        )
        changed = new != self.ratio
        if changed and new is None:
            self.restoring = True
        self.ratio = new
        return changed

    def finish_restore(self) -> None:
        """Called after the restore reconcile pass has run."""
        self.restoring = False

    def _scaled_quota(self, limit_mcpu: int) -> Optional[int]:
        """ceil(spec quota / ratio) when scaling; during the ONE restore
        pass after a ratio removal, the UNSCALED spec quota (no kubelet
        re-asserts spec quotas in this framework — without the one-shot
        write every LS pod would stay shrunk forever). Steady state
        without a ratio is inert so the hook never fights the
        cfs-quota-burst strategy's scale-ups (qosmanager/cpuburst.py)."""
        if limit_mcpu <= 0:
            return None
        quota = milli_cpu_to_quota(limit_mcpu)
        if quota <= 0:
            return None
        if self.ratio is None:
            return quota if self.restoring else None
        return math.ceil(quota / self.ratio)

    def adjust_pod_cfs_quota(self, proto) -> None:
        """AdjustPodCFSQuota (:79)."""
        if not isinstance(proto, PodContext):
            return
        req = proto.request
        if not is_pod_cpu_share(req.qos, req.annotations):
            return
        quota = self._scaled_quota(req.pod_meta.cpu_limit_mcpu)
        if quota is not None:
            proto.response.cfs_quota_us = quota

    def adjust_container_cfs_quota(self, proto) -> None:
        """AdjustContainerCFSQuota (:95). Container limits come from
        PodMeta.container_limits_mcpu when the informer reports them;
        a missing entry leaves the container alone."""
        if not isinstance(proto, ContainerContext):
            return
        req = proto.request
        if not is_pod_cpu_share(req.qos, req.annotations):
            return
        limit = req.pod_meta.container_limits_mcpu.get(req.container_name, 0)
        quota = self._scaled_quota(limit)
        if quota is not None:
            proto.response.cfs_quota_us = quota

    def register(self, registry: HookRegistry) -> None:
        registry.register(
            Stage.PRE_RUN_POD_SANDBOX, self.name,
            "scale pod cfs quota by cpu-normalization ratio",
            self.adjust_pod_cfs_quota,
        )
        registry.register(
            Stage.PRE_CREATE_CONTAINER, self.name,
            "scale container cfs quota by cpu-normalization ratio",
            self.adjust_container_cfs_quota,
        )
        registry.register(
            Stage.PRE_UPDATE_CONTAINER_RESOURCES, self.name,
            "re-scale container cfs quota on update",
            self.adjust_container_cfs_quota,
        )
