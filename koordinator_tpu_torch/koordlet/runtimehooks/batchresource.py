"""Batch-resource hook: cgroup limits for BE pods on reclaimed resources.

Reference: pkg/koordlet/runtimehooks/hooks/batchresource/
{batch_resource.go,rule.go} — BE pods request ``kubernetes.io/batch-cpu``
/ ``batch-memory`` (the dynamically reclaimed overcommit computed by the
manager); the kubelet knows nothing about those extended resources, so
this hook translates them into real cgroup values:

- pod/container cpu.shares from summed batch-cpu *requests*
  (batch_resource.go:122 SetPodCPUShares, MilliCPUToShares);
- pod/container cfs quota from summed batch-cpu *limits*
  (:156 SetPodCFSQuota; any unlimited container -> -1; divided by the
  cpu-normalization ratio, ceil, when ratio > 1, rule.go:55);
- pod/container memory limit from batch-memory limits
  (:209 SetPodMemoryLimit; any unlimited container -> -1).

Non-BE pods and pods without batch resources are left untouched.

Counterpart of
``koordinator_tpu/koordlet/runtimehooks/batchresource.py``: host work in
files, bit for bit the reference's.
"""

from __future__ import annotations

import math
from typing import Optional

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import (
    ContainerBatchResources,
)
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import HookRegistry, Stage
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
    ContainerContext,
    PodContext,
    milli_cpu_to_quota,
    milli_cpu_to_shares,
)

NAME = "BatchResource"


class BatchResourcePlugin:
    name = NAME

    def __init__(self):
        #: cpu-normalization ratio (rule.go:86; > 1 shrinks cfs quota)
        self.cpu_normalization_ratio: float = 1.0
        #: rule.go:55 GetCFSQuotaScaleRatio: disabled -> quota unset (-1)
        self.cfs_quota_enabled: bool = True

    def update_rule(self, cpu_normalization_ratio: Optional[float] = None,
                    cfs_quota_enabled: Optional[bool] = None) -> bool:
        changed = False
        if (cpu_normalization_ratio is not None
                and cpu_normalization_ratio != self.cpu_normalization_ratio):
            self.cpu_normalization_ratio = cpu_normalization_ratio
            changed = True
        if (cfs_quota_enabled is not None
                and cfs_quota_enabled != self.cfs_quota_enabled):
            self.cfs_quota_enabled = cfs_quota_enabled
            changed = True
        return changed

    # -- math ----------------------------------------------------------------

    def _scale_quota(self, quota_us: int) -> int:
        if quota_us > 0 and self.cpu_normalization_ratio > 1.0:
            return math.ceil(quota_us / self.cpu_normalization_ratio)
        return quota_us

    @staticmethod
    def _pod_batch_request_mcpu(batch) -> int:
        return sum(
            c.request_mcpu for c in batch.values() if c.request_mcpu > 0
        )

    @staticmethod
    def _pod_batch_limit_mcpu(batch) -> int:
        """Sum of limits; any unlimited container makes the pod
        unlimited (-1) (batch_resource.go:183-196)."""
        total = 0
        for c in batch.values():
            if c.limit_mcpu is None or c.limit_mcpu <= 0:
                return -1
            total += c.limit_mcpu
        return total

    @staticmethod
    def _pod_batch_memory_limit(batch) -> int:
        total = 0
        for c in batch.values():
            if c.memory_limit_bytes is None or c.memory_limit_bytes <= 0:
                return -1
            total += c.memory_limit_bytes
        return total

    # -- hook fns ------------------------------------------------------------

    def set_pod_resources(self, proto) -> None:
        """batch_resource.go:95 SetPodResources."""
        if not isinstance(proto, PodContext):
            return
        req = proto.request
        if req.qos is not QoSClass.BE or not req.batch_resources:
            return
        batch = req.batch_resources
        proto.response.cpu_shares = milli_cpu_to_shares(
            self._pod_batch_request_mcpu(batch)
        )
        if self.cfs_quota_enabled:
            proto.response.cfs_quota_us = self._scale_quota(
                milli_cpu_to_quota(self._pod_batch_limit_mcpu(batch))
            )
        else:
            proto.response.cfs_quota_us = -1
        proto.response.memory_limit_bytes = self._pod_batch_memory_limit(
            batch
        )

    def set_container_resources(self, proto) -> None:
        """batch_resource.go:244 SetContainerResources."""
        if not isinstance(proto, ContainerContext):
            return
        req = proto.request
        if req.qos is not QoSClass.BE:
            return
        c = req.batch
        if c is None:
            return
        proto.response.cpu_shares = milli_cpu_to_shares(c.request_mcpu)
        limit = (
            c.limit_mcpu
            if c.limit_mcpu is not None and c.limit_mcpu > 0
            else -1
        )
        if self.cfs_quota_enabled:
            proto.response.cfs_quota_us = self._scale_quota(
                milli_cpu_to_quota(limit)
            )
        else:
            proto.response.cfs_quota_us = -1
        proto.response.memory_limit_bytes = (
            c.memory_limit_bytes
            if c.memory_limit_bytes is not None and c.memory_limit_bytes > 0
            else -1
        )

    def register(self, registry: HookRegistry) -> None:
        registry.register(
            Stage.PRE_RUN_POD_SANDBOX, self.name,
            "set batch resource limits for BE pod cgroup",
            self.set_pod_resources,
        )
        registry.register(
            Stage.PRE_CREATE_CONTAINER, self.name,
            "set batch resource limits for BE container cgroup",
            self.set_container_resources,
        )
        registry.register(
            Stage.PRE_UPDATE_CONTAINER_RESOURCES, self.name,
            "re-apply batch resource limits on update",
            self.set_container_resources,
        )
