"""ElasticQuota: PreFilter admission, accounting, multi-tree routing and
PostFilter preemption (counterpart of
``koordinator_tpu/scheduler/plugins/elasticquota.py``; reference
plugin.go:210-321, preempt.go).

Wraps the per-tree host quota managers (``quota/core.py``,
``quota/trees.py``). Pod requests register with the pod's quota tree at
pod creation (:meth:`ElasticQuotaPlugin.on_pod_add`) and leave at
deletion. In the plugin chain PreFilter admits against the tree and
Reserve moves ``used``; the batched round moves ``used`` itself
(``Scheduler._account_quota``). PostFilter selects same-quota
lower-priority victims on the host, reading the lowered node arrays
(``ARRAYS_STATE_KEY``) and the model's LoadAware thresholds
(``THRESHOLDS_KEY``) from the cycle state; :meth:`quota_rows` hands the
host and the device preemption paths the same quota rows.
"""

from __future__ import annotations

from koordinator_tpu_torch.apis.types import resources_to_vector
from koordinator_tpu_torch.quota.core import GroupQuotaManager
from koordinator_tpu_torch.quota.trees import QuotaTreeRegistry
from koordinator_tpu_torch.scheduler.framework import (
    CycleState,
    Plugin,
    Status,
)
from koordinator_tpu_torch.scheduler.plugins.lowering import THRESHOLDS_KEY
from koordinator_tpu_torch.scheduler.preemption import (
    ARRAYS_STATE_KEY,
    find_preemption,
)


class ElasticQuotaPlugin(Plugin):
    name = "ElasticQuota"

    def __init__(self, registry: QuotaTreeRegistry,
                 enable_runtime_quota: bool = True,
                 enable_preemption: bool = True):
        self.registry = registry
        self.enable_runtime_quota = enable_runtime_quota
        self.enable_preemption = enable_preemption

    def _mgr(self, quota_name) -> GroupQuotaManager:
        return self.registry.manager_for_quota(quota_name)

    def score_weight(self) -> int:
        return 0

    # informer events ------------------------------------------------------

    def on_pod_add(self, pod) -> None:
        if pod.quota:
            self._mgr(pod.quota).add_request(
                pod.quota, resources_to_vector(pod.requests),
                non_preemptible=not pod.preemptible)

    def on_pod_delete(self, pod) -> None:
        if pod.quota:
            self._mgr(pod.quota).add_request(
                pod.quota, -resources_to_vector(pod.requests),
                non_preemptible=not pod.preemptible)

    # cycle ----------------------------------------------------------------

    def pre_filter(self, state: CycleState, snapshot, pod) -> Status:
        if not pod.quota:
            return Status.success()
        if self._mgr(pod.quota).can_admit(
                pod.quota, resources_to_vector(pod.requests),
                non_preemptible=not pod.preemptible):
            return Status.success()
        return Status.unschedulable_(f"insufficient quota {pod.quota}")

    def reserve(self, state: CycleState, snapshot, pod, node) -> Status:
        if pod.quota:
            self._mgr(pod.quota).add_used(
                pod.quota, resources_to_vector(pod.requests),
                non_preemptible=not pod.preemptible)
        return Status.success()

    def unreserve(self, state: CycleState, snapshot, pod, node) -> None:
        if pod.quota:
            self._mgr(pod.quota).add_used(
                pod.quota, -resources_to_vector(pod.requests),
                non_preemptible=not pod.preemptible)

    # PostFilter preemption (plugin.go:302, preempt.go) --------------------

    def quota_rows(self, pod):
        """``(quota_used, used_limit)`` of the pod's quota group, or None
        for a pod no quota manages: the PostFilter snapshot's rows the
        reprieve gate checks (preempt.go:176-201), the same for the host
        and the device path."""
        if not pod.quota:
            return None
        mgr = self._mgr(pod.quota)
        info = mgr.quotas.get(pod.quota)
        if info is None:
            return None
        used_limit = (mgr.refresh_runtime(pod.quota)
                      if self.enable_runtime_quota else info.max)
        return info.used, used_limit

    def post_filter(self, state: CycleState, snapshot, pod):
        """Try preempting same-quota lower-priority pods on the host:
        ``(node name, [victim PodSpec])`` or None. The lowered nodes and
        the thresholds come from the cycle state (lowered here, with the
        default thresholds, when absent)."""
        if not self.enable_preemption:
            return None
        rows = self.quota_rows(pod)
        quota_used, used_limit = rows if rows is not None else (None, None)
        arrays = state.get(ARRAYS_STATE_KEY) if state is not None else None
        thr = state.get(THRESHOLDS_KEY) if state is not None else None
        return find_preemption(
            snapshot, pod, quota_used=quota_used, used_limit=used_limit,
            arrays=arrays,
            thresholds=thr[0] if thr else None,
            prod_thresholds=thr[1] if thr else None)
