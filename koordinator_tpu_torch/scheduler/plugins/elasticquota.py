"""ElasticQuota plugin: its intake half and its PostFilter preemption
(counterpart of ``koordinator_tpu/scheduler/plugins/elasticquota.py``).

Pod requests register with the pod's quota tree at pod creation
(:meth:`ElasticQuotaPlugin.on_pod_add`) and leave at deletion; the
batched round then moves ``used`` itself (``Scheduler._account_quota``).
PostFilter (:meth:`ElasticQuotaPlugin.post_filter`) selects same-quota
lower-priority victims on the host (reference: plugin.go:302,
preempt.go); :meth:`ElasticQuotaPlugin.quota_rows` hands the host and the
device preemption paths the same quota rows. The reference's framework
seeds each cycle with the lowered node arrays and the model's LoadAware
thresholds; the port has no cycle seed, so the caller passes them.
PreFilter admission and Reserve/Unreserve (and the parent-check switch)
belong to the plugin chain (``scheduler/framework.py``), a later slice of
the port.
"""

from __future__ import annotations

from koordinator_tpu_torch.apis.types import resources_to_vector
from koordinator_tpu_torch.quota.core import GroupQuotaManager
from koordinator_tpu_torch.quota.trees import QuotaTreeRegistry
from koordinator_tpu_torch.scheduler.preemption import find_preemption


class ElasticQuotaPlugin:
    name = "ElasticQuota"

    def __init__(self, registry: QuotaTreeRegistry,
                 enable_runtime_quota: bool = True,
                 enable_preemption: bool = True):
        self.registry = registry
        self.enable_runtime_quota = enable_runtime_quota
        self.enable_preemption = enable_preemption

    def _mgr(self, quota_name) -> GroupQuotaManager:
        return self.registry.manager_for_quota(quota_name)

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

    def post_filter(self, snapshot, pod, arrays=None, thresholds=None,
                    prod_thresholds=None):
        """Try preempting same-quota lower-priority pods on the host:
        ``(node name, [victim PodSpec])`` or None. ``arrays`` are the
        lowered nodes (lowered here when None); the thresholds are the
        placement model's LoadAware ones (the defaults when None)."""
        if not self.enable_preemption:
            return None
        rows = self.quota_rows(pod)
        quota_used, used_limit = rows if rows is not None else (None, None)
        return find_preemption(
            snapshot, pod, quota_used=quota_used, used_limit=used_limit,
            arrays=arrays, thresholds=thresholds,
            prod_thresholds=prod_thresholds)
