"""ElasticQuota plugin, its intake half (counterpart of
``koordinator_tpu/scheduler/plugins/elasticquota.py`` lines 21-70).

Pod requests register with the pod's quota tree at pod creation
(:meth:`ElasticQuotaPlugin.on_pod_add`) and leave at deletion; the
batched round then moves ``used`` itself (``Scheduler._account_quota``).
PreFilter admission, Reserve/Unreserve and PostFilter preemption (and
the runtime-quota and parent-check switches they read) belong to the
plugin chain (``scheduler/framework.py``), a later slice of the port.
"""

from __future__ import annotations

from koordinator_tpu_torch.apis.types import resources_to_vector
from koordinator_tpu_torch.quota.core import GroupQuotaManager
from koordinator_tpu_torch.quota.trees import QuotaTreeRegistry


class ElasticQuotaPlugin:
    name = "ElasticQuota"

    def __init__(self, registry: QuotaTreeRegistry,
                 enable_preemption: bool = True):
        self.registry = registry
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
