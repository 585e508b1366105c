"""Multi-quota-tree registry: one GroupQuotaManager per tree (counterpart
of ``koordinator_tpu/quota/trees.py``).

Reference: pkg/scheduler/plugins/elasticquota/quota_handler.go
(GetOrCreateGroupQuotaManagerForTree :143, GetGroupQuotaManagerForTree
:172, quota→tree routing via the quota-tree-id label). Trees are created
on demand; the default (empty id) tree spans the whole cluster, while
profile-created trees carry their node pool's total resource on their
root quota (quota-controller, profile_controller.go).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.apis.types import QuotaSpec, resources_to_vector
from koordinator_tpu_torch.quota.core import GroupQuotaManager


class QuotaTreeRegistry:
    """Routes quotas to per-tree managers (the plugin's
    groupQuotaManagersForQuotaTree map)."""

    def __init__(self, cluster_total=None):
        self.default = GroupQuotaManager(cluster_total=cluster_total or {})
        self.trees: Dict[str, GroupQuotaManager] = {"": self.default}
        #: quota name -> tree id (the reference's quotaToTreeMap)
        self.quota_tree: Dict[str, str] = {}

    def manager_for_tree(self, tree_id: str) -> GroupQuotaManager:
        mgr = self.trees.get(tree_id)
        if mgr is None:
            mgr = GroupQuotaManager()
            self.trees[tree_id] = mgr
        return mgr

    def manager_for_quota(self, quota_name: Optional[str]) -> GroupQuotaManager:
        if not quota_name:
            return self.default
        return self.manager_for_tree(self.quota_tree.get(quota_name, ""))

    def update_quota(self, spec: QuotaSpec) -> None:
        old_tree = self.quota_tree.get(spec.name)
        carry = None
        if old_tree is not None and old_tree != spec.tree_id:
            # moved trees: withdraw the quota's propagated accounting from
            # the old ancestors, then re-add under the new manager with
            # its live request/used carried over
            old = self.trees.get(old_tree)
            if old is not None:
                info = old.quotas.get(spec.name)
                if info is not None:
                    carry = (
                        info.child_request.copy(),
                        info.non_preemptible_request.copy(),
                        info.used.copy(),
                        info.non_preemptible_used.copy(),
                    )
                    self._shift_accounting(old, spec.name, carry, sign=-1)
                old.quotas.pop(spec.name, None)
                old._rebuild_children()
        self.quota_tree[spec.name] = spec.tree_id
        mgr = self.manager_for_tree(spec.tree_id)
        if spec.total_resource is not None and (
            spec.parent is None or spec.parent == "root"
        ):
            # only tree ROOTS carry the node pool total (profile
            # controller); non-root totals are ignored so a stale spec
            # can't clobber the tree total
            mgr.cluster_total = resources_to_vector(spec.total_resource)
        mgr.update_quota(spec)
        if carry is not None:
            self._shift_accounting(mgr, spec.name, carry, sign=+1)

    @staticmethod
    def _shift_accounting(mgr: GroupQuotaManager, name: str, carry, sign: int) -> None:
        """Add/subtract a quota's live accounting along ``mgr``'s ancestry
        (tree-move migration): preemptible request/used go through the
        manager's propagation; the non-preemptible components propagate
        unchanged, so they shift by plain ancestry walk."""
        child_request, np_request, used, np_used = carry
        mgr.add_request(name, sign * child_request)
        mgr.add_used(name, sign * used)
        for anc in mgr._ancestry(name):
            anc.non_preemptible_request = np.maximum(
                anc.non_preemptible_request + sign * np_request, 0
            )
            anc.non_preemptible_used = np.maximum(
                anc.non_preemptible_used + sign * np_used, 0
            )

    def remove_quota(self, name: str) -> None:
        """Quota deleted: withdraw its propagated request/used from the
        old ancestors (the tree-move withdraw), then drop the node."""
        tree_id = self.quota_tree.pop(name, "")
        mgr = self.trees.get(tree_id)
        if mgr is None:
            return
        info = mgr.quotas.get(name)
        if info is not None:
            self._shift_accounting(
                mgr,
                name,
                (
                    info.child_request.copy(),
                    info.non_preemptible_request.copy(),
                    info.used.copy(),
                    info.non_preemptible_used.copy(),
                ),
                sign=-1,
            )
            mgr.quotas.pop(name, None)
            mgr._rebuild_children()

    def items(self) -> Iterable[Tuple[str, GroupQuotaManager]]:
        return self.trees.items()
