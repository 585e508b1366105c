"""ElasticQuotaProfile -> per-node-pool quota trees (counterpart of
``koordinator_tpu/quota/profile.py``; the reference's
pkg/quota-controller/profile/profile_controller.go:69-214).

Each profile selects a node pool by label,
sums its allocatable into the tree total, and materialises/updates the
tree's ROOT quota: ``min = pool total`` (masked to the profile's resource
keys), ``max = unbounded``, carrying the pool total and a stable tree id
derived from the profile name.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.apis.types import (
    QuotaSpec,
    Resources,
    selector_matches,
)

#: max quota placeholder (reference: math.MaxInt64/2000)
UNBOUNDED = (2**63 - 1) // 2000


@dataclasses.dataclass
class QuotaProfile:
    """An ElasticQuotaProfile (apis/quota/v1alpha1)."""

    name: str
    quota_name: str
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    resource_keys: Sequence[ResourceName] = (
        ResourceName.CPU,
        ResourceName.MEMORY,
    )
    tree_id: str = ""  # generated from the profile name when empty
    quota_labels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def effective_tree_id(self) -> str:
        if self.tree_id:
            return self.tree_id
        # profile_controller.go:100 hash(namespace/name)
        return hashlib.sha1(self.name.encode()).hexdigest()[:12]


class QuotaProfileController:
    """Reconciles profiles into tree-root QuotaSpecs on the scheduler."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self.profiles: Dict[str, QuotaProfile] = {}

    def update_profile(self, profile: QuotaProfile) -> None:
        self.profiles[profile.name] = profile

    def remove_profile(self, name: str) -> None:
        self.profiles.pop(name, None)

    def sync(self) -> None:
        """One reconcile pass over every profile (Reconcile :80-214)."""
        for profile in self.profiles.values():
            self._reconcile(profile)

    def _reconcile(self, profile: QuotaProfile) -> None:
        total: Resources = {}
        for node in self.scheduler.cache.nodes.values():
            if not selector_matches(profile.node_selector, node.labels):
                continue
            for r, v in node.allocatable.items():
                total[r] = total.get(r, 0) + v
        mn: Resources = {}
        mx: Resources = {}
        for key in profile.resource_keys:
            mn[key] = total.get(key, 0)
            mx[key] = UNBOUNDED
        self.scheduler.update_quota(
            QuotaSpec(
                name=profile.quota_name,
                parent=None,  # tree root
                min=mn,
                max=mx,
                is_parent=True,
                tree_id=profile.effective_tree_id(),
                total_resource=dict(total),
            )
        )
