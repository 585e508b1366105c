"""ElasticQuota topology guard: admission for quota create/update/delete.

The port's copy of ``koordinator_tpu/webhook/quota_topology.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: pkg/webhook/elasticquota/quota_topology.go (ValidAddQuota :59,
ValidUpdateQuota :97, ValidDeleteQuota :153) and quota_topology_check.go:

- validateQuotaSelfItem (:38-67): min/max/shared-weight dimensions must be
  non-negative; every min key must exist in max with ``min <= max``;
- checkParentQuotaInfo (:166): the parent must exist and be ``is_parent``;
- checkTreeID (:110): a child's tree id must match its parent's;
- checkSubAndParentGroupMaxQuotaKeySame (:182): a non-root-parent child's
  max keys must equal its parent's max keys;
- checkMinQuotaValidate (:216): Σ sibling mins (self included) must fit
  the parent min, and Σ children mins must fit the quota's own min;
- ValidDeleteQuota forbids deleting a quota that still has children.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.types import QuotaSpec
from koordinator_tpu_torch.quota.core import ROOT_QUOTA as ROOT


class QuotaTopologyError(Exception):
    """Admission rejection with the violated rule."""


class QuotaTopologyGuard:
    """Validates quota topology before specs reach the tree managers."""

    def __init__(self):
        self.quotas: Dict[str, QuotaSpec] = {}

    def _children(self, parent: str) -> List[QuotaSpec]:
        return [
            q for q in self.quotas.values() if (q.parent or ROOT) == parent
        ]

    # -- public admission ----------------------------------------------------

    def validate_add(self, spec: QuotaSpec) -> None:
        if spec.name in self.quotas:
            raise QuotaTopologyError(f"quota {spec.name} already exists")
        self._validate_self(spec)
        self._validate_topology(spec)
        self.quotas[spec.name] = spec

    def validate_update(self, spec: QuotaSpec) -> None:
        old = self.quotas.get(spec.name)
        if old is None:
            raise QuotaTopologyError(f"quota {spec.name} not found")
        if spec.tree_id != old.tree_id:
            # checkTreeID: the tree id cannot change on update
            raise QuotaTopologyError(
                f"quota {spec.name} tree id is immutable "
                f"({old.tree_id!r} -> {spec.tree_id!r})"
            )
        if not spec.is_parent and old.is_parent and self._children(spec.name):
            # checkIsParentChange (:148): a quota with children cannot
            # stop being a parent
            raise QuotaTopologyError(
                f"quota {spec.name} has children, isParent is forbidden to "
                "modify as false"
            )
        self._validate_self(spec)
        self._validate_topology(spec)
        self.quotas[spec.name] = spec

    def validate_delete(self, name: str) -> None:
        spec = self.quotas.get(name)
        if spec is None:
            raise QuotaTopologyError(f"quota {name} not found")
        children = self._children(name)
        if children:
            raise QuotaTopologyError(
                f"quota {name} still has children: "
                f"{sorted(c.name for c in children)}"
            )
        del self.quotas[name]

    # -- checks --------------------------------------------------------------

    def _validate_self(self, spec: QuotaSpec) -> None:
        for field_name, mapping in (("min", spec.min), ("max", spec.max)):
            for key, value in mapping.items():
                if value < 0:
                    raise QuotaTopologyError(
                        f"quota {spec.name} {field_name}[{key.name}] < 0"
                    )
        if spec.shared_weight is not None:
            for key, value in spec.shared_weight.items():
                if value < 0:
                    raise QuotaTopologyError(
                        f"quota {spec.name} sharedWeight[{key.name}] < 0"
                    )
        for key, value in spec.min.items():
            if key not in spec.max or spec.max[key] < value:
                raise QuotaTopologyError(
                    f"quota {spec.name} min > max on {key.name}"
                )

    def _validate_topology(self, spec: QuotaSpec) -> None:
        parent = spec.parent or ROOT
        # a non-parent child of root passes the remaining checks trivially
        # (quota_topology_check.go:86-89)
        if parent == ROOT and not spec.is_parent:
            return
        if parent != ROOT:
            parent_spec = self.quotas.get(parent)
            if parent_spec is None:
                raise QuotaTopologyError(
                    f"quota {spec.name} parent {parent} not found"
                )
            if not parent_spec.is_parent:
                raise QuotaTopologyError(
                    f"quota {spec.name} parent {parent} is not a parent group"
                )
            if parent_spec.tree_id != spec.tree_id:
                raise QuotaTopologyError(
                    f"quota {spec.name} tree id {spec.tree_id!r} differs "
                    f"from parent's {parent_spec.tree_id!r}"
                )
            if set(spec.max) != set(parent_spec.max):
                raise QuotaTopologyError(
                    f"quota {spec.name} max keys differ from parent "
                    f"{parent}'s max keys"
                )
            self._check_min_sum(spec, parent_spec)
        children = [c for c in self._children(spec.name) if c.name != spec.name]
        for child in children:
            # checkSubAndParentGroupMaxQuotaKeySame also walks children
            if set(child.max) != set(spec.max):
                raise QuotaTopologyError(
                    f"quota {spec.name} max keys differ from child "
                    f"{child.name}'s max keys"
                )
        # children's min must fit the (possibly shrunken) own min on EVERY
        # dimension any child declares (LessThanOrEqualCompletely)
        child_keys = {key for c in children for key in c.min}
        for key in child_keys:
            child_sum = sum(c.min.get(key, 0) for c in children)
            if child_sum > spec.min.get(key, 0):
                raise QuotaTopologyError(
                    f"quota {spec.name} children's min exceeds its own min "
                    f"on {key.name}"
                )

    def _check_min_sum(self, spec, parent_spec) -> None:
        siblings = [
            c for c in self._children(parent_spec.name) if c.name != spec.name
        ]
        for key, value in spec.min.items():
            total = value + sum(c.min.get(key, 0) for c in siblings)
            if total > parent_spec.min.get(key, 0):
                raise QuotaTopologyError(
                    f"all brothers' min > parent {parent_spec.name} min on "
                    f"{key.name}"
                )
