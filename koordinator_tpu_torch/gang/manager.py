"""Host gang state machine (counterpart of
``koordinator_tpu/gang/manager.py``).

A rebuild of Koordinator's PodGroupManager and Gang/GangGroupInfo
(pkg/scheduler/plugins/coscheduling/core/{core,gang,ganggroup}.go). The
batched solver resolves gangs at batch end (ops/gang.py); the scheduler's
batched round keeps this manager's waiting and bound sets in step
(``on_pod_waiting``, ``on_pod_bound``, ``unreserve`` at WaitTime expiry).
The pod-at-a-time half (PreFilter gating with schedule-cycle validity,
the Permit barrier over gang groups) is here whole, for the incremental
path of a later slice.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Set, Tuple

from koordinator_tpu_torch.apis.types import GangMode, GangSpec


class GangMatchPolicy(enum.Enum):
    """Which members count toward the Permit barrier (gang.go:496-510)."""

    ONCE_SATISFIED = "once-satisfied"      # default: sticky after first success
    ONLY_WAITING = "only-waiting"
    WAITING_AND_RUNNING = "waiting-and-running"


class PermitResult(enum.Enum):
    ALLOW = "allow"
    WAIT = "wait"
    NOT_GANG = "not-gang"


@dataclasses.dataclass
class _GroupInfo:
    """Shared per-gang-group scheduling-cycle state (ganggroup.go)."""

    gangs: Set[str]
    schedule_cycle: int = 1
    cycle_valid: bool = True
    child_cycle: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _GangRecord:
    spec: GangSpec
    policy: GangMatchPolicy
    children: Set[str] = dataclasses.field(default_factory=set)
    waiting: Set[str] = dataclasses.field(default_factory=set)   # assumed
    bound: Set[str] = dataclasses.field(default_factory=set)
    once_satisfied: bool = False

    def valid_for_permit(self) -> bool:
        if self.policy == GangMatchPolicy.ONLY_WAITING:
            return len(self.waiting) >= self.spec.min_member
        if self.policy == GangMatchPolicy.WAITING_AND_RUNNING:
            return len(self.waiting) + len(self.bound) >= self.spec.min_member
        return (
            self.once_satisfied
            or len(self.waiting) + len(self.bound) >= self.spec.min_member
        )


class GangManager:
    """Registry + state machine over all gangs."""

    def __init__(self) -> None:
        self.gangs: Dict[str, _GangRecord] = {}
        self.groups: Dict[str, _GroupInfo] = {}
        self.gang_group_key: Dict[str, str] = {}  # gang name -> groups key
        self.pod_gang: Dict[str, str] = {}

    # -- registry -----------------------------------------------------------

    def update_gang(
        self, spec: GangSpec, policy: GangMatchPolicy = GangMatchPolicy.ONCE_SATISFIED
    ) -> None:
        existing = self.gangs.get(spec.name)
        record = _GangRecord(spec=spec, policy=policy)
        if existing is not None:
            record.children = existing.children
            record.waiting = existing.waiting
            record.bound = existing.bound
            record.once_satisfied = existing.once_satisfied
        self.gangs[spec.name] = record
        group_names = tuple(sorted(spec.gang_group)) or (spec.name,)
        key = "/".join(group_names)
        old_key = self.gang_group_key.get(spec.name)
        if old_key is not None and old_key != key:
            # gang moved to a different group: drop it from the stale one
            old_group = self.groups.get(old_key)
            if old_group is not None:
                old_group.gangs.discard(spec.name)
                if not old_group.gangs:
                    del self.groups[old_key]
        group = self.groups.setdefault(key, _GroupInfo(gangs=set(group_names)))
        group.gangs.update(group_names)
        for name in group_names:
            self.gang_group_key[name] = key

    def _group_of(self, gang_name: str) -> Optional[_GroupInfo]:
        key = self.gang_group_key.get(gang_name)
        return self.groups.get(key) if key is not None else None

    def on_pod_add(self, pod_uid: str, gang_name: str) -> None:
        record = self.gangs.get(gang_name)
        if record is not None:
            record.children.add(pod_uid)
            self.pod_gang[pod_uid] = gang_name

    def on_pod_delete(self, pod_uid: str) -> None:
        gang_name = self.pod_gang.pop(pod_uid, None)
        if gang_name is None:
            return
        record = self.gangs.get(gang_name)
        if record is not None:
            record.children.discard(pod_uid)
            record.waiting.discard(pod_uid)
            record.bound.discard(pod_uid)
        # drop the pod's schedule-cycle attempt record, otherwise stale
        # entries wedge (or prematurely reopen) the group's cycle
        group = self._group_of(gang_name)
        if group is not None:
            group.child_cycle.pop(pod_uid, None)

    # -- PreFilter (core.go:232-291) ---------------------------------------

    def pre_filter(self, pod_uid: str) -> Optional[str]:
        """None = pass; a string is the rejection reason."""
        gang_name = self.pod_gang.get(pod_uid)
        if gang_name is None:
            return None
        record = self.gangs.get(gang_name)
        if record is None:
            return f"gang {gang_name} not found"
        if record.policy == GangMatchPolicy.ONCE_SATISFIED and record.once_satisfied:
            return None
        if len(record.children) < record.spec.min_member:
            return (
                f"gang {gang_name} has not collected enough children: "
                f"{len(record.children)} < {record.spec.min_member}"
            )
        group = self._group_of(gang_name)
        if group is None:
            return None
        self._try_set_cycle_valid(group)
        gang_cycle = group.schedule_cycle
        try:
            if record.spec.mode == GangMode.STRICT:
                if not group.cycle_valid:
                    return f"gang {gang_name} schedule cycle invalid"
                if group.child_cycle.get(pod_uid, 0) >= gang_cycle:
                    return (
                        f"pod {pod_uid} schedule cycle too large "
                        f"({group.child_cycle.get(pod_uid, 0)} >= {gang_cycle})"
                    )
            return None
        finally:
            # mirrors the deferred setChildScheduleCycle (core.go:274)
            group.child_cycle[pod_uid] = gang_cycle

    def _try_set_cycle_valid(self, group: _GroupInfo) -> None:
        """ganggroup.go:101-124: once every child of the group has attempted
        the current cycle, open the next one."""
        total = sum(
            len(self.gangs[g].children) for g in group.gangs if g in self.gangs
        )
        attempted = sum(
            1 for c in group.child_cycle.values() if c == group.schedule_cycle
        )
        if attempted == total and total > 0:
            group.schedule_cycle += 1
            group.cycle_valid = True

    # -- Permit (core.go:358-385) ------------------------------------------

    def permit(self, pod_uid: str) -> Tuple[PermitResult, float]:
        gang_name = self.pod_gang.get(pod_uid)
        if gang_name is None:
            return PermitResult.NOT_GANG, 0.0
        record = self.gangs.get(gang_name)
        if record is None:
            return PermitResult.NOT_GANG, 0.0
        record.waiting.add(pod_uid)
        group = self._group_of(gang_name)
        members = group.gangs if group is not None else {gang_name}
        for name in members:
            other = self.gangs.get(name)
            if other is None or not other.valid_for_permit():
                return PermitResult.WAIT, record.spec.wait_time
        return PermitResult.ALLOW, 0.0

    def allow_gang_group(self, gang_name: str) -> List[str]:
        """Permit barrier opened: all waiting pods of the group are released
        for binding; gangs become once-satisfied."""
        group = self._group_of(gang_name)
        members = group.gangs if group is not None else {gang_name}
        released: List[str] = []
        for name in members:
            record = self.gangs.get(name)
            if record is None:
                continue
            record.once_satisfied = True
            for uid in sorted(record.waiting):
                released.append(uid)
                record.bound.add(uid)
            record.waiting.clear()
        return released

    # -- failure handling ---------------------------------------------------

    def unreserve(self, pod_uid: str) -> List[str]:
        """A member failed after Reserve (or timed out at Permit): Strict
        gangs reject the whole group (core.go:390-430). Returns the uids
        whose assumed resources must be released."""
        gang_name = self.pod_gang.get(pod_uid)
        if gang_name is None:
            return []
        record = self.gangs.get(gang_name)
        if record is None:
            return []
        record.waiting.discard(pod_uid)
        if (
            record.policy == GangMatchPolicy.ONCE_SATISFIED
            and record.once_satisfied
        ) or record.spec.mode != GangMode.STRICT:
            return []
        return self.reject_gang_group(gang_name)

    def reject_gang_group(self, gang_name: str) -> List[str]:
        """Reject every waiting pod of the group and invalidate its cycle."""
        group = self._group_of(gang_name)
        members = group.gangs if group is not None else {gang_name}
        rejected: List[str] = []
        for name in members:
            record = self.gangs.get(name)
            if record is None:
                continue
            rejected.extend(sorted(record.waiting))
            record.waiting.clear()
        if group is not None:
            group.cycle_valid = False
        return rejected

    def on_pod_waiting(self, pod_uid: str) -> None:
        """A batched-path pod entered the Permit barrier (the incremental
        path records this inside :meth:`permit`)."""
        gang_name = self.pod_gang.get(pod_uid)
        record = self.gangs.get(gang_name) if gang_name else None
        if record is not None:
            record.waiting.add(pod_uid)

    def on_pod_forgotten(self, pod_uid: str) -> None:
        """An assumed pod was forgotten before its bind published (a
        deposed leader's aborted round, an auditor repair): drop it from
        waiting/bound without deregistering it from the gang — the pod
        itself returns to pending and will re-attempt. ``once_satisfied``
        deliberately stays sticky (the reference's semantics)."""
        gang_name = self.pod_gang.get(pod_uid)
        record = self.gangs.get(gang_name) if gang_name else None
        if record is not None:
            record.waiting.discard(pod_uid)
            record.bound.discard(pod_uid)

    def on_pod_bound(self, pod_uid: str) -> None:
        gang_name = self.pod_gang.get(pod_uid)
        record = self.gangs.get(gang_name) if gang_name else None
        if record is None:
            return
        record.waiting.discard(pod_uid)
        record.bound.add(pod_uid)
        if len(record.bound) >= record.spec.min_member:
            record.once_satisfied = True
