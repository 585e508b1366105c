"""Coscheduling for the plugin chain (counterpart of
``koordinator_tpu/scheduler/plugins/coscheduling.py``): the gang state
machine of ``gang/manager.py`` at PreFilter, Permit, Unreserve and
PostFilter."""

from __future__ import annotations

from koordinator_tpu_torch.gang.manager import GangManager, PermitResult
from koordinator_tpu_torch.scheduler.framework import (
    CycleState,
    Plugin,
    Status,
)


class CoschedulingPlugin(Plugin):
    name = "Coscheduling"

    def __init__(self, manager: GangManager, on_release=None,
                 on_reject=None):
        self.manager = manager
        #: called with the waiting siblings a Permit ALLOW released: they
        #: are bindable now
        self.on_release = on_release
        #: called with the waiting siblings a Strict gang-group rejection
        #: released: their holds must be returned
        self.on_reject = on_reject

    def _rejected(self, uids) -> None:
        if uids and self.on_reject is not None:
            self.on_reject(list(uids))

    def score_weight(self) -> int:
        return 0

    def pre_filter(self, state: CycleState, snapshot, pod) -> Status:
        reason = self.manager.pre_filter(pod.uid)
        if reason is None:
            return Status.success()
        return Status.unschedulable_(reason)

    def permit(self, state: CycleState, snapshot, pod, node):
        result, wait = self.manager.permit(pod.uid)
        if result == PermitResult.ALLOW:
            released = self.manager.allow_gang_group(
                self.manager.pod_gang.get(pod.uid, ""))
            if self.on_release is not None:
                self.on_release([u for u in released if u != pod.uid])
            return ("allow", 0.0)
        if result == PermitResult.WAIT:
            return ("wait", wait)
        return ("allow", 0.0)

    def unreserve(self, state: CycleState, snapshot, pod, node) -> None:
        self._rejected(self.manager.unreserve(pod.uid))

    def post_filter(self, state: CycleState, snapshot, pod) -> None:
        # a member failed filtering: a Strict gang rejects its group
        # (core.go:318 rejectGangGroupById), and the released waiting
        # siblings go back to the scheduler to return their holds
        if self.manager.pod_gang.get(pod.uid) is not None:
            self._rejected(self.manager.unreserve(pod.uid))
