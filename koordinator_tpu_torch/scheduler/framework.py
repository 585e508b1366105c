"""The plugin protocol the fine-grained plugins are written against
(counterpart of ``koordinator_tpu/scheduler/framework.py``, cut to
``CycleState``, ``Status`` and the ``Plugin`` base).

The batched round drives the NodeNUMAResource, DeviceShare and NodePorts
plugins through ``models/finegrained.FineGrained``: PreFilter, Filter and
Score build a special pod's host rows, Reserve/Unreserve apply and roll
back its holds, PreBind writes its annotations. The rest of the framework
(the incremental cycle ``SchedulingFramework.schedule_one`` and the
transformer extension points) is a later slice of the port.
"""

from __future__ import annotations

from typing import Optional

MAX_NODE_SCORE = 100


class CycleState(dict):
    """Per-scheduling-cycle scratch space shared between plugins
    (reference: framework.CycleState)."""


class Status:
    """Plugin status: success (None reason) or failure with a reason."""

    def __init__(self, reason: Optional[str] = None,
                 unschedulable: bool = False):
        self.reason = reason
        self.unschedulable = unschedulable

    @property
    def ok(self) -> bool:
        return self.reason is None

    @classmethod
    def success(cls) -> "Status":
        return cls()

    @classmethod
    def unschedulable_(cls, reason: str) -> "Status":
        return cls(reason=reason, unschedulable=True)

    def __repr__(self) -> str:
        return f"Status(ok={self.ok}, reason={self.reason!r})"


class Plugin:
    """Base plugin: every extension point the batched round drives, a
    no-op success. In cycle order: pre_filter, filter (per node), score
    (0..100), reserve / unreserve, pre_bind."""

    name = "Plugin"

    def pre_filter(self, state: CycleState, snapshot, pod) -> Status:
        return Status.success()

    def filter(self, state: CycleState, snapshot, pod, node) -> Status:
        return Status.success()

    def score(self, state: CycleState, snapshot, pod, node) -> int:
        return 0

    def reserve(self, state: CycleState, snapshot, pod, node) -> Status:
        return Status.success()

    def unreserve(self, state: CycleState, snapshot, pod, node) -> None:
        pass

    def pre_bind(self, state: CycleState, snapshot, pod, node) -> Status:
        return Status.success()
