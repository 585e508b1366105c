"""Ring-buffer audit log of every node-level QoS action.

Reference: pkg/koordlet/audit/{auditor.go,event_logger.go} — every cgroup
write / eviction / suppress action is recorded with subject + operation +
detail, bounded in memory, queryable (the reference also tails to disk
and serves HTTP; here the query API is a method).

Counterpart of ``koordinator_tpu/koordlet/audit/auditor.py``: host work
in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Deque, Iterator, List, Optional


@dataclasses.dataclass(frozen=True)
class AuditEvent:
    timestamp: float
    #: what acted: "qosmanager/cpusuppress", "resourceexecutor", ...
    group: str
    #: object acted on: a cgroup dir, a pod uid, a node resource
    subject: str
    #: verb: "update", "evict", "suppress", ...
    operation: str
    detail: str = ""


class Auditor:
    """Bounded in-memory event log (reference: auditor.go LogEvent +
    ring buffer)."""

    def __init__(self, capacity: int = 2048, clock=time.time):
        self._events: Deque[AuditEvent] = collections.deque(maxlen=capacity)
        self._clock = clock

    def log(self, group: str, subject: str, operation: str,
            detail: str = "") -> None:
        self._events.append(
            AuditEvent(self._clock(), group, subject, operation, detail)
        )

    def query(
        self,
        group: Optional[str] = None,
        subject: Optional[str] = None,
        operation: Optional[str] = None,
        since: Optional[float] = None,
        limit: Optional[int] = None,
    ) -> List[AuditEvent]:
        """Newest-first filtered view (reference: the HTTP query endpoint
        pkg/koordlet/audit/logger.go)."""

        def match(e: AuditEvent) -> bool:
            return (
                (group is None or e.group == group)
                and (subject is None or e.subject == subject)
                and (operation is None or e.operation == operation)
                and (since is None or e.timestamp >= since)
            )

        it: Iterator[AuditEvent] = filter(match, reversed(self._events))
        if limit is not None:
            it = itertools.islice(it, limit)
        return list(it)

    def __len__(self) -> int:
        return len(self._events)
