"""Typed object store + watch fan-out, the apiserver stand-in
(a copy of ``koordinator_tpu/client/bus.py``).

The reference's generated clientset/informer/lister stack (pkg/client,
6.5k LoC of codegen) reduces, for an in-process control plane, to: a
store keyed (kind, name), ``apply``/``delete`` mutations, ``get``/
``list`` reads, and ``watch`` subscriptions that replay existing objects
then receive every subsequent event — informer semantics without the
HTTP/CRD machinery.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Dict, List, Optional


class Kind(str, enum.Enum):
    """Object kinds on the bus (the CRD groups of SURVEY.md §2.6)."""

    NODE = "Node"
    POD = "Pod"
    NODE_METRIC = "NodeMetric"
    NODE_SLO = "NodeSLO"
    QUOTA = "ElasticQuota"
    QUOTA_PROFILE = "ElasticQuotaProfile"
    GANG = "PodGroup"
    RESERVATION = "Reservation"
    DEVICE = "Device"
    NODE_RESOURCE_TOPOLOGY = "NodeResourceTopology"
    MIGRATION_JOB = "PodMigrationJob"
    LEASE = "Lease"
    RECOMMENDATION = "Recommendation"
    PVC = "PersistentVolumeClaim"


class EventType(str, enum.Enum):
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


#: watch callback: (event type, name, object)
WatchFn = Callable[[EventType, str, object], None]


class APIServer:
    """The bus. Watch callbacks run synchronously on the mutating thread
    while the (reentrant) lock is held, so event order matches store
    order exactly — the deterministic equivalent of informer delivery.
    Callbacks may re-enter the bus from the same thread (the manager loop
    PATCHes nodes from inside a reconcile)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._objects: Dict[Kind, Dict[str, object]] = {k: {} for k in Kind}
        self._watchers: Dict[Kind, List[WatchFn]] = {k: [] for k in Kind}

    # -- mutations -----------------------------------------------------------

    def apply(self, kind: Kind, name: str, obj: object) -> None:
        with self._lock:
            existed = name in self._objects[kind]
            self._objects[kind][name] = obj
            event = EventType.MODIFIED if existed else EventType.ADDED
            for fn in list(self._watchers[kind]):
                fn(event, name, obj)

    def delete(self, kind: Kind, name: str) -> None:
        with self._lock:
            obj = self._objects[kind].pop(name, None)
            if obj is None:
                return
            for fn in list(self._watchers[kind]):
                fn(EventType.DELETED, name, obj)

    def transact(self, fn: Callable[[], object]) -> object:
        """Run ``fn`` atomically under the store lock (``fn`` may call
        get/apply/delete reentrantly) — the compare-and-swap primitive
        leader election builds its lease acquisition on."""
        with self._lock:
            return fn()

    # -- reads ---------------------------------------------------------------

    def get(self, kind: Kind, name: str) -> Optional[object]:
        with self._lock:
            return self._objects[kind].get(name)

    def list(self, kind: Kind) -> Dict[str, object]:
        with self._lock:
            return dict(self._objects[kind])

    # -- watch (informer semantics: replay, then live events) ----------------

    def watch(self, kind: Kind, fn: WatchFn) -> None:
        with self._lock:
            for name, obj in list(self._objects[kind].items()):
                fn(EventType.ADDED, name, obj)
            self._watchers[kind].append(fn)
