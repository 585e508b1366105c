"""Pod lifecycle event generator: watches the cgroupfs tree.

Reference: pkg/koordlet/pleg/{pleg.go,watcher.go} — inotify on the
kubepods cgroup directories emits pod/container create/delete events as
the fallback where NRI isn't available. Here the watcher is a poll-diff
over the directory tree (works on any filesystem, no inotify binding),
with the same event surface.

Counterpart of ``koordinator_tpu/koordlet/pleg/pleg.py``: host work in
files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Callable, Dict, List, Optional, Set

from koordinator_tpu_torch.koordlet.system.cgroup import SystemConfig


class EventType(enum.Enum):
    POD_ADDED = "pod_added"
    POD_DELETED = "pod_deleted"
    CONTAINER_ADDED = "container_added"
    CONTAINER_DELETED = "container_deleted"


@dataclasses.dataclass(frozen=True)
class PodLifecycleEvent:
    event: EventType
    cgroup_dir: str  # pod or container cgroup dir relative to root


Handler = Callable[[PodLifecycleEvent], None]


class PLEG:
    """Poll-diff lifecycle watcher over kubepods cgroup dirs."""

    def __init__(self, config: SystemConfig,
                 kubepods_dir: Optional[str] = None):
        self.config = config
        self.kubepods_dir = kubepods_dir or config.kubepods_dir
        self._handlers: List[Handler] = []
        self._known_pods: Set[str] = set()
        self._known_containers: Set[str] = set()
        self._primed = False

    def register(self, handler: Handler) -> None:
        self._handlers.append(handler)

    def _root(self) -> str:
        if self.config.use_cgroup_v2:
            return os.path.join(self.config.cgroup_root, self.kubepods_dir)
        return os.path.join(
            self.config.cgroup_root, "cpu", self.kubepods_dir
        )

    def _scan(self) -> tuple:
        """(pods, containers) as cgroup dirs relative to the cgroup root.

        Layout: kubepods[/<qos tier>]/<pod>/<container>; QoS tier dirs
        (besteffort/burstable) hold pods, pod dirs hold containers.
        """
        pods: Set[str] = set()
        containers: Set[str] = set()
        root = self._root()
        tiers = [""]
        try:
            for entry in sorted(os.listdir(root)):
                if not os.path.isdir(os.path.join(root, entry)):
                    continue
                if entry in ("besteffort", "burstable", "guaranteed"):
                    tiers.append(entry)
                else:
                    pods.add(os.path.join(self.kubepods_dir, entry))
        except OSError:
            return pods, containers
        for tier in tiers[1:]:
            try:
                for entry in sorted(os.listdir(os.path.join(root, tier))):
                    full = os.path.join(root, tier, entry)
                    if os.path.isdir(full):
                        pods.add(os.path.join(self.kubepods_dir, tier, entry))
            except OSError:
                continue
        base = os.path.dirname(root)  # the dir containing kubepods/
        for pod in pods:
            pod_abs = os.path.join(base, pod)
            try:
                for entry in sorted(os.listdir(pod_abs)):
                    if os.path.isdir(os.path.join(pod_abs, entry)):
                        containers.add(os.path.join(pod, entry))
            except OSError:
                continue
        return pods, containers

    def poll(self) -> List[PodLifecycleEvent]:
        """Diff against the last scan; fire handlers; return events. The
        first poll primes without events (reference: the watcher only
        reports changes after the initial walk)."""
        pods, containers = self._scan()
        events: List[PodLifecycleEvent] = []
        if self._primed:
            for p in sorted(pods - self._known_pods):
                events.append(PodLifecycleEvent(EventType.POD_ADDED, p))
            for p in sorted(self._known_pods - pods):
                events.append(PodLifecycleEvent(EventType.POD_DELETED, p))
            for c in sorted(containers - self._known_containers):
                events.append(
                    PodLifecycleEvent(EventType.CONTAINER_ADDED, c)
                )
            for c in sorted(self._known_containers - containers):
                events.append(
                    PodLifecycleEvent(EventType.CONTAINER_DELETED, c)
                )
        self._known_pods = pods
        self._known_containers = containers
        self._primed = True
        for e in events:
            for h in self._handlers:
                h(e)
        return events
