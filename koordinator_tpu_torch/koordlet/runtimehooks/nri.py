"""NRI-mode server: event-driven hook invocation from the PLEG stream.

Reference: pkg/koordlet/runtimehooks/nri/server.go — the NRI plugin
subscribes to the container runtime's lifecycle event stream (containerd
NRI v0.3 stub), runs the registered hooks per event, and applies the
resulting adjustments. The reference's three modes map here as:

- **proxy** → ``runtimeproxy.criserver`` (interpose runtime requests),
- **reconciler** → ``reconciler.Reconciler`` (periodic drift heal),
- **NRI** → THIS: *push* events. The runtime's event feed analogue in
  this framework is the PLEG cgroupfs stream (``pleg/pleg.py``); events
  are resolved to PodMeta through the statesinformer's pod provider and
  dispatched to :class:`RuntimeHookServer` stages with standalone
  application (``apply=True`` — the NRI adjustment is written through
  the executor, since there is no runtime request to merge into).

Like the reference stub it supports an event subscription list
(``nriConfig.Events``), a plugin failure policy, disabled stages
(``Options.DisableStages``), and a Synchronize pass on registration
(server.go Synchronize: re-run hooks over every already-running pod so
a restarted koordlet converges immediately instead of waiting for the
next lifecycle event).

Counterpart of ``koordinator_tpu/koordlet/runtimehooks/nri.py``: host
work in files, bit for bit the reference's.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Set, Tuple

from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta
from koordinator_tpu_torch.koordlet.pleg.pleg import EventType, PodLifecycleEvent
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import Stage
from koordinator_tpu_torch.koordlet.runtimehooks.server import RuntimeHookServer

#: reference event names (nriConfig.Events) keyed by PLEG event type
EVENT_NAMES = {
    EventType.POD_ADDED: "RunPodSandbox",
    EventType.POD_DELETED: "StopPodSandbox",
    EventType.CONTAINER_ADDED: "CreateContainer",
    EventType.CONTAINER_DELETED: "StopContainer",
}
ALL_EVENTS = frozenset(EVENT_NAMES.values())


class NriServer:
    """Dispatches PLEG lifecycle events to hook stages.

    ``pod_provider`` is any object with ``pods() -> Sequence[PodMeta]``
    (the statesinformer); events whose cgroup dir resolves to no known
    pod are dropped — the reconciler mode heals any gap on its next
    pass, matching the reference's layered NRI+reconciler deployment.
    """

    def __init__(
        self,
        server: RuntimeHookServer,
        pod_provider,
        events: Optional[Iterable[str]] = None,
        disable_stages: Optional[Set[str]] = None,
    ):
        self.server = server
        # statesinformer exposes running_pods(); any pods() sequence
        # source (tests, custom informers) works too
        self._pods_fn = getattr(pod_provider, "running_pods", None) or getattr(
            pod_provider, "pods"
        )
        # cgroup-dir index, rebuilt only when the pod set changes — a
        # PLEG burst after downtime must not do O(pods) work per event.
        # With an informer we invalidate on its PODS callback; without
        # one (plain pods() source) every event rebuilds. The previous
        # index is retained so DELETE events still resolve after the
        # informer drops the pod (the reference NRI event carries pod
        # info in-band; PLEG only carries the cgroup dir).
        self._index: Optional[Dict[str, Tuple[PodMeta, Optional[str]]]] = None
        self._prev: Dict[str, Tuple[PodMeta, Optional[str]]] = {}
        self._index_tracked = False
        register = getattr(pod_provider, "register_callback", None)
        if register is not None:
            from koordinator_tpu_torch.koordlet.statesinformer import StateKind

            register(StateKind.PODS, lambda _kind, _pods: self._invalidate())
            self._index_tracked = True
            # eager build: the retained-previous-index guarantee for
            # stop events needs a snapshot from BEFORE the pod drops
            self._index = self._build_index()
        self.events = frozenset(events) if events is not None else ALL_EVENTS
        unknown = self.events - ALL_EVENTS
        if unknown:
            raise ValueError(f"unknown NRI events: {sorted(unknown)}; "
                             f"valid: {sorted(ALL_EVENTS)}")
        self.disable_stages = set(disable_stages or ())
        valid_stages = {s.value for s in Stage}
        unknown = self.disable_stages - valid_stages
        if unknown:
            raise ValueError(f"unknown stages: {sorted(unknown)}; "
                             f"valid: {sorted(valid_stages)}")
        #: counters per event name (observability parity with the
        #: reference's klog'd handlers)
        self.handled: Dict[str, int] = {}
        self.dropped = 0

    # -- wiring --------------------------------------------------------------

    def attach(self, pleg) -> "NriServer":
        """Subscribe to a PLEG instance and run the Synchronize pass."""
        pleg.register(self.handle_event)
        self.synchronize()
        return self

    def synchronize(self) -> int:
        """Re-apply hook outputs over every running pod (the NRI stub's
        Synchronize callback); returns how many contexts ran."""
        ran = 0
        for pod in self._pods_fn():
            if "RunPodSandbox" in self.events and not self._disabled(
                "PreRunPodSandbox"
            ):
                self.server.run_pod_sandbox(pod, apply=True)
                ran += 1
            if "CreateContainer" in self.events and not self._disabled(
                "PreCreateContainer"
            ):
                for name in pod.containers:
                    self.server.create_container(pod, name, apply=True)
                    ran += 1
        return ran

    # -- event dispatch ------------------------------------------------------

    def _disabled(self, stage_name: str) -> bool:
        return stage_name in self.disable_stages

    def _invalidate(self) -> None:
        if self._index is not None:
            self._prev = self._index
        self._index = self._build_index()

    def _build_index(self) -> Dict[str, Tuple[PodMeta, Optional[str]]]:
        index: Dict[str, Tuple[PodMeta, Optional[str]]] = {}
        for pod in self._pods_fn():
            index[pod.cgroup_dir] = (pod, None)
            for name, cdir in pod.containers.items():
                index[cdir] = (pod, name)
        return index

    def _resolve(self, cgroup_dir: str, include_retired: bool = False
                 ) -> Tuple[Optional[PodMeta], Optional[str]]:
        """(pod, container_name) for a PLEG cgroup dir; container_name
        is None for pod-level dirs. ``include_retired`` also consults
        the previous index so stop events resolve after the informer
        already dropped the pod."""
        if self._index is None or not self._index_tracked:
            if self._index is not None:
                self._prev = self._index
            self._index = self._build_index()
        hit = self._index.get(cgroup_dir)
        if hit is None and include_retired:
            hit = self._prev.get(cgroup_dir)
        return hit if hit is not None else (None, None)

    def handle_event(self, event: PodLifecycleEvent) -> bool:
        """PLEG handler: returns True if a hook stage ran."""
        name = EVENT_NAMES[event.event]
        if name not in self.events:
            return False
        is_stop = event.event in (
            EventType.POD_DELETED, EventType.CONTAINER_DELETED
        )
        pod, container = self._resolve(event.cgroup_dir,
                                       include_retired=is_stop)
        if pod is None:
            self.dropped += 1
            return False
        if event.event is EventType.POD_ADDED:
            if self._disabled("PreRunPodSandbox"):
                return False
            self.server.run_pod_sandbox(pod, apply=True)
        elif event.event is EventType.POD_DELETED:
            if self._disabled("PostStopPodSandbox"):
                return False
            self.server.stop_pod_sandbox(pod, apply=True)
        elif event.event is EventType.CONTAINER_ADDED:
            if container is None or self._disabled("PreCreateContainer"):
                return False
            self.server.create_container(pod, container, apply=True)
        else:  # CONTAINER_DELETED
            if container is None or self._disabled("PostStopContainer"):
                return False
            self.server.stop_container(pod, container, apply=True)
        self.handled[name] = self.handled.get(name, 0) + 1
        return True
