"""Descheduler plugin framework + evictors (a copy of
``koordinator_tpu/descheduler/framework.py``).

Semantics oracle: pkg/descheduler/framework/types.go (DeschedulePlugin /
BalancePlugin / Evictor), framework/runtime/framework.go (profile
execution order: all Deschedule plugins, then all Balance plugins),
pkg/descheduler/evictions/ (policy-group limits: per cycle / namespace /
node), descheduler.go (interval loop).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    MigrationPhase,
    PodMigrationJob,
    PodSpec,
)


class DeschedulePlugin:
    """Point-fix plugins: look at individual policy violations."""

    name = "DeschedulePlugin"

    def deschedule(self, snapshot: ClusterSnapshot, evictor: "Evictor") -> None:
        raise NotImplementedError


class BalancePlugin:
    """Distribution plugins: rebalance load across the pool."""

    name = "BalancePlugin"

    def balance(self, snapshot: ClusterSnapshot, evictor: "Evictor") -> None:
        raise NotImplementedError


@dataclasses.dataclass
class EvictionLimiter:
    """Eviction budget (reference: evictions/evictions.go policy groups +
    arbitrator group limits). None = unlimited."""

    max_per_cycle: Optional[int] = None
    max_per_node: Optional[int] = None
    max_per_namespace: Optional[int] = None

    def __post_init__(self):
        self._cycle = 0
        self._per_node: Dict[str, int] = {}
        self._per_namespace: Dict[str, int] = {}

    def reset_cycle(self) -> None:
        self._cycle = 0
        self._per_node.clear()
        self._per_namespace.clear()

    def allow(self, pod: PodSpec) -> bool:
        if self.max_per_cycle is not None and self._cycle >= self.max_per_cycle:
            return False
        node = pod.node_name or ""
        if (
            self.max_per_node is not None
            and self._per_node.get(node, 0) >= self.max_per_node
        ):
            return False
        if (
            self.max_per_namespace is not None
            and self._per_namespace.get(pod.namespace, 0) >= self.max_per_namespace
        ):
            return False
        return True

    def note(self, node: str, namespace: str) -> None:
        self._cycle += 1
        self._per_node[node] = self._per_node.get(node, 0) + 1
        self._per_namespace[namespace] = self._per_namespace.get(namespace, 0) + 1


class Evictor:
    """Evictor protocol (reference: framework/types.go Evictor).

    ``arbiter`` optionally routes every eviction through the migration
    arbiter (control/migration.py, docs/DESIGN.md §27) under the given
    source label — a standalone descheduler run then obeys the same
    disruption budgets as the scheduler-integrated sweep. A deferral
    surfaces as the protocol's existing refusal (``evict`` returns
    False); the typed reason lands in the arbiter's ring + metrics."""

    def __init__(self, limiter: Optional[EvictionLimiter] = None,
                 arbiter=None, arbiter_source: str = "rebalance"):
        self.limiter = limiter or EvictionLimiter()
        self.evicted: List[PodSpec] = []
        self.arbiter = arbiter
        self.arbiter_source = arbiter_source

    def filter(self, pod: PodSpec) -> bool:
        """Whether this pod may be evicted at all."""
        return True

    def evict(self, snapshot: ClusterSnapshot, pod: PodSpec, reason: str = "") -> bool:
        if not self.limiter.allow(pod):
            return False
        if self.arbiter is not None:
            from koordinator_tpu_torch.obs.timeline import lane_of

            verdict = self.arbiter.request(
                self.arbiter_source, pod.node_name, [pod.uid],
                lanes=[lane_of(pod)], gangs=[pod.gang],
            )
            if not verdict.apply or not verdict.admitted:
                return False
        # capture the accounting keys before _do_evict mutates the pod
        node, namespace = pod.node_name or "", pod.namespace
        if not self._do_evict(snapshot, pod, reason):
            return False
        self.limiter.note(node, namespace)
        self.evicted.append(pod)
        from koordinator_tpu_torch.metrics.components import PODS_EVICTED

        PODS_EVICTED.inc({"strategy": reason or "unknown", "node": node})
        return True

    def _do_evict(self, snapshot, pod, reason) -> bool:
        raise NotImplementedError


class DirectEvictor(Evictor):
    """Immediate eviction: remove the pod from its node in the snapshot
    (reference: evictions.go direct API eviction path)."""

    def _do_evict(self, snapshot, pod, reason) -> bool:
        # identity-based removal: dataclass == would deep-compare every
        # field against the whole pod list
        snapshot.pods[:] = [p for p in snapshot.pods if p is not pod]
        pod.node_name = None
        pod.annotations["descheduler.evicted-reason"] = reason
        return True


class MigrationEvictor(Evictor):
    """Reservation-first eviction: emit a PodMigrationJob instead of
    evicting inline (reference: evictor/migration controller handoff,
    pkg/descheduler/controllers/migration/evictor/)."""

    def __init__(self, limiter: Optional[EvictionLimiter] = None):
        super().__init__(limiter)
        self.jobs: List[PodMigrationJob] = []
        self._seq = 0

    def _do_evict(self, snapshot, pod, reason) -> bool:
        # one active job per pod (reference: migration controller dedup)
        for job in self.jobs:
            if job.pod_uid == pod.uid and job.phase in (
                MigrationPhase.PENDING,
                MigrationPhase.RUNNING,
            ):
                return False
        self._seq += 1
        self.jobs.append(
            PodMigrationJob(
                name=f"migrate-{self._seq}-{pod.name}",
                pod_uid=pod.uid,
                reason=reason,
                create_time=snapshot.now,
            )
        )
        return True


@dataclasses.dataclass
class Profile:
    """One descheduling profile (reference: apis/config DeschedulerProfile)."""

    name: str
    deschedule_plugins: Sequence[DeschedulePlugin] = ()
    balance_plugins: Sequence[BalancePlugin] = ()


class Descheduler:
    """Runs profiles every interval (reference: descheduler.go:46)."""

    def __init__(
        self,
        profiles: Sequence[Profile],
        evictor: Evictor,
        descheduling_interval: float = 120.0,
    ):
        self.profiles = list(profiles)
        self.evictor = evictor
        self.descheduling_interval = descheduling_interval
        self.last_run = 0.0

    def run_once(self, snapshot: ClusterSnapshot) -> List[PodSpec]:
        """One descheduling cycle: every profile's Deschedule plugins,
        then its Balance plugins (reference: framework/runtime/
        framework.go RunDeschedulePlugins/RunBalancePlugins order)."""
        from koordinator_tpu_torch.metrics.components import DESCHEDULE_LOOP_DURATION

        started = time.monotonic()
        self.evictor.limiter.reset_cycle()
        before = len(self.evictor.evicted)
        for profile in self.profiles:
            for plugin in profile.deschedule_plugins:
                plugin.deschedule(snapshot, self.evictor)
            for plugin in profile.balance_plugins:
                plugin.balance(snapshot, self.evictor)
        DESCHEDULE_LOOP_DURATION.observe(time.monotonic() - started)
        return self.evictor.evicted[before:]

    def maybe_run(self, snapshot: ClusterSnapshot, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        if now - self.last_run < self.descheduling_interval:
            return []
        self.last_run = now
        return self.run_once(snapshot)
