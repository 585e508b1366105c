"""The scheduler: the batched round and the per-pod plugin chain
(counterpart of ``koordinator_tpu/scheduler/scheduler.py``).

Informer-style intake keeps a :class:`SchedulerCache` (whose every
mutation marks the delta tracker), the quota trees, the gang manager and
the fine-grained state (the NUMA resource manager and the node device
cache) up to date; each round takes a snapshot, solves the whole pending
queue through the ``PlacementModel`` (on ``cuda`` by default), bound to
this scheduler's ``FineGrained`` manager, and assumes the committed
placements, and the waiting gang members' holds, into the cache. The
model's staging cache re-lowers only the node rows the round's events
touched.

One deliberate difference from the reference: ``update_pod`` of an
assigned pod swaps it in through the cache and marks its node (the
reference swaps the object without a mark, so its staged row keeps the
old requests), as ``remove_reservation`` and ``remove_node_metric`` mark
theirs.

After the placements, the round runs ElasticQuota's PostFilter for the
pods it could not place (``_preempt_unplaced``, at most
``MAX_PREEMPTIONS_PER_ROUND`` preemptors): victims are evicted now and the
preemptor is nominated to their node, binding in a later round. The
victim selection runs on ``preemption_backend``: ``"device"`` (the
default: ``ops/preempt.py`` on the model's device over the resident
world, re-lowering one node row per eviction), ``"host"`` (the scalar
oracle, ``scheduler/preemption.py``, with a full re-lower per eviction)
or ``"verify"`` (both, raising on any difference). ``defrag_headroom``
plans (and applies) the cheapest drain that restores a hole of a given
shape on the same backends. Evictions go to ``evict_pod_fn`` when set,
else to :meth:`Scheduler.remove_pod`.

With a ``migration_arbiter`` (``control/migration.MigrationArbiter``)
every eviction source passes through it first: preemption victim sets
(all or nothing), defrag drains and the LowNodeLoad sweep of
:meth:`Scheduler.rebalance_sweep`; deferred victims stay placed, and a
preemptor whose whole set is deferred gets no nomination. Each round
starts a new per-round budget. Without one, evictions are unthrottled.

Each round records into the port's trace (``obs/trace.TRACER``: the
round number, the ``round:<id>`` watchdog mark, and the ``begin_tick``,
``epilogue`` and ``round`` spans), stamps the pod timelines
(``self.timelines``: submit at intake, staged, solved; the bus wiring's
publish closes them into ``scheduler_pod_e2e_seconds``) and the
scheduler's series (attempts by result, pending pods, the solve's
duration, preemption attempts and victims, defrag drains, gang
rejections), as the reference does.

Each ``begin_tick`` first calls the device observatory's round hook
(``obs/device.DEVICE_OBS.on_round``: it drives an armed profiler window
over the next K rounds). ``self.monitor`` is the stuck-cycle watchdog
over the trace's open marks, ``self.debug`` the debug recorder and
``self.services`` the debug services registry (``pod-timelines``,
``monitor``, ``Coscheduling`` and ``ElasticQuota``, as the reference
registers them; the loops register theirs).

``self.framework`` is the plugin chain (``scheduler/framework.py``), built
as the reference builds it: Reservation, Coscheduling, ElasticQuota,
NodeNUMAResource, DeviceShare, NodePorts, NodeResourcesFit and
LoadAwareScheduling (both configured from the model) and DefaultPreBind,
its cycles seeded with the model's lowering kwargs and numpy copies of its
LoadAware thresholds. :meth:`Scheduler.schedule_one` runs one pending pod
through it (a preemption nomination evicts its victims; a Permit wait
holds the pod at the barrier); with ``batched_placement`` False (the
``BatchedPlacement`` gate off) every round is one such cycle per pending
pod in schedule order, and ``begin_tick`` hands ``commit_tick`` the
already-completed round (``PendingTick.result``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from koordinator_tpu_torch.apis.types import (
    GangSpec,
    NodeMetric,
    NodeSpec,
    PodSpec,
    QuotaSpec,
    ReservationSpec,
    ReservationState,
    resources_to_vector,
    vector_to_resources,
)
from koordinator_tpu_torch.descheduler.framework import Evictor
from koordinator_tpu_torch.device.cache import NodeDeviceCache
from koordinator_tpu_torch.gang.manager import GangManager
from koordinator_tpu_torch.metrics.components import (
    BATCH_SOLVE_DURATION,
    DEFRAG_DRAINS,
    GANG_REJECTIONS,
    PENDING_PODS,
    PREEMPT_VICTIMS,
    PREEMPTION_ATTEMPTS,
    SCHEDULING_ATTEMPTS,
)
from koordinator_tpu_torch.models.finegrained import FineGrained
from koordinator_tpu_torch.models.placement import (
    InFlightSchedule,
    PlacementModel,
    ScheduleResult,
)
from koordinator_tpu_torch.numa.manager import ResourceManager, TopologyOptions
from koordinator_tpu_torch.obs.device import DEVICE_OBS
from koordinator_tpu_torch.obs.timeline import PodTimelines, lane_of
from koordinator_tpu_torch.obs.trace import TRACER
from koordinator_tpu_torch.quota.trees import QuotaTreeRegistry
from koordinator_tpu_torch.scheduler.cache import SchedulerCache
from koordinator_tpu_torch.scheduler.framework import (
    CycleState,
    ScheduleOutcome,
    SchedulingFramework,
)
from koordinator_tpu_torch.scheduler.monitor import (
    DebugRecorder,
    DebugServices,
    SchedulerMonitor,
)
from koordinator_tpu_torch.scheduler.plugins import (
    CoschedulingPlugin,
    DefaultPreBind,
    DeviceSharePlugin,
    ElasticQuotaPlugin,
    LoadAwareScheduling,
    NodeNUMAResourcePlugin,
    NodeResourcesFit,
    ReservationPlugin,
)
from koordinator_tpu_torch.scheduler.plugins.lowering import (
    LOWERING_KEY,
    THRESHOLDS_KEY,
)
from koordinator_tpu_torch.scheduler.plugins.nodeports import NodePortsPlugin
from koordinator_tpu_torch.scheduler.preemption import (
    ARRAYS_STATE_KEY,
    can_preempt,
    plan_defrag,
)
from koordinator_tpu_torch.scheduler.reservation_controller import (
    ReservationController,
)
from koordinator_tpu_torch.state.cluster import (
    evict_resident_rows,
    lower_nodes,
    schedule_order,
)


class PendingTick:
    """One round between dispatch (:meth:`Scheduler.begin_tick`) and
    retirement (:meth:`Scheduler.commit_tick`, exactly once): an
    in-flight solve (``inflight``) or an already-completed per-pod round
    (``result``: with the ``BatchedPlacement`` gate off there is no
    device half to overlap). ``round_id`` is the trace's round number,
    ``trigger`` why the round fired (annotated onto its spans; None for a
    fixed cadence)."""

    __slots__ = ("at", "pending", "inflight", "solve_started", "result",
                 "round_id", "trigger")

    def __init__(self, at: float, pending: Optional[Dict[str, PodSpec]] = None,
                 inflight: Optional[InFlightSchedule] = None,
                 solve_started: Optional[float] = None,
                 round_id: int = 0, trigger: Optional[str] = None,
                 result: Optional[ScheduleResult] = None):
        self.at = at
        self.pending = pending or {}
        self.inflight = inflight
        self.solve_started = solve_started
        self.result = result
        self.round_id = round_id
        self.trigger = trigger


class Scheduler:
    """The scheduler, on both paths: ``schedule_pending()`` solves the
    whole queue in one batched solve and assumes the results into the
    cache; ``schedule_one(uid)`` runs one pod through the plugin chain
    (parity, debugging, one-off placements)."""

    #: at most this many preemptors per batched round
    MAX_PREEMPTIONS_PER_ROUND = 32

    def __init__(self, model: Optional[PlacementModel] = None,
                 cluster_total=None, enable_preemption: bool = True,
                 preemption_backend: str = "device"):
        if preemption_backend not in ("device", "host", "verify"):
            raise ValueError(
                f"unknown preemption_backend {preemption_backend!r}")
        #: the victim selection of ``_preempt_unplaced`` and
        #: ``defrag_headroom``: "device", "host" or "verify" (both)
        self.preemption_backend = preemption_backend
        #: the eviction sink: called with each victim (a bus deletion
        #: whose watch event re-enters ``remove_pod``); None removes the
        #: victim from this scheduler's cache directly
        self.evict_pod_fn = None
        #: the migration arbiter every eviction source passes through;
        #: None evicts unthrottled
        self.migration_arbiter = None
        #: monotone round key feeding the arbiter's per-round budget
        self._migration_round = 0
        self.cache = SchedulerCache()
        self.quota_registry = QuotaTreeRegistry(cluster_total=cluster_total
                                                or {})
        self.quota_manager = self.quota_registry.default
        self.gang_manager = GangManager()
        self.numa_manager = ResourceManager()
        self.device_cache = NodeDeviceCache()
        self.monitor = SchedulerMonitor(tracer=TRACER)
        self.debug = DebugRecorder()
        self.services = DebugServices()
        #: per-pod submit→staged→solved→published timelines feeding the
        #: scheduler_pod_e2e_seconds{lane} histograms
        self.timelines = PodTimelines()
        #: round id of the last commit_tick: this scheduler's round, not
        #: the process-global trace counter several schedulers share
        self.last_round_id: Optional[int] = None
        #: pods placed at the Permit barrier: uid -> held node. They hold
        #: resources (assumed) but are not bound until their gang group
        #: completes.
        self._waiting: Dict[str, str] = {}
        #: when each waiting pod entered the barrier (WaitTime expiry)
        self._waiting_since: Dict[str, float] = {}
        #: the BatchedPlacement gate: False runs every round as per-pod
        #: plugin-chain cycles (``_schedule_pending_incremental``)
        self.batched_placement = True
        #: waiting pods' reservation consumption (uid -> (reservation
        #: name, delta vector)), rolled back if the wait expires
        self._resv_waiting: Dict[str, tuple] = {}
        #: committed pods' consumption in the current round, rollback-able
        #: until the bind publishes; cleared at round start
        self._resv_inflight: Dict[str, tuple] = {}
        #: waiting pods' fine-grained holds, annotated when their barrier
        #: opens (uid -> (node name, CycleState))
        self._fine_waiting: Dict[str, tuple] = {}
        self.reservation_controller = ReservationController(self.cache)
        self._quota_plugin = ElasticQuotaPlugin(
            self.quota_registry, enable_preemption=enable_preemption)
        self._coscheduling = CoschedulingPlugin(
            self.gang_manager, on_release=self._on_gang_release,
            on_reject=self._on_gang_reject)
        self._numa_plugin = NodeNUMAResourcePlugin(self.numa_manager)
        self._device_plugin = DeviceSharePlugin(self.device_cache)
        self._ports_plugin = NodePortsPlugin()
        model = model if model is not None else PlacementModel()
        # the model binds to this scheduler's managers: a model reused
        # across schedulers would otherwise apply holds to the old one's
        model.fine = FineGrained(numa_plugin=self._numa_plugin,
                                 device_plugin=self._device_plugin,
                                 ports_plugin=self._ports_plugin)
        self.model = model
        self.framework = SchedulingFramework(
            plugins=[
                ReservationPlugin(),
                self._coscheduling,
                self._quota_plugin,
                self._numa_plugin,
                self._device_plugin,
                self._ports_plugin,
                NodeResourcesFit(weights=model.resource_weights,
                                 weight=model.config.fit_weight),
                # configured from the model: the chain and the batched
                # solver apply the same thresholds and modes
                LoadAwareScheduling(
                    resource_weights=model.resource_weights,
                    usage_thresholds=model.usage_thresholds,
                    prod_usage_thresholds=model.prod_usage_thresholds,
                    scaling_factors=model.scaling_factors,
                    score_according_prod=model.config.score_according_prod,
                    weight=model.config.loadaware_weight),
                DefaultPreBind(),
            ],
            debug=self.debug,
            # numpy copies of the model's (possibly device) thresholds,
            # made once here, not per cycle
            cycle_seed={
                LOWERING_KEY: model.lowering_kwargs(),
                THRESHOLDS_KEY: (model.params.thresholds.cpu().numpy(),
                                 model.params.prod_thresholds.cpu().numpy()),
            },
        )
        self.services.register("pod-timelines", self.timelines.status)
        self.services.register("monitor", self.monitor.status)
        self.services.register(
            "Coscheduling",
            lambda: {
                name: {
                    "min_member": rec.spec.min_member,
                    "waiting": sorted(rec.waiting),
                    "bound": sorted(rec.bound),
                    "once_satisfied": rec.once_satisfied,
                }
                for name, rec in self.gang_manager.gangs.items()
            },
        )
        self.services.register(
            "ElasticQuota",
            lambda: {
                name: {
                    "request": info.request.tolist(),
                    "used": info.used.tolist(),
                    "runtime": info.runtime.tolist(),
                }
                for name, info in self.quota_manager.quotas.items()
            },
        )

    # -- informer-style intake ----------------------------------------------

    def add_node(self, node: NodeSpec) -> None:
        self.cache.add_node(node)

    def remove_node(self, name: str) -> None:
        """Node deleted: drop it and its per-node state (metric, NUMA
        topology, devices)."""
        self.cache.remove_node(name)
        self.cache.node_metrics.pop(name, None)
        self.numa_manager.update_topology(name, TopologyOptions())
        self.device_cache.update_node(name, [])

    def remove_quota(self, name: str) -> None:
        self.cache.quotas.pop(name, None)
        # withdraws the quota's accounting from its ancestors first
        self.quota_registry.remove_quota(name)

    def remove_gang(self, name: str) -> None:
        self.cache.gangs.pop(name, None)
        gm = self.gang_manager
        record = gm.gangs.pop(name, None)
        key = gm.gang_group_key.pop(name, None)
        group = gm.groups.get(key) if key else None
        if record is not None:
            for uid in list(record.children):
                gm.pod_gang.pop(uid, None)
                if group is not None:
                    # a stale cycle attempt would wedge the group's cycle
                    group.child_cycle.pop(uid, None)
        if group is not None:
            group.gangs.discard(name)
            if not group.gangs:
                gm.groups.pop(key, None)

    def remove_reservation(self, name: str) -> None:
        resv = self.cache.reservations.pop(name, None)
        if resv is not None:
            # an Available reservation's hold leaves its node's row
            self.cache.delta_tracker.mark_node(resv.node_name)

    def remove_node_metric(self, name: str) -> None:
        if self.cache.node_metrics.pop(name, None) is not None:
            self.cache.delta_tracker.mark_node(name)

    def update_pod(self, pod: PodSpec) -> None:
        """Pod object changed. Quota and gang registration re-run only
        when an accounted field changed, so a status update never counts
        a request twice."""
        old = self.cache.pods.get(pod.uid) or self.cache.pending.get(pod.uid)
        if old is None:
            self.add_pod(pod)
            return
        if old is pod:
            # the same object, mutated in place by a bind elsewhere: the
            # binding must still be observed
            if (pod.node_name is not None and not pod.waiting_permit
                    and pod.uid in self.cache.pending):
                self._observe_binding(pod)
            return
        if (old.node_name is None and pod.node_name is not None
                and not pod.waiting_permit):
            # another scheduler's bind arrived as a fresh object
            self._observe_binding(pod)
            return
        accounted_changed = (
            old.quota != pod.quota
            or old.requests != pod.requests
            or old.gang != pod.gang
            or old.preemptible != pod.preemptible
        )
        assigned = old.node_name is not None
        if accounted_changed and not assigned:
            # the pod never left the queue: its timeline (the submit
            # stamp above all) survives the remove/add round trip
            with self.timelines.preserved(pod.uid):
                self.remove_pod(old)
                self.add_pod(pod)
            return
        # a refresh that keeps the placement
        pod.node_name = old.node_name
        pod.assign_time = old.assign_time
        if accounted_changed:
            # an assigned pod: swap its quota request and used in place
            self._quota_plugin.on_pod_delete(old)
            self._account_quota(old, release=True)
            if old.gang != pod.gang:
                self.gang_manager.on_pod_delete(pod.uid)
                if pod.gang:
                    self.gang_manager.on_pod_add(pod.uid, pod.gang)
                    self.gang_manager.on_pod_bound(pod.uid)
            self._quota_plugin.on_pod_add(pod)
            self._account_quota(pod)
        # under the cache's lock, marking an assigned pod's node: its
        # requests feed the lowered row (the reference swaps the object
        # without a mark)
        self.cache.replace_pod(pod)

    def update_node_metric(self, metric: NodeMetric) -> None:
        self.cache.update_node_metric(metric)

    def update_gang(self, spec: GangSpec) -> None:
        self.cache.update_gang(spec)
        self.gang_manager.update_gang(spec)

    def update_quota(self, spec: QuotaSpec) -> None:
        self.cache.update_quota(spec)
        self.quota_registry.update_quota(spec)

    def update_reservation(self, spec: ReservationSpec) -> None:
        self.cache.update_reservation(spec)

    def update_node_topology(self, node_name: str,
                             options: TopologyOptions) -> None:
        """NodeResourceTopology intake: the node's CPU topology, NUMA
        policy and per-NUMA-node resources."""
        self.numa_manager.update_topology(node_name, options)

    def update_node_devices(self, node_name: str, entries) -> None:
        """Device CRD intake: the node's device inventory."""
        self.device_cache.update_node(node_name, entries)

    def add_pod(self, pod: PodSpec) -> None:
        self.cache.add_pod(pod)
        bound = pod.node_name is not None and not pod.waiting_permit
        if not bound:
            # the pod entered the pending queue: its timeline opens
            self.timelines.submit(pod.uid, lane_of(pod))
        if pod.gang:
            self.gang_manager.on_pod_add(pod.uid, pod.gang)
            if bound:
                self.gang_manager.on_pod_bound(pod.uid)
        self._quota_plugin.on_pod_add(pod)
        if bound:
            # a bound pod entering the cache: its quota used was booked
            # by whoever bound it, so mirror it here
            self._account_quota(pod)

    def _observe_binding(self, pod: PodSpec) -> None:
        """A binding decided elsewhere became visible: pending ->
        assigned, with the quota used and gang bound it implies."""
        self.cache.promote_assigned(pod)
        # a bind this scheduler did not make is not its latency sample
        self.timelines.forget(pod.uid)
        self._account_quota(pod)
        if pod.gang:
            self.gang_manager.on_pod_bound(pod.uid)

    def _release_node_holds(self, pod: PodSpec) -> None:
        """Release a pod's fine-grained node holds (cpuset and NUMA
        resources, devices): one sequence for delete and forget."""
        if pod.node_name is None:
            return
        self.numa_manager.release(pod.node_name, pod.uid)
        node_device = self.device_cache.get(pod.node_name)
        if node_device is not None:
            node_device.release(pod.uid)

    def remove_pod(self, pod: PodSpec) -> None:
        cached = self.cache.pods.get(pod.uid)
        was_assigned = cached is not None and cached.node_name is not None
        if was_assigned:
            self._release_node_holds(cached)
        self.cache.remove_pod(pod.uid)
        self.gang_manager.on_pod_delete(pod.uid)
        self._quota_plugin.on_pod_delete(pod)
        self._fine_waiting.pop(pod.uid, None)
        # a deleted waiting pod never ran: undo its reservation use
        self._rollback_reservation(pod.uid)
        # a deleted committed pod ran: its credit is the reservation
        # controller's to reconcile
        self._resv_inflight.pop(pod.uid, None)
        if was_assigned and (not cached.waiting_permit
                             or pod.uid in self._waiting):
            # used was booked at assume time (or at bound intake); a pod
            # held at another scheduler's barrier was never booked here
            self._account_quota(cached, release=True)
        self._waiting.pop(pod.uid, None)
        self._waiting_since.pop(pod.uid, None)
        # a deleted or evicted pod's open timeline is not a latency sample
        self.timelines.forget(pod.uid)

    # -- scheduling ---------------------------------------------------------

    def schedule_pending(self, now: Optional[float] = None,
                         trigger: Optional[str] = None) -> ScheduleResult:
        """One batched round: :meth:`begin_tick` then :meth:`commit_tick`.
        ``trigger`` annotates why the round fired onto its spans."""
        return self.commit_tick(self.begin_tick(now, trigger=trigger))

    def begin_tick(self, now: Optional[float] = None,
                   trigger: Optional[str] = None) -> PendingTick:
        """Round start through dispatch: expire stale waits and
        reservations, take the snapshot, and hand the pending queue to the
        model without reading the result back. Opens the round's trace
        number and its ``round:<id>`` mark, which :meth:`commit_tick`
        closes (or this method, when the round fails here)."""
        at0 = now if now is not None else time.time()
        # the device observatory's round boundary: drives an armed
        # profiler window (one flag read when none is)
        DEVICE_OBS.on_round()
        rid = TRACER.begin_round()
        TRACER.mark_open(f"round:{rid}", round_id=rid)
        t_begin = TRACER.now()
        try:
            # the previous round's binds have published (or were
            # forgotten): their rollback window is over
            self._resv_inflight = {}
            if self.migration_arbiter is not None:
                self._migration_round += 1
                self.migration_arbiter.begin_round(self._migration_round)
            self.expire_waiting(at0)
            self.reservation_controller.sync(at0)
            if not self.batched_placement:
                return PendingTick(
                    at0, round_id=rid, trigger=trigger,
                    result=self._schedule_pending_incremental(now))
            snapshot = self.cache.snapshot(now=now)
            pending = {pod.uid: pod for pod in snapshot.pending_pods}
            PENDING_PODS.set(len(pending))
            self.timelines.mark_many(pending, "staged")
            solve_started = time.monotonic()
            inflight = self.model.schedule_async(snapshot)
        except BaseException:
            # a failed round is not a stuck one: close its mark
            TRACER.mark_closed(f"round:{rid}")
            raise
        TRACER.emit("begin_tick", cat="tick", t0=t_begin, round_id=rid,
                    args={"pending": len(pending),
                          **({"trigger": trigger} if trigger else {})})
        return PendingTick(at0, pending, inflight, solve_started, rid,
                           trigger)

    def commit_tick(self, tick: PendingTick) -> ScheduleResult:
        """Read a :meth:`begin_tick` dispatch back and assume committed
        placements (and waiting holds) into the cache, then open the
        Permit barrier of waiting pods whose gang group is now complete,
        and run the batched PostFilter."""
        # this scheduler's round, keyed off the tick: two wired
        # schedulers in one process never share a watchdog mark key
        self.last_round_id = tick.round_id
        if tick.result is not None:
            # a per-pod round: its epilogue ran inside the cycles
            TRACER.mark_closed(f"round:{tick.round_id}", name="round",
                               cat="tick")
            return tick.result
        try:
            result = tick.inflight.finalize()
        except BaseException:
            TRACER.mark_closed(f"round:{tick.round_id}")
            raise
        try:
            t_epilogue = TRACER.now()
            BATCH_SOLVE_DURATION.observe(
                time.monotonic() - tick.solve_started)
            for uid, node in result.items():
                SCHEDULING_ATTEMPTS.inc(
                    {"result": "scheduled" if node is not None
                     else "unschedulable"})
            at = tick.at
            pending = tick.pending
            for uid, node in result.items():
                if node is None:
                    continue
                self.cache.assume_pod(uid, node, now=at)
                self.gang_manager.on_pod_bound(uid)
                # keep the host quota managers' used in step with the solve
                self._account_quota(pending.get(uid))
                if uid in result.resv_committed:
                    self._resv_inflight[uid] = result.resv_committed[uid]
            for uid, node in result.waiting.items():
                # a waiting member holds its node and quota, unbound
                self.cache.assume_pod(uid, node, now=at)
                held = self.cache.pods.get(uid)
                if held is not None:
                    held.waiting_permit = True
                self._account_quota(pending.get(uid))
                self._waiting[uid] = node
                self._waiting_since.setdefault(uid, at)
                self.gang_manager.on_pod_waiting(uid)
                if uid in result.resv_allocs:
                    self._resv_waiting[uid] = result.resv_allocs[uid]
            self._fine_waiting.update(result.fine_states)
            self._resolve_waiting(result)
            self._preempt_unplaced(result, pending, at)
            self.timelines.mark_many(
                [uid for uid, node in result.items() if node is not None],
                "solved")
        except BaseException:
            # a failed epilogue (a fenced eviction raising mid-takeover)
            # closes the mark, or the watchdog would flag a retired round
            TRACER.mark_closed(f"round:{tick.round_id}")
            raise
        TRACER.emit("epilogue", cat="tick", t0=t_epilogue,
                    round_id=tick.round_id)
        TRACER.mark_closed(
            f"round:{tick.round_id}", name="round", cat="tick",
            args={
                "placed": sum(1 for v in result.values() if v is not None),
                "total": len(result),
                **({"trigger": tick.trigger} if tick.trigger else {}),
            })
        return result

    def _preempt_unplaced(self, result: ScheduleResult, pending, now) -> None:
        """Batched PostFilter: for pods the solve could not place, try
        same-quota lower-priority preemption (preempt.go). Victims are
        evicted now; the preemptor binds in a later round once the
        capacity has freed (the reference's nominate-then-wait)."""
        backend = self.preemption_backend
        if backend != "host" and not self._quota_plugin.enable_preemption:
            # the host post_filter applies the same gate inside, after
            # counting the attempt
            return
        unplaced = [uid for uid, node in result.items()
                    if node is None and uid not in result.waiting]
        if not unplaced:
            return
        snapshot = self.cache.snapshot(now=now)
        assigned = [p for p in snapshot.pods if p.preemptible]
        if not assigned:
            return
        model = self.model
        lowering = model.lowering_kwargs()
        min_priority = min(p.priority for p in assigned)
        arrays = resident = world = None
        attempts = 0
        for uid in unplaced:
            if attempts >= self.MAX_PREEMPTIONS_PER_ROUND:
                break
            pod = pending.get(uid)
            if pod is None or pod.priority <= min_priority:
                continue  # no strictly lower-priority victim can exist
            attempts += 1
            PREEMPTION_ATTEMPTS.inc()
            if arrays is None:
                arrays = lower_nodes(snapshot, **lowering)
                if backend != "host":
                    resident = model.lower_residents(snapshot, arrays)
                    world = model.resident_world(resident)
            if backend != "device":
                # seeded like a plugin-chain cycle: the oracle's filter
                # runs with the model's thresholds
                state = CycleState(self.framework.cycle_seed)
                state[ARRAYS_STATE_KEY] = arrays
                want = self._quota_plugin.post_filter(state, snapshot, pod)
                want = None if want is None else (
                    want[0], [v.uid for v in want[1]])
            if backend == "host":
                if want is None:
                    continue
                node_name, victim_uids = want
                victim_uids = sorted(victim_uids)
                admitted = self._evict_victims(
                    victim_uids, source="preemption", node=node_name,
                    now=now, all_or_nothing=True)
                if victim_uids and not admitted:
                    # the arbiter deferred the whole set: nothing evicted,
                    # no nomination; the preemptor retries later
                    continue
                # later preemptors see the eviction: a full re-lower
                wanted = set(victim_uids)
                snapshot.pods = [p for p in snapshot.pods
                                 if p.uid not in wanted]
                arrays = lower_nodes(snapshot, **lowering)
                result.nominations[uid] = node_name
                continue
            # the device selection against the staged resident world; the
            # eviction re-lowers one node row in place
            rows = self._quota_plugin.quota_rows(pod)
            got = model.select_victims_device(
                arrays, resident, pod,
                quota_used=rows[0] if rows is not None else None,
                used_limit=rows[1] if rows is not None else None,
                world=world)
            if backend == "verify" and got != want:
                raise AssertionError(
                    f"preemption parity violation for {pod.uid}: device "
                    f"{got!r} != oracle {want!r}")
            if got is None:
                continue
            node_name, ordered_uids = got
            n_cand = sum(1 for p in snapshot.pods
                         if p.node_name == node_name and can_preempt(pod, p))
            PREEMPT_VICTIMS.inc({"outcome": "selected"}, len(ordered_uids))
            PREEMPT_VICTIMS.inc({"outcome": "reprieved"},
                                n_cand - len(ordered_uids))
            admitted = self._evict_victims(
                sorted(ordered_uids), source="preemption", node=node_name,
                now=now, all_or_nothing=True)
            if ordered_uids and not admitted:
                # deferred whole: the resident world keeps its rows, the
                # hole stays unfree, no nomination
                continue
            PREEMPT_VICTIMS.inc({"outcome": "evicted"}, len(ordered_uids))
            evict_resident_rows(snapshot, arrays, resident, node_name,
                                ordered_uids, **lowering)
            result.nominations[uid] = node_name

    def _evict_victims(self, uids: List[str], source: str = "preemption",
                       node: Optional[str] = None,
                       now: Optional[float] = None,
                       all_or_nothing: bool = False) -> List[str]:
        """Evict ``uids`` through ``evict_pod_fn`` (its deletion event
        re-enters :meth:`remove_pod`) or, without one, through
        :meth:`remove_pod` directly, which marks each victim's node.
        With a migration arbiter the batch is arbitrated first (per
        victim its QoS lane, gang and the gang's headroom: live bound
        members above ``min_member``); deferred victims stay placed, and
        ``all_or_nothing`` (a preemption victim set) defers the whole
        batch when any member would be. Returns the evicted uids."""
        if self.migration_arbiter is not None and uids:
            victims = [self.cache.pods.get(uid) for uid in uids]
            lanes = [None if v is None else lane_of(v) for v in victims]
            gangs = [None if v is None else v.gang for v in victims]
            headroom: Dict[str, int] = {}
            for gang in set(g for g in gangs if g):
                spec = self.cache.gangs.get(gang)
                if spec is None:
                    continue
                live = sum(1 for p in self.cache.pods.values()
                           if p.gang == gang and p.node_name)
                headroom[gang] = max(live - spec.min_member, 0)
            verdict = self.migration_arbiter.request(
                source, node, uids, lanes=lanes, gangs=gangs,
                gang_headroom=headroom, now=now,
                all_or_nothing=all_or_nothing)
            if not verdict.apply:
                return []
            uids = list(verdict.admitted)
        for uid in uids:
            victim = self.cache.pods.get(uid)
            if victim is None:
                continue
            if self.evict_pod_fn is not None:
                self.evict_pod_fn(victim)
            else:
                self.remove_pod(victim)
        return list(uids)

    def defrag_headroom(self, target_req, max_victim_priority: int,
                        apply: bool = False, now: Optional[float] = None):
        """Headroom repack: the cheapest node to drain (preemptible
        residents strictly below ``max_victim_priority``, least important
        first) until a ``target_req``-sized hole fits. Returns ``(node
        name, drain uids in eviction order)``, or None (also when the hole
        already fits somewhere). With ``apply=True`` the drains are
        evicted through the same sink as preemption victims. The plan
        runs on ``preemption_backend``; "verify" raises when the device
        and host plans differ."""
        target = np.asarray(target_req)
        snapshot = self.cache.snapshot(now=now)
        arrays = lower_nodes(snapshot, **self.model.lowering_kwargs())
        got = want = None
        if self.preemption_backend != "host":
            resident = self.model.lower_residents(snapshot, arrays)
            got = self.model.plan_defrag_device(
                arrays, resident, target, max_victim_priority)
        if self.preemption_backend != "device":
            plan = plan_defrag(snapshot, target, max_victim_priority,
                               arrays=arrays)
            want = None if plan is None else (
                plan[0], [v.uid for v in plan[1]])
        if self.preemption_backend == "host":
            got = want
        elif self.preemption_backend == "verify" and got != want:
            raise AssertionError(
                f"defrag parity violation: device {got!r} != oracle "
                f"{want!r}")
        if got is not None and apply:
            # arbitrated like the preemption victims, but a partial
            # admission is kept: each drain shrinks the hole's deficit
            admitted = self._evict_victims(got[1], source="defrag",
                                           node=got[0], now=now)
            DEFRAG_DRAINS.inc(amount=len(admitted))
            got = (got[0], admitted)
        return got

    def rebalance_sweep(self, plugin, now: Optional[float] = None
                        ) -> List[str]:
        """One LowNodeLoad Balance pass (``descheduler/loadaware.py``)
        against this scheduler's cache, each eviction through
        :meth:`_evict_victims` (source "rebalance", arbitrated when an
        arbiter is wired; a deferral is the evictor's refusal). The
        plugin's backend picks the walk's host or device form. Evictions
        land through ``remove_pod``/``evict_pod_fn``, which marks the
        victim's node for the next round's delta staging. Returns the
        evicted uids in sweep order."""
        scheduler = self

        class _ArbitratedSink(Evictor):
            def _do_evict(self, snapshot, pod, reason) -> bool:
                return bool(scheduler._evict_victims(
                    [pod.uid], source="rebalance", node=pod.node_name,
                    now=now))

        snapshot = self.cache.snapshot(now=now)
        sink = _ArbitratedSink()
        plugin.balance(snapshot, sink)
        return [p.uid for p in sink.evicted]

    def _schedule_pending_incremental(self, now: Optional[float]
                                      ) -> ScheduleResult:
        """A round with the BatchedPlacement gate off: one plugin-chain
        cycle per pending pod, in schedule order (the reference's only
        mode)."""
        held_before = set(self._waiting)
        pending = list(self.cache.pending.values())
        assignments: Dict[str, Optional[str]] = {}
        waiting: Dict[str, str] = {}
        for idx in schedule_order(pending):
            pod = pending[idx]
            outcome = self.schedule_one(pod.uid, now=now)
            if outcome.status == "bound":
                assignments[pod.uid] = outcome.node
            elif outcome.status == "waiting":
                waiting[pod.uid] = outcome.node
            else:
                assignments[pod.uid] = None
        # siblings a later member's Permit ALLOW released, of this round
        # and earlier ones, are bound, not waiting: reported committed so
        # the publish confirms their (still open) assumes, as the batched
        # path's _resolve_waiting does
        for uid, node in list(waiting.items()):
            pod = self.cache.pods.get(uid)
            if pod is not None and not pod.waiting_permit:
                waiting.pop(uid)
                assignments[uid] = node
        for uid in held_before.difference(self._waiting, assignments):
            pod = self.cache.pods.get(uid)
            if (pod is not None and pod.node_name is not None
                    and not pod.waiting_permit):
                assignments[uid] = pod.node_name
        return ScheduleResult(assignments, waiting=waiting)

    def schedule_one(self, pod_uid: str, now: Optional[float] = None
                     ) -> ScheduleOutcome:
        """One pending pod through the plugin chain on a fresh snapshot.
        A bound or waiting outcome is assumed into the cache (a waiting
        pod holds its node at the Permit barrier, with its cycle state
        and reservation consumption kept for the rollback); a nominated
        one evicts its victims, and the pod binds in a later cycle."""
        snapshot = self.cache.snapshot(now=now)
        pod = self.cache.pending.get(pod_uid)
        if pod is None:
            return ScheduleOutcome(pod_uid, None, "error", "pod not pending")
        outcome = self.framework.schedule_one(snapshot, pod)
        if outcome.status == "nominated" and outcome.victims:
            self._evict_victims(outcome.victims)
            return outcome
        if outcome.status in ("bound", "waiting") and outcome.node:
            self.cache.assume_pod(pod_uid, outcome.node, now=now)
            if outcome.status == "bound":
                self.gang_manager.on_pod_bound(pod_uid)
            else:
                at = now if now is not None else time.time()
                held = self.cache.pods.get(pod_uid)
                if held is not None:
                    held.waiting_permit = True
                self._waiting[pod_uid] = outcome.node
                self._waiting_since.setdefault(pod_uid, at)
                state = outcome.cycle_state
                if state is not None:
                    # the cycle state for the fine-grained rollback or
                    # deferred PreBind, the reservation delta for the
                    # rollback on WaitTime expiry
                    self._fine_waiting[pod_uid] = (outcome.node, state)
                    resv_name = state.get("reservation_allocated")
                    delta = state.get("reservation_allocated_delta")
                    if resv_name and delta is not None:
                        self._resv_waiting[pod_uid] = (resv_name, delta)
        return outcome

    def _on_gang_release(self, uids: List[str]) -> None:
        """The plugin chain's Permit barrier opened: the waiting siblings
        are bindable. As in ``_resolve_waiting``, the assume stays open
        (and the reservation consumption rollback-able) until a publish
        confirms the bind."""
        for uid in uids:
            self.cache.open_permit(uid)
            self._waiting.pop(uid, None)
            self._waiting_since.pop(uid, None)
            info = self._resv_waiting.pop(uid, None)
            if info is not None:
                self._resv_inflight[uid] = info
            self._fine_pre_bind(uid)

    def _on_gang_reject(self, uids: List[str]) -> None:
        """A Strict gang-group rejection released these waiting siblings:
        their node, quota, fine-grained and reservation holds go back."""
        for uid in uids:
            if uid in self._waiting:
                self._release_waiting(uid)

    def forget_assumed_unbound(self) -> List[str]:
        """Release every assumed-but-unbound pod back to pending, undoing
        its quota, gang and reservation holds (a round aborted before its
        binds published). Returns the forgotten uids."""
        forgotten: List[str] = []
        for uid in list(self.cache.assumed):
            pod = self.cache.pods.get(uid)
            if pod is None:
                self.cache.forget_pod(uid)
                continue
            if uid in self._waiting:
                self._release_waiting(uid)
            else:
                # the validate loop applied real NUMA/device holds for
                # this placement: the same release as remove_pod
                self._release_node_holds(pod)
                self._account_quota(pod, release=True)
                self._fine_waiting.pop(uid, None)
                self._apply_resv_rollback(
                    uid, self._resv_inflight.pop(uid, None))
                self.cache.forget_pod(uid)
            self.gang_manager.on_pod_forgotten(uid)
            forgotten.append(uid)
        return forgotten

    def expire_waiting(self, now: float) -> List[str]:
        """Reject waiting pods whose gang WaitTime elapsed, with (Strict)
        their whole gang group: holds released, pods back to pending.
        Returns the released uids."""
        released: List[str] = []
        for uid, since in list(self._waiting_since.items()):
            if uid not in self._waiting:
                self._waiting_since.pop(uid, None)
                continue
            pod = self.cache.pods.get(uid)
            if pod is None:
                self._waiting_since.pop(uid, None)
                self._waiting.pop(uid, None)
                continue
            spec = self.cache.gangs.get(pod.gang) if pod.gang else None
            wait_time = spec.wait_time if spec is not None else 600.0
            if not wait_time or (now - since) < wait_time:
                continue
            GANG_REJECTIONS.inc()
            siblings = self.gang_manager.unreserve(uid)
            for r in {uid, *siblings}:
                if r in self._waiting:
                    self._release_waiting(r)
                    released.append(r)
        return released

    def _release_waiting(self, uid: str) -> None:
        """Release one waiting pod's holds (node, quota, fine-grained,
        reservation) and return it to pending."""
        self._waiting.pop(uid, None)
        self._waiting_since.pop(uid, None)
        pod = self.cache.pods.get(uid)
        self._account_quota(pod, release=True)
        held = self._fine_waiting.pop(uid, None)
        if held is not None and self.model.fine is not None:
            node = self.cache.nodes.get(held[0])
            if pod is not None and node is not None:
                self.model.fine.rollback(None, pod, node, held[1])
        self._rollback_reservation(uid)
        self.cache.forget_pod(uid)

    def _rollback_reservation(self, uid: str) -> None:
        """Undo a waiting pod's reservation consumption."""
        self._apply_resv_rollback(uid, self._resv_waiting.pop(uid, None))

    def _apply_resv_rollback(self, uid: str, info) -> None:
        """Restore one pod's recorded reservation consumption."""
        if info is None:
            return
        name, delta = info
        resv = self.cache.reservations.get(name)
        if resv is None:
            return
        cur = resources_to_vector(resv.allocated)
        resv.allocated = vector_to_resources(np.maximum(cur - delta, 0))
        if uid in resv.allocated_pod_uids:
            resv.allocated_pod_uids.remove(uid)
        if resv.allocate_once and resv.state == ReservationState.SUCCEEDED:
            resv.state = ReservationState.AVAILABLE
        self.cache.delta_tracker.mark_node(resv.node_name)

    def _account_quota(self, pod: Optional[PodSpec],
                       release: bool = False) -> None:
        if pod is None or not pod.quota:
            return
        vec = resources_to_vector(pod.requests)
        self.quota_registry.manager_for_quota(pod.quota).add_used(
            pod.quota, -vec if release else vec,
            non_preemptible=not pod.preemptible)

    def _resolve_waiting(self, result: ScheduleResult) -> None:
        """Open the Permit barrier for waiting pods whose gang group is
        now satisfied: report them as committed placements."""
        if not self._waiting:
            return
        assigned_count: Dict[str, int] = {}
        for pod in self.cache.pods.values():
            if pod.gang and pod.node_name is not None:
                assigned_count[pod.gang] = assigned_count.get(pod.gang, 0) + 1
        gangs = self.cache.gangs

        def group_of(gang_name: str) -> List[str]:
            spec = gangs.get(gang_name)
            if spec is None or not spec.gang_group:
                return [gang_name]
            return list(spec.gang_group)

        for uid, node in list(self._waiting.items()):
            pod = self.cache.pods.get(uid)
            if pod is None or pod.gang is None:
                self._waiting.pop(uid, None)
                continue
            satisfied = all(
                assigned_count.get(g, 0)
                >= (gangs[g].min_member if g in gangs else 1)
                for g in group_of(pod.gang))
            if satisfied:
                self._waiting.pop(uid)
                self._waiting_since.pop(uid, None)
                info = self._resv_waiting.pop(uid, None)
                if info is not None:
                    # final once the bind publishes; rollback-able until
                    self._resv_inflight[uid] = info
                result.waiting.pop(uid, None)
                result[uid] = node
                # bindable; the assume stays open until the publish
                self.cache.open_permit(uid)
                self.gang_manager.on_pod_bound(uid)
                self._fine_pre_bind(uid)

    def _fine_pre_bind(self, uid: str) -> None:
        """Annotate a pod's fine-grained allocation (its deferred
        PreBind) once its Permit barrier opens."""
        held = self._fine_waiting.pop(uid, None)
        if held is None or self.model.fine is None:
            return
        node_name, cstate = held
        pod = self.cache.pods.get(uid)
        node = self.cache.nodes.get(node_name)
        if pod is not None and node is not None:
            # PreBind reads only the CycleState: no snapshot needed
            self.model.fine.pre_bind(None, pod, node, cstate)
