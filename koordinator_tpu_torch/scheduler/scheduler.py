"""The scheduler's batched round (counterpart of
``koordinator_tpu/scheduler/scheduler.py``).

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

Not in this slice of the port, and queued in ROADMAP.md:
- the plugin chain: ``schedule_one`` and ``batched_placement=False``
  raise ``NotImplementedError``;
- the trace, metrics (the preemption counters among them), pod timelines
  and device observatory, the bus wiring's publish sink and the migration
  arbiter: the round runs without them, and evictions are not
  arbitrated.
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
from koordinator_tpu_torch.device.cache import NodeDeviceCache
from koordinator_tpu_torch.gang.manager import GangManager
from koordinator_tpu_torch.models.finegrained import FineGrained
from koordinator_tpu_torch.models.placement import (
    InFlightSchedule,
    PlacementModel,
    ScheduleResult,
)
from koordinator_tpu_torch.numa.manager import ResourceManager, TopologyOptions
from koordinator_tpu_torch.quota.trees import QuotaTreeRegistry
from koordinator_tpu_torch.scheduler.cache import SchedulerCache
from koordinator_tpu_torch.scheduler.plugins.deviceshare import (
    DeviceSharePlugin,
)
from koordinator_tpu_torch.scheduler.plugins.elasticquota import (
    ElasticQuotaPlugin,
)
from koordinator_tpu_torch.scheduler.plugins.nodenumaresource import (
    NodeNUMAResourcePlugin,
)
from koordinator_tpu_torch.scheduler.plugins.nodeports import NodePortsPlugin
from koordinator_tpu_torch.scheduler.preemption import plan_defrag
from koordinator_tpu_torch.scheduler.reservation_controller import (
    ReservationController,
)
from koordinator_tpu_torch.state.cluster import (
    evict_resident_rows,
    lower_nodes,
)


class PendingTick:
    """One round between dispatch (:meth:`Scheduler.begin_tick`) and
    retirement (:meth:`Scheduler.commit_tick`, exactly once)."""

    __slots__ = ("at", "pending", "inflight")

    def __init__(self, at: float, pending: Dict[str, PodSpec],
                 inflight: InFlightSchedule):
        self.at = at
        self.pending = pending
        self.inflight = inflight


class Scheduler:
    """The batched scheduler: ``schedule_pending()`` solves the whole
    queue in one solve and assumes the results into the cache."""

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
        self.cache = SchedulerCache()
        self.quota_registry = QuotaTreeRegistry(cluster_total=cluster_total
                                                or {})
        self.quota_manager = self.quota_registry.default
        self.gang_manager = GangManager()
        self.numa_manager = ResourceManager()
        self.device_cache = NodeDeviceCache()
        #: pods placed at the Permit barrier: uid -> held node. They hold
        #: resources (assumed) but are not bound until their gang group
        #: completes.
        self._waiting: Dict[str, str] = {}
        #: when each waiting pod entered the barrier (WaitTime expiry)
        self._waiting_since: Dict[str, float] = {}
        #: BatchedPlacement gate; False (per-pod cycles) is not ported
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

    # -- scheduling ---------------------------------------------------------

    def schedule_pending(self, now: Optional[float] = None) -> ScheduleResult:
        """One batched round: :meth:`begin_tick` then :meth:`commit_tick`."""
        return self.commit_tick(self.begin_tick(now))

    def begin_tick(self, now: Optional[float] = None) -> PendingTick:
        """Round start through dispatch: expire stale waits and
        reservations, take the snapshot, and hand the pending queue to the
        model without reading the result back."""
        at0 = now if now is not None else time.time()
        # the previous round's binds have published (or were forgotten):
        # their rollback window is over
        self._resv_inflight = {}
        self.expire_waiting(at0)
        self.reservation_controller.sync(at0)
        if not self.batched_placement:
            raise NotImplementedError(
                "per-pod rounds (batched_placement=False) need the plugin "
                "chain, a later slice of the port (scheduler/framework.py)")
        snapshot = self.cache.snapshot(now=now)
        pending = {pod.uid: pod for pod in snapshot.pending_pods}
        return PendingTick(at0, pending, self.model.schedule_async(snapshot))

    def commit_tick(self, tick: PendingTick) -> ScheduleResult:
        """Read a :meth:`begin_tick` dispatch back and assume committed
        placements (and waiting holds) into the cache, then open the
        Permit barrier of waiting pods whose gang group is now complete."""
        result = tick.inflight.finalize()
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
        return result

    def _preempt_unplaced(self, result: ScheduleResult, pending, now) -> None:
        """Batched PostFilter: for pods the solve could not place, try
        same-quota lower-priority preemption (preempt.go). Victims are
        evicted now; the preemptor binds in a later round once the
        capacity has freed (the reference's nominate-then-wait)."""
        if not self._quota_plugin.enable_preemption:
            return
        unplaced = [uid for uid, node in result.items()
                    if node is None and uid not in result.waiting]
        if not unplaced:
            return
        snapshot = self.cache.snapshot(now=now)
        assigned = [p for p in snapshot.pods if p.preemptible]
        if not assigned:
            return
        backend = self.preemption_backend
        model = self.model
        lowering = model.lowering_kwargs()
        min_priority = min(p.priority for p in assigned)
        arrays = resident = world = thresholds = None
        attempts = 0
        for uid in unplaced:
            if attempts >= self.MAX_PREEMPTIONS_PER_ROUND:
                break
            pod = pending.get(uid)
            if pod is None or pod.priority <= min_priority:
                continue  # no strictly lower-priority victim can exist
            attempts += 1
            if arrays is None:
                arrays = lower_nodes(snapshot, **lowering)
                if backend != "device":  # the host oracle's thresholds
                    thresholds = (model.params.thresholds.cpu().numpy(),
                                  model.params.prod_thresholds.cpu().numpy())
                if backend != "host":
                    resident = model.lower_residents(snapshot, arrays)
                    world = model.resident_world(resident)
            if backend != "device":
                want = self._quota_plugin.post_filter(
                    snapshot, pod, arrays, *thresholds)
                want = None if want is None else (
                    want[0], [v.uid for v in want[1]])
            if backend == "host":
                if want is None:
                    continue
                node_name, victim_uids = want
                self._evict_victims(sorted(victim_uids))
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
            self._evict_victims(sorted(ordered_uids))
            evict_resident_rows(snapshot, arrays, resident, node_name,
                                ordered_uids, **lowering)
            result.nominations[uid] = node_name

    def _evict_victims(self, uids: List[str]) -> List[str]:
        """Evict ``uids`` through ``evict_pod_fn`` (its deletion event
        re-enters :meth:`remove_pod`) or, without one, through
        :meth:`remove_pod` directly, which marks each victim's node.
        Returns the uids (no arbiter defers any)."""
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
            got = (got[0], self._evict_victims(got[1]))
        return got

    def schedule_one(self, pod_uid: str, now: Optional[float] = None):
        raise NotImplementedError(
            "schedule_one runs the plugin chain, a later slice of the port "
            "(scheduler/framework.py)")

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
