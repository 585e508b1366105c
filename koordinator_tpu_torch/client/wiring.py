"""Informer adapters: subscribe components to the bus (counterpart of
``koordinator_tpu/client/wiring.py``).

The scheduler consumes Node/Pod/NodeMetric/Quota/PodGroup/Reservation/
Device/NRT, with a DeleteFunc for every kind, publishes its binds back
onto the bus and evicts through it; the manager consumes NodeMetric and
the pods through a snapshot of the bus, PATCHes Node allocatable back
onto it and, with a NodeSLO renderer, publishes each node's NodeSLO;
the descheduler classifies the bus's snapshot, reserves each migration's
destination through the placement solver and evicts through the bus.
``wire_pod_webhook`` feeds the pod mutating webhook's quota-tree
registries from the bus. A node agent (``wire_koordlet``) watches its
Node, its pods, its NodeSLO and the PVCs into its states informer, and
``KoordletLoop.report`` publishes its NodeMetric, and through
``koordlet_report_sinks`` its NRT and Device CRs.
"""

from __future__ import annotations

import dataclasses

from koordinator_tpu_torch import DeviceLike
from koordinator_tpu_torch.apis.extension import (
    ResourceName,
    parse_node_reservation,
)
from koordinator_tpu_torch.apis.types import ClusterSnapshot
from koordinator_tpu_torch.client.bus import APIServer, EventType, Kind
from koordinator_tpu_torch.obs.trace import TRACER


def transform_node(node):
    """The scheduler-side node transform: subtract the node-reservation
    annotation's resources from allocatable before the scheduler's cache
    sees the node. Only the Default apply policy trims (ReservedCPUsOnly
    reserves cores without shrinking schedulable totals); a malformed
    annotation leaves the node untouched. Returns a COPY when trimming:
    the in-process bus shares objects, and other watchers (the manager's
    overcommit reads the annotation itself) keep the raw view."""
    spec = parse_node_reservation(node.annotations)
    if spec is None or spec["apply_policy"] not in ("", "Default"):
        return node
    cpu, mem = spec["cpu"], spec["memory"]
    if cpu <= 0 and mem <= 0:
        return node
    alloc = dict(node.allocatable)
    if cpu > 0:
        alloc[ResourceName.CPU] = max(
            alloc.get(ResourceName.CPU, 0) - cpu, 0
        )
    if mem > 0:
        alloc[ResourceName.MEMORY] = max(
            alloc.get(ResourceName.MEMORY, 0) - mem, 0
        )
    return dataclasses.replace(node, allocatable=alloc)


def _updater(update_fn, delete_fn):
    """Bus watch adapter: DELETED events dispatch by name, everything
    else by object."""

    def on_event(event, name, obj):
        if event is EventType.DELETED:
            delete_fn(name)
        else:
            update_fn(obj)

    return on_event


def wire_scheduler(bus: APIServer, scheduler, elector=None) -> None:
    """Subscribe a Scheduler to every kind it consumes. Its
    ``schedule_pending`` is wrapped to publish each round's binds through
    the bus (confirming the assume and closing the pod's timeline), and
    its eviction sink deletes victims through the bus. With ``elector``
    (a LeaderElector) the eviction is fenced: a deposed leader's
    in-flight eviction raises FencingError instead of double-applying."""

    def on_node(event, name, node):
        if event is EventType.DELETED:
            scheduler.remove_node(name)
        else:
            # trim allocatable by the node-reservation annotation before
            # the scheduler sees the node
            scheduler.add_node(transform_node(node))

    # bus key per pod uid: conventionally identical, but an eviction must
    # delete the key the pod was applied under
    pod_bus_name = {}

    def on_pod(event, name, pod):
        if event is EventType.DELETED:
            pod_bus_name.pop(pod.uid, None)
            scheduler.remove_pod(pod)
        else:
            pod_bus_name[pod.uid] = name
            # update_pod handles first sight and refresh without re-running
            # quota/gang registration for status-only changes
            scheduler.update_pod(pod)

    bus.watch(Kind.NODE, on_node)
    bus.watch(Kind.POD, on_pod)
    bus.watch(
        Kind.NODE_METRIC,
        _updater(scheduler.update_node_metric, scheduler.remove_node_metric),
    )
    bus.watch(
        Kind.QUOTA, _updater(scheduler.update_quota, scheduler.remove_quota)
    )
    bus.watch(Kind.GANG, _updater(scheduler.update_gang,
                                  scheduler.remove_gang))
    bus.watch(
        Kind.RESERVATION,
        _updater(scheduler.update_reservation, scheduler.remove_reservation),
    )

    def on_nrt(event, name, topology):
        if event is EventType.DELETED:
            from koordinator_tpu_torch.numa.manager import TopologyOptions

            scheduler.update_node_topology(name, TopologyOptions())
        else:
            scheduler.update_node_topology(name, topology)

    def on_device(event, name, entries):
        scheduler.update_node_devices(
            name, [] if event is EventType.DELETED else entries
        )

    bus.watch(Kind.NODE_RESOURCE_TOPOLOGY, on_nrt)
    bus.watch(Kind.DEVICE, on_device)

    # binds are PUBLISHED through the bus so node agents and controllers
    # observe them: each newly committed pod is re-applied after the
    # round, and the MODIFIED event re-enters update_pod, which handles
    # refreshes of assigned pods idempotently
    inner_schedule = scheduler.schedule_pending

    def publish_result(out):
        t0 = TRACER.now()
        published = 0
        for uid, node in out.items():
            if node is None:
                continue
            key = pod_bus_name.get(uid, uid)
            pod = bus.get(Kind.POD, key)
            if pod is not None and getattr(pod, "node_name", None) == node:
                bus.apply(Kind.POD, key, pod)
                # confirm ONLY what published: whatever stays assumed is
                # the unpublished state an aborted round must forget
                scheduler.cache.finish_binding(uid)
                # the bind is observable: close the pod's timeline
                scheduler.timelines.published(uid)
                published += 1
        TRACER.emit("publish", cat="publish", t0=t0,
                    args={"published": published})

    def schedule_and_publish(now=None, trigger=None):
        out = inner_schedule(now=now, trigger=trigger)
        # the watchdog mark of the inline publish: a publish wedged on the
        # bus must leave an open mark behind
        rid = getattr(scheduler, "last_round_id", None)
        if rid is None:
            rid = TRACER.round_id
        TRACER.mark_open(f"publish:{rid}", round_id=rid)
        try:
            publish_result(out)
        finally:
            TRACER.mark_closed(f"publish:{rid}")
        return out

    scheduler.schedule_pending = schedule_and_publish
    # the pipelined loop (scheduler/pipeline.py) calls the halves itself
    # and publishes from its worker through this
    scheduler.publish_result = publish_result

    # victims are evicted THROUGH the bus so every watcher observes the
    # eviction; the DELETED event re-enters remove_pod
    def _evict(pod):
        def do():
            bus.delete(Kind.POD, pod_bus_name.get(pod.uid, pod.uid))

        if elector is not None:
            elector.fenced(do)
        else:
            do()

    scheduler.evict_pod_fn = _evict


def snapshot_from_bus(bus: APIServer, now: float,
                      with_reservations: bool = False) -> ClusterSnapshot:
    """The assigned-pod cluster snapshot of the bus (shared by the
    manager and the descheduler loops; the descheduler's also holds the
    reservations)."""
    return ClusterSnapshot(
        nodes=list(bus.list(Kind.NODE).values()),
        # Permit-held gang members are assumed, not bound: the manager
        # must not count them as running, and the descheduler must never
        # pick one as a migration victim
        pods=[
            p for p in bus.list(Kind.POD).values()
            if getattr(p, "node_name", None) is not None
            and not getattr(p, "waiting_permit", False)
        ],
        node_metrics=bus.list(Kind.NODE_METRIC),
        reservations=(list(bus.list(Kind.RESERVATION).values())
                      if with_reservations else []),
        now=now,
    )


class ManagerLoop:
    """The noderesource reconcile loop over the bus: NodeMetric and pods
    in, Node allocatable PATCH out."""

    def __init__(self, bus: APIServer, controller, elector=None,
                 nodeslo=None):
        self.bus = bus
        self.controller = controller
        self.elector = elector
        #: the NodeSLO renderer (``manager/nodeslo.NodeSLOController``):
        #: when set, reconcile also publishes each node's rendered NodeSLO
        #: on the bus for the koordlets
        self.nodeslo = nodeslo

    def reconcile(self, now: float) -> int:
        """One pass; returns how many nodes were synced back to the bus."""
        snapshot = snapshot_from_bus(self.bus, now)
        # the controller mutates synced nodes' allocatable, and the host
        # plugins their annotations, in place: reconcile over COPIES of
        # both, so a fenced-off or failed write-back leaks nothing into
        # the shared bus objects (the reference copies the allocatable
        # only, and its amplification annotation lands on the bus object
        # unPATCHed)
        snapshot = dataclasses.replace(snapshot, nodes=[
            dataclasses.replace(n, allocatable=dict(n.allocatable),
                                annotations=dict(n.annotations))
            for n in snapshot.nodes
        ])
        updates = self.controller.reconcile_all(snapshot)
        synced = 0
        for update, node in zip(updates, snapshot.nodes):
            if update.synced:
                # the PATCH: the mutated NodeSpec is re-applied, fanning
                # out to watchers; a leader-elected manager fences it
                if self.elector is not None:
                    self.elector.fenced(
                        lambda n=node: self.bus.apply(Kind.NODE, n.name, n)
                    )
                else:
                    self.bus.apply(Kind.NODE, node.name, node)
                synced += 1
        if self.nodeslo is not None:
            for node in snapshot.nodes:
                spec = self.nodeslo.render(node.name, node.labels)
                if spec != self.bus.get(Kind.NODE_SLO, node.name):
                    # fenced like the Node PATCH: a deposed manager must
                    # not overwrite the leader's render
                    if self.elector is not None:
                        self.elector.fenced(
                            lambda n=node.name, s=spec:
                            self.bus.apply(Kind.NODE_SLO, n, s))
                    else:
                        self.bus.apply(Kind.NODE_SLO, node.name, spec)
        return synced


def wire_pod_webhook(bus: APIServer, webhook) -> None:
    """Feed the pod mutating webhook's quota-tree registries from the
    bus (ElasticQuota and ElasticQuotaProfile watches, deletes included),
    so admission can inject multi-quota-tree node affinity."""
    bus.watch(
        Kind.QUOTA, _updater(webhook.update_quota, webhook.remove_quota)
    )
    bus.watch(
        Kind.QUOTA_PROFILE,
        _updater(webhook.update_quota_profile, webhook.remove_quota_profile),
    )


def wire_manager(bus: APIServer, controller=None, elector=None,
                 nodeslo=None, device: DeviceLike = None) -> ManagerLoop:
    """A ManagerLoop on the bus; without ``controller``, a
    ``NodeResourceController`` on ``device`` (``cuda`` unless given)."""
    from koordinator_tpu_torch.manager.noderesource import (
        NodeResourceController,
    )

    if controller is None:
        controller = NodeResourceController(device=device)
    return ManagerLoop(bus, controller, elector, nodeslo)


class KoordletLoop:
    """One node agent on the bus: it consumes its Node, its node's pods
    and its rendered NodeSLO through watches, and reports NodeMetric
    status back (and, when wired, the NRT and Device CRs)."""

    def __init__(self, bus: APIServer, informer, node_name: str,
                 reporter=None, pod_meta_fn=None,
                 topology_reporter=None, device_reporter=None):
        from koordinator_tpu_torch.koordlet.statesinformer import (
            pod_meta_from_spec,
        )

        self.bus = bus
        self.informer = informer
        self.node_name = node_name
        self.reporter = reporter
        #: optional NRT / Device CR reporters (statesinformer reporters
        #: built with koordlet_report_sinks(bus) as their sinks)
        self.topology_reporter = topology_reporter
        self.device_reporter = device_reporter
        self._meta_fn = pod_meta_fn or pod_meta_from_spec
        self._pods = {}

        def on_node(event, name, node):
            if name == node_name and event is not EventType.DELETED:
                informer.set_node(node)

        def on_slo(event, name, slo):
            if name == node_name and event is not EventType.DELETED:
                informer.set_node_slo(slo)

        def on_pod(event, name, pod):
            # a gang member waiting at the Permit barrier is assumed
            # (node_name set in the scheduler cache) but not bound: the
            # agent must not run it
            mine = (
                getattr(pod, "node_name", None) == node_name
                and not getattr(pod, "waiting_permit", False)
            )
            if event is EventType.DELETED or not mine:
                if self._pods.pop(pod.uid, None) is None:
                    return  # never ours: don't rebuild the pod list
            else:
                self._pods[pod.uid] = pod
            informer.set_pods(
                [self._meta_fn(p) for p in self._pods.values()]
            )

        def on_pvc(event, name, pvc):
            # claim -> bound-PV map for the blkio pod-volume resolution
            if event is EventType.DELETED:
                informer.remove_pvc(name)
            else:
                informer.upsert_pvc(pvc)

        bus.watch(Kind.NODE, on_node)
        bus.watch(Kind.NODE_SLO, on_slo)
        bus.watch(Kind.POD, on_pod)
        bus.watch(Kind.PVC, on_pvc)

    def pods(self):
        return list(self._pods.values())

    def report(self, now: float):
        """Aggregate the metric cache into a NodeMetric and publish it
        (needs a NodeMetricReporter); the NRT and Device reporters, when
        wired, publish through their own bus sinks."""
        if (self.reporter is None and self.topology_reporter is None
                and self.device_reporter is None):
            raise RuntimeError(
                "wire_koordlet was built without any reporter; pass "
                "reporter=/topology_reporter=/device_reporter="
            )
        metric = None
        if self.reporter is not None:
            metric = self.reporter.report(now)
            if metric is not None:
                self.bus.apply(Kind.NODE_METRIC, self.node_name, metric)
        if self.topology_reporter is not None:
            self.topology_reporter.sync()
        if self.device_reporter is not None:
            self.device_reporter.sync()
        return metric


def koordlet_report_sinks(bus: APIServer):
    """(topology_sink, device_sink) publishing the NodeResourceTopology
    and Device CRs on the bus: the ``report`` callbacks the statesinformer
    reporters take (the scheduler's NUMA manager and device cache consume
    them through wire_scheduler's watches)."""
    return (
        lambda name, options: bus.apply(
            Kind.NODE_RESOURCE_TOPOLOGY, name, options
        ),
        lambda name, entries: bus.apply(Kind.DEVICE, name, list(entries)),
    )


def wire_koordlet(bus: APIServer, informer, node_name: str, reporter=None,
                  pod_meta_fn=None, topology_reporter=None,
                  device_reporter=None) -> KoordletLoop:
    return KoordletLoop(bus, informer, node_name, reporter, pod_meta_fn,
                        topology_reporter, device_reporter)


class DeschedulerLoop:
    """The descheduling cycle over the bus: classify and emit
    PodMigrationJobs, reconcile them reservation-first (the destination
    is found by the batched placement solver the scheduler runs, on
    ``device``: ``cuda`` unless given), then evict through the bus as a
    Pod delete and re-apply, so every wired component observes the
    move."""

    def __init__(self, bus: APIServer, descheduler, place_model=None,
                 elector=None, device: DeviceLike = None):
        from koordinator_tpu_torch.descheduler.migration import (
            MigrationController,
        )
        from koordinator_tpu_torch.models.placement import PlacementModel

        if not hasattr(descheduler.evictor, "jobs"):
            # a direct evictor would mutate shared pod objects without
            # any bus event: only the migration evictor is coherent here
            raise TypeError(
                "DeschedulerLoop requires a MigrationEvictor (jobs-based) "
                "evictor; direct eviction bypasses the bus"
            )
        self.bus = bus
        self.descheduler = descheduler
        self._model = place_model or PlacementModel(device=device)
        self.controller = MigrationController(self._place)
        #: a leader-elected deployment holds the lease through the
        #: mutation phase (evictions and reservations must not apply
        #: twice)
        self.elector = elector

    def _place(self, snapshot, reservation):
        """The reservation's node, through the batched solver: the probe
        has the VICTIM pod's shape (requests, devices, selector, QoS), so
        the reserved node can host it after the eviction."""
        from koordinator_tpu_torch.apis.types import PodSpec

        victim = None
        if reservation.owner_pod_uids:
            victim = next(
                (p for p in snapshot.pods
                 if p.uid == reservation.owner_pod_uids[0]), None,
            )
        if victim is not None:
            probe = dataclasses.replace(
                victim,
                name=f"__resv__{reservation.name}",
                uid=f"__resv__{reservation.name}",
                node_name=None,
                gang=None,
                quota=None,  # reservation capacity is not quota-gated
            )
        else:
            probe = PodSpec(
                name=f"__resv__{reservation.name}",
                uid=f"__resv__{reservation.name}",  # a reserve pod
                requests=dict(reservation.requests),
            )
        # the __resv__ uid marks the probe a reserve pod: it never matches
        # a reservation, while the existing reservations stay in the
        # snapshot so their holds count against their nodes. Nodes go
        # through the scheduler informer's node-reservation trim: a probe
        # that over-estimated a reserved node would create a Reservation
        # the scheduler can never bind, looping the migration
        out = self._model.schedule(ClusterSnapshot(
            nodes=[transform_node(n) for n in snapshot.nodes],
            pods=snapshot.pods,
            pending_pods=[probe],
            node_metrics=snapshot.node_metrics,
            reservations=snapshot.reservations,
            now=snapshot.now,
        ))
        return out.get(probe.uid)

    def run_once(self, now: float):
        """One cycle; returns the uids of the pods migrated."""
        from koordinator_tpu_torch.apis.types import MigrationPhase

        snapshot = snapshot_from_bus(self.bus, now, with_reservations=True)
        pre_assign = {p.uid: p.node_name for p in snapshot.pods}
        pre_resv = {r.name for r in snapshot.reservations}
        # bus key per pod uid (conventionally identical): deletes and
        # re-applies address the key the pod was applied under
        key_of = {p.uid: k for k, p in self.bus.list(Kind.POD).items()}
        self.descheduler.run_once(snapshot)
        evictor = self.descheduler.evictor
        jobs = list(evictor.jobs)
        migrated = []
        if jobs:
            # the reconcile (state machine and placement probes, the slow
            # part) runs outside any lock; every bus write runs in one
            # fenced transaction, so a leader deposed between the two
            # raises FencingError with nothing half-applied
            self.controller.reconcile(snapshot, jobs)

            def apply_mutations():
                # reservation deltas only (blanket re-applies would grow
                # the bus traffic and resurrect collected reservations)
                post = {r.name: r for r in snapshot.reservations}
                for name in pre_resv - set(post):
                    self.bus.delete(Kind.RESERVATION, name)
                for name, resv in post.items():
                    if name not in pre_resv:
                        self.bus.apply(Kind.RESERVATION, name, resv)
                for job in jobs:
                    self.bus.apply(Kind.MIGRATION_JOB, job.name, job)
                for pod in snapshot.pending_pods:
                    # an eviction deletes the pod and the workload
                    # recreates it. The controller cleared node_name on
                    # the shared object, so it is restored for the DELETE:
                    # the scheduler's release path (quota used, NUMA and
                    # device holds) keys off the assigned state
                    pod.node_name = pre_assign.get(pod.uid)
                    self.bus.delete(Kind.POD, key_of.get(pod.uid, pod.uid))
                    pod.node_name = None
                    self.bus.apply(Kind.POD, key_of.get(pod.uid, pod.uid),
                                   pod)
                    migrated.append(pod.uid)

            if self.elector is not None:
                try:
                    self.elector.fenced(apply_mutations)
                except Exception:
                    # undo the controller's in-place victim mutation, so
                    # the shared bus objects stay consistent with the
                    # eviction that never applied, and discard the
                    # advanced jobs: a re-elected leader re-detects, it
                    # does not publish phantom SUCCEEDED migrations
                    for pod in snapshot.pending_pods:
                        pod.node_name = pre_assign.get(pod.uid)
                    evictor.jobs = [
                        j for j in evictor.jobs
                        if j.phase in (MigrationPhase.PENDING,
                                       MigrationPhase.RUNNING)
                    ]
                    raise
            else:
                apply_mutations()
            # completed jobs leave the dedup window
            evictor.jobs = [
                j for j in evictor.jobs
                if j.phase in (MigrationPhase.PENDING, MigrationPhase.RUNNING)
            ]
        return migrated


def wire_descheduler(bus: APIServer, descheduler, place_model=None,
                     elector=None, device: DeviceLike = None
                     ) -> DeschedulerLoop:
    """A DeschedulerLoop on the bus; without ``place_model``, its probes
    solve on a ``PlacementModel`` on ``device`` (``cuda`` unless
    given)."""
    return DeschedulerLoop(bus, descheduler, place_model, elector, device)
