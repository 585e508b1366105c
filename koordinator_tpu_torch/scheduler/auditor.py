"""Runtime anti-entropy: audit and repair the scheduler's chain of
mirrors (counterpart of ``koordinator_tpu/scheduler/auditor.py``).

The bus is truth, ``SchedulerCache`` mirrors the bus (informer watches),
the staged host arrays mirror the cache (``ClusterDeltaTracker`` marks
and ``lower_nodes_delta``), and the staged device tensors mirror the host
arrays (``scatter_node_rows``). Epoch fencing protects every link
against races; nothing but a runtime check protects them against bugs:
a missed tracker mark, a mutation that bypassed an informer method, a
stale assume, a drifted staged row.

:class:`StateAuditor` runs budgeted sweeps over three boundaries:

1. **cache <-> bus**: the expected cache, re-derived from the bus
   through the informer's ``transform_node``, against the live cache:
   missing, extra and stale nodes, pods, metrics, reservations, gangs
   and quotas, orphaned and expired-but-lingering assumes, and Permit
   holds whose holder is gone.
2. **accounting invariants**: non-DaemonSet requests within allocatable
   on every node, no pod both pending and assigned, reservation credit
   within the reserved capacity, gang records in legal states.
3. **device <-> host parity**: a round-robin sample of staged rows
   re-lowered from typed truth (:func:`state.cluster.lower_node_rows`,
   the production lowerings' per-row helpers) and compared exactly with
   the staged host arrays and the staged tensors on the model's device,
   at the staged generation's own time base. With ``probe_rows=r`` over
   ``n`` rows every row is probed within ``ceil(n/r)`` sweeps. The
   sampled rows of every staged field are gathered on the device into
   one ``[rows, columns]`` int32 block and copied to the host once: one
   synchronisation a sweep.

Repairs climb a ladder, every rung counted in the ``scheduler_audit_*``
series: **targeted** (re-apply the drifted object through the
scheduler's informer methods, which mark the tracker), **cache-rebuild**
(``rebuild_threshold`` drifts or more, or an invariant violation with no
targeted fix: the cache re-derived from the bus) and **full-restage**
(any parity mismatch: ``StagedStateCache.invalidate()``, so the next
solve lowers and stages from typed truth).

``cmd/scheduler.run_loop`` sweeps every ``interval_rounds`` rounds (the
pipelined loop drains first), and a promoted leader sweeps before its
first round (``on_started_leading`` -> :meth:`note_promotion`), then
prestages the repaired world after restoring the warm pool's entries
(``warm_pool``, ``service/warmpool.py``): the new leader's first solve
then replays a captured graph instead of issuing its launches cold. The
report's ``warm`` entry holds the pool's restore report and the
prestage; a failed restore costs latency, never the round.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.apis.types import (
    resources_to_vector,
    vector_to_resources,
)
from koordinator_tpu_torch.client.bus import Kind
from koordinator_tpu_torch.metrics.components import (
    AUDIT_DETECTIONS,
    AUDIT_LAST_DRIFT,
    AUDIT_PROBE_ROWS,
    AUDIT_REPAIRS,
    AUDIT_SWEEP_DURATION,
    AUDIT_SWEEPS,
    AUDIT_UNREPAIRED,
)
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.state.cluster import lower_node_rows

#: one detected drift: (kind, detail, repair closure or None)
Drift = Tuple[str, str, Optional[Callable[[], None]]]


def read_back_rows(state, rows: List[int]) -> Dict[str, np.ndarray]:
    """``rows`` of every staged field of ``state`` (a ``NodeState`` on
    any device) on the host: gathered on the device into one int32
    block, copied back in one transfer. Returns ``{field: [K, ...]
    array}`` (bool fields as 0/1)."""
    first = state.alloc
    sel = torch.as_tensor(rows, dtype=torch.int64, device=first.device)
    cols = []
    for f in STAGED_NODE_FIELDS:
        part = getattr(state, f).index_select(0, sel)
        cols.append(part.reshape(len(rows), -1).to(torch.int32))
    block = torch.cat(cols, dim=1).cpu().numpy()
    out, at = {}, 0
    for f, col in zip(STAGED_NODE_FIELDS, cols):
        width = col.shape[1]
        shape = getattr(state, f).shape[1:]
        out[f] = block[:, at:at + width].reshape((len(rows),) + tuple(shape))
        at += width
    return out


class StateAuditor:
    """Budgeted anti-entropy sweeps and the counted repair ladder.

    ``scheduler`` is a wired :class:`~koordinator_tpu_torch.scheduler.
    scheduler.Scheduler`; ``bus`` the :class:`~koordinator_tpu_torch.
    client.bus.APIServer` it is wired to (``None`` skips the cache <->
    bus boundary: a standalone model still gets the invariants and the
    parity probe).

    Sweeps run on the scheduling loop's thread between rounds;
    ``status()`` is read from the debug mux's handler threads, under
    ``_lock``.
    """

    def __init__(self, scheduler, bus=None, *, interval_rounds: int = 16,
                 probe_rows: int = 64, rebuild_threshold: int = 8,
                 assume_ttl_s: float = 900.0, warm_pool=None):
        self.scheduler = scheduler
        self.bus = bus
        self.interval_rounds = int(interval_rounds)
        self.probe_rows = int(probe_rows)
        self.rebuild_threshold = int(rebuild_threshold)
        self.assume_ttl_s = float(assume_ttl_s)
        #: the warm pool (``service/warmpool.WarmPool``) the promotion
        #: sweep restores before the new leader's first solve; set-once
        #: wiring (``cmd/scheduler.main``), read without the lock
        self.warm_pool = warm_pool
        self._lock = threading.RLock()
        self._promotion_pending = False
        self._rounds_since = 0
        self._probe_cursor = 0
        #: fixerless invariant violations that persisted THROUGH a cache
        #: rebuild (bus truth itself broken): suppresses re-escalation
        #: while they last, re-armed the moment they heal
        self._unrepairable: set = set()
        self.sweeps: Dict[str, int] = {}
        self.detections: Dict[str, int] = {}
        self.repairs: Dict[str, int] = {}
        self.last_report: Optional[dict] = None

    # -- loop hooks ----------------------------------------------------------

    def note_promotion(self) -> None:
        """This instance just acquired the lease (wire to the elector's
        ``on_started_leading``): the next :meth:`on_round` runs a
        mandatory promotion sweep — exactly one per acquisition."""
        with self._lock:
            self._promotion_pending = True

    def sweep_due(self) -> bool:
        """Whether the NEXT :meth:`on_round` will run a sweep — consumed
        by the pipelined tick loop to quiesce (drain) the pipeline
        before a sweep ever reads the caches: an unretired tick's
        assumed-but-unpublished decisions would read as drift. Pure
        peek, consumes nothing."""
        with self._lock:
            if self._promotion_pending:
                return True
            return bool(
                self.interval_rounds
                and self._rounds_since + 1 >= self.interval_rounds
            )

    def on_round(self, now: Optional[float] = None) -> Optional[dict]:
        """One scheduling round is about to run. Runs the promotion
        sweep if one is pending (once per acquisition, not per round),
        else a periodic sweep every ``interval_rounds`` rounds. Returns
        the sweep report, or None when no sweep ran."""
        with self._lock:
            if self._promotion_pending:
                self._promotion_pending = False
                self._rounds_since = 0
                kind = "promotion"
            else:
                self._rounds_since += 1
                if self.interval_rounds and \
                        self._rounds_since >= self.interval_rounds:
                    self._rounds_since = 0
                    kind = "periodic"
                else:
                    return None
        # outside the lock (sweep re-acquires it for its own body): a
        # detection's flight dump does file I/O, and holding the RLock
        # across it would block status() readers and the pipelined
        # loop's sweep_due() quiesce check behind the disk
        report = self.sweep(kind, now=now)
        if kind == "promotion":
            # after the sweep's repairs (so the staged world is repaired
            # truth, not the deposed leader's leavings), stage the world
            # eagerly: the new leader's first solve skips the full
            # staging. The published last_report is replaced, never
            # mutated: a debug-mux reader serialising it must not see a
            # key inserted mid-iteration
            warm = self._warm_restore(now=now)
            report = dict(report)
            report["warm"] = warm
            with self._lock:
                self.last_report = report
        return report

    def _warm_restore(self, now: Optional[float] = None) -> Optional[dict]:
        """The promotion path's warm restore: the pool's entries (typed
        failures quarantined and counted, that shape left cold), then an
        eager prestage of the staged world. Never raises: a failed
        restore or prestage costs latency, never the round; its error is
        in the report."""
        out: dict = {}
        if self.warm_pool is not None:
            try:
                out["pool"] = self.warm_pool.restore(compile_missing=False)
            except Exception as e:
                out["pool"] = {"error": f"{type(e).__name__}: {e}"}
        model = getattr(self.scheduler, "model", None)
        cache = getattr(self.scheduler, "cache", None)
        if model is not None and cache is not None and \
                hasattr(model, "prestage"):
            try:
                t0 = time.perf_counter()
                times = model.prestage(cache.snapshot(now=now))
                out["prestage"] = {
                    "wall_s": time.perf_counter() - t0,
                    "times": times,
                }
            except Exception as e:
                out["prestage"] = {"error": f"{type(e).__name__}: {e}"}
        return out or None

    # -- the sweep -----------------------------------------------------------

    def sweep(self, kind: str = "manual", now: Optional[float] = None) -> dict:
        """One full pass over the three trust boundaries; detections
        and repairs are applied, counted, and returned as a report."""
        with self._lock:
            t0 = time.perf_counter()
            at = now if now is not None else time.time()
            report: dict = {
                "kind": kind, "at": at, "detections": {}, "repairs": {},
                "unrepaired": [], "probe_rows": [], "probe_skipped": 0,
            }

            def detect(boundary: str, dkind: str, detail: str) -> None:
                AUDIT_DETECTIONS.inc({"boundary": boundary, "kind": dkind})
                key = f"{boundary}/{dkind}"
                report["detections"][key] = (
                    report["detections"].get(key, 0) + 1
                )

            def repaired(action: str) -> None:
                AUDIT_REPAIRS.inc({"action": action})
                report["repairs"][action] = (
                    report["repairs"].get(action, 0) + 1
                )

            # 1. cache <-> bus
            rebuilt = False
            if self.bus is not None:
                drifts = self._diff_cache_bus(at)
                for dkind, detail, _fix in drifts:
                    detect("cache-bus", dkind, detail)
                if drifts:
                    if len(drifts) >= self.rebuild_threshold:
                        self._rebuild_from_bus()
                        rebuilt = True
                        repaired("cache-rebuild")
                    else:
                        for _dkind, _detail, fix in drifts:
                            if fix is not None:
                                fix()
                                repaired("targeted")

            # 2. accounting invariants (on the post-repair cache)
            viols = self._check_invariants()
            for vkind, detail, _fix in viols:
                detect("accounting", vkind, detail)
            fixerless = {
                (vkind, detail)
                for vkind, detail, fix in viols if fix is None
            }
            # escalation memory: violations a previous rebuild provably
            # could not repair (bus truth itself broken) must not drive
            # a full O(cluster) rebuild — and a Permit-hold reset — on
            # EVERY sweep while they persist; healed entries re-arm
            self._unrepairable &= fixerless
            if (
                fixerless - self._unrepairable
                and self.bus is not None
                and not rebuilt
            ):
                self._rebuild_from_bus()
                rebuilt = True
                repaired("cache-rebuild")
                # the rebuild invalidated every captured fix closure:
                # re-derive against the rebuilt cache before repairing
                viols = self._check_invariants()
            if rebuilt and fixerless:
                # anything fixerless that survived THIS sweep's rebuild
                # is provably rebuild-proof — arm the memory whichever
                # boundary triggered the rebuild (viols is post-rebuild
                # either way: phase 1 rebuilds run before the check,
                # the branch above re-derives)
                self._unrepairable |= fixerless & {
                    (vkind, detail)
                    for vkind, detail, fix in viols if fix is None
                }
            for _vkind, _detail, fix in viols:
                if fix is not None:
                    fix()
                    repaired("targeted")
            if viols:
                # re-verify: anything that survived the ladder is
                # reported loudly, never silently dropped
                report["unrepaired"] = [
                    f"{vkind}:{detail}"
                    for vkind, detail, _ in self._check_invariants()
                ]

            # 3. device <-> host parity probe
            probe, self._probe_cursor = self._parity_probe(
                self._probe_cursor
            )
            report["probe_rows"] = probe["rows"]
            report["probe_skipped"] = probe["skipped"]
            report["readback_s"] = probe["readback_s"]
            # which rows and fields drifted ("<node>:device:<field>"), for
            # the operator reading the report
            report["probe_mismatches"] = [
                f"{name}:{what}" for name, what in probe["mismatches"]]
            AUDIT_PROBE_ROWS.inc(amount=len(probe["rows"]))
            if probe["mismatches"]:
                for name, what in probe["mismatches"]:
                    if what == "structure":
                        dkind = "staged-structure-drift"
                    elif what.startswith("host:"):
                        dkind = "staged-host-drift"
                    else:
                        dkind = "staged-device-drift"
                    detect("device-parity", dkind, f"{name}:{what}")
                # the heaviest rung: forget the staged world, next
                # solve re-lowers + re-stages from scratch
                self.scheduler.model.staged_cache.invalidate()
                repaired("full-restage")

            total = sum(report["detections"].values())
            AUDIT_LAST_DRIFT.set(total)
            AUDIT_UNREPAIRED.set(len(report["unrepaired"]))
            AUDIT_SWEEPS.inc({"kind": kind})
            self.sweeps[kind] = self.sweeps.get(kind, 0) + 1
            for key, n in report["detections"].items():
                self.detections[key] = self.detections.get(key, 0) + n
            for action, n in report["repairs"].items():
                self.repairs[action] = self.repairs.get(action, 0) + n
            report["duration_s"] = time.perf_counter() - t0
            AUDIT_SWEEP_DURATION.observe(report["duration_s"])
            self.last_report = report
        if total:
            # anomaly: drift was detected — dump the flight recorder's
            # recent rounds before the repaired state overwrites the
            # evidence (outside the lock: the dump does file I/O)
            from koordinator_tpu_torch.obs.flight import FLIGHT
            from koordinator_tpu_torch.obs.trace import TRACER

            TRACER.instant("auditor-detection", cat="audit",
                           args={"detections": total, "kind": kind})
            FLIGHT.trigger(
                "auditor-detection",
                detail=f"{total} detection(s) in {kind} sweep",
                extra={"detections": report["detections"],
                       "repairs": report["repairs"],
                       "unrepaired": report["unrepaired"]},
            )
        return report

    def status(self) -> dict:
        """Debug-mux payload (registered as ``state-auditor`` beside
        the failover/supervisor services)."""
        with self._lock:
            return {
                "interval_rounds": self.interval_rounds,
                "probe_rows": self.probe_rows,
                "rebuild_threshold": self.rebuild_threshold,
                "sweeps": dict(self.sweeps),
                "detections": dict(self.detections),
                "repairs": dict(self.repairs),
                "unrepairable": sorted(
                    f"{k}:{d}" for k, d in self._unrepairable
                ),
                "last": self.last_report,
            }

    # -- boundary 1: cache <-> bus -------------------------------------------

    def _diff_cache_bus(self, now: float) -> List[Drift]:
        """Expected cache contents from bus truth vs the live cache.
        Repair closures route through the scheduler's own informer
        methods so every fix marks the delta tracker and re-runs the
        accounting side effects the original event would have."""
        from koordinator_tpu_torch.client.wiring import transform_node

        sched = self.scheduler
        cache = sched.cache
        drifts: List[Drift] = []

        # nodes (through the informer-level transform, or the trimmed
        # allocatable would read as drift every sweep)
        expected_nodes = {
            name: transform_node(node)
            for name, node in self.bus.list(Kind.NODE).items()
        }
        for name, want in expected_nodes.items():
            have = cache.nodes.get(name)
            if have is None:
                drifts.append(("missing-node", name,
                               lambda w=want: sched.add_node(w)))
            elif have != want:
                drifts.append(("stale-node", name,
                               lambda w=want: sched.add_node(w)))
        for name in list(cache.nodes):
            if name not in expected_nodes:
                drifts.append(("extra-node", name,
                               lambda n=name: sched.remove_node(n)))

        # node metrics
        bus_metrics = self.bus.list(Kind.NODE_METRIC)
        for name, want in bus_metrics.items():
            have = cache.node_metrics.get(name)
            if have is None:
                drifts.append(("missing-metric", name,
                               lambda w=want: sched.update_node_metric(w)))
            elif have != want:
                drifts.append(("stale-metric", name,
                               lambda w=want: sched.update_node_metric(w)))
        for name in list(cache.node_metrics):
            if name not in bus_metrics:
                drifts.append(("extra-metric", name,
                               lambda n=name: self._drop_metric(n)))

        # pods: placement truth is the load-bearing field
        bus_pods = {p.uid: p for p in self.bus.list(Kind.POD).values()}
        for uid, want in bus_pods.items():
            in_pods = cache.pods.get(uid)
            in_pending = cache.pending.get(uid)
            if want.node_name is not None and \
                    getattr(want, "waiting_permit", False):
                # an UNPUBLISHED Permit hold. Ours (tracked in _waiting)
                # is live local state, not drift. Anyone else's holder
                # is gone — a deposed leader's gang assume that never
                # published: adopting it as assigned would strand it
                # (no holds, never re-solved, capacity leaked), so
                # release it back to pending instead.
                if uid not in sched._waiting:
                    drifts.append(("orphan-permit-hold", uid,
                                   lambda u=uid:
                                   self._forget_permit_hold(u)))
                continue
            if in_pods is None and in_pending is None:
                drifts.append(("missing-pod", uid,
                               lambda w=want: sched.update_pod(w)))
                continue
            if want.node_name is not None:
                if in_pods is None or in_pods.node_name != want.node_name:
                    have = in_pods if in_pods is not None else in_pending
                    drifts.append(("stale-pod", uid,
                                   lambda h=have, w=want:
                                   self._readd_pod(h, w)))
            elif in_pods is not None:
                # the cache believes a bind the bus has no record of
                drifts.append(("stale-pod", uid,
                               lambda h=in_pods, w=want:
                               self._readd_pod(h, w)))
        for uid, have in (
            list(cache.pods.items()) + list(cache.pending.items())
        ):
            if uid not in bus_pods:
                drifts.append(("extra-pod", uid,
                               lambda h=have: sched.remove_pod(h)))

        # reservations
        bus_resv = self.bus.list(Kind.RESERVATION)
        for name, want in bus_resv.items():
            have = cache.reservations.get(name)
            if have is None:
                drifts.append(("missing-reservation", name,
                               lambda w=want: sched.update_reservation(w)))
            elif have != want:
                drifts.append(("stale-reservation", name,
                               lambda w=want: sched.update_reservation(w)))
        for name in list(cache.reservations):
            if name not in bus_resv:
                drifts.append(("extra-reservation", name,
                               lambda n=name: self._drop_reservation(n)))

        # gangs + quotas (no tracker marks — never in the node arrays)
        bus_gangs = self.bus.list(Kind.GANG)
        for name, want in bus_gangs.items():
            have = cache.gangs.get(name)
            if have is None or have != want:
                dkind = "missing-gang" if have is None else "stale-gang"
                drifts.append((dkind, name,
                               lambda w=want: sched.update_gang(w)))
        for name in list(cache.gangs):
            if name not in bus_gangs:
                drifts.append(("extra-gang", name,
                               lambda n=name: sched.remove_gang(n)))
        bus_quotas = self.bus.list(Kind.QUOTA)
        for name, want in bus_quotas.items():
            have = cache.quotas.get(name)
            if have is None or have != want:
                dkind = "missing-quota" if have is None else "stale-quota"
                drifts.append((dkind, name,
                               lambda w=want: sched.update_quota(w)))
        for name in list(cache.quotas):
            if name not in bus_quotas:
                drifts.append(("extra-quota", name,
                               lambda n=name: sched.remove_quota(n)))

        # assumes: orphaned entries and expired-but-lingering confirms
        for uid, at in list(cache.assumed.items()):
            pod = cache.pods.get(uid)
            if pod is None:
                drifts.append(("orphan-assume", uid,
                               lambda u=uid: cache.forget_pod(u)))
            elif (now - at) >= self.assume_ttl_s and \
                    not getattr(pod, "waiting_permit", False):
                want = bus_pods.get(uid)
                if want is not None and want.node_name == pod.node_name:
                    # the bind is bus-confirmed but the assume never
                    # finished — confirm it now instead of holding the
                    # "assumed" state forever
                    drifts.append(("lingering-assume", uid,
                                   lambda u=uid: cache.finish_binding(u)))
        return drifts

    def _forget_permit_hold(self, uid: str) -> None:
        """Release an orphaned Permit hold — an unpublished gang assume
        whose holder is gone (a deposed leader). The shared pod object
        returns to pending (with a tracker mark for the held node); the
        next round re-places the gang with full holds. No local
        accounting exists to release: this instance never held it."""
        sched = self.scheduler
        cache = sched.cache
        pod = cache.pods.get(uid)
        if pod is not None:
            cache.forget_pod(uid)  # resets node/waiting_permit + marks
        else:
            pod = cache.pending.get(uid)
            if pod is None:
                # not in the cache at all: reset the bus object, then
                # intake it as an ordinary pending pod
                bus_pod = None
                for p in self.bus.list(Kind.POD).values():
                    if p.uid == uid:
                        bus_pod = p
                        break
                if bus_pod is None:
                    return
                cache.delta_tracker.mark_node(bus_pod.node_name)
                bus_pod.node_name = None
                bus_pod.waiting_permit = False
                sched.update_pod(bus_pod)
            elif pod.node_name is not None:
                cache.delta_tracker.mark_node(pod.node_name)
                pod.node_name = None
                pod.waiting_permit = False
        sched.gang_manager.on_pod_forgotten(uid)

    def _readd_pod(self, have, want) -> None:
        """Stale placement: release the cached copy's holds through the
        full remove path, then re-enter the bus object as the informer
        would. (``update_pod`` alone would preserve the stale cached
        placement — its refresh path trusts the cache's node.)"""
        self.scheduler.remove_pod(have)
        self.scheduler.update_pod(want)

    def _drop_metric(self, name: str) -> None:
        self.scheduler.remove_node_metric(name)
        self.scheduler.cache.delta_tracker.mark_node(name)

    def _drop_reservation(self, name: str) -> None:
        resv = self.scheduler.cache.reservations.get(name)
        self.scheduler.remove_reservation(name)
        if resv is not None:
            self.scheduler.cache.delta_tracker.mark_node(resv.node_name)

    def _rebuild_from_bus(self) -> None:
        """The middle rung: drop the whole cache and re-derive it from
        bus truth through the same informer methods a fresh standby
        would use. Node add/removes mark the tracker's structure epoch,
        so the next solve full-relowers — the staged state heals with
        the cache.

        Permit-held (waiting) pods are RELEASED first, back to pending:
        their holds (quota used, fine-grained NUMA/device allocations,
        reservation credit) are local, unpublished state that cannot be
        reconstructed from bus truth — a half-restore would leak the
        quota accounting and double-allocate the released cpusets. The
        gang re-solves with full holds next round; a rebuild is a
        leadership-grade event and restarting the wait is the safe
        price."""
        from koordinator_tpu_torch.client.wiring import transform_node

        sched = self.scheduler
        cache = sched.cache
        for uid in list(sched._waiting):
            sched._release_waiting(uid)
            sched.gang_manager.on_pod_forgotten(uid)
        for pod in list(cache.pods.values()) + list(cache.pending.values()):
            sched.remove_pod(pod)
        for uid in list(cache.assumed):
            cache.forget_pod(uid)  # orphans: pods were all removed
        for name in list(cache.node_metrics):
            sched.remove_node_metric(name)
        for name in list(cache.reservations):
            sched.remove_reservation(name)
        for name in list(cache.gangs):
            sched.remove_gang(name)
        for name in list(cache.quotas):
            sched.remove_quota(name)
        for name in list(cache.nodes):
            sched.remove_node(name)
        for node in self.bus.list(Kind.NODE).values():
            sched.add_node(transform_node(node))
        for metric in self.bus.list(Kind.NODE_METRIC).values():
            sched.update_node_metric(metric)
        for name, topo in self.bus.list(
            Kind.NODE_RESOURCE_TOPOLOGY
        ).items():
            sched.update_node_topology(name, topo)
        for name, entries in self.bus.list(Kind.DEVICE).items():
            sched.update_node_devices(name, entries)
        for quota in self.bus.list(Kind.QUOTA).values():
            sched.update_quota(quota)
        for gang in self.bus.list(Kind.GANG).values():
            sched.update_gang(gang)
        for resv in self.bus.list(Kind.RESERVATION).values():
            sched.update_reservation(resv)
        for pod in self.bus.list(Kind.POD).values():
            sched.update_pod(pod)
        # post-rebuild, every remaining Permit hold is orphaned (our own
        # were released before the teardown): release, don't adopt
        for uid, pod in list(cache.pods.items()):
            if getattr(pod, "waiting_permit", False):
                self._forget_permit_hold(uid)

    # -- boundary 2: accounting invariants -----------------------------------

    def _check_invariants(self) -> List[Drift]:
        sched = self.scheduler
        cache = sched.cache
        viols: List[Drift] = []

        # no pod simultaneously pending and assigned
        for uid in sorted(set(cache.pods) & set(cache.pending)):
            def fix_double(u=uid):
                if self.bus is not None:
                    bus_pods = {
                        p.uid: p
                        for p in self.bus.list(Kind.POD).values()
                    }
                    have = cache.pods.get(u)
                    if have is not None:
                        sched.remove_pod(have)
                    want = bus_pods.get(u)
                    if want is not None:
                        sched.update_pod(want)
                else:
                    cache.pending.pop(u, None)  # the assigned copy wins
            viols.append(("double-placed", uid, fix_double))

        # per-node used <= allocatable (non-DaemonSet requests only:
        # DaemonSets bypass Fit by design)
        used: Dict[str, np.ndarray] = {}
        for pod in list(cache.pods.values()):
            if pod.node_name is None or pod.is_daemonset:
                continue
            vec = resources_to_vector(pod.requests)
            cur = used.get(pod.node_name)
            used[pod.node_name] = vec if cur is None else cur + vec
        for name in sorted(used):
            node = cache.nodes.get(name)
            if node is None:
                continue  # extra-pod/extra-node drift owns this case
            alloc = resources_to_vector(node.allocatable)
            if bool(np.any(used[name] > alloc)):
                # no targeted fix exists: which pod is the liar is
                # unknowable locally — escalate to a bus rebuild
                viols.append(("node-overcommit", name, None))

        # reservation credit <= reserved capacity
        for name in sorted(cache.reservations):
            resv = cache.reservations[name]
            cap = resources_to_vector(resv.allocatable or resv.requests)
            got = resources_to_vector(resv.allocated)
            if bool(np.any(got > cap)):
                def fix_resv(r=resv, c=cap, g=got):
                    r.allocated = vector_to_resources(np.minimum(g, c))
                    cache.delta_tracker.mark_node(r.node_name)
                viols.append(("resv-overcredit", name, fix_resv))

        # gang records in legal states
        for name in sorted(sched.gang_manager.gangs):
            record = sched.gang_manager.gangs[name]
            overlap = record.waiting & record.bound
            strays = (record.waiting | record.bound) - record.children
            if overlap or strays:
                def fix_gang(rec=record):
                    rec.waiting -= rec.bound  # bound wins the overlap
                    rec.waiting &= rec.children
                    rec.bound &= rec.children
                viols.append(("gang-illegal-state", name, fix_gang))
        return viols

    # -- boundary 3: device <-> host parity probe ------------------------

    def _parity_probe(self, cursor: int) -> Tuple[dict, int]:
        """Re-lower ``probe_rows`` staged rows from typed truth and
        compare bit-for-bit against the staged host and device arrays.
        Rows are taken round-robin from ``cursor`` — deterministic
        coverage of every row within ``ceil(n/probe_rows)`` sweeps.
        Rows dirty since the staged generation are skipped (they are
        LEGITIMATELY stale until the next solve re-lowers them)."""
        out: dict = {"rows": [], "skipped": 0, "mismatches": [],
                     "readback_s": 0.0}
        model = getattr(self.scheduler, "model", None)
        staged = getattr(model, "staged_cache", None)
        if staged is None or not self.probe_rows:
            return out, cursor
        arrays, state, tracker, seen_epoch, last_now = staged.audit_view()
        if arrays is None or tracker is None or last_now is None:
            return out, cursor  # nothing staged yet
        if tracker.structure_epoch > seen_epoch:
            return out, cursor  # full relower already pending
        names = arrays.names
        n = len(names)
        if n == 0:
            return out, cursor
        take = min(self.probe_rows, n)
        # the probe's truth is lowered at the staged generation's OWN
        # time base, so metric-freshness flips between solves can never
        # read as drift. Snapshot BEFORE reading the dirty set: a bus
        # update landing between the two then shows up as dirty and is
        # skipped (safe); the reverse order would compare new truth
        # against old staging and cry drift on a healthy row.
        snapshot = self.scheduler.cache.snapshot(now=last_now)
        dirty = set(tracker.dirty_since(seen_epoch))
        snap_names = {node.name for node in snapshot.nodes}
        probe_idx = [(cursor + i) % n for i in range(take)]
        cursor = (cursor + take) % n
        #: (position in probe_idx, row index, name) of comparable rows:
        #: dirty rows are legitimately stale until the next solve
        comparable: List[Tuple[int, int, str]] = []
        for pos, j in enumerate(probe_idx):
            name = names[j]
            if name in dirty:
                out["skipped"] += 1
                continue
            if name not in snap_names:
                # the node set changed without a structure mark: the
                # staged world's very shape is drifted
                out["mismatches"].append((name, "structure"))
                continue
            comparable.append((pos, j, name))
        if not comparable:
            return out, cursor
        probe_names = [name for _, _, name in comparable]
        out["rows"] = probe_names
        truth = lower_node_rows(
            snapshot, probe_names, **model.lowering_kwargs()
        )
        host_sel = np.asarray([j for _, j, _ in comparable], dtype=np.int64)
        dev = None
        if state is not None:
            # the one device -> host synchronisation of the control
            # plane: the compared rows, between rounds, never on the
            # solve path
            t0 = time.perf_counter()
            dev = read_back_rows(state, host_sel.tolist())
            out["readback_s"] = time.perf_counter() - t0
        # block compare per field; drill down per row only on mismatch
        # (the healthy sweep's fast path is 2 compares per field)
        for f in STAGED_NODE_FIELDS:
            want = truth[f]
            host = getattr(arrays, f)[host_sel]
            if not np.array_equal(host, want):
                for k, (_pos, _j, name) in enumerate(comparable):
                    if not np.array_equal(host[k], want[k]):
                        out["mismatches"].append((name, f"host:{f}"))
            if dev is not None and not np.array_equal(dev[f], want):
                for k, (_pos, _j, name) in enumerate(comparable):
                    if not np.array_equal(dev[f][k], want[k]):
                        out["mismatches"].append((name, f"device:{f}"))
        return out, cursor
