"""PlacementModel: typed snapshot in, committed placements out (counterpart
of ``koordinator_tpu/models/placement.py``).

One solve: lower the snapshot to int32 arrays on the host, stage them on
the device, build the gang, quota and reservation state and the host
extras rows, dispatch the solve (the hand-written kernel for eligible
solves, the per-pod loop otherwise), and read the result back once in
:meth:`InFlightSchedule.finalize`, which also books each consumed
reservation on its ``ReservationSpec``.

With a fine-grained manager (``fine``, ``models/finegrained.FineGrained``)
the pods it must place on the host allocators (cpusets, NUMA policies,
devices, host ports) are *special*: their host rows come from its
plugins, NUMA inventories ride the staged node state, and a propose ->
validate -> refine loop replays the solve's choices against the real
managers, re-solving with refreshed rows until they agree (at most
``MAX_SCORE_ITERS`` score-consistent rounds, then feasibility only).
Host rows (:class:`HostRows`) reach the solver in compact form: one row
per distinct (mask, score) pair, shared by the pods that have it.

A snapshot that carries a ``ClusterDeltaTracker`` (every snapshot of the
scheduler cache does) goes through :class:`StagedStateCache`: the host
node arrays and the staged ``NodeState`` live on between solves, and
each solve re-lowers and scatters only the rows the tracker marked (and
the rows whose metric crossed the expiration window). Without a tracker
the snapshot is lowered and staged in full; the results are identical.

The staging cache is a resident of the HBM working set
(``state/workingset.py``): its stagings and scatters run under the
demote-and-retry ladder, and it demotes to the host or cold rung under
budget pressure.

The host route for tiny solves: with ``host_fallback_cells`` above 0, a
plain solve (no quota, gang, extras, reservations or NUMA) of at most
that many node x pod cells runs the numpy oracle
``oracle/vectorized.schedule_vectorized`` on the host arrays the round
lowered (``last_solver`` "host"), bit for bit the kernel's answer, with
nothing staged (the round skips the staging cache's device half; the
next kernel round stages again), no kernel launch and no read-back. The
route is decided before staging. :func:`measure_host_fallback_cells`
finds the cutoff on a device by timing both routes; ``cmd/scheduler.
build_scheduler`` runs it at its default.

Not in this port yet, each queued in ROADMAP.md: sharded staging (no
mesh on one card), pod-shape, reservation-axis and victim-axis bucketing
(they share XLA compiles, which eager PyTorch does not have; results are
identical without them) and the kernel's cached reservation one-hot (the
CUDA kernel has none). A solve records the reference's ``lower``, ``stage``,
``dispatch``, ``device_solve`` and ``read_back`` spans into
``obs/trace.TRACER``, and :meth:`PlacementModel.prestage` its
``prestage`` span; the solve launch, the read-back and the prestage
carry the device observatory's ``annotate`` ranges (``obs/device.py``),
and the model registers its staged cache's bytes there as an owner. With
``backend`` (``service/client.RemoteSolver``) every solve goes to the
solver sidecar.

The joint place+evict (``select_victims_device``, ``preempt_scan_device``,
``plan_defrag_device``) runs ``ops/preempt.py`` on the model's device
over the resident world ``lower_residents`` lowers and
``resident_world`` stages.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.apis.extension import NUM_RESOURCES, PriorityClass
from koordinator_tpu_torch.obs.device import DEVICE_OBS, weak_owner
from koordinator_tpu_torch.obs.trace import TRACER
from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    GangMode,
    ReservationState,
    resources_to_vector,
    selector_matches,
    vector_to_resources,
)
from koordinator_tpu_torch.ops.binpack import (
    STAGED_NODE_FIELDS,
    ExtrasRows,
    NodeState,
    NumaAux,
    PodBatch,
    ResvArrays,
    ScoreParams,
    SolveResult,
    SolverConfig,
    scatter_node_rows,
    solve_batch,
)
from koordinator_tpu_torch.ops.binpack_kernel import (
    BASE_SCORE_WORST,
    SCORE_BUDGET,
    kernel_extras_score_safe,
    kernel_routing_ok,
    kernel_solve_batch,
    kernel_supported,
    resv_score_worst,
    weight_sum,
)
from koordinator_tpu_torch.ops.gang import GangState
from koordinator_tpu_torch.ops.preempt import (
    PreemptorBatch,
    ResidentWorld,
    headroom_repack,
    preempt_scan,
    select_victims,
)
from koordinator_tpu_torch.ops.quota import QuotaState
from koordinator_tpu_torch.oracle.vectorized import schedule_vectorized
from koordinator_tpu_torch.quota.core import GroupQuotaManager
from koordinator_tpu_torch.scheduler.plugins.nodeports import pod_host_ports
from koordinator_tpu_torch.scheduler.plugins.reservation import (
    is_reserve_pod,
    reservation_free,
)
from koordinator_tpu_torch.state.cluster import (
    DEFAULT_ESTIMATED_SCALING_FACTORS,
    AggregatedArgs,
    DEFAULT_RESOURCE_WEIGHTS,
    DEFAULT_USAGE_THRESHOLDS,
    NodeArrays,
    PendingPodArrays,
    ResidentPodArrays,
    clip_i32,
    lower_nodes,
    lower_nodes_delta,
    lower_pending_pods,
    lower_resident_pods,
)
from koordinator_tpu_torch.state.workingset import WORKING_SET


def measure_host_fallback_cells(config: SolverConfig = SolverConfig(),
                                rounds: int = 5, ceiling: int = 1 << 18,
                                device: DeviceLike = None) -> int:
    """The host/device cutoff in node x pod cells, measured on ``device``
    (``cuda`` unless given), once per device and arguments in a process.

    The host route costs about ``a`` a cell; a tiny solve on the device
    costs a fixed ``c`` (the launch and the read-back). Solves of fewer
    than ``c / a`` cells are faster on the host. ``a`` is the best of
    ``rounds`` runs of ``schedule_vectorized`` on ``testing.
    example_problem(64, 128, seed=1234)``, over its 8,192 cells, after a
    warm run; ``c`` the best of ``rounds`` device rounds of that problem
    (the solve ``PlacementModel._dispatch_solve`` runs on ``device``
    under ``config``, on CUDA the routed kernel's launch, and the
    read-back of ``assign``), after a warm round that loads the kernel
    library. Returns ``max(0, min(int(c / a), ceiling))``; the parts are
    kept in :data:`HOST_PROBES`, which a later call with the same
    arguments returns from."""
    from koordinator_tpu_torch.oracle.vectorized import oracle_args
    from koordinator_tpu_torch.testing import example_problem

    key = _probe_key(device, config, rounds, ceiling)
    with _PROBE_LOCK:
        cached = HOST_PROBES.get(key)
        if cached is not None:
            return cached["cells"]
        t_start = time.perf_counter()

        def best_of(fn):
            times = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            return min(times)

        n, p = 64, 128
        state, pods, params = example_problem(n, p, seed=1234,
                                              device=resolve_device(device))
        args = oracle_args(state, pods, params)
        schedule_vectorized(*args)  # warm
        per_cell = best_of(lambda: schedule_vectorized(*args)) / (n * p)
        model = PlacementModel(config=config, device=state.alloc.device)

        def device_round():
            model._dispatch_solve(state, pods, None, None, None).assign.cpu()

        device_round()  # loads the library
        device_best = best_of(device_round)
        cells = (0 if per_cell <= 0
                 else max(0, min(int(device_best / per_cell), ceiling)))
        HOST_PROBES[key] = {
            "device": state.alloc.device,
            "host_ns_per_cell": per_cell * 1e9,
            "device_best_ms": device_best * 1e3,
            "cells": cells,
            "wall_s": time.perf_counter() - t_start,
        }
        return cells


def _probe_key(device: DeviceLike, config: SolverConfig, rounds: int,
               ceiling: int) -> tuple:
    device = resolve_device(device)
    index = device.index
    if device.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return (device.type, index, config, rounds, ceiling)


def host_probe(device: DeviceLike = None,
               config: SolverConfig = SolverConfig(), rounds: int = 5,
               ceiling: int = 1 << 18) -> Optional[dict]:
    """What :func:`measure_host_fallback_cells` measured on ``device``
    (``cuda`` unless given) with these arguments in this process, or None
    before it ran."""
    return HOST_PROBES.get(_probe_key(device, config, rounds, ceiling))


#: one probe per device (type, index), config, rounds and ceiling a
#: process: the device its round ran on, the host's ns per cell, the
#: device round's best ms, the cutoff and the probe's wall
HOST_PROBES: Dict[tuple, dict] = {}
_PROBE_LOCK = threading.Lock()


def _vec(mapping) -> np.ndarray:
    out = np.zeros(NUM_RESOURCES, dtype=np.int32)
    for k, v in mapping.items():
        out[int(k)] = v
    return out


class HostRows:
    """A solve's host extras rows in compact form: pod ``i`` reads row
    ``row_of_pod[i]`` (-1: no row, every node feasible, score 0); pods
    whose (mask, score) rows are equal share one row. Rows are keyed by
    content, so a pod whose row changes (the refine loop) moves to the
    row of its new content; :meth:`arrays` keeps only the rows in use."""

    def __init__(self, n_pods: int, n_nodes: int):
        self.n_nodes = n_nodes
        self.row_of_pod = np.full(n_pods, -1, np.int32)
        self.masks: List[np.ndarray] = []
        self.scores: List[np.ndarray] = []
        self._by_content: Dict[bytes, int] = {}

    def __bool__(self) -> bool:
        return bool((self.row_of_pod >= 0).any())

    def assign(self, i: int, mask: np.ndarray, score: np.ndarray) -> None:
        """Pod ``i``'s row is now ``(mask [N] bool, score [N] int32)``."""
        mask = np.ascontiguousarray(mask, dtype=bool)
        score = np.ascontiguousarray(score, dtype=np.int32)
        key = mask.tobytes() + score.tobytes()
        row = self._by_content.get(key)
        if row is None:
            row = len(self.masks)
            self.masks.append(mask)
            self.scores.append(score)
            self._by_content[key] = row
        self.row_of_pod[i] = row

    def get(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pod ``i``'s ``(mask, score)`` (all True and 0 without a row);
        read-only views."""
        row = int(self.row_of_pod[i])
        if row < 0:
            return (np.ones(self.n_nodes, bool),
                    np.zeros(self.n_nodes, np.int32))
        return self.masks[row], self.scores[row]

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(row_of_pod [P], mask [X,N], score [X,N])`` over the rows
        some pod reads, renumbered in first-use order."""
        used = np.unique(self.row_of_pod[self.row_of_pod >= 0])
        # one slot more, left at -1: row -1 (no row) maps to it
        remap = np.full(len(self.masks) + 1, -1, np.int32)
        remap[used] = np.arange(used.size, dtype=np.int32)
        n = self.n_nodes
        mask = (np.stack([self.masks[r] for r in used]) if used.size
                else np.zeros((0, n), bool))
        score = (np.stack([self.scores[r] for r in used]) if used.size
                 else np.zeros((0, n), np.int32))
        return remap[self.row_of_pod], mask, score


class ScheduleResult(Dict[str, Optional[str]]):
    """The ``{pod uid: node name | None}`` mapping of committed (bindable)
    placements. ``waiting`` holds placed NonStrict gang members that keep
    their node at the Permit barrier and must not be bound yet.
    ``resv_allocs`` (waiting pods) and ``resv_committed`` (committed pods)
    map a pod uid to ``(reservation name, delta vector)``: the
    reservation it consumed, so a caller can roll the consumption back.
    ``fine_states`` maps a waiting pod's uid to ``(node name,
    CycleState)``: its fine-grained holds, applied but not yet annotated
    (PreBind runs when its Permit barrier opens). ``nominations`` is
    filled by the Scheduler's preemption."""

    def __init__(self, assignments, waiting=None, resv_allocs=None,
                 resv_committed=None, fine_states=None):
        super().__init__(assignments)
        #: preemptors whose victims this round evicted: uid -> the node
        #: they were nominated to (they bind in a later round)
        self.nominations: Dict[str, str] = {}
        self.waiting: Dict[str, str] = dict(waiting or {})
        self.fine_states: Dict[str, tuple] = dict(fine_states or {})
        self.resv_allocs: Dict[str, tuple] = dict(resv_allocs or {})
        self.resv_committed: Dict[str, tuple] = dict(resv_committed or {})


def _apply_reservations(resv_specs, vstar, delta, pods_in_order, commit,
                        waiting, tracker=None) -> Tuple[dict, dict]:
    """Book each kept pod's reservation consumption on its
    ``ReservationSpec`` (allocated += delta, the pod's uid appended, an
    ``allocate_once`` reservation Succeeded), as the incremental Reserve
    does, and mark the reservation's node on ``tracker``: its lowered
    hold changed. Returns ``(resv_allocs, resv_committed)``."""
    keep = commit | waiting
    allocs: Dict[str, tuple] = {}
    committed: Dict[str, tuple] = {}
    for i, pod in enumerate(pods_in_order):
        v = int(vstar[i])
        if v < 0 or not keep[i]:
            continue
        spec = resv_specs[v]
        cur = resources_to_vector(spec.allocated)
        spec.allocated = vector_to_resources(cur + delta[i])
        spec.allocated_pod_uids.append(pod.uid)
        if spec.allocate_once:
            spec.state = ReservationState.SUCCEEDED
        book = allocs if waiting[i] else committed
        book[pod.uid] = (spec.name, delta[i].copy())
        if tracker is not None:
            tracker.mark_node(spec.node_name)
    return allocs, committed


class InFlightSchedule:
    """A dispatched solve that has not been read back. On CUDA the kernel
    runs asynchronously; :meth:`finalize` is the one read-back point.
    ``pinned`` is the staging cache's generation the solve reads, held
    against in-place scatters until :meth:`finalize` releases it."""

    def __init__(self, result, node_names, pod_uids, t_staged, timings,
                 resv_specs=None, pods_in_order=None, cache=None,
                 pinned=None, tracker=None, fine=None, applied=(),
                 snapshot=None, node_by_name=None):
        self.result = result
        self.node_names = node_names
        self.pod_uids = pod_uids
        self.t_staged = t_staged
        self.timings = timings
        self.resv_specs = resv_specs
        self.pods_in_order = pods_in_order
        self.cache = cache
        self.pinned = pinned
        self.tracker = tracker
        #: the fine-grained manager and the holds its validate loop
        #: applied: (pod index, node name, CycleState)
        self.fine = fine
        self.applied = list(applied)
        self.snapshot = snapshot
        self.node_by_name = node_by_name
        self._final: Optional[ScheduleResult] = None

    def finalize(self) -> ScheduleResult:
        """Read the solve back (blocking until the device is done) and
        build the typed result. Idempotent."""
        if self._final is not None:
            return self._final
        result = self.result
        t_readback = time.perf_counter()
        # names this transfer in an open profiler window with the label
        # the span below carries
        with DEVICE_OBS.annotate("read_back"):
            assignments = result.assign.cpu().numpy()
            commit = result.commit.cpu().numpy()
            waiting = result.waiting.cpu().numpy()
        t_done = time.perf_counter()
        # retro spans from the timestamps taken anyway: the device span
        # covers dispatch to read-back, the read-back span the copy alone
        TRACER.emit("device_solve", cat="device", t0=self.t_staged, t1=t_done)
        TRACER.emit("read_back", cat="device", t0=t_readback, t1=t_done)
        # the fine-grained epilogue: gang-rejected holds roll back,
        # committed pods are annotated (PreBind), waiting pods keep their
        # holds for the scheduler to annotate when the barrier opens
        fine_states: Dict[str, tuple] = {}
        if self.applied:
            rejected = result.rejected.cpu().numpy()
            for i, node_name, cstate in self.applied:
                pod = self.pods_in_order[i]
                node = self.node_by_name[node_name]
                if rejected[i]:
                    self.fine.rollback(self.snapshot, pod, node, cstate)
                elif commit[i]:
                    self.fine.pre_bind(self.snapshot, pod, node, cstate)
                else:
                    fine_states[pod.uid] = (node_name, cstate)
        resv_allocs = resv_committed = None
        if self.resv_specs is not None:
            resv_allocs, resv_committed = _apply_reservations(
                self.resv_specs, result.resv_vstar.cpu().numpy(),
                result.resv_delta.cpu().numpy(), self.pods_in_order, commit,
                waiting, self.tracker)
        self.timings["solve_s"] = time.perf_counter() - self.t_staged
        names = self.node_names
        self._final = ScheduleResult(
            assignments={
                uid: (names[a] if c else None)
                for uid, a, c in zip(self.pod_uids, assignments, commit)
            },
            waiting={
                uid: names[a]
                for uid, a, w in zip(self.pod_uids, assignments, waiting)
                if w
            },
            resv_allocs=resv_allocs,
            resv_committed=resv_committed,
            fine_states=fine_states,
        )
        if self.pinned is not None:
            self.cache.unpin(self.pinned)
        return self._final


class NodeStagingDelta:
    """How the staged node state last changed. ``base_epoch`` None means
    it was rebuilt from scratch; otherwise ``idx``/``rows`` carry the row
    update that takes a holder of ``base_epoch`` to ``epoch`` (what a
    remote solver would be sent in place of the world)."""

    __slots__ = ("epoch", "base_epoch", "idx", "rows")

    def __init__(self, epoch: int, base_epoch: Optional[int] = None,
                 idx: Optional[np.ndarray] = None,
                 rows: Optional[Dict[str, np.ndarray]] = None):
        self.epoch = epoch
        self.base_epoch = base_epoch
        self.idx = idx
        self.rows = rows


def merge_staging_deltas(prev: Optional[NodeStagingDelta],
                         new: NodeStagingDelta) -> NodeStagingDelta:
    """Fold ``new`` onto an untaken ``prev``, so one delta covers every
    ``ensure`` since the last take: rows unioned, the later write of a
    row winning; a full restage (``base_epoch`` None) resets the chain."""
    if new.base_epoch is None or prev is None:
        return new
    if prev.base_epoch is None:
        # an untaken full restage already holds everything after it
        return NodeStagingDelta(new.epoch)
    if new.idx is None or new.idx.size == 0:
        return NodeStagingDelta(new.epoch, prev.base_epoch, prev.idx,
                                prev.rows)
    if prev.idx is None or prev.idx.size == 0:
        return NodeStagingDelta(new.epoch, prev.base_epoch, new.idx,
                                new.rows)
    combined = np.concatenate([prev.idx, new.idx])
    # the last occurrence of each index wins
    _, first_in_rev = np.unique(combined[::-1], return_index=True)
    sel = np.sort(combined.size - 1 - first_in_rev)
    rows = {f: np.concatenate([prev.rows[f], new.rows[f]])[sel]
            for f in prev.rows}
    return NodeStagingDelta(new.epoch, prev.base_epoch, combined[sel], rows)


def _staged_estimate(arrays: Optional[NodeArrays]) -> int:
    """Bytes a staging of ``arrays`` is about to put on the device (the
    working set's admission estimate: the staged columns' host bytes)."""
    if arrays is None:
        return 0
    return int(sum(getattr(arrays, f).nbytes for f in STAGED_NODE_FIELDS
                   if getattr(arrays, f, None) is not None))


class StagedStateCache:
    """The staged cluster state, kept across solves.

    A steady scheduling round changes a few node rows (metric reports,
    binds, reservation changes), but a full path re-lowers every node in
    Python and re-uploads the ``[N, R]`` world. This cache keeps both
    halves: the host :class:`NodeArrays`, patched in place by
    ``state.cluster.lower_nodes_delta`` (the rows the snapshot's tracker
    marked), and the staged ``NodeState``, updated by
    ``ops.binpack.scatter_node_rows``.

    It lowers and stages in full when the snapshot has no tracker or
    another tracker than last time, when the node set or order changed
    (``mark_structure``), and after :meth:`invalidate`.

    Generations: while a dispatched solve holds the staged generation
    (:meth:`pin`), the scatter writes a new generation beside it instead
    of into it; an unpinned generation is written in place. Stream order
    alone would protect the kernel's reads, but not a solve output that
    aliases a staged tensor and is read at ``finalize``.

    Every cache is a resident of the HBM working set
    (``state/workingset.WORKING_SET``, system lane): each full staging,
    host-rung restage and delta scatter runs under its ``run_staged``
    demote-and-retry ladder, and :meth:`demote_device` /
    :meth:`demote_cold` are its rungs. Placements are the same at every
    rung."""

    def __init__(self, model: "PlacementModel"):
        self.model = model
        self.arrays: Optional[NodeArrays] = None   # host, patched in place
        self.state: Optional[NodeState] = None     # staged, before a solve
        self.tracker = None
        self.seen_epoch = -1
        #: version of the staged state (a remote delta's sync point)
        self.epoch = 0
        self.last_delta: Optional[NodeStagingDelta] = None
        self.last_path: Optional[str] = None       # "full" | "delta"
        #: snapshot.now of the last ensure(): the time base of the
        #: cached ``metric_fresh`` column
        self.last_now: Optional[float] = None
        self._pinned: Optional[NodeState] = None
        self._wire_delta: Optional[NodeStagingDelta] = None
        # ensure()'s compound update (host patch, scatter, epochs) is
        # atomic under this lock; one model is driven by one loop
        self._lock = threading.Lock()
        #: the HBM working-set registration: the in-process staged
        #: cluster rides the system lane, so it demotes after every
        #: tenant world
        self._ws_key = WORKING_SET.register_auto(
            "staged", self, tenant="_model", lane="system")

    def ensure(self, snapshot: ClusterSnapshot, want_device: bool = True
               ) -> Tuple[NodeArrays, Optional[NodeState], Dict[str, float],
                          Tuple[int, Optional[NodeStagingDelta]]]:
        """``(host arrays, staged state, {"lower_s", "stage_s"}, (epoch,
        delta))`` for this snapshot, incrementally when its tracker
        allows. ``want_device=False`` keeps only the host half current
        (the staged state is then None, and is staged again from the host
        arrays the next time it is wanted)."""
        out = self._ensure(snapshot, want_device)
        # the residency touch runs after the cache lock is released: the
        # manager reprices through device_bytes() (which takes it) and
        # may demote other residents; this cache is the protected key
        WORKING_SET.touch(self._ws_key)
        return out

    def _ensure(self, snapshot, want_device):
        with self._lock:
            tracker = snapshot.delta_tracker
            # sync to the epoch captured when the snapshot was taken: a
            # mark racing in after it is re-lowered next time; the live
            # epoch serves producers that mutate their snapshot in place
            epoch_now = snapshot.delta_epoch
            if epoch_now is None and tracker is not None:
                epoch_now = tracker.epoch
            t0 = time.perf_counter()
            if (tracker is not None and tracker is self.tracker
                    and self.arrays is not None
                    and tracker.structure_epoch <= self.seen_epoch):
                idx = lower_nodes_delta(
                    snapshot, self.arrays,
                    tracker.dirty_since(self.seen_epoch),
                    **self.model.lowering_kwargs())
                if idx is not None:
                    return self._delta(snapshot, epoch_now, idx, want_device,
                                       t0)
            if epoch_now is None:
                epoch_now = -1
            arrays = lower_nodes(snapshot, **self.model.lowering_kwargs())
            t1 = time.perf_counter()
            state = None
            if want_device:
                # also the cold-rung restage: re-lowered from typed truth
                # above, staged under the admission contract here
                state = WORKING_SET.run_staged(
                    self._ws_key, "stage",
                    lambda: self.model.stage_nodes(arrays),
                    estimate=_staged_estimate(arrays))
            self.arrays = arrays
            self.state = state
            self.tracker = tracker
            self.seen_epoch = epoch_now
            self.last_now = snapshot.now
            self.epoch += 1
            self.last_delta = NodeStagingDelta(self.epoch)
            self._wire_delta = self.last_delta
            self.last_path = "full"
            return arrays, state, {
                "lower_s": t1 - t0,
                "stage_s": time.perf_counter() - t1,
            }, (self.epoch, self.last_delta)

    def _delta(self, snapshot, epoch_now, idx, want_device, t0):
        """The rest of a delta ``ensure``, the host rows in ``idx``
        already patched."""
        self.seen_epoch = epoch_now
        self.last_now = snapshot.now
        t1 = time.perf_counter()
        base = self.epoch
        rows = {}
        if idx.size:
            rows = {f: np.ascontiguousarray(getattr(self.arrays, f)[idx])
                    for f in STAGED_NODE_FIELDS}
            if want_device and self.state is not None:
                dev = self.model.device
                cur = self.state
                # the second allocation boundary; an in-place scatter
                # retried after a failure writes the same rows again
                self.state = WORKING_SET.run_staged(
                    self._ws_key, "scatter",
                    lambda: scatter_node_rows(
                        cur,
                        torch.as_tensor(idx.astype(np.int64), device=dev),
                        {f: torch.as_tensor(a, device=dev)
                         for f, a in rows.items()},
                        in_place=cur is not self._pinned))
            else:
                self.state = None  # the staged half is stale
            self.epoch += 1
        self.last_delta = NodeStagingDelta(self.epoch, base, idx, rows)
        self._wire_delta = merge_staging_deltas(self._wire_delta,
                                                self.last_delta)
        if want_device and self.state is None:
            # stage again from the current host arrays (content unchanged,
            # so the epoch does not move): also the working set's
            # host-rung restage, headroom admitted first
            host_arrays = self.arrays
            self.state = WORKING_SET.run_staged(
                self._ws_key, "stage",
                lambda: self.model.stage_nodes(host_arrays),
                estimate=_staged_estimate(host_arrays))
        self.last_path = "delta"
        return self.arrays, self.state, {
            "lower_s": t1 - t0,
            "stage_s": time.perf_counter() - t1,
        }, (self.epoch, self.last_delta)

    def invalidate(self) -> None:
        """Forget the staged world: the next ``ensure`` lowers and stages
        in full. The epoch stays monotone."""
        with self._lock:
            self.arrays = None
            self.state = None
            self.tracker = None
            self.seen_epoch = -1
            self.last_delta = None
            self.last_path = None
            self.last_now = None
            self._wire_delta = None

    def take_wire_delta(self) -> Optional[Tuple[int, NodeStagingDelta]]:
        """Pop the ``(epoch, delta)`` that covers every ``ensure`` since
        the last take."""
        with self._lock:
            delta = self._wire_delta
            self._wire_delta = None
            return None if delta is None else (self.epoch, delta)

    def pin(self, state: Optional[NodeState]) -> None:
        """``state`` is held by a dispatched solve: until :meth:`unpin`,
        a delta ``ensure`` writes a new generation instead of into it."""
        with self._lock:
            self._pinned = state

    def unpin(self, state: Optional[NodeState]) -> None:
        """The solve holding ``state`` was read back (identity-checked, so
        a stale unpin cannot release a newer pin)."""
        with self._lock:
            if self._pinned is state:
                self._pinned = None

    def demote_device(self) -> bool:
        """Working-set rung 1 (device -> host): drop the staged
        generation, keep the host arrays, tracker and epoch; the next
        ``ensure`` stages again from them, bit-identical, without moving
        the epoch. Refuses (False), without waiting, a cache mid-solve
        (lock held) or one whose generation a dispatched solve holds
        (pinned): the delta scatter writes in place, and a solve must
        never read rows whose tensors were dropped under it."""
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if self.state is None or self._pinned is not None:
                return False
            self.state = None
            return True
        finally:
            self._lock.release()

    def demote_cold(self) -> bool:
        """Working-set rung 2 (host -> cold): drop the host half too; the
        next ``ensure`` lowers from typed truth (the full path). The
        epoch stays monotone, as in :meth:`invalidate`. Non-blocking and
        pin-refusing like :meth:`demote_device`."""
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if self._pinned is not None:
                return False
            if self.arrays is None and self.state is None:
                return False
            self.arrays = None
            self.state = None
            self.tracker = None
            self.seen_epoch = -1
            self.last_delta = None
            self.last_path = None
            self.last_now = None
            self._wire_delta = None
            return True
        finally:
            self._lock.release()

    def device_bytes(self) -> int:
        """Bytes of the staged generations held: the current one and a
        pinned one beside it (the working set's price)."""
        with self._lock:
            generations = [self.state]
            if self._pinned is not None and self._pinned is not self.state:
                generations.append(self._pinned)
        return sum(t.nbytes for gen in generations if gen is not None
                   for t in gen if t is not None)

    def audit_view(self):
        """``(arrays, state, tracker, seen_epoch, last_now)`` captured
        under the cache lock: a settled generation for a parity probe."""
        with self._lock:
            return (self.arrays, self.state, self.tracker, self.seen_epoch,
                    self.last_now)


def _match_matrix(specs, pods) -> np.ndarray:
    """``[P, V]`` bool owner match of Available, bound reservations
    (``specs``) against pending pods: ``reservation_matches_pod`` for
    every pair, through a pod-uid index and a label index instead of a
    P x V walk."""
    match = np.zeros((len(pods), len(specs)), bool)
    by_uid: Dict[str, List[int]] = {}
    by_label: Dict[tuple, set] = {}
    for i, pod in enumerate(pods):
        if is_reserve_pod(pod):
            continue
        by_uid.setdefault(pod.uid, []).append(i)
        for pair in pod.labels.items():
            by_label.setdefault(pair, set()).add(i)
    for v, resv in enumerate(specs):
        if resv.state != ReservationState.AVAILABLE or resv.node_name is None:
            rows = []
        elif resv.owner_pod_uids:
            rows = [i for uid in set(resv.owner_pod_uids)
                    for i in by_uid.get(uid, ())]
        elif resv.owner_labels:
            sets = [by_label.get(pair, set())
                    for pair in resv.owner_labels.items()]
            rows = list(set.intersection(*sets))
        else:
            rows = []
        match[np.asarray(rows, dtype=np.int64), v] = True
    return match


class PlacementModel:
    """Batched placement on one device (``cuda`` unless ``device`` says
    otherwise)."""

    #: score-consistent refinement rounds before the extras scores freeze
    MAX_SCORE_ITERS = 8

    def __init__(
        self,
        config: SolverConfig = SolverConfig(),
        resource_weights=None,
        usage_thresholds=None,
        prod_usage_thresholds=None,
        aggregated: Optional[AggregatedArgs] = None,
        scaling_factors=None,
        device: DeviceLike = None,
        fine=None,
        backend=None,
        host_fallback_cells: int = 0,
    ):
        self.device = resolve_device(device)
        #: a remote solve backend (``service/client.RemoteSolver``, the
        #: sidecar boundary), or None: solve in-process
        self.backend = backend
        #: plain solves of at most this many node x pod cells take the
        #: host route (the numpy oracle on the round's host arrays): at
        #: tiny shapes a launch and a read-back cost more than the whole
        #: solve. 0 = off (the default; ``cmd/scheduler.build_scheduler``
        #: measures a cutoff)
        self.host_fallback_cells = host_fallback_cells
        #: the fine-grained manager (``models/finegrained.FineGrained``),
        #: or None; a Scheduler binds its own
        self.fine = fine
        self.config = config
        self.resource_weights = dict(resource_weights or DEFAULT_RESOURCE_WEIGHTS)
        self.scaling_factors = dict(
            scaling_factors or DEFAULT_ESTIMATED_SCALING_FACTORS
        )
        #: the LoadAware aggregated (percentile) mode: with its filter
        #: side on, the filter threshold set is the aggregated one and the
        #: lowering substitutes the percentile usage (load_aware.go:157-186)
        self.aggregated = aggregated
        if aggregated is not None and aggregated.filter_enabled:
            filter_thresholds = aggregated.usage_thresholds
        else:
            filter_thresholds = usage_thresholds or DEFAULT_USAGE_THRESHOLDS
        #: the dict forms, so the plugin chain is configured identically
        self.usage_thresholds = dict(filter_thresholds)
        self.prod_usage_thresholds = dict(prod_usage_thresholds or {})

        def put(mapping):
            return torch.as_tensor(_vec(mapping), device=self.device)

        self.params = ScoreParams(
            weights=put(self.resource_weights),
            thresholds=put(self.usage_thresholds),
            prod_thresholds=put(self.prod_usage_thresholds),
        )
        #: the same parameters as host arrays, for the host route
        self._host_params = (_vec(self.resource_weights),
                             _vec(self.usage_thresholds),
                             _vec(self.prod_usage_thresholds))
        #: static per-model kernel eligibility and score divisor (params
        #: and config are fixed)
        self._kernel_eligible = kernel_supported(self.params, self.config)
        self._wsum = weight_sum(self.params)
        #: which path the last solve took: "kernel", "loop", "host", or
        #: with a backend "remote" (or the backend's own ``last_mode``)
        self.last_solver: Optional[str] = None
        #: wall-time breakdown of the last schedule(): lower_s, stage_s,
        #: solve_s (solve_s is filled at read-back)
        self.last_timings: Optional[Dict[str, float]] = None
        #: the staged node state reused across solves of snapshots that
        #: carry a delta tracker
        self.staged_cache = StagedStateCache(self)
        # live-buffer attribution: the observatory reports how much of
        # the device memory is the staged world (through a weak
        # reference: it must never keep a torn-down model's state alive)
        DEVICE_OBS.register_owner("staged_cache", weak_owner(
            self.staged_cache, StagedStateCache.device_bytes))
        #: how the last solve staged its nodes: the cache's "full" or
        #: "delta", or None (no tracker: lowered and staged in full)
        self.last_staging: Optional[str] = None
        #: the staging cache's (epoch, delta) taken by the last solve
        #: (the sync point a remote solver would be sent)
        self.staging_delta = None
        #: the last solve staged NUMA inventories (restaged in full, so
        #: the next ensure skips the cache's device half)
        self._numa_staging = False

    # -- staging ------------------------------------------------------------

    def reset_staging(self) -> None:
        """Drop the staged state: the next solve lowers and stages in
        full."""
        self.staged_cache.invalidate()

    def lowering_kwargs(self) -> dict:
        """The ``lower_nodes`` configuration this model schedules with,
        shared with the plugin chain and the preemption path so every
        consumer lowers identically."""
        return {"scaling_factors": self.scaling_factors,
                "resource_weights": self.resource_weights,
                "aggregated": self.aggregated}

    def prestage(self, snapshot: ClusterSnapshot
                 ) -> Optional[Dict[str, float]]:
        """Bring the staging cache up to ``snapshot`` ahead of its solve
        (while an earlier solve may still run: a pinned generation is
        never written). Returns ``ensure``'s timings, or None when the
        snapshot has no tracker."""
        if snapshot.delta_tracker is None:
            return None
        t0 = TRACER.now()
        with DEVICE_OBS.annotate("prestage"):
            _, _, times, _ = self.staged_cache.ensure(
                snapshot, want_device=not (self._numa_staging
                                           or self._host_sized(snapshot)))
        # the overlap window's span: in a pipelined run it crosses the
        # publisher track's device_solve span
        TRACER.emit("prestage", cat="stage", t0=t0,
                    args={"for_round": TRACER.round_id + 1})
        return times

    def stage_nodes(self, arrays: NodeArrays, numa_cap=None,
                    numa_free=None) -> NodeState:
        """Copy host node arrays (and the NUMA inventories, when given) to
        the model's device. Always a copy, on the CPU too: the staging
        cache patches the host arrays in place, and a staged tensor that
        shared their memory would change with no scatter."""
        def put(a):
            return torch.tensor(a, device=self.device)

        return NodeState(
            alloc=put(arrays.alloc),
            used_req=put(arrays.used_req),
            usage=put(arrays.usage),
            prod_usage=put(arrays.prod_usage),
            est_extra=put(arrays.est_extra),
            prod_base=put(arrays.prod_base),
            metric_fresh=put(arrays.metric_fresh),
            schedulable=put(arrays.schedulable),
            numa_cap=None if numa_cap is None else put(numa_cap),
            numa_free=None if numa_free is None else put(numa_free),
        )

    def stage_pods(self, arrays: PendingPodArrays, blocked=None,
                   has_numa_policy=None) -> PodBatch:
        """Copy host pending-pod arrays to the model's device."""
        def put(a):
            return torch.as_tensor(a, device=self.device)

        return PodBatch.build(
            req=put(arrays.req),
            est=put(arrays.est),
            is_prod=put(arrays.is_prod),
            is_daemonset=put(arrays.is_daemonset),
            quota_id=put(arrays.quota_id),
            non_preemptible=put(arrays.non_preemptible),
            gang_id=put(arrays.gang_id),
            blocked=None if blocked is None else put(blocked),
            has_numa_policy=(None if has_numa_policy is None
                             else put(has_numa_policy)),
        )

    # -- joint place+evict (ops/preempt.py) ----------------------------------

    def lower_residents(self, snapshot: ClusterSnapshot,
                        arrays: NodeArrays) -> ResidentPodArrays:
        """Lower the assigned-pod world for victim selection. The P axis
        is not padded: eager torch shares no compiled program across
        widths, and padding is inert (a test pins it)."""
        return lower_resident_pods(snapshot, arrays)

    def resident_world(self, resident: ResidentPodArrays) -> ResidentWorld:
        """Stage the resident world on the model's device, once per
        preemption round. Between evictions only ``valid`` shrinks: the
        ``*_device`` methods take the staged world back and restage just
        that mask. Always copies (evictions write the host arrays)."""
        put = self._put
        return ResidentWorld(req=put(resident.req),
                             priority=put(resident.priority),
                             quota_id=put(resident.quota_id),
                             preemptible=put(resident.preemptible),
                             valid=put(resident.valid))

    def _put(self, a) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def _current_world(self, resident, world) -> ResidentWorld:
        if world is None:
            return self.resident_world(resident)
        return world._replace(valid=self._put(resident.valid))

    def _victim_uids(self, resident, node_index: int, mask) -> List[str]:
        uids = resident.uids[node_index]
        return [uids[j] for j in range(min(len(uids), mask.shape[0]))
                if mask[j]]

    def select_victims_device(
        self,
        arrays: NodeArrays,
        resident: ResidentPodArrays,
        pod,
        quota_used=None,
        used_limit=None,
        world: Optional[ResidentWorld] = None,
    ) -> Optional[Tuple[str, List[str]]]:
        """One preemptor against the whole cluster on the device: ``(node
        name, victim uids in importance order)``, the oracle's
        ``find_preemption`` answer, or None. ``quota_used``/``used_limit``
        arm the ElasticQuota reprieve gate (both None: a pod no quota
        manages, the gate off, as the oracle). Reads back the winner and
        its row only."""
        world = self._current_world(resident, world)
        quota_on = quota_used is not None and used_limit is not None
        zeros = np.zeros(NUM_RESOURCES, dtype=np.int64)
        put = self._put
        best, victims, _, _ = select_victims(
            put(clip_i32(resources_to_vector(pod.requests))),
            put(np.int32(pod.priority)),
            put(np.int32(resident.quota_id_of(pod.quota))),
            put(bool(pod.is_daemonset)),
            put(pod.priority_class == PriorityClass.PROD),
            put(clip_i32(zeros if quota_used is None
                         else np.asarray(quota_used))),
            put(clip_i32(zeros if used_limit is None
                         else np.asarray(used_limit))),
            put(quota_on),
            put(arrays.alloc), put(arrays.used_req), put(arrays.usage),
            put(arrays.prod_usage), put(arrays.metric_fresh),
            put(arrays.schedulable), put(resident.node_rank),
            self.params.thresholds, self.params.prod_thresholds, world)
        b = int(best)
        if b < 0:
            return None
        row = victims[b].cpu().numpy()
        return arrays.names[b], self._victim_uids(resident, b, row)

    def preempt_scan_device(
        self,
        arrays: NodeArrays,
        resident: ResidentPodArrays,
        pods,
        quota_rows=None,
        world: Optional[ResidentWorld] = None,
    ) -> List[Optional[Tuple[str, List[str]]]]:
        """The whole preemptor batch in one call, the eviction deltas
        carried on the device. ``quota_rows[k]`` is ``(quota_used,
        used_limit)`` or None per pod, the round-start rows held for the
        batch: equal to the per-pod path whenever the quota groups do not
        overlap. Reads back each preemptor's winner and its row."""
        k = len(pods)
        if k == 0:
            return []
        req = np.zeros((k, NUM_RESOURCES), dtype=np.int64)
        prio = np.zeros(k, dtype=np.int32)
        quota = np.zeros(k, dtype=np.int32)
        is_ds = np.zeros(k, dtype=bool)
        is_prod = np.zeros(k, dtype=bool)
        q_used = np.zeros((k, NUM_RESOURCES), dtype=np.int64)
        q_limit = np.zeros((k, NUM_RESOURCES), dtype=np.int64)
        q_en = np.zeros(k, dtype=bool)
        for i, pod in enumerate(pods):
            req[i] = resources_to_vector(pod.requests)
            prio[i] = pod.priority
            quota[i] = resident.quota_id_of(pod.quota)
            is_ds[i] = pod.is_daemonset
            is_prod[i] = pod.priority_class == PriorityClass.PROD
            row = quota_rows[i] if quota_rows is not None else None
            if row is not None:
                q_used[i], q_limit[i] = np.asarray(row[0]), np.asarray(row[1])
                q_en[i] = True
        put = self._put
        batch = PreemptorBatch(
            req=put(clip_i32(req)), priority=put(prio), quota_id=put(quota),
            is_daemonset=put(is_ds), is_prod=put(is_prod),
            quota_used=put(clip_i32(q_used)),
            used_limit=put(clip_i32(q_limit)), quota_enabled=put(q_en),
            active=put(np.ones(k, dtype=bool)))
        best_nodes, victim_cols = preempt_scan(
            batch, put(arrays.alloc), put(arrays.used_req), put(arrays.usage),
            put(arrays.prod_usage), put(arrays.metric_fresh),
            put(arrays.schedulable), put(resident.node_rank),
            self.params.thresholds, self.params.prod_thresholds,
            self._current_world(resident, world))
        best_nodes = best_nodes.cpu().numpy()
        victim_cols = victim_cols.cpu().numpy()
        out: List[Optional[Tuple[str, List[str]]]] = []
        for i in range(k):
            b = int(best_nodes[i])
            out.append(None if b < 0 else (
                arrays.names[b],
                self._victim_uids(resident, b, victim_cols[i])))
        return out

    def plan_defrag_device(
        self,
        arrays: NodeArrays,
        resident: ResidentPodArrays,
        target_req,
        max_victim_priority: int,
        world: Optional[ResidentWorld] = None,
    ) -> Optional[Tuple[str, List[str]]]:
        """Headroom repack on the device: ``(node name, drain uids in
        eviction order)`` for the cheapest node to drain until
        ``target_req`` fits, draining preemptible residents strictly below
        ``max_victim_priority`` least important first; None when the hole
        already fits somewhere or no drain restores it."""
        put = self._put
        schedulable = put(arrays.schedulable)
        best, drain_mask, _, fits_now = headroom_repack(
            put(clip_i32(np.asarray(target_req))),
            put(np.int32(max_victim_priority)),
            put(arrays.alloc), put(arrays.used_req), schedulable,
            put(resident.node_rank), self._current_world(resident, world))
        if bool((fits_now & schedulable).any()):
            return None  # a hole already exists: nothing to drain
        b = int(best)
        if b < 0:
            return None
        ordered = self._victim_uids(resident, b, drain_mask[b].cpu().numpy())
        ordered.reverse()  # eviction order: least important first
        return arrays.names[b], ordered

    # -- solve --------------------------------------------------------------

    def schedule(self, snapshot: ClusterSnapshot) -> ScheduleResult:
        """Typed end to end: snapshot -> committed placements."""
        return self.schedule_async(snapshot).finalize()

    def schedule_async(self, snapshot: ClusterSnapshot) -> InFlightSchedule:
        """Lower, stage and dispatch one solve without reading it back.
        With fine-grained specials the propose -> validate -> refine loop
        runs here (it reads each proposal back), so such rounds block."""
        t_start = time.perf_counter()
        gang_names = sorted(snapshot.gangs)
        quota_names = sorted(snapshot.quotas)
        gang_index = {name: i for i, name in enumerate(gang_names)}
        quota_index = {name: i for i, name in enumerate(quota_names)}

        staged_state = None
        cache_stage_s = 0.0
        self.last_staging = None
        self.staging_delta = None
        host_sized = self._host_sized(snapshot)
        if snapshot.delta_tracker is not None:
            node_arrays, staged_state, cache_times, _ = (
                self.staged_cache.ensure(
                    snapshot,
                    # a solve that stages NUMA inventories restages in full
                    # below (decided from the last solve: one extra stage
                    # when topology appears), and a host-routed one stages
                    # nothing: skip the cache's device half
                    want_device=not (self._numa_staging or host_sized)))
            cache_stage_s = cache_times["stage_s"]
            self.last_staging = self.staged_cache.last_path
            self.staging_delta = self.staged_cache.take_wire_delta()
        else:
            node_arrays = lower_nodes(snapshot, **self.lowering_kwargs())
        pod_arrays = lower_pending_pods(
            snapshot.pending_pods,
            quota_index=quota_index or None,
            gang_index=gang_index or None,
            scaling_factors=self.scaling_factors,
            resource_weights=self.resource_weights,
        )
        uid_to_pod = {pod.uid: pod for pod in snapshot.pending_pods}
        pods_in_order = [uid_to_pod[uid] for uid in pod_arrays.uids]
        node_by_name = {node.name: node for node in snapshot.nodes}

        # fine-grained classification and NUMA lowering: one annotation
        # parse per pod gives the specials (host rows) and the pod-level
        # NUMA policy flags (in-solve consumption)
        fine = self.fine
        specials: List[int] = []
        pod_policy = None
        numa_cap = numa_free = node_policy = None
        use_numa = fine is not None and fine.has_topology(node_arrays.names)
        node_policy_present = use_numa and fine.any_node_policy(
            node_arrays.names)
        if fine is not None:
            pod_policy = np.zeros(len(pods_in_order), bool)
            for i, pod in enumerate(pods_in_order):
                special, has_policy = fine.pod_flags(pod, node_policy_present)
                if special:
                    specials.append(i)
                pod_policy[i] = has_policy
        if use_numa:
            numa_cap, numa_free, node_policy = fine.numa_arrays(
                node_arrays.names)
        self._numa_staging = use_numa
        if self._numa_staging:
            # NUMA inventories ride the NodeState but live outside the
            # staging cache: restage in full (the host arrays stay
            # delta-maintained), as the reference does; a remote backend
            # is never sent a delta against a base without them
            staged_state = None
            self.last_staging = "full"
            self.staging_delta = None

        # a gang pod whose GangSpec has not been observed must not bind solo
        blocked = np.array(
            [pod.gang is not None and pod.gang not in gang_index
             for pod in pods_in_order],
            dtype=bool,
        )
        gang_arrays = (self._gang_arrays(snapshot, gang_names)
                       if gang_names else None)
        quota_arrays = (self._quota_arrays(snapshot, quota_names, quota_index,
                                           node_arrays)
                        if quota_names else None)
        resv_np, resv_specs, resv_worst = self._build_resv(
            snapshot, node_arrays, pods_in_order)
        rows, affinity = self._host_rows(snapshot, pods_in_order, specials)
        t_host_done = time.perf_counter()
        # the host route: a plain solve (no quota, gang, extras,
        # reservations or NUMA) of at most host_fallback_cells cells
        host_route = (host_sized and not rows and resv_np is None
                      and not use_numa)

        state = batch = numa_aux = gang_state = quota_state = resv = None
        if host_route:
            # it reads the host arrays: nothing of the round goes to the
            # device, and the cache stages again for the next kernel round
            staged_state = None
        else:
            if staged_state is not None:
                state = staged_state
                # the solve about to dispatch reads this generation: later
                # scatters write beside it until finalize() unpins it
                self.staged_cache.pin(state)
            else:
                state = self.stage_nodes(node_arrays, numa_cap, numa_free)
            batch = self.stage_pods(pod_arrays,
                                    blocked if blocked.any() else None,
                                    pod_policy if use_numa else None)
        if use_numa:
            numa_aux = NumaAux(node_policy=torch.as_tensor(
                node_policy, device=self.device))
        if gang_arrays is not None:
            gang_state = GangState.build(**gang_arrays, device=self.device)
        if quota_arrays is not None:
            quota_state = QuotaState.build(**quota_arrays, device=self.device)
        if resv_np is not None:
            resv = ResvArrays(**{k: torch.as_tensor(v, device=self.device)
                                 for k, v in resv_np.items()})
        t_staged = time.perf_counter()
        # retro spans: host lowering, then host-to-device staging
        TRACER.emit("lower", cat="stage", t0=t_start, t1=t_host_done)
        TRACER.emit("stage", cat="stage", t0=t_host_done, t1=t_staged)
        self.last_timings = {
            # host lowering and the first host rows, less the staging the
            # cache did inside it; the refine loop counts in solve_s
            "lower_s": (t_host_done - t_start) - cache_stage_s,
            "stage_s": (t_staged - t_host_done) + cache_stage_s,
            "solve_s": 0.0,
        }

        # propose -> validate -> refine
        applied: List[tuple] = []   # (pod index, node name, CycleState)
        iteration = 0
        while True:
            extras, extras_safe = self._stage_rows(rows, resv_worst)
            with DEVICE_OBS.annotate("device_solve"):
                if host_route:
                    self.last_solver = "host"
                    result = self._host_solve(node_arrays, pod_arrays,
                                              blocked)
                else:
                    result = self._dispatch_solve(
                        state, batch, quota_state, gang_state, extras, resv,
                        resv_worst <= SCORE_BUDGET, numa_aux, extras_safe)
            if not specials:
                break
            raw = result.raw_assign.cpu().numpy()
            frozen = iteration >= self.MAX_SCORE_ITERS
            dirty = False
            for i in specials:
                a = int(raw[i])
                if a < 0:
                    continue
                pod = pods_in_order[i]
                node = node_by_name[node_arrays.names[a]]
                mask_i, score_i = rows.get(i)
                if not frozen:
                    m_row, s_row = fine.rows(snapshot, pod, snapshot.nodes)
                    if i in affinity:   # a node selector always applies
                        m_row = m_row & affinity[i]
                    if not (np.array_equal(m_row, mask_i)
                            and np.array_equal(s_row, score_i)):
                        rows.assign(i, m_row, s_row)
                        dirty = True
                        break
                ok, cstate = fine.apply(snapshot, pod, node)
                if not ok:
                    m_row = mask_i.copy()
                    m_row[a] = False
                    rows.assign(i, m_row, score_i)
                    dirty = True
                    break
                applied.append((i, node.name, cstate))
            if not dirty:
                break
            for i, node_name, cstate in reversed(applied):
                fine.rollback(snapshot, pods_in_order[i],
                              node_by_name[node_name], cstate)
            applied = []
            iteration += 1
        TRACER.emit("dispatch", cat="device", t0=t_staged,
                    args={"solver": self.last_solver})
        return InFlightSchedule(
            result, node_arrays.names, pod_arrays.uids, t_staged,
            self.last_timings,
            resv_specs=resv_specs if resv is not None else None,
            pods_in_order=pods_in_order, cache=self.staged_cache,
            pinned=staged_state, tracker=snapshot.delta_tracker,
            fine=fine, applied=applied, snapshot=snapshot,
            node_by_name=node_by_name)

    def _stage_rows(self, rows: "HostRows", worst: int
                    ) -> Tuple[Optional[ExtrasRows], bool]:
        """The host rows on the device as :class:`ExtrasRows` (None when
        no pod has one), and whether the kernel may take them
        (:func:`kernel_extras_score_safe` against the solve's worst score
        before extras)."""
        if not rows:
            return None, True
        row_of_pod, mask, score = rows.arrays()
        extras = ExtrasRows(
            row_of_pod=torch.as_tensor(row_of_pod, device=self.device),
            mask=torch.as_tensor(mask, device=self.device),
            score=torch.as_tensor(score, device=self.device))
        return extras, kernel_extras_score_safe(score, worst)

    def _dispatch_solve(self, state, batch, quota_state, gang_state, extras,
                        resv=None, resv_kernel_safe: bool = True,
                        numa_aux=None, extras_safe: bool = True):
        """Eligible solves go to the kernel that
        ``ops/binpack_kernel.kernel_route`` names by size: the one-block
        kernel, or the cluster kernel at the CTA count the route picks (on
        CUDA tensors it launches; a build or launch failure raises; on CPU
        tensors the chosen kernel's plain twin runs). Host extras rows
        ride along in compact form. Configurations the kernel does not
        cover, reservation tables whose credit could overflow the packed
        key's score budget (``resv_kernel_safe``) and extras tables with
        a score outside [0, 100] or past that budget (``extras_safe``),
        both checked on the host where they are built, and solves past
        65,536 nodes run the per-pod loop on the same device. A remote
        backend takes the whole solve instead (the same arrays over the
        wire, the same epilogue), with the staging cache's delta when it
        takes one, so that only the dirty node rows cross the wire. The
        host route is decided before this, in :meth:`schedule_async`,
        before anything is staged: a solve dispatched here runs on the
        model's device."""
        if self.backend is not None:
            # tagged before the call: a backend that raises leaves the
            # tag naming the solver that failed
            self.last_solver = "remote"
            kwargs = {}
            if (self.staging_delta is not None and getattr(
                    self.backend, "supports_staging_delta", False)):
                kwargs["staging"] = self.staging_delta
            result = self.backend.solve_result(
                state, batch, self.params, self.config, quota_state,
                gang_state, extras, resv, numa_aux, **kwargs)
            self.last_solver = getattr(self.backend, "last_mode",
                                       None) or "remote"
            return result
        if self._kernel_eligible and kernel_routing_ok(
                state, batch, extras, resv, resv_kernel_safe, numa_aux,
                extras_safe):
            self.last_solver = "kernel"
            return kernel_solve_batch(
                state, batch, self.params, quota_state, gang_state,
                self._wsum, numa_aux=numa_aux, resv=resv,
                most_allocated=self.config.numa_most_allocated,
                resv_score_checked=True, extras=extras,
                extras_score_checked=True)
        self.last_solver = "loop"
        return solve_batch(state, batch, self.params, self.config,
                           quota_state, gang_state, extras, resv, numa_aux)

    def _host_sized(self, snapshot: ClusterSnapshot) -> bool:
        """Whether ``snapshot``'s round may take the host route, known
        before it is lowered: no remote backend, no gang or quota specs,
        and ``0 < nodes x pending pods <= host_fallback_cells``. The rest
        of the test (no extras, reservations or NUMA) needs the lowering.
        Such a round skips the staging cache's device half."""
        cells = len(snapshot.nodes) * len(snapshot.pending_pods)
        return (self.backend is None and not snapshot.gangs
                and not snapshot.quotas
                and 0 < cells <= self.host_fallback_cells)

    def _host_solve(self, arrays: NodeArrays, pods: PendingPodArrays,
                    blocked: np.ndarray) -> SolveResult:
        """A tiny plain solve on the host: ``schedule_vectorized`` over the
        host arrays the round lowered (bit for bit the kernel's answer by
        the oracles' contract; nothing staged, no kernel launch, no
        read-back). Blocked pods are hard-blocked (``req[:, 0] = 2**30``);
        the carries take the placed pods' requests as the kernel's do.
        The result is CPU tensors, so :meth:`InFlightSchedule.finalize`
        copies nothing."""
        req = pods.req.copy()
        req[blocked, 0] = 2**30
        weights, thresholds, prod_thresholds = self._host_params
        assign = schedule_vectorized(
            arrays.alloc, arrays.used_req, arrays.usage, arrays.prod_usage,
            arrays.est_extra, arrays.prod_base, arrays.metric_fresh,
            arrays.schedulable, req, pods.est, pods.is_prod,
            pods.is_daemonset, weights, thresholds, prod_thresholds,
            fit_weight=self.config.fit_weight,
            loadaware_weight=self.config.loadaware_weight,
            score_according_prod=self.config.score_according_prod,
        ).astype(np.int32)
        placed = assign >= 0
        prod = placed & pods.is_prod
        fields = {f: getattr(arrays, f).copy() for f in STAGED_NODE_FIELDS}
        np.add.at(fields["used_req"], assign[placed], pods.req[placed])
        np.add.at(fields["est_extra"], assign[placed], pods.est[placed])
        np.add.at(fields["prod_base"], assign[prod], pods.est[prod])
        assign_t = torch.from_numpy(assign)
        falses = torch.zeros(assign.shape[0], dtype=torch.bool)
        return SolveResult(
            node_state=NodeState(**{f: torch.from_numpy(a)
                                    for f, a in fields.items()}),
            quota_state=None, assign=assign_t,
            commit=torch.from_numpy(placed), waiting=falses,
            rejected=falses, raw_assign=assign_t)

    def _build_resv(self, snapshot, node_arrays, pods_in_order):
        """The Available reservations with a free remainder on a known
        node, as ``(ResvArrays fields as numpy, their specs indexed by v,
        worst)``, or ``(None, [], BASE_SCORE_WORST)`` when there are
        none. ``worst`` is :func:`resv_score_worst` on the host arrays:
        past ``SCORE_BUDGET`` dispatch routes the table to the loop, and
        the extras check adds the largest extras score to it."""
        index = {name: j for j, name in enumerate(node_arrays.names)}
        specs, nodes, frees, once = [], [], [], []
        for resv in snapshot.reservations:
            if getattr(resv.state, "value", resv.state) != "Available":
                continue
            if resv.node_name not in index:
                continue
            free = reservation_free(resv)
            if not free.any():
                continue
            specs.append(resv)
            nodes.append(index[resv.node_name])
            frees.append(free)
            once.append(resv.allocate_once)
        if not specs:
            return None, [], BASE_SCORE_WORST
        node_np = np.asarray(nodes, np.int32)
        free_np = np.stack(frees).astype(np.int32)
        arrays = dict(node=node_np, free=free_np,
                      allocate_once=np.asarray(once, bool),
                      match=_match_matrix(specs, pods_in_order))
        return arrays, specs, resv_score_worst(node_np, free_np,
                                               node_arrays.alloc)

    def _gang_arrays(self, snapshot, gang_names) -> dict:
        """``GangState.build`` arguments: min member, members already
        bound, Strict or not, and the gang-group label."""
        bound = {name: 0 for name in gang_names}
        for pod in snapshot.pods:
            if pod.gang in bound and pod.node_name is not None:
                bound[pod.gang] += 1
        specs = [snapshot.gangs[g] for g in gang_names]
        return dict(
            min_member=[s.min_member for s in specs],
            bound_count=[bound[g] for g in gang_names],
            strict=[s.mode == GangMode.STRICT for s in specs],
            group_id=[
                "/".join(sorted(s.gang_group)) if s.gang_group else g
                for g, s in zip(gang_names, specs)
            ],
        )

    def _quota_arrays(self, snapshot, quota_names, quota_index,
                      node_arrays) -> dict:
        """``QuotaState.build`` arguments for the (possibly hierarchical)
        quota tree. Requests are static within a solve, so the exact tree
        runtime is computed once on the host, one GroupQuotaManager per
        tree, and shipped as the precomputed runtime; the device then
        only tracks each group's used."""
        q = len(quota_names)
        shape = (q, NUM_RESOURCES)
        mn, mx, guar, weight = (np.zeros(shape, np.int64) for _ in range(4))
        allow = np.ones(q, bool)
        child_request = np.zeros(shape, np.int64)
        used = np.zeros(shape, np.int64)
        for name, i in quota_index.items():
            spec = snapshot.quotas[name]
            mn[i] = resources_to_vector(spec.min)
            mx[i] = resources_to_vector(spec.max)
            guar[i] = resources_to_vector(spec.guaranteed)
            weight[i] = (resources_to_vector(spec.shared_weight)
                         if spec.shared_weight is not None else mx[i])
            allow[i] = spec.allow_lent_resource
        for pod in list(snapshot.pending_pods) + list(snapshot.pods):
            if pod.quota in quota_index:
                i = quota_index[pod.quota]
                vec = resources_to_vector(pod.requests)
                child_request[i] += vec
                if pod.node_name is not None:
                    used[i] += vec

        node_total = node_arrays.alloc.astype(np.int64).sum(axis=0)
        by_tree: Dict[str, list] = {}
        for name in quota_names:
            by_tree.setdefault(snapshot.quotas[name].tree_id, []).append(name)
        runtime = np.zeros(shape, np.int64)
        for tree_names in by_tree.values():
            mgr = GroupQuotaManager()
            mgr.cluster_total = node_total.copy()
            for name in tree_names:
                spec = snapshot.quotas[name]
                # only tree roots carry a node-pool total
                if spec.total_resource is not None and (
                    spec.parent is None or spec.parent == "root"
                ):
                    mgr.cluster_total = resources_to_vector(spec.total_resource)
                mgr.update_quota(spec)
            for name in tree_names:
                i = quota_index[name]
                if child_request[i].any():
                    mgr.add_request(name, child_request[i])
            for name in tree_names:
                rt = mgr.refresh_runtime(name)
                runtime[quota_index[name]] = rt if rt is not None else 0
        return dict(min=mn, max=mx, guarantee=guar, weight=weight,
                    allow_lent=allow, child_request=child_request, used=used,
                    total=node_total, runtime=runtime)

    def _host_rows(self, snapshot, pods_in_order, specials
                   ) -> Tuple[HostRows, Dict[int, np.ndarray]]:
        """The solve's host rows and, per pod, the static part its
        refreshed special rows are AND-ed with (``affinity``).
        - Specials: the fine-grained manager's rows (NUMA and device
          filters, device score) against its current state.
        - A required node selector: a mask row, built once per distinct
          selector.
        - Host ports, when no fine-grained ports plugin resolves them: a
          row against the ports of pods already assigned to each node; a
          later pending pod claiming a port an earlier one claimed is
          deferred (all-False row) to the next round, and only a pod with
          a feasible node claims its ports.
        Equal to the reference's dense ``[P,N]`` rows."""
        fine = self.fine
        nodes = snapshot.nodes
        n = len(nodes)
        rows = HostRows(len(pods_in_order), n)
        affinity: Dict[int, np.ndarray] = {}
        selector_pods = [i for i, pod in enumerate(pods_in_order)
                         if pod.node_selector]
        port_pods = []
        if fine is None or fine.ports_plugin is None:
            port_pods = [i for i, pod in enumerate(pods_in_order)
                         if pod.host_ports]
        if not (specials or selector_pods or port_pods):
            return rows, affinity
        current: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for i in specials:
            current[i] = fine.rows(snapshot, pods_in_order[i], nodes)
        zeros = np.zeros(n, np.int32)
        by_selector: Dict[frozenset, np.ndarray] = {}
        for i in selector_pods:
            selector = pods_in_order[i].node_selector
            key = frozenset(selector.items())
            row = by_selector.get(key)
            if row is None:
                row = np.fromiter(
                    (selector_matches(selector, node.labels)
                     for node in nodes), dtype=bool, count=n)
                by_selector[key] = row
            affinity[i] = row
            mask, score = current.get(i, (row, zeros))
            current[i] = (mask & row, score)
        if port_pods:
            used_by_node = [set() for _ in range(n)]
            node_idx = {nd.name: j for j, nd in enumerate(nodes)}
            for ap in snapshot.pods:
                j = node_idx.get(ap.node_name)
                if j is not None:
                    used_by_node[j] |= pod_host_ports(ap)
            claimed: set = set()
            for i in port_pods:
                mask, score = current.get(i, (np.ones(n, bool), zeros))
                want = pod_host_ports(pods_in_order[i])
                if want & claimed:
                    current[i] = (np.zeros(n, bool), score)
                    affinity[i] = np.zeros(n, bool)
                    continue
                row = np.fromiter(
                    (not (want & used_by_node[j]) for j in range(n)),
                    dtype=bool, count=n)
                if (mask & row).any():
                    claimed |= want
                affinity[i] = affinity.get(i, np.ones(n, bool)) & row
                current[i] = (mask & row, score)
        for i, (mask, score) in current.items():
            rows.assign(i, mask, score)
        return rows, affinity
