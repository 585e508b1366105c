"""Deterministic fault injection for the solver boundary, the scheduler's
state and the HBM working set: the port's copy of
``koordinator_tpu/testing/chaos.py``.

- :class:`FaultSchedule` maps ordinals (requests or ticks) to fault
  kinds, scripted or generated from a seed.
- :class:`ChaosProxy` sits between a
  :class:`~koordinator_tpu_torch.service.client.PlacementClient` /
  ``RemoteSolver`` and the sidecar, speaking the plain framed protocol
  (``service/codec.read_frame``/``write_frame``) and forwarding frames
  verbatim except where the schedule names one of the wire faults
  (:data:`FAULT_KINDS`): a torn or corrupted response, a stall, a reset,
  the sidecar killed mid-request, the delta base dropped.
- :class:`StateSaboteur` executes the scheduled state corruptions
  (:data:`STATE_FAULT_KINDS`, the drift classes the anti-entropy auditor
  ``scheduler/auditor.StateAuditor`` detects and repairs) against a live
  scheduler's caches, its staged CUDA generation included.
- :class:`HBMSaboteur` executes the scheduled device-memory-pressure
  faults (:data:`HBM_FAULT_KINDS`) against the working-set manager.
- :func:`eviction_storm_world` is the unique-fit world of the
  arbitration chaos suite (:data:`EVICTION_STORM_FAULT_KINDS`), and
  :func:`check_budget_compliance` its check that no admitted eviction
  went over the budget in effect.
- :func:`drive_audited_cluster` is the reference's kill-the-leader chaos
  drive (``tests/test_chaos.py``'s ``_drive_cluster``): seeded churn over
  a bus, two leader-elected schedulers with auditors, the leader killed
  mid-churn and corruptions planted in the standby. It takes a package's
  modules (:func:`port_env` for this one), so one drive runs through
  either package.
- :class:`InProcessSidecar` wraps a :class:`PlacementService` in a
  subprocess-like handle (``poll``/``kill``/``pid``), so a
  :class:`~koordinator_tpu_torch.service.supervisor.SolverSupervisor`
  can supervise, and a test can kill and restart, a sidecar without a
  process start per respawn.

The determinism contract is the schedule, not the interleaving: every
injected fault leads to a typed, recoverable outcome, so the chaos tests
assert path-independent facts (every tick completed; final placements
and node accounting equal to a fault-free run).

- :func:`sabotage_store` corrupts one warm-pool store file
  (``service/warmpool.py``) in one of :data:`WARM_POOL_FAULT_KINDS`, byte
  for byte as the reference does.
"""
from __future__ import annotations

import random
import socket
import struct
import threading
from typing import Callable, Dict, Optional

import numpy as np

from koordinator_tpu_torch.service.codec import read_frame, write_frame

#: every wire fault kind the proxy can inject
FAULT_KINDS = (
    "torn-response",     # half the response frame, then a hard close
    "corrupt-response",  # response payload bytes flipped (frame intact)
    "stall",             # response delayed past the client's deadline
    "reset-request",     # client connection reset after the request
    "kill-server",       # kill_fn() fired mid-request (sidecar SIGKILL)
    "drop-base",         # upstream connection swapped: delta base lost
)

#: state-corruption fault kinds, injected by :class:`StateSaboteur` into a
#: live scheduler's caches: the drift classes the runtime auditor
#: (scheduler/auditor.py) exists to detect and repair
STATE_FAULT_KINDS = (
    "corrupt-cache-cell",   # a cached pod's placement silently rewritten
    "orphan-assume",        # an assume entry with no pod behind it
    "desync-staged-row",    # a staged row moved with no delta-tracker mark
)

#: device-memory-pressure fault kinds: every one must degrade through the
#: typed demote-and-retry ladder with counted outcomes, and placements
#: stay bit-identical to a fault-free run
HBM_FAULT_KINDS = (
    "alloc-fail-stage",          # an allocation failure at the next staging
    "alloc-fail-scatter",        # an allocation failure at the next scatter
    "budget-squeeze-mid-churn",  # budget transiently halved: forced
                                 # demotions under live multi-tenant load
)


#: eviction-storm fault kinds, driven against a live scheduler and its
#: migration arbiter: every one must pass through the MigrationArbiter (no
#: declared budget exceeded in any window, every over-budget request
#: deferred with a typed and counted refusal, no eviction cascade), and
#: final placements and node accounting equal a fault-free control arm
EVICTION_STORM_FAULT_KINDS = (
    "rebalance-wave",           # a LoadAware Balance sweep fired mid-run
    "preemption-storm",         # a wave of unique-fit LS arrivals, each
                                # placing only by evicting a BE resident
    "budget-squeeze-mid-wave",  # arbiter budget transiently tightened
                                # against already-admitted evictions
)


WARM_POOL_FAULT_KINDS = (
    "truncated-entry",          # torn write: the file ends mid-payload
    "bitflipped-entry",         # bit rot: bytes flipped under the header
    "stale-host-fingerprint",   # store copied from another machine: the
                                # embedded host fingerprint is foreign
    "torn-concurrent-write",    # two unsynchronized writers interleaved:
                                # head from one write, tail from another
    "wrong-magic",              # foreign/stale file where an entry should be
    "oversize-entry",           # corrupt/hostile length: GB-claiming header
)

def sabotage_store(store_dir: str, kind: str, seed: int = 0,
                   manifest: bool = False):
    """Deterministically corrupt one warm-pool store file under
    ``store_dir`` (the newest ``.exec`` entry in sorted order, or the
    manifest with ``manifest=True``). Returns the path corrupted, or
    None when the store holds no target. Same seed, same bytes flipped:
    the warm-pool tests and phase 24 of ``chip_smoke.py`` share this one
    implementation, and equal files come out equal to the reference's."""
    import os

    if kind not in WARM_POOL_FAULT_KINDS:
        raise ValueError(f"unknown store fault kind: {kind!r}")
    targets = []
    for root, _dirs, files in os.walk(store_dir):
        for name in files:
            if manifest and name == "warm_manifest.bin":
                targets.append(os.path.join(root, name))
            elif not manifest and name.endswith(".exec"):
                targets.append(os.path.join(root, name))
    if not targets:
        return None
    path = sorted(targets)[-1]
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    rng = random.Random(seed)
    if kind == "truncated-entry":
        raw = raw[: max(8, len(raw) // 2)]
    elif kind == "bitflipped-entry":
        # flip bytes PAST the framed header so the fingerprint check —
        # not the magic check — is what must catch it
        start = min(len(raw) - 1, 64)
        for _ in range(max(1, len(raw) // 4096)):
            i = rng.randrange(start, len(raw))
            raw[i] ^= 0xFF
    elif kind == "stale-host-fingerprint":
        # a VALIDLY framed entry whose embedded provenance names a
        # different machine — the copied-store/baked-container-image
        # shape that dodges the host-scoped directory layout. Only the
        # load-time provenance check can catch this one: the frame
        # digest is recomputed, so it verifies clean.
        import pickle

        from koordinator_tpu_torch.utils.compilation_cache import (
            frame_payload,
            unframe_payload,
        )

        try:
            record = pickle.loads(unframe_payload(bytes(raw)))
            host, version, payload, trees = record
        except Exception:
            return None  # not a v2 entry (e.g. the manifest): no target
        body = pickle.dumps(
            ("x86_64-deadbeef0000", version, payload, trees)
        )
        raw = bytearray(frame_payload(body))
    elif kind == "torn-concurrent-write":
        # two writers' interleaved output: the header + head of one
        # write, the tail of another (simulated by splicing the file's
        # own head over its tail) — framing intact, fingerprint wrong
        half = max(64, len(raw) // 2)
        torn = raw[:half] + raw[len(raw) - half: len(raw) - half // 2] \
            + raw[half + half // 2:]
        if torn == raw:
            # on a length that is a multiple of four the reference's
            # splice copies a chunk onto itself and tears nothing:
            # splice the head's own tail there instead (the reference's
            # bytes on every other length)
            torn = raw[:half] + raw[half - half // 2: half] \
                + raw[half + half // 2:]
        raw = torn
        if len(raw) < 64:
            raw = raw + b"\x00" * 64
    elif kind == "wrong-magic":
        raw[:8] = b"NOTKOORD"
    elif kind == "oversize-entry":
        # keep the real magic, claim an absurd payload length
        raw[8:16] = struct.pack(">Q", 1 << 62)
    with open(path, "wb") as f:
        f.write(bytes(raw))
    return path


class FaultSchedule:
    """Ordinal (0-based) -> fault kind. ``events`` pins faults
    explicitly; :meth:`generate` derives a schedule from a seed. The
    proxy counts request ordinals globally across connections, in arrival
    order; the saboteurs count ticks."""

    def __init__(self, events: Optional[Dict[int, str]] = None):
        self.events = dict(events or {})
        for kind in self.events.values():
            if (
                kind not in FAULT_KINDS
                and kind not in STATE_FAULT_KINDS
                and kind not in HBM_FAULT_KINDS
                and kind not in EVICTION_STORM_FAULT_KINDS
            ):
                raise ValueError(f"unknown fault kind: {kind!r}")

    @classmethod
    def generate(cls, seed: int, n_requests: int, rate: float = 0.2,
                 kinds=FAULT_KINDS, start: int = 0) -> "FaultSchedule":
        """A seeded schedule over ``[start, start+n_requests)``: each
        ordinal faulted with probability ``rate``, the kind drawn
        uniformly (the reference's draws: same seed, same schedule)."""
        rng = random.Random(seed)
        events: Dict[int, str] = {}
        for i in range(start, start + n_requests):
            if rng.random() < rate:
                events[i] = kinds[rng.randrange(len(kinds))]
        return cls(events)

    def fault_for(self, ordinal: int) -> Optional[str]:
        return self.events.get(ordinal)


def _connect(address):
    family = socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_STREAM)
    sock.connect(address)
    return sock


class ChaosProxy:
    """A frame-level proxy injecting :class:`FaultSchedule` faults.

    One thread per client connection; the upstream connection is opened
    at accept (and re-opened after ``drop-base``, so the client keeps its
    connection while the server's per-connection delta base vanishes:
    the forced loss of the base). If the upstream is unreachable when a
    client connects, the client connection is closed at once, so
    ``service/supervisor.connection_probe``'s hold-open check reports the
    backend dead even though the proxy itself still accepts.

    A ``stall`` holds the response ``stall_s`` seconds on the proxy's
    stop event, so :meth:`stop` ends it at once."""

    def __init__(self, listen_address, upstream_address,
                 schedule: Optional[FaultSchedule] = None,
                 kill_fn: Optional[Callable[[], None]] = None,
                 stall_s: float = 1.0, corrupt_seed: int = 0):
        self.listen_address = listen_address
        self.upstream_address = upstream_address
        self.schedule = schedule or FaultSchedule()
        self.kill_fn = kill_fn
        self.stall_s = stall_s
        self._corrupt_rng = random.Random(corrupt_seed)
        self._lock = threading.Lock()
        self.requests_seen = 0
        self.faults_injected: Dict[str, int] = {}
        self._stop = threading.Event()
        family = (socket.AF_UNIX if isinstance(listen_address, str)
                  else socket.AF_INET)
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        self._sock.bind(listen_address)
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ChaosProxy":
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="chaos-proxy"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._sock.close()

    # -- internals -----------------------------------------------------------

    def _next_ordinal(self) -> int:
        with self._lock:
            ordinal = self.requests_seen
            self.requests_seen += 1
            return ordinal

    def _record(self, kind: str) -> None:
        with self._lock:
            self.faults_injected[kind] = (
                self.faults_injected.get(kind, 0) + 1
            )

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # a dead backend must look dead through the proxy: close the
            # client connection when the upstream will not accept
            try:
                upstream = _connect(self.upstream_address)
            except OSError:
                conn.close()
                continue
            threading.Thread(
                target=self._serve, args=(conn, upstream), daemon=True
            ).start()

    def _serve(self, conn: socket.socket, upstream: socket.socket) -> None:
        client_stream = conn.makefile("rwb")
        up_stream = upstream.makefile("rwb")

        def close_all():
            for closeable in (client_stream, up_stream, conn, upstream):
                try:
                    closeable.close()
                except OSError:
                    pass

        def hard_reset():
            # RST instead of FIN where the platform allows: the client
            # must handle an abrupt death, not a polite shutdown
            try:
                conn.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    b"\x01\x00\x00\x00\x00\x00\x00\x00",
                )
            except OSError:
                pass
            close_all()

        try:
            while not self._stop.is_set():
                try:
                    payload = read_frame(client_stream)
                except (EOFError, ValueError, OSError):
                    return close_all()
                if payload is None:
                    return close_all()
                fault = self.schedule.fault_for(self._next_ordinal())
                if fault == "reset-request":
                    self._record(fault)
                    return hard_reset()
                if fault == "kill-server":
                    self._record(fault)
                    if self.kill_fn is not None:
                        self.kill_fn()
                    return hard_reset()
                if fault == "drop-base":
                    # swap the upstream connection: the server's
                    # per-connection node-state cache dies with it while
                    # the client connection lives on, so the next delta
                    # request meets delta-base-mismatch
                    self._record(fault)
                    try:
                        up_stream.close()
                        upstream.close()
                    except OSError:
                        pass
                    try:
                        upstream = _connect(self.upstream_address)
                        up_stream = upstream.makefile("rwb")
                    except OSError:
                        return hard_reset()
                try:
                    write_frame(up_stream, payload)
                    up_stream.flush()
                    response = read_frame(up_stream)
                except (EOFError, ValueError, OSError):
                    return hard_reset()  # backend died mid-solve
                if response is None:
                    return hard_reset()
                if fault == "stall":
                    self._record(fault)
                    if self._stop.wait(self.stall_s):
                        return close_all()
                elif fault == "torn-response":
                    self._record(fault)
                    try:
                        # length prefix and half the payload, then RST:
                        # the client sees TruncatedFrame
                        client_stream.write(struct.pack(">I", len(response)))
                        client_stream.write(response[: len(response) // 2])
                        client_stream.flush()
                    except OSError:
                        pass
                    return hard_reset()
                elif fault == "corrupt-response":
                    self._record(fault)
                    corrupted = bytearray(response)
                    for _ in range(max(1, len(corrupted) // 256)):
                        i = self._corrupt_rng.randrange(len(corrupted))
                        corrupted[i] ^= 0xFF
                    response = bytes(corrupted)
                try:
                    write_frame(client_stream, response)
                    client_stream.flush()
                except OSError:
                    return close_all()
        finally:
            close_all()


def eviction_storm_world(seed: int, n_nodes: int = 12,
                         base_cpu: int = 4000, base_mem: int = 8192,
                         step: int = 64):
    """The seeded unique-fit eviction-storm world of the arbitration chaos
    suite (:data:`EVICTION_STORM_FAULT_KINDS`), draw for draw the
    reference's.

    Node ``i`` allocates ``(base_cpu + i*step, base_mem + (N-1-i)*step)``,
    a two-resource staircase where arrival ``i`` requests exactly node
    ``i``'s shape, so it fits node ``i`` and no other (every ``j < i`` is
    CPU-short, every ``j > i`` memory-short). Each node starts filled by
    one preemptible BE resident of the same shape. So every LS arrival
    has one feasible node and one victim there, and the final placement
    set is order-independent: deferrals and budget squeezes move when
    evictions land, never where. An evicted resident fits nowhere else
    while the storm runs, so any cascade is an arbitration bug.

    Resident priorities are seeded jitter; arrival priorities strictly
    dominate. Returns ``(nodes, residents, arrivals)``; residents carry
    ``node_name``."""
    from koordinator_tpu_torch.apis.extension import (
        PriorityClass,
        QoSClass,
        ResourceName,
    )
    from koordinator_tpu_torch.apis.types import NodeSpec, PodSpec

    CPU, MEM = ResourceName.CPU, ResourceName.MEMORY
    rng = random.Random(seed)
    nodes, residents, arrivals = [], [], []
    for i in range(n_nodes):
        cpu = base_cpu + i * step
        mem = base_mem + (n_nodes - 1 - i) * step
        nodes.append(NodeSpec(
            name=f"evstorm-n{i}",
            allocatable={CPU: cpu, MEM: mem},
        ))
        residents.append(PodSpec(
            name=f"evstorm-be-{i}",
            node_name=f"evstorm-n{i}",
            requests={CPU: cpu, MEM: mem},
            qos=QoSClass.BE,
            priority=rng.randrange(100, 400),
            assign_time=float(rng.randrange(0, 1000)),
        ))
        arrivals.append(PodSpec(
            name=f"evstorm-ls-{i}",
            requests={CPU: cpu, MEM: mem},
            qos=QoSClass.LS,
            priority_class=PriorityClass.PROD,
            priority=5000 + rng.randrange(0, 4000),
        ))
    return nodes, residents, arrivals


def check_budget_compliance(records, budget_at) -> None:
    """Re-check every admitted eviction of a ``MigrationArbiter``'s
    decision ring against the budget in effect when it was admitted
    (``budget_at(seq)`` returns that ``MigrationBudget``): the per-round
    cap, the per-node and per-lane sliding windows and the node cooldown.
    Undeferrable notes commit against the windows but are exempt from the
    caps; dry runs admit nothing. Raises ``AssertionError`` at the first
    eviction over a budget (the reference's chaos suite's check)."""
    node_times: Dict[str, list] = {}
    lane_times: Dict[str, list] = {}
    node_last: Dict[str, float] = {}
    round_counts: Dict[object, int] = {}
    for rec in records:
        budget = budget_at(rec["seq"])
        now = rec["now"]
        horizon = now - budget.window_s
        for times in (node_times, lane_times):
            for key in list(times):
                times[key] = [t for t in times[key] if t > horizon]
        if rec.get("dry_run"):
            assert not rec.get("undeferrable")
            continue
        if rec.get("undeferrable"):
            for _ in rec["admitted"]:
                node_times.setdefault(rec["node"], []).append(now)
            continue
        rnd = rec["round"]
        for uid in rec["admitted"]:
            lane = rec["lanes"][rec["uids"].index(uid)]
            if budget.max_per_round is not None and rnd is not None:
                assert round_counts.get(rnd, 0) < budget.max_per_round, (
                    f"round {rnd} over budget at {uid}")
                round_counts[rnd] = round_counts.get(rnd, 0) + 1
            if budget.max_per_node is not None and rec["node"]:
                assert len(node_times.get(rec["node"], [])) < \
                    budget.max_per_node, f"node window over at {uid}"
            if budget.max_per_tenant is not None and lane is not None:
                assert len(lane_times.get(lane, [])) < \
                    budget.max_per_tenant, f"lane window over at {uid}"
            if budget.node_cooldown_s > 0 and rec["node"]:
                last = node_last.get(rec["node"])
                assert last is None or now - last >= \
                    budget.node_cooldown_s, f"cooldown violated at {uid}"
            if rec["node"]:
                node_times.setdefault(rec["node"], []).append(now)
                node_last[rec["node"]] = now
            if lane is not None:
                lane_times.setdefault(lane, []).append(now)


class StateSaboteur:
    """Executes a schedule's :data:`STATE_FAULT_KINDS` against a live
    scheduler, the victims drawn from ``seed`` as the reference draws
    them (same seed, same victims):

    - ``corrupt-cache-cell``: a cached assigned pod is replaced by a copy
      claiming another node; the cache now disagrees with the bus and no
      event will heal it (auditor: ``stale-pod``).
    - ``orphan-assume``: an assume entry with no pod behind it, what a
      crashed round can leave (auditor: ``orphan-assume``).
    - ``desync-staged-row``: one staged node row, the host arrays and the
      staged generation on the model's device (on CUDA, the card's
      tensor), moved 777 m CPU of usage away from typed truth with no
      delta-tracker mark: the missed-mark class only the device <-> host
      parity probe sees (auditor: ``staged-host-drift`` /
      ``staged-device-drift``). Typed truth is untouched, so a corrupted
      then repaired run stays equal to a fault-free one.

    ``inject(tick)`` returns the kind applied, or None when nothing was
    scheduled or its precondition (an assigned pod, a staged row) does
    not hold yet; ``injected`` counts per kind and ``log`` keeps ``(tick,
    kind, detail)``."""

    def __init__(self, schedule: FaultSchedule, scheduler, seed: int = 0):
        self.schedule = schedule
        self.scheduler = scheduler
        self._rng = random.Random(seed)
        self.injected: Dict[str, int] = {}
        self.log: list = []

    def inject(self, tick: int) -> Optional[str]:
        kind = self.schedule.fault_for(tick)
        if kind is None or kind not in STATE_FAULT_KINDS:
            return None
        detail = getattr(self, "_" + kind.replace("-", "_"))()
        if detail is None:
            return None  # precondition unmet: nothing corrupted
        self.injected[kind] = self.injected.get(kind, 0) + 1
        self.log.append((tick, kind, detail))
        return kind

    def _corrupt_cache_cell(self) -> Optional[str]:
        import dataclasses

        cache = self.scheduler.cache
        nodes = sorted(cache.nodes)
        if len(nodes) < 2:
            return None
        candidates = sorted(
            uid for uid, pod in cache.pods.items()
            if pod.node_name is not None
            and not getattr(pod, "waiting_permit", False))
        if not candidates:
            return None
        uid = candidates[self._rng.randrange(len(candidates))]
        pod = cache.pods[uid]
        others = [n for n in nodes if n != pod.node_name]
        wrong = others[self._rng.randrange(len(others))]
        # a copy, so the bus's object keeps the true placement: the
        # cache-missed-an-event shape
        cache.pods[uid] = dataclasses.replace(pod, node_name=wrong)
        return f"{uid}:{pod.node_name}->{wrong}"

    def _orphan_assume(self) -> Optional[str]:
        cache = self.scheduler.cache
        uid = f"__ghost__{self._rng.randrange(1 << 30)}"
        cache.assumed[uid] = 0.0  # ancient: expired by any TTL
        return uid

    def _desync_staged_row(self) -> Optional[str]:
        model = getattr(self.scheduler, "model", None)
        staged = getattr(model, "staged_cache", None)
        if staged is None:
            return None
        arrays, state, tracker, seen_epoch, _now = staged.audit_view()
        if arrays is None or tracker is None:
            return None
        dirty = set(tracker.dirty_since(seen_epoch))
        cache = self.scheduler.cache
        candidates = [name for name in arrays.names
                      if name not in dirty and name in cache.node_metrics]
        if not candidates:
            return None
        name = candidates[self._rng.randrange(len(candidates))]
        i = arrays.names.index(name)
        if (state is not None and state.usage.device.type == "cpu"
                and np.shares_memory(state.usage.numpy(), arrays.usage)):
            # one buffer would take both writes: 1,554, not 777 a half
            raise RuntimeError("the staged usage shares memory with the "
                               "host arrays")
        # both halves drift, no tracker mark: nothing event-driven will
        # re-lower this row; only the parity probe sees it
        arrays.usage[i, 0] += 777
        if state is not None:
            state.usage[i, 0] += 777
        return name


#: the kill-the-leader drive: nodes, ticks (4 pods each), the tick from
#: which the leader no longer ticks, and the auditor cadence in rounds
AUDIT_NODES = 8
AUDIT_TICKS = 24
KILL_TICK = 10
SWEEP_EVERY = 4


def state_fault_schedule(seed: int) -> FaultSchedule:
    """A seeded schedule over all three :data:`STATE_FAULT_KINDS` for
    :func:`drive_audited_cluster`: one ``corrupt-cache-cell`` and one
    ``orphan-assume`` on distinct ticks of the standby before the kill
    (the promotion sweep audits them), and one ``desync-staged-row`` on a
    tick of the promoted leader's periodic sweep (its staged cache exists
    from its first round on; the sweep runs before that tick's solve)."""
    rng = random.Random(seed)
    cache_ticks = rng.sample(range(1, KILL_TICK), 2)
    sweep_ticks = list(range(KILL_TICK + SWEEP_EVERY, AUDIT_TICKS,
                             SWEEP_EVERY))
    return FaultSchedule({
        cache_ticks[0]: "corrupt-cache-cell",
        cache_ticks[1]: "orphan-assume",
        sweep_ticks[rng.randrange(len(sweep_ticks))]: "desync-staged-row",
    })


def port_env():
    """This package's modules as :func:`drive_audited_cluster` takes
    them."""
    from types import SimpleNamespace

    from koordinator_tpu_torch.apis import types
    from koordinator_tpu_torch.apis.extension import ResourceName
    from koordinator_tpu_torch.client import bus, leaderelection, wiring
    from koordinator_tpu_torch.scheduler.auditor import StateAuditor
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler

    return SimpleNamespace(
        APIServer=bus.APIServer, Kind=bus.Kind, EventType=bus.EventType,
        NodeSpec=types.NodeSpec, NodeMetric=types.NodeMetric,
        PodSpec=types.PodSpec, ResourceName=ResourceName,
        Scheduler=Scheduler, LeaderElector=leaderelection.LeaderElector,
        StateAuditor=StateAuditor, wire_scheduler=wiring.wire_scheduler,
        StateSaboteur=StateSaboteur, FaultSchedule=FaultSchedule)


def drive_audited_cluster(env, seed: int, *, kill_leader: bool, sabotage,
                          make_model, cutoff_of_tick=None):
    """Seeded churn over a wired bus (the reference's ``_drive_cluster``).

    ``kill_leader=True`` runs two leader-elected schedulers with
    auditors (a sweep every SWEEP_EVERY rounds, every row probed), stops
    ticking the leader at KILL_TICK (what a SIGKILL looks like from the
    bus) and lets the standby promote; ``sabotage`` (a FaultSchedule's
    events over STATE_FAULT_KINDS) is injected into the standby, the
    state a promoted leader inherits. ``kill_leader=False`` is the
    crash-free single scheduler. A tick gap of 2 s over a 1 s lease makes
    the failover cost no round, so the placements equal the crash-free
    run's. ``make_model()`` builds each scheduler's PlacementModel;
    ``cutoff_of_tick(t)``, when given, sets every model's
    ``host_fallback_cells`` before tick ``t``. Returns ``(per-tick
    placement log, bus, info)``; ``info["solvers"]`` is each tick's
    ``last_solver``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bus = env.APIServer()
    binds: Dict[str, int] = {}
    prev_node: Dict[str, Optional[str]] = {}

    def bind_watch(event, name, pod):
        node = getattr(pod, "node_name", None)
        if event is env.EventType.DELETED:
            prev_node.pop(pod.uid, None)
            return
        if node is not None and prev_node.get(pod.uid) != node:
            binds[pod.uid] = binds.get(pod.uid, 0) + 1
        prev_node[pod.uid] = node

    bus.watch(env.Kind.POD, bind_watch)
    info: dict = {"binds": binds, "solvers": []}
    if kill_leader:
        sched_a = env.Scheduler(model=make_model())
        sched_b = env.Scheduler(model=make_model())
        ea = env.LeaderElector(bus, "koord-scheduler", "a",
                               lease_duration=1.0)
        eb = env.LeaderElector(bus, "koord-scheduler", "b",
                               lease_duration=1.0)
        aud_a = env.StateAuditor(sched_a, bus, interval_rounds=SWEEP_EVERY,
                                 probe_rows=AUDIT_NODES)
        aud_b = env.StateAuditor(sched_b, bus, interval_rounds=SWEEP_EVERY,
                                 probe_rows=AUDIT_NODES)
        ea.on_started_leading = aud_a.note_promotion
        eb.on_started_leading = aud_b.note_promotion
        env.wire_scheduler(bus, sched_a, elector=ea)
        env.wire_scheduler(bus, sched_b, elector=eb)
        saboteur = env.StateSaboteur(env.FaultSchedule(sabotage), sched_b,
                                     seed=seed)
        seats = [(ea, sched_a, aud_a), (eb, sched_b, aud_b)]
        info.update(aud_a=aud_a, aud_b=aud_b, saboteur=saboteur,
                    sched_b=sched_b)
    else:
        sched = env.Scheduler(model=make_model())
        env.wire_scheduler(bus, sched)
        saboteur = None
        seats = [(None, sched, None)]

    cpu, mem = env.ResourceName.CPU, env.ResourceName.MEMORY
    for i in range(AUDIT_NODES):
        bus.apply(env.Kind.NODE, f"n{i}", env.NodeSpec(
            name=f"n{i}", allocatable={cpu: 64000, mem: 131072}))
        bus.apply(env.Kind.NODE_METRIC, f"n{i}", env.NodeMetric(
            node_name=f"n{i}",
            node_usage={cpu: int(rng.integers(0, 8000)),
                        mem: int(rng.integers(0, 16384))},
            update_time=90.0))

    log = []
    for t in range(AUDIT_TICKS):
        now = 100.0 + 2.0 * t
        for i in rng.choice(AUDIT_NODES, 2, replace=False):
            name = f"n{int(i)}"
            bus.apply(env.Kind.NODE_METRIC, name, env.NodeMetric(
                node_name=name,
                node_usage={cpu: int(rng.integers(0, 12000)),
                            mem: int(rng.integers(0, 32768))},
                update_time=now))
        for j in range(4):
            pod = env.PodSpec(
                name=f"t{t}p{j}",
                requests={cpu: int(rng.integers(200, 2000)),
                          mem: int(rng.integers(128, 2048))})
            bus.apply(env.Kind.POD, pod.uid, pod)
        if cutoff_of_tick is not None:
            for _, s, _ in seats:
                s.model.host_fallback_cells = cutoff_of_tick(t)
        if saboteur is not None:
            saboteur.inject(t)
        out = None
        for elector, sched, auditor in seats:
            if elector is None:
                out = sched.schedule_pending(now=now)
                info["solvers"].append(sched.model.last_solver)
                continue
            if kill_leader and elector is seats[0][0] and t >= KILL_TICK:
                continue  # killed: the deposed leader never ticks again
            if elector.tick(now):
                auditor.on_round(now=now)
                out = sched.schedule_pending(now=now)
                info["solvers"].append(sched.model.last_solver)
        if out is None:
            raise AssertionError(f"no leader ran tick {t}")
        log.append((t, sorted(out.items())))
    return log, bus, info


class HBMSaboteur:
    """Executes a schedule's :data:`HBM_FAULT_KINDS` against a
    working-set manager (``WORKING_SET`` unless given):

    - ``alloc-fail-stage`` / ``alloc-fail-scatter``: arm one injected
      allocation failure at that boundary; the next staging (or scatter)
      raises before any device work runs, forcing the typed
      demote-and-retry ladder, whose retry runs the callable once.
    - ``budget-squeeze-mid-churn``: the budget is halved and enforced
      (residents demote, best-effort lanes first), then restored.

    ``inject(tick)`` returns the kind applied (None when nothing was
    scheduled); ``injected`` counts per kind and ``log`` keeps ``(tick,
    kind, detail)``."""

    def __init__(self, schedule: FaultSchedule, manager=None):
        from koordinator_tpu_torch.state.workingset import WORKING_SET

        self.schedule = schedule
        self.manager = manager if manager is not None else WORKING_SET
        self.injected: Dict[str, int] = {}
        self.log: list = []

    def inject(self, tick: int) -> Optional[str]:
        kind = self.schedule.fault_for(tick)
        if kind is None or kind not in HBM_FAULT_KINDS:
            return None
        detail = getattr(self, "_" + kind.replace("-", "_"))()
        self.injected[kind] = self.injected.get(kind, 0) + 1
        self.log.append((tick, kind, detail))
        return kind

    def _alloc_fail_stage(self) -> str:
        self.manager.arm_fault("stage")
        return "armed:stage"

    def _alloc_fail_scatter(self) -> str:
        self.manager.arm_fault("scatter")
        return "armed:scatter"

    def _budget_squeeze_mid_churn(self) -> str:
        demoted = self.manager.squeeze(0.5)
        return f"squeezed:demoted={demoted}"


class InProcessSidecar:
    """A :class:`PlacementService` behind a subprocess-like handle:
    ``kill()`` severs every live connection and stops serving (what a
    SIGKILL looks like at the wire), ``poll()`` reports the exit code,
    and a respawn is a fresh handle on the same address.
    ``service_kwargs`` go to the service (``device="cpu"`` on a machine
    without CUDA)."""

    _next_pid = [1000]

    def __init__(self, address, warm_restored: Optional[bool] = None,
                 **service_kwargs):
        from koordinator_tpu_torch.service.server import PlacementService

        self._service = PlacementService(address, **service_kwargs)
        self._service.start()
        self._returncode: Optional[int] = None
        self._lock = threading.Lock()
        InProcessSidecar._next_pid[0] += 1
        self.pid = InProcessSidecar._next_pid[0]
        #: the handle-borne warm/cold restore outcome that
        #: SolverSupervisor's default ``warm_outcome_fn`` reads (None =
        #: undecided): tests set it to drive the probe-budget split
        #: without a debug mux round trip
        self.warm_restored = warm_restored

    def poll(self) -> Optional[int]:
        with self._lock:
            return self._returncode

    def kill(self) -> None:
        with self._lock:
            if self._returncode is not None:
                return
            self._returncode = -9
        self._service.stop()

    terminate = kill

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        return self.poll()

    @property
    def service(self):
        return self._service
