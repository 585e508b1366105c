"""DeviceObservatory: the device-side twin of the span tracer (the CUDA
counterpart of ``koordinator_tpu/obs/device.py``).

The trace fabric makes the host side of every round observable; this
module covers the device side with three surfaces, all off the solve's
critical path:

- **Compile telemetry.** The port compiles one thing: the kernel
  library, built by ``nvcc`` at first use
  (``ops/binpack_kernel.build_library``). A build is recorded — count,
  wall and the build's ``ptxas`` lines (registers, shared memory and
  spills of every kernel instance) — into
  ``solver_device_compile_total{fn}`` / ``solver_device_compile_seconds``
  and a bounded ring served by :meth:`debug_payload`. A process that only
  loads an already-built library records nothing.
- **Live buffers.** On CUDA, the caching allocator's numbers
  (``torch.cuda.memory_allocated``, ``memory_reserved``,
  ``max_memory_allocated``, the allocator's ``num_alloc_retries`` and
  its current allocation count), plus registered per-owner bytes (the
  placement model registers its staged state cache) and the HBM working
  set's pressure view (:meth:`DeviceObservatory.set_pressure_source`,
  budget, charge and per-rung census). A process that has not
  initialised CUDA reports the owners and the pressure view only.
  Sampled on status/debug reads, never on the tick path.
- **On-demand profiler windows.** :meth:`request_profile` arms a
  ``torch.profiler.profile`` window over the next K scheduling rounds
  (``on_round`` is called by ``Scheduler.begin_tick``), with CPU and CUDA
  activity for a CUDA model and CPU activity alone when the caller asked
  for the CPU. :meth:`annotate` scopes (``ktpu:device_solve``,
  ``ktpu:read_back``, ``ktpu:prestage``) are ``record_function`` ranges
  inside a window. Where the installed PyTorch can profile every thread
  (``_ExperimentalConfig(profile_all_threads=True)``), it does, so the
  publisher thread's ``read_back`` ranges are recorded too; otherwise
  only the thread that opened the window records ranges (CUPTI's kernel
  and copy records are process-wide either way), and ``status()`` says
  which. Each window writes one Chrome trace under ``profile_dir``;
  windows are rate-limited and disk-capped like the flight recorder's
  dumps.

The tick contract mirrors the tracer's: the observatory on or off is
observation only — same placements, bit for bit.

- **Warm manifest.** A device program's call site is a binding
  (:meth:`DeviceObservatory.bind`, :class:`ObservedCall`): the
  counterpart of the reference's ``ObservedJit`` without a jit. It asks
  the warm pool first (``service/warmpool.py``: a restored CUDA graph
  answers a call whose signature it captured), then runs the program
  and records the call's signature: the tree of its arguments with each
  tensor as a :class:`TensorSpec` (shape, dtype, device) and every
  other leaf by value. The first :data:`_MAX_WARM` signatures are the
  manifest (:meth:`warm_manifest`) that the pool persists; while the
  pool records, each keeps a host copy of its first call's tensors
  (:class:`Sample`: issued without a sync, read once the copy is done),
  the sample from which a restore captures its graph. A copy, never a
  reference: a staged base the working set demotes must free its bytes.

Deliberate differences from the reference: there is no counterpart of
``jit``, ``analyze``, ``note_padding``, ``padding_waste``,
``compile_ring``, the ``jax.monitoring`` listener, ``mark`` or
``fingerprint``. They need XLA programs, bucket padding or the bench,
none of which the port has; the kernels' bounds are computed by
``chip_smoke.py`` and kept in PERF.md. The SLO controller's device
observation reads :attr:`compiles_total` (the kernel-library builds)
and a padding waste of 0.0: the port never pads.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
import weakref
from collections import deque
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.metrics.components import (
    DEVICE_COMPILE_SECONDS,
    DEVICE_COMPILES,
    DEVICE_LIVE_BUFFERS,
    DEVICE_LIVE_BYTES,
    DEVICE_PROFILE_WINDOWS,
)
from koordinator_tpu_torch.obs.trace import TRACER

#: compile records kept for the debug payload and flight dumps
_RING_CAPACITY = 256

_NULL_CTX = nullcontext()

#: (fn, signature) pairs retained for the warm-pool manifest: the hot
#: set, not an archive
_MAX_WARM = 64

#: sentinel the warm pool's serve() returns on a miss (any real result,
#: None included, is an answer)
WARM_MISS = object()


class TensorSpec(NamedTuple):
    """A tensor argument in a call's signature: what a restore needs to
    allocate its static buffer."""

    shape: tuple
    dtype: torch.dtype
    device: str


def _signature(tree):
    """The call's signature: ``tree`` with every tensor as its
    :class:`TensorSpec`; tuples and named tuples keep their type, None,
    numbers and strings stay as they are. Hashable, picklable, and
    idempotent (a signature is its own signature). Anything else raises
    ``TypeError``: such a call has no signature and is never warm."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype, str(tree.device))
    if isinstance(tree, TensorSpec) or tree is None or isinstance(
            tree, (bool, int, float, str, torch.dtype)):
        return tree
    if isinstance(tree, tuple):
        items = tuple(_signature(x) for x in tree)
        return type(tree)(*items) if hasattr(tree, "_fields") else items
    raise TypeError(f"no signature for a {type(tree).__name__}")


def _map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor (tuple types kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = tuple(_map_tensors(x, fn) for x in tree)
        return type(tree)(*items) if hasattr(tree, "_fields") else items
    return tree


class Sample:
    """A host copy of one call's arguments: CUDA tensors copied to pinned
    host memory without a sync (an event marks the copies' end), CPU
    tensors cloned. :meth:`tree` waits for the copies."""

    __slots__ = ("_tree", "_event")

    def __init__(self, args: tuple):
        cuda = []

        def copy(t):
            if t.device.type == "cuda":
                cuda.append(t.device)
                return t.detach().to("cpu", non_blocking=True)
            return t.detach().clone()

        self._tree = _map_tensors(args, copy)
        self._event = None
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda[0]))

    def tree(self) -> tuple:
        if self._event is not None:
            self._event.synchronize()
        return self._tree


class ObservedCall:
    """A device program's binding: the warm pool first, then the program,
    whose call's signature is recorded for the warm manifest. The
    binding holds no state of its own; ``_warm`` is set once, when the
    pool adopts it (``WarmPool.adopt``, which captures ``fn``), and read
    per call without a lock, as ``enabled`` is."""

    __slots__ = ("fn_name", "fn", "_obs", "_warm")

    def __init__(self, fn_name: str, fn, obs: "DeviceObservatory"):
        self.fn_name = fn_name
        self.fn = fn
        self._obs = obs
        self._warm = None

    def __call__(self, *args):
        warm = self._warm
        if warm is not None and warm.serving:
            # a restored graph answers the call; a miss (an unknown
            # signature, an ejected entry) falls through to the program
            out = warm.serve(self.fn_name, args, {})
            if out is not WARM_MISS:
                return out
        out = self.fn(*args)
        if self._obs.enabled and self._obs._record_call(
                self.fn_name, args, warm is not None and warm.recording):
            warm.note_signature()
        return out


def _default_profile_dir() -> str:
    return os.environ.get(
        "KTPU_PROFILE_DIR",
        os.path.join(tempfile.gettempdir(), "koord-profile"),
    )


def _all_threads_config() -> dict:
    """``torch.profiler.profile`` keyword arguments that profile every
    thread, or ``{}`` where the installed PyTorch has no such switch."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def weak_owner(obj, nbytes_fn):
    """A zero-argument bytes callable over ``obj`` through a weak
    reference: the process-global observatory must never keep a
    torn-down owner alive. ``nbytes_fn(obj)`` gives the bytes; a
    collected owner reports 0."""
    ref = weakref.ref(obj)

    def nbytes():
        live = ref()
        return 0 if live is None else nbytes_fn(live)

    return nbytes


class DeviceObservatory:
    """Process-global device telemetry (one per process, like the span
    tracer and the metric registries).

    ``enabled`` is a plain flag read without the lock, and
    ``_profile_hot`` the matching fast-path flag of :meth:`on_round` and
    :meth:`annotate`; every other mutable attribute below is read and
    written under ``_lock``. Profiler start, stop and trace export run
    outside it, serialised end to end by ``_profile_io_lock`` (taken
    first, ``_lock`` inside it, never the reverse)."""

    def __init__(self, clock=time.monotonic):
        self.enabled = True
        self._profile_hot = False
        self._clock = clock
        self._lock = threading.Lock()
        self._profile_io_lock = threading.Lock()
        #: newest-last compile records {seq, fn, at, compile_s, ptxas}
        self._ring: deque = deque(maxlen=_RING_CAPACITY)
        #: owner name -> callable() -> bytes (live-buffer attribution)
        self._owners: Dict[str, object] = {}
        #: the working-set manager's pressure view (a zero-argument
        #: callable returning budget/used/residency), or None
        self._pressure_source = None
        self._seq = 0
        self._compiles_total = 0
        #: (fn_name, signature) -> [signature, sample]: the warm-pool
        #: manifest source (bounded by _MAX_WARM); the sample is the
        #: first call's arguments, kept only while a pool records
        self._warm_avals: Dict = {}
        #: profiler window state machine
        self._profile_dir: Optional[str] = None
        self._profile_min_interval_s = 30.0
        self._profile_max_windows = 8
        self._profile_armed = 0       # rounds requested, not yet started
        self._profile_remaining = 0   # rounds left in the active window
        self._profile_activities: List = []
        self._profile_path: Optional[str] = None
        self._profiler = None         # the active torch.profiler.profile
        self._profile_threads: Optional[str] = None
        self._profile_last_at: Optional[float] = None
        self._profile_windows: List[str] = []
        self._profile_error: Optional[str] = None

    # -- configuration -------------------------------------------------------

    def set_enabled(self, on: bool) -> None:
        self.enabled = bool(on)

    def configure(self, profile_dir: Optional[str] = None,
                  profile_min_interval_s: Optional[float] = None,
                  profile_max_windows: Optional[int] = None) -> None:
        """Runtime configuration (cmd flags / tests)."""
        with self._lock:
            if profile_dir is not None:
                self._profile_dir = profile_dir
            if profile_min_interval_s is not None:
                self._profile_min_interval_s = profile_min_interval_s
            if profile_max_windows is not None:
                self._profile_max_windows = profile_max_windows

    def register_owner(self, name: str, nbytes_fn) -> None:
        """Attribute live bytes to a named owner (a zero-argument
        callable; metadata only, no sync). Last registration per name
        wins."""
        with self._lock:
            self._owners[name] = nbytes_fn

    def set_pressure_source(self, fn) -> None:
        """Register the working-set manager's pressure view (a cheap
        zero-argument callable returning budget/used/residency), carried
        in :meth:`live_snapshot` beside what is live. Last registration
        wins."""
        with self._lock:
            self._pressure_source = fn

    @property
    def compiles_total(self) -> int:
        """Kernel-library builds this process recorded."""
        with self._lock:
            return self._compiles_total

    # -- compile telemetry ---------------------------------------------------

    def record_compile(self, fn_name: str, wall: float,
                       log: str = "") -> None:
        """A kernel library was built (``nvcc``): count it, time it and
        keep its ``ptxas`` lines in the ring."""
        if not self.enabled:
            return
        ptxas = [line.strip() for line in log.splitlines()
                 if "ptxas" in line]
        with self._lock:
            self._seq += 1
            self._compiles_total += 1
            self._ring.append({
                "seq": self._seq,
                "fn": fn_name,
                "at": time.time(),
                "compile_s": wall,
                "ptxas": ptxas,
            })
        DEVICE_COMPILES.inc({"fn": fn_name})
        DEVICE_COMPILE_SECONDS.observe(wall, {"fn": fn_name})
        TRACER.instant("device-compile", cat="device",
                       args={"fn": fn_name, "compile_s": round(wall, 4)})

    # -- the warm manifest ---------------------------------------------------

    def bind(self, fn_name: str, fn) -> ObservedCall:
        """The binding of a device program ``fn`` under ``fn_name``."""
        return ObservedCall(fn_name, fn, self)

    def _record_call(self, fn_name: str, args: tuple,
                     keep_sample: bool) -> bool:
        """Record a call's signature (and, with ``keep_sample``, a host
        copy of its arguments) if it is new; True when a sample was kept."""
        try:
            sig = _signature(args)
        except TypeError:
            return False
        key = (fn_name, sig)
        with self._lock:
            row = self._warm_avals.get(key)
            wanted = (row is None and len(self._warm_avals) < _MAX_WARM
                      ) or (row is not None and row[1] is None
                            and keep_sample)
        if not wanted:
            return False
        sample = Sample(args) if keep_sample else None
        with self._lock:
            row = self._warm_avals.get(key)
            if row is None:
                if len(self._warm_avals) >= _MAX_WARM:
                    return False
                self._warm_avals[key] = [sig, sample]
            elif row[1] is None:
                row[1] = sample
            else:
                return False
        return sample is not None

    def warm_manifest(self) -> List[Tuple[str, tuple, Optional[Sample]]]:
        """The hot set for the warm pool: every recorded (binding x
        signature) as ``(fn_name, signature, sample)``, the
        :class:`Sample` None where none was kept. Snapshotting is safe at
        any time."""
        with self._lock:
            return [(fn_name, row[0], row[1])
                    for (fn_name, _sig), row in self._warm_avals.items()]

    # -- live buffers --------------------------------------------------------

    def live_snapshot(self) -> dict:
        """The caching allocator's numbers for the current CUDA device
        (when this process has initialised CUDA) and each registered
        owner's bytes. Reads counters only: no device sync."""
        with self._lock:
            owners = dict(self._owners)
            pressure = self._pressure_source
        by_owner = {}
        for name, fn in owners.items():
            try:
                by_owner[name] = int(fn())
            except Exception as e:  # a broken owner never loses a read
                by_owner[name] = f"{type(e).__name__}: {e}"
        out: dict = {"owners": by_owner}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            out.update({
                "device": torch.cuda.get_device_name(),
                "count": int(stats.get("allocation.all.current", 0)),
                "bytes": int(torch.cuda.memory_allocated()),
                "reserved_bytes": int(torch.cuda.memory_reserved()),
                "max_allocated_bytes": int(torch.cuda.max_memory_allocated()),
                "alloc_retries": int(stats.get("num_alloc_retries", 0)),
            })
            DEVICE_LIVE_BUFFERS.set(out["count"])
            DEVICE_LIVE_BYTES.set(out["bytes"])
        if pressure is not None:
            try:
                out["workingset"] = pressure()
            except Exception as e:  # a broken source never loses a read
                out["workingset"] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # -- profiler windows ----------------------------------------------------

    def request_profile(self, rounds: int = 8,
                        device: DeviceLike = None) -> dict:
        """Arm a profiler window over the next ``rounds`` scheduling
        rounds of a model on ``device`` (``cuda`` unless given). Refused
        while a window is armed/active; rate-limited between windows.
        Raises when a CUDA window is asked of a PyTorch without CUDA
        profiling: a CUDA model's window is never a CPU profile."""
        dev = resolve_device(device)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            cuda = torch.profiler.ProfilerActivity.CUDA
            if cuda not in torch.profiler.supported_activities():
                raise RuntimeError(
                    "torch.profiler has no CUDA activity in this build: "
                    "no profile window for a CUDA model")
            activities.append(cuda)
        rounds = max(1, int(rounds))
        now = self._clock()
        with self._lock:
            if self._profile_armed or self._profile_remaining:
                DEVICE_PROFILE_WINDOWS.inc({"result": "refused"})
                return {"error": "profile window already armed/active"}
            last = self._profile_last_at
            if last is not None and \
                    now - last < self._profile_min_interval_s:
                DEVICE_PROFILE_WINDOWS.inc({"result": "rate-limited"})
                return {
                    "error": "rate-limited",
                    "retry_in_s": self._profile_min_interval_s
                    - (now - last),
                }
            self._profile_last_at = now
            self._profile_armed = rounds
            self._profile_activities = activities
            self._profile_error = None
            target = self._profile_dir or _default_profile_dir()
        self._profile_hot = True
        return {"armed": True, "rounds": rounds, "dir": target,
                "device": dev.type}

    def on_round(self) -> None:
        """Round boundary hook (``Scheduler.begin_tick``): drives the
        armed→active→closed profile window. One plain-flag read when no
        window is in play."""
        if not self._profile_hot:
            return
        with self._profile_io_lock:
            self._window_transition()

    def _window_transition(self) -> None:
        action = None
        with self._lock:
            if self._profile_armed:
                self._seq += 1
                path = os.path.join(
                    self._profile_dir or _default_profile_dir(),
                    f"window-{self._seq:04d}.json",
                )
                self._profile_remaining = self._profile_armed
                self._profile_armed = 0
                self._profile_path = path
                action = ("start", path, list(self._profile_activities))
            elif self._profile_remaining > 1:
                self._profile_remaining -= 1
            elif self._profile_remaining == 1:
                self._profile_remaining = 0
                path = self._profile_path
                self._profile_path = None
                prof, self._profiler = self._profiler, None
                self._profile_hot = False
                action = ("stop", path, prof)
        if action is None:
            return
        kind, path, arg = action
        try:
            if kind == "start":
                os.makedirs(os.path.dirname(path), exist_ok=True)
                config = _all_threads_config()
                prof = torch.profiler.profile(activities=arg, **config)
                prof.start()
                with self._lock:
                    self._profiler = prof
                    self._profile_threads = ("all" if config
                                             else "opening thread")
                TRACER.instant("profile-window-open", cat="device",
                               args={"path": path})
            else:
                arg.stop()
                arg.export_chrome_trace(path)
                TRACER.instant("profile-window-closed", cat="device")
                DEVICE_PROFILE_WINDOWS.inc({"result": "written"})
                # track + disk-cap ONLY after a successful stop: a
                # failed stop must neither list a broken window as
                # written nor prune an old one
                pruned = None
                with self._lock:
                    self._profile_windows.append(path)
                    if len(self._profile_windows) > \
                            self._profile_max_windows:
                        pruned = self._profile_windows.pop(0)
                if pruned is not None:
                    if os.path.isdir(pruned):
                        shutil.rmtree(pruned, ignore_errors=True)
                    else:
                        try:
                            os.unlink(pruned)
                        except OSError:
                            pass
        except Exception as e:  # observability must never crash a round
            DEVICE_PROFILE_WINDOWS.inc({"result": "error"})
            with self._lock:
                prof, self._profiler = self._profiler, None
                self._profile_error = f"{type(e).__name__}: {e}"
                self._profile_armed = 0
                self._profile_remaining = 0
                self._profile_path = None
            self._profile_hot = False
            if kind == "start" and prof is not None:
                try:
                    prof.stop()
                except Exception:
                    pass

    def annotate(self, name: str):
        """A ``torch.profiler.record_function`` range (``ktpu:<name>``)
        while a profile window is in play, so device events line up with
        the span tracer's stage names in the trace — a shared null
        context otherwise: one flag read on the hot path."""
        if self._profile_hot:
            return torch.profiler.record_function(f"ktpu:{name}")
        return _NULL_CTX

    # -- read side -----------------------------------------------------------

    def _profile_status(self) -> dict:
        return {
            "dir": self._profile_dir or _default_profile_dir(),
            "armed_rounds": self._profile_armed,
            "active_rounds_left": self._profile_remaining,
            "windows": list(self._profile_windows),
            "min_interval_s": self._profile_min_interval_s,
            "threads": self._profile_threads,
            "last_error": self._profile_error,
        }

    def status(self) -> dict:
        """Cheap snapshot for plugin/status surfaces: counters, recent
        builds, the profile window state and a live-buffer sample."""
        with self._lock:
            payload = {
                "enabled": self.enabled,
                "compiles_total": self._compiles_total,
                "recent_compiles": [dict(r) for r in self._ring],
                "profile": self._profile_status(),
            }
        payload["live"] = self.live_snapshot()
        return payload

    def debug_payload(self) -> dict:
        """The ``/debug/device`` body. The reference materialises its
        pending XLA analyses here first; the port has none, so this is
        :meth:`status`."""
        return self.status()

    def flight_payload(self) -> dict:
        """The flight recorder's ``device`` section: did the kernel
        library just build, and how much is live."""
        with self._lock:
            payload = {
                "compiles_total": self._compiles_total,
                "recent_compiles": [dict(r) for r in list(self._ring)[-16:]],
                "profile_windows": list(self._profile_windows),
            }
        payload["live"] = self.live_snapshot()
        return payload

    def reset(self) -> None:
        """Forget telemetry (tests). Counters restart; an ACTIVE profiler
        window is stopped here (its state is being erased, so the
        on_round stop path could never close it, and a profiler left
        running would make every later window fail)."""
        with self._profile_io_lock:
            with self._lock:
                prof, self._profiler = self._profiler, None
                self._ring.clear()
                self._owners.clear()
                self._warm_avals.clear()
                self._seq = 0
                self._compiles_total = 0
                self._profile_armed = 0
                self._profile_remaining = 0
                self._profile_activities = []
                self._profile_path = None
                self._profile_threads = None
                self._profile_last_at = None
                self._profile_windows.clear()
                self._profile_error = None
            self._profile_hot = False
            if prof is not None:
                try:
                    prof.stop()
                except Exception:
                    pass


#: the process observatory every component records into (one per
#: process, like the tracer and the flight recorder)
DEVICE_OBS = DeviceObservatory()
