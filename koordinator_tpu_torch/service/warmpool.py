"""The warm pool: a respawned sidecar, a promoted leader and the failover
twin answer their first solve from a restored entry (counterpart of
``koordinator_tpu/service/warmpool.py``).

In the reference a restored entry is a deserialized XLA executable, which
skips tracing and compiling. The port compiles neither; what a cold first
solve pays on the card is the kernel library's ``nvcc`` build when
``_build/`` has none, the module loads of each kernel's and each torch
op's first launch, the allocator's first blocks, and the host's issue of
the solve's launches. So an entry here has two parts:

- **The library entry.** The store keeps the built kernel library under
  a key that names its source digest (``ops/binpack_kernel._digest``). A
  restore puts it into the build directory when the library for the
  current sources is missing there (a temporary name, then
  ``os.replace``, as ``build_library`` does). With
  ``compile_missing=False`` a restore never runs ``nvcc``.
- **The signature entries.** Each manifest row is a (program x static
  config x signature) from ``DEVICE_OBS.warm_manifest()``: the config
  holds the route and CTA count ``kernel_route`` picks (and the weight
  sum and NUMA scorer); the signature the shapes, dtypes and device of
  the tensor arguments; the entry one sample of their values. On
  ``cuda`` a restore copies the sample into static input buffers, runs
  the program once on them (the module loads), then captures its device
  work as a ``torch.cuda.CUDAGraph``. :meth:`WarmPool.serve` copies a
  call's tensors into the static inputs, replays, and returns copies of
  the static outputs. On the CPU there is no graph: a restored row runs
  the program through the same copy-in and copy-out.

Entries are keyed by PROGRAM identity (the program function's module and
qualname, the config, the signature), not by binding, so the sidecar's
``sidecar_solve_batch``, the model's ``solve_batch`` and the failover
twin's ``failover_local_solve`` share one store: signatures a sidecar
persisted warm the scheduler's failover twin in another process.

**Hard rules**, in the port's terms:

- *The warm path never donates.* A served result never aliases the
  graph's static buffers: every output that is not one of the call's own
  inputs is a copy, so a second served call at the same signature leaves
  the first call's result unchanged. Calls at one signature are
  serialised by the entry's lock (copy-in, replay and copy-out never
  interleave), and, being issued on one stream, run in that order.
- *Single device only.* The pool serves and restores only in a process
  that sees at most one CUDA device (``force_single_device`` overrides
  the gate for tests).
- *Every load failure is typed, counted and quarantined.* The store
  lives on disk across crashes; torn, bit-flipped, oversized,
  stale-host, version-skewed or foreign entries surface as the
  ``WarmEntryError`` family (``utils/compilation_cache.py``), count
  ``scheduler_warm_pool_rejects_total`` with their reason (clean
  absences count ``..._misses_total``), move aside to ``*.quarantined``
  (never retried in a loop), and leave that shape cold. A library entry
  whose digest is not the current sources' is version skew. A capture
  that fails at restore counts in the report's ``failed`` with its error
  in ``last_error``; a replay that raises is ejected and its disk entry
  quarantined. None of these crashes the process or skips a round.
- *Inert unless configured.* The store is ``KTPU_COMPILATION_CACHE_DIR``;
  empty keeps the pool inert (the test suite's default).

Deliberate differences: :meth:`WarmPool.persist` writes entries and the
manifest and installs nothing (the persisting process already has its
kernels loaded; capture is the restoring process's act), and
``compile_missing`` builds a missing kernel library and captures a row
whose entry is missing or bad from zero-filled inputs (the kernels never
index by the values a zero fill gives them). The graphs' static buffers
and outputs are device memory, registered with the device observatory
as the ``warm_pool`` owner; :meth:`WarmPool.reset` frees them.
"""

from __future__ import annotations

import importlib
import os
import pickle
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch.metrics.components import (
    WARM_POOL_HITS,
    WARM_POOL_MISSES,
    WARM_POOL_QUARANTINED,
    WARM_POOL_REJECTS,
    WARM_RESTORE_SECONDS,
)
from koordinator_tpu_torch.obs.device import (
    DEVICE_OBS,
    WARM_MISS,
    TensorSpec,
    _map_tensors,
    _signature,
    weak_owner,
)
from koordinator_tpu_torch.obs.trace import TRACER
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.utils.compilation_cache import (
    ExecutableCache,
    WarmEntryCorrupt,
    WarmEntryError,
    WarmEntryOversized,
    WarmEntryVersionSkew,
    frame_payload,
    max_entry_bytes,
    unframe_payload,
)

#: manifest rows kept and restored at most
_MAX_MANIFEST = 128

#: the background persister's longest sleep (it wakes at once on a new
#: signature); tests drive persist() inline
_PERSIST_INTERVAL_S = 30.0

#: programs a manifest row may name when no binding registered them: the
#: port's own modules, never an arbitrary import from a store file
_PROGRAM_PREFIX = "koordinator_tpu_torch."


# -- argument trees --------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of ``tree``, in :func:`_map_tensors`' order."""
    out: List[torch.Tensor] = []
    _map_tensors(tree, out.append)
    return out


def _materialize(spec, sample):
    """Fresh tensors for the signature ``spec``: the sample's values
    (host arrays at the tensors' places) or, with no sample, zeros."""
    if isinstance(spec, TensorSpec):
        if sample is None:
            return torch.zeros(spec.shape, dtype=spec.dtype,
                               device=spec.device)
        a = np.asarray(sample)
        if tuple(a.shape) != tuple(spec.shape):
            raise WarmEntryCorrupt(
                f"sample {a.shape} does not match the signature "
                f"{spec.shape}")
        return torch.from_numpy(a.copy()).to(device=spec.device,
                                             dtype=spec.dtype).contiguous()
    if isinstance(spec, tuple):
        if sample is None:
            sample = (None,) * len(spec)
        elif not isinstance(sample, tuple) or len(sample) != len(spec):
            raise WarmEntryCorrupt("sample does not match the signature")
        items = tuple(_materialize(a, b) for a, b in zip(spec, sample))
        return type(spec)(*items) if hasattr(spec, "_fields") else items
    return spec


def _config_key(config) -> tuple:
    """Static config as a hashable, serializable key component."""
    try:
        return tuple(config)
    except TypeError:
        return (repr(config),)


def _disk_key(program: str, config, sig) -> str:
    """The store key of a signature entry: program identity + static
    config + signature, deterministic across processes."""
    import hashlib

    body = repr((_config_key(config), sig)).encode()
    digest = hashlib.blake2b(body, digest_size=12).hexdigest()
    return f"warm|{program}|{digest}"


def _library_key(digest: str) -> str:
    return f"library|{digest}"


class _Registration:
    """One adopted binding: the program function, where its static config
    sits in the positional call, and the program identity shared across
    processes and binding names."""

    __slots__ = ("fn_name", "fun", "config_argpos", "program")

    def __init__(self, fn_name: str, fun, config_argpos: int):
        self.fn_name = fn_name
        self.fun = fun
        self.config_argpos = config_argpos
        self.program = f"{fun.__module__}.{fun.__qualname__}"


class _Entry:
    """One restored (program x config x signature): static input buffers
    and, on ``cuda``, the captured graph with its output buffers."""

    def __init__(self, fun, argpos: int, config, static: tuple):
        self.fun = fun
        self.argpos = argpos
        self.config = config
        self.static = static
        self.static_leaves = _tensors(static)
        self._index = {id(t): i for i, t in enumerate(self.static_leaves)}
        self.kind = bk.program_kind(config)
        self.lock = threading.Lock()
        self.graph = None
        self.out = None

    def _call(self, arrays: tuple):
        argpos = self.argpos
        return self.fun(*arrays[:argpos], self.config, *arrays[argpos:])

    def capture(self) -> None:
        """On ``cuda``: one ordinary run on the static inputs (a side
        stream; it loads every module the program launches), then the
        capture. Launches recorded into the graph are not counted."""
        device = self.static_leaves[0].device
        if device.type != "cuda":
            return
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._call(self.static)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._call(self.static)
        self.graph, self.out = graph, out

    def run(self, arrays: tuple):
        """The program's answer at these arguments: copy-in, replay (or
        the program, on the CPU), copy-out."""
        leaves = _tensors(arrays)
        if len(leaves) != len(self.static_leaves):
            raise ValueError("the call's tensors do not match the entry")
        with self.lock:
            for dst, src in zip(self.static_leaves, leaves):
                dst.copy_(src)
            if self.graph is None:
                out = self._call(self.static)
            else:
                self.graph.replay()
                bk.count_replay(self.kind)
                out = self.out
            index = self._index
            # an output that is one of the inputs is the caller's own
            # tensor (as the program would return it); every other one
            # is a copy: nothing served aliases the entry's buffers
            return _map_tensors(
                out, lambda t: leaves[index[id(t)]] if id(t) in index
                else t.clone())

    def device_bytes(self) -> int:
        own = {id(t) for t in self.static_leaves}
        outs = [t for t in _tensors(self.out) if id(t) not in own]
        return sum(t.numel() * t.element_size()
                   for t in self.static_leaves + outs
                   if t.device.type == "cuda")


def _resolve_program(program: str, registered: Dict[str, object]):
    """The program function a row names: a registered binding's, else the
    port module's function of that qualified name; None when neither."""
    fun = registered.get(program)
    if fun is not None or not program.startswith(_PROGRAM_PREFIX):
        return fun
    module, _, name = program.rpartition(".")
    try:
        fun = getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError):
        return None
    return fun if callable(fun) else None


class WarmPool:
    """The process warm pool over an :class:`ExecutableCache` store.

    Inert until :meth:`configure` points it at a store directory.
    ``serving`` and ``recording`` are plain flags read per adopted call
    without the lock; every other mutable attribute is read and written
    under ``_lock``. Slow work (disk I/O, captures) runs outside it."""

    def __init__(self, cache: Optional[ExecutableCache] = None):
        #: True only while at least one entry is installed AND the pool
        #: is active
        self.serving = False
        #: True while the pool has a store: the bindings keep a sample
        #: of each new signature's arguments for persist()
        self.recording = cache is not None
        self._lock = threading.Lock()
        self._cache = cache
        #: whether configure() ever ran (ensure_configured's guard)
        self._configured = cache is not None
        self._single_device: Optional[bool] = None
        self._reg: Dict[str, _Registration] = {}
        #: (program, config_key, sig) -> _Entry
        self._execs: Dict = {}
        self._restore_thread: Optional[threading.Thread] = None
        #: (program, config_key, sig) already persisted (or known bad)
        self._persisted: set = set()
        #: the library key whose entry the store holds
        self._library_stored: Optional[str] = None
        #: manifest rows: (program, config_key, sig) -> (argpos, config,
        #: signature)
        self._manifest: Dict = {}
        self.hits = 0
        #: clean store misses (no entry for the key): that shape stays
        #: cold, nothing wrong with the store
        self.misses = 0
        #: typed rejection-ladder refusals by reason (truncated |
        #: corrupt | fingerprint | oversized | stale-host | version-skew)
        self.rejects: Dict[str, int] = {}
        self.quarantined = 0
        self.served = 0
        self.load_s_total = 0.0
        #: library builds and zero-filled captures of compile_missing
        self.compiles = 0
        self.last_restore: Optional[dict] = None
        self.last_error: Optional[str] = None
        self._bg_thread: Optional[threading.Thread] = None
        self._bg_stop = threading.Event()
        #: set by a binding that kept a new signature's sample: the
        #: persister's wake-up
        self._bg_wake = threading.Event()

    # -- configuration -------------------------------------------------------

    def configure(self, cache_dir: Optional[str] = None,
                  force_single_device: Optional[bool] = None) -> "WarmPool":
        """Point the pool at a store directory (None = the
        KTPU_COMPILATION_CACHE_DIR default; an empty directory keeps the
        pool inert) and re-evaluate the single-device gate
        (``force_single_device=True`` overrides it, for tests)."""
        cache = ExecutableCache(cache_dir)
        with self._lock:
            self._cache = cache if cache.dir else None
            self._configured = True
            self._single_device = force_single_device
        self.recording = cache.dir is not None
        self._refresh_serving()
        return self

    def ensure_configured(self) -> "WarmPool":
        """Configure from the environment iff :meth:`configure` never
        ran (a ``PlacementService`` built directly, no cmd entry point).
        The test suite's empty ``KTPU_COMPILATION_CACHE_DIR`` keeps this
        a no-op."""
        with self._lock:
            configured = self._configured
        if not configured:
            self.configure()
        return self

    @property
    def active(self) -> bool:
        """Whether the pool has a store AND may serve on this process's
        device topology."""
        with self._lock:
            cache = self._cache
        return cache is not None and self._is_single_device()

    def _is_single_device(self) -> bool:
        with self._lock:
            known = self._single_device
        if known is None:
            known = torch.cuda.device_count() <= 1
            with self._lock:
                self._single_device = known
        return known

    def _refresh_serving(self) -> None:
        with self._lock:
            have = bool(self._execs) and self._cache is not None
        self.serving = have and self._is_single_device()

    def adopt(self, observed, config_argpos: int) -> None:
        """Adopt an ``obs/device`` binding: record its program (the
        binding's own function, device work alone, its static config at
        ``config_argpos``) and hook the binding's call path, so that
        restored entries answer matching calls."""
        reg = _Registration(observed.fn_name, observed.fn, config_argpos)
        with self._lock:
            self._reg[observed.fn_name] = reg
        observed._warm = self

    # -- the call path -------------------------------------------------------

    def serve(self, fn_name: str, args: tuple, kwargs: dict):
        """A restored entry's answer for this call, or :data:`WARM_MISS`.
        Cost on the adopted path: one signature (tens of µs at solve
        arity) and two dict lookups under the lock, then the entry's
        copy-in, replay and copy-out."""
        if kwargs:
            return WARM_MISS
        with self._lock:
            reg = self._reg.get(fn_name)
        if reg is None or len(args) <= reg.config_argpos:
            return WARM_MISS
        config = args[reg.config_argpos]
        arrays = args[: reg.config_argpos] + args[reg.config_argpos + 1:]
        try:
            key = (reg.program, _config_key(config), _signature(arrays))
        except TypeError:
            return WARM_MISS
        with self._lock:
            entry = self._execs.get(key)
        if entry is None:
            return WARM_MISS
        try:
            out = entry.run(arrays)
        except Exception as e:
            # a broken entry must not poison every solve of this shape:
            # drop it (the program takes over), quarantine its disk entry
            # (a failure found on every restart is the retry loop the
            # load-time ladder forbids), and let the persister store a
            # fresh one
            with self._lock:
                self._execs.pop(key, None)
                self._persisted.discard(key)
                self.last_error = f"{type(e).__name__}: {e}"
                cache = self._cache
            moved = None
            if cache is not None:
                moved = cache.quarantine(_disk_key(key[0], config, key[2]))
            if moved is not None:
                with self._lock:
                    self.quarantined += 1
                WARM_POOL_QUARANTINED.inc()
            self._refresh_serving()
            TRACER.instant("warm-pool-eject", cat="warm",
                           args={"fn": fn_name,
                                 "error": f"{type(e).__name__}"})
            return WARM_MISS
        # counted only AFTER the entry answered: an ejected call that
        # fell through to the program never counts as served
        with self._lock:
            self.served += 1
        return out

    # -- persist (the running process's side) --------------------------------

    def persist(self) -> dict:
        """Make the store cover ``DEVICE_OBS.warm_manifest()``: the kernel
        library (when built), and every hot (program x config x
        signature) with a kept sample not yet persisted, as an entry of
        its sample's values; then the manifest. Idempotent and cheap when
        nothing is new; called from the background thread the cmd entry
        points start, never from the tick path."""
        if not self.active:
            return {"persisted": 0, "skipped": "inactive"}
        with self._lock:
            regs = dict(self._reg)
            cache = self._cache
        library = self._persist_library(cache)
        todo = []
        for fn_name, sig_args, sample in DEVICE_OBS.warm_manifest():
            reg = regs.get(fn_name)
            if reg is None or sample is None \
                    or len(sig_args) <= reg.config_argpos:
                continue
            argpos = reg.config_argpos
            config = sig_args[argpos]
            sig = sig_args[:argpos] + sig_args[argpos + 1:]
            pkey = (reg.program, _config_key(config), sig)
            with self._lock:
                if pkey in self._persisted:
                    continue
                self._persisted.add(pkey)
            todo.append((reg, config, sig, sample))
        persisted = 0
        for reg, config, sig, sample in todo:
            key = _disk_key(reg.program, config, sig)
            argpos = reg.config_argpos
            try:
                def make():
                    tree = sample.tree()
                    return (_map_tensors(tree[:argpos] + tree[argpos + 1:],
                                         lambda t: t.numpy()),
                            {"kind": "signature", "program": reg.program})

                if not self._store_checked(cache, key, make):
                    raise OSError(f"store write failed: {key}")
            except Exception as e:
                with self._lock:
                    self.last_error = f"{type(e).__name__}: {e}"
                    self._persisted.discard((reg.program,
                                             _config_key(config), sig))
                continue
            with self._lock:
                self._manifest[(reg.program, _config_key(config), sig)] = (
                    reg.config_argpos, config, sig)
            persisted += 1
        if persisted:
            self._write_manifest()
            TRACER.instant("warm-pool-persist", cat="warm",
                           args={"new": persisted})
        return {"persisted": persisted, "library": library}

    def _store_checked(self, cache, key: str, make) -> bool:
        """Leave a sound entry under ``key`` as it is (a hit); a missing
        one (a miss) or a bad one (typed, quarantined) is replaced by
        ``make()``'s ``(payload, meta)``."""
        t0 = time.perf_counter()
        try:
            found = cache.load_checked(key)
        except WarmEntryError as e:
            self._note_bad_entry(key, e)
        else:
            if found is not None:
                self._note_hit(time.perf_counter() - t0)
                return True
            self._note_miss()
        payload, meta = make()
        return cache.store(key, payload, meta)

    def _persist_library(self, cache) -> Optional[str]:
        """The kernel library's entry: "stored" once the store holds the
        current build, None when nothing is built here."""
        path = bk.library_path()
        if not path.exists():
            return None
        digest = bk._digest()
        key = _library_key(digest)
        with self._lock:
            if self._library_stored == key:
                return "stored"
        if not self._store_checked(cache, key, lambda: (
                path.read_bytes(), {"kind": "library", "digest": digest})):
            with self._lock:
                self.last_error = f"store write failed: {key}"
            return "failed"
        with self._lock:
            self._library_stored = key
        return "stored"

    def _note_hit(self, load_s: float) -> None:
        with self._lock:
            self.hits += 1
            self.load_s_total += load_s
        WARM_POOL_HITS.inc()

    def _note_miss(self) -> None:
        """A CLEAN miss: no entry for the key, the store is healthy."""
        with self._lock:
            self.misses += 1
        WARM_POOL_MISSES.inc()

    def _note_reject(self, reason: str) -> None:
        with self._lock:
            self.rejects[reason] = self.rejects.get(reason, 0) + 1
        WARM_POOL_REJECTS.inc({"reason": reason})

    def _note_bad_entry(self, key: str, err: WarmEntryError) -> None:
        """A typed load failure: count the reject by reason, quarantine
        the entry (renamed aside, never retried in a loop), record the
        error for the status surfaces."""
        self._note_reject(err.reason)
        with self._lock:
            self.last_error = f"{type(err).__name__}: {err}"
            cache = self._cache
        moved = cache.quarantine(key) if cache is not None else None
        if moved is not None:
            with self._lock:
                self.quarantined += 1
            WARM_POOL_QUARANTINED.inc()
        TRACER.instant("warm-pool-quarantine", cat="warm",
                       args={"reason": err.reason})

    # -- the on-disk manifest ------------------------------------------------

    def _manifest_path(self) -> Optional[str]:
        with self._lock:
            cache = self._cache
        if cache is None or not cache.dir:
            return None
        return os.path.join(cache.dir, "warm_manifest.bin")

    def _write_manifest(self) -> None:
        path = self._manifest_path()
        if path is None:
            return
        with self._lock:
            rows = [
                {"program": program, "config_argpos": argpos,
                 "config": config, "arrays": arrays}
                for (program, _ck, _sig), (argpos, config, arrays)
                in list(self._manifest.items())[-_MAX_MANIFEST:]
            ]
        try:
            body = pickle.dumps(rows)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(frame_payload(body))
            os.replace(tmp, path)
        except Exception as e:
            with self._lock:
                self.last_error = f"{type(e).__name__}: {e}"

    def _read_manifest(self) -> List[dict]:
        """The on-disk manifest rows; a bad manifest is typed, counted,
        quarantined, and returns []: every restore then stays cold."""
        path = self._manifest_path()
        if path is None or not os.path.exists(path):
            return []
        try:
            size = os.path.getsize(path)
            if size > max_entry_bytes():
                raise WarmEntryOversized(f"manifest: {size}B")
            with open(path, "rb") as f:
                body = unframe_payload(f.read(), what="manifest")
            rows = pickle.loads(body)
            if not isinstance(rows, list):
                raise WarmEntryCorrupt("manifest: not a row list")
            return rows
        except WarmEntryError as e:
            self._quarantine_manifest(path, e)
            return []
        except Exception as e:
            self._quarantine_manifest(
                path, WarmEntryCorrupt(f"manifest: {type(e).__name__}: {e}"))
            return []

    def _quarantine_manifest(self, path: str, err: WarmEntryError) -> None:
        self._note_reject(err.reason)
        with self._lock:
            self.last_error = f"{type(err).__name__}: {err}"
        try:
            os.replace(path, f"{path}.quarantined")
        except OSError:
            return
        with self._lock:
            self.quarantined += 1
        WARM_POOL_QUARANTINED.inc()

    # -- restore (the recovering process's side) -----------------------------

    def _ensure_library(self, cache, compile_missing: bool,
                        report: dict) -> bool:
        """Whether the kernel library of the current sources is in the
        build directory after restoring it from the store (or, with
        ``compile_missing``, building it)."""
        path = bk.library_path()
        if path.exists():
            report["library"] = "present"
            return True
        digest = bk._digest()
        key = _library_key(digest)
        t0 = time.perf_counter()
        try:
            found = cache.load_checked(key)
        except WarmEntryError as e:
            self._note_bad_entry(key, e)
            found = None
        else:
            if found is None:
                self._note_miss()
        if found is not None:
            payload, meta = found
            if (not isinstance(meta, dict) or meta.get("digest") != digest
                    or not isinstance(payload, bytes)):
                self._note_bad_entry(key, WarmEntryVersionSkew(
                    f"{key}: a library of sources "
                    f"{getattr(meta, 'get', lambda _k: None)('digest')!r}, "
                    f"the current sources are {digest!r}"))
            else:
                self._note_hit(time.perf_counter() - t0)
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.stem}.{os.getpid()}.so.tmp")
                tmp.write_bytes(payload)
                os.replace(tmp, path)
                report["library"] = "restored"
                return True
        if compile_missing:
            bk.build_library()
            with self._lock:
                self.compiles += 1
            report["compiled"] += 1
            report["library"] = "built"
            return True
        report["library"] = "missing"
        return False

    def restore(self, fns: Optional[Sequence[str]] = None,
                compile_missing: bool = False,
                background: bool = False) -> Optional[dict]:
        """Install the manifest's rows (``fns`` narrows to the programs of
        those bindings): each row's entry loaded, its static inputs made
        from the sample, its graph captured on ``cuda``. Rows on
        ``cuda`` first need the kernel library, restored from the store
        when the build directory lacks it. A row whose entry is missing
        or bad stays cold (``failed``), unless ``compile_missing``
        captures it from zero-filled inputs (``compiled``), which also
        lets a missing library be built with ``nvcc``. Returns the report
        ``{restored, compiled, failed, rows, library, wall_s}`` (None when
        backgrounded)."""
        if background:
            t = threading.Thread(
                target=self.restore,
                kwargs={"fns": fns, "compile_missing": compile_missing},
                daemon=True, name="warm-pool-restore",
            )
            with self._lock:
                self._restore_thread = t
            t.start()
            return None
        report = {"restored": 0, "compiled": 0, "failed": 0, "rows": 0,
                  "library": None}
        if not self.active:
            report["skipped"] = "inactive"
            with self._lock:
                self.last_restore = report
            return report
        t_start = time.perf_counter()
        rows = self._read_manifest()
        with self._lock:
            cache = self._cache
            programs = None if fns is None else {
                r.program for r in self._reg.values() if r.fn_name in fns
            }
            reg_funs = {r.program: r.fun for r in self._reg.values()}
        library: Optional[bool] = None
        for row in rows[-_MAX_MANIFEST:]:
            try:
                program = row["program"]
                argpos = int(row["config_argpos"])
                config = row["config"]
                sig = _signature(row["arrays"])
                devices = {t.device for t in _leaf_specs(sig)}
            except Exception:
                self._note_reject("corrupt")
                report["failed"] += 1
                continue
            if programs is not None and program not in programs:
                continue
            report["rows"] += 1
            ck = _config_key(config)
            with self._lock:
                installed = (program, ck, sig) in self._execs
            if installed:
                # an idempotent re-restore (promotion sweeps over an
                # unchanged store) captures nothing again
                report["restored"] += 1
                continue
            fun = _resolve_program(program, reg_funs)
            on_cuda = any(d.startswith("cuda") for d in devices)
            if on_cuda and library is None:
                library = self._ensure_library(cache, compile_missing, report)
            if fun is None or (on_cuda and not (
                    library and torch.cuda.is_available())):
                report["failed"] += 1
                continue
            key = _disk_key(program, config, sig)
            t0 = time.perf_counter()
            try:
                found = cache.load_checked(key)
            except WarmEntryError as e:
                self._note_bad_entry(key, e)
                found = None
            else:
                if found is None:
                    self._note_miss()
                else:
                    self._note_hit(time.perf_counter() - t0)
            if found is None and not compile_missing:
                report["failed"] += 1
                continue
            try:
                static = _materialize(
                    sig, None if found is None else found[0])
                entry = _Entry(fun, argpos, config, static)
                entry.capture()
            except Exception as e:
                with self._lock:
                    self.last_error = f"{type(e).__name__}: {e}"
                report["failed"] += 1
                continue
            with self._lock:
                self._execs.setdefault((program, ck, sig), entry)
                self._manifest[(program, ck, sig)] = (argpos, config, sig)
                self._persisted.add((program, ck, sig))
                if found is None:
                    self.compiles += 1
            if found is None:
                report["compiled"] += 1
            else:
                # "restored" means loaded from the store (warm): the
                # supervisor's probe-budget split reads restored > 0 as
                # a child that deserves the tight warm grace
                report["restored"] += 1
        report["wall_s"] = time.perf_counter() - t_start
        WARM_RESTORE_SECONDS.observe(report["wall_s"])
        DEVICE_OBS.register_owner("warm_pool",
                                  weak_owner(self, WarmPool.device_bytes))
        self._refresh_serving()
        with self._lock:
            self.last_restore = report
        if report["restored"] or report["compiled"] or report["failed"]:
            TRACER.instant("warm-pool-restore", cat="warm", args={
                "restored": report["restored"],
                "compiled": report["compiled"],
                "failed": report["failed"],
            })
        return report

    def wait_restored(self, timeout_s: float = 60.0) -> None:
        """Join an in-flight background restore (a no-op when none
        runs)."""
        with self._lock:
            thread = self._restore_thread
        if thread is not None:
            thread.join(timeout=timeout_s)
            with self._lock:
                if self._restore_thread is thread:
                    self._restore_thread = None

    # -- background persister ------------------------------------------------

    def note_signature(self) -> None:
        """A binding kept a new signature's sample: wake the persister (a
        crash-looping child must get its first solves persisted at once,
        or every respawn stays cold)."""
        self._bg_wake.set()

    def start_background(self,
                         interval_s: float = _PERSIST_INTERVAL_S) -> bool:
        """Persist newly observed hot signatures on a daemon thread, woken
        by each new signature and at least every ``interval_s`` (cmd entry
        points call this once; never on the tick path). True when this
        call started the thread: its caller stops it."""
        if not self.active:
            return False
        with self._lock:
            if self._bg_thread is not None and self._bg_thread.is_alive():
                return False
            self._bg_stop = threading.Event()
            stop, wake = self._bg_stop, self._bg_wake

            def _run():
                while True:
                    wake.wait(interval_s)
                    wake.clear()
                    if stop.is_set():
                        return
                    try:
                        self.persist()
                    except Exception:
                        pass  # the persister must never die loudly

            self._bg_thread = threading.Thread(
                target=_run, daemon=True, name="warm-pool-persist"
            )
            self._bg_thread.start()
        return True

    def stop_background(self) -> None:
        """Stop the persister and join it."""
        with self._lock:
            thread, self._bg_thread = self._bg_thread, None
            stop = self._bg_stop
        stop.set()
        self._bg_wake.set()
        if thread is not None:
            thread.join(timeout=5)

    # -- read side -----------------------------------------------------------

    def device_bytes(self) -> int:
        """Device bytes of the installed entries' static buffers and graph
        outputs (the ``warm_pool`` owner in ``DEVICE_OBS.live_snapshot``)."""
        with self._lock:
            entries = list(self._execs.values())
        return sum(e.device_bytes() for e in entries)

    def status(self) -> dict:
        """The ``warm-pool`` status section (``PlacementService.status()``
        and both debug muxes): counters, what is installed, the last
        restore report; never captures or touches disk."""
        with self._lock:
            programs: Dict[str, int] = {}
            for (program, _ck, _sig) in self._manifest:
                programs[program] = programs.get(program, 0) + 1
            return {
                "active": self._cache is not None,
                "serving": self.serving,
                "store_dir": None if self._cache is None
                else self._cache.dir,
                "single_device": self._single_device,
                "executables": len(self._execs),
                "graphs": sum(e.graph is not None
                              for e in self._execs.values()),
                "registered": sorted(self._reg),
                "manifest_rows": len(self._manifest),
                "library_stored": self._library_stored is not None,
                "manifest_programs": programs,
                "hits": self.hits,
                "misses": self.misses,
                "rejects": dict(self.rejects),
                "served": self.served,
                "quarantined": self.quarantined,
                "compiles": self.compiles,
                "load_seconds_total": self.load_s_total,
                "last_restore": self.last_restore,
                "last_error": self.last_error,
            }

    def flight_payload(self) -> dict:
        """The flight recorder's ``warm`` section, from counters alone (a
        dump never captures or touches disk)."""
        with self._lock:
            return {
                "serving": self.serving,
                "executables": len(self._execs),
                "hits": self.hits,
                "misses": self.misses,
                "rejects": dict(self.rejects),
                "served": self.served,
                "quarantined": self.quarantined,
                "last_error": self.last_error,
            }

    def reset(self) -> None:
        """Forget everything (tests): the entries, their graphs and
        buffers included."""
        self.stop_background()
        with self._lock:
            self._execs.clear()
            self._persisted.clear()
            self._manifest.clear()
            self._library_stored = None
            self.hits = 0
            self.misses = 0
            self.rejects = {}
            self.quarantined = 0
            self.served = 0
            self.load_s_total = 0.0
            self.compiles = 0
            self.last_restore = None
            self.last_error = None
        self.serving = False


def _leaf_specs(tree) -> List[TensorSpec]:
    """Every :class:`TensorSpec` of a signature."""
    if isinstance(tree, TensorSpec):
        return [tree]
    if isinstance(tree, tuple):
        return [s for x in tree for s in _leaf_specs(x)]
    return []


#: the process warm pool every adopted binding consults (inert until a
#: cmd entry point, or a test, configures a store directory)
WARM_POOL = WarmPool()
