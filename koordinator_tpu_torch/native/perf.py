"""ctypes binding for the native perf-group reader (perf_group.cpp).

Build model: the shared library compiles on first use (g++, cached in
``koordinator_tpu_torch/_build/`` by modification time); the reference
builds its cgo module via hack/libpfm.sh at test time, this is the
equivalent. The build writes a temporary name and renames it into place,
so processes that build at once never load a torn library.
``PerfGroup.open_self`` profiles the current process;
``PerfGroup.open_cgroup`` profiles a cgroup (one fd per cpu, summed on
read) like the reference's per-container collectors; ``PerfGroup.fake``
is the deterministic test backend.

Counterpart of ``koordinator_tpu/native/perf.py``: the same library and
bindings.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

_SRC = os.path.join(os.path.dirname(__file__), "perf_group.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
_LIB = os.path.join(BUILD_DIR, "libkoordperf.so")
_PERF_FLAG_PID_CGROUP = 1 << 2  # include/uapi/linux/perf_event.h

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class PerfUnavailable(RuntimeError):
    """perf_event_open failed (permissions, kernel config, platform)."""


def ensure_built() -> str:
    """Compile the shared library if missing/stale; returns its path."""
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            try:
                path = ensure_built()
            except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
                # no compiler / compile error: perf is host-unavailable,
                # not a transient per-container condition
                raise PerfUnavailable(f"native perf build failed: {e}") from e
            lib = ctypes.CDLL(path)
            lib.kp_open.restype = ctypes.c_void_p
            lib.kp_open.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_ulong,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.kp_open_fake.restype = ctypes.c_void_p
            lib.kp_open_fake.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong]
            lib.kp_read_counters.restype = ctypes.c_int
            lib.kp_read_counters.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_ulonglong),
                ctypes.POINTER(ctypes.c_ulonglong),
            ]
            lib.kp_close.restype = None
            lib.kp_close.argtypes = [ctypes.c_void_p]
            lib.kp_version.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class PerfGroup:
    """One cycles+instructions counter group (possibly multiple fds for
    per-cpu cgroup profiling, summed on read)."""

    def __init__(self, handles):
        self._handles = list(handles)

    # -- constructors -------------------------------------------------------

    @classmethod
    def open_self(cls) -> "PerfGroup":
        lib = _load()
        err = ctypes.c_int(0)
        h = lib.kp_open(0, -1, 0, ctypes.byref(err))
        if not h:
            raise PerfUnavailable(f"perf_event_open failed (errno {err.value})")
        return cls([h])

    @classmethod
    def open_cgroup(cls, cgroup_dir_fd: int, cpus) -> "PerfGroup":
        """Profile a cgroup: one group per cpu (perf_event_open requires
        cpu >= 0 with PERF_FLAG_PID_CGROUP), summed on read — the
        reference's per-container collector layout."""
        lib = _load()
        handles = []
        err = ctypes.c_int(0)
        for cpu in cpus:
            h = lib.kp_open(
                cgroup_dir_fd, int(cpu), _PERF_FLAG_PID_CGROUP,
                ctypes.byref(err),
            )
            if not h:
                for held in handles:
                    lib.kp_close(held)
                raise PerfUnavailable(
                    f"perf_event_open(cgroup) failed (errno {err.value})"
                )
            handles.append(h)
        return cls(handles)

    @classmethod
    def fake(cls, cycles_step: int, instr_step: int) -> "PerfGroup":
        lib = _load()
        return cls([lib.kp_open_fake(cycles_step, instr_step)])

    # -- reading ------------------------------------------------------------

    def read(self) -> Tuple[int, int]:
        """(cumulative cycles, cumulative instructions)."""
        lib = _load()
        cycles = instr = 0
        for h in self._handles:
            c = ctypes.c_ulonglong(0)
            i = ctypes.c_ulonglong(0)
            rc = lib.kp_read_counters(h, ctypes.byref(c), ctypes.byref(i))
            if rc != 0:
                raise PerfUnavailable(f"perf read failed (errno {rc})")
            cycles += c.value
            instr += i.value
        return cycles, instr

    def close(self) -> None:
        lib = _load()
        for h in self._handles:
            lib.kp_close(h)
        self._handles = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
