"""The warm pool's on-disk store (counterpart of
``koordinator_tpu/utils/compilation_cache.py``).

The reference keeps serialized XLA executables here, so that a restarted
process skips tracing and compiling. The port compiles one thing, the
kernel library (``ops/binpack_kernel.build_library``, one ``nvcc`` per
source), and issues its solves as launches from the host. Its store
keeps what a restarted process needs to answer its first solve without
either cost (``service/warmpool.py``):

- the built kernel library, under a key that names its source digest;
- one entry per hot solve signature: the shapes, dtypes and device of
  the solve's tensors, with one sample of their values, from which a
  restore captures the solve's device work as a CUDA graph.

Every entry is framed (:func:`frame_payload`: magic, length, blake2b
digest) around a pickled record ``(host fingerprint, versions, payload,
meta)``, the reference's record shape, and every way an entry can be bad
is a typed :class:`WarmEntryError` that the pool counts and quarantines:
a store lives on disk across crashes and is read on the recovery paths,
exactly when a crash may have torn it. The framing bytes, the typed
classes and the host fingerprint on a machine without CUDA equal the
reference's.

The store directory is ``KTPU_COMPILATION_CACHE_DIR`` (the reference's
variable; empty disables the store), scoped by :func:`host_fingerprint`.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import struct
from typing import Optional, Tuple

#: default on-disk location; override with KTPU_COMPILATION_CACHE_DIR,
#: disable with KTPU_COMPILATION_CACHE_DIR=""
_DEFAULT_DIR = os.path.join(
    os.path.expanduser("~"), ".cache", "koordinator_tpu_torch", "warm-store"
)


def _cpu_fingerprint() -> str:
    """The reference's host identity: machine architecture and a hash of
    the CPU feature flags."""
    import platform

    ident = platform.machine() or "unknown"
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                # x86 exposes "flags", arm64 "Features"
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    digest = hashlib.sha256(f"{ident}|{flags}".encode()).hexdigest()[:12]
    return f"{ident}-{digest}"


def _card_identity() -> Optional[str]:
    """The first CUDA card's name, compute capability and driver, or None
    where this process has no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        return None
    major, minor = torch.cuda.get_device_capability(0)
    driver = ""
    try:
        import ctypes

        version = ctypes.c_int(0)
        ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(version))
        driver = str(version.value)
    except (OSError, AttributeError):
        pass
    return f"{torch.cuda.get_device_name(0)}|sm_{major}{minor}|{driver}"


def host_fingerprint() -> str:
    """A short identity for the code this store replays on this host: the
    reference's (the machine architecture and a hash of the CPU flags) on
    a machine without CUDA; with a card, the card's name, compute
    capability and driver are hashed in too, because the store holds a
    kernel library built for that card and graphs captured on it."""
    cpu = _cpu_fingerprint()
    card = _card_identity()
    if card is None:
        return cpu
    ident, _ = cpu.split("-", 1)
    digest = hashlib.sha256(f"{cpu}|{card}".encode()).hexdigest()[:12]
    return f"{ident}-{digest}"


def _host_scoped(cache_dir: str) -> str:
    """``cache_dir`` scoped to this host's identity (see
    :func:`host_fingerprint`). KTPU_CACHE_HOST_SCOPE=0 restores the
    shared layout for fleets known to be homogeneous."""
    if os.environ.get("KTPU_CACHE_HOST_SCOPE", "1") == "0":
        return cache_dir
    return os.path.join(cache_dir, f"host-{host_fingerprint()}")


def versions() -> str:
    """The versions an entry's bytes depend on: torch and its CUDA."""
    import torch

    return f"torch {torch.__version__} cuda {torch.version.cuda}"


# -- typed store errors --------------------------------------------------------

class WarmEntryError(Exception):
    """Base of every typed store load failure. ``reason`` is the metric
    label (``scheduler_warm_pool_rejects_total``)."""

    reason = "corrupt"


class WarmEntryTruncated(WarmEntryError):
    """The entry file ends before its declared payload does (torn write,
    torn copy, disk full)."""

    reason = "truncated"


class WarmEntryCorrupt(WarmEntryError):
    """The entry is structurally unreadable: bad magic (a foreign file)
    or a body that fails to unpickle."""

    reason = "corrupt"


class WarmEntryFingerprintMismatch(WarmEntryError):
    """The payload does not hash to the fingerprint in the header: bit
    rot or a torn overwrite. An integrity check, not a security
    boundary: the store directory must be trusted local disk, as the
    code itself is."""

    reason = "fingerprint"


class WarmEntryOversized(WarmEntryError):
    """The entry (or its declared payload) exceeds the load cap: a
    corrupt length prefix must not make a restart buffer gigabytes."""

    reason = "oversized"


class WarmEntryHostMismatch(WarmEntryError):
    """The entry names a different host (or card) than this one: a
    copied or renamed store that dodged the host-scoped directory."""

    reason = "stale-host"


class WarmEntryVersionSkew(WarmEntryError):
    """The entry was written under other torch or CUDA versions, or is a
    kernel library built from other sources than the current ones."""

    reason = "version-skew"


#: framed-entry magic (the reference's: equal bytes for equal bodies)
_ENTRY_MAGIC = b"KTPUEXE2"
#: blake2b digest bytes stored in the header
_DIGEST_SIZE = 16
#: hard cap on entry payloads; override with KTPU_WARM_MAX_ENTRY_BYTES
_MAX_ENTRY_BYTES = 512 << 20


def max_entry_bytes() -> int:
    try:
        return int(os.environ.get("KTPU_WARM_MAX_ENTRY_BYTES",
                                  _MAX_ENTRY_BYTES))
    except ValueError:
        return _MAX_ENTRY_BYTES


def frame_payload(body: bytes) -> bytes:
    """Frame ``body`` for the store: magic + 8-byte big-endian length +
    16-byte blake2b digest + body, so that a flipped bit is a typed
    :class:`WarmEntryFingerprintMismatch`."""
    digest = hashlib.blake2b(body, digest_size=_DIGEST_SIZE).digest()
    return _ENTRY_MAGIC + struct.pack(">Q", len(body)) + digest + body


def unframe_payload(raw: bytes, what: str = "entry") -> bytes:
    """Verify and strip the :func:`frame_payload` header, raising the
    typed :class:`WarmEntryError` family on every defect."""
    header = len(_ENTRY_MAGIC) + 8 + _DIGEST_SIZE
    if len(raw) < header:
        raise WarmEntryTruncated(f"{what}: {len(raw)}B is shorter than "
                                 f"the {header}B header")
    if raw[: len(_ENTRY_MAGIC)] != _ENTRY_MAGIC:
        raise WarmEntryCorrupt(f"{what}: bad magic")
    (length,) = struct.unpack(
        ">Q", raw[len(_ENTRY_MAGIC): len(_ENTRY_MAGIC) + 8]
    )
    if length > max_entry_bytes():
        raise WarmEntryOversized(
            f"{what}: declared {length}B > cap {max_entry_bytes()}B"
        )
    digest = raw[len(_ENTRY_MAGIC) + 8: header]
    body = raw[header:]
    if len(body) < length:
        raise WarmEntryTruncated(
            f"{what}: payload {len(body)}B < declared {length}B"
        )
    body = body[:length]
    if hashlib.blake2b(body, digest_size=_DIGEST_SIZE).digest() != digest:
        raise WarmEntryFingerprintMismatch(f"{what}: payload fingerprint "
                                           f"does not match header")
    return body


def _backend_ident() -> str:
    """The device identity a store key is scoped by (the reference's
    platform and device kind)."""
    import torch

    if torch.cuda.is_available():
        return f"cuda|{torch.cuda.get_device_name(0)}"
    return "cpu"


class ExecutableCache:
    """The warm store: framed entries under ``<dir>/executables``, one
    file per key. :meth:`store` writes ``(payload, meta)`` with its
    provenance; :meth:`load_checked` returns them or raises typed;
    :meth:`quarantine` moves a bad entry aside."""

    def __init__(self, cache_dir: Optional[str] = None):
        if cache_dir is None:
            cache_dir = os.environ.get(
                "KTPU_COMPILATION_CACHE_DIR", _DEFAULT_DIR
            )
        self.dir = (
            os.path.join(_host_scoped(cache_dir), "executables")
            if cache_dir else None
        )

    def _path(self, key: str) -> Optional[str]:
        if not self.dir:
            return None
        ident = f"{key}|{_backend_ident()}|{versions()}"
        digest = hashlib.sha256(ident.encode()).hexdigest()[:24]
        return os.path.join(self.dir, f"{digest}.exec")

    def load_checked(self, key: str) -> Optional[Tuple[object, object]]:
        """``(payload, meta)`` stored for ``key``; None when no entry
        exists. Every other outcome is a typed :class:`WarmEntryError`:
        truncated, corrupt, oversized, fingerprint-mismatched, stale-host
        or version-skewed."""
        path = self._path(key)
        if path is None or not os.path.exists(path):
            return None
        try:
            size = os.path.getsize(path)
        except OSError:
            return None
        if size > max_entry_bytes() + 64:
            # refuse BEFORE reading: a corrupt length prefix inside a
            # giant file must not be discovered by buffering it
            raise WarmEntryOversized(
                f"{key}: file {size}B > cap {max_entry_bytes()}B"
            )
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise WarmEntryTruncated(f"{key}: unreadable: {e}") from e
        body = unframe_payload(raw, what=key)
        try:
            record = pickle.loads(body)
        except Exception as e:
            raise WarmEntryCorrupt(
                f"{key}: body unpickle failed: {type(e).__name__}: {e}"
            ) from e
        if not isinstance(record, tuple) or len(record) != 4:
            raise WarmEntryCorrupt(f"{key}: stale entry record shape")
        host, version, payload, meta = record
        # provenance before the payload is read: a copied store must not
        # replay a library or graph built for another card or torch
        if host != host_fingerprint():
            raise WarmEntryHostMismatch(
                f"{key}: entry built on host {host!r}, this is "
                f"{host_fingerprint()!r}"
            )
        if version != versions():
            raise WarmEntryVersionSkew(
                f"{key}: entry written under {version!r}, this process "
                f"runs {versions()!r}"
            )
        try:
            return pickle.loads(payload), pickle.loads(meta)
        except Exception as e:
            raise WarmEntryCorrupt(
                f"{key}: payload unpickle failed: {type(e).__name__}: {e}"
            ) from e

    def load(self, key: str):
        """:meth:`load_checked`, with every typed failure a plain None."""
        try:
            return self.load_checked(key)
        except WarmEntryError:
            return None

    def quarantine(self, key: str) -> Optional[str]:
        """Move ``key``'s entry aside (``<entry>.quarantined``) so that a
        poisoned file is never retried in a loop: the next load is a
        clean miss, the next store publishes a fresh entry. Returns the
        quarantine path, or None when there was nothing to move."""
        path = self._path(key)
        if path is None or not os.path.exists(path):
            return None
        target = f"{path}.quarantined"
        try:
            os.replace(path, target)
        except OSError:
            return None
        return target

    def store(self, key: str, payload, meta=None) -> bool:
        """Publish ``(payload, meta)`` under ``key`` by an atomic rename,
        with this host's fingerprint and versions inside the framed body.
        False when the store is disabled or the write failed."""
        path = self._path(key)
        if path is None:
            return False
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            body = pickle.dumps((host_fingerprint(), versions(),
                                 pickle.dumps(payload), pickle.dumps(meta)))
            with open(tmp, "wb") as f:
                f.write(frame_payload(body))
            os.replace(tmp, path)  # atomic publish
            return True
        except Exception:
            return False


def enable_persistent_cache(cache_dir: Optional[str] = None
                            ) -> Optional[str]:
    """The host-scoped store directory in effect (created), or None when
    disabled (an empty ``cache_dir`` or ``KTPU_COMPILATION_CACHE_DIR``).
    The reference also points JAX's compilation cache there; the port
    has no such cache, and its store is the warm pool's."""
    if cache_dir is None:
        cache_dir = os.environ.get("KTPU_COMPILATION_CACHE_DIR", _DEFAULT_DIR)
    if not cache_dir:
        return None
    cache_dir = _host_scoped(cache_dir)
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        # the store is an optimization: never fail startup over it
        return None
    return cache_dir
