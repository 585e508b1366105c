"""The port's warm store (``utils/compilation_cache.py``) against the JAX
package's: the framing bytes of seeded bodies, the typed error of each
store defect (both packages' stores holding an entry of the same shape,
sabotaged by each package's ``testing/chaos.sabotage_store``), the
sabotage's bytes on equal files, the host fingerprint and its scoped
directory on a machine without CUDA, and the port's ``ExecutableCache``
round trip, quarantine and size cap."""

import os
import pickle
import shutil

import jax
import numpy as np
import pytest

from koordinator_tpu.testing import chaos as jchaos
from koordinator_tpu.utils import compilation_cache as jcc
from koordinator_tpu_torch.testing import chaos as tchaos
from koordinator_tpu_torch.utils import compilation_cache as tcc

PAIRS = {"ref": (jcc, jchaos), "port": (tcc, tchaos)}


@pytest.mark.parametrize("seed, size", [(0, 0), (1, 1), (2, 100),
                                        (3, 5000), (4, 70001)])
def test_framing_bytes_equal_reference(seed, size):
    body = np.random.default_rng(seed).bytes(size)
    framed = tcc.frame_payload(body)
    assert framed == jcc.frame_payload(body)
    assert framed[:8] == b"KTPUEXE2"
    assert int.from_bytes(framed[8:16], "big") == size
    assert tcc.unframe_payload(framed) == body


def _version(name):
    return jax.__version__ if name == "ref" else tcc.versions()


def _seed_entry(name, root, version=None, tears=True):
    """One framed entry of the reference's record shape under ``root``,
    at the path each package's store reads for key ``k``; with ``tears``
    its length is not a multiple of four, else it is: the reference's
    torn write tears nothing on a multiple of four."""
    cc, _ = PAIRS[name]
    cache = cc.ExecutableCache(str(root))
    path = cache._path("k")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for pad in range(4):
        body = pickle.dumps((cc.host_fingerprint(),
                             _version(name) if version is None else version,
                             pickle.dumps({"x": np.arange(1024),
                                           "pad": "p" * pad}),
                             pickle.dumps({"kind": "signature"})))
        framed = cc.frame_payload(body)
        if (len(framed) % 4 != 0) == tears:
            break
    with open(path, "wb") as f:
        f.write(framed)
    return cache


@pytest.mark.parametrize("defect", list(tchaos.WARM_POOL_FAULT_KINDS)
                         + ["version-skew"])
def test_each_defect_is_the_references_class(tmp_path, defect):
    """Truncated, wrong magic, bit flip, oversized declared length, stale
    host, torn write (the six sabotage kinds) and version skew: the same
    typed class and reason in both packages, and the silent load a plain
    miss."""
    got = {}
    for name, (cc, chaos) in PAIRS.items():
        root = tmp_path / name
        if defect == "version-skew":
            cache = _seed_entry(name, root, version="0.0.1-foreign")
        else:
            cache = _seed_entry(name, root)
            assert chaos.sabotage_store(str(root), defect, seed=3)
        with pytest.raises(cc.WarmEntryError) as exc:
            cache.load_checked("k")
        assert cache.load("k") is None
        got[name] = (type(exc.value).__name__, exc.value.reason)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("kind", tchaos.WARM_POOL_FAULT_KINDS)
@pytest.mark.parametrize("seed", [0, 7])
def test_sabotage_bytes_equal_reference(tmp_path, kind, seed):
    """Equal files come out equal from both packages' sabotage."""
    src = _seed_entry("port", tmp_path / "src")
    out = {}
    for name, (_cc, chaos) in PAIRS.items():
        dst = tmp_path / name
        shutil.copytree(tmp_path / "src", dst)
        path = chaos.sabotage_store(str(dst), kind, seed=seed)
        assert path is not None
        with open(path, "rb") as f:
            out[name] = (os.path.relpath(path, dst), f.read())
    assert out["port"] == out["ref"]
    with open(src._path("k"), "rb") as f:
        assert out["port"][1] != f.read()


def test_torn_write_tears_a_multiple_of_four(tmp_path):
    """On a length that is a multiple of four the reference's torn write
    copies a chunk onto itself (its entry still loads); the port's
    splices the head's own tail there: a typed fingerprint mismatch."""
    for name, (cc, chaos) in PAIRS.items():
        cache = _seed_entry(name, tmp_path / name, tears=False)
        with open(cache._path("k"), "rb") as f:
            before = f.read()
        chaos.sabotage_store(str(tmp_path / name), "torn-concurrent-write")
        with open(cache._path("k"), "rb") as f:
            after = f.read()
        assert (after != before) == (name == "port")
    with pytest.raises(tcc.WarmEntryFingerprintMismatch):
        tcc.ExecutableCache(str(tmp_path / "port")).load_checked("k")


def test_sabotage_manifest_and_empty_store(tmp_path):
    for _name, (cc, chaos) in PAIRS.items():
        assert chaos.sabotage_store(str(tmp_path / "none"),
                                    "wrong-magic") is None
        with pytest.raises(ValueError):
            chaos.sabotage_store(str(tmp_path), "no-such-kind")
    root = tmp_path / "m"
    root.mkdir()
    (root / "warm_manifest.bin").write_bytes(tcc.frame_payload(b"rows"))
    path = tchaos.sabotage_store(str(root), "wrong-magic", manifest=True)
    assert path.endswith("warm_manifest.bin")
    with pytest.raises(tcc.WarmEntryCorrupt):
        tcc.unframe_payload(open(path, "rb").read())


def test_host_fingerprint_and_scope_equal_reference(tmp_path, monkeypatch):
    assert tcc.host_fingerprint() == jcc.host_fingerprint()
    assert tcc._host_scoped(str(tmp_path)) == jcc._host_scoped(str(tmp_path))
    monkeypatch.setenv("KTPU_CACHE_HOST_SCOPE", "0")
    assert tcc._host_scoped(str(tmp_path)) == str(tmp_path)
    assert jcc._host_scoped(str(tmp_path)) == str(tmp_path)


def test_executable_cache_round_trip_and_quarantine(tmp_path):
    cache = tcc.ExecutableCache(str(tmp_path))
    assert cache.dir.startswith(tcc._host_scoped(str(tmp_path)))
    assert cache.load_checked("k") is None
    assert cache.store("k", {"a": np.arange(3)}, {"kind": "signature"})
    payload, meta = cache.load_checked("k")
    np.testing.assert_array_equal(payload["a"], np.arange(3))
    assert meta == {"kind": "signature"}
    tchaos.sabotage_store(str(tmp_path), "bitflipped-entry", seed=7)
    with pytest.raises(tcc.WarmEntryFingerprintMismatch):
        cache.load_checked("k")
    moved = cache.quarantine("k")
    assert moved.endswith(".quarantined") and os.path.exists(moved)
    # never retried: the next load is a clean miss
    assert cache.load_checked("k") is None
    assert cache.quarantine("k") is None


def test_garbage_and_oversized_files(tmp_path, monkeypatch):
    cache = tcc.ExecutableCache(str(tmp_path))
    assert cache.store("k", b"x" * 100)
    with open(cache._path("k"), "wb") as f:
        f.write(np.random.default_rng(0).bytes(64))
    with pytest.raises(tcc.WarmEntryCorrupt):
        cache.load_checked("k")
    assert cache.store("k", b"x" * 100)
    # refused from the file's size, before it is read
    monkeypatch.setenv("KTPU_WARM_MAX_ENTRY_BYTES", "16")
    monkeypatch.setattr("builtins.open", lambda *a, **k: pytest.fail(
        "an oversized entry was read"))
    with pytest.raises(tcc.WarmEntryOversized):
        cache.load_checked("k")


def test_store_disabled_by_empty_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("KTPU_COMPILATION_CACHE_DIR", "")
    for cc in (tcc, jcc):
        assert cc.ExecutableCache().dir is None
        assert cc.enable_persistent_cache() is None
    assert not tcc.ExecutableCache().store("k", b"x")
    scoped = tcc.enable_persistent_cache(str(tmp_path / "c"))
    assert scoped == tcc._host_scoped(str(tmp_path / "c"))
    assert os.path.isdir(scoped)
