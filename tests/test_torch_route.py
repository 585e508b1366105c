"""The route between the placement kernels and the arithmetic they share.

- :func:`kernel_route` at the capacity edges of the one-block kernel, of
  k CTAs and of 16 CTAs, for every variant, with and without
  reservations and quotas (the budgets are ``binpack_common.cuh``'s),
  and with quota tables that go to device memory.
- The kernels' exact division by precomputed constants
  (Granlund-Montgomery, 32-bit constants), emulated in numpy with
  uint64 products: it equals floor division on edge dividends and
  divisors and on ``hypothesis`` draws. The kernels cannot run here;
  this proves the arithmetic they use.
- ``PlacementModel(device="cpu")`` at a size the route sends to the
  cluster kernel's twin, against the JAX ``PlacementModel``.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.parallel.mesh import shard_tile_bucket

# -- the route ------------------------------------------------------------

_VARIANTS = [(False, 0, 0), (False, 0, 50), (False, 256, 50), (True, 0, 50),
             (True, 64, 50), (True, 600, 3)]


def _pods(n_resv):
    rw = bk.record_words(n_resv)
    return 2 * bk.pod_chunk(rw) * rw * 4


def _fixed(n_resv, n_quota):
    return _pods(n_resv) + n_quota * 8 * 16


def _fits(rows, numa, n_resv, n_quota):
    return (_fixed(n_resv, n_quota) + bk.slice_bytes(rows, n_resv, numa)
            <= bk.SMEM_BYTES)


def _capacity(numa, n_resv, n_quota):
    """The most rows one CTA's shared memory holds, by search."""
    rows = 0
    while _fits(rows + 1, numa, n_resv, n_quota):
        rows += 1
    return rows


def _n_loc(n, k):
    return shard_tile_bucket(n, k) // k


@pytest.mark.parametrize("numa,n_resv,n_quota", _VARIANTS)
def test_route_one_block_edge(numa, n_resv, n_quota):
    cap = min(_capacity(numa, n_resv, n_quota), bk.ROWS_PER_CTA)
    at = bk.kernel_route(cap, numa, n_resv, n_quota)
    assert (at.kind, at.shards, at.n_loc) == ("block", 1, cap)
    assert at.smem <= bk.SMEM_BYTES and at.work == 0
    over = bk.kernel_route(cap + 1, numa, n_resv, n_quota)
    assert over.kind in ("cluster", "l2") and over.shards >= 2


@pytest.mark.parametrize("numa,n_resv,n_quota", _VARIANTS)
def test_route_cluster_edges(numa, n_resv, n_quota):
    """For each k, the largest node count whose k slices fit (and, when
    that is within one row per thread, the route picks k there) and one
    row over it (the route needs more CTAs or the L2 form)."""
    cap = _capacity(numa, n_resv, n_quota)
    for k in range(2, bk.MAX_SHARDS + 1):
        # the largest n whose slices of shard_tile_bucket(n, k) / k fit
        n = max((n for n in range(128 * k, min(k * cap, bk.MAX_NODES) + 1,
                                  128) if _n_loc(n, k) <= cap), default=None)
        if n is None:
            continue
        forced = bk.kernel_route(n, numa, n_resv, n_quota, shards=k)
        assert (forced.kind, forced.shards) == ("cluster", k)
        assert forced.smem <= bk.SMEM_BYTES
        route = bk.kernel_route(n, numa, n_resv, n_quota)
        assert route.kind in ("block", "cluster")
        if route.kind == "cluster":
            assert route.shards <= k or _n_loc(n, k) > bk.ROWS_PER_CTA
            assert _fits(route.n_loc, numa, n_resv, n_quota)
        nxt = bk.kernel_route(n + 1, numa, n_resv, n_quota, shards=k)
        if _n_loc(n + 1, k) > cap:
            _assert_past_shared_memory(nxt, k, numa, n_resv, n_quota)


def _assert_past_shared_memory(route, k, numa, n_resv, n_quota):
    """Slices that do not fit beside the quota tables: the quota tables
    go to device memory if the slices then fit, else the L2 form."""
    assert route.shards == k
    if n_quota and _fits(route.n_loc, numa, n_resv, 0):
        assert route.kind == "cluster" and not route.quota_shared
        assert route.smem == _pods(n_resv) + bk.slice_bytes(route.n_loc,
                                                            n_resv, numa)
    else:
        assert route.kind == "l2" and route.quota_shared
        assert route.work == k * bk.slice_bytes(route.n_loc, n_resv, numa,
                                                resident=False)
        assert route.smem == _fixed(n_resv, n_quota)


@pytest.mark.parametrize("numa,n_resv,n_quota", _VARIANTS)
def test_route_l2_beyond_sixteen(numa, n_resv, n_quota):
    """At what 16 CTAs hold the route stays in shared memory; one row
    over it takes the L2 form at 16 CTAs, up to 65,536 nodes."""
    cap = _capacity(numa, n_resv, n_quota)
    n16 = max(n for n in range(128 * 16, bk.MAX_NODES + 1, 128)
              if _n_loc(n, 16) <= cap) if _n_loc(2048, 16) <= cap else None
    if n16 is not None and n16 < bk.MAX_NODES:
        assert bk.kernel_route(n16, numa, n_resv, n_quota).kind == "cluster"
        over = bk.kernel_route(n16 + 1, numa, n_resv, n_quota)
        if over.kind == "l2" or not n_quota:
            assert (over.kind, over.shards) == ("l2", 16)
        else:   # fits once the quota tables leave shared memory
            _assert_past_shared_memory(over, over.shards, numa, n_resv,
                                       n_quota)
    top = bk.kernel_route(bk.MAX_NODES, numa, n_resv, n_quota)
    assert top.shards >= 2
    assert bk.kernel_route(bk.MAX_NODES + 1, numa, n_resv, n_quota) is None
    assert bk.kernel_route(0, numa, n_resv, n_quota) is None


def test_route_main_path_shapes_and_limits():
    main = bk.kernel_route(5000, False, 0, 50)
    assert main.kind == "cluster" and _n_loc(5000, main.shards) <= 1024
    assert bk.kernel_route(1000, False, 0, 50).kind == "block"
    assert main.quota_shared and main.smem <= bk.SMEM_BYTES
    with pytest.raises(ValueError, match="shards"):
        bk.kernel_route(100, shards=17)
    # wide match rows shrink the pod chunk, never below 2
    assert bk.pod_chunk(bk.record_words(0)) == bk.POD_CHUNK
    assert bk.pod_chunk(bk.record_words(1 << 16)) == 2
    # the head holds the extras row since the extras slice: 28 words
    assert bk.record_words(1) == 32 and bk.record_words(129) == 36


@pytest.mark.parametrize("n_nodes,numa,n_resv,n_quota,want", [
    # quota tables beyond one CTA's shared memory (256,000 bytes)
    (100, False, 0, 2000, ("block", 1, False)),
    (5000, False, 0, 2000, ("cluster", 5, False)),
    (5000, True, 64, 2000, ("cluster", 7, False)),
    (40000, False, 0, 2000, ("l2", 16, False)),
    (bk.MAX_NODES, True, 600, 2000, ("l2", 16, False)),
    # tables that fit, but would push the slices to the L2 form
    (20000, False, 0, 1000, ("cluster", 14, False)),
    # tables that fit beside the slices: in shared memory
    (5000, False, 0, 1000, ("cluster", 8, True)),
])
def test_route_quota_tables_in_device_memory(n_nodes, numa, n_resv, n_quota,
                                             want):
    """Every solve of at most 65,536 nodes takes a kernel, however many
    quota groups it has: tables that do not fit shared memory, or that
    would push the slices out of it, go to device memory."""
    route = bk.kernel_route(n_nodes, numa, n_resv, n_quota)
    assert (route.kind, route.shards, route.quota_shared) == want
    quota = 0 if not route.quota_shared else n_quota * 8 * 16
    if route.kind == "l2":
        assert route.smem == _pods(n_resv) + quota
    else:
        assert route.smem == (_pods(n_resv) + quota
                              + bk.slice_bytes(route.n_loc, n_resv, numa))
        assert route.smem <= bk.SMEM_BYTES
    forced = bk.kernel_route(n_nodes, numa, n_resv, n_quota, shards=16)
    assert forced.shards == 16 and forced.smem <= bk.SMEM_BYTES


# -- exact division by constants ---------------------------------------------

def magic_of(d):
    """``magic_of`` of binpack_common.cuh: (m, l) for d in [1, 2^31)."""
    l = (d - 1).bit_length()          # 32 - clz(d - 1)
    m = ((1 << (31 + l)) + d - 1) // d
    assert 0 < m < 1 << 32
    return m, l


def udiv(n, m, l):
    """``udiv``: umulhi(m, 2n) >> l, the product in uint64 (m < 2^32 and
    2n < 2^32, so it cannot wrap)."""
    n = np.asarray(n, np.uint64)
    prod = np.uint64(m) * (n << np.uint64(1))
    return ((prod >> np.uint64(32)) >> np.uint64(l)).astype(np.int64)


def floor_fast(x, m, l):
    """``floor_fast``: x >= 0 ? x / d : ~(~x / d), in int32."""
    x = np.asarray(x, np.int64)
    pos = udiv(np.where(x >= 0, x, 0), m, l)
    neg = ~udiv(np.where(x < 0, ~x, 0), m, l)
    return np.where(x >= 0, pos, neg)


_DIVISORS = sorted({1, 2, 3, 5, 7, 10, 100, 1000, 4096, 65535, 65536, 65537,
                    1 << 20, (1 << 30) - 1, 1 << 30, (1 << 31) - 1,
                    *(1 << s for s in range(31)),
                    *((1 << s) + 1 for s in range(1, 31)),
                    *((1 << s) - 1 for s in range(2, 32))})


def _edge_dividends(d):
    top = (1 << 31) - 1
    cand = {0, 1, 2, d - 1, d, d + 1, 2 * d - 1, 2 * d, top, top - 1,
            top // d * d, top // d * d - 1,
            (top // d) * d + min(d - 1, top % d)}
    for q in (3, 100, 12345, top // max(d, 1)):
        cand |= {q * d - 1, q * d, q * d + 1}
    return np.array(sorted(x for x in cand if 0 <= x <= top), np.int64)


@pytest.mark.parametrize("d", _DIVISORS)
def test_udiv_equals_floor_division_on_edges(d):
    m, l = magic_of(d)
    n = _edge_dividends(d)
    assert np.array_equal(udiv(n, m, l), n // d)
    # signed dividends, negative edges included, floor toward -inf
    x = np.concatenate([n, -n, -n - 1, [-(1 << 31)]])
    assert np.array_equal(floor_fast(x, m, l), x // d)


@settings(max_examples=400, deadline=None)
@given(d=st.integers(1, (1 << 31) - 1),
       x=st.integers(-(1 << 31), (1 << 31) - 1))
def test_floor_fast_equals_floor_division_drawn(d, x):
    m, l = magic_of(d)
    assert int(floor_fast(x, m, l)) == x // d
    if x >= 0:
        assert int(udiv(x, m, l)) == x // d


def _least_term(a, v):
    """binpack_common.cuh's least_fast against the first kernel's
    least_term: (a - v)*100 // a in wrapping int32, 0 where a == 0 or
    v > a, the dividend clamped at 0 and the divisor max(a, 1)."""
    if a == 0 or v > a:
        return 0, 0
    y = ((a - v) * 100 + (1 << 31)) % (1 << 32) - (1 << 31)
    y = max(y, 0)
    m, l = magic_of(max(a, 1))
    return int(udiv(y, m, l)), y // max(a, 1)


@settings(max_examples=300, deadline=None)
@given(a=st.integers(-(1 << 31), (1 << 31) - 1),
       v=st.integers(-(1 << 31), (1 << 31) - 1))
def test_least_term_by_constants_drawn(a, v):
    got, want = _least_term(a, v)
    assert got == want


# -- the routed solve against the reference ------------------------------------

def test_routed_model_matches_reference_past_one_block(monkeypatch):
    """2,500 nodes: past one CTA's rows, so the route names the cluster
    kernel and the CPU runs its twin ``binpack_sharded_plain``; the
    placements equal the JAX ``PlacementModel``."""
    spec = testing.mixed_snapshot_spec(5, n_nodes=2500, n_assigned=200,
                                       n_pending=48)
    jsnap = testing.build_snapshot(spec, jtypes, JResourceName)
    tsnap = testing.build_snapshot(spec, ttypes, TResourceName)
    want = JPlacementModel(use_pallas=False).schedule(jsnap)
    model = PlacementModel(device="cpu")
    routes, run = [], bk._run

    def record(inp, route):
        routes.append(route)
        return run(inp, route)

    monkeypatch.setattr(bk, "_run", record)
    got = model.schedule(tsnap)
    assert model.last_solver == "kernel"
    [route] = routes
    assert route.kind == "cluster" and route.shards > 1, route
    assert dict(got) == dict(want) and got.waiting == want.waiting
    assert any(n is not None for n in got.values())
