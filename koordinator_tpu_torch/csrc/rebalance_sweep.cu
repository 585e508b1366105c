// The LowNodeLoad balance sweep on Hopper (sm_90a): two kernels.
//
// Replaces koordinator_tpu/ops/rebalance.py `_balance_sweep` (:211-236),
// a `lax.scan` over the flattened eviction candidates (not a pallas_call)
// driven by descheduler/loadaware.py `_sweep_device`. Per candidate i:
//
//   cur      = node_start[i] ? usage0[i] : cur
//   over     = any((cur > high_q[i]) & res_mask)
//   avail_ok = !any((avail <= 0) & res_mask)
//   propose  = valid[i] & over & avail_ok & !blocked[i]
//   if propose & has_metric[i]: avail -= metric[i], cur -= metric[i]
//                               (on the participating resources only)
//
// The host picks the kernel from the batch before the launch
// (ops/rebalance.py sweep_route); nothing falls back from one to the
// other.
//
// rebalance_scan_kernel: the walk as prefix sums. A candidate that is
// not proposed changes no state. So once avail_ok is false the headroom
// is frozen and avail_ok stays false; and within a node, once over is
// false nothing more is proposed there, cur is frozen and over stays
// false, provided the node's high_q row is the same on all its
// candidates (the host checks that; LowNodeLoad copies the node's row
// onto each). The walk is then, per tile:
//   1. node stage: cur' before each candidate, were every eligible
//      (valid, not blocked) candidate of its node proposed: a segmented
//      exclusive sum of the masked metrics, restarting at node starts.
//      The node is cut at its first candidate with over' false (a
//      segmented or-scan); the eligible candidates before the cut are
//      the tentative proposals.
//   2. headroom stage: the headroom before each candidate under the
//      tentative proposals, an exclusive sum; a = the first candidate
//      whose headroom is exhausted (a block-wide min).
//   3. streams: proposals are the tentative ones before a. Before a, cur
//      equals cur', so over = "not cut yet" and avail_ok = true; from a
//      on, cur is summed again from the actual proposals (a segmented
//      sum, frozen at a's node, usage0 in later nodes).
// Sums are unsigned 32-bit: addition modulo 2^32 is associative, so the
// wrapped prefix sums equal the serial chain's wrapped carry bit for bit
// (strict `>` for over and `<= 0` for headroom, compared signed).
//
// What bounds it at K = 2,000-25,000: not the bytes (about 100 per
// candidate, well under a microsecond at 3.35 TB/s) but one SM: the
// latency of a tile's chain of block-wide scans (each two barriers and
// a pass of warp 0) and the issue of its loads, shared-memory reads and
// stores, of which staging a tile and the passes over a thread's
// candidates take the most (clock64 stamps per phase). So one
// CTA of 512 threads walks the list in tiles, each thread Q consecutive
// candidates (Q = 8, 4 or 2 as 1-2, 3-4 or 5-8 resources participate:
// what 512 threads' registers hold): a thread scans its own candidates
// serially, and the block-wide scans run over the threads' aggregates
// only (warp shuffles under node-start ballots, then the 16 warp
// aggregates by warp 0), so barriers and shuffles are paid once per Q
// candidates. The kernel is instantiated per count of participating
// resources (read from res_mask on the card) and touches only those
// columns. From tile to tile shared memory carries the open node's
// actual cur (frozen at its cut once cut: cur' runs on past the cut, and
// a later tile's stage 3 must start from what was really subtracted)
// and whether it was cut, the headroom, and whether it ran out; past
// the headroom's end a tile needs only stage 3's sum. A
// tile's metric columns are copied into shared memory by coalesced
// 4-byte cp.async, one tile ahead (double-buffered), skewed so that each
// thread reads its own candidates without bank conflicts; usage0 and
// high_q are read from device memory only where a node starts (high_q
// also for the node open at a thread's first candidate: a node's row is
// the same on all its candidates). A thread's stream bytes go out as
// one store per stream. One CTA leaves 131 SMs idle; a multi-CTA form
// would need the carry-free part of each tile (closed nodes, each
// column's largest headroom prefix) computed before its predecessor's
// carries arrive, so that only the open node and a min stay on the
// chain.
//
// The kernel also takes `refused`, the candidate an evictor just
// refused: it is walked as blocked and written into `blocked`, so a
// re-scan after a refusal is one launch with no host copy.
//
// rebalance_sweep_kernel: the walk as the serial chain, one warp, exact
// for any batch (the route of batches whose high_q varies inside a
// node). What bounds it is the chain, each step reading the carry the
// last one wrote; the bytes are nothing beside it. The design keeps
// everything but the chain off the critical path:
// - lane r < 8 holds cur[r], lane 8 + r holds avail[r], both in a
//   register; one ballot per candidate gives `over` (lanes 0-7) and
//   `avail_ok` (lanes 8-15) together;
// - the [K,8] int32 rows are loaded 32 candidates at a time, coalesced
//   as 16-byte vectors, into registers one chunk ahead of the walk and
//   parked in a shared-memory double buffer (the transpose: lane r then
//   reads column r of every candidate into registers before the chunk's
//   32 steps, so no step waits on a load);
// - a chunk's flags become warp-wide bit masks (three ballots), and the
//   chunk's decisions accumulate as bit masks in every lane; lane j
//   writes candidate j's three bytes after the chunk, 32 bytes a store.
// Exact int32: strict `>` for over and `<= 0` for headroom; the
// subtraction is done unsigned (two's-complement wrap, as the
// reference's x32 arithmetic), though the host's endpoint validation
// (ops/rebalance.py validate_sweep) guarantees it never wraps.

#include <cstdint>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int R = 8;
constexpr int CHUNK = 32;            // candidates per chunk, one per lane
constexpr int VEC = CHUNK * 2;       // 16-byte vectors per array per chunk
constexpr unsigned FULL = 0xffffffffu;

struct Chunk {
  int4 u0[VEC];
  int4 hq[VEC];
  int4 m[VEC];
};

struct Regs {
  int4 u0[2], hq[2], m[2];
  int flags;  // start | has_metric << 1 | (valid & !blocked) << 2
};

__device__ __forceinline__ void load_chunk(
    Regs& g, int c, int k, int lane, const uint8_t* __restrict__ node_start,
    const int4* __restrict__ usage0, const int4* __restrict__ high_q,
    const int4* __restrict__ metric, const uint8_t* __restrict__ has_metric,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ blocked) {
  const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = c * VEC + h * CHUNK + lane;  // vector index: row v/2
    const bool in = v < 2 * k;
    g.u0[h] = in ? __ldg(usage0 + v) : zero;
    g.hq[h] = in ? __ldg(high_q + v) : zero;
    g.m[h] = in ? __ldg(metric + v) : zero;
  }
  const int i = c * CHUNK + lane;
  g.flags = 0;  // past K: no start, no metric, not live (inert)
  if (i < k) {
    g.flags = (node_start[i] != 0) | ((has_metric[i] != 0) << 1) |
              ((valid[i] != 0 && blocked[i] == 0) << 2);
  }
}

__device__ __forceinline__ void park_chunk(Chunk& s, const Regs& g,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s.u0[h * CHUNK + lane] = g.u0[h];
    s.hq[h * CHUNK + lane] = g.hq[h];
    s.m[h * CHUNK + lane] = g.m[h];
  }
}

__global__ void __launch_bounds__(32, 1) rebalance_sweep_kernel(
    const uint8_t* __restrict__ node_start, const int4* __restrict__ usage0,
    const int4* __restrict__ high_q, const int4* __restrict__ metric,
    const uint8_t* __restrict__ has_metric,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ blocked,
    const int* __restrict__ available0, const uint8_t* __restrict__ res_mask,
    int k, uint8_t* __restrict__ propose_out, uint8_t* __restrict__ over_out,
    uint8_t* __restrict__ ok_out, int* __restrict__ available_out) {
  __shared__ Chunk buf[2];
  const int lane = threadIdx.x;
  const int col = lane & (R - 1);
  const bool cur_lane = lane < R;
  const bool avail_lane = lane >= R && lane < 2 * R;
  // a lane of the chain whose resource participates
  const bool masked = lane < 2 * R && res_mask[col] != 0;
  // lanes 0-7: cur[col] (0 until the first node_start); lanes 8-15:
  // avail[col]; the other lanes' value is never read
  unsigned v = avail_lane ? static_cast<unsigned>(available0[col]) : 0u;

  const int chunks = (k + CHUNK - 1) / CHUNK;
  Regs g;
  int flags = 0;  // lane j: this chunk's candidate j's flags
  if (chunks > 0) {
    load_chunk(g, 0, k, lane, node_start, usage0, high_q, metric, has_metric,
               valid, blocked);
    park_chunk(buf[0], g, lane);
    flags = g.flags;
  }
  __syncwarp();
  for (int c = 0; c < chunks; ++c) {
    // the next chunk's loads fly while this chunk is walked
    if (c + 1 < chunks) {
      load_chunk(g, c + 1, k, lane, node_start, usage0, high_q, metric,
                 has_metric, valid, blocked);
    }
    // this lane's column of the chunk, into registers
    const int* u0s = reinterpret_cast<const int*>(buf[c & 1].u0);
    const int* hqs = reinterpret_cast<const int*>(buf[c & 1].hq);
    const int* ms = reinterpret_cast<const int*>(buf[c & 1].m);
    int ru0[CHUNK], rhq[CHUNK], rm[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      ru0[j] = u0s[j * R + col];
      rhq[j] = hqs[j * R + col];
      rm[j] = ms[j * R + col];
    }
    const unsigned start_m = __ballot_sync(FULL, flags & 1);
    const unsigned metric_m = __ballot_sync(FULL, flags & 2);
    const unsigned live_m = __ballot_sync(FULL, flags & 4);
    unsigned propose_m = 0, over_m = 0, ok_m = 0;
    // past K a step is inert (no start, not live): walk all 32
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (cur_lane && ((start_m >> j) & 1u)) {
        v = static_cast<unsigned>(ru0[j]);
      }
      const int x = static_cast<int>(v);
      const bool bit = masked && (cur_lane ? x > rhq[j] : x <= 0);
      const unsigned vote = __ballot_sync(FULL, bit);
      const unsigned over = (vote & 0xffu) != 0 ? 1u : 0u;
      const unsigned ok = (vote & 0xff00u) == 0 ? 1u : 0u;
      const unsigned propose = over & ok & (live_m >> j);
      if (propose & (metric_m >> j) & masked) {
        v -= static_cast<unsigned>(rm[j]);
      }
      propose_m |= propose << j;
      over_m |= over << j;
      ok_m |= ok << j;
    }
    const int i = c * CHUNK + lane;
    if (i < k) {
      propose_out[i] = static_cast<uint8_t>((propose_m >> lane) & 1u);
      over_out[i] = static_cast<uint8_t>((over_m >> lane) & 1u);
      ok_out[i] = static_cast<uint8_t>((ok_m >> lane) & 1u);
    }
    __syncwarp();
    if (c + 1 < chunks) {
      park_chunk(buf[(c + 1) & 1], g, lane);
      flags = g.flags;
    }
    __syncwarp();
  }
  if (avail_lane) available_out[col] = static_cast<int>(v);
}

}  // namespace

// Launch on `stream` (one CTA of one warp). Returns cudaGetLastError().
extern "C" int rebalance_sweep_launch(
    const void* node_start, const void* usage0, const void* high_q,
    const void* metric, const void* has_metric, const void* valid,
    const void* blocked, const void* available0, const void* res_mask, int k,
    void* propose_out, void* over_out, void* ok_out, void* available_out,
    void* stream) {
  rebalance_sweep_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(node_start),
      static_cast<const int4*>(usage0), static_cast<const int4*>(high_q),
      static_cast<const int4*>(metric),
      static_cast<const uint8_t*>(has_metric),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(blocked),
      static_cast<const int*>(available0),
      static_cast<const uint8_t*>(res_mask), k,
      static_cast<uint8_t*>(propose_out), static_cast<uint8_t*>(over_out),
      static_cast<uint8_t*>(ok_out), static_cast<int*>(available_out));
  return static_cast<int>(cudaGetLastError());
}

namespace scan {

constexpr int R = 8;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// consecutive candidates per thread, by participating columns NC: a
// tile holds at most 8,192 (candidate, column) cells
template <int NC>
struct Items {
  static constexpr int Q = NC <= 2 ? 8 : NC <= 4 ? 4 : 2;
  static constexpr int TILE = THREADS * Q;
  // a column of the tile, skewed by one word every 32 candidates so that
  // thread t reading candidate t * Q + q finds no bank conflict
  static constexpr int SPAN = TILE + TILE / 32;
};
constexpr int MAX_CELLS = 8192 + 8192 / 32;  // NC * SPAN, at most

__device__ __forceinline__ int skew(int r) { return r + (r >> 5); }

// carries and scratch indexed by participating column j (< NC)
struct Shared {
  unsigned agg[WARPS][R];   // a scan's warp aggregates
  unsigned pre[WARPS][R];   // what flows into each warp
  unsigned seg[R];          // carry: the open node's cur after the tile
  unsigned seg_base[R];     // the tile's last node start's usage0 less
                            // the headroom before it
  unsigned avail[R];        // carry: the headroom after the tile
  int col[R];               // the participating columns, in order
  int head_warp[WARPS];     // warp w holds a node start
  int cut_end[WARPS];       // warp w's last segment is cut by its end
  int cut_in[WARPS];        // a cut flows into warp w
  int seg_cut;              // carry: the open node was cut
  int ran_out;              // carry: the headroom ran out
  int first_out[2];         // the tile's first exhausted candidate
  int last_head[2];         // the tile's last node start (-1: none)
  // the participating columns of metric of a tile, double-buffered:
  // [stage][j * SPAN + skew(candidate)]
  unsigned cells[2][MAX_CELLS];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

struct Args {
  const uint8_t* node_start;
  const int* usage0;
  const int* high_q;
  const int* metric;
  const uint8_t* has_metric;
  const uint8_t* valid;
  uint8_t* blocked;
  const int* available0;
  int k, refused;
  uint8_t* propose_out;
  uint8_t* over_out;
  uint8_t* ok_out;
  int* available_out;
};

// Q flag bytes from candidate i0 (a multiple of Q), 0 past K, packed
template <int Q>
__device__ __forceinline__ unsigned long long load_bytes(const uint8_t* p,
                                                         int i0, int k) {
  if (i0 + Q <= k) {
    if (Q == 8) return *reinterpret_cast<const unsigned long long*>(p + i0);
    if (Q == 4) return *reinterpret_cast<const unsigned*>(p + i0);
    if (Q == 2) return *reinterpret_cast<const unsigned short*>(p + i0);
  }
  unsigned long long out = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (i0 + q < k) {
      out |= static_cast<unsigned long long>(p[i0 + q]) << (8 * q);
    }
  }
  return out;
}

__device__ __forceinline__ bool byte_set(unsigned long long b, int q) {
  return ((b >> (8 * q)) & 0xffu) != 0;
}

__device__ __forceinline__ unsigned lanemask_le(int lane) {
  return FULL >> (31 - lane);
}

// inclusive segmented sum across the warp: a lane adds what lies
// between its segment's first lane `lo` (0 when the segment opens
// before the warp) and itself
template <int NC>
__device__ __forceinline__ void warp_sum(unsigned (&v)[NC], int lane,
                                         int lo) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool take = lane - d >= lo;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const unsigned y = __shfl_up_sync(FULL, v[j], d);
      if (take) v[j] += y;
    }
  }
}

// What flows into each thread from the threads before it in its segment:
// `v` holds the thread's aggregate (its sum from its last node start, or
// from its first candidate) and `head` whether it holds a node start;
// `v` returns the sum over the threads back to the segment's start, plus
// `carry` when the segment opens before the tile.
template <int NC>
__device__ __forceinline__ void block_flow(Shared& s, unsigned (&v)[NC],
                                           bool head, int lane, int w,
                                           const unsigned* carry) {
  const unsigned hb = __ballot_sync(FULL, head);
  const unsigned le = hb & lanemask_le(lane);
  warp_sum(v, lane, le ? 31 - __clz(le) : 0);
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < NC; ++j) s.agg[w][j] = v[j];
    s.head_warp[w] = hb != 0;
  }
  __syncthreads();
  if (w == 0) {  // lane = warp
    const bool hw = lane < WARPS && s.head_warp[lane] != 0;
    const unsigned hwb = __ballot_sync(FULL, hw);
    const unsigned le2 = hwb & lanemask_le(lane);
    unsigned a[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) a[j] = lane < WARPS ? s.agg[lane][j] : 0u;
    warp_sum(a, lane, le2 ? 31 - __clz(le2) : 0);
    const bool open = (hwb & ((1u << lane) - 1u)) == 0;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      unsigned e = __shfl_up_sync(FULL, a[j], 1);
      if (lane == 0) e = 0;
      if (open) e += carry[j];
      if (lane < WARPS) s.pre[lane][j] = e;
    }
  }
  __syncthreads();
  const bool open = (hb & ((1u << lane) - 1u)) == 0;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    unsigned e = __shfl_up_sync(FULL, v[j], 1);
    if (lane == 0) e = 0;
    if (open) e += s.pre[w][j];
    v[j] = e;
  }
}

// Whether a cut flows into each thread from the threads before it in its
// segment (`carry` when the segment opens before the tile): `end` is the
// thread's own state after its last candidate, `head` whether it holds
// a node start.
__device__ __forceinline__ bool block_cut(Shared& s, bool end, bool head,
                                          int lane, int w, int carry) {
  const unsigned hb = __ballot_sync(FULL, head);
  const unsigned eb = __ballot_sync(FULL, end);
  const unsigned lt = (1u << lane) - 1u;
  const unsigned before = hb & lt;
  const int lo = before ? 31 - __clz(before) : 0;
  const bool in_warp = (eb & lt & ~((1u << lo) - 1u)) != 0;
  if (lane == 31) {
    s.cut_end[w] = head ? end : (end || in_warp);
    s.head_warp[w] = hb != 0;
  }
  __syncthreads();
  if (w == 0) {
    const unsigned hwb =
        __ballot_sync(FULL, lane < WARPS && s.head_warp[lane] != 0);
    const unsigned ewb =
        __ballot_sync(FULL, lane < WARPS && s.cut_end[lane] != 0);
    const unsigned lt2 = (1u << lane) - 1u;
    const unsigned before2 = hwb & lt2;
    const int lo2 = before2 ? 31 - __clz(before2) : 0;
    if (lane < WARPS) {
      s.cut_in[lane] = (ewb & lt2 & ~((1u << lo2) - 1u)) != 0 ||
                       (!before2 && carry);
    }
  }
  __syncthreads();
  return in_warp || (before == 0 && s.cut_in[w] != 0);
}

// tile t's participating metric columns into stage `st`, one group:
// cell e is candidate e / NC's column j = e % NC, so a warp's copies are
// consecutive words of consecutive rows (zeros past K)
template <int NC>
__device__ __forceinline__ void stage_tile(Shared& s, int st, int t, int k,
                                           const Args& g) {
  constexpr int Q = Items<NC>::Q, TILE = Items<NC>::TILE;
  constexpr int SPAN = Items<NC>::SPAN;
#pragma unroll
  for (int m = 0; m < Q * NC; ++m) {
    const int e = threadIdx.x + m * THREADS;
    const int r = e / NC, j = e % NC;
    const int i = t * TILE + r;
    const size_t at = i < k ? static_cast<size_t>(i) * R + s.col[j] : 0;
    cp_async4(&s.cells[st][j * SPAN + skew(r)], g.metric + at, i < k);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Q bytes at p: one store when p is aligned to Q, else byte by byte
template <int Q>
__device__ __forceinline__ void store_q(uint8_t* p, unsigned long long v) {
  if ((reinterpret_cast<uintptr_t>(p) & (Q - 1)) == 0) {
    if (Q == 8) {
      *reinterpret_cast<unsigned long long*>(p) = v;
    } else if (Q == 4) {
      *reinterpret_cast<unsigned*>(p) = static_cast<unsigned>(v);
    } else {
      *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(v);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) p[q] = static_cast<uint8_t>(v >> (8 * q));
}

// bit q of `bits` as byte q
template <int Q>
__device__ __forceinline__ unsigned long long spread(unsigned bits) {
  unsigned long long v = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v |= static_cast<unsigned long long>((bits >> q) & 1u) << (8 * q);
  }
  return v;
}

// the three streams of this thread's Q candidates from i0 (`in`: those
// before K), one packed store per stream where all Q are in
template <int Q>
__device__ __forceinline__ void store_streams(const Args& g, int i0,
                                              unsigned in, unsigned propose,
                                              unsigned over, unsigned ok) {
  if (in == (1u << Q) - 1u) {
    store_q<Q>(g.propose_out + i0, spread<Q>(propose));
    store_q<Q>(g.over_out + i0, spread<Q>(over));
    store_q<Q>(g.ok_out + i0, spread<Q>(ok));
    return;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if ((in >> q) & 1u) {
      g.propose_out[i0 + q] = (propose >> q) & 1u;
      g.over_out[i0 + q] = (over >> q) & 1u;
      g.ok_out[i0 + q] = (ok >> q) & 1u;
    }
  }
}

// the walk over the NC participating columns `cols` (a bit mask), Q
// consecutive candidates per thread
template <int NC>
__device__ __forceinline__ void walk(Shared& s, const Args& g,
                                     unsigned cols) {
  constexpr int Q = Items<NC>::Q, TILE = Items<NC>::TILE;
  constexpr int SPAN = Items<NC>::SPAN;
  constexpr unsigned ALL = (1u << Q) - 1u;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) {
    unsigned m = cols;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      s.col[j] = __ffs(m) - 1;
      m &= m - 1u;
      s.seg[j] = 0;  // cur before the first node start, as the reference
      s.avail[j] = static_cast<unsigned>(g.available0[s.col[j]]);
    }
    s.seg_cut = 0;
    s.ran_out = 0;
    s.first_out[0] = TILE;
    s.last_head[0] = -1;
  }
  __syncthreads();
  int col[NC];  // the participating columns, in order
#pragma unroll
  for (int j = 0; j < NC; ++j) col[j] = s.col[j];
  const int k = g.k;
  const int tiles = (k + TILE - 1) / TILE;
  if (tiles > 0) stage_tile<NC>(s, 0, 0, k, g);
  for (int t = 0; t < tiles; ++t) {
    const int r0 = tid * Q;  // this thread's first candidate in the tile
    const int i0 = t * TILE + r0;
    // its flags, and usage0 and high_q where a node starts (high_q also
    // of the node open at i0: a node's high_q row is the same on all its
    // candidates, which the host checks before it takes this kernel), in
    // flight while the tile's metric cells land
    const unsigned long long st = load_bytes<Q>(g.node_start, i0, k);
    const unsigned long long hm = load_bytes<Q>(g.has_metric, i0, k);
    const unsigned long long va = load_bytes<Q>(g.valid, i0, k);
    const unsigned long long bl = load_bytes<Q>(g.blocked, i0, k);
    unsigned u0h[Q][NC];  // usage0 at a node start, 0 elsewhere
    int hqh[Q][NC];       // high_q at a node start
    int hq0[NC];          // high_q of the node open at i0
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      hq0[j] = i0 < k ? __ldg(g.high_q + static_cast<size_t>(i0) * R + col[j])
                      : 0;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const bool head = byte_set(st, q);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const size_t at = static_cast<size_t>(i0 + q) * R + col[j];
        u0h[q][j] = head ? static_cast<unsigned>(__ldg(g.usage0 + at)) : 0u;
        hqh[q][j] = head ? __ldg(g.high_q + at) : 0;
      }
    }
    __syncthreads();  // every thread is done with stage (t + 1) & 1
    if (t + 1 < tiles) {
      stage_tile<NC>(s, (t + 1) & 1, t + 1, k, g);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile t's cells, copied by every thread, landed
    const unsigned* mc = s.cells[t & 1];
    unsigned heads = 0, takes = 0, eligible = 0, in = 0;  // bit q: i0 + q
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = i0 + q;
      bool blk = byte_set(bl, q);
      if (i == g.refused) {
        blk = true;
        g.blocked[i] = 1;
      }
      const bool el = byte_set(va, q) && !blk;  // not valid past K
      heads |= static_cast<unsigned>(byte_set(st, q)) << q;
      eligible |= static_cast<unsigned>(el) << q;
      takes |= static_cast<unsigned>(el && byte_set(hm, q)) << q;
      in |= static_cast<unsigned>(i < k) << q;
    }
    const bool has_head = heads != 0;
    // candidates up to the thread's first node start: those the flow
    // from earlier threads reaches
    const unsigned fed = has_head ? ((heads & (0u - heads)) - 1u) : ALL;
    // the masked metric candidate q subtracts when `sub` has bit q
    auto x = [&](unsigned sub, int q, int j) -> unsigned {
      return ((sub >> q) & 1u) ? mc[j * SPAN + skew(r0 + q)] : 0u;
    };
    // whether cur is over the high_q `hq` of its node
    auto over_of = [&](const unsigned (&cur)[NC], const int (&hq)[NC]) {
      bool over = false;
#pragma unroll
      for (int j = 0; j < NC; ++j) over |= static_cast<int>(cur[j]) > hq[j];
      return over;
    };
    unsigned acc[NC], cur[NC];
    int hq[NC];
    unsigned propose = 0, ok = 0, seen = 0;
    const bool ran_out = s.ran_out != 0;
    if (!ran_out) {
      // 1. node stage: cur' before each candidate, tentatively; the
      // thread's sum first, then again from what flows in
      if (has_head) atomicMax(&s.last_head[t & 1], r0 + 31 - __clz(heads));
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          acc[j] = (((heads >> q) & 1u) ? u0h[q][j] : acc[j]) -
                   x(takes, q, j);
        }
      }
      block_flow(s, acc, has_head, lane, w, s.seg);
      unsigned cut = 0;  // bit q: cur' before candidate q is not over
#pragma unroll
      for (int j = 0; j < NC; ++j) hq[j] = hq0[j];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const bool head = (heads >> q) & 1u;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          if (head) hq[j] = hqh[q][j];
          cur[j] = head ? u0h[q][j] : acc[j];
          acc[j] = cur[j] - x(takes, q, j);
        }
        if (((in >> q) & 1u) && !over_of(cur, hq)) cut |= 1u << q;
      }
      // the node's cut, seen at or before each candidate of its node
      bool run = false;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        run = (((heads >> q) & 1u) ? false : run) || ((cut >> q) & 1u);
        seen |= static_cast<unsigned>(run) << q;
      }
      if (block_cut(s, run, has_head, lane, w, s.seg_cut)) seen |= fed;
      const unsigned tent = takes & ~seen;  // those that subtract
      // 2. headroom stage: the headroom before each candidate
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] -= x(tent, q, j);
      }
      block_flow(s, acc, false, lane, w, s.avail);
      int first = Q;          // this thread's first exhausted candidate
      unsigned at[NC] = {};   // the headroom before it
      unsigned base[NC] = {}; // usage0 less the headroom at its last start
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if ((heads >> q) & 1u) {
#pragma unroll
          for (int j = 0; j < NC; ++j) base[j] = u0h[q][j] - acc[j];
        }
        bool exhausted = false;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          exhausted |= static_cast<int>(acc[j]) <= 0;
        }
        if (exhausted && first == Q && ((in >> q) & 1u)) {
          first = q;
#pragma unroll
          for (int j = 0; j < NC; ++j) at[j] = acc[j];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] -= x(tent, q, j);
      }
      const unsigned eb = __ballot_sync(FULL, first < Q);
      if (first < Q && lane == __ffs(eb) - 1) {
        atomicMin(&s.first_out[t & 1], r0 + first);
      }
      // last_head is final: stage 1 and 2's barriers followed the atomics
      const int last = s.last_head[t & 1];
      if (has_head && last == r0 + 31 - __clz(heads)) {
#pragma unroll
        for (int j = 0; j < NC; ++j) s.seg_base[j] = base[j];
      }
      __syncthreads();
      const int a = s.first_out[t & 1];
      if (tid == 0) {
        s.first_out[(t + 1) & 1] = TILE;
        s.last_head[(t + 1) & 1] = -1;
      }
      if (a == TILE) {  // the headroom lasts the tile
        store_streams<Q>(g, i0, in, eligible & ~seen, ~seen, ALL);
        if (tid == THREADS - 1) {
          // the open node's actual cur after the tile: usage0 at its last
          // start (or the carry) less the proposals since, which the
          // headroom's fall since then counts; a node cut in this tile
          // keeps its cut's value, not cur' (which ran on past the cut)
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const unsigned b =
                last >= 0 ? s.seg_base[j] : s.seg[j] - s.avail[j];
            s.seg[j] = b + acc[j];
            s.avail[j] = acc[j];
          }
          s.seg_cut = (seen >> (Q - 1)) & 1u;
        }
        continue;
      }
      // 3. the headroom runs out at a: the headroom before a is final
      const int before = a - r0;  // this thread's candidates before a
      ok = before <= 0 ? 0u : before >= Q ? ALL : (1u << before) - 1u;
      propose = eligible & ~seen & ok;
      if (before >= 0 && before < Q) {  // the thread holding a
#pragma unroll
        for (int j = 0; j < NC; ++j) s.avail[j] = at[j];
        s.ran_out = 1;
      }
    }
    // 3. cur from the actual proposals
    const unsigned sub = takes & propose;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        acc[j] = (((heads >> q) & 1u) ? u0h[q][j] : acc[j]) - x(sub, q, j);
      }
    }
    block_flow(s, acc, has_head, lane, w, s.seg);
    unsigned over = 0;
#pragma unroll
    for (int j = 0; j < NC; ++j) hq[j] = hq0[j];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const bool head = (heads >> q) & 1u;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (head) hq[j] = hqh[q][j];
        cur[j] = head ? u0h[q][j] : acc[j];
        acc[j] = cur[j] - x(sub, q, j);
      }
      if (over_of(cur, hq)) over |= 1u << q;
    }
    store_streams<Q>(g, i0, in, propose, over, ok);
    if (tid == THREADS - 1) {
#pragma unroll
      for (int j = 0; j < NC; ++j) s.seg[j] = acc[j];
    }
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      g.available_out[s.col[j]] = static_cast<int>(s.avail[j]);
    }
  }
}

// no participating column: nothing is over, nothing runs out, nothing
// is proposed
__device__ __forceinline__ void walk_none(const Args& g) {
  for (int i = threadIdx.x; i < g.k; i += THREADS) {
    if (i == g.refused) g.blocked[i] = 1;
    g.propose_out[i] = 0;
    g.over_out[i] = 0;
    g.ok_out[i] = 1;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    rebalance_scan_kernel(Args g, const uint8_t* __restrict__ res_mask) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& s = *reinterpret_cast<Shared*>(smem_raw);
  unsigned cols = 0;
#pragma unroll
  for (int c = 0; c < R; ++c) cols |= (res_mask[c] != 0 ? 1u : 0u) << c;
  if (threadIdx.x < R) {  // the columns that do not participate
    g.available_out[threadIdx.x] = g.available0[threadIdx.x];
  }
  __syncthreads();  // before walk's thread 0 overwrites its columns
  switch (__popc(cols)) {
    case 0: walk_none(g); break;
    case 1: walk<1>(s, g, cols); break;
    case 2: walk<2>(s, g, cols); break;
    case 3: walk<3>(s, g, cols); break;
    case 4: walk<4>(s, g, cols); break;
    case 5: walk<5>(s, g, cols); break;
    case 6: walk<6>(s, g, cols); break;
    case 7: walk<7>(s, g, cols); break;
    default: walk<8>(s, g, cols); break;
  }
}

__global__ void __launch_bounds__(THREADS, 1) empty_kernel() {}

}  // namespace scan

namespace {

// Lets `kernel` take the Shared struct as dynamic shared memory on the
// current device, once per device and kernel (`done` holds one flag per
// device). Returns a cudaError_t.
int allow_shared(const void* kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(scan::Shared)));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return static_cast<int>(err);
}

bool scan_allowed[64];
bool empty_allowed[64];

}  // namespace

// Launch on `stream` (one CTA of 512 threads, the Shared struct as
// dynamic shared memory). `refused` (-1: none) is walked as blocked and
// written into `blocked`; the streams are [K] each. Returns
// cudaGetLastError().
extern "C" int rebalance_scan_launch(
    const void* node_start, const void* usage0, const void* high_q,
    const void* metric, const void* has_metric, const void* valid,
    void* blocked, const void* available0, const void* res_mask, int k,
    int refused, void* propose_out, void* over_out, void* ok_out,
    void* available_out, void* stream) {
  scan::Args g;
  g.node_start = static_cast<const uint8_t*>(node_start);
  g.usage0 = static_cast<const int*>(usage0);
  g.high_q = static_cast<const int*>(high_q);
  g.metric = static_cast<const int*>(metric);
  g.has_metric = static_cast<const uint8_t*>(has_metric);
  g.valid = static_cast<const uint8_t*>(valid);
  g.blocked = static_cast<uint8_t*>(blocked);
  g.available0 = static_cast<const int*>(available0);
  g.k = k;
  g.refused = refused;
  g.propose_out = static_cast<uint8_t*>(propose_out);
  g.over_out = static_cast<uint8_t*>(over_out);
  g.ok_out = static_cast<uint8_t*>(ok_out);
  g.available_out = static_cast<int*>(available_out);
  const int err = allow_shared(
      reinterpret_cast<const void*>(scan::rebalance_scan_kernel),
      scan_allowed);
  if (err != 0) return err;
  scan::rebalance_scan_kernel<<<1, scan::THREADS, sizeof(scan::Shared),
                                static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const uint8_t*>(res_mask));
  return static_cast<int>(cudaGetLastError());
}

// The scan kernel's dynamic shared memory per CTA, in bytes.
extern "C" int rebalance_scan_shared_bytes() {
  return static_cast<int>(sizeof(scan::Shared));
}

// An empty kernel at the scan kernel's launch shape (one CTA of 512
// threads, the same dynamic shared memory): the launch floor that the
// sweep's times are read against. Returns cudaGetLastError().
extern "C" int rebalance_empty_launch(void* stream) {
  const int err = allow_shared(
      reinterpret_cast<const void*>(scan::empty_kernel), empty_allowed);
  if (err != 0) return err;
  scan::empty_kernel<<<1, scan::THREADS, sizeof(scan::Shared),
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
