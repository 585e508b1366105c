// The LowNodeLoad balance sweep on Hopper (sm_90a).
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
// What bounds it: the chain is strictly serial in i, each step reading
// the carry the last one wrote; the bytes (about 100 per candidate) are
// nothing beside it. So one warp walks the whole list, and the design
// keeps everything but the chain off the critical path:
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
