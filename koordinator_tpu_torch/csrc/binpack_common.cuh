// The placement solve shared by the two kernels for Hopper (sm_90a):
// binpack.cu (one block, its slice the whole node axis) and
// binpack_cluster.cu (the k CTAs of one thread-block cluster, one node
// slice each). Both replace koordinator_tpu/ops/pallas_binpack.py::
// _make_kernel with all its variants (plain, use_quota, use_resv,
// use_numa least and most; n_shards > 1 is the cluster kernel). They are
// bit-identical to each other and to the plain twins
// koordinator_tpu_torch/ops/binpack_kernel.py::binpack_plain and
// binpack_sharded_plain.
//
// What it computes, for each pod p in schedule order:
//   used'[j] = used[j] - Σ_{v on j, match[p,v]} rfree[v]      (RESV only)
//   fit[j]   = sched[j] & all_r(req[r]==0 | used'[j,r]+req[r] <= alloc[j,r])
//   s1[j]    = Σ_r w[r] * (alloc-requested)*100 // alloc   (LeastAllocated,
//              over used')
//   s2[j]    = Σ_r w[r] * (alloc-estimated)*100 // alloc   (LoadAware,
//              0 unless the node's metric is fresh; never sees the credit)
//   s3[j]    = floor mean over requested r of (cap-nreq)*100 // cap
//              (least) or nreq*100 // cap (most), nreq = cap-nfree+req,
//              0 where cap == 0 or nreq > cap                 (NUMA only)
//   s4[j]    = xscore[x, j], x = the pod's extras row        (extras only)
//   mask[j]  = fit & (daemonset | !fresh | la_ok) & xmask[x, j]
//              & quota_admit(p)
//   key[j]   = mask ? (s1//wsum + s2//wsum + s3 + s4) << 16 | (65535 - j)
//                   : -1
// then the max key names the top score at the smallest node index, and
// the winner's request, estimate and (for prod pods) prod estimate are
// added into its row. The quota gate checks used+req <= runtime (and
// np_used+req <= min for non-preemptible pods) on the pod's requested
// dims; a placed pod is added to its group's carries. With RESV the pod
// consumes the matched reservation on the winning node with the most
// free capacity (Σ_r rfree, int32; the smallest id among equals):
// delta = min(rfree, req), an allocate_once reservation releases the
// rest (rem) and drops to zero, and only req - delta - rem lands in
// used. With NUMA the winner's numa_free loses req when the pod or the
// node declares a topology policy. A pod with an extras row x >= 0 (the
// host rows of node selectors, host ports and the fine-grained plugins,
// one [X, N] byte mask and int32 score shared by the pods whose rows are
// equal) reads xmask[x, j] and xscore[x, j] for its own rows from device
// memory (consecutive threads, consecutive nodes: the loads coalesce);
// a pod without one (x = -1) pays one uniform branch. The wrapper routes
// extras here only when every score lies in [0, 100], so the key keeps
// its 15-bit score budget.
//
// Integer semantics are the reference's int32: sums and products wrap
// (done in unsigned arithmetic, where wrapping is defined), divisions
// floor.
//
// What bounds it on this card. Per pod every node row is scored, so the
// work is P x N row evaluations in a chain of P steps, and a step ends
// only when every CTA agrees on the winner. The card's bound (the data
// once, or the integer operations at the scalar rate) is far below the
// time of that chain: what counts is the instructions each SM issues per
// row and per pod, and the barriers between pods. The design cuts them:
//  a. The node slice lives on chip for the whole pod loop. Each CTA
//     stages its rows once, before the first pod, into shared memory,
//     one row after another at an odd word stride (a warp's loads of one
//     field hit 32 banks, and each field is an immediate offset from its
//     row, so an access is one instruction): alloc, used, usage + est as
//     one carry ue (all three
//     additions wrap mod 2^32 and the score reads only usage+est+ev; the
//     est output is ue - usage at the end), the sched/fresh/la_ok/
//     node-policy flags in one word, the division constants of alloc
//     (and of the NUMA capacity), and with RESV the slice's reservations
//     (their free rows, ids, allocate_once, and the node -> reservation
//     offsets). Shared memory and not registers: at 1,024 threads a
//     thread has 64 registers, one row is 25-60 words, and a slice of up
//     to ~1,500 rows needs a per-row index that registers cannot take.
//     prod is never read by the score: it stays in device memory, and
//     only the winner's row gets a fire-and-forget atomic add (its owner
//     is the only writer). A slice too large for 16 CTAs' shared memory
//     lives in a device-memory workspace (RESIDENT = false, the "L2
//     form"), in tiles of 32 rows stored field by field, so a warp's
//     load of one field is one 128-byte line and a field is still an
//     immediate offset from its row (Row below); the code is the same.
//     The [Q,8] quota tables sit in shared memory beside the pod
//     buffers when the route leaves room (Args::qshared); otherwise the
//     gate reads min and runtime from device memory and keeps the CTA's
//     carries in its own slice of the qused/qnp outputs.
//  b. Exact division by constants (Granlund & Montgomery 1994): every
//     divisor is fixed for the solve (alloc[j,r] and cap[j,r] clamped to
//     >= 1, wsum, the NUMA counts 1..8), and every dividend is clamped to
//     [0, 2^31) or is a signed sum floored through ~x. For d in
//     [1, 2^31), l = ceil(log2 d) and m = ceil(2^(31+l) / d) < 2^32, and
//     n / d == umulhi(m, 2n) >> l for every 0 <= n < 2^31 (m*d - 2^(31+l)
//     < d <= 2^l, their Theorem 4.2 with N = 31). Three instructions in
//     place of a ~20-instruction software division.
//     Columns whose weight is 0 add wmul(term, 0) = 0 to the score and
//     are skipped; the fit test and the NUMA term run only on the
//     requested columns. Both are short lists, the same for every
//     thread, walked as loops: an unrolled loop over all 8 columns
//     issues every column's instructions, predicated off or not.
//  c. One block barrier per pod (one-block kernel), or one block and one
//     cluster barrier (cluster kernel). Warp 0 runs the quota gate on
//     its CTA's copy of the quota carries (in shared memory; its lanes
//     0..7 are the only readers and writers of the 8 columns) and
//     publishes the verdict in a slot, while every warp scores; after
//     the barrier every warp reduces the 32 warp maxima itself, from a
//     slot double-buffered by pod parity. See solve() for why each slot
//     is safe.
//  d. Pods are prefetched: each pod's req, est, flags, NUMA policy and
//     match bits sit in one record ([P, rw] int32, built by the wrapper),
//     copied in chunks of `chunk` pods into a double buffer with cp.async
//     a chunk ahead, so no device-memory load is left on a pod's path
//     (but the L2 form's rows, and quota tables too large for shared
//     memory).
//
// Ownership: thread t of a CTA owns the slice rows t, t + NT, ...: it is
// the only thread that ever reads or writes their carries, reservations
// and outputs after the prologue, so rows need no atomics and no barrier.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int R = 8;             // resource columns
constexpr int NT = 1024;         // threads of each CTA
constexpr int WARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
// the pod record: req[8], est[8], daemonset (unblocked), prod, quota id,
// non-preemptible, NUMA policy, the masks of the columns with req != 0
// and with req > 0, the columns with req != 0 in ascending order (4 bits
// each, the first lowest), the extras row (-1: none) and 3 words of
// padding, then the match bits (reservation v is bit v & 31 of word
// v >> 5), padded to 4 words
constexpr int REC_EST = 8, REC_XROW = 24, REC_MATCH = 28;
// the row flags word
constexpr unsigned F_SCHED = 1, F_FRESH = 2, F_LA_OK = 4, F_NPOL = 8;

struct Args {
  const int* rec; int P; int rw; int chunk;
  const int* alloc; const int* usage; const int* sched; const int* fresh;
  const int* la_ok; int N;
  const int* weight; int wsum;
  const int* used0; const int* est0; const int* prod0;
  const int* qmin; const int* qrt; const int* qused0; const int* qnp0; int Q;
  const int* ncap; const int* nfree0; const int* npol;
  const int* rfree0; const int* aonce; const int* roff; const int* rids; int V;
  const unsigned char* xmask; const int* xscore;   // [X, N] extras rows
  int* assign; int* used; int* estx; int* prod; int* qused; int* qnp;
  int* nfree; int* consumed; int* vstar; int* delta; int* rem; int* rfree;
  int n_loc;    // rows of each CTA's slice
  char* work;   // RESIDENT = false: the slices, slice_bytes() apart
  int qshared;  // the quota tables in shared memory (else device memory)
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// A slice row, in 32-bit words: alloc[8], used[8], ue[8], the division
// constants of alloc[8], their 8 shift bytes (2 words), the flags word;
// with NUMA the capacity[8], numa_free[8], the capacity's constants[8]
// and shift bytes (2 words); with RESV the row's first reservation.
constexpr int W_ALLOC = 0, W_USED = 8, W_UE = 16, W_MAG = 24, W_SHF = 32,
              W_FLAGS = 34, W_NUMA = 35, NUMA_WORDS = 26;
// a reservation: free[8], id, allocate_once, one word of padding
constexpr int RESV_WORDS = 11;
// rows of a tile of the L2 form
constexpr int TILE = 32;

__host__ __device__ constexpr int row_words(bool resv, bool numa) {
  return (W_NUMA + (numa ? NUMA_WORDS : 0) + (resv ? 1 : 0)) | 1;
}

// the rows a slice of n_loc rows lays out: one more (the end row that
// closes the last row's reservations), in the L2 form whole tiles
__host__ __device__ constexpr int slice_rows(int n_loc, bool resident) {
  return resident ? n_loc + 1 : (n_loc + TILE) & ~(TILE - 1);
}

// bytes of one CTA's slice of n_loc rows with room for v reservations;
// ops/binpack_kernel.py::slice_bytes is the same formula
__host__ __device__ inline size_t slice_bytes(int n_loc, int v, bool resv,
                                              bool numa, bool resident) {
  size_t b = round16(slice_rows(n_loc, resident) * row_words(resv, numa) * 4);
  if (resv) b += round16(v * RESV_WORDS * 4);
  return b;
}

// One row of a slice, its words reached as row[w]. In shared memory
// (RESIDENT) the words follow each other: an odd row stride puts a
// warp's 32 rows on 32 banks. In the L2 form row i is lane i % 32 of a
// tile of 32 rows stored field by field (word w at tile[w * 32 + i % 32]),
// so a warp's access to one field is one 128-byte line, where rows one
// after another would touch 32. Either way a field is an immediate
// offset from the row's address.
template <bool RESIDENT>
struct Row {
  static constexpr int S = RESIDENT ? 1 : TILE;   // words between fields
  int* p;
  __device__ __forceinline__ int& operator[](int w) const { return p[w * S]; }
  // shift byte r (0..7) of the two words at w
  __device__ __forceinline__ int shift(int w, int r) const {
    if constexpr (RESIDENT) {
      return reinterpret_cast<const unsigned char*>(p + w)[r];
    } else {
      return (p[(w + (r >> 2)) * S] >> (8 * (r & 3))) & 255;
    }
  }
};

template <bool RESIDENT, bool RESV, bool NUMA>
struct Slice {
  static constexpr int W = row_words(RESV, NUMA);
  static constexpr int LOFF = W_NUMA + (NUMA ? NUMA_WORDS : 0);
  int* rows;
  int* res;
  __device__ __forceinline__ Slice(char* base, int n_loc)
      : rows(reinterpret_cast<int*>(base)),
        res(reinterpret_cast<int*>(
            base + round16(slice_rows(n_loc, RESIDENT) * W * 4))) {}
  __device__ __forceinline__ Row<RESIDENT> row(int i) const {
    if constexpr (RESIDENT) {
      return {rows + i * W};
    } else {
      return {rows + (i / TILE) * (TILE * W) + (i % TILE)};
    }
  }
  __device__ __forceinline__ int* resv(int c) const {
    return res + c * RESV_WORDS;
  }
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// floor(x / d) for any d != 0 (C '/' truncates toward zero); only for a
// non-positive weight sum, which no division constant covers
__device__ __forceinline__ int floor_div(int x, int d) {
  const int q = x / d;
  const int r = x % d;
  return (r != 0 && ((r < 0) != (d < 0))) ? q - 1 : q;
}

// the division constant of d in [1, 2^31): m, with l in *shift
__device__ __forceinline__ unsigned magic_of(int d, int* shift) {
  const int l = 32 - __clz(d - 1);
  *shift = l;
  return static_cast<unsigned>(
      ((1ull << (31 + l)) + static_cast<unsigned>(d) - 1) /
      static_cast<unsigned>(d));
}

// n / d for 0 <= n < 2^31, with (m, l) the constant of d
__device__ __forceinline__ int udiv(int n, unsigned m, int l) {
  return static_cast<int>(__umulhi(m, static_cast<unsigned>(n) << 1) >> l);
}

// floor(x / d) for any int32 x: floor(x/d) = -1 - (-1-x)/d = ~(~x / d)
// for x < 0, and ~x is in [0, 2^31)
__device__ __forceinline__ int floor_fast(int x, unsigned m, int l) {
  return x >= 0 ? udiv(x, m, l) : ~udiv(~x, m, l);
}

// the LeastAllocated-style term (a - v)*100 // a, 0 when a == 0 or
// v > a; the dividend is clamped at 0 and the divisor is max(a, 1)
__device__ __forceinline__ int least_fast(int a, int v, unsigned m, int l) {
  if (a == 0 || v > a) return 0;
  return udiv(max(wmul(wsub(a, v), 100), 0), m, l);
}

__device__ __forceinline__ void load_row(const int* __restrict__ base, int j,
                                         int (&out)[R]) {
  const int4* p = reinterpret_cast<const int4*>(base + static_cast<size_t>(j) * R);
  const int4 lo = p[0];
  const int4 hi = p[1];
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

__device__ __forceinline__ void store_row(int* __restrict__ base, int j,
                                          const int (&v)[R]) {
  int4* p = reinterpret_cast<int4*>(base + static_cast<size_t>(j) * R);
  p[0] = make_int4(v[0], v[1], v[2], v[3]);
  p[1] = make_int4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// pods [first, first + count) of the record array into dst, 16 bytes a
// thread at a time (rw is a multiple of 4 words)
__device__ __forceinline__ void stage_pods(int* dst, const Args& a, int first,
                                           int count) {
  const int* src = a.rec + static_cast<size_t>(first) * a.rw;
  const int units = count * a.rw / 4;
  for (int u = threadIdx.x; u < units; u += NT) cp_async16(dst + 4 * u, src + 4 * u);
  cp_async_commit();
}

// The whole solve, for one CTA. CLUSTER: the CTA is shard `block_rank`
// of a cluster, its slice rows [rank * n_loc, (rank + 1) * n_loc).
template <bool CLUSTER, bool RESIDENT, bool RESV, bool NUMA, bool MOST>
__device__ __forceinline__ void solve(const Args& a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_warp[2][WARPS];   // warp maxima, by pod parity
  __shared__ int s_admit[2];         // the quota verdict, by pod parity
  __shared__ int s_out[2];           // CLUSTER: the CTA's best, by parity
  __shared__ unsigned s_cnt_mag[R + 1];
  __shared__ int s_cnt_shf[R + 1];
  __shared__ int s_w[R];             // the resource weights
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int shard = 0, k = 1;
  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    shard = static_cast<int>(cl.block_rank());
    k = static_cast<int>(cl.num_blocks());
  }
  const int P = a.P, C = a.chunk, RW = a.rw, Q = a.Q;
  const int lo = min(shard * a.n_loc, a.N);    // my rows: [lo, hi)
  const int hi = min(shard * a.n_loc + a.n_loc, a.N);
  const int rows = hi - lo;

  int* pods = reinterpret_cast<int*>(smem);    // [2][C][RW]
  // the quota tables, [Q][8] each: min, runtime and this CTA's carries,
  // in shared memory after the pods, or else min and runtime read where
  // they lie and the carries kept in the CTA's slice of the outputs
  int* qs = pods + 2 * C * RW;
  const bool qsh = a.qshared;
  const int* q_min = qsh ? qs : a.qmin;
  const int* q_rt = qsh ? qs + Q * R : a.qrt;
  const size_t mine = static_cast<size_t>(shard) * Q * R;
  int* q_used = qsh ? qs + 2 * Q * R : a.qused + mine;
  int* q_np = qsh ? qs + 3 * Q * R : a.qnp + mine;
  char* base = RESIDENT
                   ? reinterpret_cast<char*>(qs + (qsh ? 4 * Q * R : 0))
                   : a.work + static_cast<size_t>(shard) *
                                  slice_bytes(a.n_loc, a.V, RESV, NUMA, false);
  using S = Slice<RESIDENT, RESV, NUMA>;
  const S s(base, a.n_loc);
  constexpr int LOFF = S::LOFF;
  const int r0 = RESV ? a.roff[lo] : 0;        // my reservations (CSR)
  const int nv = RESV ? a.roff[hi] - r0 : 0;

  // -- prologue: stage the slice, the quota copy and the first chunk --
  stage_pods(pods, a, 0, min(C, P));
  for (int i = tid; i < rows; i += NT) {
    const int j = lo + i;
    const auto row = s.row(i);
    int al[R], v[R], e[R];
    unsigned sh[2] = {0, 0};
    load_row(a.alloc, j, al);
    load_row(a.used0, j, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int l;
      row[W_ALLOC + r] = al[r];
      row[W_USED + r] = v[r];
      row[W_MAG + r] = static_cast<int>(magic_of(max(al[r], 1), &l));
      sh[r >> 2] |= static_cast<unsigned>(l) << (8 * (r & 3));
    }
    row[W_SHF] = static_cast<int>(sh[0]);
    row[W_SHF + 1] = static_cast<int>(sh[1]);
    load_row(a.usage, j, v);
    load_row(a.est0, j, e);
#pragma unroll
    for (int r = 0; r < R; ++r) row[W_UE + r] = wadd(v[r], e[r]);
    load_row(a.prod0, j, v);
    store_row(a.prod, j, v);
    unsigned f = (a.sched[j] ? F_SCHED : 0) | (a.fresh[j] ? F_FRESH : 0) |
                 (a.la_ok[j] ? F_LA_OK : 0);
    if (NUMA) {
      f |= a.npol[j] > 0 ? F_NPOL : 0;
      load_row(a.ncap, j, al);
      load_row(a.nfree0, j, v);
      unsigned nsh[2] = {0, 0};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int l;
        row[W_NUMA + r] = al[r];
        row[W_NUMA + 8 + r] = v[r];
        row[W_NUMA + 16 + r] = static_cast<int>(magic_of(max(al[r], 1), &l));
        nsh[r >> 2] |= static_cast<unsigned>(l) << (8 * (r & 3));
      }
      row[W_NUMA + 24] = static_cast<int>(nsh[0]);
      row[W_NUMA + 25] = static_cast<int>(nsh[1]);
    }
    row[W_FLAGS] = static_cast<int>(f);
    if (RESV) row[LOFF] = a.roff[j] - r0;
  }
  if (RESV) {
    if (tid == 0) s.row(rows)[LOFF] = nv;
    for (int c = tid; c < nv; c += NT) {
      const int id = a.rids[r0 + c];
      int* rv = s.resv(c);
      int f[R];
      load_row(a.rfree0, id, f);
#pragma unroll
      for (int r = 0; r < R; ++r) rv[r] = f[r];
      rv[R] = id;
      rv[R + 1] = a.aonce[id] > 0;
    }
  }
  for (int x = tid; x < Q * R; x += NT) {
    if (qsh) {
      qs[x] = a.qmin[x];
      qs[Q * R + x] = a.qrt[x];
    }
    q_used[x] = a.qused0[x];
    q_np[x] = a.qnp0[x];
  }
  if (NUMA && tid <= R) {
    int l;
    s_cnt_mag[tid] = magic_of(max(tid, 1), &l);
    s_cnt_shf[tid] = l;
  }
  // the columns whose weight is not 0, 4 bits each: the others add
  // wmul(term, 0) = 0 to the score
  unsigned wcols = 0;
  int nw = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (a.weight[r] != 0) wcols |= static_cast<unsigned>(r) << (4 * nw++);
  }
  if (tid < R) s_w[tid] = a.weight[tid];
  const int wsum = a.wsum;
  int wl = 0;
  const unsigned wm = wsum > 0 ? magic_of(wsum, &wl) : 0;
  cp_async_wait_all();
  __syncthreads();

  // -- the pod loop --
  for (int p = 0, chunk = 0, pi = 0; p < P;
       ++p, pi = (pi + 1 == C) ? 0 : pi + 1, chunk += pi == 0) {
    // the next chunk goes into the other buffer, which held chunk - 1:
    // every thread is past this chunk's first barrier, so done with it
    if (pi == 1 && (chunk + 1) * C < P) {
      stage_pods(pods + ((chunk + 1) & 1) * C * RW, a, (chunk + 1) * C,
                 min(C, P - (chunk + 1) * C));
    }
    const int* rec = pods + ((chunk & 1) * C + pi) * RW;
    const int4* rec4 = reinterpret_cast<const int4*>(rec);   // 16-byte aligned
    const int4 fl4 = rec4[4], mk4 = rec4[5];
    const bool is_ds = fl4.x > 0;
    const bool is_prod = fl4.y > 0;
    const int qid = fl4.z;
    const bool non_pre = fl4.w > 0;
    const bool pod_numa = mk4.x > 0;
    const int nrq = __popc(static_cast<unsigned>(mk4.y));
    const unsigned pmask = static_cast<unsigned>(mk4.z);
    const unsigned rcols = static_cast<unsigned>(mk4.w);
    const bool quota_on = Q > 0 && qid >= 0 && qid < Q;
    const unsigned* mbits = reinterpret_cast<const unsigned*>(rec + REC_MATCH);
    // the pod's extras row, or none
    const int xrow = rec[REC_XROW];
    const size_t xoff = static_cast<size_t>(xrow) * a.N;
    const unsigned char* xm = xrow >= 0 ? a.xmask + xoff : nullptr;
    const int* xs = xrow >= 0 ? a.xscore + xoff : nullptr;

    // the quota gate: lane r of warp 0 checks resource r on this CTA's
    // copy; the other warps score meanwhile and the verdict is applied
    // after the barrier
    int admit = 1;
    if (warp == 0) {
      int viol = 0;
      if (quota_on && lane < R) {
        const int rr = rec[lane];
        const int at = qid * R + lane;
        if (rr > 0) {
          viol = wadd(q_used[at], rr) > q_rt[at] ||
                 (non_pre && wadd(q_np[at], rr) > q_min[at]);
        }
      }
      admit = !__any_sync(FULL, viol);
      if (lane == 0) s_admit[p & 1] = admit;
    }

    // score my rows, keep the max packed key (global node index)
    int best = -1;
    if (admit) {
      for (int i = tid; i < rows; i += NT) {
        const auto row = s.row(i);
        const unsigned fl = static_cast<unsigned>(row[W_FLAGS]);
        if (!(fl & F_SCHED)) continue;
        const bool fr = fl & F_FRESH;
        if (!(is_ds || !fr || (fl & F_LA_OK))) continue;
        int xsc = 0;
        if (xm != nullptr) {
          if (!xm[lo + i]) continue;
          xsc = xs[lo + i];
        }
        // used minus the matched reservations' free, on column r
        const int c0 = RESV ? row[LOFF] : 0;
        const int c1 = RESV ? s.row(i + 1)[LOFF] : 0;
        auto used_of = [&](int r) {
          int u = row[W_USED + r];
          if (RESV) {
            for (int c = c0; c < c1; ++c) {
              const int* rv = s.resv(c);
              const int id = rv[R];
              if ((mbits[id >> 5] >> (id & 31)) & 1u) u = wsub(u, rv[r]);
            }
          }
          return u;
        };
        // the columns are lists the same for every thread, walked as
        // loops: an unrolled loop over all 8 would issue every column
        bool fit = true;
#pragma unroll 1
        for (int c = 0; c < nrq; ++c) {
          const int r = (rcols >> (4 * c)) & 15;
          if (wadd(used_of(r), rec[r]) > row[W_ALLOC + r]) {
            fit = false;
            break;
          }
        }
        if (!fit) continue;
        int s1 = 0, s2 = 0;
#pragma unroll 1
        for (int c = 0; c < nw; ++c) {
          const int r = (wcols >> (4 * c)) & 15;
          const int al = row[W_ALLOC + r];
          const unsigned m = static_cast<unsigned>(row[W_MAG + r]);
          const int l = row.shift(W_SHF, r);
          const int wr = s_w[r];
          s1 = wadd(s1, wmul(least_fast(al, wadd(used_of(r), rec[r]), m, l), wr));
          if (fr) {
            const int eu = wadd(row[W_UE + r], rec[REC_EST + r]);
            s2 = wadd(s2, wmul(least_fast(al, eu, m, l), wr));
          }
        }
        int score;
        if (wsum > 0) {
          score = wadd(floor_fast(s1, wm, wl), fr ? floor_fast(s2, wm, wl) : 0);
        } else {
          score = wadd(floor_div(s1, wsum), fr ? floor_div(s2, wsum) : 0);
        }
        if (NUMA && pmask) {
          int psum = 0;
#pragma unroll 1
          for (int c = 0; c < nrq; ++c) {
            const int r = (rcols >> (4 * c)) & 15;
            const int rr = rec[r];
            if (rr <= 0) continue;
            const int cap = row[W_NUMA + r];
            const int nreq = wadd(wsub(cap, row[W_NUMA + 8 + r]), rr);
            if (cap > 0 && nreq <= cap) {
              const int numer = MOST ? nreq : wsub(cap, nreq);
              psum = wadd(psum, floor_fast(
                  wmul(numer, 100), static_cast<unsigned>(row[W_NUMA + 16 + r]),
                  row.shift(W_NUMA + 24, r)));
            }
          }
          const int cnt = __popc(pmask);
          score = wadd(score, floor_fast(psum, s_cnt_mag[cnt], s_cnt_shf[cnt]));
        }
        score = wadd(score, xsc);
        const int key = static_cast<int>((static_cast<unsigned>(score) << 16) |
                                         static_cast<unsigned>(65535 - (lo + i)));
        best = max(best, key);
      }
    }
    best = __reduce_max_sync(FULL, best);
    if (lane == 0) s_warp[p & 1][warp] = best;
    if (pi == C - 1) cp_async_wait_all();   // the next chunk, before its use
    // The one block barrier of the pod. Why the parity slots are safe: a
    // warp writes s_warp[p & 1] and s_admit[p & 1] again only at pod
    // p + 2, after it has passed pod p + 1's barrier, which every warp
    // reaches only after it has read pod p's slots below.
    __syncthreads();

    int m;
    if constexpr (!CLUSTER) {
      m = __reduce_max_sync(FULL, s_warp[p & 1][lane]);
      if (!s_admit[p & 1]) m = -1;
    } else {
      cg::cluster_group cl = cg::this_cluster();
      if (warp == 0) {
        const int b = __reduce_max_sync(FULL, s_warp[p & 1][lane]);
        if (lane == 0) s_out[p & 1] = admit ? b : -1;
      }
      // The cluster barrier (arrive is a release, wait an acquire, so
      // the slot written before it is what the peers read after it). A
      // CTA rewrites s_out[p & 1] only at pod p + 2, after pod p + 1's
      // cluster barrier, which every thread of every CTA reaches only
      // after reading pod p's k slots below. Every CTA replays the same
      // quota gate, so a rejected pod's slots are all -1.
      cl.sync();
      const int b = lane < k ? *cl.map_shared_rank(&s_out[p & 1], lane) : -1;
      m = __reduce_max_sync(FULL, b);
    }

    const int node = m >= 0 ? 65535 - (m & 65535) : -1;
    if (node >= 0) {
      const int i = node - lo;
      if (i >= 0 && i < rows && i % NT == tid) {   // the owner updates it
        const auto row = s.row(i);
        int rq[R], ev[R], net[R];
        {
          const int4 a0 = rec4[0], a1 = rec4[1], b0 = rec4[2], b1 = rec4[3];
          rq[0] = a0.x; rq[1] = a0.y; rq[2] = a0.z; rq[3] = a0.w;
          rq[4] = a1.x; rq[5] = a1.y; rq[6] = a1.z; rq[7] = a1.w;
          ev[0] = b0.x; ev[1] = b0.y; ev[2] = b0.z; ev[3] = b0.w;
          ev[4] = b1.x; ev[5] = b1.y; ev[6] = b1.z; ev[7] = b1.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) net[r] = rq[r];
        if (RESV) {
          // the most-free matched reservation on this node: ids ascend
          // within the node, so a strict '>' keeps the smallest id
          int bf = 0, vs = -1;
          for (int c = row[LOFF], c1 = s.row(i + 1)[LOFF]; c < c1; ++c) {
            const int* rv = s.resv(c);
            const int id = rv[R];
            if (!((mbits[id >> 5] >> (id & 31)) & 1u)) continue;
            int fs = 0;
#pragma unroll
            for (int r = 0; r < R; ++r) fs = wadd(fs, rv[r]);
            if (fs > bf) { bf = fs; vs = c; }
          }
          int d[R], rm[R];
#pragma unroll
          for (int r = 0; r < R; ++r) { d[r] = 0; rm[r] = 0; }
          if (vs >= 0) {
            int* rv = s.resv(vs);
            const bool once = rv[R + 1];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int f = rv[r];
              d[r] = min(f, rq[r]);
              rm[r] = once ? wsub(f, d[r]) : 0;
              rv[r] = once ? 0 : wsub(f, d[r]);
              net[r] = wsub(wsub(net[r], d[r]), rm[r]);
            }
          }
          a.vstar[p] = vs >= 0 ? s.resv(vs)[R] : -1;
          store_row(a.delta, p, d);
          store_row(a.rem, p, rm);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          row[W_USED + r] = wadd(row[W_USED + r], net[r]);
          row[W_UE + r] = wadd(row[W_UE + r], ev[r]);
        }
        if (is_prod) {   // never read by the score: a reduction, no load
#pragma unroll
          for (int r = 0; r < R; ++r) atomicAdd(a.prod + node * R + r, ev[r]);
        }
        if (NUMA) {
          const bool take = pod_numa || (row[W_FLAGS] & F_NPOL);
          if (take) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              row[W_NUMA + 8 + r] = wsub(row[W_NUMA + 8 + r], rq[r]);
            }
          }
          a.consumed[p] = take ? 1 : 0;
        }
      }
      if (quota_on && tid < R) {     // every CTA replays the add
        const int rr = rec[tid];
        const int at = qid * R + tid;
        if (rr > 0) {
          q_used[at] = wadd(q_used[at], rr);
          if (non_pre) q_np[at] = wadd(q_np[at], rr);
        }
      }
    } else if (shard == 0 && tid == 0) {   // not placed
      if (RESV) {
        const int z[R] = {0, 0, 0, 0, 0, 0, 0, 0};
        a.vstar[p] = -1;
        store_row(a.delta, p, z);
        store_row(a.rem, p, z);
      }
      if (NUMA) a.consumed[p] = 0;
    }
    if (shard == 0 && tid == 0) a.assign[p] = node;
  }

  // -- epilogue: each owner writes its rows and reservations back --
  for (int i = tid; i < rows; i += NT) {
    const int j = lo + i;
    const auto row = s.row(i);
    int v[R], us[R];
    load_row(a.usage, j, us);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = row[W_USED + r];
    store_row(a.used, j, v);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = wsub(row[W_UE + r], us[r]);
    store_row(a.estx, j, v);
    if (NUMA) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = row[W_NUMA + 8 + r];
      store_row(a.nfree, j, v);
    }
    if (RESV) {
      for (int c = row[LOFF], c1 = s.row(i + 1)[LOFF]; c < c1; ++c) {
        const int* rv = s.resv(c);
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = rv[r];
        store_row(a.rfree, rv[R], v);
      }
    }
  }
  if (qsh && tid < R) {   // this CTA's quota copy (qused/qnp[shard])
    int* qu = a.qused + static_cast<size_t>(shard) * Q * R;
    int* qn = a.qnp + static_cast<size_t>(shard) * Q * R;
    for (int q = 0; q < Q; ++q) {
      qu[q * R + tid] = q_used[q * R + tid];
      qn[q * R + tid] = q_np[q * R + tid];
    }
  }
  if constexpr (CLUSTER) {
    // no CTA exits (and frees its shared memory) while a peer may still
    // read its last slot
    cg::this_cluster().sync();
  }
}

// calls f with the instance G::get<RESV, NUMA, MOST>() of a variant
template <typename G, typename F>
cudaError_t with_instance(int resv, int numa, int most, F&& f) {
  if (!numa) {
    return resv ? f(G::template get<true, false, false>())
                : f(G::template get<false, false, false>());
  }
  if (most) {
    return resv ? f(G::template get<true, true, true>())
                : f(G::template get<false, true, true>());
  }
  return resv ? f(G::template get<true, true, false>())
              : f(G::template get<false, true, false>());
}

// the launch arguments of both entry points, in the C interface's order
#define BINPACK_C_PARAMS                                                   \
  const int *rec, int P, int rw, int chunk, const int *alloc,              \
      const int *usage, const int *sched, const int *fresh,                \
      const int *la_ok, int N, const int *weight, int wsum,                \
      const int *used0, const int *est0, const int *prod0,                 \
      const int *qmin, const int *qrt, const int *qused0, const int *qnp0, \
      int Q, const int *ncap, const int *nfree0, const int *npol,          \
      int numa, int most, const int *rfree0, const int *aonce,             \
      const int *roff, const int *rids, int V,                             \
      const unsigned char *xmask, const int *xscore, int *assign,          \
      int *used, int *estx, int *prod, int *qused, int *qnp, int *nfree,   \
      int *consumed, int *vstar, int *delta, int *rem, int *rfree

#define BINPACK_ARGS_INIT(n_loc, work, qshared)                            \
  Args{rec, P, rw, chunk, alloc, usage, sched, fresh, la_ok, N, weight,    \
       wsum, used0, est0, prod0, qmin, qrt, qused0, qnp0, Q, ncap, nfree0, \
       npol, rfree0, aonce, roff, rids, V, xmask, xscore, assign, used,    \
       estx, prod, qused, qnp, nfree, consumed, vstar, delta, rem, rfree,  \
       n_loc, work, qshared}

// The lane axis: K independent plain solves (no quota, reservations, NUMA
// or extras) in one launch, lane blockIdx.y, each lane the solve above on
// its own pointers. It replaces the reference's jax.vmap of the scan over
// lanes (koordinator_tpu/service/admission.py::_vmapped_plain_assign, one
// shared base; service/tenancy.py::_vmapped_tenant_solve, a base per
// lane). Every lane has its own pod records (P of them, the short lanes
// padded with blocked pods), LoadAware verdicts, weights, weight sum and
// outputs; the seven node arrays are one base shared by every lane
// (base_stride 0) or a base per lane (base_stride 1, the shorter worlds
// padded with unschedulable zero rows). In the L2 form each lane has
// work_stride bytes of workspace. Lanes share nothing, so the grid's lanes
// run on whatever SMs are free, and a batch costs one launch.
struct LaneArgs {
  Args a;                        // lane 0's pointers
  const int* wsum;               // [K] each lane's weight sum
  int base_stride;               // 0: one base; 1: [K, N, ...] bases
  unsigned long long work_stride;
};

__device__ __forceinline__ Args lane_args(const LaneArgs& l) {
  const size_t lane = blockIdx.y;
  const size_t P = l.a.P, N = l.a.N;
  const size_t b = l.base_stride ? lane * N : 0;
  Args a = l.a;
  a.rec += lane * P * a.rw;
  a.alloc += b * R;
  a.usage += b * R;
  a.sched += b;
  a.fresh += b;
  a.used0 += b * R;
  a.est0 += b * R;
  a.prod0 += b * R;
  a.la_ok += lane * N;
  a.weight += lane * R;
  a.wsum = l.wsum[lane];
  a.assign += lane * P;
  a.used += lane * N * R;
  a.estx += lane * N * R;
  a.prod += lane * N * R;
  if (a.work != nullptr) a.work += lane * l.work_stride;
  return a;
}

// the lane launches' C parameters: the plain solve's, wsum per lane
#define BINPACK_LANE_C_PARAMS                                              \
  const int *rec, int P, int rw, int chunk, const int *alloc,              \
      const int *usage, const int *sched, const int *fresh,                \
      const int *la_ok, int N, const int *weight, const int *wsum,         \
      const int *used0, const int *est0, const int *prod0, int *assign,    \
      int *used, int *estx, int *prod, int lanes, int base_stride

#define BINPACK_LANE_ARGS_INIT(n_loc, work, work_stride)                   \
  LaneArgs{Args{rec, P, rw, chunk, alloc, usage, sched, fresh, la_ok, N,   \
                weight, 0, used0, est0, prod0, nullptr, nullptr, nullptr,  \
                nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr,   \
                nullptr, nullptr, 0, nullptr, nullptr, assign, used, estx, \
                prod, nullptr, nullptr, nullptr, nullptr, nullptr,         \
                nullptr, nullptr, nullptr, n_loc, work, 1},                \
           wsum, base_stride, work_stride}

}  // namespace
