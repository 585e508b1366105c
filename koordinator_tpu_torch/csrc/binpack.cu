// Placement kernel for Hopper (sm_90a): the batched greedy bin-pack.
//
// Replaces koordinator_tpu/ops/pallas_binpack.py::_make_kernel, all its
// single-chip variants (plain, use_quota, use_resv, use_numa least and
// most; launched by pl.pallas_call in _pallas_solve). Bit-identical to
// it and to the plain twin
// koordinator_tpu_torch/ops/binpack_kernel.py::binpack_plain.
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
//   mask[j]  = fit & (daemonset | !fresh | la_ok) & quota_admit(p)
//   key[j]   = mask ? (s1//wsum + s2//wsum + s3) << 16 | (65535 - j) : -1
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
// node declares a topology policy.
//
// Design. The TPU ran the pods as a sequential grid over one core with
// the node carry in VMEM. Here one thread block walks the pods in order
// (the loop replaces the sequential grid). Thread t owns node rows t,
// t+NT, ...: it is the only thread that ever reads or writes the
// carries (used/est/prod/numa_free) of those rows, so no atomics and no
// barrier are needed around the row update. The [N,8] int32 rows are 32
// contiguous bytes, read as two 16-byte loads. Reservations reach the
// kernel as a node -> reservation CSR (roff[N+1], rids[V] sorted by
// (node, id)): reservation v's free row belongs to the thread that owns
// v's node, so the credit and the consumption need no atomics either,
// and the credit is an exact int32 sum (the TPU's hi/lo f32 one-hot
// matmul, and its 256-reservation cap, existed only for the MXU).
// Threads 0..7 own the 8 resource columns of the [Q,8] quota carries
// the same way. Per pod: warp 0 evaluates the quota gate (barrier A),
// every thread scores its rows and reduces its packed keys with warp
// shuffles into shared memory (barrier B), warp 0 reduces the warp
// maxima (barrier C), and the owner of the winning row updates it and
// writes the pod's reservation and NUMA outputs (thread 0 writes them
// for a pod that was not placed).
//
// Each variant is its own template instance (NT threads, RESV, NUMA,
// MOST), so the plain/quota code is the same as without the new
// variants and ptxas reports registers and spills per variant.
//
// Integer semantics are the reference's int32 (binpack_common.cuh).
//
// Bound on this card: per pod the kernel reads four [N,8] int32 arrays
// (alloc, usage, used, est), two more with NUMA, and the matched
// reservations' rows with RESV: 0.64-0.96 MB at 5k nodes, 6.4-9.6 GB
// over 10k pods, 2-3 ms at 3.35 TB/s if it streamed from device memory
// at the full rate. The carries fit in the 50 MB L2, but one block runs
// on one SM and gets only that SM's share of L2 bandwidth, plus three
// block-wide barriers per pod, so expect the kernel far above that
// bound. binpack_cluster.cu splits the node axis over the CTAs of a
// thread-block cluster and merges their packed keys across it.

#include <cuda_runtime.h>

#include "binpack_common.cuh"

namespace {

template <int NT, bool RESV, bool NUMA, bool MOST>
__global__ void __launch_bounds__(NT, 1) binpack_kernel(
    const int* __restrict__ req, const int* __restrict__ est,
    const int* __restrict__ flags, int P,
    const int* __restrict__ alloc, const int* __restrict__ usage,
    const int* __restrict__ sched, const int* __restrict__ fresh,
    const int* __restrict__ la_ok, int N,
    const int* __restrict__ weight, int wsum,
    const int* __restrict__ used0, const int* __restrict__ est0,
    const int* __restrict__ prod0,
    const int* __restrict__ qmin, const int* __restrict__ qrt,
    const int* __restrict__ qused0, const int* __restrict__ qnp0, int Q,
    const int* __restrict__ ncap, const int* __restrict__ nfree0,
    const int* __restrict__ npol, const int* __restrict__ pod_numa,
    const int* __restrict__ rfree0, const int* __restrict__ aonce,
    const int* __restrict__ roff, const int* __restrict__ rids,
    const unsigned char* __restrict__ match, int V,
    int* __restrict__ assign, int* __restrict__ used, int* __restrict__ estx,
    int* __restrict__ prod, int* __restrict__ qused, int* __restrict__ qnp,
    int* __restrict__ nfree, int* __restrict__ consumed,
    int* __restrict__ vstar, int* __restrict__ delta, int* __restrict__ rem,
    int* __restrict__ rfree) {
  constexpr int WARPS = NT / 32;
  __shared__ int s_admit;
  __shared__ int s_warp_best[WARPS];
  __shared__ int s_best;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // initial carries: each thread copies the rows (and quota column) it
  // owns, and the free rows of its nodes' reservations
  for (int j = tid; j < N; j += NT) {
    int v[R];
    load_row(used0, j, v); store_row(used, j, v);
    load_row(est0, j, v); store_row(estx, j, v);
    load_row(prod0, j, v); store_row(prod, j, v);
    if (NUMA) { load_row(nfree0, j, v); store_row(nfree, j, v); }
    if (RESV) {
      for (int k = roff[j]; k < roff[j + 1]; ++k) {
        const int rv = rids[k];
        load_row(rfree0, rv, v); store_row(rfree, rv, v);
      }
    }
  }
  if (tid < R) {
    for (int q = 0; q < Q; ++q) {
      qused[q * R + tid] = qused0[q * R + tid];
      qnp[q * R + tid] = qnp0[q * R + tid];
    }
  }

  int w[R];
#pragma unroll
  for (int r = 0; r < R; ++r) w[r] = weight[r];

  for (int p = 0; p < P; ++p) {
    int rq[R], ev[R];
    load_row(req, p, rq);   // same address across the block: a broadcast
    load_row(est, p, ev);
    const bool is_ds = flags[p * FLAGS + 0] > 0;
    const bool is_prod = flags[p * FLAGS + 1] > 0;
    const int qid = flags[p * FLAGS + 2];
    const bool non_pre = flags[p * FLAGS + 3] > 0;
    const bool quota_on = Q > 0 && qid >= 0 && qid < Q;
    const unsigned char* mrow =
        RESV ? match + static_cast<size_t>(p) * V : nullptr;

    // (A) the quota gate: lane r of warp 0 checks resource r
    if (warp == 0) {
      int viol = 0;
      if (quota_on && lane < R) {
        const int rr = req[p * R + lane];
        const int at = qid * R + lane;
        if (rr > 0) {
          viol = wadd(qused[at], rr) > qrt[at] ||
                 (non_pre && wadd(qnp[at], rr) > qmin[at]);
        }
      }
      const int any = __any_sync(FULL, viol);
      if (lane == 0) s_admit = !any;
    }
    __syncthreads();

    // (B) score my rows, keep the max packed key
    int best = -1;
    if (s_admit) {
      for (int j = tid; j < N; j += NT) {
        if (!sched[j]) continue;
        const int fr = fresh[j];
        if (!(is_ds || !fr || la_ok[j])) continue;
        int al[R], u[R];
        load_row(alloc, j, al);
        load_row(used, j, u);
        if (RESV) {   // matched reservations' free credited back
          for (int k = roff[j]; k < roff[j + 1]; ++k) {
            const int rv = rids[k];
            if (!mrow[rv]) continue;
            int f[R];
            load_row(rfree, rv, f);
#pragma unroll
            for (int r = 0; r < R; ++r) u[r] = wsub(u[r], f[r]);
          }
        }
        bool fit = true;
        int s1 = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int requested = wadd(u[r], rq[r]);
          if (rq[r] != 0 && requested > al[r]) fit = false;
          s1 = wadd(s1, wmul(least_term(al[r], requested), w[r]));
        }
        if (!fit) continue;
        int s2 = 0;
        if (fr) {
          int us[R], ex[R];
          load_row(usage, j, us);
          load_row(estx, j, ex);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int eu = wadd(wadd(us[r], ex[r]), ev[r]);
            s2 = wadd(s2, wmul(least_term(al[r], eu), w[r]));
          }
          s2 = floor_div(s2, wsum);
        }
        int score = wadd(floor_div(s1, wsum), s2);
        if (NUMA) {
          int c[R], nf[R];
          load_row(ncap, j, c);
          load_row(nfree, j, nf);
          int psum = 0, cnt = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (rq[r] <= 0) continue;
            ++cnt;
            const int nreq = wadd(wsub(c[r], nf[r]), rq[r]);
            if (c[r] > 0 && nreq <= c[r]) {
              const int numer = MOST ? nreq : wsub(c[r], nreq);
              psum = wadd(psum, floor_div(wmul(numer, 100), c[r]));
            }
          }
          if (cnt > 0) score = wadd(score, floor_div(psum, cnt));
        }
        const int key = static_cast<int>((static_cast<unsigned>(score) << 16) |
                                         static_cast<unsigned>(65535 - j));
        best = max(best, key);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      best = max(best, __shfl_xor_sync(FULL, best, off));
    }
    if (lane == 0) s_warp_best[warp] = best;
    __syncthreads();

    // (C) block max over the warp maxima
    if (warp == 0) {
      int k = (WARPS == 32 || lane < WARPS) ? s_warp_best[lane] : -1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        k = max(k, __shfl_xor_sync(FULL, k, off));
      }
      if (lane == 0) s_best = k;
    }
    __syncthreads();

    const int m = s_best;
    const int node = m >= 0 ? 65535 - (m & 65535) : -1;
    if (node >= 0) {
      if (node % NT == tid) {   // the owner updates the winning row
        int v[R];
        int net[R];
#pragma unroll
        for (int r = 0; r < R; ++r) net[r] = rq[r];
        if (RESV) {
          // the most-free matched reservation on this node: ids ascend
          // within the node, so a strict '>' keeps the smallest id
          int bf = 0, vs = -1;
          for (int k = roff[node]; k < roff[node + 1]; ++k) {
            const int rv = rids[k];
            if (!mrow[rv]) continue;
            int f[R];
            load_row(rfree, rv, f);
            int fs = 0;
#pragma unroll
            for (int r = 0; r < R; ++r) fs = wadd(fs, f[r]);
            if (fs > bf) { bf = fs; vs = rv; }
          }
          int d[R], rm[R];
#pragma unroll
          for (int r = 0; r < R; ++r) { d[r] = 0; rm[r] = 0; }
          if (vs >= 0) {
            int f[R];
            load_row(rfree, vs, f);
            const bool once = aonce[vs] > 0;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              d[r] = min(f[r], rq[r]);
              rm[r] = once ? wsub(f[r], d[r]) : 0;
              f[r] = once ? 0 : wsub(f[r], d[r]);
              net[r] = wsub(wsub(net[r], d[r]), rm[r]);
            }
            store_row(rfree, vs, f);
          }
          vstar[p] = vs;
          store_row(delta, p, d);
          store_row(rem, p, rm);
        }
        load_row(used, node, v);
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = wadd(v[r], net[r]);
        store_row(used, node, v);
        load_row(estx, node, v);
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = wadd(v[r], ev[r]);
        store_row(estx, node, v);
        if (is_prod) {
          load_row(prod, node, v);
#pragma unroll
          for (int r = 0; r < R; ++r) v[r] = wadd(v[r], ev[r]);
          store_row(prod, node, v);
        }
        if (NUMA) {
          const bool take = pod_numa[p] > 0 || npol[node] > 0;
          if (take) {
            load_row(nfree, node, v);
#pragma unroll
            for (int r = 0; r < R; ++r) v[r] = wsub(v[r], rq[r]);
            store_row(nfree, node, v);
          }
          consumed[p] = take ? 1 : 0;
        }
      }
      if (quota_on && tid < R) {     // thread r owns quota column r
        const int rr = req[p * R + tid];
        const int at = qid * R + tid;
        if (rr > 0) {
          qused[at] = wadd(qused[at], rr);
          if (non_pre) qnp[at] = wadd(qnp[at], rr);
        }
      }
    } else if (tid == 0) {           // not placed: no reservation, no NUMA
      if (RESV) {
        const int z[R] = {0, 0, 0, 0, 0, 0, 0, 0};
        vstar[p] = -1;
        store_row(delta, p, z);
        store_row(rem, p, z);
      }
      if (NUMA) consumed[p] = 0;
    }
    if (tid == 0) assign[p] = node;
  }
}

}  // namespace

#define BINPACK_ARGS                                                        \
  req, est, flags, P, alloc, usage, sched, fresh, la_ok, N, weight, wsum,  \
      used0, est0, prod0, qmin, qrt, qused0, qnp0, Q, ncap, nfree0, npol,   \
      pod_numa, rfree0, aonce, roff, rids, match, V, assign, used, estx,    \
      prod, qused, qnp, nfree, consumed, vstar, delta, rem, rfree

#define BINPACK_LAUNCH(NT, RESV, NUMA, MOST)                                \
  binpack_kernel<NT, RESV, NUMA, MOST><<<1, NT, 0, s>>>(BINPACK_ARGS)

extern "C" int binpack_launch(
    const int* req, const int* est, const int* flags, int P,
    const int* alloc, const int* usage, const int* sched, const int* fresh,
    const int* la_ok, int N, const int* weight, int wsum,
    const int* used0, const int* est0, const int* prod0,
    const int* qmin, const int* qrt, const int* qused0, const int* qnp0, int Q,
    const int* ncap, const int* nfree0, const int* npol, const int* pod_numa,
    int numa, int most,
    const int* rfree0, const int* aonce, const int* roff, const int* rids,
    const unsigned char* match, int V,
    int* assign, int* used, int* estx, int* prod, int* qused, int* qnp,
    int* nfree, int* consumed,
    int* vstar, int* delta, int* rem, int* rfree,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool resv = V > 0;
  if (!numa) {
    if (resv) BINPACK_LAUNCH(1024, true, false, false);
    else BINPACK_LAUNCH(1024, false, false, false);
  } else if (most) {
    if (resv) BINPACK_LAUNCH(1024, true, true, true);
    else BINPACK_LAUNCH(1024, false, true, true);
  } else {
    if (resv) BINPACK_LAUNCH(1024, true, true, false);
    else BINPACK_LAUNCH(1024, false, true, false);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* binpack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
