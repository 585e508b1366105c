// Placement kernel for Hopper (sm_90a): the batched greedy bin-pack.
//
// Replaces koordinator_tpu/ops/pallas_binpack.py::_make_kernel, the
// plain and use_quota variants (launched by pl.pallas_call in
// _pallas_solve). Bit-identical to it and to the plain twin
// koordinator_tpu_torch/ops/binpack_kernel.py::binpack_plain.
//
// What it computes, for each pod p in schedule order:
//   fit[j]   = sched[j] & all_r(req[r]==0 | used[j,r]+req[r] <= alloc[j,r])
//   s1[j]    = Σ_r w[r] * (alloc-requested)*100 // alloc   (LeastAllocated)
//   s2[j]    = Σ_r w[r] * (alloc-estimated)*100 // alloc   (LoadAware,
//              0 unless the node's metric is fresh)
//   mask[j]  = fit & (daemonset | !fresh | la_ok) & quota_admit(p)
//   key[j]   = mask ? (s1//wsum + s2//wsum) << 16 | (65535 - j) : -1
// then the max key names the top score at the smallest node index, and
// the winner's request, estimate and (for prod pods) prod estimate are
// added into its row. The quota gate checks used+req <= runtime (and
// np_used+req <= min for non-preemptible pods) on the pod's requested
// dims; a placed pod is added to its group's carries.
//
// Design. The TPU ran the pods as a sequential grid over one core with
// the node carry in VMEM. Here one thread block of 1024 threads walks
// the pods in order (the loop replaces the sequential grid). Thread t
// owns node rows t, t+1024, ...: it is the only thread that ever reads
// or writes the carries (used/est/prod) of those rows, so no atomics
// and no barrier are needed around the row update. The [N,8] int32
// rows are 32 contiguous bytes, read as two 16-byte loads. Threads
// 0..7 own the 8 resource columns of the [Q,8] quota carries the same
// way. Per pod: warp 0 evaluates the quota gate (barrier A), every
// thread scores its rows and reduces its packed keys with warp
// shuffles into shared memory (barrier B), warp 0 reduces the 32 warp
// maxima (barrier C), and the owner of the winning row updates it.
//
// Integer semantics are the reference's int32: sums and products wrap
// (done in unsigned arithmetic, where wrapping is defined), divisions
// floor. The reference divided through a float reciprocal because int32
// division is slow on a TPU; here the dividend is clamped at 0 first,
// as floor_div_exact does, so C's truncating '/' equals floor.
//
// Bound on this card: per pod the kernel reads four [N,8] int32 arrays
// (alloc, usage, used, est): 0.64 MB at 5k nodes, 6.4 GB over 10k pods,
// about 2 ms at 3.35 TB/s if it streamed from device memory at the full
// rate. The carries fit in the 50 MB L2, but one block runs on one SM
// and gets only that SM's share of L2 bandwidth, plus three block-wide
// barriers per pod, so expect the kernel far above that bound. The next
// step (a later change) splits the node axis over a thread-block
// cluster, keeps the carries in distributed shared memory, and merges
// the per-CTA packed keys across the cluster.

#include <cuda_runtime.h>

namespace {

constexpr int R = 8;             // resource columns
constexpr int THREADS = 1024;    // one block
constexpr int WARPS = THREADS / 32;
constexpr int FLAGS = 4;         // daemonset (unblocked), prod, quota id, non-preemptible
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// floor(x / d) for any d != 0 (C '/' truncates toward zero)
__device__ __forceinline__ int floor_div(int x, int d) {
  const int q = x / d;
  const int r = x % d;
  return (r != 0 && ((r < 0) != (d < 0))) ? q - 1 : q;
}

// the LeastAllocated-style per-resource term: (alloc - v)*100 // alloc,
// 0 when alloc == 0 or v > alloc
__device__ __forceinline__ int least_term(int a, int v) {
  if (a == 0 || v > a) return 0;
  const int y = max(wmul(wsub(a, v), 100), 0);
  return y / max(a, 1);
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

__global__ void __launch_bounds__(THREADS, 1) binpack_kernel(
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
    int* __restrict__ assign, int* __restrict__ used, int* __restrict__ estx,
    int* __restrict__ prod, int* __restrict__ qused, int* __restrict__ qnp) {
  __shared__ int s_admit;
  __shared__ int s_warp_best[WARPS];
  __shared__ int s_best;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // initial carries: each thread copies the rows (and quota column) it owns
  for (int j = tid; j < N; j += THREADS) {
    int v[R];
    load_row(used0, j, v); store_row(used, j, v);
    load_row(est0, j, v); store_row(estx, j, v);
    load_row(prod0, j, v); store_row(prod, j, v);
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
      for (int j = tid; j < N; j += THREADS) {
        if (!sched[j]) continue;
        const int fr = fresh[j];
        if (!(is_ds || !fr || la_ok[j])) continue;
        int a[R], u[R];
        load_row(alloc, j, a);
        load_row(used, j, u);
        bool fit = true;
        int s1 = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int requested = wadd(u[r], rq[r]);
          if (rq[r] != 0 && requested > a[r]) fit = false;
          s1 = wadd(s1, wmul(least_term(a[r], requested), w[r]));
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
            s2 = wadd(s2, wmul(least_term(a[r], eu), w[r]));
          }
          s2 = floor_div(s2, wsum);
        }
        const int score = wadd(floor_div(s1, wsum), s2);
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
      int k = s_warp_best[lane];
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
      if (node % THREADS == tid) {   // the owner updates the winning row
        int v[R];
        load_row(used, node, v);
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = wadd(v[r], rq[r]);
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
      }
      if (quota_on && tid < R) {     // thread r owns quota column r
        const int rr = req[p * R + tid];
        const int at = qid * R + tid;
        if (rr > 0) {
          qused[at] = wadd(qused[at], rr);
          if (non_pre) qnp[at] = wadd(qnp[at], rr);
        }
      }
    }
    if (tid == 0) assign[p] = node;
  }
}

}  // namespace

extern "C" int binpack_launch(
    const int* req, const int* est, const int* flags, int P,
    const int* alloc, const int* usage, const int* sched, const int* fresh,
    const int* la_ok, int N, const int* weight, int wsum,
    const int* used0, const int* est0, const int* prod0,
    const int* qmin, const int* qrt, const int* qused0, const int* qnp0, int Q,
    int* assign, int* used, int* estx, int* prod, int* qused, int* qnp,
    void* stream) {
  binpack_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      req, est, flags, P, alloc, usage, sched, fresh, la_ok, N, weight, wsum,
      used0, est0, prod0, qmin, qrt, qused0, qnp0, Q, assign, used, estx,
      prod, qused, qnp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* binpack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
