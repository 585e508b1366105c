// Node-sharded placement kernel for Hopper (sm_90a): the batched greedy
// bin-pack over the k CTAs of one thread-block cluster.
//
// Replaces koordinator_tpu/ops/pallas_binpack.py::_make_kernel with
// n_shards > 1 (the distributed variant that
// koordinator_tpu/parallel/mesh.py::shard_kernel_solver launches on every
// chip of a mesh), with all its variants (plain, use_quota, use_resv,
// use_numa least and most). Bit-identical to the single-block kernel in
// binpack.cu and to the plain twin
// koordinator_tpu_torch/ops/binpack_kernel.py::binpack_sharded_plain.
// The per-pod computation is binpack.cu's; what differs is who owns what
// and how the winner is agreed.
//
// Ownership. The node axis is cut into k equal ranges of n_loc rows
// (n_loc = shard_tile_bucket(N, k) / k, the reference's layout). CTA s
// (its rank in the cluster) owns global rows [s*n_loc, (s+1)*n_loc) and
// thread t of it rows s*n_loc + t, + NT, ...: as in binpack.cu, each
// row's carries (used/est/prod/numa_free) and the free rows of the
// node's reservations (the node -> reservation CSR) have exactly one
// writer, so the reservation table needs no replication: the TPU
// replicated it only because its credit was a matmul over the whole
// table. Every CTA keeps its own copy of the [Q,8] quota carries
// (qused/qnp point at [k,Q,8]; CTA s uses slice s) and replays the same
// admits and adds, as every TPU shard does, so the gate needs no
// exchange; slice 0 is the output.
//
// Per pod: (A) warp 0 runs the quota gate on this CTA's copy; (B) every
// thread scores its rows and the block reduces the packed keys (global
// node index in the low 16 bits, so ties still go to the smallest
// node); (C) thread 0 writes the CTA's best into the shared slot
// s_out[p & 1]; (D) one cluster barrier (release/acquire); (E) warp 0
// reads the k slots through distributed shared memory and takes their
// max: every CTA arrives at the same winner. The owner of the winning
// row (in the CTA whose range holds it) updates its carries, consumes
// the reservation, takes NUMA capacity and writes the pod's vstar /
// delta / rem / consumed; CTA 0's thread 0 writes assign[p] and the
// outputs of a pod that was not placed. Distributed shared memory takes
// the place of the TPU's remote DMAs and the cluster barrier that of
// its ack semaphore.
//
// Bound on this card: the same work as binpack.cu, so the same bound
// (bytes of the inputs and outputs once, or the operations on them).
// The carries stay in global memory (L2) as in binpack.cu; what the
// cluster buys is fewer rows per thread (one at k >= 5 for 5,000 nodes)
// at the price of one cluster barrier and k DSMEM loads per pod.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "binpack_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;          // threads of each CTA
constexpr int PORTABLE_CLUSTER = 8;

template <bool RESV, bool NUMA, bool MOST>
__global__ void __launch_bounds__(NT, 1) binpack_cluster_kernel(
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
    int* __restrict__ rfree, int n_loc) {
  constexpr int WARPS = NT / 32;
  __shared__ int s_admit;
  __shared__ int s_warp_best[WARPS];
  __shared__ int s_out[2];
  __shared__ int s_best;
  cg::cluster_group cluster = cg::this_cluster();
  const int shard = static_cast<int>(cluster.block_rank());
  const int k = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = shard * n_loc;            // my rows: [lo, hi)
  const int hi = min(lo + n_loc, N);
  int* const my_qused = qused + static_cast<size_t>(shard) * Q * R;
  int* const my_qnp = qnp + static_cast<size_t>(shard) * Q * R;

  // initial carries: each thread copies the rows it owns and the free
  // rows of its nodes' reservations; each CTA its own quota copy
  for (int j = lo + tid; j < hi; j += NT) {
    int v[R];
    load_row(used0, j, v); store_row(used, j, v);
    load_row(est0, j, v); store_row(estx, j, v);
    load_row(prod0, j, v); store_row(prod, j, v);
    if (NUMA) { load_row(nfree0, j, v); store_row(nfree, j, v); }
    if (RESV) {
      for (int c = roff[j]; c < roff[j + 1]; ++c) {
        const int rv = rids[c];
        load_row(rfree0, rv, v); store_row(rfree, rv, v);
      }
    }
  }
  if (tid < R) {
    for (int q = 0; q < Q; ++q) {
      my_qused[q * R + tid] = qused0[q * R + tid];
      my_qnp[q * R + tid] = qnp0[q * R + tid];
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

    // (A) the quota gate on my copy: lane r of warp 0 checks resource r
    if (warp == 0) {
      int viol = 0;
      if (quota_on && lane < R) {
        const int rr = req[p * R + lane];
        const int at = qid * R + lane;
        if (rr > 0) {
          viol = wadd(my_qused[at], rr) > qrt[at] ||
                 (non_pre && wadd(my_qnp[at], rr) > qmin[at]);
        }
      }
      const int any = __any_sync(FULL, viol);
      if (lane == 0) s_admit = !any;
    }
    __syncthreads();

    // (B) score my rows, keep the max packed key (global node index)
    int best = -1;
    if (s_admit) {
      for (int j = lo + tid; j < hi; j += NT) {
        if (!sched[j]) continue;
        const int fr = fresh[j];
        if (!(is_ds || !fr || la_ok[j])) continue;
        int al[R], u[R];
        load_row(alloc, j, al);
        load_row(used, j, u);
        if (RESV) {   // matched reservations' free credited back
          for (int c = roff[j]; c < roff[j + 1]; ++c) {
            const int rv = rids[c];
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
          int cp[R], nf[R];
          load_row(ncap, j, cp);
          load_row(nfree, j, nf);
          int psum = 0, cnt = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (rq[r] <= 0) continue;
            ++cnt;
            const int nreq = wadd(wsub(cp[r], nf[r]), rq[r]);
            if (cp[r] > 0 && nreq <= cp[r]) {
              const int numer = MOST ? nreq : wsub(cp[r], nreq);
              psum = wadd(psum, floor_div(wmul(numer, 100), cp[r]));
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

    // (C) the CTA's best into this pod's slot
    if (warp == 0) {
      int b = s_warp_best[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        b = max(b, __shfl_xor_sync(FULL, b, off));
      }
      if (lane == 0) s_out[p & 1] = b;
    }
    // (D) one cluster barrier per pod. Why two slots are enough: a CTA
    // writes slot p & 1 again only at pod p + 2, after it has passed
    // pod p + 1's barrier, which needs every CTA to arrive there; and
    // each CTA arrives there only after its warp 0 has read pod p's
    // slots in (E) (the block barrier after (E) orders it before the
    // rest of the CTA). So no slot is overwritten while a peer may still
    // read it. Arrive is a release and wait an acquire, so the slot
    // written before the barrier is what the peers read after it.
    cluster.sync();

    // (E) the max over the cluster's slots (distributed shared memory)
    if (warp == 0) {
      int b = -1;
      if (lane < k) b = *cluster.map_shared_rank(&s_out[p & 1], lane);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        b = max(b, __shfl_xor_sync(FULL, b, off));
      }
      if (lane == 0) s_best = b;
    }
    __syncthreads();

    const int m = s_best;
    const int node = m >= 0 ? 65535 - (m & 65535) : -1;
    if (node >= 0) {
      if (node >= lo && node < hi && (node - lo) % NT == tid) {
        // the owner updates the winning row
        int v[R];
        int net[R];
#pragma unroll
        for (int r = 0; r < R; ++r) net[r] = rq[r];
        if (RESV) {
          // the most-free matched reservation on this node: ids ascend
          // within the node, so a strict '>' keeps the smallest id
          int bf = 0, vs = -1;
          for (int c = roff[node]; c < roff[node + 1]; ++c) {
            const int rv = rids[c];
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
      if (quota_on && tid < R) {     // every CTA replays the add
        const int rr = req[p * R + tid];
        const int at = qid * R + tid;
        if (rr > 0) {
          my_qused[at] = wadd(my_qused[at], rr);
          if (non_pre) my_qnp[at] = wadd(my_qnp[at], rr);
        }
      }
    } else if (shard == 0 && tid == 0) {   // not placed
      if (RESV) {
        const int z[R] = {0, 0, 0, 0, 0, 0, 0, 0};
        vstar[p] = -1;
        store_row(delta, p, z);
        store_row(rem, p, z);
      }
      if (NUMA) consumed[p] = 0;
    }
    if (shard == 0 && tid == 0) assign[p] = node;
  }
  // no CTA exits (and frees its shared memory) while a peer may still
  // read its last slot
  cluster.sync();
}

cudaLaunchConfig_t cluster_config(int shards, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shards, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = shards;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters above the portable size need the kernel's opt-in
template <typename... Params>
cudaError_t allow_cluster(void (*kern)(Params...), int shards) {
  if (shards <= PORTABLE_CLUSTER) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kern)(Params...), int shards,
                           cudaStream_t s, Args... args) {
  const cudaError_t e = allow_cluster(kern, shards);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(shards, s, &attr);
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename... Params>
cudaError_t cluster_occupancy(void (*kern)(Params...), int shards,
                              int* clusters) {
  const cudaError_t e = allow_cluster(kern, shards);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(shards, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

// calls f with the kernel instance of a variant
template <typename F>
cudaError_t with_instance(int resv, int numa, int most, F&& f) {
  if (!numa) {
    return resv ? f(binpack_cluster_kernel<true, false, false>)
                : f(binpack_cluster_kernel<false, false, false>);
  }
  if (most) {
    return resv ? f(binpack_cluster_kernel<true, true, true>)
                : f(binpack_cluster_kernel<false, true, true>);
  }
  return resv ? f(binpack_cluster_kernel<true, true, false>)
              : f(binpack_cluster_kernel<false, true, false>);
}

}  // namespace

// qused/qnp are [shards, Q, 8]: one copy per CTA, slice 0 the result
extern "C" int binpack_cluster_launch(
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
    int shards, int n_loc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = with_instance(V > 0, numa, most, [&](auto kern) {
    return launch_cluster(
        kern, shards, s, req, est, flags, P, alloc, usage, sched, fresh,
        la_ok, N, weight, wsum, used0, est0, prod0, qmin, qrt, qused0, qnp0,
        Q, ncap, nfree0, npol, pod_numa, rfree0, aonce, roff, rids, match, V,
        assign, used, estx, prod, qused, qnp, nfree, consumed, vstar, delta,
        rem, rfree, n_loc);
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// how many clusters of `shards` CTAs of a variant can be resident at once
extern "C" int binpack_cluster_occupancy(int shards, int resv, int numa,
                                         int most, int* clusters) {
  return static_cast<int>(with_instance(resv, numa, most, [&](auto kern) {
    return cluster_occupancy(kern, shards, clusters);
  }));
}
