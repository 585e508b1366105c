// Node-sharded placement kernel for Hopper (sm_90a): the batched greedy
// bin-pack over the k CTAs of one thread-block cluster.
//
// Replaces koordinator_tpu/ops/pallas_binpack.py::_make_kernel with
// n_shards > 1 (the distributed variant that
// koordinator_tpu/parallel/mesh.py::shard_kernel_solver launches on every
// chip of a mesh), with all its variants (plain, use_quota, use_resv,
// use_numa least and most). Bit-identical to the one-block kernel in
// binpack.cu and to the plain twin
// koordinator_tpu_torch/ops/binpack_kernel.py::binpack_sharded_plain.
// The per-pod computation and the design notes are binpack_common.cuh's
// solve(); what differs is who owns what and how the winner is agreed.
//
// Ownership. The node axis is cut into k equal ranges of n_loc rows
// (n_loc = shard_tile_bucket(N, k) / k, the reference's layout). CTA s
// (its rank in the cluster) owns global rows [s*n_loc, (s+1)*n_loc) and
// stages them, with the reservations on them, in its shared memory
// (RESIDENT) or, past what 16 CTAs' shared memory holds, in its part of
// a device-memory workspace (the L2 form, the same code, tiles of 32
// rows stored field by field). Every CTA keeps its own copy of the
// [Q,8] quota carries (in shared memory, or in qused/qnp[s] when the
// tables do not fit there) and replays the same admits and adds, as
// every TPU shard does, so the gate needs no exchange; copy s ends in
// qused/qnp[s] ([k,Q,8]), copy 0 is the output.
//
// Per pod: every warp scores its rows and writes its best into a shared
// slot; one block barrier; warp 0 writes the CTA's best (or -1 when its
// quota gate rejects the pod) into s_out[p & 1]; one cluster barrier;
// every warp reads the k slots through distributed shared memory and
// takes their max, so every thread arrives at the same winner without a
// further barrier. Distributed shared memory takes the place of the
// TPU's remote DMAs and the cluster barrier that of its ack semaphore.
//
// Bound on this card: the same work as binpack.cu, so the same bound.
// What the cluster buys is k SMs on one solve, at the price of one
// cluster barrier and k DSMEM loads per pod.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "binpack_common.cuh"

namespace {

constexpr int PORTABLE_CLUSTER = 8;

template <bool RESIDENT, bool RESV, bool NUMA, bool MOST>
__global__ void __launch_bounds__(NT, 1)
    binpack_cluster_kernel(const __grid_constant__ Args a) {
  solve<true, RESIDENT, RESV, NUMA, MOST>(a);
}

template <bool RESIDENT>
struct Cluster {
  template <bool RESV, bool NUMA, bool MOST>
  static auto get() {
    return binpack_cluster_kernel<RESIDENT, RESV, NUMA, MOST>;
  }
};

cudaLaunchConfig_t cluster_config(int shards, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shards, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = shards;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel's opt-ins: its dynamic shared memory, and clusters above
// the portable size
template <typename Kernel>
cudaError_t allow(Kernel kern, int shards, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess || shards <= PORTABLE_CLUSTER) return e;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename F>
cudaError_t with_form(int resident, int resv, int numa, int most, F&& f) {
  return resident ? with_instance<Cluster<true>>(resv, numa, most, f)
                  : with_instance<Cluster<false>>(resv, numa, most, f);
}

}  // namespace

// qused/qnp are [shards, Q, 8]: one copy per CTA, slice 0 the result;
// resident = 0 runs the L2 form over `work` (shards slices); qshared = 0
// keeps each CTA's quota carries in its slice of qused/qnp
extern "C" int binpack_cluster_launch(BINPACK_C_PARAMS, int shards,
                                      int n_loc, int resident, int qshared,
                                      void* work, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args args =
      BINPACK_ARGS_INIT(n_loc, static_cast<char*>(work), qshared);
  const cudaError_t e = with_form(resident, V > 0, numa, most, [&](auto kern) {
    const cudaError_t a = allow(kern, shards, smem);
    if (a != cudaSuccess) return a;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(shards, smem, s, &attr);
    const cudaError_t l = cudaLaunchKernelEx(&cfg, kern, args);
    return l != cudaSuccess ? l : cudaGetLastError();
  });
  return static_cast<int>(e);
}

// how many clusters of `shards` CTAs of an instance, each with `smem`
// bytes of dynamic shared memory, can be resident at once
extern "C" int binpack_cluster_occupancy(int shards, int resident, int resv,
                                         int numa, int most, int smem,
                                         int* clusters) {
  return static_cast<int>(with_form(resident, resv, numa, most, [&](auto kern) {
    const cudaError_t e = allow(kern, shards, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(shards, smem, nullptr, &attr);
    return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  }));
}
