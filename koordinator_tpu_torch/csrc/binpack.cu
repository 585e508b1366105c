// Placement kernel for Hopper (sm_90a), one block: the batched greedy
// bin-pack for a solve whose node axis fits one CTA's shared memory.
//
// Replaces koordinator_tpu/ops/pallas_binpack.py::_make_kernel, all its
// single-chip variants (plain, use_quota, use_resv, use_numa least and
// most; launched by pl.pallas_call in _pallas_solve). Bit-identical to
// it and to the plain twin
// koordinator_tpu_torch/ops/binpack_kernel.py::binpack_plain.
//
// The TPU ran the pods as a sequential grid over one core with the node
// carry in VMEM. Here one block of 1,024 threads walks the pods in order
// with the whole node axis staged in its shared memory; the solve and
// its design notes are binpack_common.cuh's solve(). One block barrier
// per pod. ops/binpack_kernel.py::kernel_route sends a solve here when
// its slice fits; larger ones go to the cluster kernel
// (binpack_cluster.cu).
//
// Bound on this card: the inputs read once and the outputs written once
// (~1 MB at 5,000 nodes x 10,000 pods), or the ~180 integer operations
// of each (pod, node) pair at the card's scalar rate, whichever is
// larger; chip_smoke.py computes it per solve. One SM cannot approach
// it: the per-pod chain (score the slice, one barrier, the winner's
// update) is what this kernel is built to shorten.

#include <cuda_runtime.h>

#include "binpack_common.cuh"

namespace {

template <bool RESV, bool NUMA, bool MOST>
__global__ void __launch_bounds__(NT, 1)
    binpack_kernel(const __grid_constant__ Args a) {
  solve<false, true, RESV, NUMA, MOST>(a);
}

struct OneBlock {
  template <bool RESV, bool NUMA, bool MOST>
  static auto get() { return binpack_kernel<RESV, NUMA, MOST>; }
};

}  // namespace

// qshared: the quota tables in shared memory; smem: dynamic shared memory
// bytes (pod chunks, the quota tables when qshared, the slice)
extern "C" int binpack_launch(BINPACK_C_PARAMS, int qshared, int smem,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args args = BINPACK_ARGS_INIT(N, nullptr, qshared);
  const cudaError_t e = with_instance<OneBlock>(V > 0, numa, most, [&](auto kern) {
    const cudaError_t a = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (a != cudaSuccess) return a;
    kern<<<1, NT, smem, s>>>(args);
    return cudaGetLastError();
  });
  return static_cast<int>(e);
}

extern "C" const char* binpack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
