// Integer helpers shared by the placement kernels (binpack.cu, one block;
// binpack_cluster.cu, the CTAs of a thread-block cluster).
//
// Integer semantics are the reference's int32: sums and products wrap
// (done in unsigned arithmetic, where wrapping is defined), divisions
// floor. The reference divided through a float reciprocal because int32
// division is slow on a TPU; here the dividend is clamped at 0 first,
// as floor_div_exact does, so C's truncating '/' equals floor.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int R = 8;             // resource columns
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

}  // namespace
