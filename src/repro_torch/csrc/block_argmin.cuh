// Block-wide argmin over one row of values, lowest index on ties.
//
// Used by jsaq_route.cu (int rows).  Each thread scans a strided slice of
// the row in ascending order (strict < keeps its earliest minimum), then
// (value, index) pairs are merged by warp shuffles and once more across the
// warps through shared memory.  The merge prefers the smaller value and, among equal values, the
// smaller index, so the result is the lowest global index of the minimum:
// what torch.argmin and jnp.argmin return.  Rows hold no NaN.
#pragma once

#include <climits>
#include <cuda_runtime.h>

// A (value, index) pair; MinPair<int> has the layout of int2.
template <typename T>
struct MinPair {
  T x;
  int y;
};

// The value a thread that saw no element carries; it loses every merge
// against a real element, since its index is INT_MAX.
template <typename T>
__device__ __forceinline__ T argmin_sentinel();

template <>
__device__ __forceinline__ int argmin_sentinel<int>() {
  return INT_MAX;
}

template <typename T>
__device__ __forceinline__ void argmin_merge(T& v, int& i, T v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

template <typename T>
__device__ __forceinline__ void warp_argmin(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    argmin_merge(v, i, v2, i2);
  }
}

// `row` is read with ordinary (coherent) loads: callers write the row inside
// the same kernel, so it must not be declared __restrict__ or read through
// the read-only cache.  blockDim.x must be a multiple of 32.  `scratch` holds
// 33 pairs in shared memory; slot 32 carries the result.  Contains two
// __syncthreads() and returns the result to every thread.
template <typename T>
__device__ __forceinline__ MinPair<T> block_argmin(const T* row, int n,
                                                   MinPair<T>* scratch) {
  T v = argmin_sentinel<T>();
  int i = INT_MAX;  // INT_MAX index: this thread saw no element
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const T x = row[s];
    if (i == INT_MAX || x < v) {
      v = x;
      i = s;
    }
  }
  warp_argmin(v, i);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = MinPair<T>{v, i};
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? scratch[lane].x : argmin_sentinel<T>();
    i = lane < nwarps ? scratch[lane].y : INT_MAX;
    warp_argmin(v, i);
    if (lane == 0) scratch[32] = MinPair<T>{v, i};
  }
  __syncthreads();
  return scratch[32];
}
