// Block-wide argmin over one row of int32 values, lowest index on ties.
//
// Shared by jsaq_route.cu and care_route.cu.  Each thread scans a strided
// slice of the row in ascending order (strict < keeps its earliest minimum),
// then (value, index) pairs are merged by warp shuffles and once more across
// the warps through shared memory.  The merge prefers the smaller value and,
// among equal values, the smaller index, so the result is the lowest global
// index of the minimum: what torch.argmin and jnp.argmin return.
#pragma once

#include <climits>
#include <cuda_runtime.h>

__device__ __forceinline__ void argmin_merge(int& v, int& i, int v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmin(int& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    argmin_merge(v, i, v2, i2);
  }
}

// `row` is read with ordinary (coherent) loads: callers write the row inside
// the same kernel, so it must not be declared __restrict__ or read through
// the read-only cache.  blockDim.x must be a multiple of 32.  `scratch` holds
// 33 int2 in shared memory; slot 32 carries the result.  Contains two
// __syncthreads() and returns the result to every thread.
__device__ __forceinline__ int2 block_argmin(const int* row, int n, int2* scratch) {
  int v = INT_MAX;
  int i = INT_MAX;  // INT_MAX index: this thread saw no element
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int x = row[s];
    if (i == INT_MAX || x < v) {
      v = x;
      i = s;
    }
  }
  warp_argmin(v, i);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = make_int2(v, i);
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? scratch[lane].x : INT_MAX;
    i = lane < nwarps ? scratch[lane].y : INT_MAX;
    warp_argmin(v, i);
    if (lane == 0) scratch[32] = make_int2(v, i);
  }
  __syncthreads();
  return scratch[32];
}
