// Batched sequential JSAQ dispatch for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jsaq_route_pallas (repro/kernels/jsaq_route.py,
// body _jsaq_kernel, segmented argmin seg_argmin).  Per row of a (D, K) int32
// state: num_jobs times take the argmin (lowest index on ties) and add one
// job to the chosen server.
//
// What bounds it on this card: the chain of num_jobs argmins is sequential,
// and each is a block-wide reduction over K values followed by a dependent
// one-element update, so latency (two __syncthreads per round plus the
// scan) bounds it rather than bytes or operations: the row stays in L2 and
// is re-read every round.
//
// Design: one thread block per row (rows are independent and run on
// separate SMs); the servers are strided over the block's threads so the
// scan is coalesced; the row is copied to q_out once and updated in place;
// ties resolve to the lowest index by the (value, index) merge of
// block_argmin.cuh.  Nothing is padded: the scan is bounded by K.
#include <cuda_runtime.h>

#include "block_argmin.cuh"

__global__ void __launch_bounds__(1024)
jsaq_route_kernel(const int* q_in, int* idx, int* q_out, int k, int num_jobs) {
  __shared__ MinPair<int> scratch[33];
  const long long row = blockIdx.x;
  const int* qi = q_in + row * k;
  int* qo = q_out + row * k;
  int* ix = idx + row * num_jobs;
  for (int s = threadIdx.x; s < k; s += blockDim.x) qo[s] = qi[s];
  __syncthreads();
  for (int n = 0; n < num_jobs; ++n) {
    const MinPair<int> r = block_argmin(qo, k, scratch);
    if (threadIdx.x == 0) {
      ix[n] = r.y;
      qo[r.y] += 1;
    }
    __syncthreads();
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int jsaq_route_launch(const int* q_in, int* idx, int* q_out, int d,
                                 int k, int num_jobs, int threads,
                                 cudaStream_t stream) {
  if (d > 0 && k > 0) {
    jsaq_route_kernel<<<d, threads, 0, stream>>>(q_in, idx, q_out, k, num_jobs);
  }
  return static_cast<int>(cudaGetLastError());
}
