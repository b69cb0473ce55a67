// One serving slot's arrival lanes, routed in order, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel serve_route_pallas
// (repro/kernels/jsaq_route.py, body _serve_kernel).  Per run (one row of
// the (D, R) state): each lane a < A is live when act && a < n_arr; it goes
// to the lowest-index argmin of the f32 score (approx, or float(q_len +
// busy) under comm "exact"), is admitted when that replica's pending ring
// holds fewer than cap requests, and takes the ring slot
// tail = (q_head[j] + q_len[j]) % cap.  An admitted lane bumps q_len[j] by
// one and approx[j] by the same IEEE +1.0f the reference adds, so the next
// lane sees it.  jv and tail are written for every lane, dead lanes
// included, as the reference writes them.
//
// What bounds it on this card: the lanes form a dependent chain (each
// argmin reads the state the previous lane bumped), so a launch is a
// sequence of A block-wide reductions of R values, each followed by a
// one-thread update and a barrier.  Its time is latency (about three
// barriers per lane), far above both its operations bound (2 R operations
// per lane) and its bytes bound (the (D, R) state and the (D, A) lanes,
// read or written once).
//
// Design: one thread block per run; the run's four (R,) arrays (score,
// q_len, approx, q_head) live in shared memory (16 B per replica, 16 KB
// at R = 1024), so no lane touches device memory except to store its
// result.  Per live lane: a block argmin (block_argmin.cuh), then thread 0
// applies the admit and bump and a barrier publishes them.  Once the live
// lanes are done the state no longer changes, so one more argmin serves
// every dead lane.  R is bounded by kMaxReplicas (dynamic shared memory
// above 48 KB is opted into at launch).
#include <cuda_runtime.h>

#include "block_argmin.cuh"

constexpr int kMaxReplicas = 8192;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(1024)
serve_route_kernel(const int* q_len_in, const int* q_head_in, const int* busy_in,
                   const float* approx_in, const int* n_arr, const bool* act,
                   int* jv, int* tail, bool* admit, int* q_len_out,
                   float* approx_out, int* drops_out, int a_n, int r, int cap,
                   int exact) {
  extern __shared__ float smem[];
  float* score = smem;
  float* approx = smem + r;
  int* q_len = reinterpret_cast<int*>(smem + 2 * r);
  int* q_head = q_len + r;
  __shared__ MinPair<float> amin[33];

  const long long run = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int* busy = busy_in + run * r;
  int* jv_row = jv + run * a_n;
  int* tail_row = tail + run * a_n;
  bool* admit_row = admit + run * a_n;

  for (int s = tid; s < r; s += nthr) {
    const int qv = q_len_in[run * r + s];
    const float av = approx_in[run * r + s];
    q_len[s] = qv;
    approx[s] = av;
    q_head[s] = q_head_in[run * r + s];
    score[s] = exact ? static_cast<float>(qv + busy[s]) : av;
  }
  const int n_live = act[run] ? min(max(n_arr[run], 0), a_n) : 0;
  int drops = 0;  // meaningful in thread 0 only
  __syncthreads();

  for (int a = 0; a < n_live; ++a) {
    const int j = block_argmin(score, r, amin).y;
    if (tid == 0) {
      const int len_j = q_len[j];
      const bool ok = len_j < cap;
      jv_row[a] = j;
      tail_row[a] = (q_head[j] + len_j) % cap;
      admit_row[a] = ok;
      if (ok) {
        q_len[j] = len_j + 1;
        const float bumped = approx[j] + 1.0f;
        approx[j] = bumped;
        score[j] = exact ? static_cast<float>(len_j + 1 + busy[j]) : bumped;
      } else {
        drops += 1;
      }
    }
    // Publishes the bump before the next lane's scan, and orders this
    // lane's read of amin[32] before the next lane's writes to amin.
    __syncthreads();
  }

  if (n_live < a_n) {
    const int j = block_argmin(score, r, amin).y;
    const int t = (q_head[j] + q_len[j]) % cap;
    for (int a = n_live + tid; a < a_n; a += nthr) {
      jv_row[a] = j;
      tail_row[a] = t;
      admit_row[a] = false;
    }
  }
  for (int s = tid; s < r; s += nthr) {
    q_len_out[run * r + s] = q_len[s];
    approx_out[run * r + s] = approx[s];
  }
  if (tid == 0) drops_out[run] = drops;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when r is outside [1, kMaxReplicas].
extern "C" int serve_route_launch(const int* q_len_in, const int* q_head_in,
                                  const int* busy_in, const float* approx_in,
                                  const int* n_arr, const bool* act, int* jv,
                                  int* tail, bool* admit, int* q_len_out,
                                  float* approx_out, int* drops_out, int d,
                                  int a_n, int r, int cap, int exact, int threads,
                                  cudaStream_t stream) {
  if (r < 1 || r > kMaxReplicas) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * r * static_cast<int>(sizeof(float));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        serve_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (d > 0) {
    serve_route_kernel<<<d, threads, smem, stream>>>(
        q_len_in, q_head_in, busy_in, approx_in, n_arr, act, jv, tail, admit,
        q_len_out, approx_out, drops_out, a_n, r, cap, exact);
  }
  return static_cast<int>(cudaGetLastError());
}
