// CARE-biased top-k MoE routing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel moe_route_pallas
// (repro/kernels/moe_route.py:89, body _moe_route_kernel).  Per token (one
// row of the (T, E) logits): gates are softmax(logits) = exp(z - max) / sum
// or sigmoid(logits) = 1 / (1 + exp(-x)), in float32; the selection score
// is logits - bias; k sweeps each take the argmax of the score (the lowest
// index wins ties) and set it to -1e30; the weight of a chosen expert is
// its unbiased gate, and the k weights are divided by (their sum + 1e-20),
// summed in selection order.  counts[e] is the number of (token, sweep)
// pairs that chose e.
//
// What bounds it on this card: bytes.  Each logit is read once and each
// output written once: at the DeepSeek-V2 prefill shape (T = 2048, E = 160,
// k = 6, float32 logits) 1.41 MB, 0.42 us at 3.35 TB/s, against ~6e6
// operations (0.17 us at 33.5e12 lane operations a second).  Both are far
// below a launch's own latency (a few us), which is what a call costs.
//
// Design: one warp per token, so a row's reductions are warp shuffles and
// need no barrier.  E <= 256 means each lane holds at most 8 experts in
// registers (expert c * 32 + lane in slot c), loaded once; every loop over
// slots is unrolled so the arrays stay in registers.  The argmax merges
// (value, index) pairs and keeps the lower index on equal values, as the
// TPU's jnp.argmax does.  Tokens are masked by bound (no padding, T >= 1).
// Counts: the TPU accumulates them across its sequential grid into one
// block; here blocks run in no order, so each block keeps a shared-memory
// histogram and adds it to the zero-filled counts with integer atomicAdd.
// Integer sums commute, so the counts are exact and do not depend on the
// order of the blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxExperts = 256;
constexpr int kSlots = kMaxExperts / 32;
constexpr int kWarps = 8;  // tokens per block
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float load_logit(const void* logits, long long i,
                                            int is_bf16) {
  if (is_bf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(logits)[i]);
  return static_cast<const float*>(logits)[i];
}

__global__ void __launch_bounds__(kWarps * 32)
moe_route_kernel(const void* logits, int is_bf16, const float* bias, int* idx,
                 float* weights, int* counts, int t, int e, int k, int softmax) {
  __shared__ int hist[kMaxExperts];
  for (int s = threadIdx.x; s < e; s += blockDim.x) hist[s] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long tok = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (tok < t) {
    float gate[kSlots], score[kSlots];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int ex = c * 32 + lane;
      gate[c] = ex < e ? load_logit(logits, tok * e + ex, is_bf16) : -INFINITY;
      // Experts past E never win: every real score is above -inf.
      score[c] = ex < e ? gate[c] - bias[ex] : -INFINITY;
      m = fmaxf(m, gate[c]);
    }
    if (softmax) {
      m = warp_max(m);
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        gate[c] = c * 32 + lane < e ? expf(gate[c] - m) : 0.0f;
        s += gate[c];
      }
      s = warp_sum(s);
#pragma unroll
      for (int c = 0; c < kSlots; ++c) gate[c] = gate[c] / s;
    } else {
#pragma unroll
      for (int c = 0; c < kSlots; ++c) gate[c] = 1.0f / (1.0f + expf(-gate[c]));
    }

    int* idx_row = idx + tok * k;
    float* w_row = weights + tok * k;
    float w_sum = 0.0f;
    for (int i = 0; i < k; ++i) {
      // This lane's best (value, index), lowest index first among equals.
      float bv = score[0];
      int bi = lane;
#pragma unroll
      for (int c = 1; c < kSlots; ++c) {
        if (score[c] > bv) {
          bv = score[c];
          bi = c * 32 + lane;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      // Every lane now holds the same winner bi; its owner masks it and
      // hands its gate to the others.
      float w = 0.0f;
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        if (c * 32 + lane == bi) {
          w = gate[c];
          score[c] = kNeg;
        }
      }
      w = __shfl_sync(0xffffffffu, w, bi & 31);
      w_sum += w;
      if (lane == 0) {
        idx_row[i] = bi;
        w_row[i] = w;
        atomicAdd(&hist[bi], 1);
      }
    }
    const float denom = w_sum + 1e-20f;
    __syncwarp();
    for (int i = lane; i < k; i += 32) w_row[i] = w_row[i] / denom;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < e; s += blockDim.x) {
    if (hist[s]) atomicAdd(&counts[s], hist[s]);
  }
}

// Launches on `stream`; `counts` must be zero-filled.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when e is
// outside [1, kMaxExperts] or k outside [1, e].
extern "C" int moe_route_launch(const void* logits, int is_bf16, const float* bias,
                                int* idx, float* weights, int* counts, int t, int e,
                                int k, int softmax, cudaStream_t stream) {
  if (e < 1 || e > kMaxExperts || k < 1 || k > e) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t > 0) {
    const int blocks = (t + kWarps - 1) / kWarps;
    moe_route_kernel<<<blocks, kWarps * 32, 0, stream>>>(
        logits, is_bf16, bias, idx, weights, counts, t, e, k, softmax);
  }
  return static_cast<int>(cudaGetLastError());
}
