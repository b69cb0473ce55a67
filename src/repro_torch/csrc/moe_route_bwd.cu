// The backward of the MoE router's combine weights for Hopper (sm_90a): the
// gradient of the (T, k) weights that csrc/moe_route.cu returns with respect
// to the (T, E) float32 logits.
//
// Replaces no TPU kernel: the Pallas kernel moe_route_pallas
// (repro/kernels/moe_route.py:89) has no VJP, and the JAX package trains
// through its plain router.  The port's training path runs the forward
// kernel, so its gradient needs a kernel of its own.  It differentiates what
// ref.moe_route_ref computes: gates g = softmax(logits) or sigmoid(logits);
// for the chosen experts idx_j (the selection bias reaches only the argmax
// and takes no gradient) r_j = g[idx_j], Z = sum_j r_j + 1e-20, w_j = r_j / Z.
// For the upstream gradient gw:
//   dr_j = (gw_j - sum_m gw_m w_m) / Z,   dg_e = sum_{j: idx_j = e} dr_j,
//   softmax: dlogit_e = g_e (dg_e - sum_e' g_e' dg_e')   (every expert),
//   sigmoid: dlogit_e = dg_e g_e (1 - g_e)               (chosen ones only).
//
// What bounds it on this card: the bytes.  At DeepSeek-V2's prefill shape
// (T = 2048, E = 160, k = 6) it reads 1.4 MB and writes 1.3 MB, ~0.8 us at
// 3.35 TB/s, against ~2 us for any launch; it does ~3e6 operations.
//
// Design: one warp a token, 8 warps a block.  Lane l holds experts l + 32 i
// (i < 8, E <= 256) in registers; the row max and sums are warp shuffles.
// The gates, the slots' experts and dr go through the warp's shared memory;
// each lane sums dg for its own experts over the k slots in slot order, so a
// token that names an expert twice sums its slots, with no atomics.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxExperts = 256;
constexpr int kPerLane = kMaxExperts / 32;
constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__global__ void __launch_bounds__(32 * kWarps)
    moe_route_bwd_kernel(const float* __restrict__ logits, const int* __restrict__ idx,
                         const float* __restrict__ grad_w, float* __restrict__ dlogits, int t,
                         int e, int k, int softmax) {
  __shared__ float gate_s[kWarps][kMaxExperts];
  __shared__ float dr_s[kWarps][kMaxExperts];
  __shared__ int idx_s[kWarps][kMaxExperts];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long tok = (long long)blockIdx.x * kWarps + warp;
  if (tok >= t) return;  // a whole warp leaves together
  const float* row = logits + tok * e;

  float g[kPerLane];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int ex = lane + 32 * i;
    g[i] = ex < e ? row[ex] : -INFINITY;
    m = fmaxf(m, g[i]);
  }
  if (softmax) {
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      g[i] = lane + 32 * i < e ? expf(g[i] - m) : 0.f;
      sum += g[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) g[i] /= sum;
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) g[i] = lane + 32 * i < e ? 1.f / (1.f + expf(-g[i])) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    if (lane + 32 * i < e) gate_s[warp][lane + 32 * i] = g[i];
  }
  for (int j = lane; j < k; j += 32) idx_s[warp][j] = idx[tok * k + j];
  __syncwarp();

  // Z = sum_j r_j + 1e-20 in slot order, and sum_j gw_j r_j.
  float z = 0.f, a = 0.f;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    float r = 0.f, gw = 0.f;
    if (j < k) {
      r = gate_s[warp][idx_s[warp][j]];
      gw = grad_w[tok * k + j];
    }
    z += warp_sum(r);
    a += warp_sum(gw * r);
  }
  z += 1e-20f;
  const float gw_dot_w = a / z;
  for (int j = lane; j < k; j += 32) {
    dr_s[warp][j] = (grad_w[tok * k + j] - gw_dot_w) / z;
  }
  __syncwarp();

  float dg[kPerLane];
  float c = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int ex = lane + 32 * i;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      if (idx_s[warp][j] == ex) acc += dr_s[warp][j];
    }
    dg[i] = acc;
    c += g[i] * acc;
  }
  float* out = dlogits + tok * e;
  if (softmax) {
    c = warp_sum(c);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int ex = lane + 32 * i;
      if (ex < e) out[ex] = g[i] * (dg[i] - c);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int ex = lane + 32 * i;
      if (ex < e) out[ex] = dg[i] * g[i] * (1.f - g[i]);
    }
  }
}

}  // namespace

// Launches on `stream`.  logits, dlogits: (T, E) float32; idx: (T, k) int32
// experts in [0, E); grad_w: (T, k) float32; all contiguous.  `softmax` picks
// the gate (1 softmax, 0 sigmoid).  Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for T < 1, E outside [1, 256] or k
// outside [1, E].
extern "C" int moe_route_bwd_launch(const void* logits, const void* idx, const void* grad_w,
                                    void* dlogits, int t, int e, int k, int softmax,
                                    cudaStream_t stream) {
  if (t < 1 || e < 1 || e > kMaxExperts || k < 1 || k > e) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)((t + kWarps - 1) / kWarps);
  moe_route_bwd_kernel<<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const float*>(logits), static_cast<const int*>(idx),
      static_cast<const float*>(grad_w), static_cast<float*>(dlogits), t, e, k, softmax);
  return static_cast<int>(cudaGetLastError());
}
