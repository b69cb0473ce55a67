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
//   softmax: dlogit_e = g_e (dg_e - c),  c = sum_e g_e dg_e = sum_j r_j dr_j,
//   sigmoid: dlogit_e = dg_e g_e (1 - g_e)   (chosen ones; every other 0).
// S = sum_j r_j and A = sum_j gw_j r_j are sums over the k slots, and
// Z = S + 1e-20, sum_m gw_m w_m = A / Z and c = (A - (A / Z) S) / Z follow
// from them; the row max and the softmax sum are the only reductions over E.
//
// What bounds it on this card: the bytes.  At DeepSeek-V2's prefill shape
// (T = 2048, E = 160, k = 6) it reads 1.4 MB and writes 1.3 MB, 0.81 us at
// 3.35 TB/s, against ~1.9 us for an empty launch; at 16,384 tokens 21.8 MB,
// 6.5 us.  So a token's whole input is requested at once, 16 bytes a lane,
// and what follows the one round trip is kept short.
//
// Design: L lanes a token (L = 8 from E = 33 up; fewer, a power of two, for
// fewer float4 chunks), 128 threads a block, 128 / L tokens.  Lane l owns the
// row's float4 chunks l + L v (v < V, V = ceil(E / 4L)): at E = 160 that is
// 8 lanes x 5 chunks, none masked.  Before any arithmetic a token's k
// experts and upstream gradients are copied to shared memory by cp.async and
// its logits row loaded into registers with 16-byte loads (4-byte loads when
// E is not a multiple of 4 or a row is not 16-byte aligned).  Entries past
// the row hold -inf, so every exp runs unconditionally (the compiler
// wraps a conditional exp in a branch of its own, and the row's exps then
// run one after another).  The row max and sums are butterfly shuffles
// over the token's L lanes.  While k <= L each lane holds one slot in
// registers and its gate is computed beside the row's exps, so the row sum
// and the two slot sums reduce together; more slots than lanes go through
// shared memory, j = l + L m.  dg is a scatter of the slots' dr_j into a
// zeroed shared row: the first slot naming an expert writes the sum of
// that expert's dr_j in slot order, so a token that names an expert twice
// sums its slots, with no atomics (two calls give the same bits).  The
// owners read their chunks back and write the gradient row with 16-byte
// stores.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxExperts = 256;
constexpr int kThreads = 128;
// Dynamic shared memory a launch may take without opting in.
constexpr int kSmemWithoutOptIn = 48 * 1024;

template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int L>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Experts 4c .. 4c + 3 of a row: one 16-byte access, or four 4-byte ones
// masked at E (-inf past it).
template <bool kVec>
__device__ __forceinline__ void load4(const float* row, int c, int e, float (&x)[4]) {
  if constexpr (kVec) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * c);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = 4 * c + q < e ? row[4 * c + q] : -INFINITY;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int c, int e, const float (&x)[4]) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(row + 4 * c) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (4 * c + q < e) row[4 * c + q] = x[q];
    }
  }
}

// 1 / x without IEEE division's slow path (a call that spills registers),
// within 2 ulp: the softmax row sum lies in [1, 256], Z above 1e-20, and a
// sigmoid's 1 + e^-x above 1 (past 2^126 it gives 0, the gate's limit).
__device__ __forceinline__ float recip(float x) { return __fdividef(1.f, x); }

__device__ __forceinline__ float sigmoid(float x) { return recip(1.f + expf(-x)); }

// Shared memory, per token: its logits row and its dg row (4 ceil(E / 4)
// floats each), then its k experts, k upstream gradients and k dr.
template <int L, int V, bool kVec>
__global__ void __launch_bounds__(kThreads)
    moe_route_bwd_kernel(const float* __restrict__ logits, const int* __restrict__ idx,
                         const float* __restrict__ grad_w, float* __restrict__ dlogits, int t,
                         int e, int k, int softmax) {
  constexpr int kTokens = kThreads / L;
  extern __shared__ float4 smem4[];
  const int chunks = (e + 3) / 4, row = 4 * chunks;
  const int local = threadIdx.x / L, sub = threadIdx.x % L;
  const long long tok0 = (long long)blockIdx.x * kTokens;
  if (tok0 + (threadIdx.x & ~31) / L >= t) return;  // a whole warp past T leaves together
  const long long tok = tok0 + local;
  const bool live = tok < t;  // the other lanes of a warp still shuffle
  float* smem = reinterpret_cast<float*>(smem4);
  float* x_s = smem + local * row;
  float* dg_s = smem + (kTokens + local) * row;
  int* idx_s = reinterpret_cast<int*>(smem + 2 * kTokens * row) + local * k;
  float* gw_s = smem + 2 * kTokens * row + kTokens * k + local * k;
  float* dr_s = smem + 2 * kTokens * row + 2 * kTokens * k + local * k;

  // Every input requested before any arithmetic.  Entries past the row
  // (and rows past T) hold -inf: they take no part in the max, and their
  // exp is 0, so no element needs a branch of its own.
  if (live) {
    for (int j = sub; j < k; j += L) {
      cp_async4(idx_s + j, idx + tok * k + j);
      cp_async4(gw_s + j, grad_w + tok * k + j);
    }
  }
  cp_async_commit();
  float x[V][4];
  const float* src = logits + tok * e;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = sub + L * v;
    if (live && c < chunks) {
      load4<kVec>(src, c, e, x[v]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) x[v][q] = -INFINITY;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = sub + L * v;
    if (c < chunks) {
      reinterpret_cast<float4*>(dg_s)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(x_s)[c] = make_float4(x[v][0], x[v][1], x[v][2], x[v][3]);
    }
  }

  cp_async_wait_all();
  __syncwarp();  // the token's logits, experts and gradients in shared memory

  // While k <= L a lane holds one slot in registers: its expert, gradient
  // and logit, and the mask of the slots that name the same expert.
  const bool few = k <= L;
  const bool has = few && live && sub < k;
  const int ex = has ? idx_s[sub] : 0;
  const float gw = has ? gw_s[sub] : 0.f;
  const float xe = x_s[ex];
  unsigned same = 0;
  if (few) {
    for (int i = 0; i < k; ++i) same |= static_cast<unsigned>(idx_s[i] == ex) << i;
  }

  // The row max; then, side by side, the row's exps and the slots' gates
  // p_j (softmax: exp(x - m), not yet over the row sum), and three sums: the
  // row sum (a partial sum for each component q, then (s0 + s1) + (s2 +
  // s3)), sum_j p_j and sum_j gw_j p_j.
  float m = 0.f, row_sum = 0.f;
  if (softmax) {
    float mq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mq[q] = x[0][q];
#pragma unroll
      for (int v = 1; v < V; ++v) mq[q] = fmaxf(mq[q], x[v][q]);
    }
    m = group_max<L>(fmaxf(fmaxf(mq[0], mq[1]), fmaxf(mq[2], mq[3])));
    float sq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sq[q] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        x[v][q] = expf(x[v][q] - m);
        sq[q] += x[v][q];
      }
    }
    row_sum = (sq[0] + sq[1]) + (sq[2] + sq[3]);
  }
  float p = 0.f, sum_p = 0.f, sum_gp = 0.f;
  const int first_slot = live && !few ? sub : k;  // more slots than lanes: j = sub + L m
  if (has) {
    p = softmax ? expf(xe - m) : sigmoid(xe);
    sum_p = p;
    sum_gp = gw * p;
  }
  for (int j = first_slot; j < k; j += L) {
    const float xj = x_s[idx_s[j]];
    const float pj = softmax ? expf(xj - m) : sigmoid(xj);
    sum_p += pj;
    sum_gp += gw_s[j] * pj;
  }
  row_sum = group_sum<L>(row_sum);
  sum_p = group_sum<L>(sum_p);
  sum_gp = group_sum<L>(sum_gp);
  const float scale = softmax ? recip(row_sum) : 1.f;
  if (softmax) {  // x becomes the gates
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int q = 0; q < 4; ++q) x[v][q] *= scale;
    }
  }

  // S = sum_j r_j and A = sum_j gw_j r_j; Z = S + 1e-20, sum_m gw_m w_m =
  // A / Z, and c = sum_j r_j dr_j = (A - (A / Z) S) / Z.  dg: the first
  // slot naming an expert writes its slots' dr, summed in slot order (for
  // the sigmoid, already times g (1 - g)).
  const float s_r = sum_p * scale, s_a = sum_gp * scale;
  const float inv_z = recip(s_r + 1e-20f);
  const float gw_dot_w = s_a * inv_z;
  const float c = (s_a - gw_dot_w * s_r) * inv_z;
  if (few) {
    const float dr = (gw - gw_dot_w) * inv_z;
    float s = 0.f + dr;
    if (__any_sync(0xffffffffu, has && same != 1u << sub)) {  // a repeated expert
      const int base = (threadIdx.x % 32) & ~(L - 1);
      s = 0.f;
      for (int i = 0; i < k; ++i) {
        const float other = __shfl_sync(0xffffffffu, dr, base + i);
        if (same >> i & 1u) s += other;
      }
    }
    if (has && (same & ((1u << sub) - 1u)) == 0u) dg_s[ex] = softmax ? s : s * p * (1.f - p);
  } else {
    for (int j = first_slot; j < k; j += L) dr_s[j] = (gw_s[j] - gw_dot_w) * inv_z;
    __syncwarp();
    for (int j = first_slot; j < k; j += L) {
      const int ej = idx_s[j];
      float s = 0.f;
      bool first = true;
      for (int i = 0; i < k; ++i) {
        if (idx_s[i] == ej) {
          s += dr_s[i];
          first = first && i >= j;
        }
      }
      if (first && softmax) {
        dg_s[ej] = s;
      } else if (first) {
        const float g = sigmoid(x_s[ej]);
        dg_s[ej] = s * g * (1.f - g);
      }
    }
  }
  __syncwarp();

  if (!live) return;
  float* dst = dlogits + tok * e;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int cc = sub + L * v;
    if (cc < chunks) {
      const float4 d = reinterpret_cast<const float4*>(dg_s)[cc];
      float out[4] = {d.x, d.y, d.z, d.w};
      if (softmax) {
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = x[v][q] * (out[q] - c);
      }
      store4<kVec>(dst, cc, e, out);
    }
  }
}

template <int L, int V, bool kVec>
int launch(const float* logits, const int* idx, const float* grad_w, float* dlogits, int t,
           int e, int k, int softmax, cudaStream_t stream) {
  constexpr int kTokens = kThreads / L;
  const size_t smem = sizeof(float) * kTokens * (2 * 4 * ((e + 3) / 4) + 3 * k);
  auto* kernel = moe_route_bwd_kernel<L, V, kVec>;
  if (smem > kSmemWithoutOptIn) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (unsigned)((t + kTokens - 1) / kTokens);
  kernel<<<blocks, kThreads, smem, stream>>>(logits, idx, grad_w, dlogits, t, e, k, softmax);
  return static_cast<int>(cudaGetLastError());
}

// Lanes a token and float4 chunks a lane for E experts (kernels/moe_route.
// moe_bwd_tiling mirrors it).
template <bool kVec>
int dispatch(const float* logits, const int* idx, const float* grad_w, float* dlogits, int t,
             int e, int k, int softmax, cudaStream_t stream) {
  const int chunks = (e + 3) / 4;
#define MOE_BWD_LAUNCH(L, V) \
  return launch<L, V, kVec>(logits, idx, grad_w, dlogits, t, e, k, softmax, stream)
  if (chunks <= 1) MOE_BWD_LAUNCH(1, 1);
  if (chunks <= 2) MOE_BWD_LAUNCH(2, 1);
  if (chunks <= 4) MOE_BWD_LAUNCH(4, 1);
  switch ((chunks + 7) / 8) {
    case 1: MOE_BWD_LAUNCH(8, 1);
    case 2: MOE_BWD_LAUNCH(8, 2);
    case 3: MOE_BWD_LAUNCH(8, 3);
    case 4: MOE_BWD_LAUNCH(8, 4);
    case 5: MOE_BWD_LAUNCH(8, 5);
    case 6: MOE_BWD_LAUNCH(8, 6);
    case 7: MOE_BWD_LAUNCH(8, 7);
    default: MOE_BWD_LAUNCH(8, 8);
  }
#undef MOE_BWD_LAUNCH
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
  const auto* x = static_cast<const float*>(logits);
  const auto* ids = static_cast<const int*>(idx);
  const auto* gw = static_cast<const float*>(grad_w);
  auto* out = static_cast<float*>(dlogits);
  const bool vec = e % 4 == 0 && (reinterpret_cast<uintptr_t>(logits) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(dlogits) % 16) == 0;
  return vec ? dispatch<true>(x, ids, gw, out, t, e, k, softmax, stream)
             : dispatch<false>(x, ids, gw, out, t, e, k, softmax, stream);
}
