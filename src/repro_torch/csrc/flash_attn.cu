// Tiled online-softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (repro/kernels/flash_attn.py:84, body _flash_kernel).  For each query row:
// s = (q . k) * scale in float32; if softcap > 0, s = softcap * tanh(s /
// softcap); with causal, keys after the row (kpos > qpos) and, with a window,
// keys with qpos - kpos >= window get -1e30; then the flash recurrence over
// key tiles: a running max m (from -1e30) and sum l in float32, p = exp(s -
// m_new) rounded to the value type before the PV product (l sums the
// unrounded p), a float32 accumulator rescaled by exp(m_old - m_new), and
// out = acc / max(l, 1e-30) in the input type.
//
// Layout: the JAX package's, read in place.  q (B, S, H, dh), k (B, T, KVH,
// dh), v (B, T, KVH, dv), out (B, S, H, dv), all contiguous; query head h
// reads KV head h / (H / KVH), so K and V are never repeated for GQA (the TPU
// wrapper broadcasts them).  Query rows and keys are masked by bound, so any
// S, T >= 1 runs without padding: a key past T scores -inf and adds nothing
// (m starts at -1e30, so exp(-inf - m) is 0, never NaN).
//
// What bounds it on this card: operations.  At Gemma2-9B's global layer (B =
// 2, S = T = 8064, H = 16, dh = dv = 256, causal) the useful work is 1.07e12
// FLOP, 1.08 ms on the bf16 tensor cores, against 0.40 GB of inputs and
// outputs (0.12 ms at 3.35 TB/s).  This first version does its products on
// the CUDA cores in float32 (67 TFLOP/s at most, 16 ms for that layer), the
// same arithmetic for float32 and bfloat16 inputs; tensor cores (mma / wgmma)
// and TMA are later work.
//
// Design: one block of 256 threads per (batch, head, 64 query rows).  The
// block stages its Q tile once and each 32-key K and V tile in shared memory
// as float32 (rows padded by 4 floats so the float4 reads of 16 neighbouring
// threads fall in distinct banks); at dh = dv = 256 that is 141 KB, the same
// for both input types, above the 48 KB default and so set with
// cudaFuncSetAttribute.  Thread (ty, tx) of a 16 x 16 grid owns query rows
// 4ty..4ty+3: it computes their scores against keys tx and tx + 16, keeps the
// rows' m and l in registers (a row's 16 threads share a half-warp, so the
// row max and sum are shuffles, no barrier), and accumulates value columns
// 64c + 4tx..+3 (c < 4) of those rows in 64 registers, so the (64, dv)
// accumulator never touches shared memory.  Key tiles wholly above the
// diagonal or wholly outside the window are skipped (every row keeps its own
// key); a block holding a row with no key at all (S > T with a window) runs
// every tile, as the dense softmax then averages all keys.  Blocks of the
// last query rows, which have the most tiles, are started first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 32;         // keys per tile
constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kMaxDim = 256;    // largest dh and dv
constexpr int kChunks = kMaxDim / 64;  // value-column chunks of 16 threads x 4
constexpr int kPad = 4;         // floats of padding per staged row
constexpr int kLdp = kBQ + kPad;  // row pitch of the transposed p tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, rows) of a (rows_total, stride)-strided source into a float tile
// of row pitch `ld`; rows past `valid` are zero.  One warp per row, lanes
// along the row, so each warp's reads are contiguous.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, long long row_stride,
                                      int rows, int valid, int width) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const T* s = src + r * row_stride;
    float* d = dst + r * ld;
    for (int c = lane; c < width; c += 32) d[c] = r < valid ? to_f(s[c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int b_n, int s_n, int t_n, int h_n, int kvh_n, int dh,
             int dv, float scale, float softcap, int causal, int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = dh + kPad, ldv = dv + kPad;
  float* qs = smem;                 // (kBQ, ldq)
  float* ks = qs + kBQ * ldq;       // (kBK, ldq)
  float* vs = ks + kBK * ldq;       // (kBK, ldv)
  float* ps = vs + kBK * ldv;       // (kBK, kLdp): p transposed

  const int n_qb = (s_n + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (b_n * h_n);
  const int qb = n_qb - 1 - blockIdx.x / (b_n * h_n);  // heaviest blocks first
  const int b = bh / h_n, h = bh % h_n;
  const int kvh = h / (h_n / kvh_n);
  const int row0 = qb * kBQ;
  const int row_last = min(row0 + kBQ, s_n) - 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // Key range this block may attend.  window == INT_MAX means none; a row
  // past t_n - 1 + window has no key, and then every tile runs.
  int k_lo = 0, k_hi = t_n;
  if (causal && (long long)row_last < (long long)t_n - 1 + window) {
    k_hi = min(t_n, row_last + 1);
    k_lo = max(0, (int)max(0LL, (long long)row0 - window + 1));
  }

  const long long q_stride = (long long)h_n * dh;
  const long long kv_stride = (long long)kvh_n * dh;
  const long long v_stride = (long long)kvh_n * dv;
  stage(qs, ldq, q + ((long long)b * s_n + row0) * q_stride + (long long)h * dh, q_stride,
        kBQ, s_n - row0, dh);

  float m[4], l[4], acc[kChunks][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][i][j] = 0.0f;
  }

  for (int k0 = k_lo / kBK * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    const long long key0 = (long long)b * t_n + k0;
    stage(ks, ldq, k + key0 * kv_stride + (long long)kvh * dh, kv_stride, kBK, t_n - k0, dh);
    stage(vs, ldv, v + key0 * v_stride + (long long)kvh * dv, v_stride, kBK, t_n - k0, dv);
    __syncthreads();

    // Scores of rows 4ty + i against keys tx + 16 j.
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
    for (int d = 0; d < dh; d += 4) {
      float4 qa[4], kb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * ldq + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ldq + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // Scale, softcap, mask; the online softmax of each row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = row0 + 4 * ty + i;
      float p[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (causal && (kpos > qpos || qpos - kpos >= window)) x = kNeg;
        p[j] = kpos < t_n ? x : -INFINITY;
      }
      const float m_new = fmaxf(m[i], half_warp_max(fmaxf(p[0], p[1])));
      const float alpha = expf(m[i] - m_new);
      p[0] = expf(p[0] - m_new);
      p[1] = expf(p[1] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(p[0] + p[1]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 2; ++j) ps[(tx + 16 * j) * kLdp + 4 * ty + i] = to_f(from_f<T>(p[j]));
    }
    __syncthreads();

    // acc += p (rounded to the value type) . V
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pk = *reinterpret_cast<const float4*>(ps + kk * kLdp + 4 * ty);
      const float pr[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 64 * c + 4 * tx;
        if (col < dv) {
          const float4 vk = *reinterpret_cast<const float4*>(vs + kk * ldv + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[c][i][0] = fmaf(pr[i], vk.x, acc[c][i][0]);
            acc[c][i][1] = fmaf(pr[i], vk.y, acc[c][i][1]);
            acc[c][i][2] = fmaf(pr[i], vk.z, acc[c][i][2]);
            acc[c][i][3] = fmaf(pr[i], vk.w, acc[c][i][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= s_n) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * s_n + row) * h_n + h) * dv;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 64 * c + 4 * tx;
      if (col < dv) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[col + j] = from_f<T>(acc[c][i][j] / denom);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s, int t, int h,
           int kvh, int dh, int dv, float scale, float softcap, int causal, int window,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * (dh + kPad) + (size_t)kBK * (dv + kPad) + kBK * kLdp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)((s + kBQ - 1) / kBQ) * b * h;
  flash_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), b, s, t, h, kvh, dh, dv, scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`.  `is_bf16` picks bfloat16 (1) or float32 (0) for all
// four tensors.  `window` <= 0 means no window.  Returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape the kernel does not
// take: any size below 1, dh or dv above 256 or not a multiple of 4, or H not
// a multiple of KVH.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 int is_bf16, int b, int s, int t, int h, int kvh, int dh,
                                 int dv, float scale, float softcap, int causal, int window,
                                 cudaStream_t stream) {
  if (b < 1 || s < 1 || t < 1 || h < 1 || kvh < 1 || h % kvh || dh < 4 || dv < 4 ||
      dh > kMaxDim || dv > kMaxDim || dh % 4 || dv % 4 ||
      (long long)((s + kBQ - 1) / kBQ) * b * h > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (window <= 0) window = INT_MAX;
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, out, b, s, t, h, kvh, dh, dv, scale, softcap,
                                 causal, window, stream);
  }
  return launch<float>(q, k, v, out, b, s, t, h, kvh, dh, dv, scale, softcap, causal, window,
                       stream);
}
