// The backward of flash attention for Hopper (sm_90a): dq, dk and dv of the
// online-softmax SDPA that csrc/flash_attn.cu computes forward.
//
// Replaces no TPU kernel: the Pallas kernel flash_attention_pallas
// (repro/kernels/flash_attn.py:84) has no VJP, and the JAX package trains
// through its plain attention.  The port's training path runs the forward
// kernel, so its gradient needs a kernel of its own.  It differentiates what
// ref.flash_attention_ref computes: s = (q . k) * scale in float32, then
// softcap * tanh(s / softcap) with a softcap, then with causal the fill
// -1e30 where kpos > qpos or qpos - kpos >= window; p = softmax(s);
// out = p v.  For dout:
//   dv_j = sum_i p_ij dout_i          (p rounded to bfloat16 first in bf16)
//   dp_ij = dout_i . v_j
//   ds_ij = p_ij (dp_ij - D_i) (1 - tanh^2),  D_i = dout_i . out_i
//   dq_i = scale sum_j ds_ij k_j,  dk_j = scale sum_i ds_ij q_i,
// summed over the query heads of a key head's GQA group.  A masked score
// gets no gradient (the fill blocks it); a row with no key at all (causal and
// row >= T - 1 + window) has the uniform softmax 1 / T of the fill, so its
// dout reaches every value row, and it adds nothing to dq or dk.
//
// What bounds it on this card: the operations.  At SmolLM-135M's training
// shape (B = 8, S = T = 2048, 9 heads over 3 KV heads of width 64, causal,
// bf16) the call does ~1.3e11 operations with the score recomputed twice and
// moves ~38 MB; on the tensor cores the bound is ~0.13 ms, on the CUDA cores
// (this kernel) ~2 ms at their float32 rate.  A wgmma design is later work.
//
// Design: two launches, no atomics, so the result is the same every run.
// - Kernel A, a block per (32-row query block, head, batch), 256 threads:
//   loop 1 over the key tiles the block's rows can see computes each row's
//   max and sum, so lse_i = m_i + log l_i (+inf for a row with no key);
//   D_i = dout_i . out_i; both go to a scratch for kernel B; loop 2 over
//   the same tiles recomputes s and p, dp and ds, and sums dq in registers.
// - Kernel B, a block per (32-key block, KV head, batch): K and V tiles stay
//   in shared memory, dk and dv in registers; it walks the query heads of
//   the group and the 32-row query tiles that can see its keys, recomputing
//   p from lse, then, under causal with a window, the rows with no key.
// Tiles are float32 in shared memory (bfloat16 widened as loaded), rows
// padded by 4 words; a thread owns row t / 8 and columns t % 8 + 8 j of a
// 32 x 32 score tile (float4 dot products), and for the sums it owns a row
// or key t / 8 and the float4 column groups 4 (t % 8) + 32 m of the width.
// Causal and window skip key tiles (A) and query tiles (B) as the forward
// does.  Widths: multiples of 4 up to 256 (float32), {64, 128, 256} (bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 32;      // query rows and keys a tile
constexpr int kThreads = 256;  // 8 threads a row of a tile
constexpr int kMaxDim = 256;
constexpr int kPad = 4;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// p as the reference multiplies it with v: cast to v's dtype.
__device__ __forceinline__ float as_elem(float x, const float*) { return x; }
__device__ __forceinline__ float as_elem(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [r0, r0 + 32) of a (rows, width) slice with `stride` elements between
// rows into a float tile of leading dimension width + kPad; rows at or past
// `rows` are zero.
template <typename E>
__device__ void load_tile(float* dst, const E* src, long long stride, int r0, int rows,
                          int width) {
  const int per_row = width / 4;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows) val = load4(src + (long long)(r0 + r) * stride + c);
    store4(dst + r * (width + kPad) + c, val);
  }
}

// acc[j] = a_row . b_{c_j}, c_j = t % 8 + 8 j, over `width` columns.
__device__ __forceinline__ void dot4(const float* a_row, const float* b, int ldb, int width,
                                     float acc[4]) {
  const int c0 = threadIdx.x % 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.f;
  for (int d = 0; d < width; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(a_row + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(b + (c0 + 8 * j) * ldb + d);
      acc[j] = fmaf(a.x, x.x, acc[j]);
      acc[j] = fmaf(a.y, x.y, acc[j]);
      acc[j] = fmaf(a.z, x.z, acc[j]);
      acc[j] = fmaf(a.w, x.w, acc[j]);
    }
  }
}

// acc[m] += sum_c w[c * ldw] * tile[c][4 (t % 8) + 32 m .. + 3] over the 32
// rows c of `tile` (float4 column groups below `width`).
template <int kV4>
__device__ __forceinline__ void accumulate(float4 acc[kV4], const float* w, int ldw,
                                           const float* tile, int width) {
  const int col0 = 4 * (threadIdx.x % 8);
  for (int c = 0; c < kTile; ++c) {
    const float x = w[c * ldw];
#pragma unroll
    for (int m = 0; m < kV4; ++m) {
      const int col = col0 + 32 * m;
      if (col < width) {
        const float4 y = *reinterpret_cast<const float4*>(tile + c * (width + kPad) + col);
        acc[m].x = fmaf(x, y.x, acc[m].x);
        acc[m].y = fmaf(x, y.y, acc[m].y);
        acc[m].z = fmaf(x, y.z, acc[m].z);
        acc[m].w = fmaf(x, y.w, acc[m].w);
      }
    }
  }
}

struct Shape {
  int b, s, t, h, kvh, dh, dv;
  float scale, softcap;
  int causal;
  long long window;  // LLONG_MAX-free: INT_MAX when there is none
};

__device__ __forceinline__ bool visible(const Shape& sh, int i, int j) {
  return j < sh.t && (!sh.causal || (j <= i && (long long)i - j < sh.window));
}

// The capped score and the softcap's derivative 1 - tanh^2.
__device__ __forceinline__ float score(const Shape& sh, float dot, float* deriv) {
  float s = dot * sh.scale;
  *deriv = 1.f;
  if (sh.softcap > 0.f) {
    const float th = tanhf(s / sh.softcap);
    s = sh.softcap * th;
    *deriv = 1.f - th * th;
  }
  return s;
}

size_t smem_bytes(int dh, int dv) {
  return sizeof(float) * (2 * (size_t)kTile * (dh + kPad) + 2 * (size_t)kTile * (dv + kPad) +
                          2 * kTile * (kTile + 1) + 2 * kTile);
}

// Kernel A: lse and D of a query block, then its dq.
template <typename E, int kV4>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    const E* __restrict__ out, const E* __restrict__ dout, E* __restrict__ dq,
    float* __restrict__ lse_g, float* __restrict__ d_g, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = sh.dh + kPad, ldv = sh.dv + kPad;
  float* qs = smem;
  float* dos = qs + kTile * ldk;
  float* ks = dos + kTile * ldv;
  float* vs = ks + kTile * ldk;
  float* ps = vs + kTile * ldv;  // ds, 32 x 33
  float* lse_s = ps + 2 * kTile * (kTile + 1);
  float* d_s = lse_s + kTile;

  const int qb = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (sh.h / sh.kvh);
  const int r0 = qb * kTile;
  const int rows = min(kTile, sh.s - r0);
  const int tid = threadIdx.x, r = tid / 8, c0 = tid % 8;
  const int i = r0 + r;  // this thread's query row

  const long long q_stride = (long long)sh.h * sh.dh, o_stride = (long long)sh.h * sh.dv;
  const long long k_stride = (long long)sh.kvh * sh.dh, v_stride = (long long)sh.kvh * sh.dv;
  const E* q_b = q + ((long long)bb * sh.s * sh.h + hh) * sh.dh;
  const E* o_b = out + ((long long)bb * sh.s * sh.h + hh) * sh.dv;
  const E* do_b = dout + ((long long)bb * sh.s * sh.h + hh) * sh.dv;
  const E* k_b = k + ((long long)bb * sh.t * sh.kvh + kh) * sh.dh;
  const E* v_b = v + ((long long)bb * sh.t * sh.kvh + kh) * sh.dv;

  load_tile(qs, q_b, q_stride, r0, sh.s, sh.dh);
  load_tile(dos, do_b, o_stride, r0, sh.s, sh.dv);

  // Key tiles the block's rows can see.
  int key_lo = 0, key_hi = sh.t;
  if (sh.causal) {
    const long long lo = (long long)r0 - sh.window + 1;
    key_lo = lo > 0 ? (int)lo : 0;
    key_hi = min(sh.t, r0 + rows);
  }
  const int tile_lo = (key_lo / kTile) * kTile;

  // D_i = dout_i . out_i (8 threads a row).
  {
    float part = 0.f;
    if (r < rows) {
      for (int col = 4 * c0; col < sh.dv; col += 32) {
        const float4 o = load4(o_b + (long long)i * o_stride + col);
        const float4 g = load4(do_b + (long long)i * o_stride + col);
        part += o.x * g.x + o.y * g.y + o.z * g.z + o.w * g.w;
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    if (c0 == 0) d_s[r] = part;
  }
  __syncthreads();

  // Loop 1: each row's max and sum over the keys it sees.
  float m_t = -INFINITY, l_t = 0.f;
  for (int k0 = tile_lo; k0 < key_hi; k0 += kTile) {
    load_tile(ks, k_b, k_stride, k0, sh.t, sh.dh);
    __syncthreads();
    float acc[4];
    dot4(qs + r * ldk, ks, ldk, sh.dh, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float deriv;
      const float s = score(sh, acc[j], &deriv);
      if (i < sh.s && visible(sh, i, k0 + c0 + 8 * j)) {
        if (s > m_t) {
          l_t = l_t * expf(m_t - s) + 1.f;
          m_t = s;
        } else {
          l_t += expf(s - m_t);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m_t, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l_t, off);
    const float m_n = fmaxf(m_t, m_o);
    if (m_n > -INFINITY) {
      l_t = (m_t > -INFINITY ? l_t * expf(m_t - m_n) : 0.f) +
            (m_o > -INFINITY ? l_o * expf(m_o - m_n) : 0.f);
    }
    m_t = m_n;
  }
  if (c0 == 0) {
    const float lse = m_t > -INFINITY ? m_t + logf(l_t) : INFINITY;  // +inf: no key
    lse_s[r] = lse;
    if (r < rows) {
      const long long row = ((long long)bb * sh.h + hh) * sh.s + i;
      lse_g[row] = lse;
      d_g[row] = d_s[r];
    }
  }
  __syncthreads();

  // Loop 2: dq_i = scale sum_j ds_ij k_j.
  float4 acc_q[kV4];
#pragma unroll
  for (int m = 0; m < kV4; ++m) acc_q[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse = lse_s[r], d_i = d_s[r];
  for (int k0 = tile_lo; k0 < key_hi; k0 += kTile) {
    load_tile(ks, k_b, k_stride, k0, sh.t, sh.dh);
    load_tile(vs, v_b, v_stride, k0, sh.t, sh.dv);
    __syncthreads();
    float sc[4], dp[4];
    dot4(qs + r * ldk, ks, ldk, sh.dh, sc);
    dot4(dos + r * ldv, vs, ldv, sh.dv, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float deriv;
      const float s = score(sh, sc[j], &deriv);
      float ds = 0.f;
      if (i < sh.s && visible(sh, i, k0 + c0 + 8 * j)) {
        const float p = expf(s - lse);
        ds = p * (dp[j] - d_i) * deriv;
      }
      ps[r * (kTile + 1) + c0 + 8 * j] = ds;
    }
    __syncthreads();
    accumulate<kV4>(acc_q, ps + r * (kTile + 1), 1, ks, sh.dh);
    __syncthreads();
  }
  if (r < rows) {
    E* dq_row = dq + (((long long)bb * sh.s + i) * sh.h + hh) * sh.dh;
#pragma unroll
    for (int m = 0; m < kV4; ++m) {
      const int col = 4 * c0 + 32 * m;
      if (col < sh.dh) {
        const float4 a = acc_q[m];
        store4(dq_row + col,
               make_float4(a.x * sh.scale, a.y * sh.scale, a.z * sh.scale, a.w * sh.scale));
      }
    }
  }
}

// Kernel B: dk and dv of a key block, over its group's query heads.
template <typename E, int kV4>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    const E* __restrict__ dout, E* __restrict__ dk, E* __restrict__ dv,
    const float* __restrict__ lse_g, const float* __restrict__ d_g, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = sh.dh + kPad, ldv = sh.dv + kPad;
  float* qs = smem;
  float* dos = qs + kTile * ldk;
  float* ks = dos + kTile * ldv;
  float* vs = ks + kTile * ldk;
  float* ps = vs + kTile * ldv;     // p, 32 x 33
  float* dss = ps + kTile * (kTile + 1);  // ds, 32 x 33
  float* lse_s = dss + kTile * (kTile + 1);
  float* d_s = lse_s + kTile;

  const int kb = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int group = sh.h / sh.kvh;
  const int k0 = kb * kTile;
  const int keys = min(kTile, sh.t - k0);
  const int tid = threadIdx.x, r = tid / 8, c0 = tid % 8;

  const long long q_stride = (long long)sh.h * sh.dh, o_stride = (long long)sh.h * sh.dv;
  const long long k_stride = (long long)sh.kvh * sh.dh, v_stride = (long long)sh.kvh * sh.dv;
  const E* k_b = k + ((long long)bb * sh.t * sh.kvh + kh) * sh.dh;
  const E* v_b = v + ((long long)bb * sh.t * sh.kvh + kh) * sh.dv;
  load_tile(ks, k_b, k_stride, k0, sh.t, sh.dh);
  load_tile(vs, v_b, v_stride, k0, sh.t, sh.dv);

  // Query rows that can see a key of this block: i >= k0 and
  // i - (k0 + keys - 1) < window; rows with no key are added after.
  int q_lo = 0, q_hi = sh.s;
  long long no_key = LLONG_MAX;  // first row with no key (causal only)
  if (sh.causal) {
    q_lo = k0;
    const long long hi = (long long)k0 + keys - 1 + sh.window;
    q_hi = (int)(hi < sh.s ? hi : sh.s);
    no_key = (long long)sh.t - 1 + sh.window;
  }

  float4 acc_k[kV4], acc_v[kV4];
#pragma unroll
  for (int m = 0; m < kV4; ++m) {
    acc_k[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc_v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const E* elem = nullptr;  // picks as_elem's overload

  for (int g = 0; g < group; ++g) {
    const int hh = kh * group + g;
    const E* q_b = q + ((long long)bb * sh.s * sh.h + hh) * sh.dh;
    const E* do_b = dout + ((long long)bb * sh.s * sh.h + hh) * sh.dv;
    const float* lse_b = lse_g + ((long long)bb * sh.h + hh) * sh.s;
    const float* d_b = d_g + ((long long)bb * sh.h + hh) * sh.s;
    for (int r0 = q_lo; r0 < q_hi; r0 += kTile) {
      __syncthreads();  // the previous tile's sums are done
      load_tile(qs, q_b, q_stride, r0, sh.s, sh.dh);
      load_tile(dos, do_b, o_stride, r0, sh.s, sh.dv);
      if (tid < kTile) {
        const bool in = r0 + tid < sh.s;
        lse_s[tid] = in ? lse_b[r0 + tid] : INFINITY;
        d_s[tid] = in ? d_b[r0 + tid] : 0.f;
      }
      __syncthreads();
      float sc[4], dp[4];
      dot4(qs + r * ldk, ks, ldk, sh.dh, sc);
      dot4(dos + r * ldv, vs, ldv, sh.dv, dp);
      const int i = r0 + r;
      const float lse = lse_s[r], d_i = d_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = c0 + 8 * j;
        float deriv;
        const float s = score(sh, sc[j], &deriv);
        float p = 0.f, ds = 0.f;
        if (i < sh.s && visible(sh, i, k0 + jj)) {
          p = expf(s - lse);  // 0 for a row with no key (lse = +inf)
          ds = p * (dp[j] - d_i) * deriv;
          p = as_elem(p, elem);
        }
        // Transposed: row jj (the key) of ps / dss holds the 32 query rows.
        ps[jj * (kTile + 1) + r] = p;
        dss[jj * (kTile + 1) + r] = ds;
      }
      __syncthreads();
      accumulate<kV4>(acc_v, ps + r * (kTile + 1), 1, dos, sh.dv);
      accumulate<kV4>(acc_k, dss + r * (kTile + 1), 1, qs, sh.dh);
    }
    // Rows with no key: the fill's uniform softmax, p = 1 / T on every key.
    if (no_key < sh.s) {
      const float p = as_elem(1.f / (float)sh.t, elem);
      for (int r0 = (int)no_key; r0 < sh.s; r0 += kTile) {
        __syncthreads();
        load_tile(dos, do_b, o_stride, r0, sh.s, sh.dv);
        if (tid < kTile) {
          for (int jj = 0; jj < kTile; ++jj) ps[jj * (kTile + 1) + tid] = r0 + tid < sh.s ? p : 0.f;
        }
        __syncthreads();
        accumulate<kV4>(acc_v, ps + r * (kTile + 1), 1, dos, sh.dv);
      }
    }
  }
  if (r < keys) {
    const long long j = (long long)bb * sh.t + k0 + r;
    E* dk_row = dk + (j * sh.kvh + kh) * sh.dh;
    E* dv_row = dv + (j * sh.kvh + kh) * sh.dv;
#pragma unroll
    for (int m = 0; m < kV4; ++m) {
      const int col = 4 * c0 + 32 * m;
      if (col < sh.dh) {
        const float4 a = acc_k[m];
        store4(dk_row + col,
               make_float4(a.x * sh.scale, a.y * sh.scale, a.z * sh.scale, a.w * sh.scale));
      }
      if (col < sh.dv) store4(dv_row + col, acc_v[m]);
    }
  }
}

template <typename E, int kV4>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* dd, const Shape& sh,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(sh.dh, sh.dv);
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<E, kV4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dkv_kernel<E, kV4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a((sh.s + kTile - 1) / kTile, sh.h, sh.b);
  bwd_dq_kernel<E, kV4><<<grid_a, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(out), static_cast<const E*>(dout), static_cast<E*>(dq), lse, dd, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((sh.t + kTile - 1) / kTile, sh.kvh, sh.b);
  bwd_dkv_kernel<E, kV4><<<grid_b, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), static_cast<E*>(dk), static_cast<E*>(dv), lse, dd, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_typed(const void* q, const void* k, const void* v, const void* out, const void* dout,
                 void* dq, void* dk, void* dv, float* lse, float* dd, const Shape& sh,
                 cudaStream_t stream) {
  const int width = sh.dh > sh.dv ? sh.dh : sh.dv;
  if (width <= 32) return launch<E, 1>(q, k, v, out, dout, dq, dk, dv, lse, dd, sh, stream);
  if (width <= 64) return launch<E, 2>(q, k, v, out, dout, dq, dk, dv, lse, dd, sh, stream);
  if (width <= 128) return launch<E, 4>(q, k, v, out, dout, dq, dk, dv, lse, dd, sh, stream);
  return launch<E, 8>(q, k, v, out, dout, dq, dk, dv, lse, dd, sh, stream);
}

bool bf16_width(int d) { return d == 64 || d == 128 || d == 256; }

}  // namespace

// Launches both kernels on `stream`.  q, dq: (B, S, H, dh); k, dk: (B, T,
// KVH, dh); v, dv: (B, T, KVH, dv); out, dout: (B, S, H, dv), all float32 or
// all bfloat16 (`is_bf16`), contiguous and 16-byte aligned; `lse` and `dd`
// float32 scratch of B H S each.  `window` <= 0 means no window.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for what the
// forward kernel refuses too: any size below 1, H not a multiple of KVH, a
// pointer not 16-byte aligned, in float32 dh or dv above 256 or not a
// multiple of 4, in bfloat16 dh or dv outside {64, 128, 256}.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                                     const void* out, const void* dout, void* dq, void* dk,
                                     void* dv, void* lse, void* dd, int is_bf16, int b, int s,
                                     int t, int h, int kvh, int dh, int dvw, float scale,
                                     float softcap, int causal, int window, cudaStream_t stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (b < 1 || s < 1 || t < 1 || h < 1 || kvh < 1 || h % kvh || dh < 4 || dvw < 4 ||
      dh > kMaxDim || dvw > kMaxDim || dh % 4 || dvw % 4 || (any & 15) || b > 65535 ||
      h > 65535 || kvh > 65535 || s > INT_MAX - kTile || t > INT_MAX - kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16 && (!bf16_width(dh) || !bf16_width(dvw))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh{b, s, t, h, kvh, dh, dvw, scale, softcap, causal,
           (causal && window > 0) ? (long long)window : (long long)INT_MAX};
  float* lse_f = static_cast<float*>(lse);
  float* dd_f = static_cast<float*>(dd);
  if (is_bf16) {
    return launch_typed<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, lse_f, dd_f, sh, stream);
  }
  return launch_typed<float>(q, k, v, out, dout, dq, dk, dv, lse_f, dd_f, sh, stream);
}

// Dynamic shared memory of one block of either kernel at these widths.
extern "C" int flash_attn_bwd_smem_bytes(int dh, int dv) { return (int)smem_bytes(dh, dv); }
