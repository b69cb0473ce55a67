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
// summed over the query heads of a key head's GQA group.  p_ij = exp(s_ij -
// lse_i) with the log-sum-exp lse (B, H, S) that the forward kernel wrote
// (natural log; +inf for a row with no key, so its p is 0).  A masked score
// gets no gradient (the fill blocks it); a row with no key at all (causal and
// row >= T - 1 + window) has the uniform softmax 1 / T of the fill, so its
// dout reaches every value row, and it adds nothing to dq or dk.
//
// What bounds it on this card: the operations.  At SmolLM-135M's training
// shape (B = 8, S = T = 2048, 9 heads over 3 KV heads of width 64, causal,
// bf16) the five products per attended (query, key) pair (the scores, dp,
// dv, dk, dq) are 9.7e10 FLOP, 0.098 ms on the bf16 tensor cores, against
// ~38 MB of inputs and outputs (0.011 ms at 3.35 TB/s).  The two kernels
// below run 7 products a pair (the scores twice, dp twice) so that neither
// needs atomics; at dh 64 each product's tile is 64 x 64 x 16, whose two
// shared-memory operands alone take the shared memory's full rate.
//
// bfloat16: every product on the tensor cores (wgmma, float32 accumulators in
// registers, operands fed by TMA with the 128-byte swizzle, the building
// blocks of the forward in flash_wgmma.cuh).  Three launches, no atomics, so
// two calls give the same bits:
// - bwd_dot_kernel: D_i = dout_i . out_i into a float32 (B, H, S) scratch,
//   a 16-byte chunk a thread (reads O and dO once).
// - bwd_dq_wgmma, a block per (128 query rows, head, batch): warpgroups 0
//   and 1 own 64 rows each, warpgroup 2 loads.  Q and dO are loaded once;
//   64-key K and V tiles stream through a two-stage ring on mbarriers, over
//   the key tiles the rows can see (bwd_key_tiles in kernels/flash_attn.py).
//   A tile takes three products: S = Q K^T and dP = dO V^T (both operands
//   K-major in shared memory), then dQ += dS K with dS in registers as the A
//   operand and K read MN-major.  dP runs while p is computed from S.
// - bwd_dkv_wgmma, a block per (128 keys, KV head, batch): warpgroup w owns
//   keys 64 w .. 64 w + 63, whose K and V stay in shared memory; one warp of
//   warpgroup 2 streams 64-row tiles of Q and dO (TMA) and of the rows' lse
//   and D (plain loads) through a two-stage ring, over the GQA group's query
//   heads and the query tiles that can see the block's keys, then the tiles
//   of rows with no key (bwd_query_tiles).  A tile pair takes four
//   products: S^T = K Q^T and dP^T = V dO^T (K-major), dV += P^T dO and dK
//   += dS^T Q (P^T and dS^T in registers, dO and Q read MN-major), so it
//   needs no transpose in shared memory.  A warpgroup skips a tile its keys
//   cannot see.
// dK and dV of 64 keys take (dh + dv) / 2 registers a thread; past dh + dv
// = 256 (a width of 256, or 128 with 256) they do not fit beside the score
// tiles, so the block holds 64 keys and splits the two sums: warpgroup 0
// computes S^T, P^T and dV, warpgroup 1 S^T, dP^T, dS^T and dK (S^T twice:
// 5 products a pair in place of 4).  The dq block at dh = dv = 256 has one
// consumer warpgroup, since Q, dO and two stages of K and V of 128 rows
// would take 256 KB of shared memory.  p is rounded to bfloat16 as the A
// operand of dV, as the forward feeds it to O += P V; dS likewise for dK and
// dQ.  A row with no key adds bf16(1 / T) dout to every key's dv through the
// same dV product.  softcap * tanh(x / softcap) is computed as in the
// forward (ex2 and rcp), its derivative as 1 - tanh^2.
//
// float32: on the CUDA cores, since TF32 cannot meet float32's 1e-4.
// - Kernel A, a block per (32-row query block, head, batch), 256 threads:
//   D_i = dout_i . out_i to a scratch for kernel B, then over the key tiles
//   the block's rows can see it recomputes s and p from the forward's lse,
//   dp and ds, and sums dq in registers.
// - Kernel B, a block per (32-key block, KV head, batch): K and V tiles stay
//   in shared memory, dk and dv in registers; it walks the query heads of
//   the group and the 32-row query tiles that can see its keys, recomputing
//   p from lse, then, under causal with a window, the rows with no key.
// Tiles are float32 in shared memory, rows padded by 4 words; a thread owns
// row t / 8 and columns t % 8 + 8 j of a 32 x 32 score tile (float4 dot
// products), and for the sums it owns a row or key t / 8 and the float4
// column groups 4 (t % 8) + 32 m of the width.  Widths: multiples of 4 up
// to 256 (float32), {64, 128, 256} (bf16).

#include <climits>
#include <cmath>

#include "flash_wgmma.cuh"

namespace {

constexpr int kMaxDim = 256;

// ---- bfloat16: tensor cores --------------------------------------------------

constexpr int kStages = 2;  // tiles in flight in each ring

__device__ __forceinline__ bool sees(long long qpos, long long kpos, int causal, int window) {
  return !causal || (kpos <= qpos && qpos - kpos < window);
}

// The score in base 2 (log2(e) times the scaled or softcapped dot product,
// as the forward computes it) and the softcap's derivative 1 - tanh^2.
struct Score {
  float scale_l2, cap_l2, tanh_l2;
  bool capped;

  __device__ __forceinline__ float operator()(float x, float* deriv) const {
    if (capped) {
      const float th = 1.0f - 2.0f * rcp(ex2(x * tanh_l2) + 1.0f);
      *deriv = 1.0f - th * th;
      return cap_l2 * th;
    }
    *deriv = 1.0f;
    return x * scale_l2;
  }
};

__device__ __forceinline__ Score make_score(float scale, float softcap) {
  return Score{scale * kLog2e, softcap * kLog2e,
               softcap > 0.0f ? 2.0f * kLog2e * scale / softcap : 0.0f, softcap > 0.0f};
}

__device__ __forceinline__ uint32_t align1024(const uint8_t* raw) {
  return (smem_u32(raw) + 1023) & ~1023u;
}

// D_i = dout_i . out_i of every row (b, s, h) into dd (B, H, S): DV / 8
// threads a row, a 16-byte chunk each.
template <int DV>
__global__ void __launch_bounds__(256) bwd_dot_kernel(const __nv_bfloat16* __restrict__ out,
                                                      const __nv_bfloat16* __restrict__ dout,
                                                      float* __restrict__ dd, long long rows,
                                                      int s_n, int h_n) {
  constexpr int kLanes = DV / 8;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / kLanes;
  const int chunk = (int)(t % kLanes);
  float part = 0.0f;
  if (row < rows) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + row * DV + 8 * chunk);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * DV + 8 * chunk);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(op[i]), c = __bfloat1622float2(gp[i]);
      part = fmaf(a.x, c.x, part);
      part = fmaf(a.y, c.y, part);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (chunk == 0 && row < rows) {
    const int h = (int)(row % h_n);
    const long long bs = row / h_n;
    dd[((bs / s_n) * h_n + h) * s_n + bs % s_n] = part;
  }
}

// The dq kernel's shape: consumer warpgroups of 64 query rows each; Q and dO
// of the block's rows, then kStages stages of 64 keys of K and of V, then
// the mbarriers (Q and dO, then per stage full K, full V, empty K, empty V).
template <int DH, int DV>
struct DqCfg {
  static constexpr int kWgs = DH + DV > 384 ? 1 : 2;
  static constexpr int kRows = 64 * kWgs;
  static constexpr int kThreads = 128 * (kWgs + 1);
  static constexpr int kQ = kWgs * (DH / 64) * kBox;
  static constexpr int kO = kWgs * (DV / 64) * kBox;
  static constexpr int kK = (DH / 64) * kBox;
  static constexpr int kV = (DV / 64) * kBox;
  static constexpr int kBar = kQ + kO + kStages * (kK + kV);
  static constexpr int kSmem = kBar + 8 * (1 + 4 * kStages) + 1024;
};

// Key tiles [first, end) of 64 keys that query rows [row0, row_last] can
// see (none when no row has a key), and whether tile k0 holds a key some
// row must not attend.  kernels/flash_attn.py:bwd_key_tiles is the same
// arithmetic, tested on the CPU.
struct KeySpan {
  int first, end;
};

__device__ __forceinline__ KeySpan bwd_key_tiles(int row0, int row_last, int t_n, int causal,
                                                 int window) {
  KeySpan r{0, (t_n + 63) / 64};
  if (!causal) return r;
  const long long lo = max(0LL, (long long)row0 - window + 1);
  const long long hi = min((long long)t_n, (long long)row_last + 1);
  if (lo >= hi) return KeySpan{0, 0};
  r.first = (int)(lo / 64);
  r.end = (int)((hi + 63) / 64);
  return r;
}

__device__ __forceinline__ bool key_tile_masked(int k0, int row0, int row_last, int t_n,
                                                int causal, int window) {
  return (long long)k0 + 64 > t_n ||
         (causal && ((long long)k0 + 63 > row0 || (long long)row_last - k0 >= window));
}

template <int DH, int DV>
__global__ void __launch_bounds__(DqCfg<DH, DV>::kThreads, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, const float* __restrict__ dd,
             __nv_bfloat16* __restrict__ dq, int b_n, int s_n, int t_n, int h_n, int kvh_n,
             float scale, float softcap, int causal, int window) {
  using C = DqCfg<DH, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = align1024(smem_raw);
  const uint32_t sdo = sq + C::kQ;
  const uint32_t sk = sdo + C::kO;
  const uint32_t sv = sk + kStages * C::kK;
  const uint32_t bar_q = sq + C::kBar;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages;  // + 8 * stage
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;
  constexpr int kConsumers = 128 * C::kWgs;

  const int n_qb = (s_n + C::kRows - 1) / C::kRows;
  const int bh = blockIdx.x % (b_n * h_n);
  const int qb = n_qb - 1 - blockIdx.x / (b_n * h_n);  // heaviest blocks first
  const int b = bh / h_n, h = bh % h_n;
  const int kvh = h / (h_n / kvh_n);
  const int row0 = qb * C::kRows;
  const int row_last = min(row0 + C::kRows, s_n) - 1;
  const KeySpan tiles = bwd_key_tiles(row0, row_last, t_n, causal, window);
  const int n_tiles = tiles.end - tiles.first;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_k + 8 * st, kConsumers);
      mbar_init(empty_v + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread keeps the ring full.
    if constexpr (C::kWgs == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, C::kQ + C::kO);
#pragma unroll
      for (int w = 0; w < C::kWgs; ++w) {
#pragma unroll
        for (int c = 0; c < DH / 64; ++c)
          tma_load(sq + (w * (DH / 64) + c) * kBox, &tq, bar_q, 64 * c, h, row0 + 64 * w, b);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load(sdo + (w * (DV / 64) + c) * kBox, &tdo, bar_q, 64 * c, h, row0 + 64 * w, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int k0 = (tiles.first + i) * 64;
        mbar_wait(empty_k + 8 * st, ph ^ 1);
        mbar_expect_tx(full_k + 8 * st, C::kK);
#pragma unroll
        for (int c = 0; c < DH / 64; ++c)
          tma_load(sk + st * C::kK + c * kBox, &tk, full_k + 8 * st, 64 * c, kvh, k0, b);
        mbar_wait(empty_v + 8 * st, ph ^ 1);
        mbar_expect_tx(full_v + 8 * st, C::kV);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load(sv + st * C::kV + c * kBox, &tv, full_v + 8 * st, 64 * c, kvh, k0, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows row0 + 64 wg .. + 63.  Thread
  // (warp, lane) holds rows qrow and qrow + 8, columns qcol, qcol + 1 of
  // every 8-column group of S, dP and dQ.
  if constexpr (C::kWgs == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int qrow = row0 + 64 * wg + 16 * warp + lane / 4;
  const int qcol = 2 * (lane % 4);
  const uint32_t q_wg = sq + wg * (DH / 64) * kBox;
  const uint32_t do_wg = sdo + wg * (DV / 64) * kBox;
  const Score score = make_score(scale, softcap);
  float lse2[2], d_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    const long long at = ((long long)b * h_n + h) * s_n + row;
    lse2[r] = row < s_n ? lse[at] * kLog2e : INFINITY;  // rows past S: p = 0
    d_row[r] = row < s_n ? dd[at] : 0.0f;
  }

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int k0 = (tiles.first + i) * 64;
    const uint32_t k_st = sk + st * C::kK, v_st = sv + st * C::kV;

    // S = Q K^T, then dP = dO V^T, both K-major in shared memory.
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.0f;
    mbar_wait(full_k + 8 * st, ph);
    keep(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_n64(s, kmajor_desc(q_wg + off), kmajor_desc(k_st + off), kk > 0);
    }
    wgmma_commit();
    mbar_wait(full_v + 8 * st, ph);
    keep(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_n64(dp, kmajor_desc(do_wg + off), kmajor_desc(v_st + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_one();
    keep(s);

    // p (times the softcap's derivative) from the forward's lse, while dP runs.
    const bool masked = key_tile_masked(k0, row0, row_last, t_n, causal, window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j / 2) & 1;
      float deriv;
      float p = ex2(score(s[j], &deriv) - lse2[r]);
      if (masked) {
        const int kpos = k0 + 8 * (j / 4) + qcol + (j & 1);
        if (kpos >= t_n || !sees(qrow + 8 * r, kpos, causal, window)) p = 0.0f;
      }
      s[j] = p * deriv;
    }
    wgmma_wait_all();
    keep(dp);
    mbar_arrive(empty_v + 8 * st);

    // dS = p (dP - D) as the A operand of dQ += dS K (K read MN-major).
    uint32_t a[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const float dr = d_row[m & 1];
      a[m] = pack_bf16(s[2 * m] * (dp[2 * m] - dr), s[2 * m + 1] * (dp[2 * m + 1] - dr));
    }
    keep(acc);
    keep(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(acc, a + 4 * kk, mnmajor_desc(k_st + kk * 2048));
    wgmma_commit();
    wgmma_wait_all();
    keep(acc);
    keep(a);
    mbar_arrive(empty_k + 8 * st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= s_n) continue;
    __nv_bfloat16* dst = dq + (((long long)b * s_n + row) * h_n + h) * DH + qcol;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// The dk/dv kernel's shape: kKeys keys of K and V, then kStages stages of
// 64 query rows of Q and of dO and of their lse (base 2) and D, then the
// mbarriers (K and V, then per stage full, empty).  Split: see the note above.
template <int DH, int DV>
struct DkvCfg {
  static constexpr bool kSplit = DH + DV > 256;
  static constexpr int kKeys = kSplit ? 64 : 128;
  static constexpr int kK = (kKeys / 64) * (DH / 64) * kBox;
  static constexpr int kV = (kKeys / 64) * (DV / 64) * kBox;
  static constexpr int kQ = (DH / 64) * kBox;
  static constexpr int kO = (DV / 64) * kBox;
  static constexpr int kStats = kK + kV + kStages * (kQ + kO);  // 128 floats a stage
  static constexpr int kBar = kStats + kStages * 128 * 4;
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// Query tiles of 64 rows that keys [k0, k0 + keys) meet: [main_lo, main_hi)
// holds every row that sees one of them, [none_lo, none_hi) every row with
// no key at all (causal, row >= T - 1 + window), which spreads its dout over
// every key.  kernels/flash_attn.py:bwd_query_tiles is the same arithmetic,
// tested on the CPU.
struct QuerySpans {
  int main_lo, main_hi, none_lo, none_hi;
};

__device__ __forceinline__ QuerySpans bwd_query_tiles(int k0, int keys, int s_n, int t_n,
                                                      int causal, int window) {
  QuerySpans r{0, (s_n + 63) / 64, 0, 0};
  if (!causal) return r;
  const long long lo = k0;
  const long long hi = min((long long)s_n, (long long)min(k0 + keys, t_n) - 1 + window);
  r.main_lo = (int)(lo / 64);
  r.main_hi = lo < hi ? (int)((hi + 63) / 64) : r.main_lo;
  const long long none = (long long)t_n - 1 + window;
  if (none < s_n) {
    r.none_lo = (int)(none / 64);
    r.none_hi = (s_n + 63) / 64;
  }
  return r;
}

// Whether the 64 x 64 pair (keys kw0.., rows q0..) holds a pair that must
// not attend (`masked`), or none that may (`skipped`).
__device__ __forceinline__ bool pair_masked(int kw0, int q0, int causal, int window) {
  return causal && ((long long)q0 < (long long)kw0 + 63 || (long long)q0 + 63 - kw0 >= window);
}

__device__ __forceinline__ bool pair_skipped(int kw0, int q0, int causal, int window) {
  return causal && ((long long)q0 + 63 < kw0 || (long long)q0 - kw0 - 63 >= window);
}

struct DkvArgs {
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b_n, s_n, t_n, h_n, kvh_n;
  float scale, softcap;
  int causal, window;
};

// One consumer warpgroup's walk: dV (kDoV) and / or dK (kDoK) of its 64 keys
// kw0.. over the block's query tiles.  k_wg and v_wg are its K and V rows.
template <int DH, int DV, bool kDoV, bool kDoK>
__device__ __forceinline__ void dkv_consume(const DkvArgs& ar, int b, int kvh, int kw0,
                                            uint32_t k_wg, uint32_t v_wg, uint32_t sq,
                                            uint32_t sdo, const float* stats, uint32_t full,
                                            uint32_t empty, const QuerySpans& sp) {
  using C = DkvCfg<DH, DV>;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int krow = kw0 + 16 * warp + lane / 4;  // and krow + 8
  const int qcol = 2 * (lane % 4);
  const int group = ar.h_n / ar.kvh_n;
  const Score score = make_score(ar.scale, ar.softcap);
  const long long none_row = (long long)ar.t_n - 1 + ar.window;
  // A row with no key: p = 1 / T on every key, rounded as the reference
  // rounds p for the product with v.
  const float p_none = __bfloat162float(__float2bfloat16_rn(1.0f / (float)ar.t_n));

  float dv_acc[kDoV ? DV / 2 : 1], dk_acc[kDoK ? DH / 2 : 1];
  if constexpr (kDoV) {
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.0f;
  }
  if constexpr (kDoK) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk_acc[i] = 0.0f;
  }

  int n = 0;
  for (int g = 0; g < group; ++g) {
    for (int pass = 0; pass < 2; ++pass) {
      const int lo = pass ? sp.none_lo : sp.main_lo, hi = pass ? sp.none_hi : sp.main_hi;
      for (int t = lo; t < hi; ++t, ++n) {
        const int st = n % kStages;
        const uint32_t ph = (n / kStages) & 1;
        const int q0 = 64 * t;
        const uint32_t q_st = sq + st * C::kQ, do_st = sdo + st * C::kO;
        const float* lse2 = stats + st * 128;
        const float* d_q = lse2 + 64;
        mbar_wait(full + 8 * st, ph);

        if (pass == 0 && !pair_skipped(kw0, q0, ar.causal, ar.window)) {
          // S^T = K Q^T and dP^T = V dO^T, all K-major.
          float s[32], dp[kDoK ? 32 : 1];
#pragma unroll
          for (int j = 0; j < 32; ++j) s[j] = 0.0f;
          keep(s);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk) {
            const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
            wgmma_ss_n64(s, kmajor_desc(k_wg + off), kmajor_desc(q_st + off), kk > 0);
          }
          wgmma_commit();
          if constexpr (kDoK) {
#pragma unroll
            for (int j = 0; j < 32; ++j) dp[j] = 0.0f;
            keep(dp);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DV / 16; ++kk) {
              const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
              wgmma_ss_n64(dp, kmajor_desc(v_wg + off), kmajor_desc(do_st + off), kk > 0);
            }
            wgmma_commit();
            wgmma_wait_one();
          } else {
            wgmma_wait_all();
          }
          keep(s);

          // P^T (bf16, the A operand of dV) and p times the softcap's
          // derivative (kept in s for dS^T).  Element 2m, 2m + 1 of the
          // accumulator is key krow + 8 (m & 1), rows qi, qi + 1 of the tile.
          const bool masked = pair_masked(kw0, q0, ar.causal, ar.window);
          uint32_t a[16];
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            const int qi = 8 * (m / 2) + qcol;
            float d0, d1;
            float p0 = ex2(score(s[2 * m], &d0) - lse2[qi]);
            float p1 = ex2(score(s[2 * m + 1], &d1) - lse2[qi + 1]);
            if (masked) {
              const int kpos = krow + 8 * (m & 1);
              if (!sees(q0 + qi, kpos, ar.causal, ar.window)) p0 = 0.0f;
              if (!sees(q0 + qi + 1, kpos, ar.causal, ar.window)) p1 = 0.0f;
            }
            if constexpr (kDoV) a[m] = pack_bf16(p0, p1);
            s[2 * m] = p0 * d0;
            s[2 * m + 1] = p1 * d1;
          }
          if constexpr (kDoV) {
            keep(dv_acc);
            keep(a);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs<DV>(dv_acc, a + 4 * kk, mnmajor_desc(do_st + kk * 2048));
            wgmma_commit();
          }
          if constexpr (kDoK) {
            wgmma_wait_all();  // dP^T, and dV before its operand is overwritten
            keep(dp);
            keep(a);
            if constexpr (kDoV) keep(dv_acc);
#pragma unroll
            for (int m = 0; m < 16; ++m) {
              const int qi = 8 * (m / 2) + qcol;
              a[m] = pack_bf16(s[2 * m] * (dp[2 * m] - d_q[qi]),
                               s[2 * m + 1] * (dp[2 * m + 1] - d_q[qi + 1]));
            }
            keep(dk_acc);
            keep(a);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs<DH>(dk_acc, a + 4 * kk, mnmajor_desc(q_st + kk * 2048));
            wgmma_commit();
          }
          wgmma_wait_all();
          keep(a);
          if constexpr (kDoV) keep(dv_acc);
          if constexpr (kDoK) keep(dk_acc);
        } else if (pass == 1) {
          if constexpr (kDoV) {
            uint32_t a[16];
#pragma unroll
            for (int m = 0; m < 16; ++m) {
              const long long q = q0 + 8 * (m / 2) + qcol;
              a[m] = pack_bf16(q >= none_row && q < ar.s_n ? p_none : 0.0f,
                               q + 1 >= none_row && q + 1 < ar.s_n ? p_none : 0.0f);
            }
            keep(dv_acc);
            keep(a);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs<DV>(dv_acc, a + 4 * kk, mnmajor_desc(do_st + kk * 2048));
            wgmma_commit();
            wgmma_wait_all();
            keep(dv_acc);
            keep(a);
          }
        }
        mbar_arrive(empty + 8 * st);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = krow + 8 * r;
    if (key >= ar.t_n) continue;
    const long long at = ((long long)b * ar.t_n + key) * ar.kvh_n + kvh;
    if constexpr (kDoV) {
      __nv_bfloat16* dst = ar.dv + at * DV + qcol;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
    if constexpr (kDoK) {
      __nv_bfloat16* dst = ar.dk + at * DH + qcol;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            dk_acc[4 * j + 2 * r] * ar.scale, dk_acc[4 * j + 2 * r + 1] * ar.scale);
    }
  }
}

template <int DH, int DV>
__global__ void __launch_bounds__(3 * 128, 1)
bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ dd, DkvArgs ar) {
  using C = DkvCfg<DH, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = align1024(smem_raw);
  const uint32_t sv = sk + C::kK;
  const uint32_t sq = sv + C::kV;
  const uint32_t sdo = sq + kStages * C::kQ;
  float* stats = reinterpret_cast<float*>(smem_raw + (sk - smem_u32(smem_raw)) + C::kStats);
  const uint32_t bar_kv = sk + C::kBar;
  const uint32_t full = bar_kv + 8, empty = full + 8 * kStages;  // + 8 * stage

  const int bk = blockIdx.x % (ar.b_n * ar.kvh_n);
  const int kb = blockIdx.x / (ar.b_n * ar.kvh_n);  // the first keys, the most rows, first
  const int b = bk / ar.kvh_n, kvh = bk % ar.kvh_n;
  const int k0 = kb * C::kKeys;
  const QuerySpans sp = bwd_query_tiles(k0, C::kKeys, ar.s_n, ar.t_n, ar.causal, ar.window);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1 + 32);  // the TMA's bytes and the loading warp's lse and D
      mbar_init(empty + 8 * st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer: warp 0 of warpgroup 2 keeps the ring full; lane 0 issues
    // the copies, every lane loads two rows' lse and D.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, C::kK + C::kV);
#pragma unroll
      for (int w = 0; w < C::kKeys / 64; ++w) {
#pragma unroll
        for (int c = 0; c < DH / 64; ++c)
          tma_load(sk + (w * (DH / 64) + c) * kBox, &tk, bar_kv, 64 * c, kvh, k0 + 64 * w, b);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load(sv + (w * (DV / 64) + c) * kBox, &tv, bar_kv, 64 * c, kvh, k0 + 64 * w, b);
      }
    }
    const int group = ar.h_n / ar.kvh_n;
    int n = 0;
    for (int g = 0; g < group; ++g) {
      const int h = kvh * group + g;
      const long long head = ((long long)b * ar.h_n + h) * ar.s_n;
      for (int pass = 0; pass < 2; ++pass) {
        const int lo = pass ? sp.none_lo : sp.main_lo, hi = pass ? sp.none_hi : sp.main_hi;
        for (int t = lo; t < hi; ++t, ++n) {
          const int st = n % kStages;
          const uint32_t ph = (n / kStages) & 1;
          const int q0 = 64 * t;
          mbar_wait(empty + 8 * st, ph ^ 1);
          if (lane == 0) {
            mbar_expect_tx(full + 8 * st, C::kQ + C::kO);
#pragma unroll
            for (int c = 0; c < DH / 64; ++c)
              tma_load(sq + st * C::kQ + c * kBox, &tq, full + 8 * st, 64 * c, h, q0, b);
#pragma unroll
            for (int c = 0; c < DV / 64; ++c)
              tma_load(sdo + st * C::kO + c * kBox, &tdo, full + 8 * st, 64 * c, h, q0, b);
          }
          float* lse2 = stats + st * 128;
#pragma unroll
          for (int rr = lane; rr < 64; rr += 32) {
            const int row = q0 + rr;
            lse2[rr] = row < ar.s_n ? lse[head + row] * kLog2e : INFINITY;
            lse2[64 + rr] = row < ar.s_n ? dd[head + row] : 0.0f;
          }
          mbar_arrive(full + 8 * st);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  mbar_wait(bar_kv, 0);
  if constexpr (C::kSplit) {
    if (wg == 0) {
      dkv_consume<DH, DV, true, false>(ar, b, kvh, k0, sk, sv, sq, sdo, stats, full, empty, sp);
    } else {
      dkv_consume<DH, DV, false, true>(ar, b, kvh, k0, sk, sv, sq, sdo, stats, full, empty, sp);
    }
  } else {
    dkv_consume<DH, DV, true, true>(ar, b, kvh, k0 + 64 * wg, sk + wg * (DH / 64) * kBox,
                                    sv + wg * (DV / 64) * kBox, sq, sdo, stats, full, empty, sp);
  }
}

template <int DH, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, const void* out, const void* dout,
                 const float* lse, void* dq, void* dk, void* dv, float* dd, int b, int s, int t,
                 int h, int kvh, float scale, float softcap, int causal, int window,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_map(&tq, q, DH, h, s, b);
  if (err == 0) err = encode_map(&tk, k, DH, kvh, t, b);
  if (err == 0) err = encode_map(&tv, v, DV, kvh, t, b);
  if (err == 0) err = encode_map(&tdo, dout, DV, h, s, b);
  if (err != 0) return err;

  const long long rows = (long long)b * s * h;
  const long long dot_blocks = (rows * (DV / 8) + 255) / 256;
  bwd_dot_kernel<DV><<<(unsigned)dot_blocks, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout), dd, rows,
      s, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  using Q = DqCfg<DH, DV>;
  e = cudaFuncSetAttribute(bwd_dq_wgmma<DH, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Q::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long dq_blocks = (long long)((s + Q::kRows - 1) / Q::kRows) * b * h;
  bwd_dq_wgmma<DH, DV><<<(unsigned)dq_blocks, Q::kThreads, Q::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, dd, static_cast<__nv_bfloat16*>(dq), b, s, t, h, kvh, scale, softcap,
      causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  using K = DkvCfg<DH, DV>;
  e = cudaFuncSetAttribute(bwd_dkv_wgmma<DH, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           K::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long dkv_blocks = (long long)((t + K::kKeys - 1) / K::kKeys) * b * kvh;
  const DkvArgs ar{static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), b, s, t, h,
                   kvh, scale, softcap, causal, window};
  bwd_dkv_wgmma<DH, DV><<<(unsigned)dkv_blocks, 3 * 128, K::kSmem, stream>>>(tq, tk, tv, tdo,
                                                                             lse, dd, ar);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dv(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const float* lse, void* dq, void* dk, void* dv, float* dd, int b, int s, int t,
              int h, int kvh, int dvw, float scale, float softcap, int causal, int window,
              cudaStream_t stream) {
  switch (dvw) {
    case 64:
      return launch_wgmma<DH, 64>(q, k, v, out, dout, lse, dq, dk, dv, dd, b, s, t, h, kvh,
                                  scale, softcap, causal, window, stream);
    case 128:
      return launch_wgmma<DH, 128>(q, k, v, out, dout, lse, dq, dk, dv, dd, b, s, t, h, kvh,
                                   scale, softcap, causal, window, stream);
    case 256:
      return launch_wgmma<DH, 256>(q, k, v, out, dout, lse, dq, dk, dv, dd, b, s, t, h, kvh,
                                   scale, softcap, causal, window, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- float32: CUDA cores -----------------------------------------------------

constexpr int kTile = 32;      // query rows and keys a tile
constexpr int kThreads = 256;  // 8 threads a row of a tile
constexpr int kPad = 4;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [r0, r0 + 32) of a (rows, width) slice with `stride` elements between
// rows into a tile of leading dimension width + kPad; rows at or past `rows`
// are zero.
__device__ void load_tile(float* dst, const float* src, long long stride, int r0, int rows,
                          int width) {
  const int per_row = width / 4;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows) val = load4(src + (long long)(r0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * (width + kPad) + c) = val;
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

// Kernel A: D of a query block, then its dq from the forward's lse.
template <int kV4>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ out, const float* __restrict__ dout, float* __restrict__ dq,
    const float* __restrict__ lse_g, float* __restrict__ d_g, Shape sh) {
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
  const float* q_b = q + ((long long)bb * sh.s * sh.h + hh) * sh.dh;
  const float* o_b = out + ((long long)bb * sh.s * sh.h + hh) * sh.dv;
  const float* do_b = dout + ((long long)bb * sh.s * sh.h + hh) * sh.dv;
  const float* k_b = k + ((long long)bb * sh.t * sh.kvh + kh) * sh.dh;
  const float* v_b = v + ((long long)bb * sh.t * sh.kvh + kh) * sh.dv;

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

  // D_i = dout_i . out_i (8 threads a row), and the forward's lse.
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
    if (c0 == 0) {
      d_s[r] = part;
      const long long row = ((long long)bb * sh.h + hh) * sh.s + i;
      lse_s[r] = r < rows ? lse_g[row] : INFINITY;  // +inf: no key
      if (r < rows) d_g[row] = part;
    }
  }
  __syncthreads();

  // dq_i = scale sum_j ds_ij k_j.
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
    float* dq_row = dq + (((long long)bb * sh.s + i) * sh.h + hh) * sh.dh;
#pragma unroll
    for (int m = 0; m < kV4; ++m) {
      const int col = 4 * c0 + 32 * m;
      if (col < sh.dh) {
        const float4 a = acc_q[m];
        *reinterpret_cast<float4*>(dq_row + col) =
            make_float4(a.x * sh.scale, a.y * sh.scale, a.z * sh.scale, a.w * sh.scale);
      }
    }
  }
}

// Kernel B: dk and dv of a key block, over its group's query heads.
template <int kV4>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
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
  const float* k_b = k + ((long long)bb * sh.t * sh.kvh + kh) * sh.dh;
  const float* v_b = v + ((long long)bb * sh.t * sh.kvh + kh) * sh.dv;
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

  for (int g = 0; g < group; ++g) {
    const int hh = kh * group + g;
    const float* q_b = q + ((long long)bb * sh.s * sh.h + hh) * sh.dh;
    const float* do_b = dout + ((long long)bb * sh.s * sh.h + hh) * sh.dv;
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
      const float p = 1.f / (float)sh.t;
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
    float* dk_row = dk + (j * sh.kvh + kh) * sh.dh;
    float* dv_row = dv + (j * sh.kvh + kh) * sh.dv;
#pragma unroll
    for (int m = 0; m < kV4; ++m) {
      const int col = 4 * c0 + 32 * m;
      if (col < sh.dh) {
        const float4 a = acc_k[m];
        *reinterpret_cast<float4*>(dk_row + col) =
            make_float4(a.x * sh.scale, a.y * sh.scale, a.z * sh.scale, a.w * sh.scale);
      }
      if (col < sh.dv) *reinterpret_cast<float4*>(dv_row + col) = acc_v[m];
    }
  }
}

template <int kV4>
int launch_f32_v4(const float* q, const float* k, const float* v, const float* out,
                  const float* dout, float* dq, float* dk, float* dv, const float* lse, float* dd,
                  const Shape& sh, cudaStream_t stream) {
  const size_t smem = smem_bytes(sh.dh, sh.dv);
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<kV4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dkv_kernel<kV4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a((sh.s + kTile - 1) / kTile, sh.h, sh.b);
  bwd_dq_kernel<kV4><<<grid_a, kThreads, smem, stream>>>(q, k, v, out, dout, dq, lse, dd, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((sh.t + kTile - 1) / kTile, sh.kvh, sh.b);
  bwd_dkv_kernel<kV4><<<grid_b, kThreads, smem, stream>>>(q, k, v, dout, dk, dv, lse, dd, sh);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
               void* dq, void* dk, void* dv, const float* lse, float* dd, const Shape& sh,
               cudaStream_t stream) {
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *of = static_cast<const float*>(out),
              *gf = static_cast<const float*>(dout);
  float *dqf = static_cast<float*>(dq), *dkf = static_cast<float*>(dk),
        *dvf = static_cast<float*>(dv);
  const int width = sh.dh > sh.dv ? sh.dh : sh.dv;
  if (width <= 32) return launch_f32_v4<1>(qf, kf, vf, of, gf, dqf, dkf, dvf, lse, dd, sh, stream);
  if (width <= 64) return launch_f32_v4<2>(qf, kf, vf, of, gf, dqf, dkf, dvf, lse, dd, sh, stream);
  if (width <= 128) return launch_f32_v4<4>(qf, kf, vf, of, gf, dqf, dkf, dvf, lse, dd, sh, stream);
  return launch_f32_v4<8>(qf, kf, vf, of, gf, dqf, dkf, dvf, lse, dd, sh, stream);
}

bool bf16_width(int d) { return d == 64 || d == 128 || d == 256; }

template <int DH>
int wgmma_smem_dv(int dkv, int dv) {
  if (dv == 64) return dkv ? DkvCfg<DH, 64>::kSmem : DqCfg<DH, 64>::kSmem;
  if (dv == 128) return dkv ? DkvCfg<DH, 128>::kSmem : DqCfg<DH, 128>::kSmem;
  return dkv ? DkvCfg<DH, 256>::kSmem : DqCfg<DH, 256>::kSmem;
}

}  // namespace

// Launches on `stream`.  q, dq: (B, S, H, dh); k, dk: (B, T, KVH, dh); v, dv:
// (B, T, KVH, dv); out, dout: (B, S, H, dv), all float32 or all bfloat16
// (`is_bf16`), contiguous and 16-byte aligned; `lse` float32 (B, H, S), the
// forward's log-sum-exp; `dd` a float32 scratch of B H S for D.  `window` <= 0
// means no window.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for what the forward kernel refuses too: any size
// below 1, H not a multiple of KVH, a pointer not 16-byte aligned, in float32
// dh or dv above 256 or not a multiple of 4, in bfloat16 dh or dv outside
// {64, 128, 256}.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                                     const void* out, const void* dout, const void* lse,
                                     void* dq, void* dk, void* dv, void* dd, int is_bf16, int b,
                                     int s, int t, int h, int kvh, int dh, int dvw, float scale,
                                     float softcap, int causal, int window, cudaStream_t stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (b < 1 || s < 1 || t < 1 || h < 1 || kvh < 1 || h % kvh || dh < 4 || dvw < 4 ||
      dh > kMaxDim || dvw > kMaxDim || dh % 4 || dvw % 4 || (any & 15) || b > 65535 ||
      h > 65535 || kvh > 65535 || s > INT_MAX - kTile || t > INT_MAX - kTile ||
      (long long)b * h * (((s > t ? s : t) + 63) / 64) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int win = (causal && window > 0) ? window : INT_MAX;
  const float* lse_f = static_cast<const float*>(lse);
  float* dd_f = static_cast<float*>(dd);
  if (is_bf16) {
    switch (dh) {
      case 64:
        return launch_dv<64>(q, k, v, out, dout, lse_f, dq, dk, dv, dd_f, b, s, t, h, kvh, dvw,
                             scale, softcap, causal, win, stream);
      case 128:
        return launch_dv<128>(q, k, v, out, dout, lse_f, dq, dk, dv, dd_f, b, s, t, h, kvh, dvw,
                              scale, softcap, causal, win, stream);
      case 256:
        return launch_dv<256>(q, k, v, out, dout, lse_f, dq, dk, dv, dd_f, b, s, t, h, kvh, dvw,
                              scale, softcap, causal, win, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh{b, s, t, h, kvh, dh, dvw, scale, softcap, causal, (long long)win};
  return launch_f32(q, k, v, out, dout, dq, dk, dv, lse_f, dd_f, sh, stream);
}

// Dynamic shared memory of one block of the bfloat16 dq kernel (`dkv` 0) or
// dk/dv kernel (`dkv` 1) at these widths, in bytes; -1 for widths it refuses.
extern "C" int flash_attn_bwd_smem_bytes(int dkv, int dh, int dv) {
  if (!bf16_width(dh) || !bf16_width(dv)) return -1;
  switch (dh) {
    case 64:
      return wgmma_smem_dv<64>(dkv, dv);
    case 128:
      return wgmma_smem_dv<128>(dkv, dv);
  }
  return wgmma_smem_dv<256>(dkv, dv);
}
