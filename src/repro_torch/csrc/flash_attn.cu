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
// (m starts at -1e30, so exp(-inf - m) is 0, never NaN).  Key tiles wholly
// above the diagonal or wholly outside the window are skipped; a block
// holding a row with no key at all (S > T - 1 + window) runs every tile, as
// the dense softmax then averages all keys.  Blocks of the last query rows,
// which have the most tiles, are started first.
//
// What bounds it on this card: operations.  At Gemma2-9B's global layer (B =
// 2, S = T = 8064, H = 16, dh = dv = 256, causal) the useful work is 1.07e12
// FLOP, 1.08 ms on the bf16 tensor cores, against 0.40 GB of inputs and
// outputs (0.12 ms at 3.35 TB/s).
//
// Two kernels, chosen by the input type; neither falls back to the other.
// Either also stores each row's log-sum-exp when given an lse pointer
// (row_lse: natural log of the filled, softcapped, scaled scores' sum of
// exponentials, +inf for a row with no key), which the backward
// (csrc/flash_attn_bwd.cu) reads in place of recomputing it; a null pointer
// stores nothing.
//
// bfloat16, flash_wgmma: both products on the tensor cores (wgmma, float32
// accumulators in registers).  One block of three warpgroups handles 128
// query rows of one (batch, head): warpgroups 0 and 1 each own 64 rows and
// compute; one thread of warpgroup 2 issues every load.  setmaxnreg moves
// registers from the producer (24) to the consumers (240), which hold the
// (64, dv) accumulator (128 registers a thread at dv = 256), the 64 x 64
// score tile (32) and its bf16 copy (16).  Q is loaded once and 64-key K and
// V tiles stream through a ring of two stages, all by TMA (tensor maps over
// the 4-D tensors, boxes of 64 rows x 64 columns with the 128-byte swizzle
// the wgmma descriptors name), each stage with a full and an empty mbarrier
// for K and for V.  S = Q K^T reads Q and K from shared memory (K-major);
// softmax runs in registers in base 2; P stays in registers as the A operand
// of O += P V, whose accumulator layout is the register layout of A, and V is
// read from shared memory MN-major, transposed by the descriptor.  At dh = dv
// = 256 shared memory holds Q (64 KB) and two stages of K and V (128 KB).
// TMA fills rows past S or T with zeros, so keys past T are still masked here
// and rows past S are never stored.  softcap * tanh(x / softcap) is
// softcap * (1 - 2 / (2^(2 x log2(e) / softcap) + 1)) with ex2.approx and
// rcp.approx, within about 5e-7 * softcap of tanh (tanh.approx.f32 would be
// 2^-11 * softcap, 0.02 at softcap 50).  A warpgroup waits for each product
// before it reads the result; overlapping one tile's softmax with the
// previous tile's P V product was measured and not kept (PERF.md).
// dh and dv in {64, 128, 256}.
//
// float32, flash_kernel: the products on the CUDA cores in float32 FMAs, since
// the tensor cores (TF32) cannot meet float32's 2e-5.  What bounds it is the
// FMA rate, 67 TFLOP/s (0.379 ms at the float32 case of chip_smoke.py), so
// the design keeps shared memory, the instruction slots and the loads off the
// FMAs' path.  One block of three warpgroups per (batch, head, 64 query
// rows), one block an SM.  Warpgroup 2 produces: it copies 32-key K and V
// tiles into a ring of two stages by cp.async (16-byte .cg copies, so
// every pointer is 16-byte aligned: the binding copies an input that is
// not; rows past T zero-filled), each stage with a full mbarrier that the
// copies complete (cp.async.mbarrier.arrive) and an empty one that each
// consumer warp arrives on when done with it.  Warpgroups 0 and 1 consume, each owning 32
// of the rows and synchronising only among themselves (a named barrier a
// tile), so one group's softmax and waits overlap the other's FMAs; group
// 1 starts one score product behind group 0.
// setmaxnreg gives the consumers 232 registers and the producer 40.  Shared
// memory at dh = dv = 256: Q 64 KB (copied once), two stages of K (rows
// padded to 272 floats, 16 mod 32 words) 68 KB and of V 64 KB, two p tiles
// per group 18 KB: 219,968 bytes of the 232,448 a block may take.  Tiles
// of 64 keys would take 135 KB a stage pair, so the keys come 32 a tile at
// every width.
//   S = Q K^T: warp w of a group owns its rows w + 4i (i < 8); lane = s +
// 4 g splits d into 4 slices (16-byte chunks c = s mod 4) and takes keys g
// + 8t (t < 4), so a thread holds an 8 x 4 register tile of partial sums:
// 12 float4 reads per 128 FMAs, 0.375 words an FMA a thread, 0.125 after
// the warp's broadcast (a Q read is one row, 4 chunks; a K read is 8 keys,
// 512 bytes in 4 wavefronts, conflict-free since K's row pitch is 16 mod 32
// words).  Two xor-shuffle halvings sum the slices, leaving each thread two
// rows, w + 8s and w + 8s + 4, of its 4 keys.
//   softmax in base 2 on those 8 scores: the row max and sum over the 8
// lanes of a row are 3 shuffles; scale folds log2(e); softcap * tanh(x /
// softcap) is softcap * (1 - 2 / (2^(2 x log2(e) / softcap) + 1)) by exp2f
// and a fast reciprocal (a few 1e-6 from the precise tanh, held within 2e-5
// on the card); masks only on the tiles that need them.  p goes to the
// group's shared tile transposed (key-major), each row's factor alpha beside
// it, both double-buffered around the group's barrier.
//   O += P V: thread (a, b) of a group owns its rows 4a..4a+3, 16+4a..+3
// and value columns 4b..4b+3, 128+4b..+3, an 8 x 8 register tile: 4 float4
// reads per 64 FMAs, 0.25 words an FMA (a warp's p reads are 16 words, its
// V reads 32, one wavefront each).  dh and dv multiples of 4 up to 256; the
// schedule of tiles is mirrored by kernels/flash_attn.py:key_tiles(...,
// block_q=64, block_k=32).
#include <climits>

#include "flash_wgmma.cuh"

namespace {

// ---- shared by both kernels ---------------------------------------------------

constexpr int kBQ = 64;         // float32 query rows per block
constexpr int kMaxDim = 256;    // largest dh and dv
constexpr float kNeg = -1e30f;
constexpr float kNegL2 = kNeg * kLog2e;  // the -1e30 fill, in base 2
constexpr float kLn2 = 0.6931471805599453f;

// A row's log-sum-exp in natural-log units from its base-2 running max m2
// and sum l: (m2 + log2 l) ln 2 over the filled, softcapped, scaled scores;
// +inf for a row with no key (causal, row >= T - 1 + window), which the
// backward reads as p = 0.
__device__ __forceinline__ float row_lse(float m2, float l, int row, int t_n, int causal,
                                         int window) {
  if (causal && (long long)row >= (long long)t_n - 1 + window) return INFINITY;
  return (m2 + log2f(l)) * kLn2;
}

// ---- bfloat16: tensor cores --------------------------------------------------

constexpr int kRows = 128;              // query rows per block: two warpgroups of 64
constexpr int kKeys = 64;               // keys per tile
constexpr int kStages = 2;              // K and V tiles in flight
constexpr int kWgThreads = 3 * 128;     // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kConsumers = 2 * 128;

// Shared memory of one block, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 B): Q's 128 rows, then
// kStages stages of 64 keys of K and of V, then the mbarriers (q, then per
// stage full K, full V, empty K, empty V), plus 1024 of alignment slack.
template <int DH, int DV>
struct Layout {
  static constexpr int kQ = 2 * (DH / 64) * kBox;
  static constexpr int kK = (DH / 64) * kBox;
  static constexpr int kV = (DV / 64) * kBox;
  static constexpr int kBar = kQ + kStages * (kK + kV);
};

constexpr int wgmma_smem_bytes(int dh, int dv) {
  return (2 * (dh / 64) + kStages * (dh / 64 + dv / 64)) * kBox + 8 * (1 + 4 * kStages) + 1024;
}

// Key tiles [first, end) of kTile keys that query rows [row0, row_last]
// visit, and whether every one needs the mask: a row with no key at all
// (causal, row_last >= T - 1 + window) makes the block run every tile masked,
// since the dense softmax then averages all T keys.  kernels/flash_attn.py:
// key_tiles is the same arithmetic, tested on the CPU.
struct Tiles {
  int first, end, all_masked;
};

template <int kTile = kKeys>
__device__ __forceinline__ Tiles key_tiles(int row0, int row_last, int t_n, int causal,
                                           int window) {
  Tiles r{0, (int)(((long long)t_n + kTile - 1) / kTile), 0};
  if (!causal) return r;
  if ((long long)row_last >= (long long)t_n - 1 + window) {
    r.all_masked = 1;
    return r;
  }
  const int k_hi = min(t_n, row_last + 1);
  const int k_lo = (int)max(0LL, (long long)row0 - window + 1);
  r.first = k_lo / kTile;
  r.end = (int)(((long long)k_hi + kTile - 1) / kTile);
  return r;
}

// Whether tile [k0, k0 + kTile) holds a key that some row in [row0,
// row_last] must not attend: past T, after row0 (causal), or window or more
// before row_last.
template <int kTile = kKeys>
__device__ __forceinline__ bool tile_masked(const Tiles& r, int k0, int row0, int row_last,
                                            int t_n, int causal, int window) {
  return r.all_masked || (long long)k0 + kTile > t_n ||
         (causal && ((long long)k0 + kTile - 1 > row0 || (long long)row_last - k0 >= window));
}

template <int DH, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
            float* __restrict__ lse, int b_n,
            int s_n, int t_n, int h_n, int kvh_n, float scale, float softcap, int causal,
            int window) {
  using L = Layout<DH, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + L::kQ;
  const uint32_t sv = sk + kStages * L::kK;
  const uint32_t bar_q = sq + L::kBar;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages;  // + 8 * stage
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;

  const int n_qb = (s_n + kRows - 1) / kRows;
  const int bh = blockIdx.x % (b_n * h_n);
  const int qb = n_qb - 1 - blockIdx.x / (b_n * h_n);  // heaviest blocks first
  const int b = bh / h_n, h = bh % h_n;
  const int kvh = h / (h_n / kvh_n);
  const int row0 = qb * kRows;
  const int row_last = min(row0 + kRows, s_n) - 1;
  const Tiles tiles = key_tiles(row0, row_last, t_n, causal, window);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, L::kQ);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int c = 0; c < DH / 64; ++c)
          tma_load(sq + (w * (DH / 64) + c) * kBox, &tq, bar_q, 64 * c, h, row0 + 64 * w, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int k0 = (tiles.first + i) * kKeys;
        mbar_wait(empty_k + 8 * st, ph ^ 1);
        mbar_expect_tx(full_k + 8 * st, L::kK);
#pragma unroll
        for (int c = 0; c < DH / 64; ++c)
          tma_load(sk + st * L::kK + c * kBox, &tk, full_k + 8 * st, 64 * c, kvh, k0, b);
        mbar_wait(empty_v + 8 * st, ph ^ 1);
        mbar_expect_tx(full_v + 8 * st, L::kV);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load(sv + st * L::kV + c * kBox, &tv, full_v + 8 * st, 64 * c, kvh, k0, b);
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows row0 + 64 wg .. + 63.  Thread
    // (warp, lane) holds rows qrow and qrow + 8, columns qcol, qcol + 1 of
    // every 8-column group of S and O.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int qrow = row0 + 64 * wg + 16 * warp + lane / 4;
    const int qcol = 2 * (lane % 4);
    const uint32_t q_wg = sq + wg * (DH / 64) * kBox;
    const float scale_l2 = scale * kLog2e;
    const float cap_l2 = softcap * kLog2e;
    const float tanh_l2 = softcap > 0.0f ? 2.0f * kLog2e * scale / softcap : 0.0f;

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegL2, kNegL2}, l[2] = {0.0f, 0.0f};
    mbar_wait(bar_q, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int k0 = (tiles.first + i) * kKeys;

      // S = Q K^T: dh / 16 steps of 16 along the 128-byte swizzled rows.
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.0f;
      mbar_wait(full_k + 8 * st, ph);
      keep(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_n64(s, kmajor_desc(q_wg + off), kmajor_desc(sk + st * L::kK + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(s);
      mbar_arrive(empty_k + 8 * st);

      // Scores in base 2: log2(e) * (scale * qk, or softcap * tanh(scale * qk / softcap)).
      if (softcap > 0.0f) {
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = cap_l2 - 2.0f * cap_l2 * rcp(ex2(s[j] * tanh_l2) + 1.0f);
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] *= scale_l2;
      }
      if (tile_masked(tiles, k0, row0, row_last, t_n, causal, window)) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int kpos = k0 + 8 * (j / 4) + qcol + (j & 1);
          const int qpos = qrow + 8 * ((j / 2) & 1);
          if (kpos >= t_n) {
            s[j] = -INFINITY;
          } else if (causal && (kpos > qpos || (long long)qpos - kpos >= window)) {
            s[j] = kNegL2;
          }
        }
      }

      // Online softmax of rows qrow (r = 0) and qrow + 8 (r = 1); a row's 16
      // columns of this tile are spread over the 4 lanes of a quad.
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = ex2(m[r] - mx);
        m[r] = mx;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ex2(s[4 * j + 2 * r + c] - mx);
            s[4 * j + 2 * r + c] = p;
            sum += p;
          }
        }
        l[r] = l[r] * alpha[r] + sum;  // this lane's part of the row sum
      }

      // P (bf16) as the A operand: keys 16kk..16kk+15 are S's columns groups
      // 2kk and 2kk + 1, which is the A fragment's register layout.
      uint32_t p[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // O += P V: 4 steps of 16 keys (2048 B of V rows each).
      mbar_wait(full_v + 8 * st, ph);
      keep(o);
      keep(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DV>(o, p + 4 * kk, mnmajor_desc(sv + st * L::kV + kk * 2048));
      wgmma_commit();
      wgmma_wait_all();
      keep(o);
      keep(p);
      mbar_arrive(empty_v + 8 * st);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = qrow + 8 * r;
      if (row >= s_n) continue;
      if (lse != nullptr && qcol == 0) {
        lse[((long long)b * h_n + h) * s_n + row] = row_lse(m[r], sum, row, t_n, causal, window);
      }
      const float denom = fmaxf(sum, 1e-30f);
      __nv_bfloat16* dst = out + (((long long)b * s_n + row) * h_n + h) * DV + qcol;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    }
  }
}

template <int DH, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                 int s, int t, int h, int kvh, float scale, float softcap, int causal, int window,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, DH, h, s, b);
  if (err == 0) err = encode_map(&tk, k, DH, kvh, t, b);
  if (err == 0) err = encode_map(&tv, v, DV, kvh, t, b);
  if (err != 0) return err;
  constexpr int smem = wgmma_smem_bytes(DH, DV);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma<DH, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (long long)((s + kRows - 1) / kRows) * b * h;
  flash_wgmma<DH, DV><<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, b, s, t, h, kvh, scale, softcap,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dv(const void* q, const void* k, const void* v, void* out, float* lse, int b, int s,
              int t, int h, int kvh, int dv, float scale, float softcap, int causal, int window,
              cudaStream_t stream) {
  switch (dv) {
    case 64:
      return launch_wgmma<DH, 64>(q, k, v, out, lse, b, s, t, h, kvh, scale, softcap, causal,
                                  window, stream);
    case 128:
      return launch_wgmma<DH, 128>(q, k, v, out, lse, b, s, t, h, kvh, scale, softcap, causal,
                                   window, stream);
    case 256:
      return launch_wgmma<DH, 256>(q, k, v, out, lse, b, s, t, h, kvh, scale, softcap, causal,
                                   window, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                int s, int t, int h, int kvh, int dh, int dv, float scale, float softcap,
                int causal, int window, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch_dv<64>(q, k, v, out, lse, b, s, t, h, kvh, dv, scale, softcap, causal, window,
                           stream);
    case 128:
      return launch_dv<128>(q, k, v, out, lse, b, s, t, h, kvh, dv, scale, softcap, causal, window,
                            stream);
    case 256:
      return launch_dv<256>(q, k, v, out, lse, b, s, t, h, kvh, dv, scale, softcap, causal, window,
                            stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- float32: CUDA cores -----------------------------------------------------

constexpr int kBK = 32;            // keys per tile
constexpr int kGroups = 2;         // consumer groups: 4 warps and 32 query rows each
constexpr int kGroupRows = kBQ / kGroups;
constexpr int kConsumerWarps = 4 * kGroups;
constexpr int kF32Threads = 32 * kConsumerWarps + 128;  // and a producer warpgroup
constexpr int kLdp = kGroupRows + 4;  // row pitch of a group's transposed p tile

// Row pitch of a staged K tile: at least dh and 16 mod 32 words, so the 8
// keys a warp reads at once fall in alternate halves of the banks.
__host__ __device__ __forceinline__ int f32_ldk(int dh) { return dh + (48 - dh % 32) % 32; }

// cp.async of one 16-byte chunk; `valid` false fills the destination with
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Rows [0, rows) of width `width` from a strided source into a tile of row
// pitch `ld`, by warps `warp`, `warp + warps`, ... a row each, lanes along
// it; rows at or past `valid` are zero.  Row 0 of `src` is in bounds.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long stride, int rows, int valid, int width,
                                          int warp, int warps) {
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += warps) {
    const bool ok = r < valid;
    const float* s = ok ? src + r * stride : src;
    for (int c = 4 * lane; c < width; c += 128) cp_async16(dst + r * ld + c, s + c, ok);
  }
}

// Named barrier of one consumer group's 128 threads (id 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
}

__global__ void __launch_bounds__(kF32Threads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
             int b_n, int s_n, int t_n,
             int h_n, int kvh_n, int dh, int dv, float score_mul, float cap_mul, int softcapped,
             int causal, int window) {
  extern __shared__ float4 smem4[];
  const int ldk = f32_ldk(dh);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);  // full K, full V, empty K, empty V x 2
  float* qs = reinterpret_cast<float*>(bars + 8);  // (kBQ, dh)
  float* ks = qs + kBQ * dh;                       // 2 stages of (kBK, ldk)
  float* vs = ks + 2 * kBK * ldk;                  // 2 stages of (kBK, dv)
  float* ps = vs + 2 * kBK * dv;                   // per group 2 of (kBK, kLdp): p, key-major
  float* al = ps + kGroups * 2 * kBK * kLdp;       // per group 2 of (kGroupRows): rescale
  float* ls = al + kGroups * 2 * kGroupRows;       // (kBQ): each row's final sum
  const uint32_t full_k = smem_u32(bars), full_v = full_k + 16, empty_k = full_k + 32,
                 empty_v = full_k + 48;

  const int n_qb = (s_n + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (b_n * h_n);
  const int qb = n_qb - 1 - blockIdx.x / (b_n * h_n);  // heaviest blocks first
  const int b = bh / h_n, h = bh % h_n;
  const int kvh = h / (h_n / kvh_n);
  const int row0 = qb * kBQ;
  const int row_last = min(row0 + kBQ, s_n) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tiles tl = key_tiles<kBK>(row0, row_last, t_n, causal, window);
  const int n_tiles = tl.end - tl.first;
  const long long q_stride = (long long)h_n * dh;

  if (threadIdx.x == 0) {
    for (int st = 0; st < 2; ++st) {
      mbar_init(full_k + 8 * st, 128);  // the producer's threads, as their copies land
      mbar_init(full_v + 8 * st, 128);
      mbar_init(empty_k + 8 * st, kConsumerWarps);  // a consumer warp each, when done
      mbar_init(empty_v + 8 * st, kConsumerWarps);
    }
  }
  load_rows(qs, dh, q + ((long long)b * s_n + row0) * q_stride + (long long)h * dh, q_stride,
            kBQ, s_n - row0, dh, warp, kF32Threads / 32);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer: K j and V j into stage j % 2
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pw = warp - kConsumerWarps;
    const long long k_stride = (long long)kvh_n * dh, v_stride = (long long)kvh_n * dv;
    const float* kb = k + (long long)b * t_n * k_stride + (long long)kvh * dh;
    const float* vb = v + (long long)b * t_n * v_stride + (long long)kvh * dv;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j & 1, k0 = (tl.first + j) * kBK;
      if (j >= 2) mbar_wait(empty_k + 8 * st, ((j - 2) >> 1) & 1);
      load_rows(ks + st * kBK * ldk, ldk, kb + k0 * k_stride, k_stride, kBK, t_n - k0, dh, pw, 4);
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(full_k + 8 * st)
                   : "memory");
      if (j >= 2) mbar_wait(empty_v + 8 * st, ((j - 2) >> 1) & 1);
      load_rows(vs + st * kBK * dv, dv, vb + k0 * v_stride, v_stride, kBK, t_n - k0, dv, pw, 4);
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(full_v + 8 * st)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // A consumer group: 4 warps, query rows 32 grp .. 32 grp + 31.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int grp = warp >> 2, gw = warp & 3;
  const int sl = lane & 3, g = lane >> 2;  // score roles: d slice, key group
  const int pa = lane >> 3, pb = 8 * gw + (lane & 7);  // P V roles
  const bool lo_ok = 4 * pb < dv, hi_ok = 128 + 4 * pb < dv;
  const float* qg = qs + kGroupRows * grp * dh;
  float* pg = ps + grp * 2 * kBK * kLdp;
  float* ag = al + grp * 2 * kGroupRows;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  float m2[2] = {kNegL2, kNegL2}, lsum[2] = {0.0f, 0.0f};
  const int nch = dh >> 2;
  // Group 1 starts once group 0 has its first scores, so that each group's
  // softmax, barrier and waits fall in the other's products.
  if (grp == 1) asm volatile("bar.sync 3, 256;\n" ::: "memory");

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, k0 = (tl.first + j) * kBK;
    const float* kt = ks + st * kBK * ldk;
    float* pt = pg + (j & 1) * kBK * kLdp;
    float* alp = ag + (j & 1) * kGroupRows;

    // Partial scores of the group's rows gw + 4i against keys g + 8t over d
    // slice sl.
    mbar_wait(full_k + 8 * st, (j >> 1) & 1);
    float sp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) sp[i][t] = 0.0f;
#pragma unroll 2
    for (int c = sl; c < nch; c += 4) {
      float4 kf[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        kf[t] = *reinterpret_cast<const float4*>(kt + (g + 8 * t) * ldk + 4 * c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(qg + (gw + 4 * i) * dh + 4 * c);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          sp[i][t] = fmaf(qf.x, kf[t].x, sp[i][t]);
          sp[i][t] = fmaf(qf.y, kf[t].y, sp[i][t]);
          sp[i][t] = fmaf(qf.z, kf[t].z, sp[i][t]);
          sp[i][t] = fmaf(qf.w, kf[t].w, sp[i][t]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_k + 8 * st);
    if (grp == 0 && j == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    // Sum the 4 slices, halving twice: keep rows 4 b1 .. (lane bit 1), then
    // 2 b0 .. of those (lane bit 0), so this lane keeps rows i = 2 sl, 2 sl + 1.
    float hf[4][4], f[2][4];
    const bool b1 = lane & 2, b0 = lane & 1;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float send = b1 ? sp[r][t] : sp[4 + r][t];
        hf[r][t] = (b1 ? sp[4 + r][t] : sp[r][t]) + __shfl_xor_sync(0xffffffffu, send, 2);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float send = b0 ? hf[r][t] : hf[2 + r][t];
        f[r][t] = (b0 ? hf[2 + r][t] : hf[r][t]) + __shfl_xor_sync(0xffffffffu, send, 1);
      }

    // The online softmax of the group's rows gw + 8 sl + 4u, in base 2.
    const bool masked = tile_masked<kBK>(tl, k0, row0, row_last, t_n, causal, window);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = gw + 8 * sl + 4 * u;
      const int qpos = row0 + kGroupRows * grp + row;
      float x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float y = f[u][t] * score_mul;
        if (softcapped) y = fmaf(-2.0f, __fdividef(1.0f, 1.0f + exp2f(y)), 1.0f) * cap_mul;
        if (masked) {
          const int kpos = k0 + g + 8 * t;
          if (causal && (kpos > qpos || qpos - kpos >= window)) y = kNegL2;
          if (kpos >= t_n) y = -INFINITY;
        }
        x[t] = y;
      }
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m2[u], mx);
      const float alpha = exp2f(m2[u] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float p = exp2f(x[t] - m_new);
        sum += p;
        pt[(g + 8 * t) * kLdp + row] = p;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      lsum[u] = lsum[u] * alpha + sum;
      m2[u] = m_new;
      if (g == 0) {
        alp[row] = alpha;
        if (j == n_tiles - 1) {
          ls[kGroupRows * grp + row] = lsum[u];
          if (lse != nullptr && qpos < s_n) {
            lse[((long long)b * h_n + h) * s_n + qpos] =
                row_lse(m2[u], lsum[u], qpos, t_n, causal, window);
          }
        }
      }
    }
    // p j is written; the group's P V of tile j - 1 is done.
    group_sync(grp);

    // acc = acc * alpha + p . V
    const float* vt = vs + st * kBK * dv;
    const float4 a0 = *reinterpret_cast<const float4*>(alp + 4 * pa);
    const float4 a1 = *reinterpret_cast<const float4*>(alp + 16 + 4 * pa);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= ar[r];
    mbar_wait(full_v + 8 * st, (j >> 1) & 1);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(pt + kk * kLdp + 4 * pa);
      const float4 p1 = *reinterpret_cast<const float4*>(pt + kk * kLdp + 16 + 4 * pa);
      const float4 v0 = lo_ok ? *reinterpret_cast<const float4*>(vt + kk * dv + 4 * pb)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 v1 = hi_ok ? *reinterpret_cast<const float4*>(vt + kk * dv + 128 + 4 * pb)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float vc[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(pr[r], vc[c], acc[r][c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_v + 8 * st);
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = kGroupRows * grp + (r < 4 ? 4 * pa : 16 + 4 * pa) + (r & 3);
    if (row0 + row >= s_n) continue;
    const float denom = fmaxf(ls[row], 1e-30f);
    float* o = out + (((long long)b * s_n + row0 + row) * h_n + h) * dv + 4 * pb;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? hi_ok : lo_ok)) continue;
      float y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c] = acc[r][4 * half + c] / denom;
      *reinterpret_cast<float4*>(o + 128 * half) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

size_t f32_smem_bytes(int dh, int dv) {
  return 8 * sizeof(uint64_t) +
         sizeof(float) * ((size_t)kBQ * dh + 2 * kBK * (size_t)(f32_ldk(dh) + dv) +
                          kGroups * 2 * (kBK * kLdp + kGroupRows) + kBQ);
}

int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int b, int s,
               int t, int h, int kvh, int dh, int dv, float scale, float softcap, int causal,
               int window, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(dh, dv);
  cudaError_t err =
      cudaFuncSetAttribute(flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Scores times score_mul are base 2; with a softcap they are first
  // 2 x / softcap in base 2, and the tanh comes back times softcap log2(e).
  const bool capped = softcap > 0.0f;
  const float score_mul = capped ? 2.0f * kLog2e * scale / softcap : scale * kLog2e;
  const long long blocks = (long long)((s + kBQ - 1) / kBQ) * b * h;
  flash_kernel<<<(unsigned)blocks, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, b, s, t, h, kvh, dh, dv, score_mul, softcap * kLog2e,
      (int)capped, causal, window);
  return static_cast<int>(cudaGetLastError());
}

bool wgmma_width(int d) { return d == 64 || d == 128 || d == 256; }

}  // namespace

// Launches on `stream`.  `is_bf16` picks bfloat16 (1, the tensor-core kernel)
// or float32 (0, the CUDA-core kernel) for q, k, v and out.  `lse`, when not
// null, is float32 (B, H, S): each row's log-sum-exp (row_lse); a null
// pointer stores nothing.  `window` <= 0
// means no window.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take: any size below
// 1, H not a multiple of KVH, T within 64 of INT_MAX, a pointer not 16-byte
// aligned (TMA's rule in bfloat16, the 16-byte copies and stores in
// float32); in float32 dh or dv above 256 or not a multiple of 4; in
// bfloat16 dh or dv outside {64, 128, 256}.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int is_bf16, int b, int s, int t, int h, int kvh,
                                 int dh, int dv, float scale, float softcap, int causal, int window,
                                 cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
                        15) == 0;
  if (b < 1 || s < 1 || t < 1 || h < 1 || kvh < 1 || h % kvh || dh < 4 || dv < 4 ||
      dh > kMaxDim || dv > kMaxDim || dh % 4 || dv % 4 || t > INT_MAX - kKeys ||
      (long long)((s + kBQ - 1) / kBQ) * b * h > INT_MAX || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (window <= 0) window = INT_MAX;
  float* lse_f = static_cast<float*>(lse);
  if (is_bf16) {
    if (!wgmma_width(dh) || !wgmma_width(dv)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_bf16(q, k, v, out, lse_f, b, s, t, h, kvh, dh, dv, scale, softcap, causal,
                       window, stream);
  }
  return launch_f32(q, k, v, out, lse_f, b, s, t, h, kvh, dh, dv, scale, softcap, causal, window,
                    stream);
}

// Dynamic shared memory of one block of the kernel that flash_attn_launch
// picks for this type and these widths, in bytes; -1 for widths it refuses.
extern "C" int flash_attn_smem_bytes(int is_bf16, int dh, int dv) {
  if (is_bf16) {
    if (!wgmma_width(dh) || !wgmma_width(dv)) return -1;
    return wgmma_smem_bytes(dh, dv);
  }
  if (dh < 4 || dv < 4 || dh > kMaxDim || dv > kMaxDim || dh % 4 || dv % 4) return -1;
  return (int)f32_smem_bytes(dh, dv);
}
