// CARE-biased top-k MoE routing for Hopper (sm_90a): route, count and place
// every (token, slot) in its expert's capacity buffer in one launch.
//
// Replaces the Pallas TPU kernel moe_route_pallas
// (repro/kernels/moe_route.py:89, body _moe_route_kernel) and the capacity
// positions the reference computes around it (repro/models/ffn.py:110-114:
// an exclusive cumsum of the (T k, E) one-hot).  Per token (one row of the
// (T, E) logits): gates are softmax(logits) = exp(z - max) / sum or
// sigmoid(logits) = 1 / (1 + exp(-x)), in float32; the selection score is
// logits - bias; k sweeps each take the argmax of the score (the lowest
// index wins ties) and set it to -1e30, so a later sweep takes it again when
// every other score is lower; the weight of a chosen expert is its unbiased
// gate, the k weights divided by (their sum + 1e-20).  counts[e] is the
// number of (token, sweep) pairs that chose e, and pos[j], for flat entry
// j = t k + i, the number of entries j' < j with the same expert.  Ids,
// counts and positions are exact.
//
// What bounds it on this card: latency.  At the DeepSeek-V2 prefill shape
// (T = 2048, E = 160, k = 6, float32 logits) the call moves 1.5 MB, 0.45 us
// at 3.35 TB/s, and does ~7e6 operations, 0.21 us; an empty kernel alone
// takes ~1.8 us with the queue filled on an H100 SXM at 700 W
// (chip_smoke.py phase 7 prints both beside this kernel).  What costs is a
// chain of dependent steps: a token's loads, k warp reductions, and the
// exchange of counts between CTAs.  So the design spends no second launch
// (no zero fill of counts, no position pass) and keeps that chain short.
//
// Design:
// - Tiling.  One CTA an SM (its shared memory takes more than half of one),
//   16-32 warps a CTA, a token a warp while the tokens fit
//   (kernels/moe_route.moe_tiling); CTAs in clusters of up to kCluster,
//   launched cooperatively, so every CTA is resident at once.
// - Route.  A warp routes its tokens one at a time, the next row's loads
//   issued before the current row is routed.  The row is staged through
//   shared memory (one pad word every 32, so neither the coalesced store
//   nor the range reads conflict) and lane l reads its contiguous experts
//   [l kC, (l + 1) kC), kC = ceil(E / 32), a template argument.  A lane keeps
//   its best remaining score as an order-preserving uint32 key (-0.0 folded
//   into +0.0; key 0, below every float's, for a slot past E).  A sweep is
//   __reduce_max_sync on the keys, then __reduce_min_sync on the indices of
//   the lanes holding the max: the lowest index.  Its owner masks it to
//   -1e30 and rescans its kC keys (every lane runs that code; only the
//   owner's changes).  Gates are computed after the sweeps for the k chosen
//   experts only; the softmax normaliser, which cancels out of the weights
//   but for their 1e-20, is summed with ex2.approx in fixed point.
// - Rank within the CTA.  A warp's tokens are contiguous in flat order.
//   Each chunk of <= 32 slots of a token is ranked with __match_any_sync and
//   __popc(peers & lanemask_lt) on top of the warp's running histogram in
//   shared memory, which the group's lowest lane then advances (no atomics,
//   so no order taken from them).  A thread an expert scans the warps'
//   histograms into each warp's offset and the CTA's count.
// - Prefix within the cluster.  Each CTA pushes its counts to every CTA of
//   its cluster with st.async, which completes bytes on the receiver's
//   mbarrier: no fence and no cluster-wide barrier on the way.  Each CTA
//   then has its prefix and the cluster's count.
// - Prefix across clusters, in the same launch.  CTA r of a cluster
//   publishes the cluster's counts of experts r, r + csize, ... as 64-bit
//   words (generation, count), then sums, a warp an expert and a lane a
//   cluster, the words of every cluster before its own, reading a word again
//   (after a short back-off) until it carries this call's generation.  Every
//   cluster publishes before it waits and every CTA is resident, so the
//   waits end; the word holds its value, so no fence is needed.  The sums
//   are pushed to the cluster's CTAs like the counts.
// - Scratch.  The (E, max_clusters) words live across calls, zeroed once
//   when the wrapper allocates them; each call passes a new generation
//   number >= 1 (the wrapper keeps one scratch and counter a stream), so
//   nothing is reset and no call reads another call's word.
// - counts is the last CTA's prefix plus its cluster's count, written once.
//   The last chunk of slots of a warp keeps its id, weight and rank in
//   registers until its position is known, then stores all three.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

constexpr int kMaxExperts = 256;
constexpr int kMaxC = kMaxExperts / 32;     // experts a lane owns at most
constexpr int kMaxWarps = 32;               // warps a CTA at most (MOE_MAX_WARPS)
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMinWarps = 16;               // warps a CTA at least (MOE_MIN_WARPS)
constexpr int kCluster = 8;                 // CTAs a cluster at most (MOE_CLUSTER)
constexpr int kLook = kMaxExperts / (kCluster * kMinWarps);  // look-backs a warp
constexpr int kRowWords = kMaxExperts + kMaxExperts / 32;
// Dynamic shared memory of a CTA: a staged row and a histogram a warp
// (66.5 KB for kMaxWarps warps), rounded up past half of the SM's 228 KB so
// that two CTAs never share an SM.
constexpr int kSmem = 116 * 1024;
static_assert(kMaxWarps * (kRowWords + kMaxExperts) * 4 <= kSmem, "arrays past kSmem");
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ unsigned float_key(float x) {
  const unsigned b = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float load_logit(const void* logits, long long i, int is_bf16) {
  if (is_bf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(logits)[i]);
  return static_cast<const float*>(logits)[i];
}

// Element lane + 32 m of row `tok`, for m < kC (coalesced).
template <int kC>
__device__ __forceinline__ void load_row(float (&v)[kC], const void* logits, int is_bf16,
                                         long long tok, int e, int lane) {
#pragma unroll
  for (int m = 0; m < kC; ++m) {
    const int i = lane + 32 * m;
    v[m] = i < e ? load_logit(logits, tok * e + i, is_bf16) : 0.0f;
  }
}

__device__ __forceinline__ unsigned long long word(unsigned gen, int value) {
  return (static_cast<unsigned long long>(gen) << 32) | static_cast<unsigned>(value);
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Shared-memory barrier for the pushes of the cluster's CTAs (one phase a
// launch): one local arrival, which also sets the bytes it waits for.
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "\t@!p bra WAIT;\n}" ::"r"(smem_addr(bar)) : "memory");
}

// Stores `value` into `slot` of the cluster's CTA `rank` and counts its 4
// bytes on that CTA's `bar` (an asynchronous store: no fence, no barrier).
__device__ __forceinline__ void push(const int* slot, int value, unsigned long long* bar,
                                     int rank) {
  unsigned dst, dst_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst) : "r"(smem_addr(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst_bar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(dst), "r"(value), "r"(dst_bar) : "memory");
}

// This lane's best remaining key over its slots, the lowest index among
// equals, as (key, expert index); slots past E hold key 0 and never win.
template <int kC>
__device__ __forceinline__ void lane_best(const unsigned (&key)[kC], int lo, unsigned& best,
                                          int& best_x) {
  best = key[0];
  best_x = lo;
#pragma unroll
  for (int j = 1; j < kC; ++j) {
    best_x = key[j] > best ? lo + j : best_x;
    best = max(best, key[j]);
  }
}

// kC = ceil(E / 32): the experts a lane owns.
template <int kC>
__global__ void __launch_bounds__(kMaxThreads, 1)
moe_route_kernel(const void* logits, int is_bf16, const float* bias, int* idx,
                 float* weights, int* counts, int* pos, unsigned long long* flags,
                 int flag_stride, unsigned gen, int t, int e, int k, int softmax,
                 int per_warp) {
  extern __shared__ int smem[];
  float* rows = reinterpret_cast<float*>(smem);  // [kMaxWarps][kRowWords]
  int* hist = smem + kMaxWarps * kRowWords;      // [kMaxWarps][kMaxExperts]: counts, then offsets
  __shared__ int peer_count[kCluster][kMaxExperts];  // pushed: the cluster's block counts
  __shared__ int cluster_base[kMaxExperts];  // pushed: the clusters' prefix
  __shared__ int block_base[kMaxExperts];
  __shared__ __align__(8) unsigned long long bars[2];
  // The barriers the cluster's CTAs push into, ready before any of them
  // leaves the cluster barrier below.
  if (threadIdx.x == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int lo = lane * kC;
  int* h = hist + w * kMaxExperts;
  float* row = rows + w * kRowWords;

  const long long tok0 = (static_cast<long long>(blockIdx.x) * nw + w) * per_warp;
  const long long tok_end = min(tok0 + per_warp, static_cast<long long>(t));
  float nxt[kC];
  if (tok0 < tok_end) load_row(nxt, logits, is_bf16, tok0, e, lane);
  float bias_r[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) bias_r[j] = lo + j < e ? bias[lo + j] : 0.0f;
  for (int x = lane; x < e; x += 32) h[x] = 0;
  const unsigned masked = float_key(kNeg);

  // The warp's last chunk of slots stays in registers for the final pass.
  int my_x = 0, my_rank = 0;
  float my_g = 0.0f;
  long long my_j = -1;
  for (long long tok = tok0; tok < tok_end; ++tok) {
    __syncwarp();  // the row buffer is free (and h zeroed)
#pragma unroll
    for (int m = 0; m < kC; ++m) {
      if (lane + 32 * m < e) row[lane + 33 * m] = nxt[m];
    }
    __syncwarp();
    if (tok + 1 < tok_end) load_row(nxt, logits, is_bf16, tok + 1, e, lane);
    // A slot past E reads a word of the buffer that holds no logit
    // (lo + j + (lo + j) / 32 < kRowWords) and drops it.
    float z[kC];
    unsigned key[kC];
    float zmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int ex = lo + j;
      const float v = row[ex + (ex >> 5)];
      z[j] = ex < e ? v : -INFINITY;
      key[j] = ex < e ? float_key(v - bias_r[j]) : 0u;
      zmax = fmaxf(zmax, z[j]);
    }
    unsigned best;
    int best_x;
    lane_best(key, lo, best, best_x);
    // The softmax's max and normaliser.  The normaliser cancels out of the
    // weights but for the 1e-20 of their denominator, so ex2.approx and a
    // sum in fixed point (2^-22, one integer reduction) serve.
    float m = 0.0f, inv_s = 0.0f;
    if (softmax) {
      m = key_float(__reduce_max_sync(kFull, float_key(zmax)));
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kC; ++j) s += __expf(z[j] - m);  // exp(-inf) = 0
      const unsigned fixed = __reduce_add_sync(kFull, __float2uint_rn(s * 4194304.0f));
      inv_s = 4194304.0f / static_cast<float>(fixed);
    }

    const long long row0 = tok * k;
    float w_sum = 0.0f;
    for (int c0 = 0; c0 < k; c0 += 32) {
      // Sweeps c0 .. c0 + 31: the lowest index of the max key, to every
      // lane; its owner masks it and takes its next best.
      const int n = min(32, k - c0);
      for (int i = 0; i < n; ++i) {
        const unsigned top = __reduce_max_sync(kFull, best);
        const int x = static_cast<int>(
            __reduce_min_sync(kFull, best == top ? static_cast<unsigned>(best_x) : kFull));
        // Only the owner holds x; every lane runs the same code, no branch.
#pragma unroll
        for (int j = 0; j < kC; ++j) key[j] = lo + j == x ? masked : key[j];
        lane_best(key, lo, best, best_x);
        my_x = i == lane ? x : my_x;
      }
      // Slot c0 + lane: its gate, and its rank among the warp's slots.
      const bool live = lane < n;
      float g = 0.0f;
      if (live) {
        const float z = row[my_x + (my_x >> 5)];
        g = softmax ? expf(z - m) * inv_s : 1.0f / (1.0f + expf(-z));
      }
      my_g = g;
      w_sum += warp_sum(g);
      const unsigned peers = __match_any_sync(kFull, live ? static_cast<unsigned>(my_x) : kFull);
      const int rank = live ? h[my_x] + __popc(peers & lt) : 0;
      __syncwarp();
      if (live && __ffs(peers) - 1 == lane) h[my_x] += __popc(peers);
      __syncwarp();
      my_j = live ? row0 + c0 + lane : -1;
      my_rank = rank;
      if (live && c0 + 32 < k) {  // not the last chunk: normalised and placed below
        idx[my_j] = my_x;
        weights[my_j] = g;
        pos[my_j] = rank;
      }
    }
    const float denom = w_sum + 1e-20f;
    my_g /= denom;
    for (int s = lane; s < ((k - 1) & ~31); s += 32) weights[row0 + s] /= denom;
    // Every slot but the warp's last chunk holds its rank in the warp in pos;
    // the last chunk's three outputs wait in registers for the final pass.
    if (tok + 1 < tok_end && my_j >= 0) {
      idx[my_j] = my_x;
      weights[my_j] = my_g;
      pos[my_j] = my_rank;
    }
  }
  __syncthreads();

  // Each warp's offset in the CTA and the CTA's count: a thread an expert
  // scans the nw histograms.
  const int tid = threadIdx.x;
  int block_count = 0;
  if (tid < e) {
    int v[kMaxWarps];
#pragma unroll
    for (int wi = 0; wi < kMaxWarps; ++wi) v[wi] = wi < nw ? hist[wi * kMaxExperts + tid] : 0;
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < kMaxWarps; ++wi) {
      if (wi < nw) hist[wi * kMaxExperts + tid] = sum;
      sum += v[wi];
    }
    block_count = sum;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int cl = blockIdx.x / csize;
  // Every CTA of the cluster has started and set up its barriers.
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (gridDim.x == 1) {  // one CTA: its counts are the prefix sums' end
    if (tid < e) {
      block_base[tid] = 0;
      counts[tid] = block_count;
    }
  } else {
    // Inside the cluster: every CTA pushes its counts to all, then takes its
    // prefix and the cluster's count from them.
    if (tid == 0) bar_expect(&bars[0], 4u * csize * e);
    if (tid < e) {
      for (int r = 0; r < csize; ++r) push(&peer_count[rank][tid], block_count, &bars[0], r);
    }
    bar_wait(&bars[0]);
    int cta_base = 0, cluster_total = 0;
    if (tid < e) {
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const int v = r < csize ? peer_count[r][tid] : 0;
        cta_base += r < rank ? v : 0;
        cluster_total += v;
      }
    }
    // Across clusters: CTA `rank` publishes the cluster's counts of experts
    // rank, rank + csize, ..., then sums, a warp an expert and a lane a
    // cluster, the counts of every cluster before this one.  A warp's experts
    // (at most kLook in clusters of kCluster CTAs of >= kMinWarps warps) are
    // read at once, then each word not yet written is read again; the sums
    // are pushed to every CTA of the cluster.
    if (tid < e && tid % csize == rank) {
      publish(flags + static_cast<long long>(tid) * flag_stride + cl, word(gen, cluster_total));
    }
    if (tid == 0) bar_expect(&bars[1], 4u * e);
    const int step = nw * csize;
    for (int ex0 = rank + w * csize; ex0 < e; ex0 += kLook * step) {
      unsigned sum[kLook];
#pragma unroll
      for (int q = 0; q < kLook; ++q) sum[q] = 0;
      for (int p0 = 0; p0 < cl; p0 += 32) {
        const bool mine = p0 + lane < cl;
        unsigned long long v[kLook];
#pragma unroll
        for (int q = 0; q < kLook; ++q) {
          const int ex = ex0 + q * step;
          v[q] = ex < e && mine ? peek(flags + static_cast<long long>(ex) * flag_stride + p0 + lane)
                                : word(gen, 0);
        }
#pragma unroll
        for (int q = 0; q < kLook; ++q) {
          const int ex = ex0 + q * step;
          if (ex < e) {
            while (static_cast<unsigned>(v[q] >> 32) != gen) {
              __nanosleep(64);  // back off: every CTA after this one reads these words
              v[q] = peek(flags + static_cast<long long>(ex) * flag_stride + p0 + lane);
            }
            sum[q] += __reduce_add_sync(kFull, static_cast<unsigned>(v[q]));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        const int ex = ex0 + q * step;
        if (ex < e && lane < csize) {
          push(&cluster_base[ex], static_cast<int>(sum[q]), &bars[1], lane);
        }
      }
    }
    bar_wait(&bars[1]);
    if (tid < e) {
      block_base[tid] = cluster_base[tid] + cta_base;
      if (blockIdx.x == gridDim.x - 1) counts[tid] = cluster_base[tid] + cluster_total;
    }
  }
  __syncthreads();

  // Positions: the CTA's prefix + the warp's offset + the rank in the warp.
  if (tok0 < tok_end) {
    const long long last_chunk = (tok_end - 1) * k + ((k - 1) & ~31);
    for (long long j = tok0 * k + lane; j < last_chunk; j += 32) {
      const int x = idx[j];
      pos[j] += block_base[x] + h[x];
    }
    if (my_j >= 0) {
      idx[my_j] = my_x;
      weights[my_j] = my_g;
      pos[my_j] = block_base[my_x] + h[my_x] + my_rank;
    }
  }
}

__global__ void empty_kernel() {}

using Kernel = void (*)(const void*, int, const float*, int*, float*, int*, int*,
                        unsigned long long*, int, unsigned, int, int, int, int, int);
// The instance for E experts is kKernels[(E + 31) / 32 - 1].
static const Kernel kKernels[kMaxC] = {
    moe_route_kernel<1>, moe_route_kernel<2>, moe_route_kernel<3>, moe_route_kernel<4>,
    moe_route_kernel<5>, moe_route_kernel<6>, moe_route_kernel<7>, moe_route_kernel<8>};

// Clusters of kCluster CTAs every instance may hold at once on the current
// device: the flag scratch's row length.  Also lets each instance take kSmem
// of dynamic shared memory, so it must run before the first launch on a
// device.  Returns cudaGetLastError() (0 on success).
extern "C" int moe_route_max_clusters(int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim = {kCluster, 1, 1};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  *clusters = INT_MAX;
  for (Kernel kernel : kKernels) {
    int n = 0;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    *clusters = n < *clusters ? n : *clusters;
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches `blocks` CTAs of `warps` warps in clusters of `csize` (blocks a
// multiple of csize, csize <= kCluster), cooperatively (every CTA resident
// at once), each warp routing per_warp tokens, on `stream`; `flags` holds
// (E, flag_stride) words and `gen` is new for this scratch.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue on arguments
// the kernel does not take.
extern "C" int moe_route_launch(const void* logits, int is_bf16, const float* bias, int* idx,
                                float* weights, int* counts, int* pos,
                                unsigned long long* flags, int flag_stride, unsigned gen,
                                int t, int e, int k, int softmax, int per_warp, int warps,
                                int blocks, int csize, cudaStream_t stream) {
  if (e < 1 || e > kMaxExperts || k < 1 || k > e || t < 1 || per_warp < 1 || warps < 1 ||
      warps > kMaxWarps || csize < 1 || csize > kCluster || blocks < 1 || blocks % csize ||
      blocks / csize > flag_stride || gen < 1 ||
      static_cast<long long>(blocks) * warps * per_warp < t) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim = {static_cast<unsigned>(csize), 1, 1};
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaLaunchKernelEx(&cfg, kKernels[(e + 31) / 32 - 1], logits, is_bf16, bias, idx, weights,
                     counts, pos, flags, flag_stride, gen, t, e, k, softmax, per_warp);
  return static_cast<int>(cudaGetLastError());
}

// One empty block: the launch floor chip_smoke.py times beside the kernel.
extern "C" int moe_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
