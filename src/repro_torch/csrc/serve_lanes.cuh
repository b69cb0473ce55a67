// One serving slot's lane chain on one warp, for Hopper (sm_90a).
//
// Shared by serve_route_kernel (one slot) and serve_slots_kernel (the whole
// slot loop) in serve_route.cu.  The lanes of a slot form a chain: each goes
// to the lowest-index argmin of the replicas' f32 scores, and an admitted
// lane bumps its replica's score before the next lane looks.  A block-wide
// argmin per lane costs two block barriers and a third for the update; here
// one warp runs the whole chain and needs no barrier at all.
//
// - Keys.  A score becomes an order-preserving uint32 (score_key): -0.0 is
//   folded into +0.0 first, since argmin treats them as equal and breaks
//   their tie by index, then positive floats get the sign bit set and
//   negative floats are inverted.  Rows hold no NaN.  kNoKey (all ones, above
//   the key of +inf) marks an entry or a lane that holds no replica.
// - Ownership.  The replicas are cut into sub-blocks of 32; warp lane l owns
//   the contiguous, ascending sub-blocks [l * spl, (l + 1) * spl), spl =
//   ceil(ceil(R / 32) / 32), and keeps the least (key, index) of its range in
//   registers, the earliest index winning its own ties.  A lane may own
//   nothing.  Each sub-block's least (key, index) lives in shared memory.
// - Per routed lane.  __reduce_min_sync gives the least key; the lowest lane
//   of __ballot_sync(key == min) owns the lowest global index holding it,
//   since ranges are contiguous and ascending: jnp.argmin's tie order.
//   Every lane applies the admit or drop alike (no divergent step), then the
//   warp rescans the replica's sub-block, one entry a lane (32 entries),
//   and, when a lane owns more than one sub-block, the owner's spl
//   sub-block minima: a rescan reads at most 32 + ceil(R / 1024) entries.
//   The ring tail (a remainder) and the ring writes wait until the chain
//   is done.
// - After a drop.  A full ring bumps nothing, so every later live lane of
//   the slot picks the same replica and drops too: the chain stops there and
//   returns that replica, which the callers give to the rest of the lanes.
//   With no drop, the chain ends with the post-chain argmin, which is what
//   every dead lane receives.
#pragma once

#include <climits>
#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;

__device__ __forceinline__ unsigned score_key(float x) {
  const unsigned b = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One run's routing state in shared memory.  busy is read under exact only.
struct ServeRow {
  int* q_len;
  const int* q_head;
  float* approx;
  const int* busy;
  unsigned* sub_key;  // least key of each 32-replica sub-block
  int* sub_idx;       // the lowest replica holding it
  int r;
  int cap;
  bool exact;
};

__device__ __forceinline__ unsigned replica_key(const ServeRow& s, int e) {
  return score_key(s.exact ? static_cast<float>(s.q_len[e] + s.busy[e]) : s.approx[e]);
}

// Merge one key a warp lane holds for replica `e` (kNoKey if none) into the
// least (key, index) of sub-block `sb`, stored by lane 0.  The 32 lanes of
// the calling warp must hold the 32 replicas of `sb` in lane order.
__device__ __forceinline__ void store_sub_min(const ServeRow& s, int sb, unsigned key) {
  const unsigned m = __reduce_min_sync(kFullMask, key);
  const int first = __ffs(__ballot_sync(kFullMask, key == m)) - 1;
  if ((threadIdx.x & 31) == 0) {
    s.sub_key[sb] = m;
    s.sub_idx[sb] = sb * 32 + first;
  }
}

// Every sub-block's minimum from the state in shared memory; called by every
// thread of the block (blockDim.x a multiple of 32), a barrier after it.
__device__ __forceinline__ void serve_sub_minima(const ServeRow& s) {
  const int n_sub = (s.r + 31) >> 5;
  for (int sb = threadIdx.x >> 5; sb < n_sub; sb += blockDim.x >> 5) {
    const int e = sb * 32 + (threadIdx.x & 31);
    store_sub_min(s, sb, e < s.r ? replica_key(s, e) : kNoKey);
  }
}

// Where the chain stopped: lanes [0, stop) were admitted (their replica
// and head + len in lane_j and lane_raw); lanes [stop, n_live) all drop at
// replica j (stop == n_live: no drop); j and tail, its ring tail, are also
// what every dead lane receives.
struct ChainEnd {
  int stop;
  int j;
  int tail;
};

// The lowest-index least key over the 32 lanes' (key, idx), to every lane.
__device__ __forceinline__ int warp_argmin_idx(unsigned key, int idx) {
  const unsigned m = __reduce_min_sync(kFullMask, key);
  return __shfl_sync(kFullMask, idx, __ffs(__ballot_sync(kFullMask, key == m)) - 1);
}

// Routes lanes [0, n_live) of one slot.  Run by all 32 lanes of one warp,
// after serve_sub_minima (or an update of the sub-block minima) and a
// barrier.  Bumps q_len and approx (the same IEEE +1.0f the reference adds),
// records each admitted lane's replica and head + len in lane_j and
// lane_raw (the caller takes the ring tail, raw % cap, after the chain),
// and above R = 1024 updates the sub-block minima; the caller syncs before
// other warps read any of them.  Every lane stores the same values, so the
// chain has no divergent step.  With one sub-block a lane (R <= 1024) the
// rescan of the bumped sub-block and the next lane's argmin are one round
// of reductions: the least key is that of the rescanned sub-block or of the
// other lanes' minima, and the sub-block's indices lie between those of
// the lanes below its owner and above it.
__device__ __forceinline__ ChainEnd serve_chain(const ServeRow& s, int n_live,
                                                int* lane_j, int* lane_raw) {
  const int lane = threadIdx.x & 31;
  const int n_sub = (s.r + 31) >> 5;
  const int spl = (n_sub + 31) >> 5;
  unsigned key = kNoKey;
  int idx = INT_MAX;
  for (int i = 0; i < spl; ++i) {
    const int sb = lane * spl + i;
    if (sb < n_sub && s.sub_key[sb] < key) {
      key = s.sub_key[sb];
      idx = s.sub_idx[sb];
    }
  }
  int j = warp_argmin_idx(key, idx);
  int a = 0;
  int len;
  for (;; ++a) {
    // Every load of the step first: j's state and, one replica a lane, the
    // keys of j's sub-block.
    const int sb = j >> 5;
    const int e = (sb << 5) + lane;
    len = s.q_len[j];
    const int head = s.q_head[j];
    const float old = s.approx[j];
    const int busy_j = s.exact ? s.busy[j] : 0;
    const unsigned k_old = e < s.r ? replica_key(s, e) : kNoKey;
    if (a >= n_live || len >= s.cap) break;
    const float bumped = __fadd_rn(old, 1.0f);
    const unsigned new_key =
        score_key(s.exact ? static_cast<float>(len + 1 + busy_j) : bumped);
    const unsigned k = e == j ? new_key : k_old;
    __syncwarp();  // every lane has read q_len[j] and approx[j]
    s.q_len[j] = len + 1;
    s.approx[j] = bumped;
    lane_j[a] = j;
    lane_raw[a] = head + len;
    const int owner = sb / spl;
    if (spl == 1) {
      const unsigned others = lane == owner ? kNoKey : key;
      const unsigned m_sub = __reduce_min_sync(kFullMask, k);
      const unsigned m = min(m_sub, __reduce_min_sync(kFullMask, others));
      const unsigned b_others = __ballot_sync(kFullMask, others == m);
      const unsigned b_below = b_others & ((1u << owner) - 1u);
      const unsigned b_sub = __ballot_sync(kFullMask, k == m);
      const int sub_min = (sb << 5) + __ffs(__ballot_sync(kFullMask, k == m_sub)) - 1;
      const int from = __shfl_sync(kFullMask, idx,
                                   __ffs(b_below != 0u ? b_below : b_others) - 1);
      j = (b_below == 0u && b_sub != 0u) ? (sb << 5) + __ffs(b_sub) - 1 : from;
      if (lane == owner) {
        key = m_sub;
        idx = sub_min;
      }
    } else {
      unsigned lk = __reduce_min_sync(kFullMask, k);
      const int li = (sb << 5) + __ffs(__ballot_sync(kFullMask, k == lk)) - 1;
      // The owner's range: its spl sub-block minima, sb's the new one.
      s.sub_key[sb] = lk;
      s.sub_idx[sb] = li;
      const int sb2 = owner * spl + lane;
      unsigned k2 = kNoKey;
      int i2 = INT_MAX;
      if (lane < spl && sb2 < n_sub) {
        k2 = sb2 == sb ? lk : s.sub_key[sb2];
        i2 = sb2 == sb ? li : s.sub_idx[sb2];
      }
      lk = __reduce_min_sync(kFullMask, k2);
      const int oi = __shfl_sync(kFullMask, i2, __ffs(__ballot_sync(kFullMask, k2 == lk)) - 1);
      if (lane == owner) {
        key = lk;
        idx = oi;
      }
      j = warp_argmin_idx(key, idx);
    }
    __syncwarp();  // this lane's writes are seen by the next lane's reads
  }
  return ChainEnd{a, j, (s.q_head[j] + len) % s.cap};
}
