// The serving tier's lane routing and its whole slot loop, for Hopper (sm_90a).
//
// serve_route_kernel replaces the Pallas TPU kernel serve_route_pallas
// (repro/kernels/jsaq_route.py, body _serve_kernel): one serving slot's
// arrival lanes for each run (one row of the (D, R) state).  Lane a < A is
// live when act && a < n_arr; it goes to the lowest-index argmin of the f32
// score (approx, or float(q_len + busy) under comm "exact"), is admitted when
// that replica's pending ring holds fewer than cap requests, and takes the
// ring slot tail = (q_head[j] + q_len[j]) % cap.  An admitted lane bumps
// q_len[j] by one and approx[j] by the same IEEE +1.0f the reference adds,
// so the next lane sees it.  jv and tail are written for every lane, dead
// lanes included, as the reference writes them.
//
// serve_slots_kernel runs the body of the serving engine's slot loop
// (repro_torch/serve/engine.py, _serve_core) for slots [t0, t0 + t_end) of
// every run, where the JAX package runs serve_route_pallas inside one
// lax.scan: per slot the lane chain, the ring writes, FIFO admission into
// free decode slots, decode (one unit, or the credit schedule's units),
// completions, the MSR drain, the rt/dt/et/et_rt/exact/none trigger and its
// snap, and the occupancy row.  The fixed horizon starts from an empty
// engine at slot 0 and scatters each completion's slot by request id.
// Stream mode (serve_stream's chunk step, the reference's donated scan
// carry) resumes from the carry, stores each lane's arrival slot in its
// ring entry, folds each slot's completions past the warmup into the
// streaming JCT accumulators (Chan's combine in f32, in the reference's
// order of operations; the JCT histogram in shared memory), and writes the
// carry back in place.
//
// What bounds them on this card.  The lanes of a slot form a dependent chain
// (each argmin reads the state the previous lane bumped), and the slots of
// a run form another.  Both kernels sit far above their bytes and operations
// bounds; what sets their time is the latency of one routed lane and, for
// serve_slots, of one slot's replica stage.  A routed lane was three block
// barriers (~0.8 us); a slot of the loop was ~77 PyTorch operations issued
// by the host.
//
// The fold of a slot costs one pass over the completions (count, exact
// integer JCT sum, maximum, histogram) in the replica stage, then, after
// the slot's barrier, a second pass over the replicas holding measured
// completions for the squared deviations from the batch mean, summed per
// warp in a fixed order; thread 0 combines them into the running mean and
// m2 during the next slot's replica stage, so no barrier is added.
//
// Design.  One block per run, the run's state in shared memory.  The chain
// runs on one warp with no barrier between lanes (serve_lanes.cuh): warp
// reductions over the lanes' minima, and a rescan of one 32-replica
// sub-block; the lanes' outputs are written after it, in parallel.
// serve_slots keeps the whole slot loop in one launch: per slot, warp 0
// runs the chain and then writes the admitted lanes' work and rid into the
// rings, one barrier, then every thread runs the replica stage for its
// replicas (one a thread up to 1024) and the warps rebuild the sub-block
// minima for the next slot's chain, one barrier.  The next slot's lanes are
// loaded during the replica stage.  A field lives in shared memory only
// where the kind reads it (deps under dt, the slot counter under rt and
// et_rt, the rates under use_rates; in stream mode both counters, which
// the carry holds), and rem and arid ((S, R) each) join it
// when they fit, else they stay in device scratch; the rings (R, cap) stay
// in device scratch (L2).  A ring entry is read only after the chain wrote
// it: admission reads entries head .. head + n_admit - 1 with n_admit <=
// q_len, all written by the lanes that raised q_len.  Float arithmetic uses
// the _rn intrinsics, so nvcc contracts nothing into an FMA and each
// operation rounds as PyTorch's does.
#include <cuda_runtime.h>

#include "serve_lanes.cuh"

constexpr int kMaxReplicas = 8192;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448 - 1024;  // Hopper's opt-in, less static shared memory

// The trigger kinds, in the order of ref.CARE_COMMS.
enum Comm { kRt = 0, kDt = 1, kEt = 2, kEtRt = 3, kExact = 4, kNone = 5 };

__global__ void __launch_bounds__(1024)
serve_route_kernel(const int* q_len_in, const int* q_head_in, const int* busy_in,
                   const float* approx_in, const int* n_arr, const bool* act,
                   int* jv, int* tail, bool* admit, int* q_len_out,
                   float* approx_out, int* drops_out, int a_n, int r, int cap,
                   int exact) {
  extern __shared__ int smem[];
  const int n_sub = (r + 31) >> 5;
  int* q_head = smem + r;
  int* busy = smem + 3 * r;
  ServeRow row{smem, q_head, reinterpret_cast<float*>(smem + 2 * r), busy,
               reinterpret_cast<unsigned*>(smem + 4 * r), smem + 4 * r + n_sub, r,
               cap, exact != 0};
  int* lane_j = smem + 4 * r + 2 * n_sub;
  int* lane_raw = lane_j + a_n;
  __shared__ ChainEnd end;

  const long long run = blockIdx.x;
  const int tid = threadIdx.x;
  for (int s = tid; s < r; s += blockDim.x) {
    row.q_len[s] = q_len_in[run * r + s];
    q_head[s] = q_head_in[run * r + s];
    row.approx[s] = approx_in[run * r + s];
    busy[s] = busy_in[run * r + s];
  }
  const int n_live = act[run] ? min(max(n_arr[run], 0), a_n) : 0;
  __syncthreads();
  serve_sub_minima(row);
  __syncthreads();

  if (tid < 32) {
    const ChainEnd e = serve_chain(row, n_live, lane_j, lane_raw);
    if (tid == 0) end = e;
  }
  __syncthreads();
  for (int a = tid; a < a_n; a += blockDim.x) {
    const bool ok = a < end.stop;
    jv[run * a_n + a] = ok ? lane_j[a] : end.j;
    tail[run * a_n + a] = ok ? lane_raw[a] % cap : end.tail;
    admit[run * a_n + a] = ok;
  }
  for (int s = tid; s < r; s += blockDim.x) {
    q_len_out[run * r + s] = row.q_len[s];
    approx_out[run * r + s] = row.approx[s];
  }
  if (tid == 0) drops_out[run] = n_live - end.stop;
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
  const int smem = 4 * (4 * r + 2 * ((r + 31) >> 5) + 2 * a_n);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
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

// Work units of slot t at decode rate `rate`: floor((t+1) r) - floor(t r)
// in f32, as workload.service_units computes it.
__device__ __forceinline__ int service_units(float t, float rate) {
  return static_cast<int>(__fsub_rn(floorf(__fmul_rn(__fadd_rn(t, 1.0f), rate)),
                                    floorf(__fmul_rn(t, rate))));
}

// The streaming JCT histogram's bucket of jct (clipped into [1, INT_MAX]),
// as metrics.jct_bucket computes it: floor(log2) by count-leading-zeros,
// then 4 linear sub-octaves an octave from 4 up.
constexpr int kHistBuckets = 119;
__device__ __forceinline__ int jct_bucket(int jct) {
  const int j = max(jct, 1);
  const int e = 31 - __clz(j);
  return e < 2 ? j - 1 : 4 * e + ((j >> max(e - 2, 0)) & 3) - 5;
}

// The arguments of serve_slots_kernel; (T, D, A) lanes, (D, ...)
// everything else.  The carry (q_len .. dropped) is read at entry in stream
// mode, zeroed in fixed mode, and written back at exit; the rings are
// updated in place.  Null: comp_slot in stream mode, the metrics and
// warmup in fixed mode, rid in stream mode, rem_c / arid_c in fixed mode,
// final_occ and busy in stream mode, occ unless the occupancy is traced.
struct SlotsArgs {
  const int* n_arr;  // (T, D)
  const int* work;   // (T, D, A)
  const int* rid;    // (T, D, A)
  const float* x;    // (D,)
  const int* rt_period;
  const float* msr_drain;
  const float* rates;  // (D, R), read under use_rates only
  const int* horizon;  // absolute slots
  const int* warmup;   // absolute slots
  int* comp_slot;      // (D, n_cap)
  int* final_occ;      // (D, R)
  int* occ;            // (D, T, R)
  int* busy;           // (D, R)
  int* q_len;          // (D, R) carry
  int* q_head;
  float* approx;
  int* q_work;  // (D, R, cap) rings, in place
  int* q_rid;
  int* rem_c;  // (D, R, S) carry
  int* arid_c;
  int* deps_c;   // (D, R) carry, copied to shared memory (in the fixed
  int* since_c;  // horizon only the counter the kind reads)
  int* msgs;     // (D,) carry
  int* total_comp;
  int* dropped;
  int* count;  // (D,) streaming accumulators
  float* mean;
  float* m2;
  int* max_jct;
  int* hist;   // (D, kHistBuckets)
  int* rem_g;  // (D, S, R) scratch, used when rem and arid are not in shared memory
  int* arid_g;
  int d, t_n, t_end, t0, a_n, r, s_n, cap, n_cap, comm, use_rates, rem_smem, stream;
};

// One instance a mode, so that the fixed horizon carries none of the
// fold's registers.
template <bool kStream>
__global__ void __launch_bounds__(1024) serve_slots_kernel(SlotsArgs p) {
  extern __shared__ int smem[];
  const int run = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int r = p.r;
  const int s_n = p.s_n;
  const int cap = p.cap;
  const int n_sub = (r + 31) >> 5;
  const bool exact = p.comm == kExact;
  const bool dt = p.comm == kDt;
  const bool rt_kind = p.comm == kRt || p.comm == kEtRt;
  constexpr bool stream = kStream;
  const long long row0 = static_cast<long long>(run) * r;

  // Shared memory, in the order serve_slots_smem (kernels/jsaq_route.py)
  // counts it.
  int* cur = smem;
  int* q_len = cur;
  int* q_head = cur + r;
  float* approx = reinterpret_cast<float*>(cur + 2 * r);
  int* busy = cur + 3 * r;
  cur += 4 * r;
  // The trigger counters: in stream mode both (the carry holds both), in
  // the fixed horizon the one the kind reads.
  const bool keep_deps = stream || dt;
  const bool keep_since = stream || rt_kind;
  int* deps = cur;
  if (keep_deps) cur += r;
  int* since = cur;
  if (keep_since) cur += r;
  float* rate = reinterpret_cast<float*>(cur);
  if (p.use_rates) cur += r;
  unsigned* sub_key = reinterpret_cast<unsigned*>(cur);
  int* sub_idx = cur + n_sub;
  cur += 2 * n_sub;
  int* work_s = cur;
  int* rid_s = cur + p.a_n;
  int* lane_j = cur + 2 * p.a_n;
  int* lane_raw = cur + 3 * p.a_n;
  cur += 4 * p.a_n;
  int* rem = p.rem_smem ? cur : p.rem_g + static_cast<long long>(run) * s_n * r;
  int* arid = p.rem_smem ? cur + s_n * r : p.arid_g + static_cast<long long>(run) * s_n * r;
  ServeRow row{q_len, q_head, approx, busy, sub_key, sub_idx, r, cap, exact};
  __shared__ int n_live;
  __shared__ int msgs_s;
  __shared__ int comp_s;
  // Stream mode: the histogram, the running maximum, each slot's measured
  // count and JCT sum (double-buffered by slot parity) and each warp's
  // share of its squared deviations.
  __shared__ int hist_s[kHistBuckets];
  __shared__ int max_s;
  __shared__ int slot_n[2];
  __shared__ unsigned long long slot_sum[2];
  __shared__ float warp_m2[32];
  // Thread 0's: the running accumulators, and the fold of the previous
  // slot still to combine (its measured count and batch mean).
  __shared__ int count;
  __shared__ float mean;
  __shared__ float m2;
  __shared__ int fold_n;
  __shared__ float fold_mean;

  int* q_work = p.q_work + row0 * cap;
  int* q_rid = p.q_rid + row0 * cap;
  const float x = p.x[run];
  const int rt_period = p.rt_period[run];
  const float msr = p.msr_drain[run];
  const int h = static_cast<int>(
      min(max(static_cast<long long>(p.horizon[run]) - p.t0, 0LL),
          static_cast<long long>(p.t_end)));
  const int warmup = stream ? p.warmup[run] : 0;

  if (!stream) {
    for (int i = tid; i < p.n_cap; i += nthr) p.comp_slot[static_cast<long long>(run) * p.n_cap + i] = -1;
  }
  for (int j = tid; j < r; j += nthr) {
    int n_busy = 0;
    for (int s = 0; s < s_n; ++s) {
      const int rv = stream ? p.rem_c[(row0 + j) * s_n + s] : 0;
      rem[s * r + j] = rv;
      arid[s * r + j] = stream ? p.arid_c[(row0 + j) * s_n + s] : -1;
      n_busy += rv > 0;
    }
    q_len[j] = stream ? p.q_len[row0 + j] : 0;
    q_head[j] = stream ? p.q_head[row0 + j] : 0;
    approx[j] = stream ? p.approx[row0 + j] : 0.0f;
    busy[j] = n_busy;
    if (keep_deps) deps[j] = stream ? p.deps_c[row0 + j] : 0;
    if (keep_since) since[j] = stream ? p.since_c[row0 + j] : 0;
    if (p.use_rates) rate[j] = p.rates[row0 + j];
  }
  if (stream) {
    for (int b = tid; b < kHistBuckets; b += nthr) hist_s[b] = p.hist[run * kHistBuckets + b];
  }
  // Slot t's lanes into shared memory; a thread's first lane comes from
  // registers loaded at the start of the previous slot's replica stage.
  // In stream mode a lane's ring entry is its arrival slot, not its rid.
  auto lane_base = [&](int t) { return (static_cast<long long>(t) * p.d + run) * p.a_n; };
  auto store_lanes = [&](int t, int w0, int r0) {
    if (tid < p.a_n) {
      work_s[tid] = w0;
      rid_s[tid] = r0;
    }
    for (int a = tid + nthr; a < p.a_n; a += nthr) {
      work_s[a] = p.work[lane_base(t) + a];
      rid_s[a] = stream ? p.t0 + t : p.rid[lane_base(t) + a];
    }
    if (tid == 0) n_live = min(max(p.n_arr[t * p.d + run], 0), p.a_n);
  };
  auto lane_rid = [&](int t) {
    return stream ? p.t0 + t : (tid < p.a_n ? p.rid[lane_base(t) + tid] : 0);
  };
  if (h > 0) store_lanes(0, tid < p.a_n ? p.work[lane_base(0) + tid] : 0, lane_rid(0));
  if (tid == 0) {
    msgs_s = 0;
    comp_s = 0;
    slot_n[0] = slot_n[1] = 0;
    slot_sum[0] = slot_sum[1] = 0ull;
    fold_n = 0;
    if (stream) {
      max_s = p.max_jct[run];
      count = p.count[run];
      mean = p.mean[run];
      m2 = p.m2[run];
    }
  }
  // Chan's combine of a folded slot into the running accumulators, in the
  // reference's order of f32 operations (StreamMetrics.update).
  auto combine = [&]() {
    float m2_b = 0.0f;
    for (int w = 0; w < (nthr >> 5); ++w) m2_b = __fadd_rn(m2_b, warp_m2[w]);
    const float n_bf = static_cast<float>(fold_n);
    const float n_af = static_cast<float>(count);
    const float tot = fmaxf(__fadd_rn(n_af, n_bf), 1.0f);
    const float delta = __fsub_rn(fold_mean, mean);
    mean = __fadd_rn(mean, __fdiv_rn(__fmul_rn(delta, n_bf), tot));
    m2 = __fadd_rn(__fadd_rn(m2, m2_b),
                   __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(delta, delta), n_af), n_bf), tot));
    count += fold_n;
    fold_n = 0;
  };
  int msgs = 0;
  int comps = 0;
  int drops = 0;  // thread 0's
  const int loops = (r + nthr - 1) / nthr;
  __syncthreads();
  serve_sub_minima(row);
  __syncthreads();

  for (int t = 0; t < h; ++t) {
    const int tt = p.t0 + t;  // the absolute slot
    // 1. The slot's lanes, in order, on warp 0; admitted lanes into the rings.
    if (tid < 32) {
      const ChainEnd e = serve_chain(row, n_live, lane_j, lane_raw);
      if (tid == 0) drops += n_live - e.stop;
      for (int a = tid; a < e.stop; a += 32) {  // no two admitted lanes collide
        const int ring = lane_j[a] * cap + lane_raw[a] % cap;
        q_work[ring] = work_s[a];
        q_rid[ring] = rid_s[a];
      }
    }
    __syncthreads();

    // 2. The replica stage: one replica a thread, as _serve_core's steps 2-5.
    const bool next = t + 1 < h;
    int w_next = 0;
    int r_next = 0;
    if (next) {
      w_next = tid < p.a_n ? p.work[lane_base(t + 1) + tid] : 0;
      r_next = lane_rid(t + 1);
    }
    if (stream && tid == 0) {
      if (fold_n > 0) combine();  // the previous slot's fold
      slot_n[(t + 1) & 1] = 0;
      slot_sum[(t + 1) & 1] = 0ull;
    }
    const bool measure = stream && tt >= warmup;
    int n_loc = 0;
    long long sum_loc = 0;
    int max_loc = 0;
    unsigned marked = 0;  // the thread's replicas (by k) holding measured completions
    const float tf = static_cast<float>(tt);
    for (int k = 0; k < loops; ++k) {
      const int j = tid + k * nthr;
      unsigned key = kNoKey;
      if (j < r) {
        const int dep0 = keep_deps ? deps[j] : 0;
        const int since0 = keep_since ? since[j] : 0;
        int ql = q_len[j];
        int qh = q_head[j];
        int n_free = 0;
        for (int s = 0; s < s_n; ++s) n_free += rem[s * r + j] <= 0;
        const int n_admit = min(ql, n_free);
        const int units = p.use_rates ? service_units(tf, rate[j]) : 1;
        int rank = 0;
        int n_busy = 0;
        int comp = 0;
        for (int s = 0; s < s_n; ++s) {
          int rv = rem[s * r + j];
          int av = arid[s * r + j];
          if (rv <= 0) {  // free: FIFO admission in slot order
            if (rank < n_admit) {
              const int qi = (qh + rank) % cap;
              rv = q_work[j * cap + qi];
              av = q_rid[j * cap + qi];
            }
            ++rank;
          }
          if (rv > 0) {  // decode
            rv -= units;
            if (rv <= 0) {
              ++comp;
              if (!stream) {
                if (av >= 0 && av < p.n_cap) p.comp_slot[static_cast<long long>(run) * p.n_cap + av] = tt;
                av = -1;
              } else if (measure) {  // av stays until the fold's second pass
                const int jct = tt - av + 1;
                ++n_loc;
                sum_loc += jct;
                max_loc = max(max_loc, jct);
                atomicAdd(&hist_s[jct_bucket(jct)], 1);
                marked |= 1u << k;
              } else {
                av = -1;
              }
            }
          }
          n_busy += rv > 0;
          rem[s * r + j] = rv;
          arid[s * r + j] = av;
        }
        qh = (qh + n_admit) % cap;
        ql -= n_admit;
        // MSR drain, then the trigger on the truth and the snap.
        const float drain = p.use_rates ? __fmul_rn(msr, rate[j]) : msr;
        float ap = approx[j];
        ap = __fsub_rn(ap, __fmul_rn(drain, ap > 0.0f ? 1.0f : 0.0f));
        if (ap < 0.0f) ap = 0.0f;
        const int occ_j = ql + n_busy;
        const float true_occ = static_cast<float>(occ_j);
        const float err = fabsf(__fsub_rn(true_occ, ap));
        const int ds = dep0 + comp;
        const int ss = since0 + 1;
        bool trig = false;
        switch (p.comm) {
          case kRt: trig = ss >= rt_period; break;
          case kDt: trig = static_cast<float>(ds) >= x; break;
          case kEt: trig = err >= x; break;
          case kEtRt: trig = err >= x || ss >= rt_period; break;
          case kExact: trig = comp > 0; break;
          default: break;
        }
        msgs += exact ? comp : static_cast<int>(trig);
        comps += comp;
        if (keep_deps) deps[j] = trig ? 0 : ds;
        if (keep_since) since[j] = trig ? 0 : ss;
        if (trig) ap = true_occ;
        q_len[j] = ql;
        q_head[j] = qh;
        approx[j] = ap;
        busy[j] = n_busy;
        if (p.occ != nullptr) {
          p.occ[(static_cast<long long>(run) * p.t_n + t) * r + j] = occ_j;
        }
        key = score_key(exact ? true_occ : ap);
      }
      const int sb = (tid >> 5) + k * (nthr >> 5);  // the same for the whole warp
      if (sb < n_sub) store_sub_min(row, sb, key);
    }
    if (measure) {
      n_loc = __reduce_add_sync(kFullMask, n_loc);
      max_loc = __reduce_max_sync(kFullMask, max_loc);
      for (int o = 16; o > 0; o >>= 1) sum_loc += __shfl_xor_sync(kFullMask, sum_loc, o);
      if ((tid & 31) == 0 && n_loc > 0) {
        atomicAdd(&slot_n[t & 1], n_loc);
        atomicAdd(&slot_sum[t & 1], static_cast<unsigned long long>(sum_loc));
        atomicMax(&max_s, max_loc);
      }
    }
    if (next) store_lanes(t + 1, w_next, r_next);
    __syncthreads();

    // 3. Stream mode: the slot's fold.  Its measured count and JCT sum
    // (exact integers) give the batch mean; the second pass sums the
    // squared deviations of the completions the first pass left marked,
    // per warp in a fixed order, and frees their decode slots.  Thread 0
    // combines during the next slot's replica stage (or after the loop).
    const int n_b = measure ? slot_n[t & 1] : 0;
    if (n_b > 0) {
      const float mean_b = __fdiv_rn(__ull2float_rn(slot_sum[t & 1]),
                                     fmaxf(static_cast<float>(n_b), 1.0f));
      float acc = 0.0f;
      for (int k = 0; k < loops; ++k) {
        if (!(marked >> k & 1u)) continue;
        const int j = tid + k * nthr;
        for (int s = 0; s < s_n; ++s) {
          const int av = arid[s * r + j];
          if (rem[s * r + j] <= 0 && av >= 0) {
            const float dv = __fsub_rn(static_cast<float>(tt - av + 1), mean_b);
            acc = __fadd_rn(acc, __fmul_rn(dv, dv));
            arid[s * r + j] = -1;
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, o));
      if ((tid & 31) == 0) warp_m2[tid >> 5] = acc;
      if (tid == 0) {
        fold_n = n_b;
        fold_mean = mean_b;
      }
    }
  }
  __syncthreads();
  if (tid == 0 && fold_n > 0) combine();

  // Past the horizon every slot is a frozen no-op: its occupancy row is the
  // final one.  Then the carry and the per-run sums.
  for (int j = tid; j < r; j += nthr) {
    const long long o = static_cast<long long>(run) * r + j;
    const int occ_j = q_len[j] + busy[j];
    if (p.final_occ != nullptr) p.final_occ[o] = occ_j;
    if (p.busy != nullptr) p.busy[o] = busy[j];
    p.q_len[o] = q_len[j];
    p.q_head[o] = q_head[j];
    p.approx[o] = approx[j];
    if (keep_deps) p.deps_c[o] = deps[j];
    if (keep_since) p.since_c[o] = since[j];
    if (p.rem_c != nullptr) {
      for (int s = 0; s < s_n; ++s) {
        p.rem_c[o * s_n + s] = rem[s * r + j];
        p.arid_c[o * s_n + s] = arid[s * r + j];
      }
    }
    if (p.occ != nullptr) {
      for (int t = h; t < p.t_n; ++t) {
        p.occ[(static_cast<long long>(run) * p.t_n + t) * r + j] = occ_j;
      }
    }
  }
  if (stream) {
    for (int b = tid; b < kHistBuckets; b += nthr) p.hist[run * kHistBuckets + b] = hist_s[b];
  }
  msgs = __reduce_add_sync(kFullMask, msgs);
  comps = __reduce_add_sync(kFullMask, comps);
  if ((tid & 31) == 0) {
    atomicAdd(&msgs_s, msgs);
    atomicAdd(&comp_s, comps);
  }
  __syncthreads();
  if (tid == 0) {
    // Running totals wrap as int32 sums do.
    auto add = [&](int* total, int v) {
      const unsigned base = stream ? static_cast<unsigned>(total[run]) : 0u;
      total[run] = static_cast<int>(base + static_cast<unsigned>(v));
    };
    add(p.msgs, msgs_s);
    add(p.total_comp, comp_s);
    add(p.dropped, drops);
    if (stream) {
      p.count[run] = count;
      p.mean[run] = mean;
      p.m2[run] = m2;
      p.max_jct[run] = max_s;
    }
  }
}

// Launches serve_slots_kernel on `stream` with `threads` threads and `smem`
// bytes of dynamic shared memory a block (the wrapper counts them); returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when r is
// outside [1, kMaxReplicas].
extern "C" int serve_slots_launch(
    const int* n_arr, const int* work, const int* rid, const float* x,
    const int* rt_period, const float* msr_drain, const float* rates,
    const int* horizon, const int* warmup, int* comp_slot, int* final_occ, int* occ,
    int* busy, int* q_len, int* q_head, float* approx, int* q_work, int* q_rid,
    int* rem_c, int* arid_c, int* deps_c, int* since_c, int* msgs, int* total_comp,
    int* dropped, int* count, float* mean, float* m2, int* max_jct, int* hist,
    int* rem_g, int* arid_g, int d, int t_n, int t_end, int t0, int a_n, int r,
    int s_n, int cap, int n_cap, int comm, int use_rates, int rem_smem, int stream_mode,
    int threads, int smem, cudaStream_t stream) {
  if (r < 1 || r > kMaxReplicas) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(SlotsArgs) =
      stream_mode ? serve_slots_kernel<true> : serve_slots_kernel<false>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const SlotsArgs p{n_arr, work, rid, x, rt_period, msr_drain, rates, horizon, warmup,
                    comp_slot, final_occ, occ, busy, q_len, q_head, approx, q_work,
                    q_rid, rem_c, arid_c, deps_c, since_c, msgs, total_comp, dropped,
                    count, mean, m2, max_jct, hist, rem_g, arid_g, d, t_n, t_end, t0,
                    a_n, r, s_n, cap, n_cap, comm, use_rates, rem_smem, stream_mode};
  if (d > 0) kernel<<<d, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
