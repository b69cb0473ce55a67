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
// (repro_torch/serve/engine.py, _serve_core) for slots [0, t_end) of every
// run, where the JAX package runs serve_route_pallas inside one lax.scan:
// per slot the lane chain, the ring writes, FIFO admission into free decode
// slots, decode (one unit, or the credit schedule's units), completions, the
// MSR drain, the rt/dt/et/et_rt/exact/none trigger and its snap, and the
// occupancy row.
//
// What bounds them on this card.  The lanes of a slot form a dependent chain
// (each argmin reads the state the previous lane bumped), and the slots of
// a run form another.  Both kernels sit far above their bytes and operations
// bounds; what sets their time is the latency of one routed lane and, for
// serve_slots, of one slot's replica stage.  A routed lane was three block
// barriers (~0.8 us); a slot of the loop was ~77 PyTorch operations issued
// by the host.
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
// et_rt, the rates under use_rates), and rem and arid ((S, R) each) join it
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

// The per-run inputs and outputs of serve_slots_kernel; (T, D, A) lanes,
// (D, ...) everything else.  occ is null unless the occupancy is traced.
struct SlotsArgs {
  const int* n_arr;  // (T, D)
  const int* work;   // (T, D, A)
  const int* rid;    // (T, D, A)
  const float* x;    // (D,)
  const int* rt_period;
  const float* msr_drain;
  const float* rates;  // (D, R), read under use_rates only
  const int* horizon;
  int* comp_slot;  // (D, n_cap)
  int* msgs;       // (D,)
  int* total_comp;
  int* dropped;
  int* final_occ;  // (D, R)
  int* occ;        // (D, T, R) or null
  int* q_len_out;  // (D, R) end-of-run routing state
  int* q_head_out;
  float* approx_out;
  int* busy_out;
  int* q_work;  // (D, R, cap) scratch
  int* q_rid;
  int* rem_g;  // (D, S, R) scratch, used when rem and arid are not in shared memory
  int* arid_g;
  int d, t_n, t_end, a_n, r, s_n, cap, n_cap, comm, use_rates, rem_smem;
};

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

  // Shared memory, in the order serve_slots_smem (kernels/jsaq_route.py)
  // counts it.
  int* cur = smem;
  int* q_len = cur;
  int* q_head = cur + r;
  float* approx = reinterpret_cast<float*>(cur + 2 * r);
  int* busy = cur + 3 * r;
  cur += 4 * r;
  int* deps = cur;
  if (dt) cur += r;
  int* since = cur;
  if (rt_kind) cur += r;
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

  int* q_work = p.q_work + static_cast<long long>(run) * r * cap;
  int* q_rid = p.q_rid + static_cast<long long>(run) * r * cap;
  int* comp_slot = p.comp_slot + static_cast<long long>(run) * p.n_cap;
  const float x = p.x[run];
  const int rt_period = p.rt_period[run];
  const float msr = p.msr_drain[run];
  const int h = min(max(p.horizon[run], 0), p.t_end);

  for (int i = tid; i < p.n_cap; i += nthr) comp_slot[i] = -1;
  for (int j = tid; j < r; j += nthr) {
    q_len[j] = 0;
    q_head[j] = 0;
    approx[j] = 0.0f;
    busy[j] = 0;
    if (dt) deps[j] = 0;
    if (rt_kind) since[j] = 0;
    if (p.use_rates) rate[j] = p.rates[static_cast<long long>(run) * r + j];
    for (int s = 0; s < s_n; ++s) {
      rem[s * r + j] = 0;
      arid[s * r + j] = -1;
    }
  }
  for (int sb = tid; sb < n_sub; sb += nthr) {  // every score is 0
    sub_key[sb] = score_key(0.0f);
    sub_idx[sb] = sb * 32;
  }
  // Slot t's lanes into shared memory; a thread's first lane comes from
  // registers loaded at the start of the previous slot's replica stage.
  auto lane_base = [&](int t) { return (static_cast<long long>(t) * p.d + run) * p.a_n; };
  auto store_lanes = [&](int t, int w0, int r0) {
    if (tid < p.a_n) {
      work_s[tid] = w0;
      rid_s[tid] = r0;
    }
    for (int a = tid + nthr; a < p.a_n; a += nthr) {
      work_s[a] = p.work[lane_base(t) + a];
      rid_s[a] = p.rid[lane_base(t) + a];
    }
    if (tid == 0) n_live = min(max(p.n_arr[t * p.d + run], 0), p.a_n);
  };
  if (h > 0) {
    const bool mine = tid < p.a_n;
    store_lanes(0, mine ? p.work[lane_base(0) + tid] : 0, mine ? p.rid[lane_base(0) + tid] : 0);
  }
  if (tid == 0) {
    msgs_s = 0;
    comp_s = 0;
  }
  int msgs = 0;
  int comps = 0;
  int drops = 0;  // thread 0's
  const int loops = (r + nthr - 1) / nthr;
  __syncthreads();

  for (int t = 0; t < h; ++t) {
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
    if (next && tid < p.a_n) {
      w_next = p.work[lane_base(t + 1) + tid];
      r_next = p.rid[lane_base(t + 1) + tid];
    }
    const float tf = static_cast<float>(t);
    for (int k = 0; k < loops; ++k) {
      const int j = tid + k * nthr;
      unsigned key = kNoKey;
      if (j < r) {
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
              if (av >= 0 && av < p.n_cap) comp_slot[av] = t;
              av = -1;
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
        const int ds = dt ? deps[j] + comp : 0;
        const int ss = rt_kind ? since[j] + 1 : 0;
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
        if (dt) deps[j] = trig ? 0 : ds;
        if (rt_kind) since[j] = trig ? 0 : ss;
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
    if (next) store_lanes(t + 1, w_next, r_next);
    __syncthreads();
  }

  // Past the horizon every slot is a frozen no-op: its occupancy row is the
  // final one.  Then the per-run sums.
  for (int j = tid; j < r; j += nthr) {
    const long long o = static_cast<long long>(run) * r + j;
    const int occ_j = q_len[j] + busy[j];
    p.final_occ[o] = occ_j;
    p.q_len_out[o] = q_len[j];
    p.q_head_out[o] = q_head[j];
    p.approx_out[o] = approx[j];
    p.busy_out[o] = busy[j];
    if (p.occ != nullptr) {
      for (int t = h; t < p.t_n; ++t) {
        p.occ[(static_cast<long long>(run) * p.t_n + t) * r + j] = occ_j;
      }
    }
  }
  msgs = __reduce_add_sync(kFullMask, msgs);
  comps = __reduce_add_sync(kFullMask, comps);
  if ((tid & 31) == 0) {
    atomicAdd(&msgs_s, msgs);
    atomicAdd(&comp_s, comps);
  }
  __syncthreads();
  if (tid == 0) {
    p.msgs[run] = msgs_s;
    p.total_comp[run] = comp_s;
    p.dropped[run] = drops;
  }
}

// Launches serve_slots_kernel on `stream` with `threads` threads and `smem`
// bytes of dynamic shared memory a block (the wrapper counts them); returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when r is
// outside [1, kMaxReplicas].
extern "C" int serve_slots_launch(
    const int* n_arr, const int* work, const int* rid, const float* x,
    const int* rt_period, const float* msr_drain, const float* rates,
    const int* horizon, int* comp_slot, int* msgs, int* total_comp, int* dropped,
    int* final_occ, int* occ, int* q_len_out, int* q_head_out, float* approx_out,
    int* busy_out, int* q_work, int* q_rid, int* rem_g, int* arid_g, int d,
    int t_n, int t_end, int a_n, int r, int s_n, int cap, int n_cap, int comm,
    int use_rates, int rem_smem, int threads, int smem, cudaStream_t stream) {
  if (r < 1 || r > kMaxReplicas) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        serve_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const SlotsArgs p{n_arr, work, rid, x, rt_period, msr_drain, rates, horizon,
                    comp_slot, msgs, total_comp, dropped, final_occ, occ,
                    q_len_out, q_head_out, approx_out, busy_out, q_work, q_rid,
                    rem_g, arid_g, d, t_n, t_end, a_n, r, s_n, cap, n_cap, comm,
                    use_rates, rem_smem};
  if (d > 0) serve_slots_kernel<<<d, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
