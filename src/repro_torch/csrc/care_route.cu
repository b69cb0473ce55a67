// Fused CARE slot loop for Hopper (sm_90a): the mean-field simulator kernel.
//
// Replaces the Pallas TPU kernel care_route_pallas (repro/kernels/jsaq_route.py,
// body _care_kernel).  One run per row: T slots of JSQ/JSAQ routing with
// lowest-index ties, a cap-checked admit, deterministic service of msr_slots
// slots per job, the MSR emulation drain and the rt/dt/et/et_rt/exact/none
// trigger with its snap, integer for integer as _care_kernel computes them.
//
// What bounds it on this card: every slot touches every server's state
// (about 40 integer operations and six int32 loads and stores per server),
// and the slots form a dependent chain inside each run.  At K = 1e6 a run's
// state is 28 MB, far above the 227 KB of shared memory a block may hold,
// so the state lives in device memory (L2 when it fits) and each slot
// streams it once for the argmin and once for the update.  With one block
// per run, a grid of D runs occupies only D of the card's 132 SMs.
//
// Design: one thread block per run, servers strided over its threads so
// every pass is coalesced.  Per slot: (1) a block argmin over (value,
// index) pairs (block_argmin.cuh); (2) thread 0 applies the arrival to the
// chosen server alone and broadcasts it through the barrier; (3) one
// elementwise pass applies service, drain, trigger and snap, keeping
// per-thread partial sums and extrema; (4) a block reduction of departures,
// messages, max|q - qa|, max q and min q, folded into thread 0's running
// statistics.  Slots past a run's horizon are frozen, so the loop stops
// there.  The state q and the per-server arrivals live in the output
// tensors; the other five state arrays in a (D, 5, K) int32 scratch tensor
// that the caller allocates.  No pad lanes: every pass is bounded by K.
#include <cuda_runtime.h>

#include "block_argmin.cuh"

// Trigger kinds; the Python binding passes the index of the same name.
enum CommKind { kRt = 0, kDt = 1, kEt = 2, kEtRt = 3, kExact = 4, kNone = 5 };

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(1024)
care_route_kernel(const int* arrive, const int* params, int* routed, int* q_out,
                  int* ps_out, int* stats, int* scratch, int t_slots, int k,
                  int cap, int jsaq, int comm) {
  __shared__ MinPair<int> amin[33];
  __shared__ int red[5][32];
  const long long run = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int x = params[run * 4 + 0];
  const int rt_period = params[run * 4 + 1];
  const int msr = params[run * 4 + 2];
  const int horizon = params[run * 4 + 3];

  int* q = q_out + run * k;
  int* ps = ps_out + run * k;
  int* qa = scratch + (run * 5 + 0) * k;
  int* hr = scratch + (run * 5 + 1) * k;
  int* eh = scratch + (run * 5 + 2) * k;
  int* ds = scratch + (run * 5 + 3) * k;
  int* ss = scratch + (run * 5 + 4) * k;
  const int* arr_row = arrive + run * t_slots;
  int* routed_row = routed + run * t_slots;
  const int* score = jsaq ? qa : q;

  for (int s = tid; s < k; s += nthr) {
    q[s] = 0;
    ps[s] = 0;
    qa[s] = 0;
    hr[s] = 0;
    eh[s] = msr;
    ds[s] = 0;
    ss[s] = 0;
  }
  // Running statistics; only thread 0's copies are meaningful.
  int msgs = 0, deps = 0, arrs = 0, drops = 0, max_aq = 0, max_q = 0, gap = 0;
  const int t_end = min(t_slots, max(horizon, 0));
  __syncthreads();

  for (int t = 0; t < t_end; ++t) {
    // (1) route: lowest-index argmin of the true or approximated queues.
    const int j = block_argmin(score, k, amin).y;

    // (2) arrival and admit, applied to server j by thread 0.
    if (tid == 0) {
      const bool a = arr_row[t] > 0;
      const int q_sel = q[j];
      const bool admit = a && q_sel < cap;
      drops += (a && !admit) ? 1 : 0;
      if (admit) {
        if (q_sel == 0) hr[j] = msr;
        q[j] = q_sel + 1;
        const int qa_sel = qa[j];
        if (qa_sel == 0) eh[j] = msr;
        qa[j] = qa_sel + 1;
        ps[j] += 1;
        arrs += 1;
      }
      routed_row[t] = admit ? j : -1;
    }
    __syncthreads();

    // (3) service, MSR drain, trigger and snap for every server.
    int p_dep = 0, p_sent = 0, p_aq = 0, p_qmax = 0, p_qmin = INT_MAX;
    for (int s = tid; s < k; s += nthr) {
      int qv = q[s], qav = qa[s], hrv = hr[s], ehv = eh[s];
      const int dsv = ds[s], ssv = ss[s];
      const bool busy = qv > 0;
      if (busy) hrv -= 1;
      const bool dep = busy && hrv <= 0;
      if (dep) {
        qv -= 1;
        if (qv > 0) hrv = msr;
      }
      const bool ticking = qav > 0;
      if (ticking) ehv -= 1;
      if (ticking && ehv <= 0) {
        qav -= 1;
        ehv = msr;
      }
      const int err = abs(qv - qav);
      const int dsa = dsv + (dep ? 1 : 0);
      const int ssa = ssv + 1;
      bool trig;
      switch (comm) {
        case kRt: trig = ssa >= rt_period; break;
        case kDt: trig = dsa >= x; break;
        case kEt: trig = err >= x; break;
        case kEtRt: trig = err >= x || ssa >= rt_period; break;
        case kExact: trig = dep; break;
        default: trig = false; break;
      }
      p_dep += dep ? 1 : 0;
      p_sent += (comm == kExact ? dep : trig) ? 1 : 0;
      if (trig) {
        qav = qv;
        ehv = msr;
      }
      p_aq = max(p_aq, abs(qv - qav));
      p_qmax = max(p_qmax, qv);
      p_qmin = min(p_qmin, qv);
      q[s] = qv;
      qa[s] = qav;
      hr[s] = hrv;
      eh[s] = ehv;
      ds[s] = trig ? 0 : dsa;
      ss[s] = trig ? 0 : ssa;
    }

    // (4) block reduction into thread 0's running statistics.
    p_dep = warp_sum(p_dep);
    p_sent = warp_sum(p_sent);
    p_aq = warp_max(p_aq);
    p_qmax = warp_max(p_qmax);
    p_qmin = warp_min(p_qmin);
    const int warp = tid >> 5;
    const int lane = tid & 31;
    if (lane == 0) {
      red[0][warp] = p_dep;
      red[1][warp] = p_sent;
      red[2][warp] = p_aq;
      red[3][warp] = p_qmax;
      red[4][warp] = p_qmin;
    }
    __syncthreads();
    if (warp == 0) {
      const bool live = lane < (nthr >> 5);
      int r_dep = warp_sum(live ? red[0][lane] : 0);
      int r_sent = warp_sum(live ? red[1][lane] : 0);
      int r_aq = warp_max(live ? red[2][lane] : 0);
      int r_qmax = warp_max(live ? red[3][lane] : 0);
      int r_qmin = warp_min(live ? red[4][lane] : INT_MAX);
      if (lane == 0) {
        deps += r_dep;
        msgs += r_sent;
        max_aq = max(max_aq, r_aq);
        max_q = max(max_q, r_qmax);
        gap = max(gap, r_qmax - r_qmin);
      }
    }
    // Orders this slot's state writes before the next slot's argmin scan
    // and warp 0's reads of `red` before the next slot's writes to it.
    __syncthreads();
  }

  for (int t = t_end + tid; t < t_slots; t += nthr) routed_row[t] = -1;
  if (tid == 0) {
    int* st = stats + run * 8;
    st[0] = msgs;
    st[1] = deps;
    st[2] = arrs;
    st[3] = drops;
    st[4] = max_aq;
    st[5] = max_q;
    st[6] = gap;
    st[7] = 0;
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int care_route_launch(const int* arrive, const int* params, int* routed,
                                 int* q_out, int* ps_out, int* stats, int* scratch,
                                 int d, int t_slots, int k, int cap, int jsaq,
                                 int comm, int threads, cudaStream_t stream) {
  if (d > 0) {
    care_route_kernel<<<d, threads, 0, stream>>>(arrive, params, routed, q_out, ps_out,
                                                 stats, scratch, t_slots, k, cap, jsaq,
                                                 comm);
  }
  return static_cast<int>(cudaGetLastError());
}
