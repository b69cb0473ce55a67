// Fused CARE slot loop for Hopper (sm_90a): the mean-field simulator kernel.
//
// Replaces the Pallas TPU kernel care_route_pallas (repro/kernels/jsaq_route.py,
// body _care_kernel).  One run per row: T slots of JSQ/JSAQ routing with
// lowest-index ties, a cap-checked admit, deterministic service of msr_slots
// slots per job, the MSR emulation drain and the rt/dt/et/et_rt/exact/none
// trigger with its snap, integer for integer as _care_kernel computes them.
//
// What bounds it on this card.  The slots of a run form a chain: slot t+1
// routes on the state slot t leaves.  At the mean-field cell (one Bernoulli
// arrival a slot, jobs of 8 slots, K = 1e6) about 8 servers of a run are
// busy at any time, so the state that can change in a slot is a few hundred
// bytes, while the whole state is 28 MB.  A dense pass over all K servers a
// slot (the TPU kernel's schedule) streams 0.8 GB a slot for 16 runs and
// cannot beat ~1 s even at the card's full memory rate.  What bounds this
// kernel instead is the latency of one slot of the chain: two block barriers,
// the loads and stores of the servers it visits (L2 hits), and a few shared
// memory round trips, a few microseconds a slot.
//
// Design: visit only the servers whose state can change.  A server is at
// rest when q == 0 and qa == 0.  Its hr and eh are dead (an admit resets
// them), its score is 0, the least a score can be, it adds nothing to the
// slot's departures, errors or max q, and in a slot it changes only its
// counters ss and ds, which matter only where it triggers.  At rest it
// triggers under rt when ss + 1 >= rt_period, under dt and et only if
// x <= 0 (a stored ds is always < x when x >= 1), under et_rt on either, and
// never under exact and none.
//
// - Servers are cut into tiles of `tile` servers (256, or more so that the
//   tile table fits).  A tile table in dynamic shared memory holds, for each
//   tile, whether it is live (some server with q > 0 or qa > 0), the last
//   slot it was visited, and under rt / et_rt the first slot an rt trigger
//   wakes it: last + min over its servers of max(1, rt_period - ss).
// - A tile is due in slot t if it is live, holds slot t's arrival, or is
//   rt-due.  Under dt, et and et_rt with x <= 0, and under rt and
//   et_rt with rt_period <= 1, every tile is due every slot (dense).  The
//   live tiles form a compact list in shared memory, rebuilt by each slot's
//   visits; rt-due tiles are appended to it by a scan of the table that runs
//   only in slots at or past the earliest wake-up slot (and costs the slot a
//   third barrier).
// - One warp visits one tile: lane l owns servers l, l + 32, ... of it, and
//   loads kUnroll of them (up to five int32 fields each) before computing,
//   so the loads are coalesced and in flight together.  A visit loads only the
//   fields that are alive: q, qa, hr and eh only if the tile was live, ds
//   only under dt and ss only under rt / et_rt (no other trigger reads
//   them).  Before a visit, a tile's ss is advanced by the slots it rested
//   (nothing triggered in them, by construction); at its first visit ds and
//   ss start from 0, so only q and the per-server arrivals are zero-filled,
//   once.  The slot's arrival is applied by the lane that owns the routed
//   server, whose arrival count is loaded with the rest.
// - Each visit also folds its servers into the warp's partial argmin (value,
//   lowest index), max q and min q, and the tile's live flag and wake-up
//   slot.  After the first barrier warp 0 merges the warps' partials with the
//   first index of the lowest tile not visited (it rests, so its scores are
//   0): that is the next slot's route, so the argmin needs no pass of its
//   own.  If a tile was not visited, the slot's min q is 0.
// - Departures, messages, arrivals, drops and max |q - qa| are totals or
//   maxima over the whole run, so each thread keeps its own and the block
//   reduces them once, at the end; warp 0 keeps max q and the gap from its
//   per-slot merge.  Two barriers a slot.
//
// A block per run, min(16, tiles) warps: the slots of a run are a chain, so
// spreading a run over more SMs would add a cross-SM barrier to every slot
// and remove no work; more warps only help the slots where many tiles are
// due (rt wake-ups, x <= 0).  Slots past a run's horizon are
// frozen, so the loop stops there.  The state q and the per-server arrivals
// live in the output tensors; qa, hr, eh, ds and ss in a (D, 5, K) int32
// scratch tensor that the caller allocates.
#include <climits>
#include <cuda_runtime.h>

// Trigger kinds; the Python binding passes the index of the same name.
enum CommKind { kRt = 0, kDt = 1, kEt = 2, kEtRt = 3, kExact = 4, kNone = 5 };

constexpr int kMaxWarps = 16;  // CARE_WARPS in kernels/jsaq_route.py
constexpr int kUnroll = 8;     // servers a lane loads before it computes
constexpr int kNever = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

// Warp reductions on the redux unit (sm_80 and later); every lane gets the
// result.
__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(kFull, v); }
__device__ __forceinline__ int warp_max(int v) { return __reduce_max_sync(kFull, v); }
__device__ __forceinline__ int warp_min(int v) { return __reduce_min_sync(kFull, v); }

// Keeps the smaller value and, among equal values, the smaller index.
__device__ __forceinline__ void argmin_merge(int& v, int& i, int v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// The least (value, index) pair of the warp: the least value, and the least
// index among the lanes that hold it (each lane's index is its lowest for its
// value), so ties go to the lowest index as jnp.argmin breaks them.
__device__ __forceinline__ void warp_argmin(int& v, int& i) {
  const int least = warp_min(v);
  i = warp_min(v == least ? i : kNever);
  v = least;
}

// One run's pointers and scalars.
struct Run {
  int* q;
  int* ps;
  int* qa;
  int* hr;
  int* eh;
  int* ds;
  int* ss;
  int* routed;
  int k, cap, jsaq, comm, x, rt_period, msr, tile;
  bool rt_kind;   // rt or et_rt: a slot counter that reaches rt_period triggers
  bool err_kind;  // et or et_rt: an error of x or more triggers
};

// What a thread carries through the run (totals and maxima), and what a
// warp carries through one slot (partial argmin, max q, min q).
struct Acc {
  int msgs = 0, deps = 0, arrs = 0, drops = 0, max_aq = 0;
  int v = kNever, i = kNever, qmax = 0, qmin = kNever;
};

// Visit tile `tl` in slot t with one warp: bring its resting slots up to
// date, apply the slot's arrival (to server j when `arr`), then service,
// drain, trigger and snap for each of its servers; update the tile table and
// append the tile to the next slot's list if it is live.  Only live fields
// are loaded and stored: a tile that was not live has q = qa = 0 and dead hr
// and eh (an admit resets them), so they are neither loaded nor, unless the
// tile takes the arrival, stored; ds is read only by dt's trigger and ss only
// by rt's, so each is kept only under its kinds.
__device__ __forceinline__ void visit(const Run& r, int tl, int t, int j, bool arr,
                                      int* tl_last, int* tl_due, int* tl_live,
                                      int* next_list, int* next_n, int* wake_min,
                                      Acc& a, int lane) {
  const int base = tl * r.tile;
  const int n = min(r.tile, r.k - base);
  const int prev = tl_last[tl];
  const bool fresh = prev < 0;    // never visited: ds = 0 and ss = 0 before slot 0
  const int skip = t - 1 - prev;  // slots the tile rested since its last visit
  const bool was_live = tl_live[tl] != 0;
  const bool active = was_live || (arr && j >= base && j < base + n);
  const bool keep_ds = r.comm == kDt;
  bool live = false;
  int wake = kNever;  // under rt / et_rt: least max(1, rt_period - ss) at rest
  for (int c = 0; c < n; c += 32 * kUnroll) {
    int qv[kUnroll], qav[kUnroll], hrv[kUnroll], ehv[kUnroll], dsv[kUnroll], ssv[kUnroll];
    int ps_j = 0;  // the routed server's admitted arrivals, loaded with the rest
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = c + u * 32 + lane;
      if (s < n) {
        const int g = base + s;
        if (was_live) {
          qv[u] = r.q[g];
          qav[u] = r.qa[g];
          hrv[u] = r.hr[g];
          ehv[u] = r.eh[g];
        } else {
          qv[u] = 0;
          qav[u] = 0;
          hrv[u] = 0;
          ehv[u] = r.msr;
        }
        dsv[u] = (keep_ds && !fresh) ? r.ds[g] : 0;
        ssv[u] = ((r.rt_kind && !fresh) ? r.ss[g] : 0) + skip;
        if (arr && g == j) ps_j = r.ps[g];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = c + u * 32 + lane;
      if (s >= n) continue;
      const int g = base + s;
      int qx = qv[u], qax = qav[u], hrx = hrv[u], ehx = ehv[u];
      if (arr && g == j) {  // the slot's arrival, admitted if under cap
        if (qx < r.cap) {
          if (qx == 0) hrx = r.msr;
          qx += 1;
          if (qax == 0) ehx = r.msr;
          qax += 1;
          r.ps[g] = ps_j + 1;
          r.routed[t] = j;
          a.arrs += 1;
        } else {
          a.drops += 1;
        }
      }
      const bool busy = qx > 0;
      if (busy) hrx -= 1;
      const bool dep = busy && hrx <= 0;
      if (dep) {
        qx -= 1;
        if (qx > 0) hrx = r.msr;
      }
      const bool ticking = qax > 0;
      if (ticking) ehx -= 1;
      if (ticking && ehx <= 0) {
        qax -= 1;
        ehx = r.msr;
      }
      const int err = abs(qx - qax);
      const int dsa = dsv[u] + (dep ? 1 : 0);
      const int ssa = ssv[u] + 1;
      // rt: ssa >= rt_period; dt: dsa >= x; et: err >= x; et_rt: either
      // of rt's and et's; exact: a departure; none: never.
      const bool trig = (r.rt_kind && ssa >= r.rt_period) || (keep_ds && dsa >= r.x) ||
                        (r.err_kind && err >= r.x) || (r.comm == kExact && dep);
      a.deps += dep ? 1 : 0;
      a.msgs += (r.comm == kExact ? dep : trig) ? 1 : 0;
      if (trig) {
        qax = qx;
        ehx = r.msr;
      }
      const int ss_new = trig ? 0 : ssa;
      if (active) {
        r.q[g] = qx;
        r.qa[g] = qax;
        r.hr[g] = hrx;
        r.eh[g] = ehx;
      }
      if (keep_ds) r.ds[g] = trig ? 0 : dsa;
      if (r.rt_kind) r.ss[g] = ss_new;
      a.max_aq = max(a.max_aq, abs(qx - qax));
      a.qmax = max(a.qmax, qx);
      a.qmin = min(a.qmin, qx);
      argmin_merge(a.v, a.i, r.jsaq ? qax : qx, g);
      if (qx > 0 || qax > 0) {
        live = true;
      } else if (r.rt_kind) {
        wake = min(wake, (int)max(1LL, (long long)r.rt_period - ss_new));
      }
    }
  }
  live = __any_sync(kFull, live);
  if (r.rt_kind) wake = warp_min(wake);
  if (lane == 0) {
    tl_last[tl] = t;
    tl_live[tl] = live ? 1 : 0;
    if (live) {
      tl_due[tl] = kNever;
      next_list[atomicAdd(next_n, 1)] = tl;
    } else if (r.rt_kind) {
      const long long due = (long long)t + wake;
      const int d = due > kNever ? kNever : (int)due;
      tl_due[tl] = d;
      atomicMin(wake_min, d);
    } else {
      tl_due[tl] = kNever;
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
care_route_kernel(const int* __restrict__ arrive, const int* __restrict__ params,
                  int* routed, int* q_out, int* ps_out, int* stats, int* scratch,
                  int t_slots, int k, int cap, int jsaq, int comm, int tile, int n_tiles) {
  extern __shared__ int smem[];
  int* tl_last = smem;                         // last slot visited, -1: never
  int* tl_due = smem + n_tiles;                // first rt wake-up slot, kNever: none
  int* tl_live = smem + 2 * n_tiles;           // 1 if some q > 0 or qa > 0
  int* lists = smem + 3 * n_tiles;             // two lists of due tiles, by slot parity
  __shared__ int red[4][kMaxWarps];
  __shared__ int fin[5][kMaxWarps];
  __shared__ int s_route, s_arr, s_ncur, s_nnext, s_next_rt, s_wake;

  const long long run = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  Run r;
  r.k = k;
  r.cap = cap;
  r.jsaq = jsaq;
  r.comm = comm;
  r.tile = tile;
  r.x = params[run * 4 + 0];
  r.rt_period = params[run * 4 + 1];
  r.msr = params[run * 4 + 2];
  const int horizon = params[run * 4 + 3];
  r.q = q_out + run * k;
  r.ps = ps_out + run * k;
  r.qa = scratch + (run * 5 + 0) * k;
  r.hr = scratch + (run * 5 + 1) * k;
  r.eh = scratch + (run * 5 + 2) * k;
  r.ds = scratch + (run * 5 + 3) * k;
  r.ss = scratch + (run * 5 + 4) * k;
  r.routed = routed + run * t_slots;
  r.rt_kind = comm == kRt || comm == kEtRt;
  r.err_kind = comm == kEt || comm == kEtRt;
  const bool dense = ((comm == kDt || comm == kEt || comm == kEtRt) && r.x <= 0) ||
                     (r.rt_kind && r.rt_period <= 1);
  const int* arr_row = arrive + run * t_slots;
  const int t_end = min(t_slots, max(horizon, 0));
  // Before slot 0 every server rests with ss = 0 and last = -1.
  const int due0 = r.rt_kind ? max(1, r.rt_period) - 1 : kNever;

  for (int s = tid; s < k; s += nthr) {
    r.q[s] = 0;
    r.ps[s] = 0;
  }
  for (int t = tid; t < t_slots; t += nthr) r.routed[t] = -1;
  for (int i = tid; i < n_tiles; i += nthr) {
    tl_last[i] = -1;
    tl_due[i] = due0;
    tl_live[i] = 0;
  }
  if (tid == 0) {
    // Slot 0 routes to server 0 (all scores 0): its tile is due if the slot
    // has an arrival.
    const bool a0 = t_end > 0 && arr_row[0] > 0;
    s_route = 0;
    s_arr = a0 ? 1 : 0;
    lists[0] = 0;
    s_ncur = (a0 && !dense) ? 1 : 0;
    s_nnext = 0;
    s_next_rt = due0;
    s_wake = kNever;
  }
  Acc a;
  int gap = 0, max_q = 0;  // thread 0's
  __syncthreads();

  for (int t = 0; t < t_end; ++t) {
    const int j = s_route;
    const bool arr = s_arr != 0;
    int* cur = lists + (t & 1) * n_tiles;
    int* nxt = lists + ((t + 1) & 1) * n_tiles;
    const bool scan = r.rt_kind && !dense && t >= s_next_rt;
    // The next slot's arrival, loaded early; used by warp 0 after the barrier.
    const int a_next = (tid == 0 && t + 1 < t_end) ? arr_row[t + 1] : 0;
    if (scan) {
      // Append the tiles at rest whose wake-up slot has come.  A listed tile
      // is live (due kNever) or holds the arrival (skipped here), so no tile
      // is listed twice.  The least later wake-up slot goes to s_wake.
      const int tj = arr ? j / tile : -1;
      int later = kNever;
      for (int b = warp * 32; b < n_tiles; b += nwarps * 32) {
        const int tl = b + lane;
        bool due = false;
        if (tl < n_tiles && tl != tj) {
          const int dv = tl_due[tl];
          due = dv <= t;
          if (!due) later = min(later, dv);
        }
        const unsigned m = __ballot_sync(kFull, due);
        if (m) {
          int at = 0;
          if (lane == 0) at = atomicAdd(&s_ncur, __popc(m));
          at = __shfl_sync(kFull, at, 0);
          if (due) cur[at + __popc(m & ((1u << lane) - 1u))] = tl;
        }
      }
      later = warp_min(later);
      if (lane == 0) atomicMin(&s_wake, later);
      __syncthreads();
    }
    const int count = dense ? n_tiles : s_ncur;  // tiles visited in slot t
    a.v = kNever;
    a.i = kNever;
    a.qmax = 0;
    a.qmin = kNever;
    for (int e = warp; e < count; e += nwarps) {
      visit(r, dense ? e : cur[e], t, j, arr, tl_last, tl_due, tl_live, nxt, &s_nnext,
            &s_wake, a, lane);
    }

    warp_argmin(a.v, a.i);
    const int w_qmax = warp_max(a.qmax);
    const int w_qmin = warp_min(a.qmin);
    if (lane == 0) {
      red[0][warp] = a.v;
      red[1][warp] = a.i;
      red[2][warp] = w_qmax;
      red[3][warp] = w_qmin;
    }
    __syncthreads();

    if (warp == 0) {
      const bool w = lane < nwarps;
      int v = w ? red[0][lane] : kNever;
      int i = w ? red[1][lane] : kNever;
      warp_argmin(v, i);
      const int qmax = warp_max(w ? red[2][lane] : 0);
      int qmin = warp_min(w ? red[3][lane] : kNever);
      if (count < n_tiles) {
        // The lowest tile not visited rests: its first server scores 0.
        for (int b = 0; b < n_tiles; b += 32) {
          const int tl = b + lane;
          const unsigned m = __ballot_sync(kFull, tl < n_tiles && tl_last[tl] != t);
          if (m) {
            argmin_merge(v, i, 0, (b + __ffs(m) - 1) * tile);
            break;
          }
        }
        qmin = 0;
      }
      if (lane == 0) {
        gap = max(gap, qmax - qmin);
        max_q = max(max_q, qmax);
        s_route = i;
        s_arr = a_next > 0 ? 1 : 0;
        int nn = s_nnext;
        const int ti = i / tile;
        if (a_next > 0 && !dense && !tl_live[ti]) nxt[nn++] = ti;
        s_ncur = nn;
        s_nnext = 0;
        if (r.rt_kind) s_next_rt = scan ? s_wake : min(s_next_rt, s_wake);
        s_wake = kNever;
      }
    }
    __syncthreads();
  }

  // The run's totals and maxima.
  const int v_msgs = warp_sum(a.msgs);
  const int v_deps = warp_sum(a.deps);
  const int v_arrs = warp_sum(a.arrs);
  const int v_drops = warp_sum(a.drops);
  const int v_aq = warp_max(a.max_aq);
  if (lane == 0) {
    fin[0][warp] = v_msgs;
    fin[1][warp] = v_deps;
    fin[2][warp] = v_arrs;
    fin[3][warp] = v_drops;
    fin[4][warp] = v_aq;
  }
  __syncthreads();
  if (tid == 0) {
    int tot[5] = {0, 0, 0, 0, 0};
    for (int w = 0; w < nwarps; ++w) {
      for (int f = 0; f < 4; ++f) tot[f] += fin[f][w];
      tot[4] = max(tot[4], fin[4][w]);
    }
    int* st = stats + run * 8;
    st[0] = tot[0];
    st[1] = tot[1];
    st[2] = tot[2];
    st[3] = tot[3];
    st[4] = tot[4];
    st[5] = max_q;
    st[6] = gap;
    st[7] = 0;
  }
}

// Dynamic shared memory of the tile table: five int32 words a tile.
static size_t table_bytes(int n_tiles) { return 5 * sizeof(int) * (size_t)n_tiles; }

// Launches on `stream`; returns cudaGetLastError() (0 on success) or the
// error of raising the kernel's dynamic shared memory limit.
extern "C" int care_route_launch(const int* arrive, const int* params, int* routed,
                                 int* q_out, int* ps_out, int* stats, int* scratch,
                                 int d, int t_slots, int k, int cap, int jsaq, int comm,
                                 int tile, int n_tiles, int threads, cudaStream_t stream) {
  const size_t smem = table_bytes(n_tiles);
  cudaError_t err = cudaFuncSetAttribute(
      care_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d > 0) {
    care_route_kernel<<<d, threads, smem, stream>>>(arrive, params, routed, q_out, ps_out,
                                                    stats, scratch, t_slots, k, cap, jsaq,
                                                    comm, tile, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
