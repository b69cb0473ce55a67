// Batched sequential JSAQ dispatch for Hopper (sm_90a), as a level fill.
//
// Replaces the Pallas TPU kernel jsaq_route_pallas (repro/kernels/jsaq_route.py,
// body _jsaq_kernel, segmented argmin seg_argmin).  Per row of a (D, K) int32
// state: num_jobs times take the argmin (lowest index on ties) and add one
// job to the chosen server.
//
// The chain has a closed form.  With m the row minimum and a_i = q_i - m,
// the n-th job goes to the n-th smallest pair of the merged stream {(a_i + c,
// i) : c >= 0}: the jobs fill the row level by level, and the jobs of level
// v go to the servers with a_i <= v in index order.  Let cnt(v) be the
// number of such servers and P(v) = sum_{u < v} cnt(u) the jobs placed below
// level v.  The fill level L is the v with P(v) <= N < P(v + 1), rem = N -
// P(L) jobs land on level L, and q'_i = m + L (+1 for the first rem servers
// with a_i <= L) where a_i <= L, else q_i.  Between two consecutive distinct
// values of a the set of servers at or below the level and each server's
// rank in it stay the same, so one round per distinct value places a whole
// run of levels: the job at level v and rank r is idx[P(v1) + (v - v1)
// cnt(v1) + r].  To reach the d-th distinct value, d (d - 1) / 2 jobs must
// come first, so there are at most floor((1 + sqrt(1 + 8 N)) / 2) rounds (23
// at N = 256).  A server with a_i >= N never receives a job, so a histogram
// of N bins finds L.  int32 wraps as the chain does: once every server
// stands at INT32_MAX (P(V) < N for V = INT32_MAX - m), the next job goes to
// server 0, which wraps to INT32_MIN and takes every later job of the row.
// kernels/jsaq_route.py:jsaq_route_levels is the same schedule in plain
// PyTorch, tested on the CPU.
//
// What bounds it on this card: the bytes are 4 (2 D K + D N) (0.17 us at D
// = 64, K = 1000, N = 256), far below an empty launch (~1.9 us), so latency
// does: the passes over the row and the block barriers of their scans.  The
// chain it replaces ran N dependent block argmins (~0.73 us each).
//
// Design: one block per row (rows are independent and run on separate
// SMs): (1) the row minimum, (2) a shared-memory histogram of a_i < N, (3)
// cnt, P and the distinct values that take a job (the rounds) by three
// block-wide scans over the bins, kItems bins a thread, stopping once P
// passes N, (4) two sweeps over each warp's segment of the row, counting by
// ballot, one scan of the warps' counts between them, that write q', the
// fill level's jobs, and the list of servers with a_i < L in index order
// (at most N of them, since each takes a job), (5) the full rounds, one a
// warp and all at once, each ranking the list by ballot.  The histogram,
// the list and the rounds live in shared memory when they fit in what a
// block may opt in to (jsaq_route_smem_max), else in a device scratch that
// the binding allocates: at D = 16, K = 1e5, N = 4096 the scratch took 1.7x
// as long (PERF.md).  Nothing is padded: any K >= 1 and N >= 0.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kItems = 4;  // consecutive bins a thread scans
constexpr int kSweep = 4;  // loads in flight a lane in the sweeps over the row

// Exclusive block-wide scan of x; `total` gets the block's sum.  `sh` holds
// 32 values; the call begins and ends with a barrier, so it may be reused.
template <typename T>
__device__ __forceinline__ T block_scan(T x, T* sh, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  T inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nw ? sh[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) sh[lane] = w;
  }
  __syncthreads();
  total = sh[nw - 1];
  return (warp ? sh[warp - 1] : T(0)) + inc - x;
}

__device__ __forceinline__ int block_min(int x, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  x = __reduce_min_sync(0xffffffffu, x);
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  int r = sh[0];
  for (int w = 1; w < nw; ++w) r = min(r, sh[w]);
  __syncthreads();
  return r;
}

// One round: the levels [v, v_end) that the servers with a <= v fill, cnt of
// them, the first of its jobs at p.
struct Round {
  int v, cnt, p;
};

__global__ void __launch_bounds__(1024)
jsaq_route_kernel(const int* __restrict__ q_in, int* __restrict__ idx, int* __restrict__ q_out,
                  int k, int n, int max_rounds, int* __restrict__ scratch) {
  extern __shared__ int dyn[];
  __shared__ long long sh64[32];
  __shared__ int sh32[32];
  __shared__ int s_fill[3];  // L, rem, P(V)
  const long long row = blockIdx.x;
  const int* qi = q_in + row * k;
  int* qo = q_out + row * k;
  int* ix = idx + row * (long long)n;
  // Work space: the histogram (n), the list's servers (n) and their a (n),
  // then the rounds.
  int* hist = scratch ? scratch + row * (3LL * n + 3LL * max_rounds) : dyn;
  int* list = hist + n;
  int* list_a = list + n;
  Round* rounds = reinterpret_cast<Round*>(list_a + n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int chunk = blockDim.x * kItems;

  // (1) the row minimum.
  int mn = INT_MAX;
#pragma unroll 8
  for (int s = tid; s < k; s += blockDim.x) mn = min(mn, qi[s]);
  const int m = block_min(mn, sh32);
  const unsigned um = static_cast<unsigned>(m);

  // (2) the histogram of a_i < n.
  for (int v = tid; v < n; v += blockDim.x) hist[v] = 0;
  if (tid == 0) {
    s_fill[0] = n;  // L when no bin is the fill level: P(n) = n
    s_fill[1] = 0;
    s_fill[2] = n;  // P(V) when V >= n, or past where the scan stopped
  }
  __syncthreads();
#pragma unroll 8
  for (int s = tid; s < k; s += blockDim.x) {
    const unsigned a = static_cast<unsigned>(qi[s]) - um;
    if (a < static_cast<unsigned>(n)) atomicAdd(&hist[a], 1);
  }
  __syncthreads();

  // (3) cnt, P and the rounds, a chunk of bins at a time, until P passes n.
  const unsigned V = static_cast<unsigned>(INT_MAX) - um;  // INT32_MAX's level
  long long cnt_carry = 0, p_carry = 0;
  int r_carry = 0;
  for (int v0 = 0; v0 < n && p_carry <= n; v0 += chunk) {
    const int vb = v0 + tid * kItems;
    int h[kItems];
    long long c_loc = 0;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      h[e] = vb + e < n ? hist[vb + e] : 0;
      c_loc += h[e];
    }
    long long tot;
    const long long c_pre = cnt_carry + block_scan(c_loc, sh64, tot);
    cnt_carry += tot;
    long long cnt[kItems], p_loc = 0;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      cnt[e] = (e ? cnt[e - 1] : c_pre) + h[e];
      p_loc += cnt[e];
    }
    long long p = p_carry + block_scan(p_loc, sh64, tot);
    p_carry += tot;
    int f_loc = 0;
    long long pv[kItems];
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      pv[e] = p;
      f_loc += (h[e] > 0 && p < n);
      p += cnt[e];
    }
    int f_tot;
    int r = r_carry + block_scan(f_loc, sh32, f_tot);
    r_carry += f_tot;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int v = vb + e;
      if (v >= n) break;
      if (h[e] > 0 && pv[e] < n) {
        if (r < max_rounds) rounds[r] = Round{v, static_cast<int>(cnt[e]), static_cast<int>(pv[e])};
        ++r;
      }
      if (pv[e] <= n && n < pv[e] + cnt[e]) {
        s_fill[0] = v;
        s_fill[1] = static_cast<int>(n - pv[e]);
      }
      if (static_cast<unsigned>(v) == V) s_fill[2] = static_cast<int>(min(pv[e], (long long)n));
    }
  }
  __syncthreads();
  int fill = s_fill[0], rem = s_fill[1];
  const int p_wrap = s_fill[2];
  const bool wrap = V < static_cast<unsigned>(n) && p_wrap < n;
  if (wrap) {  // every server reaches INT32_MAX; jobs p_wrap.. go to server 0
    fill = static_cast<int>(V);
    rem = 0;
  }
  const int n_rounds = min(r_carry, max_rounds);
  const int n_full = n_rounds - (n_rounds > 0 && rounds[n_rounds - 1].v == fill);
  const unsigned level = um + static_cast<unsigned>(fill);
  const unsigned fill_u = static_cast<unsigned>(fill);
  const int p_fill = n - rem;

  // (4) q', the fill level's jobs, and the list of servers below it, in
  // two sweeps of each warp's segment of the row: count the servers below
  // and at the level, scan the warps' counts, then place by ballot.
  const int seg = ((k + nw - 1) / nw + 31) & ~31;
  const int s_lo = min(k, warp * seg), s_hi = min(k, s_lo + seg);
  long long counts = 0;  // (a <= L) << 32 | (a < L), this warp's
  for (int s0 = s_lo; s0 < s_hi; s0 += 32 * kSweep) {
    unsigned a[kSweep];
#pragma unroll
    for (int e = 0; e < kSweep; ++e) {
      const int s = s0 + 32 * e + lane;
      a[e] = s < s_hi ? static_cast<unsigned>(qi[s]) - um : 0xffffffffu;
    }
#pragma unroll
    for (int e = 0; e < kSweep; ++e) {
      counts += (static_cast<long long>(__popc(__ballot_sync(0xffffffffu, a[e] <= fill_u))) << 32) +
                __popc(__ballot_sync(0xffffffffu, a[e] < fill_u));
    }
  }
  long long tot;
  const long long pre = __shfl_sync(0xffffffffu, block_scan(lane ? 0LL : counts, sh64, tot), 0);
  int lt = static_cast<int>(pre & 0xffffffff), le = static_cast<int>(pre >> 32);
  const int listed = static_cast<int>(tot & 0xffffffff);
  const unsigned below = (1u << lane) - 1;
  for (int s0 = s_lo; s0 < s_hi; s0 += 32 * kSweep) {
    int qv[kSweep];
#pragma unroll
    for (int e = 0; e < kSweep; ++e) {
      const int s = s0 + 32 * e + lane;
      qv[e] = s < s_hi ? qi[s] : 0;
    }
#pragma unroll
    for (int e = 0; e < kSweep; ++e) {
      const int s = s0 + 32 * e + lane;
      const unsigned a = s < s_hi ? static_cast<unsigned>(qv[e]) - um : 0xffffffffu;
      const unsigned at = __ballot_sync(0xffffffffu, a <= fill_u);
      const unsigned under = __ballot_sync(0xffffffffu, a < fill_u);
      if (a <= fill_u) {
        const int rank = le + __popc(at & below);
        const bool extra = rank < rem;
        if (extra) ix[p_fill + rank] = s;
        unsigned out = level + extra;
        if (wrap && s == 0) out += static_cast<unsigned>(n - p_wrap);
        qo[s] = static_cast<int>(out);
        if (a < fill_u) {
          const int pos = lt + __popc(under & below);
          list[pos] = s;
          list_a[pos] = static_cast<int>(a);
        }
      } else if (s < s_hi) {
        qo[s] = qv[e];
      }
      le += __popc(at);
      lt += __popc(under);
    }
  }
  if (wrap) {
    for (int j = p_wrap + tid; j < n; j += blockDim.x) ix[j] = 0;
  }
  __syncthreads();

  // (5) the full rounds, a warp each: rank the list's servers at or below
  // the round's value by ballot, and write every level of the round.
  for (int j = warp; j < n_full; j += nw) {
    const Round rd = rounds[j];
    const int span = (j + 1 < n_full ? rounds[j + 1].v : fill) - rd.v;
    int rank = 0;
    for (int b = 0; b < listed; b += 32) {
      const int i = b + lane;
      const bool take = i < listed && list_a[i] <= rd.v;
      const unsigned ballot = __ballot_sync(0xffffffffu, take);
      if (take) {
        const int srv = list[i];
        int pos = rd.p + rank + __popc(ballot & ((1u << lane) - 1));
        for (int l = 0; l < span; ++l, pos += rd.cnt) ix[pos] = srv;
      }
      rank += __popc(ballot);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  With
// `scratch` null the work space is dynamic shared memory; else `scratch`
// holds d * (3 num_jobs + 3 max_rounds) ints: a row's histogram, list and
// its levels (num_jobs each), and rounds (3 ints each).
extern "C" int jsaq_route_launch(const int* q_in, int* idx, int* q_out, int d, int k,
                                 int num_jobs, int max_rounds, int threads, int* scratch,
                                 cudaStream_t stream) {
  if (d > 0 && k > 0) {
    const size_t smem =
        scratch ? 0 : sizeof(int) * (3 * static_cast<size_t>(num_jobs) + 3 * max_rounds);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          jsaq_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    jsaq_route_kernel<<<d, threads, smem, stream>>>(q_in, idx, q_out, k, num_jobs, max_rounds,
                                                    scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

// The most dynamic shared memory, in bytes, that a block may take on the
// current device: its opt-in limit less the kernel's static shared memory;
// -1 if the device cannot be asked.
extern "C" int jsaq_route_smem_max() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, jsaq_route_kernel) != cudaSuccess) {
    return -1;
  }
  return optin - static_cast<int>(attr.sharedSizeBytes);
}
