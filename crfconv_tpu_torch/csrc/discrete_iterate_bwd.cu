// K14: every step of the discrete CRF's reverse recurrence in one launch,
// the transpose of K13. With lam_steps = g (dL/dq_steps) and, for t =
// steps-1 .. 0, qn = q_{t+1} (q_last at t = steps-1, else qs[t+1]) and
// msg_t = msgs[t] (K13's saved residuals):
//
//   dz_t[m,:]  = qn[m,:] * (lam_{t+1}[m,:] - <lam_{t+1}[m,:], qn[m,:]>)
//   du        += dz_t                                   (du_in + sum_t dz_t)
//   dmsg_t     = -dz_t C^T                              (written to dmsgs[t])
//   dC        += msg_t^T dz_t
//   lam_t      = S~^T dmsg_t: lam_t[r,:] = sum over the slots (m, k) with
//                col[m,k] == r of w[m,k] * dmsg_t[m,:]
//
// and lam_out = lam_0 (dp). g, qs [steps,B,N,L], q_last, msgs, dmsgs, du_in,
// du_out, lam_out [B,N,L]; Ct = C^T, dC_in, dC_out [L,L]; du_in and dC_in
// may be null (zeros). du and dC carry no sign: the caller negates them
// (the gradients into u and C are -du and -dC), as
// crfconv_tpu/ops/crf_pallas.py::_discrete_core_bwd does. One step (steps
// = 1, lam = g, qn = q_last) is the one-step entry point.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_discrete_core_bwd
// (_bwd_discrete_kernel, with the row-layout band blocks of
// _banded_setup_rows), which keeps lam resident in VMEM across the steps
// and multiplies band blocks. Here a persistent cooperative grid runs every
// reverse step, one grid barrier a step, over a plan built once per
// backward call (discrete_iterate_bwd_plan_i32): S~^T as rows, each row's
// terms (w[m,k], m) in ascending slot order (K8's tile_inverse over col,
// dropping clamped rows outside the cloud, then a count, a scan and a fill
// of the rows). A block owns a run of items of R rows (128, 64 or 32 by L)
// and, for each reverse step t, per item:
//  1. stages with cp.async dmsg_{t+1}'s rows from the least to the greatest
//     source row of the item's terms (found once a launch; K9 keeps them
//     within the windows that meet the item, `cap` rows), the item's row
//     offsets and terms (tcap at a time: one chunk but for items whose rows
//     collect the most slots) and its msg_t rows;
//  2. forms lam_{t+1} of its rows from shared memory into the item's dz
//     buffer, a thread a (row, 4 classes) as in K13, each row's terms added
//     in ascending slot order from +0.0 (the order of index_add_ on the
//     CPU, so lam is bit-equal to the plain version run there; no atomics,
//     subnormals kept), or takes g at t = steps-1;
//  3. does step t's row work on the same rows: the dot product and dz in
//     class order (a row's lanes pass the partial sum along by shuffles),
//     du, and dmsg_t = -dz C^T (j ascending, C^T in shared memory), each
//     product and sum rounded on its own as the plain version, so dmsg and
//     du are bit-equal to it; q_{t+1} and du of a pass's rows are loaded
//     while the pass before runs;
//  4. adds its rows' msg_t^T dz_t into the block's [L, L] partial of dC in
//     shared memory (kept across the steps), a thread a (row of dC, 4
//     columns) over the item's rows, or over half of them where L is
//     small.
// After the last barrier the blocks form lam_0 and add their partials of
// dC in block order. A rerun is bit-identical.
//
// Bound: bytes. The fused call reads g, q_1..q_steps, the msg stack, C and
// the plan (row offsets and terms, which encode w and col) once and writes
// dp, du, dC and the dmsg stack once: at B16 x 8192, L = 20, K = 31, 10
// steps 0.11 ms on 3.35 TB/s (the ten one-step bounds, each step's inputs
// and outputs moved once, sum to 0.32 ms).
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <string.h>

#include "cp_async.cuh"
#include "tile_inverse.cuh"

namespace cg = cooperative_groups;

constexpr int DB_THREADS = 256;
constexpr int DB_WARPS = DB_THREADS / 32;
constexpr int DB_UNROLL = 8;          // terms whose loads are issued together
constexpr int DB_MAX_L = 128;
// dynamic shared memory a block may use, beside its 16 static bytes
constexpr int DB_SMEM_MAX = 231424;
constexpr int DB_SCAN_THREADS = 1024;

// ---------------------------------------------------------------------------
// the plan: S~^T by rows
// ---------------------------------------------------------------------------

constexpr int DB_PLAN_THREADS = 256;

// Block-wide exclusive prefix sum of one int a thread (DB_PLAN_THREADS
// threads); also returns the block's total.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[DB_PLAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int i = 0; i < DB_PLAN_THREADS / 32; ++i) {
    before += i < warp ? warp_sums[i] : 0;
    all += warp_sums[i];
  }
  *total = all;
  return before + incl - v;
}

// Row r of cloud b over the tile-wise transpose (tile_inverse's order and
// runs): the tiles whose windows hold r, [t_lo, t_hi), found by binary
// search over the window starts.
__device__ __forceinline__ void row_tile_range(const int* starts, int nt,
                                               int r, int front, int width,
                                               int* t_lo, int* t_hi) {
  int lo = 0, hi = nt;  // first t with starts[t] > r + front - width
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(starts + mid) > r + front - width) hi = mid; else lo = mid + 1;
  }
  *t_lo = lo;
  hi = nt;  // first t with starts[t] > r + front
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(starts + mid) > r + front) hi = mid; else lo = mid + 1;
  }
  *t_hi = lo;
}

struct PlanArgs {
  const int* starts;
  const int* order;
  const int* runs;
  const float* w;
  int* row_ptr;    // [rows + 1]
  int2* terms;     // [rows * k]
  int* bsum;       // [blocks]: the blocks' term counts, then their offsets
  long long rows;
  int n, k, tile, width, front, nt;
};

// FILL = false: each row's term count into row_ptr[m + 1] and each block's
// total into bsum. FILL = true (bsum now the blocks' offsets): row_ptr as
// the rows' ends, and every term (w[m,k], m) of row r, the tiles in
// ascending order, each run in slot order.
template <bool FILL>
__global__ void __launch_bounds__(DB_PLAN_THREADS)
plan_rows_kernel(const PlanArgs a) {
  const long long m = (long long)blockIdx.x * DB_PLAN_THREADS + threadIdx.x;
  const bool live = m < a.rows;
  const int b = live ? (int)(m / a.n) : 0, r = live ? (int)(m % a.n) : 0;
  int t_lo = 0, t_hi = 0;
  if (live) row_tile_range(a.starts, a.nt, r, a.front, a.width, &t_lo, &t_hi);
  const long long bk = (long long)b * a.n * a.k;
  int count = 0;
  if (!FILL) {
    for (int t = t_lo; t < t_hi; ++t) {
      const int* rb = a.runs + ((long long)b * a.nt + t) * (a.width + 1) +
                      (r + a.front - __ldg(a.starts + t));
      count += rb[1] - rb[0];
    }
    if (live) a.row_ptr[m + 1] = count;
    int total;
    block_scan(count, &total);
    if (threadIdx.x == 0) a.bsum[blockIdx.x] = total;
    return;
  }
  count = live ? a.row_ptr[m + 1] : 0;
  int total;
  const int start = a.bsum[blockIdx.x] + block_scan(count, &total);
  if (!live) return;
  a.row_ptr[m + 1] = start + count;
  if (m == 0) a.row_ptr[0] = 0;
  int2* out = a.terms + start;
  for (int t = t_lo; t < t_hi; ++t) {
    const int* rb = a.runs + ((long long)b * a.nt + t) * (a.width + 1) +
                    (r + a.front - __ldg(a.starts + t));
    const int* ob = a.order + bk + (long long)t * a.tile * a.k;
    const int end = rb[1];
#pragma unroll 4
    for (int j = rb[0]; j < end; ++j) {
      const int slot = ob[j];
      *out++ = make_int2(__float_as_int(a.w[bk + slot]), slot / a.k);
    }
  }
}

// bsum[0, n) from counts to their exclusive prefix sums, by one block: each
// thread sums a contiguous chunk, the chunk sums are scanned across the
// block, and each chunk is rewritten from its offset.
__global__ void __launch_bounds__(DB_SCAN_THREADS)
plan_scan_kernel(int* __restrict__ a, int n) {
  __shared__ int warp_sums[DB_SCAN_THREADS / 32];
  const int per = (n + DB_SCAN_THREADS - 1) / DB_SCAN_THREADS;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int i = 0; i < DB_SCAN_THREADS / 32; ++i) {
      const int v = warp_sums[i];
      warp_sums[i] = run;
      run += v;
    }
  }
  __syncthreads();
  int off = warp_sums[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = off;
    off += v;
  }
}

// packed int64s: col, w, starts, order, runs, bsum (scratch), row_ptr,
// terms, b, n, k, tile, width, front, stream. row_ptr [b*n + 1], terms
// [b*n*k], bsum [ceil(b*n / 256)].
extern "C" int discrete_iterate_bwd_plan_i32(const char* packed) {
  long long v[15];
  memcpy(v, packed, sizeof v);
  PlanArgs a;
  const int b = (int)v[8];
  a.n = (int)v[9];
  a.k = (int)v[10];
  a.tile = (int)v[11];
  a.width = (int)v[12];
  a.front = (int)v[13];
  a.rows = (long long)b * a.n;
  if (a.rows == 0) return -1;  // nothing to launch
  cudaStream_t st = (cudaStream_t)v[14];
  a.starts = (const int*)v[2];
  a.order = (const int*)v[3];
  a.runs = (const int*)v[4];
  a.bsum = (int*)v[5];
  a.w = (const float*)v[1];
  a.row_ptr = (int*)v[6];
  a.terms = (int2*)v[7];
  a.nt = (a.n + a.tile - 1) / a.tile;
  cudaError_t e = tile_inv::launch_tile_inverse(
      (const int*)v[0], a.starts, (int*)a.order, (int*)a.runs, b, a.n, a.k,
      a.tile, a.width, a.front, true, st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)((a.rows + DB_PLAN_THREADS - 1) / DB_PLAN_THREADS);
  plan_rows_kernel<false><<<blocks, DB_PLAN_THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  plan_scan_kernel<<<1, DB_SCAN_THREADS, 0, st>>>(a.bsum, blocks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  plan_rows_kernel<true><<<blocks, DB_PLAN_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the reverse steps
// ---------------------------------------------------------------------------

struct DbArgs {
  const float* g;        // lam_steps
  const float* qs;       // [steps, rows, L] (q_{t+1} = qs[t+1]) or null
  const float* q_last;   // q_steps
  const float* msgs;     // [steps, rows, L]
  const float* Ct;       // C^T
  const int* row_ptr;    // [rows + 1]
  const int2* terms;     // (w bits, source row in the cloud)
  const float* du_in;    // or null
  const float* dC_in;    // or null
  float* dmsgs;          // [steps, rows, L]
  float* lam_out;        // lam_0
  float* du_out;
  float* dC_out;
  float* part;           // [parts, L, L]: a block's partial of dC
  long long rows;
  int n, L, steps, R;    // R: rows of an item
  int cap;               // rows of dmsg an item may stage (0: none)
  int tcap;              // terms of an item staged at a time (even)
  int parts, per_block;
};

__host__ __device__ inline int db_align4(int v) { return (v + 3) / 4 * 4; }

// Row halves of an item over which dC's (row, 4 columns) sums are split:
// two where the L * L / 4 sums would leave most threads idle.
__host__ __device__ inline int db_halves(int L) {
  return L * L / 4 * 2 <= DB_THREADS ? 2 : 1;
}

// Shared memory, in floats: C^T and the partial of dC [L][L] each (and
// the partial's two halves over an item, s2), each item's span of dmsg
// rows and range of terms (4 ints), lam and then dz, and msg, of one item
// [R][L] each, the item's row offsets [R + 1], a chunk of its terms
// [tcap + 2] (2 ints each), dmsg's window.
__host__ __device__ inline size_t db_smem_floats(int L, int R, int per_block,
                                                 int tcap, int cap, bool s2) {
  return (s2 ? 4 : 2) * (size_t)db_align4(L * L) + 4 * (size_t)per_block +
         2 * (size_t)R * L + db_align4(R + 1) + 2 * ((size_t)tcap + 2) +
         (size_t)cap * L;
}

// Stage the terms [cb, ce) into tb + (cb & 1) as 16-byte copies from the
// even term at or below cb (the last one may copy a single term).
__device__ __forceinline__ void stage_terms(int2* tb, const int2* terms,
                                            int cb, int ce) {
  const int c0 = cb & ~1;
  for (int e = threadIdx.x; 2 * e < ce - c0; e += DB_THREADS) {
    const int j = c0 + 2 * e;
    cp_async16(tb + 2 * e, terms + j, ce - j >= 2 ? 16 : 8);
  }
}

template <int CPT, bool VEC4>
__device__ __forceinline__ void db_load(float (&v)[CPT], const float* x,
                                        long long src, int L, int c) {
  const float* r = x + src * L + c;
  if constexpr (VEC4) {
    const float4 t4 = *reinterpret_cast<const float4*>(r);
    v[0] = t4.x;
    v[1] = t4.y;
    v[2] = t4.z;
    v[3] = t4.w;
  } else {
#pragma unroll
    for (int q = 0; q < CPT; ++q) v[q] = c + q < L ? r[q] : 0.0f;
  }
}

template <int CPT, bool VEC4>
__device__ __forceinline__ void db_store(float* x, long long dst, int L,
                                         int c, const float (&v)[CPT]) {
  float* r = x + dst * L + c;
  if constexpr (VEC4) {
    *reinterpret_cast<float4*>(r) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      if (c + q < L) r[q] = v[q];
  }
}

// acc += w * ds[src - off, c : c + CPT] over the row's terms tr[j0, j1)
// (in shared memory) in term (slot) order, each product and sum rounded;
// ds is dmsg's window (off = its first row) or the cloud's rows (off = 0).
template <int CPT, bool VEC4>
__device__ __forceinline__ void transpose_row(float (&acc)[CPT],
                                              const float* ds, int off,
                                              const int2* tr, int j0, int j1,
                                              int L, int c) {
  for (int j = j0; j < j1; j += DB_UNROLL) {
    int2 tt[DB_UNROLL];
    float v[DB_UNROLL][CPT];
#pragma unroll
    for (int s = 0; s < DB_UNROLL; ++s)
      if (j + s < j1) tt[s] = tr[j + s];
#pragma unroll
    for (int s = 0; s < DB_UNROLL; ++s)
      if (j + s < j1) db_load<CPT, VEC4>(v[s], ds, tt[s].y - off, L, c);
#pragma unroll
    for (int s = 0; s < DB_UNROLL; ++s) {
      if (j + s < j1) {
        const float wv = __int_as_float(tt[s].x);
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(wv, v[s][q]));
      }
    }
  }
}

__device__ __forceinline__ void db_item(const DbArgs& a, long long it,
                                        long long* row0, int* nr,
                                        int* cloud) {
  const int per_cloud = (a.n + a.R - 1) / a.R;
  const int b = (int)(it / per_cloud);
  const int r0 = (int)(it % per_cloud) * a.R;
  *cloud = b;
  *nr = min(a.R, a.n - r0);
  *row0 = (long long)b * a.n + r0;
}

template <int CPT, bool VEC4>
__global__ void __launch_bounds__(DB_THREADS, 2)
discrete_bwd_kernel(const DbArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int lo_s, hi_s;
  const int L = a.L;
  const int G = (L + CPT - 1) / CPT;  // lanes of a row (<= 32)
  const int rpw = 32 / G;
  const int rpp = DB_WARPS * rpw;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rw = lane / G;
  const bool lane_live = rw < rpw;
  const int g = lane_live ? lane % G : 0;
  const int base = lane_live ? rw * G : 0;
  const int c = g * CPT;

  float* Cts = smem;
  float* P = Cts + db_align4(L * L);  // the block's partial of dC
  float* S2 = P + db_align4(L * L);   // an item's two halves of it
  int* span = reinterpret_cast<int*>(
      S2 + (VEC4 && db_halves(L) == 2 ? 2 * db_align4(L * L) : 0));
  float* dzb = reinterpret_cast<float*>(span + 4 * a.per_block);
  float* msb = dzb + a.R * L;
  int* rp = reinterpret_cast<int*>(msb + a.R * L);  // the item's row offsets
  int2* tb = reinterpret_cast<int2*>(rp + db_align4(a.R + 1));  // its terms
  float* win = reinterpret_cast<float*>(tb + a.tcap + 2);

  const long long items =
      (a.rows / a.n) * (long long)((a.n + a.R - 1) / a.R);
  const long long first = (long long)blockIdx.x * a.per_block;
  const long long last = min(items, first + a.per_block);
  const long long plane = a.rows * L;

  for (int e = threadIdx.x; e < L * L; e += DB_THREADS) {
    Cts[e] = a.Ct[e];
    P[e] = 0.0f;
  }
  // each item's span of source rows, once: dmsg's rows [lo, lo + n) it
  // stages, n = -1 where the span exceeds cap (reads from global), and its
  // range of terms
  for (long long it = first; it < last; ++it) {
    long long row0;
    int nr, b;
    db_item(a, it, &row0, &nr, &b);
    if (threadIdx.x == 0) {
      lo_s = INT_MAX;
      hi_s = -1;
    }
    __syncthreads();
    int lo = INT_MAX, hi = -1;
    const int j0 = __ldg(a.row_ptr + row0), j1 = __ldg(a.row_ptr + row0 + nr);
    for (int j = j0 + threadIdx.x; j < j1; j += DB_THREADS) {
      const int s = __ldg(a.terms + j).y;
      lo = min(lo, s);
      hi = max(hi, s);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0 && hi >= 0) {
      atomicMin(&lo_s, lo);
      atomicMax(&hi_s, hi);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int ns = hi_s < 0 ? 0 : hi_s - lo_s + 1;
      span[4 * (it - first)] = hi_s < 0 ? 0 : lo_s;
      span[4 * (it - first) + 1] = ns <= a.cap ? ns : -1;
      span[4 * (it - first) + 2] = j0;  // the item's terms [j0, j1)
      span[4 * (it - first) + 3] = j1;
    }
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  // phase t >= 0: lam_{t+1}, then step t's row work; phase -1: lam_0
  for (int t = a.steps - 1; t >= -1; --t) {
    const float* dsrc = t + 1 < a.steps ? a.dmsgs + (t + 1) * plane : nullptr;
    const float* qn =
        t >= 0 && t + 1 < a.steps ? a.qs + (t + 1) * plane : a.q_last;
    for (long long it = first; it < last; ++it) {
      long long row0;
      int nr, b;
      db_item(a, it, &row0, &nr, &b);
      const int lo = span[4 * (it - first)];
      const int ns = dsrc ? span[4 * (it - first) + 1] : 0;
      const float* db = dsrc ? dsrc + (long long)b * a.n * L : nullptr;
      // the item's terms [jb, je), staged tcap at a time, and row offsets
      const int jb = dsrc ? span[4 * (it - first) + 2] : 0;
      const int je = dsrc ? span[4 * (it - first) + 3] : 0;
      if (dsrc) {
        for (int e = threadIdx.x; e <= nr; e += DB_THREADS)
          cp_async4(rp + e, a.row_ptr + row0 + e, 4);
        stage_terms(tb, a.terms, jb, min(je, jb + a.tcap));
      }
      if (ns > 0) {  // dmsg_{t+1}'s rows that the item's terms read
        const float* src = db + (long long)lo * L;
        if constexpr (VEC4) {
          for (int e = threadIdx.x; e < ns * L / 4; e += DB_THREADS)
            cp_async16(win + 4 * e, src + 4 * e, 16);
        } else {
          for (int e = threadIdx.x; e < ns * L; e += DB_THREADS)
            cp_async4(win + e, src + e, 4);
        }
      }
      if (t >= 0) {  // msg_t of the item's rows
        const float* src = a.msgs + t * plane + row0 * L;
        if constexpr (VEC4) {
          for (int e = threadIdx.x; e < nr * L / 4; e += DB_THREADS)
            cp_async16(msb + 4 * e, src + 4 * e, 16);
        } else {
          for (int e = threadIdx.x; e < nr * L; e += DB_THREADS)
            cp_async4(msb + e, src + e, 4);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // lam_{t+1} of the item's rows into dzb, a chunk of terms at a time
      // (one for all but the items whose rows collect the most slots)
      for (int cb = jb; cb < je;) {
        const int ce = min(je, cb + a.tcap);
        const int2* tc = tb + (cb & 1) - cb;  // term j at tc[j]
        for (int p0 = 0; p0 < nr; p0 += rpp) {
          const int r = p0 + warp * rpw + rw;
          if (!lane_live || r >= nr) continue;
          float lam[CPT];
#pragma unroll
          for (int q = 0; q < CPT; ++q) lam[q] = 0.0f;
          if (cb > jb) db_load<CPT, VEC4>(lam, dzb, r, L, c);
          const int j0 = max(rp[r], cb), j1 = min(rp[r + 1], ce);
          if (ns > 0)
            transpose_row<CPT, VEC4>(lam, win, lo, tc, j0, j1, L, c);
          else
            transpose_row<CPT, VEC4>(lam, db, 0, tc, j0, j1, L, c);
          db_store<CPT, VEC4>(dzb, r, L, c, lam);
        }
        cb = ce;
        if (cb < je) {  // the next chunk
          __syncthreads();
          stage_terms(tb, a.terms, cb, min(je, cb + a.tcap));
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
      }

      // q_{t+1} and the running du of a pass's rows, loaded a pass ahead
      float qv_next[CPT], du_next[CPT];
      auto fetch = [&](int p0) {
        const int r = p0 + warp * rpw + rw;
#pragma unroll
        for (int q = 0; q < CPT; ++q) qv_next[q] = du_next[q] = 0.0f;
        if (t < 0 || !lane_live || r >= nr) return;
        db_load<CPT, VEC4>(qv_next, qn, row0 + r, L, c);
        if (t < a.steps - 1)
          db_load<CPT, VEC4>(du_next, a.du_out, row0 + r, L, c);
        else if (a.du_in)
          db_load<CPT, VEC4>(du_next, a.du_in, row0 + r, L, c);
      };
      fetch(0);
      for (int p0 = 0; p0 < nr; p0 += rpp) {
        const int r = p0 + warp * rpw + rw;
        const bool live = lane_live && r < nr;
        const long long m = row0 + r;
        float qv[CPT], du[CPT];
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          qv[q] = qv_next[q];
          du[q] = du_next[q];
        }
        if (p0 + rpp < nr) fetch(p0 + rpp);
        float lam[CPT];  // the row's lam_{t+1}: its own classes of dzb
#pragma unroll
        for (int q = 0; q < CPT; ++q) lam[q] = 0.0f;
        if (live) {
          if (!dsrc)
            db_load<CPT, VEC4>(lam, a.g, m, L, c);
          else if (je > jb)  // else no term: lam = 0
            db_load<CPT, VEC4>(lam, dzb, r, L, c);
        }
        if (t < 0) {  // lam_0
          if (live) db_store<CPT, VEC4>(a.lam_out, m, L, c, lam);
          continue;
        }
        // <lam, qn> in class order from +0.0 along the row's lanes
        float dot = 0.0f;
        for (int s = 0; s < G; ++s) {
          float part = dot;
          if (g == s) {
#pragma unroll
            for (int q = 0; q < CPT; ++q)
              if (c + q < L) part = __fadd_rn(part, __fmul_rn(lam[q], qv[q]));
          }
          dot = __shfl_sync(0xffffffffu, part, base + s);
        }
        float dz[CPT];
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          dz[q] = __fmul_rn(qv[q], __fsub_rn(lam[q], dot));
        float* zr = dzb + r * L;
        if (live) {
#pragma unroll
          for (int q = 0; q < CPT; ++q) du[q] = __fadd_rn(du[q], dz[q]);
          db_store<CPT, VEC4>(a.du_out, m, L, c, du);
          db_store<CPT, VEC4>(zr, 0, L, c, dz);
        }
        __syncwarp();
        if (live) {  // dmsg_t = -dz C^T, j ascending
          float acc[CPT];
#pragma unroll
          for (int q = 0; q < CPT; ++q) acc[q] = 0.0f;
          if constexpr (VEC4) {
            for (int j = 0; j < L; j += 4) {
              const float4 z4 = *reinterpret_cast<const float4*>(zr + j);
              const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                const float4 c4 =
                    *reinterpret_cast<const float4*>(Cts + (j + s) * L + c);
                acc[0] = __fadd_rn(acc[0], __fmul_rn(zv[s], c4.x));
                acc[1] = __fadd_rn(acc[1], __fmul_rn(zv[s], c4.y));
                acc[2] = __fadd_rn(acc[2], __fmul_rn(zv[s], c4.z));
                acc[3] = __fadd_rn(acc[3], __fmul_rn(zv[s], c4.w));
              }
            }
          } else {
            for (int j = 0; j < L; ++j) {
              const float zj = zr[j];
#pragma unroll
              for (int q = 0; q < CPT; ++q)
                if (c + q < L)
                  acc[q] = __fadd_rn(acc[q], __fmul_rn(zj, Cts[j * L + c + q]));
            }
          }
#pragma unroll
          for (int q = 0; q < CPT; ++q) acc[q] = -acc[q];
          db_store<CPT, VEC4>(a.dmsgs + t * plane, m, L, c, acc);
        }
      }
      __syncthreads();  // dz of every row in shared memory
      if (t >= 0 && VEC4) {
        // the block's dC += msg_t^T dz_t over the item: a thread sums one
        // (row of dC, 4 columns) over the item's rows into P, or, where L
        // is small, over half of them into S2, the halves then added into P
        // in order
        const int nq = L * L / 4, halves = db_halves(L);
        for (int e = threadIdx.x; e < nq * halves; e += DB_THREADS) {
          const int qd = e % nq, hf = e / nq;
          const int ra = qd / (L / 4), c4 = (qd % (L / 4)) * 4;
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int r = hf * nr / halves; r < (hf + 1) * nr / halves; ++r) {
            const float ma = msb[r * L + ra];
            const float4 d = *reinterpret_cast<const float4*>(dzb + r * L + c4);
            acc.x = fmaf(ma, d.x, acc.x);
            acc.y = fmaf(ma, d.y, acc.y);
            acc.z = fmaf(ma, d.z, acc.z);
            acc.w = fmaf(ma, d.w, acc.w);
          }
          float* o = (halves == 2 ? S2 + hf * L * L : P) + ra * L + c4;
          if (halves == 2) {
            *reinterpret_cast<float4*>(o) = acc;
          } else {
            o[0] += acc.x;
            o[1] += acc.y;
            o[2] += acc.z;
            o[3] += acc.w;
          }
        }
        if (halves == 2) {
          __syncthreads();
          for (int e = threadIdx.x; e < L * L; e += DB_THREADS)
            P[e] += S2[e] + S2[L * L + e];
        }
        __syncthreads();  // the window, msg and dz free for the next item
      } else if (t >= 0) {  // the block's dC += msg_t^T dz_t over the item
        for (int e = threadIdx.x; e < L * L; e += DB_THREADS) {
          const int ra = e / L, rc = e - ra * L;
          float acc = 0.0f;
          for (int r = 0; r < nr; ++r)
            acc = fmaf(msb[r * L + ra], dzb[r * L + rc], acc);
          P[e] += acc;
        }
        __syncthreads();  // the window, msg and dz free for the next item
      }
    }
    if (t == 0)
      for (int e = threadIdx.x; e < L * L; e += DB_THREADS)
        a.part[(long long)blockIdx.x * L * L + e] = P[e];
    if (t >= 0) grid.sync();  // dmsg_t (and the partials) complete
  }
  // dC_out = dC_in + the blocks' partials in block order
  const long long stride = (long long)gridDim.x * DB_THREADS;
  for (long long e = (long long)blockIdx.x * DB_THREADS + threadIdx.x;
       e < (long long)L * L; e += stride) {
    float acc = a.part[e];
    for (unsigned p = 1; p < gridDim.x; ++p)
      acc = __fadd_rn(acc, a.part[p * (long long)L * L + e]);
    a.dC_out[e] = __fadd_rn(a.dC_in ? a.dC_in[e] : 0.0f, acc);
  }
}

template <int CPT, bool VEC4>
static int launch(DbArgs a, cudaStream_t st) {
  auto kern = discrete_bwd_kernel<CPT, VEC4>;
  static int sms = 0;
  static size_t sizes[8];  // blocks an SM holds at the last sizes asked
  static int counts[8];
  static int used = 0;
  auto blocks_per_sm = [&](size_t bytes, int* per_sm) -> int {
    for (int i = 0; i < used; ++i)
      if (sizes[i] == bytes) return *per_sm = counts[i], 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kern, DB_THREADS, bytes);
    if (err != cudaSuccess) return (int)err;
    const int slot = used < 8 ? used++ : (int)(bytes / 16 % 8);
    sizes[slot] = bytes;
    counts[slot] = *per_sm;
    return 0;
  };
  cudaError_t e;
  if (sms == 0) {
    int dev;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DB_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
  }
  const long long items =
      (a.rows / a.n) * (long long)((a.n + a.R - 1) / a.R);
  auto bytes = [&](int per_block) {
    return db_smem_floats(a.L, a.R, per_block, a.tcap, a.cap,
                          VEC4 && db_halves(a.L) == 2) *
           sizeof(float);
  };
  if (bytes(1) > DB_SMEM_MAX) a.cap = 0;  // no room for the window
  int per_block = 1, per_sm = 0, rc;
  unsigned grid = 0;
  for (;;) {  // grow per_block until the grid and it agree
    const size_t smem = bytes(per_block);
    if (smem > DB_SMEM_MAX) return (int)cudaErrorInvalidValue;
    if ((rc = blocks_per_sm(smem, &per_sm)) != 0) return rc;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    const long long resident = (long long)per_sm * sms;
    grid = (unsigned)(items < resident ? items : resident);
    const int need = (int)((items + grid - 1) / grid);
    if (need <= per_block) break;
    per_block = need;
  }
  if ((int)grid > a.parts) return (int)cudaErrorInvalidValue;
  a.per_block = per_block;
  void* params[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)kern, grid, DB_THREADS,
                                          params, bytes(per_block), st);
}

// packed int64s: g, qs (or 0), q_last, msgs, Ct, row_ptr, terms, du_in (or
// 0), dC_in (or 0), dmsgs, lam_out, du_out, dC_out, part, b, n, L, steps,
// R, cap, tcap, parts, vec4, stream. vec4: L % 4 == 0 and every state
// pointer 16-byte aligned.
extern "C" int discrete_iterate_bwd_f32(const char* packed) {
  long long v[24];
  memcpy(v, packed, sizeof v);
  DbArgs a;
  a.g = (const float*)v[0];
  a.qs = (const float*)v[1];
  a.q_last = (const float*)v[2];
  a.msgs = (const float*)v[3];
  a.Ct = (const float*)v[4];
  a.row_ptr = (const int*)v[5];
  a.terms = (const int2*)v[6];
  a.du_in = (const float*)v[7];
  a.dC_in = (const float*)v[8];
  a.dmsgs = (float*)v[9];
  a.lam_out = (float*)v[10];
  a.du_out = (float*)v[11];
  a.dC_out = (float*)v[12];
  a.part = (float*)v[13];
  const int b = (int)v[14];
  a.n = (int)v[15];
  a.L = (int)v[16];
  a.steps = (int)v[17];
  a.R = (int)v[18];
  a.cap = (int)v[19];
  a.tcap = (int)v[20];
  a.parts = (int)v[21];
  const bool vec4 = v[22] != 0;
  a.per_block = 1;
  a.rows = (long long)b * a.n;
  if (a.rows == 0 || a.L == 0 || a.steps == 0) return -1;  // nothing to launch
  if (a.L > DB_MAX_L || a.R <= 0 || a.tcap < 2 || a.tcap % 2)
    return (int)cudaErrorInvalidValue;
  if (a.steps > 1 && a.qs == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)v[23];
  if (vec4) return launch<4, true>(a, st);
  if (a.L <= 32) return launch<1, false>(a, st);
  if (a.L <= 64) return launch<2, false>(a, st);
  return launch<4, false>(a, st);
}
