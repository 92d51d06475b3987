// K12: the gradient of a CRF core into its edge weights,
//
//   ds[b,m,k] = sum_t < dmsg_t[b,m,:], x_t[b, col[b,m,k], :] >
//
// dmsgs, xs [T,B,N,H] (the reverse steps' dmsg_t and the forward's saved
// x_t or q_t), col [B,N,K] int32 (K9, -1 = reads zero) -> ds [B,N,K], all
// f32 but col.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::banded_neighbor_dot
// (_nbr_dot_kernel). The TPU kernel multiplies each 128-row tile by its
// whole window on the MXU ([128, w] products, hi/lo bf16) and picks the K
// columns out with iota compares; here only the K needed dot products are
// computed, from shared memory.
//
// A block owns 128 rows of one cloud (64 where K > 16). K9 clamped every
// column of a row into its 64-row tile's window, so the block's columns
// span few rows: it finds their least and greatest once, and for each
// step t and 32-column chunk stages x_t's rows of that span (at most its
// tiles' windows, `cap`) and its own dmsg_t rows in shared memory with
// cp.async, in two buffers, so that the next stage loads while this one is
// summed. (A block whose columns span more rows than that, never when col
// is K9's, reads x_t from global memory.) Four lanes own a row, two float4s
// each (eight lanes and one float4 where K > 16, whose K sums would not fit
// four lanes' registers; scalars where H % 4 != 0); an odd staged row is
// stored with its halves swapped, so that the two rows a quarter-warp reads
// fall in different banks half the time. Each lane keeps the row's K dot
// products in registers across every step and chunk, and the row's lanes
// add theirs with shuffles once at the end. dmsg_t is read once; x_t once a
// block instead of once a referencing slot.
//
// Where the clouds have too few blocks to fill the card (the coarse
// scales), the steps are split over `splits` blocks a row tile, each
// writing its partial sums; a second kernel adds them in split order. Every
// sum runs in one fixed order, with no atomics: a rerun is bit-identical.
//
// Bound: bytes (dmsgs and xs read once each, 2 * T*B*N*H floats; col, ds).
#include <climits>
#include <cuda_runtime.h>
#include <string.h>

#include "cp_async.cuh"

constexpr int ND_THREADS = 512;
constexpr int ND_CW = 32;     // columns a stage
constexpr int ND_STAGES = 2;  // buffers in the ring
constexpr int ND_SMEM_MAX = 231424;  // dynamic bytes a block may use

struct NdArgs {
  const float* dmsgs;
  const float* xs;
  const int* col;
  float* ds;    // [rows, k]
  float* part;  // [splits, rows, k] where splits > 1
  long long rows;
  int steps, splits, n, k, h, cap;
};

__host__ __device__ inline size_t nd_smem_bytes(int cap, int k, int rows) {
  return ND_STAGES * ((size_t)cap * ND_CW + rows * ND_CW) * sizeof(float) +
         (size_t)rows * k * sizeof(int);
}

// Stage x_t's rows [lo, lo + nst) and dmsg_t's block rows [row0, row0 +
// ROWS) of columns [c0, c0 + 32) (zero outside the cloud and beyond h).
// With four lanes a row (ROWS = 128) an odd row's halves are swapped.
template <int VEC, int ROWS>
__device__ __forceinline__ void nd_stage(const NdArgs& a, float* xb,
                                         float* db, const float* xt,
                                         const float* dt, int lo, int nst,
                                         int row0, int c0) {
  constexpr int PER = ND_CW / VEC;  // copies a row
  constexpr int SWAP = ROWS == 128 && VEC == 4 ? 16 : 0;
  for (int e = threadIdx.x; e < (nst + ROWS) * PER; e += ND_THREADS) {
    const int row = e / PER, cc = (e % PER) * VEC;
    const int c = c0 + cc;
    const bool x_row = row < nst;
    const int g = x_row ? lo + row : row0 + row - nst;
    const bool in = c < a.h && (x_row || g < a.n);
    const float* src = (x_row ? xt : dt) + (long long)g * a.h + c;
    const int sr = x_row ? row : row - nst;  // the row in its buffer
    float* dst = (x_row ? xb : db) + sr * ND_CW;
    if constexpr (VEC == 4)
      cp_async16(dst + (cc ^ (sr & 1) * SWAP), in ? src : xt, in ? 16 : 0);
    else
      cp_async4(dst + cc, in ? src : xt, in ? 4 : 0);
  }
}

template <int VEC, int KB, int ROWS>
__global__ void __launch_bounds__(ND_THREADS, 1)
crf_neighbor_dot_kernel(const NdArgs a) {
  constexpr int LANES = ND_THREADS / ROWS;  // lanes of a row
  constexpr int PER = ND_CW / LANES;        // columns of a lane
  constexpr int SWAP = ROWS == 128 && VEC == 4 ? 16 : 0;
  extern __shared__ __align__(16) float smem[];
  __shared__ int lo_s, hi_s;
  float* xst = smem;                        // [ND_STAGES][cap][ND_CW]
  float* dst = xst + ND_STAGES * a.cap * ND_CW;  // [ND_STAGES][ROWS][ND_CW]
  int* cv = reinterpret_cast<int*>(dst + ND_STAGES * ROWS * ND_CW);
  const int k = a.k, h = a.h;
  const int tiles = (a.n + ROWS - 1) / ROWS;
  const long long bn = (long long)(blockIdx.x / tiles) * a.n;  // cloud's row 0
  const int row0 = (blockIdx.x % tiles) * ROWS;
  const int t0 = (int)((long long)blockIdx.y * a.steps / a.splits);
  const int t1 = (int)((long long)(blockIdx.y + 1) * a.steps / a.splits);
  const long long plane = a.rows * h;

  if (threadIdx.x == 0) {
    lo_s = INT_MAX;
    hi_s = -1;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
  for (int e = threadIdx.x; e < ROWS * k; e += ND_THREADS) {
    const int c = row0 + e / k < a.n ? a.col[(bn + row0) * k + e] : -1;
    cv[e] = c;
    if (c >= 0) {
      lo = min(lo, c);
      hi = max(hi, c);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (threadIdx.x % 32 == 0 && hi >= 0) {
    atomicMin(&lo_s, lo);
    atomicMax(&hi_s, hi);
  }
  __syncthreads();
  lo = lo_s;
  const int span = hi_s < 0 ? 0 : hi_s - lo + 1;
  // a span wider than the staged rows (columns not clamped by K9 into one
  // window) takes the rows from global memory instead
  const bool staged = span <= a.cap;
  const int nst = staged ? span : 0;

  const int r = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const bool live = row0 + r < a.n;
  const int nt = t1 - t0;
  const int stages = ((h + ND_CW - 1) / ND_CW) * nt;  // (chunk, t), t fastest
  for (int kg = 0; kg < k; kg += KB) {
    float acc[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) acc[j] = 0.0f;
    // a ring of ND_STAGES buffers: stages i + 1 .. i + ND_STAGES - 1 load
    // while stage i is summed (one commit group a stage)
    for (int i = 0; i < ND_STAGES - 1; ++i) {
      if (i < stages) {
        const int t = t0 + i % nt;
        nd_stage<VEC, ROWS>(a, xst + i * a.cap * ND_CW, dst + i * ROWS * ND_CW,
                      a.xs + t * plane + bn * h, a.dmsgs + t * plane + bn * h,
                      lo, nst, row0, i / nt * ND_CW);
      }
      cp_async_commit();  // empty groups keep the count uniform
    }
    for (int i = 0; i < stages; ++i) {
      cp_async_wait<ND_STAGES - 2>();  // stage i has landed
      // stage i visible to every thread, and stage i - 1's buffer free
      __syncthreads();
      const int next = i + ND_STAGES - 1;
      if (next < stages) {
        const int t = t0 + next % nt;
        const int buf = next % ND_STAGES;
        nd_stage<VEC, ROWS>(a, xst + buf * a.cap * ND_CW, dst + buf * ROWS * ND_CW,
                      a.xs + t * plane + bn * h, a.dmsgs + t * plane + bn * h,
                      lo, nst, row0, next / nt * ND_CW);
      }
      cp_async_commit();
      const int t = t0 + i % nt;
      const int c0 = i / nt * ND_CW;
      const float* xb = xst + (i % ND_STAGES) * a.cap * ND_CW;
      const float* db = dst + (i % ND_STAGES) * ROWS * ND_CW + r * ND_CW;
      const float* xt = a.xs + t * plane + bn * h;
      // a lane's columns within the chunk: two float4s, 4 lane and 16 +
      // 4 lane (stored with an odd row's halves swapped, so that the two
      // rows a quarter-warp reads fall in different banks half the time),
      // or lane + 4 q
      int cc[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q)
        cc[q] = VEC == 4 ? (q / 4) * 4 * LANES + lane * 4 + q % 4
                         : lane + LANES * q;
      const int dsw = (r & 1) * SWAP;
      float dv[PER];
      if constexpr (VEC == 4) {
#pragma unroll
        for (int hf = 0; hf < PER / 4; ++hf) {
          const float4 d4 = *reinterpret_cast<const float4*>(
              db + ((hf * 4 * LANES + lane * 4) ^ dsw));
          dv[hf * 4] = d4.x;
          dv[hf * 4 + 1] = d4.y;
          dv[hf * 4 + 2] = d4.z;
          dv[hf * 4 + 3] = d4.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < PER; ++q) dv[q] = db[cc[q]];
      }
      if (staged) {
        // branch-free: a slot with col < 0 reads staged row 0 and adds
        // d * 0 (acc + 0 == acc)
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          const int c = live && kg + j < k ? cv[r * k + kg + j] : -1;
          const int gr = c < 0 ? 0 : c - lo;
          const float* xr = xb + gr * ND_CW;
          const int sw = (gr & 1) * SWAP;
          float xv[PER];
          if constexpr (VEC == 4) {
#pragma unroll
            for (int hf = 0; hf < PER / 4; ++hf) {
              const float4 x4 = *reinterpret_cast<const float4*>(
                  xr + ((hf * 4 * LANES + lane * 4) ^ sw));
              xv[hf * 4] = x4.x;
              xv[hf * 4 + 1] = x4.y;
              xv[hf * 4 + 2] = x4.z;
              xv[hf * 4 + 3] = x4.w;
            }
          } else {
#pragma unroll
            for (int q = 0; q < PER; ++q) xv[q] = xr[cc[q]];
          }
#pragma unroll
          for (int q = 0; q < PER; ++q)
            acc[j] = fmaf(dv[q], c < 0 ? 0.0f : xv[q], acc[j]);
        }
      } else {
        for (int j = 0; j < KB; ++j) {
          const int c = live && kg + j < k ? cv[r * k + kg + j] : -1;
          if (c < 0) continue;
          for (int q = 0; q < PER; ++q)
            if (c0 + cc[q] < h)
              acc[j] = fmaf(dv[q], xt[(long long)c * h + c0 + cc[q]], acc[j]);
        }
      }
    }
    __syncthreads();  // the ring free for the next slot group
    // the row's lanes add their sums, in one order
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float v = acc[j];
#pragma unroll
      for (int o = LANES / 2; o > 0; o /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (live && lane == 0 && kg + j < k) {
        const long long o = (bn + row0 + r) * k + kg + j;
        if (a.splits > 1)
          a.part[blockIdx.y * a.rows * k + o] = v;
        else
          a.ds[o] = v;
      }
    }
  }
}

// ds[i] = part[0][i] + part[1][i] + ..., in split order
__global__ void crf_neighbor_dot_sum(const float* __restrict__ part,
                                     float* __restrict__ ds, long long total,
                                     int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[s * total + i];
  ds[i] = v;
}

template <int VEC, int KB, int ROWS>
static int nd_launch(const NdArgs& a, int blocks, size_t smem,
                     cudaStream_t st) {
  auto kern = crf_neighbor_dot_kernel<VEC, KB, ROWS>;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  kern<<<dim3((unsigned)blocks, (unsigned)a.splits), ND_THREADS, smem, st>>>(
      a);
  return (int)cudaGetLastError();
}

// packed int64s: dmsgs, xs, col, ds, part (or 0), steps, splits, b, n, k,
// h, cap (the rows a block's columns may span), vec4 (both stacks 16-byte
// aligned, h % 4 == 0), block rows (128 for k <= 16, else 64), stream.
extern "C" int crf_neighbor_dot_f32(const char* packed) {
  long long v[15];
  memcpy(v, packed, sizeof v);
  NdArgs a;
  a.dmsgs = (const float*)v[0];
  a.xs = (const float*)v[1];
  a.col = (const int*)v[2];
  a.ds = (float*)v[3];
  a.part = (float*)v[4];
  a.steps = (int)v[5];
  a.splits = (int)v[6];
  const int b = (int)v[7];
  a.n = (int)v[8];
  a.k = (int)v[9];
  a.h = (int)v[10];
  const bool vec4 = v[12] != 0;
  const int rows = (int)v[13];
  cudaStream_t st = (cudaStream_t)v[14];
  a.rows = (long long)b * a.n;
  if (a.rows == 0 || a.k == 0) return -1;  // nothing to launch
  if (a.splits < 1 || (a.splits > 1 && a.part == nullptr) ||
      rows != (a.k <= 16 ? 128 : 64))
    return (int)cudaErrorInvalidValue;
  // staged rows: the window's width, at most the cloud and what fits
  int cap = (int)(v[11] < a.n ? v[11] : a.n);
  while (cap > 1 && nd_smem_bytes(cap, a.k, rows) > ND_SMEM_MAX) cap /= 2;
  a.cap = cap;
  const size_t smem = nd_smem_bytes(cap, a.k, rows);
  if (smem > ND_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = b * ((a.n + rows - 1) / rows);
  int rc;
  if (a.k <= 16)
    rc = vec4 ? nd_launch<4, 16, 128>(a, blocks, smem, st)
              : nd_launch<1, 16, 128>(a, blocks, smem, st);
  else
    rc = vec4 ? nd_launch<4, 32, 64>(a, blocks, smem, st)
              : nd_launch<1, 32, 64>(a, blocks, smem, st);
  if (rc != 0 || a.splits == 1) return rc;
  const long long total = a.rows * a.k;
  crf_neighbor_dot_sum<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      a.part, a.ds, total, a.splits);
  return (int)cudaGetLastError();
}
