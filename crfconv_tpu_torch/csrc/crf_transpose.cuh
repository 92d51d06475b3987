// The transpose half of a CRF core's reverse step, shared by K11 (the
// continuous core) and K14 (the discrete core). Both end a step with
//
//   lam_t[b, r, :] = sum over the slots (m, j) with col[b, m, j] == r of
//                    w[b, m, j] * dmsg[b, m, :]          (lam_t = S~^T dmsg)
//   dW_out         = dW_in + sum_m P[m, :]^T Q[m, :]    (dM or dC)
//
// with no atomics, so both are identical from run to run:
//
//  * transpose (once per backward call): tile_inverse (tile_inverse.cuh,
//    K8's) over the operator's columns col [B, N, K], dropping the slots of
//    clamped rows outside [0, N) (col = -1). col is K1's window clamp, so
//    every other column lies in its tile's window.
//  * outer_partials: the rows are cut into `parts` chunks; block (a-tile,
//    c-tile, chunk) sums P^T Q over its chunk into its own [H, H] partial
//    (32 x 32, 64 or 128 entries a block, rows staged 32 at a time in
//    shared memory, in ascending row order).
//  * segment_sum: one thread per (row, 4 or 1 columns) walks the tiles
//    whose windows hold its row, and their runs, so it adds its terms
//    w * dmsg, each product rounded on its own, in ascending slot order
//    from +0.0: the order of index_add_ on the CPU, so lam_t is bit-equal to
//    the plain version run on the CPU. Each element is written once; no
//    zero pass. Its threads also reduce the partials in chunk order:
//    dW_out = dW_in + (part_0 + part_1 + ...).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "tile_inverse.cuh"

namespace crf_t {

constexpr int kThreads = tile_inv::kThreads;
constexpr int kRowsA = 32;    // a-rows of an outer_partials block
constexpr int kStage = 32;    // rows staged at a time

// part[p][a][c] = sum over the rows m of chunk p of P[m, a] Q[m, c]; a
// block takes 32 a-rows and 32 * kJ c-columns (kJ = 1, 2 or 4, the least
// that covers H up to 128), each thread 4 x kJ of them. Each thread loads
// its share of the next 32 rows into registers while the block sums the
// staged ones.
template <int kJ>
__global__ void __launch_bounds__(kThreads)
    outer_partials_kernel(const float* __restrict__ P,
                          const float* __restrict__ Q,
                          float* __restrict__ part, long long rows, int h,
                          long long chunk) {
  constexpr int kCols = 32 * kJ;
  constexpr int kLoadP = kStage * kRowsA / kThreads;   // 4 a thread
  constexpr int kLoadQ = kStage * kCols / kThreads;    // 4 kJ a thread
  __shared__ float ps[kStage][kRowsA + 1];
  __shared__ float qs[kStage][kCols];
  const int a0 = blockIdx.x * kRowsA, c0 = blockIdx.y * kCols;
  const long long m_lo = blockIdx.z * chunk;
  const long long m_hi = min(rows, m_lo + chunk);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float pr[kLoadP], qr[kLoadQ];
  auto load = [&](long long m0) {
#pragma unroll
    for (int i = 0; i < kLoadP; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kRowsA, a = e % kRowsA;
      const long long m = m0 + r;
      pr[i] = (m < m_hi && a0 + a < h) ? P[m * h + a0 + a] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kLoadQ; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kCols, c = e % kCols;
      const long long m = m0 + r;
      qr[i] = (m < m_hi && c0 + c < h) ? Q[m * h + c0 + c] : 0.0f;
    }
  };
  float acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.0f;
  if (m_lo < m_hi) load(m_lo);
  for (long long m0 = m_lo; m0 < m_hi; m0 += kStage) {
#pragma unroll
    for (int i = 0; i < kLoadP; ++i) {
      const int e = threadIdx.x + i * kThreads;
      ps[e / kRowsA][e % kRowsA] = pr[i];
    }
#pragma unroll
    for (int i = 0; i < kLoadQ; ++i) {
      const int e = threadIdx.x + i * kThreads;
      qs[e / kCols][e % kCols] = qr[i];
    }
    __syncthreads();
    if (m0 + kStage < m_hi) load(m0 + kStage);
#pragma unroll 8
    for (int r = 0; r < kStage; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pa = ps[r][ty + 8 * i];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          acc[i][j] = fmaf(pa, qs[r][tx + 32 * j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* pb = part + blockIdx.z * (long long)h * h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = c0 + tx + 32 * j;
      if (a < h && c < h) pb[(long long)a * h + c] = acc[i][j];
    }
  }
}

// the c-tile's width in warps of columns: 1, 2 or 4
inline int outer_cols_j(int h) { return h <= 32 ? 1 : (h <= 64 ? 2 : 4); }

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const float* __restrict__ dmsg,
                       const float* __restrict__ w,
                       const int* __restrict__ starts,
                       const int* __restrict__ order,
                       const int* __restrict__ runs,
                       float* __restrict__ lam_out, int n, int k, int h,
                       int tile, int width, int front, int nt,
                       int rows_per_block, const float* __restrict__ part,
                       int parts, const float* __restrict__ dw_in,
                       float* __restrict__ dw_out) {
  __shared__ int t_lo[kThreads], t_hi[kThreads];
  extern __shared__ int tile_start[];  // starts[0, nt)
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - r0);

  // dW_out = dW_in + the partials summed in chunk order, over the grid
  const long long hh = (long long)h * h;
  const long long stride = (long long)gridDim.x * gridDim.y * kThreads;
  for (long long e = ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                         kThreads + threadIdx.x;
       e < hh; e += stride) {
    float acc = part[e];
#pragma unroll 8
    for (int p = 1; p < parts; ++p) acc = __fadd_rn(acc, part[p * hh + e]);
    dw_out[e] = __fadd_rn(dw_in[e], acc);
  }

  for (int t = threadIdx.x; t < nt; t += kThreads) tile_start[t] = starts[t];
  __syncthreads();
  tile_inv::row_tiles(tile_start, nt, r0, rows, front, width, t_lo, t_hi);
  const int chunks = kVec ? h >> 2 : h;
  const long long base = (long long)b * n;     // the batch's first row
  const int* ob_batch = order + base * k;
  const float* wb = w + base * k;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int i = e / chunks;
    const int c = (e - i * chunks) * (kVec ? 4 : 1);
    const int r = r0 + i;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int t = t_lo[i]; t < t_hi[i]; ++t) {
      const int* rb = runs + ((long long)b * nt + t) * (width + 1) +
                      (r + front - tile_start[t]);
      const int* ob = ob_batch + (long long)t * tile * k;
      const int end = rb[1];
#pragma unroll 4
      for (int j = rb[0]; j < end; ++j) {
        const int slot = ob[j];
        const float wv = __ldg(wb + slot);
        const float* src = dmsg + (base + slot / k) * h + c;
        if (kVec) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(src));
          acc.x = __fadd_rn(acc.x, __fmul_rn(wv, v.x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(wv, v.y));
          acc.z = __fadd_rn(acc.z, __fmul_rn(wv, v.z));
          acc.w = __fadd_rn(acc.w, __fmul_rn(wv, v.w));
        } else {
          acc.x = __fadd_rn(acc.x, __fmul_rn(wv, __ldg(src)));
        }
      }
    }
    float* out = lam_out + (base + r) * h + c;
    if (kVec) {
      *reinterpret_cast<float4*>(out) = acc;
    } else {
      *out = acc.x;
    }
  }
}

// The transpose's structure of the operator col [b, n, k]: packed as 11
// int64s (col, starts, order, runs, b, n, k, tile, width, front, stream).
inline int build_transpose(const char* packed) {
  long long a[11];
  memcpy(a, packed, sizeof a);
  const int b = (int)a[4], n = (int)a[5], k = (int)a[6];
  if ((long long)b * n == 0) return -1;  // nothing to launch
  return (int)tile_inv::launch_tile_inverse(
      (const int*)a[0], (const int*)a[1], (int*)a[2], (int*)a[3], b, n, k,
      (int)a[7], (int)a[8], (int)a[9], true, (cudaStream_t)a[10]);
}

struct Tail {
  const float *dmsg, *w, *P, *Q, *dw_in;
  const int *starts, *order, *runs;
  float *lam_out, *dw_out, *part;
  int b, n, k, h, tile, width, front, parts;
};

// outer_partials, then segment_sum (which also reduces the partials)
inline cudaError_t launch_tail(const Tail& t, cudaStream_t st) {
  const long long rows = (long long)t.b * t.n;
  const long long chunk = (rows + t.parts - 1) / t.parts;
  const int cj = outer_cols_j(t.h);
  const dim3 pgrid((t.h + kRowsA - 1) / kRowsA,
                   (t.h + 32 * cj - 1) / (32 * cj), t.parts);
  auto partials = cj == 1 ? outer_partials_kernel<1>
                          : (cj == 2 ? outer_partials_kernel<2>
                                     : outer_partials_kernel<4>);
  partials<<<pgrid, kThreads, 0, st>>>(t.P, t.Q, t.part, rows, t.h, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nt = (t.n + t.tile - 1) / t.tile;
  const bool vec = t.h % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(t.dmsg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(t.lam_out) % 16 == 0;
  const int chunks = vec ? t.h / 4 : t.h;
  const int rows_per_block = chunks >= kThreads ? 1 : kThreads / chunks;
  const dim3 grid((t.n + rows_per_block - 1) / rows_per_block, t.b);
  const size_t smem = sizeof(int) * nt;  // the tiles' window starts
  auto kernel = vec ? segment_sum_kernel<true> : segment_sum_kernel<false>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, st>>>(
      t.dmsg, t.w, t.starts, t.order, t.runs, t.lam_out, t.n, t.k, t.h,
      t.tile, t.width, t.front, nt, rows_per_block, t.part, t.parts, t.dw_in,
      t.dw_out);
  return cudaGetLastError();
}

}  // namespace crf_t
