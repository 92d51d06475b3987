// K8: transpose of the window-clamped gather (K1),
//
//   dx[b, r, :] = sum over the slots (m, k) with clamp(idx[b,m,k]) == r of
//                 g[b, m, k, :], added in ascending slot order from +0.0
//
// g[B,M,K,F] (rows of F floats ld apart), idx[B,M,K] -> dx[B,N,F] f32.
// A slot is clamped into its output tile's window exactly as K1 clamps it,
// and a clamped row outside [0, N) is dropped, so this is K1's exact
// transpose for every geometry (same-scale, strided sub_idx, 1-NN up_idx).
// The sum order is index_add_'s on the CPU (index order), so dx is
// bit-equal to windowed_gather_bwd_plain run on the CPU, and identical from
// run to run.
//
// Replaces crfconv_tpu/ops/windowed_pallas.py::windowed_gather_bwd_pallas
// (_bwd_kernel). The TPU kernel multiplies each tile's transposed one-hot
// matrix into per-tile window partials (MXU, hi/lo bf16 split) and
// overlap-adds the windows in XLA; it covers the same-scale geometry only.
//
// Bound: bytes (g read once, dx written once). Two launches:
//  1. tile_inverse (tile_inverse.cuh, shared with K11 and K14): one block
//     per (64-row output tile, batch) sorts the tile's slots by (clamped
//     row relative to the window, slot) in shared memory: a count per
//     window row, their prefix sum (each row's run), a place for each slot
//     in its row's run, and a sort of each run by slot; it writes the
//     sorted slots and the runs' offsets (a CSR of the tile);
//  2. segment_sum: one thread per (dx row, 4 or 1 columns) walks the tiles
//     whose windows hold its row in ascending order (row_tiles: a binary
//     search over the tiles' window starts, held in shared memory), and
//     each tile's run for the row, and writes its sum once (0 for a row no
//     slot reaches). Lanes run across F, so a warp reads whole rows of g.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "tile_inverse.cuh"

constexpr int kThreads = tile_inv::kThreads;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const float* __restrict__ g,
                       const int* __restrict__ starts,
                       const int* __restrict__ order,
                       const int* __restrict__ runs, float* __restrict__ dx,
                       int n, int m, int k, int f, long long ld, int tile,
                       int width, int front, int nt, int rows_per_block) {
  __shared__ int t_lo[kThreads], t_hi[kThreads];
  extern __shared__ int tile_start[];  // starts[0, nt)
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - r0);
  for (int t = threadIdx.x; t < nt; t += kThreads) tile_start[t] = starts[t];
  __syncthreads();
  tile_inv::row_tiles(tile_start, nt, r0, rows, front, width, t_lo, t_hi);
  const int chunks = kVec ? f >> 2 : f;
  const float* gb = g + (long long)b * m * k * ld;
  for (int w = threadIdx.x; w < rows * chunks; w += kThreads) {
    const int i = w / chunks;
    const int col = (w - i * chunks) * (kVec ? 4 : 1);
    const int r = r0 + i;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int t = t_lo[i]; t < t_hi[i]; ++t) {
      const int* rb = runs + ((long long)b * nt + t) * (width + 1) +
                      (r + front - tile_start[t]);
      const int* ob = order + (long long)b * m * k + (long long)t * tile * k;
      const int end = rb[1];
#pragma unroll 4
      for (int j = rb[0]; j < end; ++j) {
        const float* row = gb + (long long)ob[j] * ld + col;
        if (kVec) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row));
          acc.x = __fadd_rn(acc.x, v.x);
          acc.y = __fadd_rn(acc.y, v.y);
          acc.z = __fadd_rn(acc.z, v.z);
          acc.w = __fadd_rn(acc.w, v.w);
        } else {
          acc.x = __fadd_rn(acc.x, __ldg(row));
        }
      }
    }
    float* out = dx + ((long long)b * n + r) * f + col;
    if (kVec) {
      *reinterpret_cast<float4*>(out) = acc;
    } else {
      *out = acc.x;
    }
  }
}

// The arguments arrive packed as 16 int64s (g, idx, starts, order, runs,
// dx, b, n, m, k, f, ld, tile, width, front, stream): one buffer costs the
// host less than ctypes' conversion of each argument.
extern "C" int windowed_gather_bwd_f32(const char* packed) {
  long long a[16];
  memcpy(a, packed, sizeof a);
  const void* g = (const void*)a[0];
  const void* idx = (const void*)a[1];
  const void* starts = (const void*)a[2];
  void* order = (void*)a[3];
  void* runs = (void*)a[4];
  void* dx = (void*)a[5];
  const int b = (int)a[6], n = (int)a[7], m = (int)a[8], k = (int)a[9],
            f = (int)a[10];
  const long long ld = a[11];
  const int tile = (int)a[12], width = (int)a[13], front = (int)a[14];
  void* stream = (void*)a[15];
  if ((long long)b * n * f == 0) return -1;  // nothing to launch
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = k == 0 ? 0 : (m + tile - 1) / tile;
  if (nt > 0) {
    const cudaError_t e = tile_inv::launch_tile_inverse(
        (const int*)idx, (const int*)starts, (int*)order, (int*)runs, b, m, k,
        tile, width, front, false, st);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = f % 4 == 0 && ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int chunks = vec ? f / 4 : f;
  const int rows_per_block = chunks >= kThreads ? 1 : kThreads / chunks;
  dim3 grid((n + rows_per_block - 1) / rows_per_block, b);
  const size_t smem = sizeof(int) * nt;  // the tiles' window starts
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vec ? segment_sum_kernel<true> : segment_sum_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (vec) {
    segment_sum_kernel<true><<<grid, kThreads, smem, st>>>(
        (const float*)g, (const int*)starts, (const int*)order,
        (const int*)runs, (float*)dx, n, m, k, f, ld, tile, width, front, nt,
        rows_per_block);
  } else {
    segment_sum_kernel<false><<<grid, kThreads, smem, st>>>(
        (const float*)g, (const int*)starts, (const int*)order,
        (const int*)runs, (float*)dx, n, m, k, f, ld, tile, width, front, nt,
        rows_per_block);
  }
  return (int)cudaGetLastError();
}
