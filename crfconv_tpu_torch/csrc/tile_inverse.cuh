// The transpose of a window-clamped slot list, shared by K8 (the gather's
// transpose) and the CRF cores' reverse steps (K11, K14: lam_t = S~^T dmsg_t).
//
// For each 64-row output tile t of an [B, M, K] list of slots, tile_inverse
// sorts the tile's slots by their clamped row relative to the tile's window
// (rel = clamp(v + front - start, 0, width - 1)) and, within one row, by
// slot: a counting sort in shared memory (a count per window row, their
// prefix sum, a place for each slot in its row's run, and an insertion sort
// of each short run). It writes the sorted slots (order, [B, M * K], each
// the slot's index within its batch) and the offsets of the runs (runs,
// [B, tiles, width + 1]: the run of rel is [runs[rel], runs[rel + 1])).
// With drop_negative, a negative v (the CRF operator's column of a clamped
// row outside [0, N)) goes to a bucket past the window that no row reads.
//
// row_tiles gives the tiles whose windows hold a row: the window starts
// ascend, so a binary search over them finds the range. A row's terms are
// then the runs of those tiles in ascending tile order, each run in slot
// order: ascending slot order over the whole batch, the order in which
// index_add_ on the CPU adds them.
#pragma once

#include <cuda_runtime.h>

namespace tile_inv {

constexpr int kThreads = 256;

// Exclusive prefix sum of a[0, n) in place, by the whole block. Each
// thread sums a contiguous chunk, the chunk sums are scanned across the
// block, and each chunk is rewritten from its offset.
__device__ inline void block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;  // inclusive scan of the chunk sums within the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int v = warp_sums[w];
      warp_sums[w] = run;
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
  __syncthreads();
}

__device__ __forceinline__ int window_rel(int v, int start, int front,
                                          int width, bool drop_negative) {
  if (drop_negative && v < 0) return width;  // the bucket no row reads
  return min(max(v + front - start, 0), width - 1);
}

__global__ void __launch_bounds__(kThreads)
    tile_inverse_kernel(const int* __restrict__ idx,
                        const int* __restrict__ starts, int* __restrict__ order,
                        int* __restrict__ runs, int m, int k, int tile,
                        int width, int front, bool drop_negative) {
  // count[width + 2] (the runs' offsets after the scan), then the slots
  // placed by row
  extern __shared__ int smem[];
  __shared__ int warp_sums[kThreads / 32];
  int* count = smem;
  int* placed = smem + width + 2;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int nt = gridDim.x;
  const int m0 = t * tile;
  const int slots = min(tile, m - m0) * k;
  const int start = starts[t];
  const int* ib = idx + ((long long)b * m + m0) * k;
  for (int i = threadIdx.x; i < width + 2; i += kThreads) count[i] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < slots; s += kThreads)
    atomicAdd(count + window_rel(ib[s], start, front, width, drop_negative),
              1);
  __syncthreads();
  block_exclusive_scan(count, width + 2, warp_sums);
  int* rb = runs + ((long long)b * nt + t) * (width + 1);
  for (int i = threadIdx.x; i <= width; i += kThreads) rb[i] = count[i];
  __syncthreads();
  // each slot takes a place in its row's run (in no fixed order) ...
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    const int rel = window_rel(ib[s], start, front, width, drop_negative);
    placed[atomicAdd(count + rel, 1)] = s;
  }
  __syncthreads();
  // ... and each run is sorted by slot (count[rel] is now its end): runs
  // hold a few slots each, the window's edge rows all clamped slots
  for (int rel = threadIdx.x; rel < width; rel += kThreads) {
    const int lo = rel == 0 ? 0 : count[rel - 1], hi = count[rel];
    for (int i = lo + 1; i < hi; ++i) {
      const int v = placed[i];
      int j = i - 1;
      while (j >= lo && placed[j] > v) {
        placed[j + 1] = placed[j];
        --j;
      }
      placed[j + 1] = v;
    }
  }
  __syncthreads();
  int* ob = order + ((long long)b * m + m0) * k;  // slots within batch b
  for (int i = threadIdx.x; i < slots; i += kThreads)
    ob[i] = m0 * k + placed[i];
}

// Launches tile_inverse over idx [b, m, k]: order [b, m * k], runs
// [b, tiles, width + 1]. Returns the launch's error code.
inline cudaError_t launch_tile_inverse(const int* idx, const int* starts,
                                       int* order, int* runs, int b, int m,
                                       int k, int tile, int width, int front,
                                       bool drop_negative, cudaStream_t st) {
  const int nt = (m + tile - 1) / tile;
  const size_t smem = sizeof(int) * (width + 2 + (size_t)tile * k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  tile_inverse_kernel<<<dim3(nt, b), kThreads, smem, st>>>(
      idx, starts, order, runs, m, k, tile, width, front, drop_negative);
  return cudaGetLastError();
}

// For the rows r0 + i, i < count (count <= blockDim.x), the range
// [t_lo[i], t_hi[i]) of tiles whose windows [starts[t] - front, + width)
// hold the row: the t with r + front - width < starts[t] <= r + front.
// tile_start holds starts[0, nt) in shared memory. Ends with a barrier.
__device__ inline void row_tiles(const int* tile_start, int nt, int r0,
                                 int count, int front, int width, int* t_lo,
                                 int* t_hi) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = r0 + i;
    int lo = 0, hi = nt;  // first t with starts[t] > r + front - width
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tile_start[mid] > r + front - width) hi = mid; else lo = mid + 1;
    }
    t_lo[i] = lo;
    hi = nt;  // first t with starts[t] > r + front
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tile_start[mid] > r + front) hi = mid; else lo = mid + 1;
    }
    t_hi[i] = lo;
  }
  __syncthreads();
}

}  // namespace tile_inv
