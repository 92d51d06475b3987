// K2: in-window k-nearest-neighbour search.
//
// Replaces crfconv_tpu/ops/windowed_pallas.py::window_knn_pallas
// (_knn_kernel). For each 64-query tile the candidates are exactly the
// `width` rows of the tile's window; a row outside [0, N) is a sentinel at
// coordinate 2e9. Same-scale search pins the query's own row to -inf so it
// is column 0. Output indices are global, clipped to [0, N - 1].
//
// Distances use the association of the TPU kernel and of the plain
// version, d = (|q|^2 - 2 ((qx wx + qy wy) + qz wz)) + |w|^2, written with
// __fmul_rn / __fadd_rn (and built with -fmad=false) so no FMA contraction
// changes the rounding: the kernel selects the same indices as the plain
// version bit for bit.
//
// Selection orders candidates by distinct keys, k32 the order-preserving
// int32 image of d + 0.0 (-0 -> +0): exact mode the 64-bit (k32 << 32) |
// column (ties to the lowest index, as lax.top_k); packed mode clears the
// low 11 bits of k32 (distances within ~2^-13 relative tie), the TPU
// kernel's packed int32 key (k32 & ~2047) | column, which orders exactly as
// the 64-bit ((k32 & ~2047) << 32) | column while width <= 2048; wider
// packed windows take that 64-bit key.
//
// Design: one block per (tile, batch) stages the window's x, y, z and
// |p|^2 in shared memory (4 * width floats); one warp per query forms its
// distances in registers, 32 columns a step, and selects in one pass: for
// k = 1 each lane keeps its least key and the warp takes the least of
// them; for k <= 32 (warp_select.cuh, shared with K6) the first 32 keys
// are sorted across the lanes by a bitonic network, then each step's keys
// are offered, a ballot admitting those below the k-th kept one. Larger k
// take k rounds, each the least key above the previous pick, the
// distances formed again each round. Where tiles are few (the coarse
// scales) a tile's queries are split over up to 8 blocks, each staging
// the window.
//
// Bound: operations. Per query the kernel forms `width` distances (8
// operations each) and compares each key at least once; the bytes
// (positions in, k indices out) are small.
#include <cstdint>
#include <cstring>

#include <math_constants.h>

#include "warp_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using warp_select::kAll;
using warp_select::Max;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// packed, width <= 2048: the int32 (k32 & ~2047) | column
struct Key32 {
  using T = int;
  __device__ static T make(float d, int j, bool) {
    return (warp_select::order_bits(__fadd_rn(d, 0.0f)) & ~2047) | j;
  }
  __device__ static int col(T key) { return key & 2047; }
};

// exact, or packed wider than 2048: the int64 (k32 << 32) | column
struct Key64 {
  using T = long long;
  __device__ static T make(float d, int j, bool exact) {
    int k32 = warp_select::order_bits(__fadd_rn(d, 0.0f));
    if (!exact) k32 &= ~2047;
    return (T)(((unsigned long long)(unsigned)k32 << 32) | (unsigned)j);
  }
  __device__ static int col(T key) { return (int)(key & 0xFFFFFFFFLL); }
};

// the 32 lanes' keys sorted ascending across the lanes
template <typename T>
__device__ __forceinline__ T warp_sort(T v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const T other = __shfl_xor_sync(kAll, v, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_min ? (other < v ? other : v) : (other < v ? v : other);
    }
  }
  return v;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
window_knn_kernel(const float* __restrict__ q, const float* __restrict__ pos,
                  const int* __restrict__ starts, int* __restrict__ out,
                  int m, int n, int k, int tile, int width, int front,
                  int self_same, int exact) {
  using T = typename K::T;
  extern __shared__ float smem[];
  float* wx = smem;
  float* wy = wx + width;
  float* wz = wy + width;
  float* wn = wz + width;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int base = starts[t] - front;  // global row of window column 0
  const float* pb = pos + (long long)b * n * 3;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    const int g = base + j;
    float x = 2e9f, y = 2e9f, z = 2e9f;
    if (g >= 0 && g < n) {
      x = pb[3 * g];
      y = pb[3 * g + 1];
      z = pb[3 * g + 2];
    }
    wx[j] = x;
    wy[j] = y;
    wz[j] = z;
    wn[j] = sq3(x, y, z);
  }
  __syncthreads();

  // the tile's queries, split over gridDim.z blocks where tiles are few
  for (int r = blockIdx.z * kWarps + warp; r < tile;
       r += kWarps * gridDim.z) {
    const int row = t * tile + r;
    if (row >= m) break;
    const float* qr = q + ((long long)b * m + row) * 3;
    const float qx = qr[0], qy = qr[1], qz = qr[2];
    const float qn = sq3(qx, qy, qz);
    const int self_j = self_same ? row - base : -1;
    // the key of window column j, or the largest key past the window
    auto key_at = [&](int j) -> T {
      if (j >= width) return Max<T>::value;
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, wx[j]), __fmul_rn(qy, wy[j])),
          __fmul_rn(qz, wz[j]));
      const float d = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), wn[j]);
      return K::make(j == self_j ? -CUDART_INF_F : d, j, exact);
    };
    int* orow = out + ((long long)b * m + row) * k;
    if (k == 1) {   // each lane its least key, then the warp's
      T best = Max<T>::value;
      for (int j = lane; j < width; j += 32) {
        const T key = key_at(j);
        best = key < best ? key : best;
      }
      best = warp_select::warp_min(best);
      if (lane == 0) orow[0] = min(max(base + K::col(best), 0), n - 1);
    } else if (k <= 32) {
      warp_select::MinK<T> top(k, lane);
      top.kept = warp_sort(key_at(lane), lane);
      top.limit = __shfl_sync(kAll, top.kept, k - 1);
      for (int j0 = 32; j0 < width; j0 += 32) top.offer(key_at(j0 + lane));
      if (lane < k)
        orow[lane] = min(max(base + K::col(top.kept), 0), n - 1);
    } else {
      T prev = Max<T>::value;
      for (int sel = 0; sel < k; ++sel) {
        T best = Max<T>::value;
        for (int j = lane; j < width; j += 32) {
          const T key = key_at(j);
          if ((sel == 0 || key > prev) && key < best) best = key;
        }
        prev = warp_select::warp_min(best);
        if (lane == 0) orow[sel] = min(max(base + K::col(prev), 0), n - 1);
      }
    }
  }
}

template <typename K>
int launch(const float* q, const float* pos, const int* starts, int* out,
           int b, int m, int n, int k, int tile, int width, int front,
           int self_same, int exact, cudaStream_t stream) {
  const int nt = (m + tile - 1) / tile;
  const size_t smem = (size_t)4 * width * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_knn_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // enough blocks for eight an SM of an H100, up to a warp a query
  const int split = min((tile + kWarps - 1) / kWarps,
                        max(1, (132 * 8 + nt * b - 1) / (nt * b)));
  window_knn_kernel<K><<<dim3(nt, b, split), kThreads, smem, stream>>>(
      q, pos, starts, out, m, n, k, tile, width, front, self_same, exact);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments arrive packed as 14 int64s (q, pos, starts, out, b, m, n,
// k, tile, width, front, self_same, exact, stream).
extern "C" int window_knn_f32(const char* packed) {
  long long a[14];
  memcpy(a, packed, sizeof a);
  const int b = (int)a[4], m = (int)a[5], n = (int)a[6], k = (int)a[7],
            tile = (int)a[8], width = (int)a[9], front = (int)a[10],
            self_same = (int)a[11], exact = (int)a[12];
  const int nt = (m + tile - 1) / tile;
  if (b == 0 || nt == 0 || k == 0) return -1;  // nothing to launch
  if (k > width) return (int)cudaErrorInvalidValue;
  auto run = !exact && width <= 2048 ? launch<Key32> : launch<Key64>;
  return run((const float*)a[0], (const float*)a[1], (const int*)a[2],
             (int*)a[3], b, m, n, k, tile, width, front, self_same, exact,
             (cudaStream_t)a[13]);
}
