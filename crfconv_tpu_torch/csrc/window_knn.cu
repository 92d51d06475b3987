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
// Selection orders candidates by a 64-bit key (k32 << 32) | column, with
// k32 the order-preserving int32 image of d. Exact mode keeps all 32 bits
// (ties broken by lowest index, as lax.top_k); packed mode clears the low
// 11 bits (distances within ~2^-13 relative count as ties), the order of
// the TPU kernel's packed int32 key without its 2048-column limit. Each of
// the k rounds takes the least key above the previous pick, so nothing is
// written back between rounds.
//
// Bound: operations. Per query the kernel forms `width` distances and runs
// k rounds of a warp arg-min over them; the bytes (positions in, k indices
// out) are small. One block per (tile, batch) stages the window's x, y, z
// and |p|^2 in shared memory (4 * width floats); one warp per query keeps
// its distance row in shared memory and reduces with shuffles.
#include <climits>

#include <math_constants.h>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ long long select_key(float d, int j, int exact) {
  d = __fadd_rn(d, 0.0f);  // -0 -> +0, so integer order equals float order
  int k32 = __float_as_int(d);
  k32 ^= (k32 < 0) ? 0x7FFFFFFF : 0;
  if (!exact) k32 &= ~2047;
  return (long long)(((unsigned long long)(unsigned)k32 << 32) |
                     (unsigned)j);
}

}  // namespace

__global__ void window_knn_kernel(const float* __restrict__ q,
                                  const float* __restrict__ pos,
                                  const int* __restrict__ starts,
                                  int* __restrict__ out, int m, int n, int k,
                                  int tile, int width, int front,
                                  int self_same, int exact) {
  extern __shared__ float smem[];
  float* wx = smem;
  float* wy = wx + width;
  float* wz = wy + width;
  float* wn = wz + width;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* dist = wn + width + warp * width;

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

  for (int r = warp; r < tile; r += kWarps) {
    const int row = t * tile + r;
    if (row >= m) break;
    const float* qr = q + ((long long)b * m + row) * 3;
    const float qx = qr[0], qy = qr[1], qz = qr[2];
    const float qn = sq3(qx, qy, qz);
    const int self_j = self_same ? row - base : -1;
    for (int j = lane; j < width; j += 32) {
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, wx[j]), __fmul_rn(qy, wy[j])),
          __fmul_rn(qz, wz[j]));
      float d = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), wn[j]);
      dist[j] = (j == self_j) ? -CUDART_INF_F : d;
    }
    __syncwarp();
    int* orow = out + ((long long)b * m + row) * k;
    long long prev = LLONG_MIN;
    for (int sel = 0; sel < k; ++sel) {
      long long best = LLONG_MAX;
      for (int j = lane; j < width; j += 32) {
        const long long key = select_key(dist[j], j, exact);
        if (key > prev && key < best) best = key;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const long long other = __shfl_xor_sync(0xFFFFFFFFu, best, off);
        best = other < best ? other : best;
      }
      prev = best;
      if (lane == 0) {
        const int g = base + (int)(best & 0xFFFFFFFFLL);
        orow[sel] = min(max(g, 0), n - 1);
      }
    }
    __syncwarp();
  }
}

extern "C" int window_knn_f32(const void* q, const void* pos,
                              const void* starts, void* out, int b, int m,
                              int n, int k, int tile, int width, int front,
                              int self_same, int exact, void* stream) {
  const int nt = (m + tile - 1) / tile;
  if (b == 0 || nt == 0 || k == 0) return -1;  // nothing to launch
  const size_t smem = (size_t)(4 + kWarps) * width * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(nt, b);
  window_knn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)pos, (const int*)starts, (int*)out, m, n,
      k, tile, width, front, self_same, exact);
  return (int)cudaGetLastError();
}
