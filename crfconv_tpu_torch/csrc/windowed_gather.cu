// K1: window-clamped neighbour gather, x[B,N,F], idx[B,M,K] -> out[B,M,K,F].
//
// Replaces crfconv_tpu/ops/windowed_pallas.py::windowed_gather_pallas
// (_kernel_large, _kernel_small). The TPU kernel selects rows with one-hot
// matmuls on the MXU and a hi/lo bf16 split (~2^-16 relative); here each
// element is a direct load, so the copy is exact f32.
//
// Bound: bytes. The kernel writes B*M*K*F floats and reads as many (each
// read is a row of a window that stays in the 50 MB L2). One block per
// (64-row output tile, batch), or a few blocks, each a part of the tile's
// run, where the tiles alone would not fill the card (the coarse scales).
// The tile's output is one contiguous run of rows*K*F floats:
//  - the block resolves each of the tile's rows*K slots once (the window
//    clamp) into a source offset row*F, or -1 for a zero row, in shared
//    memory;
//  - threads write the run as float4s (a scalar head up to its first
//    16-byte boundary and a scalar tail), each thread walking its
//    elements' (slot, column) with a carry instead of a division;
//  - where F % 4 == 0 and x is 16-byte aligned the four elements of a
//    store are one float4 load of one source row, else four scalar loads.
// The window is not staged in shared memory: at F = 320 it is 640 KB.
#include "window.cuh"

#include <cstdint>
#include <cstring>

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kFillBlocks = 1024;  // blocks that keep the card's SMs busy

template <bool kVecLoad>
__global__ void __launch_bounds__(kThreads)
    windowed_gather_kernel(const float* __restrict__ x,
                           const int* __restrict__ idx,
                           const int* __restrict__ starts,
                           float* __restrict__ out, int n, int m, int k, int f,
                           int tile, int width, int front) {
  extern __shared__ long long src[];  // source offset of each slot, or -1
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int part = blockIdx.z;  // of gridDim.z parts of the tile's float4s
  const int m0 = t * tile;
  const int slots = min(tile, m - m0) * k;
  const int start = starts[t];
  const float* xb = x + (long long)b * n * f;
  const int* ib = idx + ((long long)b * m + m0) * k;
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    const long long row = window_row(ib[s], start, front, width);
    src[s] = row_in(row, n) ? row * f : -1;
  }
  __syncthreads();

  const long long base = ((long long)b * m + m0) * k * f;
  float* ob = out + base;
  const int total = slots * f;
  // elements before the run's first 16-byte boundary, and the float4s
  const int head = min(total, (int)((4 - (base & 3)) & 3));
  const int all_vecs = (total - head) >> 2;
  const int per_part = (all_vecs + gridDim.z - 1) / gridDim.z;
  const int first = part * per_part;  // this block's float4s [first, vecs)
  const int vecs = min(all_vecs, first + per_part);
  if (part == 0 && threadIdx.x < head) {
    const int e = threadIdx.x;
    const int s = e / f;
    const long long o = src[s];
    ob[e] = o >= 0 ? __ldg(xb + o + (e - s * f)) : 0.0f;
  }
  // (s, c) of the first element of this thread's float4, advanced by
  // (step_s, step_c) = divmod(4 * kThreads, f) per float4; kUnroll float4s
  // are loaded before any is stored, so that their loads overlap
  const int e0 = head + 4 * (first + threadIdx.x);
  int s = e0 / f;
  int c = e0 - s * f;
  const int step_s = (4 * kThreads) / f;
  const int step_c = 4 * kThreads - step_s * f;
  float4* ov = reinterpret_cast<float4*>(ob + head);
  for (int v0 = first + threadIdx.x; v0 < vecs; v0 += kUnroll * kThreads) {
    float4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v0 + u * kThreads < vecs) {
        if (kVecLoad) {  // c % 4 == 0 and the four columns share the slot
          const long long o = src[s];
          r[u] = o >= 0 ? __ldg(reinterpret_cast<const float4*>(xb + o + c))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
          float e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int cj = c + j, sj = s;
            while (cj >= f) {
              cj -= f;
              ++sj;
            }
            const long long o = src[sj];
            e[j] = o >= 0 ? __ldg(xb + o + cj) : 0.0f;
          }
          r[u] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
      s += step_s;
      c += step_c;
      if (c >= f) {
        c -= f;
        ++s;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v0 + u * kThreads < vecs) ov[v0 + u * kThreads] = r[u];
    }
  }
  const int tail = head + 4 * all_vecs;
  if (part == gridDim.z - 1 && threadIdx.x < total - tail) {
    const int e = tail + threadIdx.x;
    const int s2 = e / f;
    const long long o = src[s2];
    ob[e] = o >= 0 ? __ldg(xb + o + (e - s2 * f)) : 0.0f;
  }
}

template <bool kVecLoad>
static int launch(const float* x, const int* idx, const int* starts,
                  float* out, int b, int n, int m, int k, int f, int tile,
                  int width, int front, cudaStream_t stream) {
  const size_t smem = sizeof(long long) * tile * k;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        windowed_gather_kernel<kVecLoad>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // parts per tile: enough blocks for every SM (132 on an H100) to hold
  // several, while each part keeps at least one unrolled pass of float4s
  const int tiles = (m + tile - 1) / tile;
  const long long vecs = (long long)tile * k * f / 4;
  const long long want = (kFillBlocks + (long long)tiles * b - 1) /
                         ((long long)tiles * b);
  const long long most = (vecs + kUnroll * kThreads - 1) / (kUnroll * kThreads);
  const int parts = (int)(want < most ? want : most);
  dim3 grid(tiles, b, parts > 1 ? parts : 1);
  windowed_gather_kernel<kVecLoad><<<grid, kThreads, smem, stream>>>(
      x, idx, starts, out, n, m, k, f, tile, width, front);
  return (int)cudaGetLastError();
}

// The arguments arrive packed as 13 int64s (x, idx, starts, out, b, n, m,
// k, f, tile, width, front, stream): one buffer costs the host less than
// ctypes' conversion of each argument.
extern "C" int windowed_gather_f32(const char* packed) {
  long long a[13];
  memcpy(a, packed, sizeof a);
  const void* x = (const void*)a[0];
  const void* idx = (const void*)a[1];
  const void* starts = (const void*)a[2];
  void* out = (void*)a[3];
  const int b = (int)a[4], n = (int)a[5], m = (int)a[6], k = (int)a[7],
            f = (int)a[8], tile = (int)a[9], width = (int)a[10],
            front = (int)a[11];
  void* stream = (void*)a[12];
  if (b == 0 || m == 0 || k == 0 || f == 0) return -1;  // nothing to launch
  // the run of one tile is indexed in int
  if ((long long)tile * k * f >= (1LL << 31) - 4 * kThreads)
    return (int)cudaErrorInvalidValue;
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? launch<true>((const float*)x, (const int*)idx,
                            (const int*)starts, (float*)out, b, n, m, k, f,
                            tile, width, front, (cudaStream_t)stream)
             : launch<false>((const float*)x, (const int*)idx,
                             (const int*)starts, (float*)out, b, n, m, k, f,
                             tile, width, front, (cudaStream_t)stream);
}
