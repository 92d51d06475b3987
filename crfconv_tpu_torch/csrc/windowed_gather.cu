// K1: window-clamped neighbour gather, x[B,N,F], idx[B,M,K] -> out[B,M,K,F].
//
// Replaces crfconv_tpu/ops/windowed_pallas.py::windowed_gather_pallas
// (_kernel_large, _kernel_small). The TPU kernel selects rows with one-hot
// matmuls on the MXU and a hi/lo bf16 split (~2^-16 relative); here each
// element is a direct load, so the copy is exact f32.
//
// Bound: bytes. The kernel writes B*M*K*F floats and reads as many (each
// read is a row of a window that stays in the 50 MB L2). One block per
// (64-row output tile, batch); its threads walk the tile's (m, k, f)
// elements with f fastest, so the stores are contiguous and coalesced and
// each neighbour row is read as one contiguous run. The window is not
// staged in shared memory: at F = 643 it is about 2 MB.
#include "window.cuh"

__global__ void windowed_gather_kernel(const float* __restrict__ x,
                                       const int* __restrict__ idx,
                                       const int* __restrict__ starts,
                                       float* __restrict__ out, int n, int m,
                                       int k, int f, int tile, int width,
                                       int front) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int m0 = t * tile;
  const int rows = min(tile, m - m0);
  const int total = rows * k * f;
  const int start = starts[t];
  const float* xb = x + (long long)b * n * f;
  const int* ib = idx + ((long long)b * m + m0) * k;
  float* ob = out + ((long long)b * m + m0) * k * f;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int mk = e / f;  // (row - m0) * k + neighbour
    const int c = e - mk * f;
    const long long row = window_row(ib[mk], start, front, width);
    ob[e] = row_in(row, n) ? xb[row * f + c] : 0.0f;
  }
}

extern "C" int windowed_gather_f32(const void* x, const void* idx,
                                   const void* starts, void* out, int b, int n,
                                   int m, int k, int f, int tile, int width,
                                   int front, void* stream) {
  const int nt = (m + tile - 1) / tile;
  if (b == 0 || nt == 0 || k == 0 || f == 0) return -1;  // nothing to launch
  dim3 grid(nt, b);
  windowed_gather_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)idx, (const int*)starts, (float*)out, n, m,
      k, f, tile, width, front);
  return (int)cudaGetLastError();
}
