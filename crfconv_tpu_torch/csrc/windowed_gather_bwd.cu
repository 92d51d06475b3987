// K8: transpose of the window-clamped gather (K1),
//
//   dx[b, clamp(idx[b,m,k]), :] += g[b,m,k,:]
//
// g[B,M,K,F], idx[B,M,K] -> dx[B,N,F] f32; dx must be zeroed by the caller.
// A slot is clamped into its output tile's window exactly as K1 clamps it,
// and a clamped row outside [0, N) is dropped, so this is K1's exact
// transpose for every geometry (same-scale, strided sub_idx, 1-NN up_idx).
//
// Replaces crfconv_tpu/ops/windowed_pallas.py::windowed_gather_bwd_pallas
// (_bwd_kernel). The TPU kernel multiplies each tile's transposed one-hot
// matrix into per-tile window partials (MXU, hi/lo bf16 split) and
// overlap-adds the windows in XLA; it covers the same-scale geometry only.
// Here every slot adds its row of g into dx with f32 atomics, which reach
// the 50 MB L2 where dx lives. The order of the adds into one row varies
// from run to run, so dx is not bit-reproducible between runs (each sum is
// within float32 rounding of the exact one).
//
// Bound: bytes. g is read once (B*M*K*F floats) and dx written once; one
// add per element of g. One thread per element of g, f fastest, so a warp
// reads g in full sectors and its atomics go to a few contiguous rows.
#include "window.cuh"

__global__ void windowed_gather_bwd_kernel(const float* __restrict__ g,
                                           const int* __restrict__ idx,
                                           const int* __restrict__ starts,
                                           float* __restrict__ dx,
                                           long long total, int n, int m,
                                           int k, int f, int tile, int width,
                                           int front) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long slot = e / f;  // (b * m + row) * k + neighbour
  const int c = (int)(e - slot * f);
  const long long bm = slot / k;
  const int b = (int)(bm / m);
  const int row = (int)(bm - (long long)b * m);
  const long long r = window_row(idx[slot], starts[row / tile], front, width);
  if (!row_in(r, n)) return;
  atomicAdd(dx + ((long long)b * n + r) * f + c, g[e]);
}

extern "C" int windowed_gather_bwd_f32(const void* g, const void* idx,
                                       const void* starts, void* dx, int b,
                                       int n, int m, int k, int f, int tile,
                                       int width, int front, void* stream) {
  const long long total = (long long)b * m * k * f;
  if (total == 0) return -1;  // nothing to launch
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  windowed_gather_bwd_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const float*)g, (const int*)idx, (const int*)starts, (float*)dx, total,
      n, m, k, f, tile, width, front);
  return (int)cudaGetLastError();
}
