// K9: the continuous CRF's operator S~, built once per CRF call.
//
//   col[b,m,k] = clamp(idx[b,m,k])   if that row lies in [0, N), else -1
//
// idx[B,N,K] int32 (same-scale neighbours, self removed) -> col[B,N,K] int32.
// The clamp is K1's (window.cuh): each index is clamped into the window of
// its row's 64-row tile. Row m of S~ then holds s[m,k] at column col[m,k]
// (the weights are s itself, masked slots with s = 0 kept, duplicated
// columns adding up as separate slots), in the ELL layout the iterate
// kernels (K10, K11) and the neighbour dot (K12) read.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_banded_setup (_build_at_kernel),
// and the backward's _banded_setup_rows. The TPU kernel scatters the weights
// into dense [w, 128] band blocks (hi/lo bf16) for the MXU; on Hopper the
// iterations gather rows instead, so the operator is its columns. What this
// kernel saves is the clamp's integer division (one per element in K1, its
// bottleneck), paid once per call instead of at every one of the 2 * steps
// iterations of the forward and backward.
//
// Bound: bytes (idx read once, col written once). One thread per slot.
#include "window.cuh"

__global__ void crf_operator_kernel(const int* __restrict__ idx,
                                    const int* __restrict__ starts,
                                    int* __restrict__ col, long long total,
                                    int n, int k, int tile, int width,
                                    int front) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long bm = e / k;  // b * n + row
  const int row = (int)(bm % n);
  const long long r = window_row(idx[e], starts[row / tile], front, width);
  col[e] = row_in(r, n) ? (int)r : -1;
}

extern "C" int crf_operator_i32(const void* idx, const void* starts,
                                void* col, int b, int n, int k, int tile,
                                int width, int front, void* stream) {
  const long long total = (long long)b * n * k;
  if (total == 0) return -1;  // nothing to launch
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  crf_operator_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)starts, (int*)col, total, n, k, tile,
      width, front);
  return (int)cudaGetLastError();
}
