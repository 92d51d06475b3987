// K7: fused weighted gather-reduce, the train-path point-conv contraction.
//
//   xg[b,m,k,:] = x[b, clamp(idx[b,m,k]), :]       (K1's window clamp)
//   out[b,m,:]  = sum_k u[b,m,k,:] * xg[b,m,k,:]
//
// x[B,N,H], u[B,M,K,H], idx[B,M,K] -> out[B,M,H], xg[B,M,K,H], all f32.
//
// Replaces crfconv_tpu/ops/windowed_pallas.py::windowed_weighted_reduce_pallas
// (_kernel_weighted_reduce). The TPU kernel DMAs each tile's window into VMEM
// in a transposed lane layout, selects with lane dynamic-gathers and folds K
// in lane pairs; none of that is carried over. Here each element of xg is a
// direct load of a row of x (which stays in the 50 MB L2), so xg is exactly
// K1's output and the sum over k runs in one register, k ascending, each
// product and sum rounded on its own (no FMA): the plain version adds in the
// same order, so the two are bit-equal. Any other order moves out by ~1e-7,
// which in training flips a few max-pool and leaky-ReLU choices downstream
// and moves the step's gradients by ~1e-3.
//
// Bound: bytes. u is read and xg written once (2 * B*M*K*H floats), against
// 2 operations per element of u. One thread per (b, m, h) output element,
// h fastest: a warp covers 32 / H rows and at each k reads u and writes xg
// in full 32-byte sectors.
#include "window.cuh"

__global__ void windowed_weighted_reduce_kernel(
    const float* __restrict__ x, const float* __restrict__ u,
    const int* __restrict__ idx, const int* __restrict__ starts,
    float* __restrict__ out, float* __restrict__ xg, long long total, int n,
    int m, int k, int h, int tile, int width, int front) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long bm = e / h;  // b * m + row
  const int c = (int)(e - bm * h);
  const int b = (int)(bm / m);
  const int row = (int)(bm - (long long)b * m);
  const int start = starts[row / tile];
  const float* xb = x + (long long)b * n * h;
  const int* ib = idx + bm * k;
  const long long base = bm * k * h + c;
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    const long long r = window_row(ib[j], start, front, width);
    const float v = row_in(r, n) ? xb[r * h + c] : 0.0f;
    const long long o = base + (long long)j * h;
    xg[o] = v;
    acc = __fadd_rn(acc, __fmul_rn(u[o], v));
  }
  out[e] = acc;
}

extern "C" int windowed_weighted_reduce_f32(
    const void* x, const void* u, const void* idx, const void* starts,
    void* out, void* xg, int b, int n, int m, int k, int h, int tile,
    int width, int front, void* stream) {
  const long long total = (long long)b * m * h;
  if (total == 0) return -1;  // nothing to launch
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  windowed_weighted_reduce_kernel<<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
      (const float*)x, (const float*)u, (const int*)idx, (const int*)starts,
      (float*)out, (float*)xg, total, n, m, k, h, tile, width, front);
  return (int)cudaGetLastError();
}
