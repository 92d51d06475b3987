// K12: the gradient of the continuous CRF core into the similarity s,
//
//   ds[b,m,k] = sum_t < dmsg_t[b,m,:], x_t[b, col[b,m,k], :] >
//
// dmsgs, xs [T,B,N,H] (K11's dmsg_t and the forward's saved x_t), col
// [B,N,K] int32 (K9, -1 = reads zero) -> ds [B,N,K], all f32 but col.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::banded_neighbor_dot
// (_nbr_dot_kernel). The TPU kernel multiplies each 128-row tile by its
// whole window on the MXU ([128, w] products, hi/lo bf16) and picks the K
// columns out with iota compares; here only the K needed dot products are
// computed. A group of LR lanes (LR = 32, or the next power of two >= H when
// H < 32) owns one row and walks its K slots in turn: each lane sums its
// columns h = lane, lane + LR, ... over every step t into one register, so
// the row's dmsg and the neighbour's x rows are read in full sectors, and
// the group reduces the sum with shuffles. One accumulator a thread keeps
// the registers, and so the warps in flight to hide the gathers' latency,
// free (an earlier design with K accumulators a thread took 250 registers
// and ran ~3x slower).
//
// Bound: bytes (dmsgs and xs read once each, 2 * T*B*N*H floats; col, ds).
#include <cuda_runtime.h>

constexpr int NBR_THREADS = 256;

__global__ void __launch_bounds__(NBR_THREADS)
crf_neighbor_dot_kernel(const float* __restrict__ dmsgs,
                        const float* __restrict__ xs,
                        const int* __restrict__ col, float* __restrict__ ds,
                        int steps, long long rows, int n, int k, int h,
                        int lr) {
  const int lane = threadIdx.x % lr;
  const long long m =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lr;
  // whole groups leave together, so the shuffles below see full groups
  const bool live = m < rows;
  const long long mm = live ? m : 0;
  const long long plane = rows * h;  // one step of a stack
  const float* d = dmsgs + mm * h;
  const float* xb = xs + (mm / n) * n * (long long)h;
  for (int j = 0; j < k; ++j) {
    const int cj = live ? col[mm * k + j] : -1;
    float acc = 0.0f;
    if (cj >= 0) {
      const float* xr = xb + (long long)cj * h;
      for (int t = 0; t < steps; ++t)
        for (int c = lane; c < h; c += lr)
          acc = fmaf(d[t * plane + c], xr[t * plane + c], acc);
    }
    for (int off = lr / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off, lr);
    if (live && lane == 0) ds[m * k + j] = acc;
  }
}

extern "C" int crf_neighbor_dot_f32(const void* dmsgs, const void* xs,
                                    const void* col, void* ds, int steps,
                                    int b, int n, int k, int h,
                                    void* stream) {
  const long long rows = (long long)b * n;
  if (rows == 0 || k == 0) return -1;  // nothing to launch
  int lr = 32;
  while (lr / 2 >= h && lr > 1) lr /= 2;
  const long long threads = rows * lr;
  const long long blocks = (threads + NBR_THREADS - 1) / NBR_THREADS;
  crf_neighbor_dot_kernel<<<(unsigned)blocks, NBR_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)dmsgs, (const float*)xs, (const int*)col, (float*)ds,
      steps, rows, n, k, h, lr);
  return (int)cudaGetLastError();
}
