// K10: one Jacobi step of the continuous CRF's mean field,
//
//   out[m,:] = zp[m,:] + (sum_k s[m,k] * x[col[m,k],:]) M
//
// x, zp, out [B,N,H], s [B,N,K], col [B,N,K] int32 (K9, -1 = reads zero),
// M [H,H], all f32 except col. out never aliases x: step t+1 reads only x_t
// (the caller ping-pongs two buffers, or writes into the saved x stack).
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_run_core (_iterate_kernel,
// _iterate_stack_kernel). The TPU kernel keeps x transposed in VMEM for all
// steps and multiplies hi/lo bf16 band blocks on the MXU; none of that is
// carried over. Here one launch is one step: a block owns R rows, gathers
// their message into shared memory (phase 1, crf_rows.cuh), then applies M
// with each thread holding RT rows of one column in registers, so one load
// of M (from L1/L2; 256 KB at H = 256) serves RT rows (phase 2). Both sums
// run in one order (k ascending, then h ascending), every product and sum
// rounded on its own, as the plain version adds: the two are bit-equal.
//
// Bound: bytes at H <= 64 (x, zp, out, s, col once each); at H = 256 the
// H x H apply (2 H^2 operations a row) and the bytes are within 2x. At
// B16 x 8192 rows, H = 32: 66 MB, 0.020 ms on 3.35 TB/s.
#include "crf_rows.cuh"

__global__ void __launch_bounds__(CRF_THREADS)
crf_iterate_kernel(const float* __restrict__ x, const float* __restrict__ zp,
                   const float* __restrict__ s, const int* __restrict__ col,
                   const float* __restrict__ M, float* __restrict__ out,
                   long long rows, int n, int k, int h) {
  extern __shared__ float msg[];  // [R, h]
  const CrfRows g = crf_rows(h);
  const long long row0 = (long long)blockIdx.x * g.rows;
  crf_message(x, s, col, msg, row0, g.rows, rows, n, k, h);
  __syncthreads();

  const int tc = threadIdx.x % g.cols;
  const int tg = threadIdx.x / g.cols;
  if (tg >= g.groups) return;
  const float* mrow = msg + tg * CRF_RT * h;
  for (int c = tc; c < h; c += g.cols) {
    float acc[CRF_RT];
#pragma unroll
    for (int i = 0; i < CRF_RT; ++i) acc[i] = 0.0f;
    for (int j = 0; j < h; ++j) {
      const float mv = M[(long long)j * h + c];
#pragma unroll
      for (int i = 0; i < CRF_RT; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(mrow[i * h + j], mv));
    }
#pragma unroll
    for (int i = 0; i < CRF_RT; ++i) {
      const long long m = row0 + tg * CRF_RT + i;
      if (m < rows) out[m * h + c] = __fadd_rn(zp[m * h + c], acc[i]);
    }
  }
}

extern "C" int crf_iterate_f32(const void* x, const void* zp, const void* s,
                               const void* col, const void* M, void* out,
                               int b, int n, int k, int h, void* stream) {
  const long long rows = (long long)b * n;
  if (rows == 0 || h == 0) return -1;  // nothing to launch
  const CrfRows g = crf_rows(h);
  const size_t smem = (size_t)g.rows * h * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        crf_iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + g.rows - 1) / g.rows;
  crf_iterate_kernel<<<(unsigned)blocks, CRF_THREADS, smem,
                       (cudaStream_t)stream>>>(
      (const float*)x, (const float*)zp, (const float*)s, (const int*)col,
      (const float*)M, (float*)out, rows, n, k, h);
  return (int)cudaGetLastError();
}
