// K11: one step of the continuous CRF's reverse recurrence, the transpose
// of K10. With lam = dL/dx_{t+1} and x = x_t:
//
//   dmsg[m,:]     = lam[m,:] M^T                         (written to dmsg)
//   lam_out       = S~^T dmsg: lam_out[r,:] = sum over the slots (m, k) with
//                   col[m,k] == r of s[m,k] * dmsg[m,:]   (lam_t)
//   dzp_out[m,:]  = dzp[m,:] + lam[m,:]
//   dM_out        = dM + msg^T lam,  msg[m,:] = sum_k s[m,k] x[col[m,k],:]
//
// lam, x, dzp, dmsg, dzp_out, lam_out [B,N,H]; s, col [B,N,K]; Mt = M^T
// [H,H]; dM, dM_out [H,H]. Run for t = steps-1 .. 0, lam_out of one launch
// is the next one's lam; the last gives dz = lam_0, dzp = g + sum_{t>=1}
// lam_t.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_crf_core_bwd (_bwd_iterate_kernel,
// with the row-layout band blocks of _banded_setup_rows). The TPU kernel
// keeps lam resident in VMEM and multiplies band blocks; its sums run in
// one order, so it is deterministic. Here a step is three kernels, none
// with atomics, over S~^T's structure built once per backward call
// (crf_iterate_bwd_transpose_i32: K8's tile_inverse over col,
// crf_transpose.cuh), so lam_out and dM_out are identical from run to run:
//
//  1. rows: a block owns R rows (crf_rows.cuh); it loads lam,
//     writes dzp_out, writes msg into a workspace, and applies M^T with RT
//     rows per thread, j ascending, each product and sum rounded on its
//     own: dmsg is bit-equal to the plain version;
//  2. outer_partials: msg^T lam over `parts` chunks of rows, one partial a
//     chunk (crf_transpose.cuh);
//  3. segment_sum: each lam_out element once, its terms s * dmsg added in
//     ascending slot order from +0.0, as index_add_ adds on the CPU, so
//     lam_out is bit-equal to the plain version run on the CPU (subnormal
//     terms kept: no flush); and dM_out = dM + the partials in chunk order.
//
// Bound: bytes at every H of the main path (lam, x, dzp, s, col in;
// lam_out, dmsg, dzp_out out); the two H x H products (4 H^2 operations a
// row) stay on the CUDA cores.
#include "crf_rows.cuh"
#include "crf_transpose.cuh"

__global__ void __launch_bounds__(CRF_THREADS)
crf_bwd_rows_kernel(const float* __restrict__ lam, const float* __restrict__ x,
                    const float* __restrict__ s, const int* __restrict__ col,
                    const float* __restrict__ Mt,
                    const float* __restrict__ dzp, float* __restrict__ dmsg,
                    float* __restrict__ dzp_out, float* __restrict__ msg,
                    long long rows, int n, int k, int h) {
  extern __shared__ float L[];  // [R, h] lam
  const CrfRows g = crf_rows(h);
  const int rh = g.rows * h;
  const long long row0 = (long long)blockIdx.x * g.rows;

  // lam, dzp, msg
  for (int e = threadIdx.x; e < rh; e += blockDim.x) {
    const long long o = row0 * h + e;
    float l = 0.0f;
    if (o < rows * h) {
      l = lam[o];
      dzp_out[o] = __fadd_rn(dzp[o], l);
      const long long m = o / h;
      msg[o] = crf_message_at(x, s, col, m, (int)(o - m * h), n, k, h);
    }
    L[e] = l;
  }
  __syncthreads();

  // dmsg = lam M^T, j ascending
  const int tc = threadIdx.x % g.cols;
  const int tg = threadIdx.x / g.cols;
  if (tg < g.groups) {
    const float* lrow = L + tg * CRF_RT * h;
    for (int c = tc; c < h; c += g.cols) {
      float acc[CRF_RT];
#pragma unroll
      for (int i = 0; i < CRF_RT; ++i) acc[i] = 0.0f;
      for (int j = 0; j < h; ++j) {
        const float mv = Mt[(long long)j * h + c];
#pragma unroll
        for (int i = 0; i < CRF_RT; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(lrow[i * h + j], mv));
      }
#pragma unroll
      for (int i = 0; i < CRF_RT; ++i) {
        const long long m = row0 + tg * CRF_RT + i;
        if (m < rows) dmsg[m * h + c] = acc[i];
      }
    }
  }
}

// S~^T's structure, once per backward call (see crf_transpose.cuh)
extern "C" int crf_iterate_bwd_transpose_i32(const char* packed) {
  return crf_t::build_transpose(packed);
}

// The arguments arrive packed as 25 int64s: lam, x, s, col, Mt, dzp, dM,
// lam_out, dmsg, dzp_out, dM_out, starts, order, runs (the transpose's
// structure), msg (workspace [B*N, H]), part (workspace [parts, H, H]), b,
// n, k, h, tile, width, front, parts, stream.
extern "C" int crf_iterate_bwd_f32(const char* packed) {
  long long a[25];
  memcpy(a, packed, sizeof a);
  const int b = (int)a[16], n = (int)a[17], k = (int)a[18], h = (int)a[19];
  const long long rows = (long long)b * n;
  if (rows == 0 || h == 0) return -1;  // nothing to launch
  cudaStream_t st = (cudaStream_t)a[24];
  const CrfRows g = crf_rows(h);
  const size_t smem = (size_t)g.rows * h * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        crf_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + g.rows - 1) / g.rows;
  const float* lam = (const float*)a[0];
  float* dmsg = (float*)a[8];
  float* msg = (float*)a[14];
  crf_bwd_rows_kernel<<<(unsigned)blocks, CRF_THREADS, smem, st>>>(
      lam, (const float*)a[1], (const float*)a[2], (const int*)a[3],
      (const float*)a[4], (const float*)a[5], dmsg, (float*)a[9], msg, rows,
      n, k, h);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  crf_t::Tail t;
  t.dmsg = dmsg;
  t.w = (const float*)a[2];
  t.P = msg;
  t.Q = lam;
  t.dw_in = (const float*)a[6];
  t.starts = (const int*)a[11];
  t.order = (const int*)a[12];
  t.runs = (const int*)a[13];
  t.lam_out = (float*)a[7];
  t.dw_out = (float*)a[10];
  t.part = (float*)a[15];
  t.b = b;
  t.n = n;
  t.k = k;
  t.h = h;
  t.tile = (int)a[20];
  t.width = (int)a[21];
  t.front = (int)a[22];
  t.parts = (int)a[23];
  return (int)crf_t::launch_tail(t, st);
}
