// K14: one step of the discrete CRF's reverse recurrence, the transpose of
// K13. With lam = dL/dq_{t+1}, qn = q_{t+1} and msg = msg_t (K13's saved
// residuals):
//
//   dz[m,:]      = qn[m,:] * (lam[m,:] - <lam[m,:], qn[m,:]>)  (softmax VJP)
//   du_out[m,:]  = du[m,:] + dz[m,:]
//   dmsg[m,:]    = -dz[m,:] C^T                       (written to dmsg)
//   lam_out      = S~^T dmsg: lam_out[r,:] = sum over the slots (m, k) with
//                  col[m,k] == r of w[m,k] * dmsg[m,:]   (lam_t)
//   dC_out       = dC + msg^T dz
//
// lam, qn, msg, du, du_out, dmsg, lam_out [B,N,L]; w, col [B,N,K]; Ct = C^T
// [L,L]; dC, dC_out [L,L]. Run for t = steps-1 .. 0, lam_out of one launch
// is the next one's lam; the last gives dp = lam_0. du and dC carry no
// sign: the caller negates their sums (du = -sum_t dz_t, dC = -sum_t
// msg_t^T dz_t), as crfconv_tpu/ops/crf_pallas.py::_discrete_core_bwd does.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_discrete_core_bwd
// (_bwd_discrete_kernel, with the row-layout band blocks of
// _banded_setup_rows). The TPU kernel keeps lam resident in VMEM and
// multiplies band blocks; here a step is three kernels, none with atomics,
// over S~^T's structure built once per backward call
// (discrete_iterate_bwd_transpose_i32, crf_transpose.cuh, as K11):
//
//  1. rows: a warp owns a row (its lanes the classes) and a block ROWS rows;
//     the warp forms dz, du and dmsg in one order (l, then j ascending,
//     each product and sum rounded on its own, as the plain version), so
//     they are bit-equal to it, and writes dz into a workspace;
//  2. outer_partials: msg^T dz over `parts` chunks of rows;
//  3. segment_sum: each lam_out element once, its terms w * dmsg added in
//     ascending slot order from +0.0 (bit-equal to the plain version run on
//     the CPU), and dC_out = dC + the partials in chunk order.
//
// Bound: bytes (lam, qn, msg, du, w, col read; du_out, dmsg, lam_out
// written). At B16 x 8192, L = 20, K = 31: 106 MB, 0.032 ms on 3.35 TB/s.
#include "crf_transpose.cuh"

constexpr int DB_THREADS = 256;
constexpr int DB_WARPS = DB_THREADS / 32;
constexpr int DB_ROWS_PER_WARP = 8;
constexpr int DB_ROWS = DB_WARPS * DB_ROWS_PER_WARP;  // rows per block

__global__ void __launch_bounds__(DB_THREADS)
discrete_bwd_rows_kernel(const float* __restrict__ lam,
                         const float* __restrict__ qn,
                         const float* __restrict__ Ct,
                         const float* __restrict__ du,
                         float* __restrict__ dmsg, float* __restrict__ du_out,
                         float* __restrict__ dz_out, long long rows, int L) {
  extern __shared__ float sh[];
  float* cts = sh;                               // [L, L] C^T
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* lw = cts + L * L + warp * 3 * L;        // [L] lam of the row
  float* qw = lw + L;                            // [L] qn of the row
  float* zw = qw + L;                            // [L] dz of the row
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) cts[e] = Ct[e];
  __syncthreads();

  const long long row0 = (long long)blockIdx.x * DB_ROWS;
  for (int r = 0; r < DB_ROWS_PER_WARP; ++r) {
    const long long m = row0 + warp * DB_ROWS_PER_WARP + r;
    if (m >= rows) break;   // uniform over the warp
    for (int l = lane; l < L; l += 32) {
      lw[l] = lam[m * L + l];
      qw[l] = qn[m * L + l];
    }
    __syncwarp();
    float dot = 0.0f;
    for (int l = 0; l < L; ++l) dot = __fadd_rn(dot, __fmul_rn(lw[l], qw[l]));
    for (int l = lane; l < L; l += 32) {
      const float dz = __fmul_rn(qw[l], __fsub_rn(lw[l], dot));
      zw[l] = dz;
      dz_out[m * L + l] = dz;
      du_out[m * L + l] = __fadd_rn(du[m * L + l], dz);
    }
    __syncwarp();
    for (int l = lane; l < L; l += 32) {
      float acc = 0.0f;
      for (int j = 0; j < L; ++j)
        acc = __fadd_rn(acc, __fmul_rn(zw[j], cts[j * L + l]));
      dmsg[m * L + l] = -acc;
    }
    __syncwarp();   // lw, qw, zw are the next row's
  }
}

// S~^T's structure, once per backward call (see crf_transpose.cuh)
extern "C" int discrete_iterate_bwd_transpose_i32(const char* packed) {
  return crf_t::build_transpose(packed);
}

// The arguments arrive packed as 25 int64s: lam, qn, msg, w, Ct, du, dC,
// lam_out, dmsg, du_out, dC_out, starts, order, runs (the transpose's
// structure), dz (workspace [B*N, L]), part (workspace [parts, L, L]), b,
// n, k, L, tile, width, front, parts, stream.
extern "C" int discrete_iterate_bwd_f32(const char* packed) {
  long long a[25];
  memcpy(a, packed, sizeof a);
  const int b = (int)a[16], n = (int)a[17], k = (int)a[18], L = (int)a[19];
  const long long rows = (long long)b * n;
  if (rows == 0 || L == 0) return -1;  // nothing to launch
  cudaStream_t st = (cudaStream_t)a[24];
  const size_t smem =
      ((size_t)L * L + 3 * (size_t)DB_WARPS * L) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        discrete_bwd_rows_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + DB_ROWS - 1) / DB_ROWS;
  float* dmsg = (float*)a[8];
  float* dz = (float*)a[14];
  discrete_bwd_rows_kernel<<<(unsigned)blocks, DB_THREADS, smem, st>>>(
      (const float*)a[0], (const float*)a[1], (const float*)a[4],
      (const float*)a[5], dmsg, (float*)a[9], dz, rows, L);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  crf_t::Tail t;
  t.dmsg = dmsg;
  t.w = (const float*)a[3];
  t.P = (const float*)a[2];
  t.Q = dz;
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
  t.h = L;
  t.tile = (int)a[20];
  t.width = (int)a[21];
  t.front = (int)a[22];
  t.parts = (int)a[23];
  return (int)crf_t::launch_tail(t, st);
}
