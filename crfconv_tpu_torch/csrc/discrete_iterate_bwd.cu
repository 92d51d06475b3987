// K14: one step of the discrete CRF's reverse recurrence, the transpose of
// K13. With lam = dL/dq_{t+1}, qn = q_{t+1} and msg = msg_t (K13's saved
// residuals):
//
//   dz[m,:]            = qn[m,:] * (lam[m,:] - <lam[m,:], qn[m,:]>)  (softmax VJP)
//   du_out[m,:]        = du[m,:] + dz[m,:]
//   dmsg[m,:]          = -dz[m,:] C^T                    (written to dmsg)
//   lam_out[col[m,k],:] += w[m,k] * dmsg[m,:]           (lam_t = S~^T dmsg)
//   dC_out             += msg^T dz
//
// lam, qn, msg, du, du_out, dmsg, lam_out [B,N,L]; w, col [B,N,K]; Ct = C^T
// [L,L]; dC_out [L,L]. lam_out must be zeroed and dC_out hold the running
// sum by the caller. Run for t = steps-1 .. 0, lam_out of one launch is
// the next one's lam; the last gives dp = lam_0. du and dC carry no sign:
// the caller negates their sums (du = -sum_t dz_t, dC = -sum_t msg_t^T
// dz_t), as crfconv_tpu/ops/crf_pallas.py::_discrete_core_bwd does.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_discrete_core_bwd
// (_bwd_discrete_kernel, with the row-layout band blocks of
// _banded_setup_rows). The TPU kernel keeps lam resident in VMEM and
// multiplies band blocks; here a warp owns a row (its lanes the classes)
// and a block ROWS rows: the warp forms dz, du and dmsg in one order (l,
// then j ascending, each product and sum rounded on its own, as the plain
// version), so they are bit-equal to it; it scatters w * dmsg into lam_out
// with f32 atomics (the transpose of the gather, as K11 does), four classes
// per atomic when L is a multiple of 4; the block keeps its rows' msg and
// dz in shared memory and adds its msg^T dz into dC_out with one atomic per
// entry. The atomics make lam_out and dC_out differ in the last bits from
// run to run, and flush subnormal sums to zero.
//
// Bound: bytes (lam, qn, msg, du, w, col read; du_out, dmsg, lam_out
// written). At B16 x 8192, L = 20, K = 31: 106 MB, 0.032 ms on 3.35 TB/s.
#include <cuda_runtime.h>

constexpr int DB_THREADS = 256;
constexpr int DB_WARPS = DB_THREADS / 32;
constexpr int DB_ROWS_PER_WARP = 8;
constexpr int DB_ROWS = DB_WARPS * DB_ROWS_PER_WARP;  // rows per block

// lam_out[b, col[m,j], c..c+V) += w[m,j] * d[c..c+V) over the row's slots j
// and class groups c, spread over the warp's lanes.
template <int V>
__device__ __forceinline__ void scatter_row(
    const float* __restrict__ w, const int* __restrict__ col, const float* d,
    float* __restrict__ lam_out, long long m, int n, int k, int L,
    int lane) {
  const int lv = L / V;
  float* base = lam_out + (m / n) * n * (long long)L;
  for (int e = lane; e < k * lv; e += 32) {
    const int j = e / lv;
    const int c = (e - j * lv) * V;
    const int cj = col[m * k + j];
    if (cj < 0) continue;
    const float wv = w[m * k + j];
    float* dst = base + (long long)cj * L + c;
    if constexpr (V == 4) {
      atomicAdd(reinterpret_cast<float4*>(dst),
                make_float4(__fmul_rn(wv, d[c]), __fmul_rn(wv, d[c + 1]),
                            __fmul_rn(wv, d[c + 2]), __fmul_rn(wv, d[c + 3])));
    } else {
      atomicAdd(dst, __fmul_rn(wv, d[c]));
    }
  }
}

__global__ void __launch_bounds__(DB_THREADS)
discrete_iterate_bwd_kernel(const float* __restrict__ lam,
                            const float* __restrict__ qn,
                            const float* __restrict__ msg,
                            const float* __restrict__ w,
                            const int* __restrict__ col,
                            const float* __restrict__ Ct,
                            const float* __restrict__ du,
                            float* __restrict__ lam_out,
                            float* __restrict__ dmsg,
                            float* __restrict__ du_out,
                            float* __restrict__ dC, long long rows, int n,
                            int k, int L) {
  extern __shared__ float sh[];
  float* cts = sh;                          // [L, L] C^T
  float* Ms = cts + L * L;                  // [ROWS, L] the rows' msg
  float* Zs = Ms + DB_ROWS * L;             // [ROWS, L] the rows' dz
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* lw = Zs + DB_ROWS * L + warp * 3 * L;   // [L] lam of the row
  float* qw = lw + L;                            // [L] qn of the row
  float* dw = qw + L;                            // [L] dmsg of the row
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) cts[e] = Ct[e];
  __syncthreads();

  const long long row0 = (long long)blockIdx.x * DB_ROWS;
  for (int r = 0; r < DB_ROWS_PER_WARP; ++r) {
    const int br = warp * DB_ROWS_PER_WARP + r;
    const long long m = row0 + br;
    float* mr = Ms + br * L;
    float* zr = Zs + br * L;
    if (m >= rows) {   // uniform over the warp
      for (int l = lane; l < L; l += 32) mr[l] = zr[l] = 0.0f;
      continue;
    }
    for (int l = lane; l < L; l += 32) {
      lw[l] = lam[m * L + l];
      qw[l] = qn[m * L + l];
      mr[l] = msg[m * L + l];
    }
    __syncwarp();
    float dot = 0.0f;
    for (int l = 0; l < L; ++l) dot = __fadd_rn(dot, __fmul_rn(lw[l], qw[l]));
    for (int l = lane; l < L; l += 32) {
      const float dz = __fmul_rn(qw[l], __fsub_rn(lw[l], dot));
      zr[l] = dz;
      du_out[m * L + l] = __fadd_rn(du[m * L + l], dz);
    }
    __syncwarp();
    for (int l = lane; l < L; l += 32) {
      float acc = 0.0f;
      for (int j = 0; j < L; ++j)
        acc = __fadd_rn(acc, __fmul_rn(zr[j], cts[j * L + l]));
      dw[l] = -acc;
      dmsg[m * L + l] = -acc;
    }
    __syncwarp();
    if (L % 4 == 0)
      scatter_row<4>(w, col, dw, lam_out, m, n, k, L, lane);
    else
      scatter_row<1>(w, col, dw, lam_out, m, n, k, L, lane);
    __syncwarp();   // lw, qw, dw are the next row's
  }
  __syncthreads();

  // dC += msg^T dz over the block's rows (zero beyond the last)
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
    const int a = e / L;
    const int c = e - a * L;
    float acc = 0.0f;
    for (int r = 0; r < DB_ROWS; ++r) acc = fmaf(Ms[r * L + a], Zs[r * L + c], acc);
    atomicAdd(dC + e, acc);
  }
}

extern "C" int discrete_iterate_bwd_f32(const void* lam, const void* qn,
                                        const void* msg, const void* w,
                                        const void* col, const void* Ct,
                                        const void* du, void* lam_out,
                                        void* dmsg, void* du_out, void* dC,
                                        int b, int n, int k, int L,
                                        void* stream) {
  const long long rows = (long long)b * n;
  if (rows == 0 || L == 0) return -1;  // nothing to launch
  const size_t smem =
      ((size_t)L * L + 2 * (size_t)DB_ROWS * L + 3 * (size_t)DB_WARPS * L) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        discrete_iterate_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + DB_ROWS - 1) / DB_ROWS;
  discrete_iterate_bwd_kernel<<<(unsigned)blocks, DB_THREADS, smem,
                                (cudaStream_t)stream>>>(
      (const float*)lam, (const float*)qn, (const float*)msg, (const float*)w,
      (const int*)col, (const float*)Ct, (const float*)du, (float*)lam_out,
      (float*)dmsg, (float*)du_out, (float*)dC, rows, n, k, L);
  return (int)cudaGetLastError();
}
