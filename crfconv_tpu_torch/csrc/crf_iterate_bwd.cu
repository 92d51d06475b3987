// K11: one step of the continuous CRF's reverse recurrence, the transpose
// of K10. With lam = dL/dx_{t+1} and x = x_t:
//
//   dmsg[m,:]          = lam[m,:] M^T                  (written to dmsg_out)
//   lam_out[col[m,k],:] += s[m,k] * dmsg[m,:]           (lam_t = S~^T dmsg)
//   dzp_out[m,:]       = dzp[m,:] + lam[m,:]
//   dM_out             += msg^T lam,  msg[m,:] = sum_k s[m,k] x[col[m,k],:]
//
// lam, x, dzp, dmsg_out, dzp_out, lam_out [B,N,H]; s, col [B,N,K]; Mt = M^T
// [H,H]; dM_out [H,H]. lam_out must be zeroed and dM_out hold the running
// dM by the caller. Run for t = steps-1 .. 0, lam_out of one launch is the
// next one's lam; the last gives dz = lam_0, dzp = g + sum_{t>=1} lam_t.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_crf_core_bwd (_bwd_iterate_kernel,
// with the row-layout band blocks of _banded_setup_rows). The TPU kernel
// keeps lam resident in VMEM and multiplies band blocks; here a block owns R
// rows as in K10: phase 1 loads lam, adds it into dzp and gathers msg
// (crf_rows.cuh); phase 2 applies M^T with RT rows per thread, in the order
// of the plain version, so dmsg is bit-equal to it; phase 3 scatters
// s * dmsg into lam_out with f32 atomics (the transpose of the gather, as
// K8 does), four columns per atomic where H allows; phase 4 reduces the
// block's msg^T lam in shared memory and adds it into dM_out with one
// atomic per entry and block. The atomics make lam_out and dM_out differ in
// the last bits from run to run, and flush subnormal sums to zero.
//
// Bound: bytes at H <= 64 (lam, x, dzp in; lam_out, dmsg, dzp_out out; s,
// col); the two H x H products (4 H^2 operations a row) at H = 256.
#include "crf_rows.cuh"

// lam_out[b, col[m,j], c] += s[m,j] * D[r, c] for the block's rows m = row0 +
// r, V consecutive columns c per atomic (a float4 add from sm_90 on: a
// quarter of the atomic operations of one float each), c fastest, so a
// row's adds are contiguous. Each product is rounded on its own.
template <int V>
__device__ __forceinline__ void scatter(
    const float* __restrict__ s, const int* __restrict__ col, const float* D,
    float* __restrict__ lam_out, long long row0, int r_count, long long rows,
    int n, int k, int h) {
  const int hv = h / V;
  for (int e = threadIdx.x; e < r_count * k * hv; e += blockDim.x) {
    const int c = (e % hv) * V;
    const int rj = e / hv;
    const int j = rj % k;
    const int r = rj / k;
    const long long m = row0 + r;
    if (m >= rows) continue;
    const int cj = col[m * k + j];
    if (cj < 0) continue;
    const float sv = s[m * k + j];
    const float* dr = D + r * h + c;
    float* dst = lam_out + ((m / n) * n + cj) * (long long)h + c;
    if constexpr (V == 4) {
      atomicAdd(reinterpret_cast<float4*>(dst),
                make_float4(__fmul_rn(sv, dr[0]), __fmul_rn(sv, dr[1]),
                            __fmul_rn(sv, dr[2]), __fmul_rn(sv, dr[3])));
    } else {
      atomicAdd(dst, __fmul_rn(sv, dr[0]));
    }
  }
}

__global__ void __launch_bounds__(CRF_THREADS)
crf_iterate_bwd_kernel(const float* __restrict__ lam,
                       const float* __restrict__ x,
                       const float* __restrict__ s,
                       const int* __restrict__ col,
                       const float* __restrict__ Mt,
                       const float* __restrict__ dzp,
                       float* __restrict__ lam_out, float* __restrict__ dmsg,
                       float* __restrict__ dzp_out, float* __restrict__ dM,
                       long long rows, int n, int k, int h) {
  extern __shared__ float sh[];
  const CrfRows g = crf_rows(h);
  const int rh = g.rows * h;
  float* L = sh;           // [R, h] lam
  float* G = sh + rh;      // [R, h] msg
  float* D = sh + 2 * rh;  // [R, h] dmsg
  const long long row0 = (long long)blockIdx.x * g.rows;

  // phase 1: lam, dzp, msg
  for (int e = threadIdx.x; e < rh; e += blockDim.x) {
    const long long o = row0 * h + e;
    float l = 0.0f;
    if (o < rows * h) {
      l = lam[o];
      dzp_out[o] = __fadd_rn(dzp[o], l);
    }
    L[e] = l;
  }
  crf_message(x, s, col, G, row0, g.rows, rows, n, k, h);
  __syncthreads();

  // phase 2: dmsg = lam M^T, j ascending
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
        const int r = tg * CRF_RT + i;
        D[r * h + c] = acc[i];
        const long long m = row0 + r;
        if (m < rows) dmsg[m * h + c] = acc[i];
      }
    }
  }
  __syncthreads();

  // phase 3: lam_out[col] += s * dmsg
  if (h % 4 == 0)
    scatter<4>(s, col, D, lam_out, row0, g.rows, rows, n, k, h);
  else
    scatter<1>(s, col, D, lam_out, row0, g.rows, rows, n, k, h);

  // phase 4: dM += msg^T lam over the block's rows (zero beyond the last)
  for (int e = threadIdx.x; e < h * h; e += blockDim.x) {
    const int a = e / h;
    const int c = e - a * h;
    float acc = 0.0f;
    for (int r = 0; r < g.rows; ++r)
      acc = fmaf(G[r * h + a], L[r * h + c], acc);
    atomicAdd(dM + e, acc);
  }
}

extern "C" int crf_iterate_bwd_f32(const void* lam, const void* x,
                                   const void* s, const void* col,
                                   const void* Mt, const void* dzp,
                                   void* lam_out, void* dmsg, void* dzp_out,
                                   void* dM, int b, int n, int k, int h,
                                   void* stream) {
  const long long rows = (long long)b * n;
  if (rows == 0 || h == 0) return -1;  // nothing to launch
  const CrfRows g = crf_rows(h);
  const size_t smem = 3 * (size_t)g.rows * h * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        crf_iterate_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + g.rows - 1) / g.rows;
  crf_iterate_bwd_kernel<<<(unsigned)blocks, CRF_THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const float*)lam, (const float*)x, (const float*)s, (const int*)col,
      (const float*)Mt, (const float*)dzp, (float*)lam_out, (float*)dmsg,
      (float*)dzp_out, (float*)dM, rows, n, k, h);
  return (int)cudaGetLastError();
}
