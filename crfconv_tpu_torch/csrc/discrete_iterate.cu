// K13: one mean-field step of the discrete CRF (CRF-as-RNN),
//
//   msg[m,:] = sum_k w[m,k] * q[col[m,k],:]
//   out[m,:] = softmax(-u[m,:] - msg[m,:] C)
//
// q, u, out [B,N,L]; w [B,N,K] (masked slots already zero); col [B,N,K]
// int32 (K9's clamped columns, -1 = reads zero); C [L,L]; all f32 but col.
// msg_out [B,N,L], when not null, receives msg (the residual the backward
// needs). out never aliases q: step t+1 reads only q_t (the caller
// ping-pongs two buffers or writes into the saved stack).
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_run_discrete_core
// (_iterate_discrete_kernel, _iterate_discrete_stack_kernel). The TPU
// kernel keeps q transposed in VMEM for all steps and multiplies hi/lo
// bf16 band blocks on the MXU; none of that is carried over. Here one
// launch is one step and a warp owns a row, its lanes the classes (l =
// lane, lane + 32, ...): each lane sums its class of the message over k,
// the warp shares the message in shared memory for the L x L product with
// C (staged in shared memory once per block), then a warp max, exp, and a
// sum of the exponentials that every lane takes in class order from shared
// memory. Every sum runs in one order (k, then j, then l ascending), each
// product and sum rounded on its own, as the plain version adds.
//
// Bound: bytes (q, u, w, col read, out and msg written once each). At
// B16 x 8192, L = 20, K = 31: 64 MB, 0.019 ms on 3.35 TB/s; 75 MB with msg.
#include <cuda_runtime.h>

constexpr int DISC_THREADS = 256;       // 8 warps, a row each
constexpr int DISC_WARPS = DISC_THREADS / 32;
constexpr int DISC_MAX_L = 128;         // classes a row may have
constexpr int DISC_PER_LANE = DISC_MAX_L / 32;

__global__ void __launch_bounds__(DISC_THREADS)
discrete_iterate_kernel(const float* __restrict__ q,
                        const float* __restrict__ u,
                        const float* __restrict__ w,
                        const int* __restrict__ col,
                        const float* __restrict__ C, float* __restrict__ out,
                        float* __restrict__ msg_out, long long rows, int n,
                        int k, int L) {
  extern __shared__ float sh[];
  float* cs = sh;                                  // [L, L]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ms = sh + L * L + warp * 2 * L;           // [L] this row's message
  float* es = ms + L;                              // [L] its exponentials
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) cs[e] = C[e];
  __syncthreads();

  const long long m = (long long)blockIdx.x * DISC_WARPS + warp;
  if (m >= rows) return;                           // the whole warp leaves
  const float* qb = q + (m / n) * n * (long long)L;
  const int* cm = col + m * k;
  const float* wm = w + m * k;
  for (int l = lane; l < L; l += 32) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      const int cj = cm[j];
      if (cj >= 0)
        acc = __fadd_rn(acc, __fmul_rn(wm[j], qb[(long long)cj * L + l]));
    }
    ms[l] = acc;
    if (msg_out != nullptr) msg_out[m * L + l] = acc;
  }
  __syncwarp();

  float z[DISC_PER_LANE];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < DISC_PER_LANE; ++i) {
    const int l = lane + 32 * i;
    z[i] = -INFINITY;
    if (l < L) {
      float acc = 0.0f;
      for (int j = 0; j < L; ++j)
        acc = __fadd_rn(acc, __fmul_rn(ms[j], cs[j * L + l]));
      z[i] = __fsub_rn(-u[m * L + l], acc);
      mx = fmaxf(mx, z[i]);
    }
  }
  for (int off = 16; off > 0; off /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
#pragma unroll
  for (int i = 0; i < DISC_PER_LANE; ++i) {
    const int l = lane + 32 * i;
    if (l < L) {
      z[i] = expf(__fsub_rn(z[i], mx));
      es[l] = z[i];
    }
  }
  __syncwarp();
  float s = 0.0f;
  for (int l = 0; l < L; ++l) s = __fadd_rn(s, es[l]);
#pragma unroll
  for (int i = 0; i < DISC_PER_LANE; ++i) {
    const int l = lane + 32 * i;
    if (l < L) out[m * L + l] = __fdiv_rn(z[i], s);
  }
}

extern "C" int discrete_iterate_f32(const void* q, const void* u,
                                    const void* w, const void* col,
                                    const void* C, void* out, void* msg_out,
                                    int b, int n, int k, int L,
                                    void* stream) {
  const long long rows = (long long)b * n;
  if (rows == 0 || L == 0) return -1;  // nothing to launch
  if (L > DISC_MAX_L) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)L * L + 2 * (size_t)DISC_WARPS * L) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        discrete_iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + DISC_WARPS - 1) / DISC_WARPS;
  discrete_iterate_kernel<<<(unsigned)blocks, DISC_THREADS, smem,
                            (cudaStream_t)stream>>>(
      (const float*)q, (const float*)u, (const float*)w, (const int*)col,
      (const float*)C, (float*)out, (float*)msg_out, rows, n, k, L);
  return (int)cudaGetLastError();
}
