// K4: CRF similarity and first mean-field message, fused.
//
// Replaces crfconv_tpu/ops/crf_sim_pallas.py::crf_similarity_message
// (_kernel_sim). Per point i with neighbours j = idx[i, k] (self removed):
//   s_k = softmax_k(-|y_i - y_j|^2)   (max subtracted, sum clamped at 1e-30)
//   msg_i = sum_k s_k z_j
// Neighbour rows follow K1's clamp: a row outside [0, N) reads zero y and
// zero z.
//
// Bound: bytes. Each neighbour costs one y row and one z row (8H bytes, from
// L2) against ~4H flops. One thread per point keeps y_i and the message in
// registers (HP, the padded width, is a template constant). Three passes
// over the K neighbours: distances (stored as -d in the point's own row of
// s), the softmax denominator, then s and the message. The [B, N, K, 2H]
// gather of the unfused path never reaches device memory.
#include "window.cuh"

template <int HP>
__global__ void crf_sim_kernel(const float* __restrict__ y,
                               const float* __restrict__ z,
                               const int* __restrict__ idx,
                               const int* __restrict__ starts,
                               float* __restrict__ s, float* __restrict__ msg,
                               int n, int k, int h, int tile, int width,
                               int front) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= n) return;
  const int start = starts[i / tile];
  const float* yb = y + (long long)b * n * h;
  const float* zb = z + (long long)b * n * h;
  const int* ir = idx + ((long long)b * n + i) * k;
  float* sr = s + ((long long)b * n + i) * k;

  float yi[HP];
#pragma unroll
  for (int c = 0; c < HP; ++c) yi[c] = c < h ? yb[(long long)i * h + c] : 0.0f;

  float mx = -1e30f;
  for (int nb = 0; nb < k; ++nb) {
    const long long row = window_row(ir[nb], start, front, width);
    const bool in = row_in(row, n);
    float d = 0.0f;
#pragma unroll
    for (int c = 0; c < HP; ++c) {
      const float yj = (in && c < h) ? yb[row * h + c] : 0.0f;
      const float diff = yi[c] - yj;
      d += diff * diff;
    }
    sr[nb] = -d;
    mx = fmaxf(mx, -d);
  }
  float sum = 0.0f;
  for (int nb = 0; nb < k; ++nb) sum += expf(sr[nb] - mx);
  const float inv = 1.0f / fmaxf(sum, 1e-30f);

  float acc[HP];
#pragma unroll
  for (int c = 0; c < HP; ++c) acc[c] = 0.0f;
  for (int nb = 0; nb < k; ++nb) {
    const float sk = expf(sr[nb] - mx) * inv;
    sr[nb] = sk;
    const long long row = window_row(ir[nb], start, front, width);
    if (!row_in(row, n)) continue;
#pragma unroll
    for (int c = 0; c < HP; ++c)
      if (c < h) acc[c] += sk * zb[row * h + c];
  }
  float* mr = msg + ((long long)b * n + i) * h;
#pragma unroll
  for (int c = 0; c < HP; ++c)
    if (c < h) mr[c] = acc[c];
}

template <int HP>
static void launch(const void* y, const void* z, const void* idx,
                   const void* starts, void* s, void* msg, int b, int n, int k,
                   int h, int tile, int width, int front,
                   cudaStream_t stream) {
  constexpr int kThreads = 128;
  dim3 grid((n + kThreads - 1) / kThreads, b);
  crf_sim_kernel<HP><<<grid, kThreads, 0, stream>>>(
      (const float*)y, (const float*)z, (const int*)idx, (const int*)starts,
      (float*)s, (float*)msg, n, k, h, tile, width, front);
}

extern "C" int crf_similarity_message_f32(const void* y, const void* z,
                                          const void* idx, const void* starts,
                                          void* s, void* msg, int b, int n,
                                          int k, int h, int tile, int width,
                                          int front, void* stream) {
  if (b == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (h <= 8) {
    launch<8>(y, z, idx, starts, s, msg, b, n, k, h, tile, width, front, st);
  } else if (h <= 16) {
    launch<16>(y, z, idx, starts, s, msg, b, n, k, h, tile, width, front, st);
  } else if (h <= 32) {
    launch<32>(y, z, idx, starts, s, msg, b, n, k, h, tile, width, front, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
