// K3: eval-mode same-scale point convolution, fused.
//
// Replaces crfconv_tpu/ops/conv_pallas.py::point_conv_fused_infer
// (_kernel_conv). Per point i and neighbour j = idx[i, k]:
//   t = leaky(a0 * ((p_i - p_j) . W0) + c0)      (W0: [3, H])
//   u = a1 * (t . W1) + c1                       (W1: [H, H])
//   out_i += u * x_j
// with both batch norms folded to affine (a, c) pairs by the caller.
// Neighbour rows follow K1's clamp: a row outside [0, N) reads zero
// position and zero features.
//
// Bound: bytes at H = 8 (each neighbour costs one 12-byte position and one
// 4H-byte feature row from L2 against ~H (H + 4) flops; as H grows towards
// 32 the per-neighbour H x H product makes it operations). One thread per
// point keeps t, u and the accumulator in registers (HP, the padded width,
// is a template constant), and W0, W1 and the affine vectors sit in shared
// memory, where every thread of a warp reads the same word (a broadcast).
// Nothing of shape [B, N, K, *] is written to device memory, which is what
// the unfused path pays for.
#include "window.cuh"

template <int HP>
__global__ void point_conv_kernel(
    const float* __restrict__ x, const float* __restrict__ pos,
    const int* __restrict__ idx, const int* __restrict__ starts,
    const float* __restrict__ w0, const float* __restrict__ a0,
    const float* __restrict__ c0, const float* __restrict__ w1,
    const float* __restrict__ a1, const float* __restrict__ c1,
    float* __restrict__ out, int n, int k, int h, int tile, int width,
    int front, float slope) {
  __shared__ float s_w0[3][HP];
  __shared__ float s_w1[HP][HP];
  __shared__ float s_aff[4][HP];
  for (int e = threadIdx.x; e < HP * HP; e += blockDim.x) {
    const int r = e / HP, c = e % HP;
    s_w1[r][c] = (r < h && c < h) ? w1[r * h + c] : 0.0f;
  }
  for (int e = threadIdx.x; e < 3 * HP; e += blockDim.x) {
    const int r = e / HP, c = e % HP;
    s_w0[r][c] = c < h ? w0[r * h + c] : 0.0f;
  }
  for (int c = threadIdx.x; c < HP; c += blockDim.x) {
    const bool v = c < h;
    s_aff[0][c] = v ? a0[c] : 0.0f;
    s_aff[1][c] = v ? c0[c] : 0.0f;
    s_aff[2][c] = v ? a1[c] : 0.0f;
    s_aff[3][c] = v ? c1[c] : 0.0f;
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= n) return;
  const int start = starts[i / tile];
  const float* pb = pos + (long long)b * n * 3;
  const float* xb = x + (long long)b * n * h;
  const int* ir = idx + ((long long)b * n + i) * k;
  const float px = pb[3 * i], py = pb[3 * i + 1], pz = pb[3 * i + 2];

  float acc[HP];
#pragma unroll
  for (int c = 0; c < HP; ++c) acc[c] = 0.0f;

  for (int nb = 0; nb < k; ++nb) {
    const long long row = window_row(ir[nb], start, front, width);
    if (!row_in(row, n)) continue;  // zero features: the neighbour adds 0
    const float rx = px - pb[3 * row];
    const float ry = py - pb[3 * row + 1];
    const float rz = pz - pb[3 * row + 2];
    float tv[HP];
#pragma unroll
    for (int c = 0; c < HP; ++c) {
      const float lin = rx * s_w0[0][c] + ry * s_w0[1][c] + rz * s_w0[2][c];
      const float v = s_aff[0][c] * lin + s_aff[1][c];
      tv[c] = v >= 0.0f ? v : slope * v;
    }
    const float* xr = xb + row * h;
#pragma unroll
    for (int c = 0; c < HP; ++c) {
      if (c < h) {
        float u = 0.0f;
#pragma unroll
        for (int g = 0; g < HP; ++g) u += tv[g] * s_w1[g][c];
        acc[c] += (s_aff[2][c] * u + s_aff[3][c]) * xr[c];
      }
    }
  }
  float* orow = out + ((long long)b * n + i) * h;
#pragma unroll
  for (int c = 0; c < HP; ++c)
    if (c < h) orow[c] = acc[c];
}

template <int HP>
static void launch(const void* x, const void* pos, const void* idx,
                   const void* starts, const void* w0, const void* a0,
                   const void* c0, const void* w1, const void* a1,
                   const void* c1, void* out, int b, int n, int k, int h,
                   int tile, int width, int front, float slope,
                   cudaStream_t stream) {
  constexpr int kThreads = 128;
  dim3 grid((n + kThreads - 1) / kThreads, b);
  point_conv_kernel<HP><<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const float*)pos, (const int*)idx,
      (const int*)starts, (const float*)w0, (const float*)a0,
      (const float*)c0, (const float*)w1, (const float*)a1, (const float*)c1,
      (float*)out, n, k, h, tile, width, front, slope);
}

extern "C" int point_conv_infer_f32(const void* x, const void* pos,
                                    const void* idx, const void* starts,
                                    const void* w0, const void* a0,
                                    const void* c0, const void* w1,
                                    const void* a1, const void* c1, void* out,
                                    int b, int n, int k, int h, int tile,
                                    int width, int front, float slope,
                                    void* stream) {
  if (b == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (h <= 8) {
    launch<8>(x, pos, idx, starts, w0, a0, c0, w1, a1, c1, out, b, n, k, h,
              tile, width, front, slope, s);
  } else if (h <= 16) {
    launch<16>(x, pos, idx, starts, w0, a0, c0, w1, a1, c1, out, b, n, k, h,
               tile, width, front, slope, s);
  } else if (h <= 32) {
    launch<32>(x, pos, idx, starts, w0, a0, c0, w1, a1, c1, out, b, n, k, h,
               tile, width, front, slope, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
