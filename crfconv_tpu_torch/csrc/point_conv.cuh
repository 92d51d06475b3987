// The eval-mode point convolution shared by K3 (same-scale, point_conv.cu)
// and K5 (strided, point_conv_strided.cu). Per output point i with center
// c_i and neighbour j = idx[i, k] (a source row):
//   t = leaky(a0 * ((c_i - p_j) . W0) + c0)      (W0: [3, H])
//   u = a1 * (t . W1) + c1                       (W1: [H, H])
//   out_i += u * x_j
// with both batch norms folded to affine (a, c) pairs by the caller. The
// center is the point itself (same-scale) or a coarse point (strided).
// Neighbour rows follow K1's clamp into the output tile's window: a row
// outside [0, N) reads zero position, zero features and zero rider.
//
// With a residual rider res [B, N, R] the kernel also writes res_out[i] =
// max_k res[j] (zero for a row outside [0, N)), the strided block's
// residual max-pool over the same neighbours.
//
// Bound: bytes at H = 8 (each neighbour costs one 12-byte position and one
// 4H-byte feature row from L2 against ~H (H + 4) flops; as H grows towards
// 32 the per-neighbour H x H product makes it operations). One thread per
// point keeps u and the accumulator in registers (HP, the padded width, is
// a template constant) and makes t one entry at a time; W0, W1 and the
// affine vectors sit in shared memory, where every thread of a warp reads
// the same word (a broadcast).
// The rider (R up to a few hundred channels) would not fit in registers
// beside them: after the convolution the block's threads take its points'
// (point, channel) pairs, channel fastest, so each neighbour's rider row is
// read in full sectors. Nothing of shape [B, M, K, *] is written to device
// memory, which is what the unfused path pays for.
#pragma once

#include "window.cuh"

constexpr int POINT_CONV_THREADS = 128;

template <int HP>
__global__ void __launch_bounds__(POINT_CONV_THREADS) point_conv_kernel(
    const float* __restrict__ x, const float* __restrict__ pos,
    const float* __restrict__ ctr, const int* __restrict__ idx,
    const int* __restrict__ starts, const float* __restrict__ w0,
    const float* __restrict__ a0, const float* __restrict__ c0,
    const float* __restrict__ w1, const float* __restrict__ a1,
    const float* __restrict__ c1, const float* __restrict__ res,
    float* __restrict__ out, float* __restrict__ res_out, int n, int m,
    int k, int h, int r, int tile, int width, int front, float slope) {
  __shared__ float s_w0[3][HP];
  __shared__ float s_w1[HP][HP];
  __shared__ float s_aff[4][HP];
  for (int e = threadIdx.x; e < HP * HP; e += blockDim.x) {
    const int rr = e / HP, c = e % HP;
    s_w1[rr][c] = (rr < h && c < h) ? w1[rr * h + c] : 0.0f;
  }
  for (int e = threadIdx.x; e < 3 * HP; e += blockDim.x) {
    const int rr = e / HP, c = e % HP;
    s_w0[rr][c] = c < h ? w0[rr * h + c] : 0.0f;
  }
  for (int c = threadIdx.x; c < HP; c += blockDim.x) {
    const bool v = c < h;
    s_aff[0][c] = v ? a0[c] : 0.0f;
    s_aff[1][c] = v ? c0[c] : 0.0f;
    s_aff[2][c] = v ? a1[c] : 0.0f;
    s_aff[3][c] = v ? c1[c] : 0.0f;
  }
  __syncthreads();

  const int i0 = blockIdx.x * blockDim.x;
  const int i = i0 + threadIdx.x;
  const int b = blockIdx.y;
  const float* pb = pos + (long long)b * n * 3;
  if (i < m) {
    const int start = starts[i / tile];
    const float* xb = x + (long long)b * n * h;
    const int* ir = idx + ((long long)b * m + i) * k;
    const float* cr = ctr + ((long long)b * m + i) * 3;
    const float px = cr[0], py = cr[1], pz = cr[2];

    float acc[HP];
#pragma unroll
    for (int c = 0; c < HP; ++c) acc[c] = 0.0f;

    for (int nb = 0; nb < k; ++nb) {
      const long long row = window_row(ir[nb], start, front, width);
      if (!row_in(row, n)) continue;  // zero features: the neighbour adds 0
      const float rx = px - pb[3 * row];
      const float ry = py - pb[3 * row + 1];
      const float rz = pz - pb[3 * row + 2];
      // u = t W1 with t's entries made one at a time, g ascending (a padded
      // g adds t = 0)
      float u[HP];
#pragma unroll
      for (int c = 0; c < HP; ++c) u[c] = 0.0f;
      auto add_row = [&](int g) {
        const float lin = rx * s_w0[0][g] + ry * s_w0[1][g] + rz * s_w0[2][g];
        const float v = s_aff[0][g] * lin + s_aff[1][g];
        const float t = v >= 0.0f ? v : slope * v;
#pragma unroll
        for (int c = 0; c < HP; ++c) u[c] += t * s_w1[g][c];
      };
      if constexpr (HP <= 8) {
        // unrolled: W1's 64 values stay in registers across neighbours
#pragma unroll
        for (int g = 0; g < HP; ++g) add_row(g);
      } else {
        // rolled: W1 is read from shared memory, as HP^2 registers for it
        // would spill (ptxas: 4-8 KB of stack a thread at HP = 32)
#pragma unroll 1
        for (int g = 0; g < h; ++g) add_row(g);
      }
      const float* xr = xb + row * h;
#pragma unroll
      for (int c = 0; c < HP; ++c)
        if (c < h) acc[c] += (s_aff[2][c] * u[c] + s_aff[3][c]) * xr[c];
    }
    float* orow = out + ((long long)b * m + i) * h;
#pragma unroll
    for (int c = 0; c < HP; ++c)
      if (c < h) orow[c] = acc[c];
  }
  if (res == nullptr) return;

  // the rider: the block's (point, channel) pairs, channel fastest
  const float* rb = res + (long long)b * n * r;
  const int count = min((int)blockDim.x, m - i0);
  for (int e = threadIdx.x; e < count * r; e += blockDim.x) {
    const int p = e / r;
    const int c = e - p * r;
    const int ip = i0 + p;
    const int start = starts[ip / tile];
    const int* ir = idx + ((long long)b * m + ip) * k;
    float mx = -INFINITY;
    for (int nb = 0; nb < k; ++nb) {
      const long long row = window_row(ir[nb], start, front, width);
      mx = fmaxf(mx, row_in(row, n) ? rb[row * r + c] : 0.0f);
    }
    res_out[((long long)b * m + ip) * r + c] = mx;
  }
}

// Launch over m output points of b clouds; returns cudaGetLastError(), -1
// for an empty problem, or cudaErrorInvalidValue for h > 32.
inline int point_conv_launch(
    const void* x, const void* pos, const void* ctr, const void* idx,
    const void* starts, const void* w0, const void* a0, const void* c0,
    const void* w1, const void* a1, const void* c1, const void* res,
    void* out, void* res_out, int b, int n, int m, int k, int h, int r,
    int tile, int width, int front, float slope, void* stream) {
  if (b == 0 || m == 0) return -1;  // nothing to launch
  dim3 grid((m + POINT_CONV_THREADS - 1) / POINT_CONV_THREADS, b);
  cudaStream_t s = (cudaStream_t)stream;
#define POINT_CONV_ARGS                                                       \
  (const float*)x, (const float*)pos, (const float*)ctr, (const int*)idx,    \
      (const int*)starts, (const float*)w0, (const float*)a0,                \
      (const float*)c0, (const float*)w1, (const float*)a1, (const float*)c1, \
      (const float*)res, (float*)out, (float*)res_out, n, m, k, h, r, tile,  \
      width, front, slope
  if (h <= 8) {
    point_conv_kernel<8><<<grid, POINT_CONV_THREADS, 0, s>>>(POINT_CONV_ARGS);
  } else if (h <= 16) {
    point_conv_kernel<16><<<grid, POINT_CONV_THREADS, 0, s>>>(POINT_CONV_ARGS);
  } else if (h <= 32) {
    point_conv_kernel<32><<<grid, POINT_CONV_THREADS, 0, s>>>(POINT_CONV_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef POINT_CONV_ARGS
  return (int)cudaGetLastError();
}
