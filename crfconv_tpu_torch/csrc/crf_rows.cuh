// Row blocking and the message S~ x shared by the CRF iterate kernels (K10
// forward, K11 backward).
//
// A block of THREADS threads owns R = groups * RT consecutive rows of the
// flattened [B*N, H] state. For the H x H products each thread owns one
// column c of RT rows (columns c, c + cols, ... when H > THREADS), so that
// one load of M serves RT rows; the threads of a group are the columns.
#pragma once

#include <cuda_runtime.h>

constexpr int CRF_THREADS = 256;
constexpr int CRF_RT = 8;  // rows per thread in an H x H product

struct CrfRows {
  int cols;    // threads per row group (<= CRF_THREADS)
  int groups;  // row groups per block
  int rows;    // rows per block, groups * CRF_RT
};

__host__ __device__ inline CrfRows crf_rows(int h) {
  CrfRows g;
  g.cols = h < CRF_THREADS ? h : CRF_THREADS;
  g.groups = CRF_THREADS / g.cols;
  g.rows = g.groups * CRF_RT;
  return g;
}

// msg[m, c] = sum_j s[m, j] * x[b, col[m, j], c], j ascending from zero,
// each product and sum rounded on its own; slots with col < 0 add nothing
// (their row reads zero).
__device__ __forceinline__ float crf_message_at(
    const float* __restrict__ x, const float* __restrict__ s,
    const int* __restrict__ col, long long m, int c, int n, int k, int h) {
  const float* xb = x + (m / n) * n * (long long)h + c;
  const int* cm = col + m * k;
  const float* sm = s + m * k;
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int cj = cm[j];
    if (cj >= 0) acc = __fadd_rn(acc, __fmul_rn(sm[j], xb[(long long)cj * h]));
  }
  return acc;
}

// msg[r * h + c] = crf_message_at(m = row0 + r, c) for the block's rows
// (zero beyond the last). c is fastest across threads, so a row of x is
// read in full sectors.
__device__ __forceinline__ void crf_message(
    const float* __restrict__ x, const float* __restrict__ s,
    const int* __restrict__ col, float* msg, long long row0, int r_count,
    long long rows, int n, int k, int h) {
  for (int e = threadIdx.x; e < r_count * h; e += blockDim.x) {
    const int r = e / h;
    const int c = e - r * h;
    const long long m = row0 + r;
    msg[e] = m < rows ? crf_message_at(x, s, col, m, c, n, k, h) : 0.0f;
  }
}
