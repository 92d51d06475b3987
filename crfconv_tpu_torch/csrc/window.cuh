// Window geometry shared by the four kernels (ops/windowed.py::window_starts).
//
// Output tile t = m / tile may read source rows
// [starts[t] - front, starts[t] - front + width) in unpadded coordinates.
// A neighbour index is clamped into that window; a clamped row that falls
// outside [0, N) reads zero (the source is zero-padded on both sides).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ long long window_row(int idx, int start, int front,
                                                int width) {
  int rel = idx + front - start;
  rel = min(max(rel, 0), width - 1);
  return (long long)start - front + rel;
}

__device__ __forceinline__ bool row_in(long long row, int n) {
  return row >= 0 && row < n;
}
