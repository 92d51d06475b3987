// K9: the continuous CRF's operator S~, built once per CRF call.
//
//   col[b,m,k] = clamp(idx[b,m,k])   if that row lies in [0, N), else -1
//
// idx[B,N,K] int32 (same-scale neighbours, self removed) -> col[B,N,K] int32.
// The clamp is K1's (window.cuh): each index is clamped into the window of
// its row's tile. Row m of S~ then holds s[m,k] at column col[m,k] (the
// weights are s itself, masked slots with s = 0 kept, duplicated columns
// adding up as separate slots), in the ELL layout the iterate kernels (K10,
// K11) and the neighbour dot (K12) read.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_banded_setup (_build_at_kernel),
// and the backward's _banded_setup_rows. The TPU kernel scatters the weights
// into dense [w, 128] band blocks (hi/lo bf16) for the MXU; on Hopper the
// iterations gather rows instead, so the operator is its columns. What this
// kernel saves is the clamp, paid once per call instead of at every one of
// the 2 * steps iterations of the forward and backward.
//
// Bound: bytes (idx read once, col written once). A block takes one tile of
// one cloud, whose rows share one window start, read once: the tile's
// slots are one contiguous run of tile * K words, so no slot's row is
// divided out. The run moves as int4s (16-byte loads and stores) where idx
// and col share their offset modulo 16 bytes, with a scalar head up to the
// first 16-byte boundary and a scalar tail: on the main path's calls that
// took 0.72-0.86 of the time of one coalesced loop of 4-byte loads and
// stores on the H100 (tools/ab_k4_k9.py). All index arithmetic is 32-bit
// but the run's base.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

constexpr int OP_THREADS = 256;

struct OpArgs {
  const int* idx;
  const int* starts;
  int* col;
  int n, k, tile, width, front;
};

__global__ void __launch_bounds__(OP_THREADS)
crf_operator_kernel(const OpArgs a) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int r0 = t * a.tile;
  const int len = min(a.tile, a.n - r0) * a.k;  // the tile's slots
  const long long base = ((long long)b * a.n + r0) * a.k;
  const int* ib = a.idx + base;
  int* cb = a.col + base;
  const int lo = a.starts[t] - a.front;  // the window's first row
  const int last = a.width - 1, n = a.n;
  auto clamp = [&](int v) {
    const int row = lo + min(max(v - lo, 0), last);
    return row >= 0 && row < n ? row : -1;
  };
  const int head =
      ((uintptr_t)ib & 15) == ((uintptr_t)cb & 15)
          ? min(len, (int)((16 - ((uintptr_t)ib & 15)) & 15) / 4)
          : len;
  const int quads = (len - head) / 4;
  const int4* iq = reinterpret_cast<const int4*>(ib + head);
  int4* cqd = reinterpret_cast<int4*>(cb + head);
  for (int q = threadIdx.x; q < quads; q += OP_THREADS) {
    const int4 v = __ldg(iq + q);
    cqd[q] = make_int4(clamp(v.x), clamp(v.y), clamp(v.z), clamp(v.w));
  }
  for (int e = threadIdx.x; e < head; e += OP_THREADS) cb[e] = clamp(ib[e]);
  for (int e = head + 4 * quads + threadIdx.x; e < len; e += OP_THREADS)
    cb[e] = clamp(ib[e]);
}

// packed int64s: idx, starts, col, b, n, k, tile, width, front, stream.
// Returns cudaGetLastError(), or -1 for an empty problem.
extern "C" int crf_operator_i32(const char* packed) {
  long long v[10];
  memcpy(v, packed, sizeof v);
  OpArgs a;
  a.idx = (const int*)v[0];
  a.starts = (const int*)v[1];
  a.col = (int*)v[2];
  const int b = (int)v[3];
  a.n = (int)v[4];
  a.k = (int)v[5];
  a.tile = (int)v[6];
  a.width = (int)v[7];
  a.front = (int)v[8];
  cudaStream_t st = (cudaStream_t)v[9];
  if (b == 0 || a.n == 0 || a.k == 0) return -1;  // nothing to launch
  const unsigned tiles = (unsigned)((a.n + a.tile - 1) / a.tile);
  crf_operator_kernel<<<dim3(tiles, (unsigned)b), OP_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
