// K4: CRF similarity and first mean-field message, fused.
//
// Replaces crfconv_tpu/ops/crf_sim_pallas.py::crf_similarity_message
// (_kernel_sim). Per point i with neighbours j = idx[i, k] (self removed):
//   s_k = softmax_k(-|y_i - y_j|^2)   (max subtracted, sum clamped at 1e-30)
//   msg_i = sum_k s_k z_j
// Neighbour rows follow K1's clamp: a row outside [0, N) reads zero y and
// zero z.
//
// Bound: bytes (y, z, idx read once, s and msg written once; ~5H flops a
// neighbour). The design:
// - A 256-thread block owns SIM_POINTS = 128 consecutive points (two
//   64-row tiles) and takes them in passes of 1024 / HP (HP, the padded
//   width 8, 16 or 32, a template constant). A point is a group of HP / 4
//   lanes of one warp, each holding one float4 of its channels: y_i and the
//   message sit in one register quad a lane, and the squared distance is
//   the group's shuffle reduction (butterfly, so every lane holds the same
//   bits). A neighbour's y or z row is one request of the group's lanes,
//   from L2 (or L1), four slots' loads in flight.
// - TABLE: the block clamps its points' indices once into a shared table
//   of rows by slot and point (coalesced idx loads), and keeps the
//   distances in a shared [points][k | 1] buffer (odd stride: the groups
//   of a warp read other banks).
// - The call is latency-bound: more blocks in flight help, so at HP 8 and
//   16 the kernel keeps to 32 registers for eight blocks an SM, at HP 32
//   to 64 for four (uncapped, ptxas took 71 and three blocks fit: 1.37
//   times as slow; at 40, six blocks, 1.04 times). Staging the rows in
//   shared memory instead (a block's span of rows, or a ring of rows
//   sliding over consecutive tiles, with cp.async), or fewer blocks an SM
//   with more L1, was slower at every width on the H100.
// - DIRECT, where the table and buffer would outgrow shared memory (k above
//   SIM_TABLE_MAX_K, far above the main path's): each row is clamped where
//   it is read and the distances go to s itself. On the main path's calls
//   it took 1.16-3.2 times TABLE's time on the H100 (tools/ab_k4_k9.py).
// - Two passes over k: the distances and their max; then e_k = exp(-d_k -
//   max), their sum and the message sum_k e_k z_j, in k order. s = e / sum
//   is written once, coalesced over the block's [points, k] slab. No
//   atomics: a rerun is bit-identical.
// Nothing of shape [B, N, K, H] reaches device memory.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "window.cuh"

constexpr int SIM_THREADS = 256;
constexpr int SIM_POINTS = 128;        // points a block owns: two tiles
constexpr int SIM_SMEM_MAX = 231424;   // dynamic bytes a block may use

// dynamic shared bytes of a TABLE block: the [k][SIM_POINTS + 1] table, the
// [SIM_POINTS][k | 1] distances, and the max, sum and window start of each
// point
constexpr size_t sim_smem_bytes(int k) {
  return 4 * ((size_t)k * (SIM_POINTS + 1) + (size_t)SIM_POINTS * (k | 1) +
              3 * (size_t)SIM_POINTS);
}

// the largest k whose table and buffer fit shared memory (TABLE)
constexpr int sim_table_max_k() {
  int k = 1;
  while (sim_smem_bytes(k + 1) <= SIM_SMEM_MAX) ++k;
  return k;
}
constexpr int SIM_TABLE_MAX_K = sim_table_max_k();

struct SimArgs {
  const float* y;
  const float* z;
  const int* idx;
  const int* starts;
  float* s;
  float* msg;
  int n, k, h, tile, width, front;
  bool vec;    // y, z, msg rows as float4s (h % 4 == 0, 16-byte aligned)
};

// registers for eight blocks an SM at HP < 32, four at HP 32
template <int HP, bool TABLE>
__global__ void __launch_bounds__(SIM_THREADS, HP < 32 ? 8 : 4)
crf_sim_kernel(const SimArgs a) {
  constexpr int G = HP / 4;              // lanes a point
  constexpr int PW = 32 / G;             // points a warp
  constexpr int PB = SIM_THREADS / G;    // points a pass
  static_assert(SIM_POINTS % PB == 0, "a block's points in whole passes");
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int n = a.n, k = a.k, h = a.h;
  const int i0 = blockIdx.x * SIM_POINTS;
  const int np = min(SIM_POINTS, n - i0);  // the block's points
  const int cs = SIM_POINTS + 1;           // a slot's row in the table
  const int ds = k | 1;                  // a point's row of distances
  int* cols = reinterpret_cast<int*>(smem);                // [k][cs]
  float* dbuf = reinterpret_cast<float*>(cols + k * cs);   // [points][ds]
  float* mxs = dbuf + SIM_POINTS * ds;
  float* sums = mxs + SIM_POINTS;
  int* tstart = reinterpret_cast<int*>(sums + SIM_POINTS);

  const long long bn = (long long)b * n;
  const float* yb = a.y + bn * h;
  const float* zb = a.z + bn * h;
  const int* ib = a.idx + (bn + i0) * k;

  if constexpr (TABLE) {
    for (int p = tid; p < np; p += SIM_THREADS)
      tstart[p] = a.starts[(i0 + p) / a.tile];
    __syncthreads();
    // the clamped rows of the block's points, (point, slot) pairs in idx's
    // order (coalesced at any k)
    for (int e = tid; e < np * k; e += SIM_THREADS) {
      const int p = e / k, j = e - p * k;
      cols[j * cs + p] =
          (int)window_row(ib[e], tstart[p], a.front, a.width);
    }
    __syncthreads();
  }

  // PB points a pass: lane cq of a point owns channels [4 cq, 4 cq + 4)
  const int lane = tid % 32, warp = tid / 32;
  const int pw = lane / G, cq = lane % G;
  const int c0 = 4 * cq;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // this lane's quad of a row of y or z (zero beyond h)
  auto load4 = [&](const float* base, long long row) -> float4 {
    const float* r = base + row * h + c0;
    if (a.vec)
      return c0 < h ? __ldg(reinterpret_cast<const float4*>(r)) : zero4;
    return make_float4(c0 < h ? __ldg(r) : 0.0f,
                       c0 + 1 < h ? __ldg(r + 1) : 0.0f,
                       c0 + 2 < h ? __ldg(r + 2) : 0.0f,
                       c0 + 3 < h ? __ldg(r + 3) : 0.0f);
  };
  // ... of a neighbour's row: zero outside [0, n)
  auto nbr4 = [&](const float* base, int row) -> float4 {
    return row >= 0 && row < n ? load4(base, row) : zero4;
  };

  for (int p0 = 0; p0 < np; p0 += PB) {
    const int pl = p0 + warp * PW + pw;  // the point in the block
    const bool live = pl < np;
    const int pe = live ? pl : np - 1;   // a point past the block's repeats
    const int i = i0 + pe;               // its last one
    const float4 yi = load4(yb, i);
    const int start = TABLE ? 0 : a.starts[i / a.tile];
    const int* ir = ib + pe * k;
    // the point's distances: its own buffer row (a point past the block's
    // has one too), or its row of s
    float* dr = TABLE ? dbuf + pl * ds : a.s + (bn + i) * k;
    const bool keep = TABLE || live;
    auto row_of = [&](int j) -> int {
      if constexpr (TABLE) return cols[j * cs + pe];
      return (int)window_row(ir[j], start, a.front, a.width);
    };

    // pass 1: -d_k and their max, four slots' loads in flight (a slot past
    // k repeats slot k0)
    float mx = -INFINITY;
    for (int k0 = 0; k0 < k; k0 += 4) {
      float4 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = nbr4(yb, row_of(k0 + r < k ? k0 + r : k0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = k0 + r;
        if (j < k) {
          const float dx = yi.x - v[r].x, dy = yi.y - v[r].y;
          const float dz = yi.z - v[r].z, dw = yi.w - v[r].w;
          float d = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, dw * dw)));
#pragma unroll
          for (int off = G / 2; off > 0; off /= 2)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          if (keep && j % G == cq) dr[j] = -d;
          mx = fmaxf(mx, -d);
        }
      }
    }
    __syncwarp();

    // pass 2: e_k, their sum and sum_k e_k z_j, k ascending (no shuffles:
    // on DIRECT a point past the block's skips it, as the live point may be
    // rewriting its row of s)
    float sum = 0.0f;
    float4 acc = zero4;
    for (int k0 = 0; keep && k0 < k; k0 += 4) {
      float4 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = nbr4(zb, row_of(k0 + r < k ? k0 + r : k0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = k0 + r;
        if (j < k) {
          const float e = expf(dr[j] - mx);
          sum += e;
          acc.x = fmaf(e, v[r].x, acc.x);
          acc.y = fmaf(e, v[r].y, acc.y);
          acc.z = fmaf(e, v[r].z, acc.z);
          acc.w = fmaf(e, v[r].w, acc.w);
        }
      }
    }
    const float sc = fmaxf(sum, 1e-30f);
    if (live) {
      const float4 m = make_float4(acc.x / sc, acc.y / sc, acc.z / sc,
                                   acc.w / sc);
      float* mr = a.msg + (bn + i) * h + c0;
      if (a.vec) {
        if (c0 < h) *reinterpret_cast<float4*>(mr) = m;
      } else {
        if (c0 < h) mr[0] = m.x;
        if (c0 + 1 < h) mr[1] = m.y;
        if (c0 + 2 < h) mr[2] = m.z;
        if (c0 + 3 < h) mr[3] = m.w;
      }
      if (TABLE && cq == 0) {
        mxs[pl] = mx;
        sums[pl] = sc;
      }
    }
    if constexpr (!TABLE) {
      __syncwarp();  // the group's lanes have read every -d_k
      // s over the distances each lane wrote itself
      if (live)
        for (int j = cq; j < k; j += G) dr[j] = expf(dr[j] - mx) / sc;
    }
  }

  if constexpr (TABLE) {
    // s = e / sum over the block's [np, k] slab of s, coalesced
    __syncthreads();
    float* sb = a.s + (bn + i0) * k;
    for (int e = tid; e < np * k; e += SIM_THREADS) {
      const int p = e / k, j = e - p * k;
      sb[e] = expf(dbuf[p * ds + j] - mxs[p]) / sums[p];
    }
  }
}

template <int HP, bool TABLE>
static int sim_launch(const SimArgs& a, int b, cudaStream_t st) {
  auto kern = crf_sim_kernel<HP, TABLE>;
  const size_t smem = TABLE ? sim_smem_bytes(a.k) : 0;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  kern<<<dim3((unsigned)((a.n + SIM_POINTS - 1) / SIM_POINTS), (unsigned)b),
         SIM_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// TABLE where its table and buffer fit shared memory, else DIRECT
template <int HP>
static int sim_dispatch(const SimArgs& a, int b, cudaStream_t st) {
  if (a.k <= SIM_TABLE_MAX_K)
    return sim_launch<HP, true>(a, b, st);
  return sim_launch<HP, false>(a, b, st);
}

static inline bool sim_aligned(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// packed int64s: y, z, idx, starts, s, msg, b, n, k, h, tile, width, front,
// stream. Returns cudaGetLastError(), -1 for an empty problem, or
// cudaErrorInvalidValue for h > 32.
extern "C" int crf_similarity_message_f32(const char* packed) {
  long long v[14];
  memcpy(v, packed, sizeof v);
  SimArgs a;
  a.y = (const float*)v[0];
  a.z = (const float*)v[1];
  a.idx = (const int*)v[2];
  a.starts = (const int*)v[3];
  a.s = (float*)v[4];
  a.msg = (float*)v[5];
  const int b = (int)v[6];
  a.n = (int)v[7];
  a.k = (int)v[8];
  a.h = (int)v[9];
  a.tile = (int)v[10];
  a.width = (int)v[11];
  a.front = (int)v[12];
  cudaStream_t st = (cudaStream_t)v[13];
  if (b == 0 || a.n == 0) return -1;  // nothing to launch
  a.vec = a.h % 4 == 0 && sim_aligned(a.y) && sim_aligned(a.z) &&
          sim_aligned(a.msg);
  if (a.h <= 8) return sim_dispatch<8>(a, b, st);
  if (a.h <= 16) return sim_dispatch<16>(a, b, st);
  if (a.h <= 32) return sim_dispatch<32>(a, b, st);
  return (int)cudaErrorInvalidValue;
}

// the largest k that takes the TABLE route (the card tests' route check)
extern "C" int crf_similarity_table_max_k() { return SIM_TABLE_MAX_K; }
