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
// Bound: operations for K3 (the H x H product per neighbour), bytes for K5
// (the rider). The design keeps the products on the FMA pipes:
// - A block owns `passes` (1 or 2, ops/conv.py::block_passes) runs of PB =
//   1024 / HP consecutive points (HP, the padded width 8, 16 or 32, a
//   template constant), four output columns a thread, so HP / 4 lanes of
//   one warp share a point. It clamps its points' indices once into a
//   table of clamped rows by slot and point (the lanes of a warp read
//   consecutive words) and stages, with cp.async, the source rows they
//   span, from the least to the greatest (at most the windows of its first
//   and last tile, `cap`, which the host sizes): positions, and the
//   features where HP = 8 (48-byte rows, so neighbouring rows fall in
//   other banks). At HP >= 16 a point's lanes read a neighbour's 64- or
//   128-byte feature row from L2 in one coalesced request instead, issued
//   before the product (staged, a stride-4 window of 80-byte rows left K5
//   two blocks an SM, and conv2_1 ran slower on the H100).
// - Where the table and the staged rows would not fit shared memory (k or
//   the pad far above the main path's), the launch takes STAGED = false:
//   nothing is staged, and each row is clamped where it is used and read
//   from L2, so any k and pad run.
// - For four neighbours at a time, the point's lanes each make t for four
//   of its HP entries (the affine a0, c0 folded into W0) and exchange them
//   through a 2 KB buffer of their warp. Each lane then forms its 4 x 4
//   tile of U = T W1' (a1 folded into W1, c1 the sum's start): each pair
//   of shared float4 loads (four rows of T, four columns of W1') feeds 16
//   FMAs, and no entry of T is made twice.
// - The lane adds u * x over the neighbours in k order into its four
//   sums: no atomics, so a rerun is bit-identical.
// - The rider: after the convolution each thread takes (point, four
//   channels) pairs (single channels where R % 4 != 0) and issues the
//   loads of 16 neighbours before it takes their max, from L2 (a rider
//   window, 196-393 KB, would not fit shared memory).
// Nothing of shape [B, M, K, *] is written to device memory.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "cp_async.cuh"
#include "window.cuh"

constexpr int PC_THREADS = 256;
constexpr int PC_WARPS = PC_THREADS / 32;
constexpr int PC_TBUF = 512;         // floats of a warp's T buffer
constexpr int PC_RIDER_LOADS = 16;   // rider loads in flight a thread
constexpr int PC_SMEM_MAX = 231424;  // dynamic bytes a block may use

// points a pass of a block takes at padded width hp (four columns a thread)
__host__ __device__ constexpr int pc_points(int hp) {
  return PC_THREADS * 4 / hp;
}

// floats of a staged source row: the position (and a pad), then the
// features where hp == 8
__host__ __device__ constexpr int pc_stride(int hp) {
  return hp == 8 ? 12 : 4;
}

// the clamped rows' table: k rows of the block's points, one word of pad
__host__ __device__ constexpr int pc_cols_stride(int hp, int passes) {
  return pc_points(hp) * passes + 1;
}

// dynamic shared bytes of a block; cap 0 stages nothing and keeps no table
__host__ __device__ inline size_t pc_smem_bytes(int hp, int cap, int k,
                                                int passes) {
  const size_t table = cap > 0 ? (size_t)pc_cols_stride(hp, passes) * k : 0;
  return sizeof(float) * ((size_t)hp * hp + 5 * hp + PC_WARPS * PC_TBUF +
                          (size_t)cap * pc_stride(hp)) +
         sizeof(int) * (table + (size_t)pc_points(hp) * passes);
}

struct PcArgs {
  const float* x;
  const float* pos;
  const float* ctr;
  const int* idx;
  const int* starts;
  const float* w0;
  const float* a0;
  const float* c0;
  const float* w1;
  const float* a1;
  const float* c1;
  const float* res;  // nullptr: no rider
  float* out;
  float* res_out;
  int n, m, k, h, r, tile, width, front;
  int cap;     // rows a block may stage (0: STAGED = false)
  int passes;  // passes of pc_points(HP) points a block makes
  float slope;
  bool vec_x;  // x, out rows as float4s (h % 4 == 0, 16-byte aligned)
  bool vec_r;  // res, res_out rows as float4s
};

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

template <int HP, bool STAGED>
__global__ void __launch_bounds__(PC_THREADS, 3)
point_conv_kernel(const PcArgs a) {
  constexpr int TPP = HP / 4;             // lanes a point
  constexpr int PB = PC_THREADS / TPP;    // points a pass
  constexpr int PW = 32 / TPP;            // points a warp
  constexpr bool STAGE_X = STAGED && HP == 8;
  constexpr int S = pc_stride(HP);
  extern __shared__ __align__(16) float smem[];
  __shared__ int lo_s, hi_s;
  float* w1s = smem;             // [HP][HP]: W1 diag(a1)
  float* w0s = w1s + HP * HP;    // [HP] float4s: a0 W0 (x, y, z), c0
  float* c1s = w0s + 4 * HP;     // [HP]
  float* tbuf = c1s + HP;        // [PC_WARPS][HP][PW] float4s
  float* stage = tbuf + PC_WARPS * PC_TBUF;  // [cap][S]
  const int pbt = PB * a.passes;                  // the block's points
  const int cs = pc_cols_stride(HP, a.passes);    // a slot's row in cols
  // [k][cs]: the lanes of a warp read consecutive words
  int* cols = reinterpret_cast<int*>(stage + a.cap * S);
  int* tstart = cols + (STAGED ? a.k * cs : 0);  // [pbt]: window starts

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * pbt;
  const int n = a.n, m = a.m, k = a.k, h = a.h;
  const int np = min(pbt, m - i0);  // the block's points (a point past m
                                    // repeats the last one)
  for (int p = tid; p < pbt; p += PC_THREADS)
    tstart[p] = a.starts[(i0 + min(p, np - 1)) / a.tile];

  for (int e = tid; e < HP * HP; e += PC_THREADS) {
    const int g = e / HP, c = e % HP;
    w1s[e] = g < h && c < h ? a.w1[g * h + c] * a.a1[c] : 0.0f;
  }
  for (int g = tid; g < HP; g += PC_THREADS) {
    const bool v = g < h;
    const float s = v ? a.a0[g] : 0.0f;
    w0s[4 * g] = v ? s * a.w0[g] : 0.0f;
    w0s[4 * g + 1] = v ? s * a.w0[h + g] : 0.0f;
    w0s[4 * g + 2] = v ? s * a.w0[2 * h + g] : 0.0f;
    w0s[4 * g + 3] = v ? a.c0[g] : 0.0f;
    c1s[g] = v ? a.c1[g] : 0.0f;
  }
  if (tid == 0) {
    lo_s = INT_MAX;
    hi_s = INT_MIN;
  }
  __syncthreads();

  // the clamped row of slot j of the block's point p
  const int* ib = a.idx + ((long long)b * m + i0) * k;
  auto clamped = [&](int p, int j) {
    return (int)window_row(ib[min(p, np - 1) * k + j], tstart[p], a.front,
                           a.width);
  };
  const float* pb = a.pos + (long long)b * n * 3;
  const float* xb = a.x + (long long)b * n * h;
  int lo = 0;
  if constexpr (STAGED) {
    // the clamped rows of the block's points, (point, slot) pairs in idx's
    // order (coalesced loads at any k), and the least and greatest of them
    lo = INT_MAX;
    int hi = INT_MIN;
    for (int e = tid; e < pbt * k; e += PC_THREADS) {
      const int p = e / k, j = e - p * k;
      const int row = clamped(p, j);
      cols[j * cs + p] = row;
      lo = min(lo, row);
      hi = max(hi, row);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (tid % 32 == 0) {
      atomicMin(&lo_s, lo);
      atomicMax(&hi_s, hi);
    }
    __syncthreads();
    lo = lo_s;
    const int span = hi_s >= lo ? hi_s - lo + 1 : 0;  // none where k == 0
    if (span > a.cap) __trap();  // the host sized cap to the tiles' windows

    // stage rows [lo, lo + span): zero outside [0, n) and beyond h
    for (int e = tid; e < span * 3; e += PC_THREADS) {
      const int rr = e / 3, d = e - rr * 3;
      const int g = lo + rr;
      const bool in = g >= 0 && g < n;
      cp_async4(stage + rr * S + d, in ? pb + (long long)g * 3 + d : pb,
                in ? 4 : 0);
    }
    if constexpr (STAGE_X) {
      if (a.vec_x) {
        constexpr int Q = HP / 4;
        for (int e = tid; e < span * Q; e += PC_THREADS) {
          const int rr = e / Q, c = (e % Q) * 4;
          const int g = lo + rr;
          const bool in = g >= 0 && g < n && c < h;
          cp_async16(stage + rr * S + 4 + c,
                     in ? xb + (long long)g * h + c : xb, in ? 16 : 0);
        }
      } else {
        for (int e = tid; e < span * HP; e += PC_THREADS) {
          const int rr = e / HP, c = e % HP;
          const int g = lo + rr;
          const bool in = g >= 0 && g < n && c < h;
          cp_async4(stage + rr * S + 4 + c,
                    in ? xb + (long long)g * h + c : xb, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // the convolution, PB points a pass: lane cq of a point owns columns
  // [4 cq, 4 cq + 4)
  const int lane = tid % 32, warp = tid / 32;
  const int pw = lane / TPP, cq = lane % TPP;
  float4* tw = reinterpret_cast<float4*>(tbuf + warp * PC_TBUF);
  const float4* w0q = reinterpret_cast<const float4*>(w0s) + 4 * cq;
  const float4* w1q = reinterpret_cast<const float4*>(w1s) + cq;
  const float4 c1v = reinterpret_cast<const float4*>(c1s)[cq];
  const float slope = a.slope;
  for (int p0 = 0; p0 < np; p0 += PB) {
    const int pl = p0 + warp * PW + pw;  // the point in the block
    const int i = i0 + min(pl, np - 1);
    const float* cr = a.ctr + ((long long)b * m + i) * 3;
    const float cx = cr[0], cy = cr[1], cz = cr[2];
    const int* cp = cols + pl;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

    for (int k0 = 0; k0 < k; k0 += 4) {
      int rows[4];  // source rows (a slot past k repeats slot k0)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = k0 + r < k ? k0 + r : k0;
        rows[r] = STAGED ? cp[j * cs] : clamped(pl, j);
      }
      float4 xv[4];
      if constexpr (!STAGE_X) {
        // the neighbours' feature rows from L2, in flight over the product
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int g = rows[r];
          const float* xr = xb + (long long)g * h + 4 * cq;
          const bool in = g >= 0 && g < n;
          if (a.vec_x) {
            xv[r] = in && 4 * cq < h
                        ? __ldg(reinterpret_cast<const float4*>(xr))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          } else {
            const int c = 4 * cq;
            xv[r].x = in && c < h ? __ldg(xr) : 0.0f;
            xv[r].y = in && c + 1 < h ? __ldg(xr + 1) : 0.0f;
            xv[r].z = in && c + 2 < h ? __ldg(xr + 2) : 0.0f;
            xv[r].w = in && c + 3 < h ? __ldg(xr + 3) : 0.0f;
          }
        }
      }
      // t of four neighbours at this lane's four entries g = 4 cq + j
      float4 t[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4 p;
        if constexpr (STAGED) {
          p = *reinterpret_cast<const float4*>(stage + (rows[r] - lo) * S);
        } else {
          const float* q = pb + (long long)rows[r] * 3;
          const bool in = rows[r] >= 0 && rows[r] < n;
          p = in ? make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), 0.0f)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        const float rx = cx - p.x, ry = cy - p.y, rz = cz - p.z;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w = w0q[j];
          const float v = fmaf(rx, w.x, fmaf(ry, w.y, fmaf(rz, w.z, w.w)));
          const float tv = v >= 0.0f ? v : slope * v;
          if (r == 0) t[j].x = tv;
          if (r == 1) t[j].y = tv;
          if (r == 2) t[j].z = tv;
          if (r == 3) t[j].w = tv;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) tw[(4 * cq + j) * PW + pw] = t[j];
      __syncwarp();
      // u[r][c] = c1 + sum_g T[r][g] W1'[g][c], g ascending
      float u[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        u[r][0] = c1v.x;
        u[r][1] = c1v.y;
        u[r][2] = c1v.z;
        u[r][3] = c1v.w;
      }
#pragma unroll
      for (int g = 0; g < HP; ++g) {
        const float4 tv = tw[g * PW + pw];
        const float4 wv = w1q[g * TPP];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float tr = comp(tv, r);
          u[r][0] = fmaf(tr, wv.x, u[r][0]);
          u[r][1] = fmaf(tr, wv.y, u[r][1]);
          u[r][2] = fmaf(tr, wv.z, u[r][2]);
          u[r][3] = fmaf(tr, wv.w, u[r][3]);
        }
      }
      __syncwarp();  // the buffer free for the next four
      if constexpr (STAGE_X) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          xv[r] = *reinterpret_cast<const float4*>(stage + (rows[r] - lo) * S +
                                                   4 + 4 * cq);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (k0 + r < k) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = fmaf(u[r][c], comp(xv[r], c),
                                                    acc[c]);
        }
      }
    }
    if (pl < np) {
      float* orow = a.out + ((long long)b * m + i) * h + 4 * cq;
      if (a.vec_x) {
        if (4 * cq < h)
          *reinterpret_cast<float4*>(orow) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * cq + c < h) orow[c] = acc[c];
      }
    }
  }
  if (a.res == nullptr) return;

  // the rider: (point, four channels) a thread, PC_RIDER_LOADS loads in
  // flight before their max (a slot past k repeats slot k0: no change)
  const int rw = a.r;
  const float* rb = a.res + (long long)b * n * rw;
  const int rq = a.vec_r ? rw / 4 : rw;  // work items a point
  for (int e = tid; e < np * rq; e += PC_THREADS) {
    const int p = e / rq, q = e - p * rq;
    const int* rp = cols + p;
    auto row = [&](int j) { return STAGED ? rp[j * cs] : clamped(p, j); };
    float* dst = a.res_out + ((long long)b * m + i0 + p) * rw;
    if (a.vec_r) {
      float4 mx = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      for (int k0 = 0; k0 < k; k0 += PC_RIDER_LOADS) {
        float4 v[PC_RIDER_LOADS];
#pragma unroll
        for (int j = 0; j < PC_RIDER_LOADS; ++j) {
          const int g = row(k0 + j < k ? k0 + j : k0);
          v[j] = g >= 0 && g < n
                     ? __ldg(reinterpret_cast<const float4*>(
                                 rb + (long long)g * rw) + q)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < PC_RIDER_LOADS; ++j) mx = max4(mx, v[j]);
      }
      reinterpret_cast<float4*>(dst)[q] = mx;
    } else {
      float mx = -INFINITY;
      for (int k0 = 0; k0 < k; k0 += PC_RIDER_LOADS) {
        float v[PC_RIDER_LOADS];
#pragma unroll
        for (int j = 0; j < PC_RIDER_LOADS; ++j) {
          const int g = row(k0 + j < k ? k0 + j : k0);
          v[j] = g >= 0 && g < n ? __ldg(rb + (long long)g * rw + q) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < PC_RIDER_LOADS; ++j) mx = fmaxf(mx, v[j]);
      }
      dst[q] = mx;
    }
  }
}

template <int HP, bool STAGED>
static int pc_launch(const PcArgs& a, int b, cudaStream_t s) {
  const size_t smem = pc_smem_bytes(HP, a.cap, a.k, a.passes);
  auto kern = point_conv_kernel<HP, STAGED>;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const int pb = pc_points(HP) * a.passes;
  kern<<<dim3((unsigned)((a.m + pb - 1) / pb), (unsigned)b), PC_THREADS, smem,
         s>>>(a);
  return (int)cudaGetLastError();
}

static inline bool pc_aligned(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// packed int64s: x, pos, ctr, idx, starts, w0, a0, c0, w1, a1, c1, res (or
// 0), out, res_out (or 0), b, n, m, k, h, r, tile, width, front, passes
// (ops/conv.py::block_passes), cap (the rows a block may stage,
// ops/conv.py::stage_rows), stream; then slope as a double. Returns
// cudaGetLastError(), -1 for an empty problem, or cudaErrorInvalidValue for
// h > 32, passes < 1, cap < 1, or a rider that is missing where one is
// asked for.
template <int HP>
static int pc_dispatch(PcArgs a, int b, cudaStream_t s) {
  if (pc_smem_bytes(HP, a.cap, a.k, a.passes) <= PC_SMEM_MAX)
    return pc_launch<HP, true>(a, b, s);
  a.cap = 0;  // the table and the staged rows do not fit: stage nothing
  return pc_launch<HP, false>(a, b, s);
}

inline int point_conv_launch(const char* packed, bool rider) {
  long long v[26];
  double slope;
  memcpy(v, packed, sizeof v);
  memcpy(&slope, packed + sizeof v, sizeof slope);
  PcArgs a;
  a.x = (const float*)v[0];
  a.pos = (const float*)v[1];
  a.ctr = (const float*)v[2];
  a.idx = (const int*)v[3];
  a.starts = (const int*)v[4];
  a.w0 = (const float*)v[5];
  a.a0 = (const float*)v[6];
  a.c0 = (const float*)v[7];
  a.w1 = (const float*)v[8];
  a.a1 = (const float*)v[9];
  a.c1 = (const float*)v[10];
  a.res = (const float*)v[11];
  a.out = (float*)v[12];
  a.res_out = (float*)v[13];
  const int b = (int)v[14];
  a.n = (int)v[15];
  a.m = (int)v[16];
  a.k = (int)v[17];
  a.h = (int)v[18];
  a.r = (int)v[19];
  a.tile = (int)v[20];
  a.width = (int)v[21];
  a.front = (int)v[22];
  a.passes = (int)v[23];
  a.cap = (int)v[24];
  cudaStream_t s = (cudaStream_t)v[25];
  a.slope = (float)slope;
  if (b == 0 || a.m == 0) return -1;  // nothing to launch
  if (a.passes < 1 || a.cap < 1 || (rider && (a.res == nullptr || a.r < 1)))
    return (int)cudaErrorInvalidValue;
  a.vec_x = a.h % 4 == 0 && pc_aligned(a.x) && pc_aligned(a.out);
  a.vec_r = a.res != nullptr && a.r % 4 == 0 && pc_aligned(a.res) &&
            pc_aligned(a.res_out);
  if (a.h <= 8) return pc_dispatch<8>(a, b, s);
  if (a.h <= 16) return pc_dispatch<16>(a, b, s);
  if (a.h <= 32) return pc_dispatch<32>(a, b, s);
  return (int)cudaErrorInvalidValue;
}
