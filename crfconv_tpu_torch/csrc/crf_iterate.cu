// K10: every Jacobi step of one call of the continuous CRF's mean field,
//
//   x_{t+1}[m,:] = zp[m,:] + (sum_k s[m,k] * x_t[col[m,k],:]) M,
//
// for t = 0 .. steps-1 from x_0 = z. z, zp, x_t [B,N,H], s [B,N,K], col
// [B,N,K] int32 (K9, -1 = reads zero), M [H,H], all f32 except col. Step t
// writes x_{t+1} into xs[t+1] when the caller saves the stack (xs [steps,
// B,N,H], xs[0] = z), else into one of two ping-pong buffers, and the last
// step into out; a step never writes the state it reads.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_run_core (_iterate_kernel,
// _iterate_stack_kernel), which runs every step in one pallas_call with x
// transposed in VMEM and hi/lo bf16 band blocks on the MXU. Here too one
// launch runs every step: a persistent cooperative grid (as many blocks as
// are resident at once) walks the work items of a step, then waits at a
// grid barrier before the next step reads what this one wrote.
//
// A work item is R rows by one tile of HCT output columns, and a block
// takes a run of consecutive items (so the windows its gathers read
// overlap from one item to the next):
//  1. message: the item's s and col rows are staged in shared memory once;
//     a thread owns one (row, 4 columns) element (float4 when H % 4 == 0,
//     else one column) and issues 8 slots' gathers before it adds
//     any, so that the loads are in flight together;
//  2. apply: a register-tiled SIMT product. Each thread owns TM rows x TN
//     columns and reads msg and M from shared memory as float4s; M is held
//     whole where H <= 64 (loaded once a launch) and otherwise streamed in
//     JC-row chunks, double-buffered with cp.async, once per R rows.
// Rows per item and column tiles are chosen per width (launch_for) so that
// one read of M serves 16-64 rows and the grid holds >= 2 blocks an SM. A
// block keeps its items' s and col rows in shared memory for every step
// where they fit without costing a resident block.
//
// The sums keep the plain version's order: k ascending for the message, j
// ascending for the apply, every product and sum rounded on its own
// (__fmul_rn/__fadd_rn, no FMA), so each step is bit-equal to
// crf_iterate_plain. Tensor cores are not used: TF32 would break that.
//
// Bound: a step moves x, zp, s, col and x_{t+1} (bytes lead at H <= 64)
// and does 2 H^2 + 2 K H operations a row (they lead at H >= 128). With
// no FMA each multiply-add is two instructions, so the SIMT floor of the
// apply is twice the f32 peak's time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <string.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

constexpr int IT_THREADS = 256;
constexpr int IT_UNROLL = 8;  // slots whose gathers are issued together
constexpr int IT_SMEM_MAX = 232448;  // bytes of shared memory a block may use

struct IterArgs {
  const float* z;   // x_0
  const float* zp;
  const float* s;
  const int* col;
  const float* M;
  float* xs;        // [steps, rows, h] or null
  float* ping0;     // the two ping-pong states when xs is null
  float* ping1;
  float* out;       // x_steps
  long long rows;
  int n, k, h, steps;
  int cached;  // 1: every item's s and col rows stay in shared memory
};

// the state that step t reads, and the one it writes
__device__ __forceinline__ const float* state_in(const IterArgs& a, int t) {
  if (t == 0) return a.z;
  if (a.xs) return a.xs + (long long)t * a.rows * a.h;
  return (t - 1) % 2 ? a.ping1 : a.ping0;
}

__device__ __forceinline__ float* state_out(const IterArgs& a, int t) {
  if (t == a.steps - 1) return a.out;
  if (a.xs) return a.xs + (long long)(t + 1) * a.rows * a.h;
  return t % 2 ? a.ping1 : a.ping0;
}

// Copy M[j0 : j0+jc, c0 : c0+HCT] into dst [jc][HCT], zero outside [H, H].
template <int VEC, int HCT>
__device__ __forceinline__ void load_m(const float* M, float* dst, int j0,
                                       int jc, int c0, int h) {
  if constexpr (VEC == 4) {
    for (int e = threadIdx.x; e < jc * (HCT / 4); e += IT_THREADS) {
      const int j = e / (HCT / 4), c = (e % (HCT / 4)) * 4;
      const bool in = j0 + j < h && c0 + c < h;
      cp_async16(dst + j * HCT + c,
                 in ? M + (long long)(j0 + j) * h + c0 + c : M, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < jc * HCT; e += IT_THREADS) {
      const int j = e / HCT, c = e % HCT;
      const bool in = j0 + j < h && c0 + c < h;
      cp_async4(dst + j * HCT + c,
                in ? M + (long long)(j0 + j) * h + c0 + c : M, in ? 4 : 0);
    }
  }
}

// msg[r, :] = sum_k s[m,k] x[col[m,k], :] for the item's rows m = row0 + r
// (zero beyond the last row), k ascending, each product and sum rounded.
// A thread issues IT_UNROLL slots' gathers before it adds any.
template <int VEC, int R>
__device__ __forceinline__ void message(const float* x, const IterArgs& a,
                                        const float* sv, const int* cv,
                                        float* msg, int ms, long long row0) {
  const int h = a.h, k = a.k;
  const int nv = h / VEC;  // VEC == 4 only where h % 4 == 0
  for (int e = threadIdx.x; e < R * nv; e += IT_THREADS) {
    const int r = e / nv, c = (e - r * nv) * VEC;
    const long long m = row0 + r;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
    if (m < a.rows) {
      const float* xb = x + (m / a.n) * a.n * (long long)h + c;
      const int* cr = cv + r * k;
      const float* sr = sv + r * k;
      for (int k0 = 0; k0 < k; k0 += IT_UNROLL) {
        float v[IT_UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < IT_UNROLL; ++u) {
          const int j = k0 + u < k ? cr[k0 + u] : -1;
          if (j >= 0) {
            if constexpr (VEC == 4) {
              const float4 t4 =
                  *reinterpret_cast<const float4*>(xb + (long long)j * h);
              v[u][0] = t4.x;
              v[u][1] = t4.y;
              v[u][2] = t4.z;
              v[u][3] = t4.w;
            } else {
              v[u][0] = xb[(long long)j * h];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < IT_UNROLL; ++u) {
          const int j = k0 + u < k ? cr[k0 + u] : -1;
          if (j >= 0) {
            const float w = sr[k0 + u];
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              acc[q] = __fadd_rn(acc[q], __fmul_rn(w, v[u][q]));
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) msg[r * ms + c + q] = acc[q];
  }
}

// acc[i][q] += sum_{j in [j0, j0 + jc)} msg[ty*TM + i, j] * Mc[j - j0, tx*TN + q]
// (jc a multiple of 4, j ascending), each product and sum rounded.
template <int TM, int TN, int HCT>
__device__ __forceinline__ void apply(float (&acc)[TM][TN], const float* msg,
                                      int ms, const float* Mc, int j0,
                                      int jc, int ty, int tx) {
  for (int jj = 0; jj < jc; jj += 4) {
    float av[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 t4 = *reinterpret_cast<const float4*>(
          msg + (ty * TM + i) * ms + j0 + jj);
      av[i][0] = t4.x;
      av[i][1] = t4.y;
      av[i][2] = t4.z;
      av[i][3] = t4.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float mv[TN];
#pragma unroll
      for (int q = 0; q < TN; q += 4) {
        const float4 t4 = *reinterpret_cast<const float4*>(
            Mc + (jj + u) * HCT + tx * TN + q);
        mv[q] = t4.x;
        mv[q + 1] = t4.y;
        mv[q + 2] = t4.z;
        mv[q + 3] = t4.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q)
          acc[i][q] = __fadd_rn(acc[i][q], __fmul_rn(av[i][u], mv[q]));
    }
  }
}

// Copy the s and col rows of the item at row0 into sv [R][k], then col
// (k ints) after them; -1 beyond the last row.
template <int R>
__device__ __forceinline__ void load_rows(const IterArgs& a, float* sv,
                                          long long row0) {
  int* cv = reinterpret_cast<int*>(sv + R * a.k);
  const long long base = row0 * a.k;
  const long long lim = a.rows * a.k;
  for (int e = threadIdx.x; e < R * a.k; e += IT_THREADS) {
    const bool in = base + e < lim;
    sv[e] = in ? __ldg(a.s + base + e) : 0.0f;
    cv[e] = in ? __ldg(a.col + base + e) : -1;
  }
}

// Shared memory, in floats: msg [R][ms], s and col [R][k] for one item (or
// for each of the block's `nb` items, kept across the steps), then M: whole
// [HCT][HCT] (WHOLE) or two [JC][HCT] chunks.
__host__ __device__ inline int msg_stride(int h) {
  return ((h + 3) / 4) * 4 + 4;  // float4 rows, 4 banks apart
}

template <int R, int HCT, int JC, bool WHOLE>
__host__ __device__ inline size_t smem_floats(int h, int k, long long nb) {
  return (size_t)R * msg_stride(h) + 2 * (size_t)R * k * nb +
         (WHOLE ? (size_t)HCT * HCT : 2 * (size_t)JC * HCT);
}

template <int VEC, int R, int HCT, int TM, int TN, int JC, bool WHOLE>
__global__ void __launch_bounds__(IT_THREADS, 2)
crf_iterate_kernel(const IterArgs a) {
  static_assert((R / TM) * (HCT / TN) == IT_THREADS, "thread tile");
  static_assert(TN % 4 == 0 && JC % 4 == 0, "float4 tiles");
  extern __shared__ __align__(16) float smem[];
  const int h = a.h, k = a.k;
  const int ms = msg_stride(h);
  const int hp = (h + 3) / 4 * 4;  // j runs over [0, hp); msg is 0 beyond h
  const int tx = threadIdx.x % (HCT / TN), ty = threadIdx.x / (HCT / TN);
  const int col_tiles = (h + HCT - 1) / HCT;
  const long long items = ((a.rows + R - 1) / R) * col_tiles;
  const int jchunks = (hp + JC - 1) / JC;
  // a block takes a run of consecutive items, so that the windows its
  // gathers read overlap from one item to the next
  const long long per_block = (items + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * per_block;
  const long long last = first + per_block < items ? first + per_block : items;
  float* msg = smem;
  float* rows_buf = msg + R * ms;  // s, col of one item, or of each
  float* Ms = rows_buf + 2 * R * k * (a.cached ? per_block : 1);

  // columns of msg in [h, ms) are never written: zero them once
  for (int e = threadIdx.x; e < R * (ms - h); e += IT_THREADS)
    msg[(e / (ms - h)) * ms + h + e % (ms - h)] = 0.0f;
  if (WHOLE) {  // M, zero-padded to [HCT][HCT], once a launch
    load_m<VEC, HCT>(a.M, Ms, 0, HCT, 0, h);
    cp_async_commit();
    cp_async_wait<0>();
  }
  if (a.cached)  // s and col do not change from step to step
    for (long long item = first; item < last; ++item)
      load_rows<R>(a, rows_buf + (item - first) * 2 * R * k, item / col_tiles * R);
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < a.steps; ++t) {
    const float* x = state_in(a, t);
    float* y = state_out(a, t);
    for (long long item = first; item < last; ++item) {
      const long long row0 = (item / col_tiles) * R;
      const int c0 = (int)(item % col_tiles) * HCT;
      if (!WHOLE) {  // the first chunk of M loads under the message
        load_m<VEC, HCT>(a.M, Ms, 0, JC, c0, h);
        cp_async_commit();
      }
      float* sv = rows_buf + (a.cached ? (item - first) * 2 * R * k : 0);
      const int* cv = reinterpret_cast<const int*>(sv + R * k);
      if (!a.cached) {
        load_rows<R>(a, sv, row0);
        __syncthreads();
      }
      message<VEC, R>(x, a, sv, cv, msg, ms, row0);

      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[i][q] = 0.0f;
      if constexpr (WHOLE) {
        __syncthreads();  // msg visible
        apply<TM, TN, HCT>(acc, msg, ms, Ms, 0, hp, ty, tx);
      } else {
        for (int c = 0; c < jchunks; ++c) {
          if (c + 1 < jchunks) {
            load_m<VEC, HCT>(a.M, Ms + ((c + 1) & 1) * JC * HCT,
                             (c + 1) * JC, JC, c0, h);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();  // chunk c (and, at c = 0, msg) visible
          const int j0 = c * JC;
          const int jc = hp - j0 < JC ? hp - j0 : JC;
          apply<TM, TN, HCT>(acc, msg, ms, Ms + (c & 1) * JC * HCT, j0, jc,
                             ty, tx);
          __syncthreads();  // chunk c's buffer free for chunk c + 2
        }
      }

#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long m = row0 + ty * TM + i;
        if (m >= a.rows) continue;
#pragma unroll
        for (int q = 0; q < TN; q += 4) {
          const int c = c0 + tx * TN + q;
          const long long o = m * h + c;
          if constexpr (VEC == 4) {  // h % 4 == 0: all four in, or none
            if (c < h) {
              const float4 z4 =
                  __ldg(reinterpret_cast<const float4*>(a.zp + o));
              float4 r;
              r.x = __fadd_rn(z4.x, acc[i][q]);
              r.y = __fadd_rn(z4.y, acc[i][q + 1]);
              r.z = __fadd_rn(z4.z, acc[i][q + 2]);
              r.w = __fadd_rn(z4.w, acc[i][q + 3]);
              *reinterpret_cast<float4*>(y + o) = r;
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (c + u < h)
                y[o + u] = __fadd_rn(__ldg(a.zp + o + u), acc[i][q + u]);
          }
        }
      }
      if constexpr (WHOLE) __syncthreads();  // msg, s, col free again
    }
    if (t + 1 < a.steps) grid.sync();  // x_{t+1} complete before it is read
  }
}

template <int VEC, int R, int HCT, int TM, int TN, int JC, bool WHOLE>
static int launch(IterArgs a, cudaStream_t st) {
  auto kern = crf_iterate_kernel<VEC, R, HCT, TM, TN, JC, WHOLE>;
  static int sms = 0;
  // blocks an SM holds at the last few shared-memory sizes asked
  static size_t sizes[8];
  static int counts[8];
  static int used = 0;
  auto blocks_per_sm = [&](size_t bytes, int* per_sm) -> int {
    for (int i = 0; i < used; ++i)
      if (sizes[i] == bytes) return *per_sm = counts[i], 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kern, IT_THREADS, bytes);
    if (err != cudaSuccess) return (int)err;
    const int slot = used < 8 ? used++ : (int)(bytes / 16 % 8);
    sizes[slot] = bytes;
    counts[slot] = *per_sm;
    return 0;
  };
  cudaError_t e;
  if (sms == 0) {
    int dev;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    // as much shared memory as a block may take; what a launch asks for is
    // set below
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             IT_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
  }
  const long long items =
      ((a.rows + R - 1) / R) * ((a.h + HCT - 1) / HCT);
  size_t smem = smem_floats<R, HCT, JC, WHOLE>(a.h, a.k, 1) * sizeof(float);
  if (smem > IT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  int per_sm = 0, rc;
  if ((rc = blocks_per_sm(smem, &per_sm)) != 0) return rc;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  // keep every item's s and col in shared memory across the steps where
  // that leaves as many blocks on an SM
  const long long per_block = (items + grid - 1) / grid;
  const size_t cached =
      smem_floats<R, HCT, JC, WHOLE>(a.h, a.k, per_block) * sizeof(float);
  int per_sm_cached = 0;
  if (cached <= IT_SMEM_MAX &&
      (rc = blocks_per_sm(cached, &per_sm_cached)) != 0)
    return rc;
  a.cached = per_sm_cached >= per_sm;
  if (a.cached) smem = cached;
  void* params[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)kern, grid, IT_THREADS,
                                          params, smem, st);
}

// Rows per item and column tiles by width: M whole in shared memory up to
// H = 64; above, M streamed in 32-row chunks, with 128-column tiles of 32
// rows at H = 128 (256 items at ScanNet's 8192 rows) and items of 16 whole
// rows above (128 items at its 2048 rows of H = 256: on the H100 that beat
// 16 rows by two column tiles, whose messages are formed twice, by 8 %).
template <int VEC>
static int launch_for(const IterArgs& a, cudaStream_t st) {
  if (a.h <= 32) return launch<VEC, 64, 32, 2, 4, 32, true>(a, st);
  if (a.h <= 64) return launch<VEC, 64, 64, 4, 4, 64, true>(a, st);
  if (a.h <= 128) return launch<VEC, 32, 128, 4, 4, 32, false>(a, st);
  return launch<VEC, 16, 256, 4, 4, 32, false>(a, st);
}

// packed int64s: z, zp, s, col, M, xs (or 0), ping0, ping1, out, b, n, k,
// h, steps, stream. vec4: every state pointer 16-byte aligned, h % 4 == 0.
extern "C" int crf_iterate_f32(const char* packed) {
  long long v[16];
  memcpy(v, packed, sizeof v);
  IterArgs a;
  a.z = (const float*)v[0];
  a.zp = (const float*)v[1];
  a.s = (const float*)v[2];
  a.col = (const int*)v[3];
  a.M = (const float*)v[4];
  a.xs = (float*)v[5];
  a.ping0 = (float*)v[6];
  a.ping1 = (float*)v[7];
  a.out = (float*)v[8];
  const int b = (int)v[9];
  a.n = (int)v[10];
  a.k = (int)v[11];
  a.h = (int)v[12];
  a.steps = (int)v[13];
  const bool vec4 = v[15] != 0;
  a.rows = (long long)b * a.n;
  if (a.rows == 0 || a.h == 0 || a.steps == 0) return -1;  // nothing to launch
  cudaStream_t st = (cudaStream_t)v[14];
  return vec4 ? launch_for<4>(a, st) : launch_for<1>(a, st);
}
