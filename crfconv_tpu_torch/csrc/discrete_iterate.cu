// K13: every mean-field step of one call of the discrete CRF
// (CRF-as-RNN),
//
//   msg_t[m,:]   = sum_k w[m,k] * q_t[col[m,k],:]
//   q_{t+1}[m,:] = softmax(-u[m,:] - msg_t[m,:] C)
//
// for t = 0 .. steps-1 from q_0 = p. p, u, q_t [B,N,L]; w [B,N,K] (masked
// slots already zero); col [B,N,K] int32 (K9's clamped columns, -1 = reads
// zero); C [L,L]; all f32 but col. Step t writes q_{t+1} into qs[t+1] when
// the caller saves the stack (qs [steps,B,N,L], qs[0] = p), else into one
// of two ping-pong buffers, and the last step into out; msgs [steps,B,N,L],
// when not null, receives every msg_t (the residuals of the backward). A
// step never writes the state it reads. One step (steps = 1) is the
// one-step entry point.
//
// Replaces crfconv_tpu/ops/crf_pallas.py::_run_discrete_core
// (_iterate_discrete_kernel, _iterate_discrete_stack_kernel), which runs
// every step in one pallas_call with q transposed in VMEM and hi/lo bf16
// band blocks on the MXU. Here too one launch runs every step: a
// persistent cooperative grid (as many blocks as are resident at once)
// walks its items of a step, then waits at a grid barrier before the next
// step reads what this one wrote.
//
// An item is R = 128 rows of one cloud; a block takes a run of consecutive
// items. Per item and step:
//  1. staging (cp.async): the item's w and col rows, and q_t's rows from
//     the least to the greatest of the item's columns (K9 clamped every
//     column into its tile's window, so that span is at most R - TILE +
//     the window's width, `cap`); each span is found once a launch. An
//     item whose span exceeds cap gathers from global memory instead;
//  2. message: a thread owns (row, 4 classes) as a float4 where L % 4 == 0
//     (else (row, 1, 2 or 4 classes)), so the G = L / 4 lanes of a row sit
//     in one warp (five at L = 20, six rows a warp); it issues 8 slots'
//     gathers from shared memory before it adds any, k ascending;
//  3. apply and softmax: the row's message goes through shared memory to
//     its lanes; z = -u - msg C with j ascending over C in shared memory
//     (held for the whole launch); the row maximum and the sum of the
//     exponentials in class order from +0.0 pass along the row's lanes by
//     shuffles, and each lane divides its classes by the sum.
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no
// FMA) in the plain version's order, so msg_t is bit-equal to the plain
// version on the same q_t, and q_{t+1} too wherever expf rounds as
// torch.exp does.
//
// Bound: operations at the discrete net's shape. A step moves p or q_t, u,
// w, col and q_{t+1} (plus msg_t and the stack when saved) and does
// 2 K L + 2 L^2 + ~5 L operations a row; the fused call's bound counts
// the inputs once and every step's operations. At B16 x 8192, L = 20,
// K = 31, 10 steps: 64 MB and 2.8 GFLOP, 0.042 ms on 67 TFLOP/s (the ten
// one-step bounds sum to 0.19 ms, bytes).
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <string.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

constexpr int DI_THREADS = 256;
constexpr int DI_WARPS = DI_THREADS / 32;
constexpr int DI_UNROLL = 8;          // slots whose gathers are issued together
constexpr int DI_MAX_L = 128;         // classes a row may have
// dynamic shared memory a block may use, beside its 16 static bytes
constexpr int DI_SMEM_MAX = 231424;

struct DiArgs {
  const float* p;     // q_0
  const float* u;
  const float* w;
  const int* col;
  const float* C;
  float* qs;          // [steps, rows, L] or null
  float* msgs;        // [steps, rows, L] or null
  float* ping0;       // the two ping-pong states when qs is null
  float* ping1;
  float* out;         // q_steps
  long long rows;
  int n, k, L, steps;
  int R;              // rows of an item
  int cap;            // rows of q_t an item may stage (0: none)
  int per_block;      // items a block takes
};

__device__ __forceinline__ const float* state_in(const DiArgs& a, int t) {
  if (t == 0) return a.p;
  if (a.qs) return a.qs + (long long)t * a.rows * a.L;
  return (t - 1) % 2 ? a.ping1 : a.ping0;
}

__device__ __forceinline__ float* state_out(const DiArgs& a, int t) {
  if (t == a.steps - 1) return a.out;
  if (a.qs) return a.qs + (long long)(t + 1) * a.rows * a.L;
  return t % 2 ? a.ping1 : a.ping0;
}

__host__ __device__ inline int align4(int v) { return (v + 3) / 4 * 4; }

// Shared memory, in floats: C [L][L], the items' spans (2 ints each), w and
// col of one item [R][k] each, the message rows of a pass, q_t's window.
__host__ __device__ inline size_t di_smem_floats(int L, int k, int R,
                                                 int per_block,
                                                 int rows_per_pass, int cap) {
  return (size_t)align4(L * L) + align4(2 * per_block) +
         2 * (size_t)align4(R * k) + (size_t)rows_per_pass * L +
         (size_t)cap * L;
}

// The CPT classes [c, c + CPT) of row `src` of x (zero beyond L).
template <int CPT, bool VEC4>
__device__ __forceinline__ void load_classes(float (&v)[CPT], const float* x,
                                             long long src, int L, int c) {
  const float* r = x + src * L + c;
  if constexpr (VEC4) {
    const float4 t4 = *reinterpret_cast<const float4*>(r);
    v[0] = t4.x;
    v[1] = t4.y;
    v[2] = t4.z;
    v[3] = t4.w;
  } else {
#pragma unroll
    for (int q = 0; q < CPT; ++q) v[q] = c + q < L ? r[q] : 0.0f;
  }
}

template <int CPT, bool VEC4>
__device__ __forceinline__ void store_classes(float* x, long long dst, int L,
                                              int c, const float (&v)[CPT]) {
  float* r = x + dst * L + c;
  if constexpr (VEC4) {
    *reinterpret_cast<float4*>(r) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      if (c + q < L) r[q] = v[q];
  }
}

// acc = sum_k w[r,k] x[col[r,k] - off, c : c + CPT], k ascending, each
// product and sum rounded; xs is q_t's window (off = its first row) or the
// cloud's rows (off = 0). wr, cr: the row's w and col in shared memory.
template <int CPT, bool VEC4>
__device__ __forceinline__ void message(float (&acc)[CPT], const float* xs,
                                        int off, const float* wr,
                                        const int* cr, int k, int L, int c) {
#pragma unroll
  for (int q = 0; q < CPT; ++q) acc[q] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += DI_UNROLL) {
    float v[DI_UNROLL][CPT];
    int j[DI_UNROLL];
#pragma unroll
    for (int s = 0; s < DI_UNROLL; ++s) {
      j[s] = k0 + s < k ? cr[k0 + s] : -1;
      if (j[s] >= 0) load_classes<CPT, VEC4>(v[s], xs, j[s] - off, L, c);
    }
#pragma unroll
    for (int s = 0; s < DI_UNROLL; ++s) {
      if (j[s] >= 0) {
        const float wv = wr[k0 + s];
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(wv, v[s][q]));
      }
    }
  }
}

// Rows of one cloud [r0, r0 + nr) of item `it`; the item's first global row.
__device__ __forceinline__ void item_rows(const DiArgs& a, long long it,
                                          long long* row0, int* nr,
                                          int* cloud) {
  const int per_cloud = (a.n + a.R - 1) / a.R;
  const int b = (int)(it / per_cloud);
  const int r0 = (int)(it % per_cloud) * a.R;
  *cloud = b;
  *nr = min(a.R, a.n - r0);
  *row0 = (long long)b * a.n + r0;
}

template <int CPT, bool VEC4>
__global__ void __launch_bounds__(DI_THREADS, 2)
discrete_iterate_kernel(const DiArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int lo_s, hi_s;
  const int L = a.L, k = a.k;
  const int G = (L + CPT - 1) / CPT;  // lanes of a row (<= 32)
  const int rpw = 32 / G;             // rows of a warp
  const int rpp = DI_WARPS * rpw;     // rows of a pass
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rw = lane / G;            // the lane's row in its warp
  const bool lane_live = rw < rpw;
  const int g = lane_live ? lane % G : 0;
  const int base = lane_live ? rw * G : 0;  // the row's first lane
  const int c = g * CPT;                    // the lane's first class

  float* Cs = smem;
  int* span = reinterpret_cast<int*>(Cs + align4(L * L));  // lo, n an item
  float* wv = reinterpret_cast<float*>(span + align4(2 * a.per_block));
  int* cv = reinterpret_cast<int*>(wv + align4(a.R * k));
  float* mb = reinterpret_cast<float*>(cv + align4(a.R * k));
  float* win = mb + rpp * L;

  const long long items =
      (long long)(a.rows / a.n) * ((a.n + a.R - 1) / a.R);
  const long long first = (long long)blockIdx.x * a.per_block;
  const long long last = min(items, first + a.per_block);

  for (int e = threadIdx.x; e < L * L; e += DI_THREADS) Cs[e] = a.C[e];
  // each item's span of columns, once: q_t's rows [lo, lo + n) it stages,
  // n = -1 where the span exceeds cap (the item gathers from global)
  for (long long it = first; it < last; ++it) {
    long long row0;
    int nr, b;
    item_rows(a, it, &row0, &nr, &b);
    if (threadIdx.x == 0) {
      lo_s = INT_MAX;
      hi_s = -1;
    }
    __syncthreads();
    int lo = INT_MAX, hi = -1;
    for (int e = threadIdx.x; e < nr * k; e += DI_THREADS) {
      const int cj = a.col[row0 * k + e];
      if (cj >= 0) {
        lo = min(lo, cj);
        hi = max(hi, cj);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0 && hi >= 0) {
      atomicMin(&lo_s, lo);
      atomicMax(&hi_s, hi);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int ns = hi_s < 0 ? 0 : hi_s - lo_s + 1;
      span[2 * (it - first)] = hi_s < 0 ? 0 : lo_s;
      span[2 * (it - first) + 1] = ns <= a.cap ? ns : -1;
    }
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const long long plane = a.rows * L;
  for (int t = 0; t < a.steps; ++t) {
    const float* x = state_in(a, t);
    float* y = state_out(a, t);
    float* mt = a.msgs ? a.msgs + t * plane : nullptr;
    for (long long it = first; it < last; ++it) {
      long long row0;
      int nr, b;
      item_rows(a, it, &row0, &nr, &b);
      const int lo = span[2 * (it - first)];
      const int ns = span[2 * (it - first) + 1];
      const float* xb = x + (long long)b * a.n * L;  // the cloud's q_t
      // stage w, col and q_t's window
      for (int e = threadIdx.x; e < nr * k; e += DI_THREADS) {
        cp_async4(wv + e, a.w + row0 * k + e, 4);
        cp_async4(cv + e, a.col + row0 * k + e, 4);
      }
      if (ns > 0) {
        const float* src = xb + (long long)lo * L;
        if constexpr (VEC4) {
          for (int e = threadIdx.x; e < ns * L / 4; e += DI_THREADS)
            cp_async16(win + 4 * e, src + 4 * e, 16);
        } else {
          for (int e = threadIdx.x; e < ns * L; e += DI_THREADS)
            cp_async4(win + e, src + e, 4);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      for (int p0 = 0; p0 < nr; p0 += rpp) {
        const int r = p0 + warp * rpw + rw;
        const bool live = lane_live && r < nr;
        const long long m = row0 + r;
        float acc[CPT], uv[CPT];
#pragma unroll
        for (int q = 0; q < CPT; ++q) acc[q] = uv[q] = 0.0f;
        if (live) load_classes<CPT, VEC4>(uv, a.u, m, L, c);  // u early
        if (live) {
          if (ns > 0)  // from the window in shared memory
            message<CPT, VEC4>(acc, win, lo, wv + r * k, cv + r * k, k, L, c);
          else         // from global memory (or no column at all)
            message<CPT, VEC4>(acc, xb, 0, wv + r * k, cv + r * k, k, L, c);
          if (mt) store_classes<CPT, VEC4>(mt, m, L, c, acc);
        }
        // the row's message to all its lanes
        float* mr = mb + (warp * rpw + (lane_live ? rw : 0)) * L;
        if (live) store_classes<CPT, VEC4>(mr, 0, L, c, acc);
        __syncwarp();
        float z[CPT];
#pragma unroll
        for (int q = 0; q < CPT; ++q) z[q] = 0.0f;
        if (live) {
          if constexpr (VEC4) {
            for (int j = 0; j < L; j += 4) {
              const float4 a4 = *reinterpret_cast<const float4*>(mr + j);
              const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                const float4 c4 =
                    *reinterpret_cast<const float4*>(Cs + (j + s) * L + c);
                z[0] = __fadd_rn(z[0], __fmul_rn(av[s], c4.x));
                z[1] = __fadd_rn(z[1], __fmul_rn(av[s], c4.y));
                z[2] = __fadd_rn(z[2], __fmul_rn(av[s], c4.z));
                z[3] = __fadd_rn(z[3], __fmul_rn(av[s], c4.w));
              }
            }
          } else {
            for (int j = 0; j < L; ++j) {
              const float aj = mr[j];
#pragma unroll
              for (int q = 0; q < CPT; ++q)
                if (c + q < L)
                  z[q] = __fadd_rn(z[q], __fmul_rn(aj, Cs[j * L + c + q]));
            }
          }
#pragma unroll
          for (int q = 0; q < CPT; ++q) z[q] = __fsub_rn(-uv[q], z[q]);
        }
        // the row maximum over its lanes
        float mx = -INFINITY;
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          if (c + q < L) mx = fmaxf(mx, z[q]);
        float rmx = -INFINITY;
        for (int s = 0; s < G; ++s)
          rmx = fmaxf(rmx, __shfl_sync(0xffffffffu, mx, base + s));
        float e[CPT];
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          e[q] = c + q < L ? expf(__fsub_rn(z[q], rmx)) : 0.0f;
        // the sum of the exponentials in class order from +0.0: lane s of
        // the row adds its classes to the sum of lanes 0 .. s-1
        float sum = 0.0f;
        for (int s = 0; s < G; ++s) {
          float part = sum;
          if (g == s) {
#pragma unroll
            for (int q = 0; q < CPT; ++q)
              if (c + q < L) part = __fadd_rn(part, e[q]);
          }
          sum = __shfl_sync(0xffffffffu, part, base + s);
        }
        if (live) {
          float o[CPT];
#pragma unroll
          for (int q = 0; q < CPT; ++q) o[q] = __fdiv_rn(e[q], sum);
          store_classes<CPT, VEC4>(y, m, L, c, o);
        }
        __syncwarp();  // mr is the next pass's
      }
      __syncthreads();  // w, col and the window free for the next item
    }
    if (t + 1 < a.steps) grid.sync();  // q_{t+1} complete before it is read
  }
}

template <int CPT, bool VEC4>
static int launch(DiArgs a, cudaStream_t st) {
  auto kern = discrete_iterate_kernel<CPT, VEC4>;
  static int sms = 0;
  static size_t sizes[8];  // blocks an SM holds at the last sizes asked
  static int counts[8];
  static int used = 0;
  auto blocks_per_sm = [&](size_t bytes, int* per_sm) -> int {
    for (int i = 0; i < used; ++i)
      if (sizes[i] == bytes) return *per_sm = counts[i], 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kern, DI_THREADS, bytes);
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
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DI_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
  }
  const int G = (a.L + CPT - 1) / CPT;
  const int rpp = DI_WARPS * (32 / G);
  const long long items =
      (a.rows / a.n) * (long long)((a.n + a.R - 1) / a.R);
  auto bytes = [&](int per_block) {
    return di_smem_floats(a.L, a.k, a.R, per_block, rpp, a.cap) *
           sizeof(float);
  };
  if (bytes(1) > DI_SMEM_MAX) a.cap = 0;  // no room for the window
  // the grid and the items a block takes depend on each other through the
  // shared memory of the items' spans: grow per_block until they agree
  int per_block = 1, per_sm = 0, rc;
  unsigned grid = 0;
  for (;;) {
    const size_t smem = bytes(per_block);
    if (smem > DI_SMEM_MAX) return (int)cudaErrorInvalidValue;
    if ((rc = blocks_per_sm(smem, &per_sm)) != 0) return rc;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    const long long resident = (long long)per_sm * sms;
    grid = (unsigned)(items < resident ? items : resident);
    const int need = (int)((items + grid - 1) / grid);
    if (need <= per_block) break;
    per_block = need;
  }
  a.per_block = per_block;
  void* params[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel((const void*)kern, grid, DI_THREADS,
                                          params, bytes(per_block), st);
}

// packed int64s: p, u, w, col, C, qs (or 0), msgs (or 0), ping0, ping1,
// out, b, n, k, L, steps, R, cap, vec4, stream. vec4: L % 4 == 0 and every
// state pointer 16-byte aligned.
extern "C" int discrete_iterate_f32(const char* packed) {
  long long v[19];
  memcpy(v, packed, sizeof v);
  DiArgs a;
  a.p = (const float*)v[0];
  a.u = (const float*)v[1];
  a.w = (const float*)v[2];
  a.col = (const int*)v[3];
  a.C = (const float*)v[4];
  a.qs = (float*)v[5];
  a.msgs = (float*)v[6];
  a.ping0 = (float*)v[7];
  a.ping1 = (float*)v[8];
  a.out = (float*)v[9];
  const int b = (int)v[10];
  a.n = (int)v[11];
  a.k = (int)v[12];
  a.L = (int)v[13];
  a.steps = (int)v[14];
  a.R = (int)v[15];
  a.cap = (int)v[16];
  const bool vec4 = v[17] != 0;
  a.per_block = 1;
  a.rows = (long long)b * a.n;
  if (a.rows == 0 || a.L == 0 || a.steps == 0) return -1;  // nothing to launch
  if (a.L > DI_MAX_L || a.R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)v[18];
  if (vec4) return launch<4, true>(a, st);
  if (a.L <= 32) return launch<1, false>(a, st);
  if (a.L <= 64) return launch<2, false>(a, st);
  return launch<4, false>(a, st);
}
