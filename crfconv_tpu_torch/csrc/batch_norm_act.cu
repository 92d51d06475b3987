// K16: an MLP's batch norm and the leaky ReLU after it, one pass each way.
//
//   z = (x - mean) * invstd * scale + bias,   y = z >= 0 ? z : z * slope
//
// x [rows, F] f32, channel-last and contiguous; the per-channel vectors [F].
// Training normalises with the batch's own mean and biased variance and
// updates the running statistics the flax way (ra = m * ra + (1 - m) * batch,
// the variance unbiased); eval normalises with the running statistics.
//
// This replaces no TPU kernel: the JAX package leaves the batch norm to XLA,
// which fuses it. In PyTorch's eager mode it was a chain of some fifteen
// elementwise and reduction kernels each way, ~150 bytes an element a train
// step. Here:
//
//   bn_stats_kernel + bn_stats_finalize_kernel   (train forward)
//   bn_apply_kernel                              (train and eval forward)
//   bn_bwd_reduce_kernel + bn_bwd_finalize_kernel + bn_bwd_apply_kernel
//
// read x once for the statistics and once for the output, and x and the
// output's gradient twice backward: 32 bytes an element a step, 8 in eval.
//
// Bound: bytes. Each thread owns one column of VEC channels (16-byte loads
// where F % 4 == 0 and the pointers are aligned) and walks rows a grid's
// height apart, four loads in flight: narrow F packs 256 / (F / VEC) rows
// into a block, wide F gives a block a strip of 256 columns. The per-channel
// vectors are read once a thread.
//
// Reductions are deterministic: a block reduces its rows in a fixed tree and
// writes one partial per channel to [chunks, F]; a finalize launch merges
// the chunks in a fixed order in double. The statistics are Welford's within
// a thread, Chan's across threads, and in the finalize the chunks' sums and
// their squared deviations from the global mean (no one-pass sum of squares,
// which cancels in float32). The backward recomputes z from x with the
// forward's own device function, so the activation's mask (flax's: slope
// below 0, 1 at 0 and above) agrees with the forward's bit for bit.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kFinCols = 8;  // channels of a finalize block

template <int VEC>
struct Frag {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Frag<VEC> load(const float* p) {
  Frag<VEC> f;
  if constexpr (VEC == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    f.v[0] = a.x;
    f.v[1] = a.y;
    f.v[2] = a.z;
    f.v[3] = a.w;
  } else {
    f.v[0] = __ldg(p);
  }
  return f;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Frag<VEC>& f) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
  } else {
    *p = f.v[0];
  }
}

// The normalised input, each operation rounded on its own as PyTorch's
// (x - mean) * invstd.
__device__ __forceinline__ float xhat(float x, float mean, float invstd) {
  return __fmul_rn(__fsub_rn(x, mean), invstd);
}

// The pre-activation z, forward and backward alike.
__device__ __forceinline__ float pre_act(float x, float mean, float invstd,
                                         float scale, float bias) {
  return __fadd_rn(__fmul_rn(xhat(x, mean, invstd), scale), bias);
}

__device__ __forceinline__ float act(float z, int leaky, float slope) {
  return (!leaky || z >= 0.0f) ? z : __fmul_rn(z, slope);
}

// flax's gradient: g where z >= 0 (0 included), g * slope below.
__device__ __forceinline__ float act_grad(float z, float g, int leaky,
                                          float slope) {
  return (!leaky || z >= 0.0f) ? g : __fmul_rn(g, slope);
}

__device__ __forceinline__ float inv_std(float var, float eps) {
  return __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
}

// A thread's place: its vector column (-1: idle), its row within a pass
// of the block, and the rows a pass covers.
struct Place {
  int col, r0, ry, s;
};

__device__ __forceinline__ Place place(int v) {
  Place p;
  p.s = v < kThreads ? v : kThreads;
  p.ry = kThreads / p.s;
  p.r0 = threadIdx.x / p.s;
  const int c = blockIdx.y * p.s + threadIdx.x % p.s;
  p.col = (p.r0 < p.ry && c < v) ? c : -1;
  return p;
}

// Welford's update of one thread's column by one row.
template <int VEC>
__device__ __forceinline__ void welford(float& n, float* mean, float* m2,
                                        const Frag<VEC>& a) {
  n += 1.0f;
  const float rn = __frcp_rn(n);
  for (int i = 0; i < VEC; ++i) {
    const float d = a.v[i] - mean[i];
    mean[i] += d * rn;
    m2[i] += d * (a.v[i] - mean[i]);
  }
}

// Chan's merge of (nb, mb, qb) into (n, m, q).
__device__ __forceinline__ void chan(float& n, float& m, float& q, float nb,
                                     float mb, float qb) {
  if (nb == 0.0f) return;
  const float nn = n + nb;
  const float d = mb - m;
  const float w = nb / nn;
  m += d * w;
  q += qb + d * d * n * w;
  n = nn;
}

// The partial statistics of a chunk of rows (blockIdx.x) for a strip of
// columns (blockIdx.y): part [3][chunks][f] holds each channel's count,
// mean and sum of squared deviations.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const float* __restrict__ x, float* __restrict__ part,
                    long long rows, int f) {
  const Place p = place(f / VEC);
  float n = 0.0f, mean[VEC], m2[VEC];
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.0f;
  if (p.col >= 0) {
    const long long step = (long long)gridDim.x * p.ry;
    const float* xc = x + (long long)p.col * VEC;
    long long r = (long long)blockIdx.x * p.ry + p.r0;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      Frag<VEC> a[kUnroll];
      for (int u = 0; u < kUnroll; ++u)
        a[u] = load<VEC>(xc + (r + u * step) * f);
      for (int u = 0; u < kUnroll; ++u) welford<VEC>(n, mean, m2, a[u]);
    }
    for (; r < rows; r += step)
      welford<VEC>(n, mean, m2, load<VEC>(xc + r * f));
  }
  __shared__ float sn[kThreads], sm[kThreads * VEC], sq[kThreads * VEC];
  const int t = threadIdx.x;
  sn[t] = n;
  for (int i = 0; i < VEC; ++i) {
    sm[t * VEC + i] = mean[i];
    sq[t * VEC + i] = m2[i];
  }
  // rows r0 and r0 + h of one column merge into r0, in a fixed tree
  for (int h = 1; h < p.ry; h *= 2) {
    __syncthreads();
    if (p.col >= 0 && p.r0 % (2 * h) == 0 && p.r0 + h < p.ry) {
      const int o = t + h * p.s;
      for (int i = 0; i < VEC; ++i) {
        float nc = n;
        chan(nc, mean[i], m2[i], sn[o], sm[o * VEC + i], sq[o * VEC + i]);
        sm[t * VEC + i] = mean[i];
        sq[t * VEC + i] = m2[i];
      }
      n += sn[o];
      sn[t] = n;
    }
  }
  if (p.col >= 0 && p.r0 == 0) {
    const long long chunks = gridDim.x;
    for (int i = 0; i < VEC; ++i) {
      const long long e = (long long)blockIdx.x * f + p.col * VEC + i;
      part[e] = n;
      part[chunks * f + e] = mean[i];
      part[2 * chunks * f + e] = m2[i];
    }
  }
}

// A finalize block's place: its channel (-1: idle) and its group of chunks.
struct FinPlace {
  int ch, grp, groups, cw;
};

__device__ __forceinline__ FinPlace fin_place(int f) {
  FinPlace p;
  p.cw = f < kFinCols ? f : kFinCols;
  p.groups = kThreads / p.cw;
  p.grp = threadIdx.x / p.cw;
  const int c = blockIdx.x * p.cw + threadIdx.x % p.cw;
  p.ch = (p.grp < p.groups && c < f) ? c : -1;
  return p;
}

// The sum of ``v`` over a finalize block's groups, in a fixed tree; every
// thread of a channel gets its total.
__device__ __forceinline__ double group_sum(double v, const FinPlace& p,
                                            double* s) {
  const int t = threadIdx.x;
  __syncthreads();
  s[t] = v;
  for (int h = 1; h < p.groups; h *= 2) {
    __syncthreads();
    if (p.ch >= 0 && p.grp % (2 * h) == 0 && p.grp + h < p.groups)
      s[t] += s[t + h * p.cw];
  }
  __syncthreads();
  return s[t % p.cw];
}

// Merges the chunks: count and mean, then the squared deviations of the
// chunks' means from the global mean; writes the batch's mean and invstd
// and updates the running statistics in place.
__global__ void __launch_bounds__(kThreads) bn_stats_finalize_kernel(
    const float* __restrict__ part, int chunks, int f, float* mean_out,
    float* invstd_out, float* run_mean, float* run_var, float eps,
    float keep, float take) {
  const FinPlace p = fin_place(f);
  __shared__ double s[kThreads];
  const float* pn = part;
  const float* pm = part + (long long)chunks * f;
  const float* pq = part + 2LL * chunks * f;
  double n = 0.0, sum = 0.0;
  if (p.ch >= 0) {
    for (int k = p.grp; k < chunks; k += p.groups) {
      const double nk = pn[(long long)k * f + p.ch];
      n += nk;
      sum += nk * pm[(long long)k * f + p.ch];
    }
  }
  n = group_sum(n, p, s);
  sum = group_sum(sum, p, s);
  const double mean = n > 0.0 ? sum / n : 0.0;
  double q = 0.0;
  if (p.ch >= 0) {
    for (int k = p.grp; k < chunks; k += p.groups) {
      const long long e = (long long)k * f + p.ch;
      const double d = pm[e] - mean;
      q += pq[e] + pn[e] * d * d;
    }
  }
  q = group_sum(q, p, s);
  if (p.ch < 0 || p.grp != 0) return;
  const double var = q / n;
  const double unbiased = var * n / (n > 1.0 ? n - 1.0 : 1.0);
  mean_out[p.ch] = (float)mean;
  invstd_out[p.ch] = (float)(1.0 / sqrt(var + (double)eps));
  run_mean[p.ch] = __fadd_rn(__fmul_rn(keep, run_mean[p.ch]),
                             __fmul_rn(take, (float)mean));
  run_var[p.ch] = __fadd_rn(__fmul_rn(keep, run_var[p.ch]),
                            __fmul_rn(take, (float)unbiased));
}

// y = act(z). ``s2`` is invstd, or the running variance where ``s2_is_var``.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float* __restrict__ mean,
                    const float* __restrict__ s2,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, long long rows, int f,
                    int s2_is_var, float eps, int leaky, float slope) {
  const Place p = place(f / VEC);
  if (p.col < 0) return;
  float m[VEC], is[VEC], sc[VEC], b[VEC];
  for (int i = 0; i < VEC; ++i) {
    const int ch = p.col * VEC + i;
    m[i] = mean[ch];
    is[i] = s2_is_var ? inv_std(s2[ch], eps) : s2[ch];
    sc[i] = scale[ch];
    b[i] = bias[ch];
  }
  const long long step = (long long)gridDim.x * p.ry;
  const long long off = (long long)p.col * VEC;
  long long r = (long long)blockIdx.x * p.ry + p.r0;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    Frag<VEC> a[kUnroll];
    for (int u = 0; u < kUnroll; ++u)
      a[u] = load<VEC>(x + (r + u * step) * f + off);
    for (int u = 0; u < kUnroll; ++u) {
      for (int i = 0; i < VEC; ++i)
        a[u].v[i] = act(pre_act(a[u].v[i], m[i], is[i], sc[i], b[i]), leaky,
                        slope);
      store<VEC>(y + (r + u * step) * f + off, a[u]);
    }
  }
  for (; r < rows; r += step) {
    Frag<VEC> a = load<VEC>(x + r * f + off);
    for (int i = 0; i < VEC; ++i)
      a.v[i] = act(pre_act(a.v[i], m[i], is[i], sc[i], b[i]), leaky, slope);
    store<VEC>(y + r * f + off, a);
  }
}

// The per-channel backward state of one thread's column.
template <int VEC>
struct Coeffs {
  float m[VEC], is[VEC], sc[VEC], b[VEC];
};

template <int VEC>
__device__ __forceinline__ Coeffs<VEC> coeffs_of(int col, const float* mean,
                                                 const float* invstd,
                                                 const float* scale,
                                                 const float* bias) {
  Coeffs<VEC> c;
  for (int i = 0; i < VEC; ++i) {
    const int ch = col * VEC + i;
    c.m[i] = mean[ch];
    c.is[i] = invstd[ch];
    c.sc[i] = scale[ch];
    c.b[i] = bias[ch];
  }
  return c;
}

// Partial sums of g' and g' * xhat over a chunk of rows: part [2][chunks][f].
// g's rows lie ldg floats apart.
template <int VEC>
__global__ void __launch_bounds__(kThreads) bn_bwd_reduce_kernel(
    const float* __restrict__ x, const float* __restrict__ g, long long ldg,
    float* __restrict__ part, long long rows, int f,
    const float* __restrict__ mean, const float* __restrict__ invstd,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int leaky, float slope) {
  const Place p = place(f / VEC);
  float sg[VEC], sgx[VEC];
  for (int i = 0; i < VEC; ++i) sg[i] = sgx[i] = 0.0f;
  if (p.col >= 0) {
    const Coeffs<VEC> c = coeffs_of<VEC>(p.col, mean, invstd, scale, bias);
    const long long step = (long long)gridDim.x * p.ry;
    const long long off = (long long)p.col * VEC;
    long long r = (long long)blockIdx.x * p.ry + p.r0;
    auto add = [&](const Frag<VEC>& a, const Frag<VEC>& d) {
      for (int i = 0; i < VEC; ++i) {
        const float z = pre_act(a.v[i], c.m[i], c.is[i], c.sc[i], c.b[i]);
        const float gp = act_grad(z, d.v[i], leaky, slope);
        sg[i] += gp;
        sgx[i] += gp * xhat(a.v[i], c.m[i], c.is[i]);
      }
    };
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      Frag<VEC> a[kUnroll], d[kUnroll];
      for (int u = 0; u < kUnroll; ++u) {
        a[u] = load<VEC>(x + (r + u * step) * f + off);
        d[u] = load<VEC>(g + (r + u * step) * ldg + off);
      }
      for (int u = 0; u < kUnroll; ++u) add(a[u], d[u]);
    }
    for (; r < rows; r += step)
      add(load<VEC>(x + r * f + off), load<VEC>(g + r * ldg + off));
  }
  __shared__ float s1[kThreads * VEC], s2[kThreads * VEC];
  const int t = threadIdx.x;
  for (int i = 0; i < VEC; ++i) {
    s1[t * VEC + i] = sg[i];
    s2[t * VEC + i] = sgx[i];
  }
  for (int h = 1; h < p.ry; h *= 2) {
    __syncthreads();
    if (p.col >= 0 && p.r0 % (2 * h) == 0 && p.r0 + h < p.ry) {
      const int o = (t + h * p.s) * VEC;
      for (int i = 0; i < VEC; ++i) {
        s1[t * VEC + i] = sg[i] += s1[o + i];
        s2[t * VEC + i] = sgx[i] += s2[o + i];
      }
    }
  }
  if (p.col >= 0 && p.r0 == 0) {
    const long long chunks = gridDim.x;
    for (int i = 0; i < VEC; ++i) {
      const long long e = (long long)blockIdx.x * f + p.col * VEC + i;
      part[e] = sg[i];
      part[chunks * f + e] = sgx[i];
    }
  }
}

// dbias = sum g', dscale = sum g' * xhat, the chunks added in a fixed order.
__global__ void __launch_bounds__(kThreads)
    bn_bwd_finalize_kernel(const float* __restrict__ part, int chunks, int f,
                           float* dscale, float* dbias) {
  const FinPlace p = fin_place(f);
  __shared__ double s[kThreads];
  double a = 0.0, b = 0.0;
  if (p.ch >= 0) {
    for (int k = p.grp; k < chunks; k += p.groups) {
      a += part[(long long)k * f + p.ch];
      b += part[((long long)chunks + k) * f + p.ch];
    }
  }
  a = group_sum(a, p, s);
  b = group_sum(b, p, s);
  if (p.ch < 0 || p.grp != 0) return;
  dbias[p.ch] = (float)a;
  dscale[p.ch] = (float)b;
}

// dx = scale * invstd * (g' - dbias / n - xhat * dscale / n) with batch
// statistics, scale * invstd * g' with running ones.
template <int VEC>
__global__ void __launch_bounds__(kThreads) bn_bwd_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ g, long long ldg,
    float* __restrict__ dx, long long rows, int f,
    const float* __restrict__ mean, const float* __restrict__ invstd,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ dscale, const float* __restrict__ dbias,
    int batch, int leaky, float slope) {
  const Place p = place(f / VEC);
  if (p.col < 0) return;
  const Coeffs<VEC> c = coeffs_of<VEC>(p.col, mean, invstd, scale, bias);
  float k[VEC], mb[VEC], ms[VEC];
  for (int i = 0; i < VEC; ++i) {
    const int ch = p.col * VEC + i;
    k[i] = __fmul_rn(c.sc[i], c.is[i]);
    mb[i] = batch ? (float)((double)dbias[ch] / (double)rows) : 0.0f;
    ms[i] = batch ? (float)((double)dscale[ch] / (double)rows) : 0.0f;
  }
  auto grad = [&](const Frag<VEC>& a, Frag<VEC>& d) {
    for (int i = 0; i < VEC; ++i) {
      const float z = pre_act(a.v[i], c.m[i], c.is[i], c.sc[i], c.b[i]);
      const float gp = act_grad(z, d.v[i], leaky, slope);
      const float xh = xhat(a.v[i], c.m[i], c.is[i]);
      d.v[i] = __fmul_rn(
          k[i], __fsub_rn(__fsub_rn(gp, mb[i]), __fmul_rn(xh, ms[i])));
    }
  };
  const long long step = (long long)gridDim.x * p.ry;
  const long long off = (long long)p.col * VEC;
  long long r = (long long)blockIdx.x * p.ry + p.r0;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    Frag<VEC> a[kUnroll], d[kUnroll];
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = load<VEC>(x + (r + u * step) * f + off);
      d[u] = load<VEC>(g + (r + u * step) * ldg + off);
    }
    for (int u = 0; u < kUnroll; ++u) {
      grad(a[u], d[u]);
      store<VEC>(dx + (r + u * step) * f + off, d[u]);
    }
  }
  for (; r < rows; r += step) {
    Frag<VEC> d = load<VEC>(g + r * ldg + off);
    grad(load<VEC>(x + r * f + off), d);
    store<VEC>(dx + r * f + off, d);
  }
}

bool aligned(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* q : ptrs) bits |= reinterpret_cast<uintptr_t>(q);
  return bits % 16 == 0;
}

// The grid of a pass over ``rows`` rows: its height (``chunks``, or at most
// ``blocks`` blocks in all) and its strips of columns.
dim3 grid_of(long long rows, int f, int vec, long long chunks, int blocks) {
  const int v = f / vec;
  const int s = v < kThreads ? v : kThreads;
  const int ry = kThreads / s;
  const int gy = (v + s - 1) / s;
  long long gx = chunks;
  if (gx <= 0) {
    gx = (rows + (long long)ry * kUnroll - 1) / ((long long)ry * kUnroll);
    const long long most = blocks / gy > 1 ? blocks / gy : 1;
    gx = gx < most ? gx : most;
  }
  return dim3((unsigned)gx, (unsigned)gy);
}

}  // namespace

// Arguments packed as int64s (pointers, sizes, flags, the stream), then
// doubles: python/struct's native layout of ops/batch_norm.py.
struct StatsArgs {
  long long x, part, chunks, rows, f, mean, invstd, run_mean, run_var, stream;
  double eps, keep, take;  // the running statistics: keep * ra + take * batch
};

struct ApplyArgs {
  long long x, y, mean, s2, scale, bias, rows, f, s2_is_var, leaky, blocks,
      stream;
  double eps, slope;
};

struct BwdArgs {
  long long x, g, ldg, dx, part, chunks, rows, f, mean, invstd, scale, bias,
      dscale, dbias, batch, leaky, blocks, stream;
  double slope;
};

extern "C" int batch_norm_stats_f32(const char* packed) {
  StatsArgs args;
  memcpy(&args, packed, sizeof args);
  const StatsArgs* a = &args;
  if (a->rows == 0 || a->f == 0) return -1;  // nothing to launch
  const float* x = (const float*)a->x;
  float* part = (float*)a->part;
  const int f = (int)a->f;
  const cudaStream_t st = (cudaStream_t)a->stream;
  const bool v4 = f % 4 == 0 && aligned({x});
  const dim3 grid = grid_of(a->rows, f, v4 ? 4 : 1, a->chunks, 0);
  if (v4)
    bn_stats_kernel<4><<<grid, kThreads, 0, st>>>(x, part, a->rows, f);
  else
    bn_stats_kernel<1><<<grid, kThreads, 0, st>>>(x, part, a->rows, f);
  bn_stats_finalize_kernel<<<(f + kFinCols - 1) / kFinCols, kThreads, 0, st>>>(
      part, (int)a->chunks, f, (float*)a->mean, (float*)a->invstd,
      (float*)a->run_mean, (float*)a->run_var, (float)a->eps,
      (float)a->keep, (float)a->take);
  return (int)cudaGetLastError();
}

extern "C" int batch_norm_apply_f32(const char* packed) {
  ApplyArgs args;
  memcpy(&args, packed, sizeof args);
  const ApplyArgs* a = &args;
  if (a->rows == 0 || a->f == 0) return -1;  // nothing to launch
  const float* x = (const float*)a->x;
  float* y = (float*)a->y;
  const int f = (int)a->f;
  const bool v4 = f % 4 == 0 && aligned({x, y});
  const dim3 grid = grid_of(a->rows, f, v4 ? 4 : 1, 0, (int)a->blocks);
  const cudaStream_t st = (cudaStream_t)a->stream;
  const float *mean = (const float*)a->mean, *s2 = (const float*)a->s2,
              *scale = (const float*)a->scale, *bias = (const float*)a->bias;
  if (v4)
    bn_apply_kernel<4><<<grid, kThreads, 0, st>>>(
        x, y, mean, s2, scale, bias, a->rows, f, (int)a->s2_is_var,
        (float)a->eps, (int)a->leaky, (float)a->slope);
  else
    bn_apply_kernel<1><<<grid, kThreads, 0, st>>>(
        x, y, mean, s2, scale, bias, a->rows, f, (int)a->s2_is_var,
        (float)a->eps, (int)a->leaky, (float)a->slope);
  return (int)cudaGetLastError();
}

extern "C" int batch_norm_bwd_f32(const char* packed) {
  BwdArgs args;
  memcpy(&args, packed, sizeof args);
  const BwdArgs* a = &args;
  if (a->rows == 0 || a->f == 0) return -1;  // nothing to launch
  const float* x = (const float*)a->x;
  const float* g = (const float*)a->g;
  float* dx = (float*)a->dx;
  float* part = (float*)a->part;
  const int f = (int)a->f;
  const cudaStream_t st = (cudaStream_t)a->stream;
  const float *mean = (const float*)a->mean, *invstd = (const float*)a->invstd,
              *scale = (const float*)a->scale, *bias = (const float*)a->bias;
  float *dscale = (float*)a->dscale, *dbias = (float*)a->dbias;
  const int leaky = (int)a->leaky;
  const float slope = (float)a->slope;
  const bool v4 = f % 4 == 0 && a->ldg % 4 == 0 && aligned({x, g, dx});
  const dim3 red = grid_of(a->rows, f, v4 ? 4 : 1, a->chunks, 0);
  if (v4)
    bn_bwd_reduce_kernel<4><<<red, kThreads, 0, st>>>(
        x, g, a->ldg, part, a->rows, f, mean, invstd, scale, bias, leaky,
        slope);
  else
    bn_bwd_reduce_kernel<1><<<red, kThreads, 0, st>>>(
        x, g, a->ldg, part, a->rows, f, mean, invstd, scale, bias, leaky,
        slope);
  bn_bwd_finalize_kernel<<<(f + kFinCols - 1) / kFinCols, kThreads, 0, st>>>(
      part, (int)a->chunks, f, dscale, dbias);
  const dim3 grid = grid_of(a->rows, f, v4 ? 4 : 1, 0, (int)a->blocks);
  if (v4)
    bn_bwd_apply_kernel<4><<<grid, kThreads, 0, st>>>(
        x, g, a->ldg, dx, a->rows, f, mean, invstd, scale, bias, dscale,
        dbias, (int)a->batch, leaky, slope);
  else
    bn_bwd_apply_kernel<1><<<grid, kThreads, 0, st>>>(
        x, g, a->ldg, dx, a->rows, f, mean, invstd, scale, bias, dscale,
        dbias, (int)a->batch, leaky, slope);
  return (int)cudaGetLastError();
}
