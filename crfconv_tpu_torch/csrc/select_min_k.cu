// K6: the k smallest entries of each row of a distance block, ascending,
//
//   d [R, width] f32 (contiguous) -> idx [R, k] int32.
//
// Replaces crfconv_tpu/ops/windowed_pallas.py::select_min_k
// (_select_k_kernel, _select_k_packed_kernel). The TPU kernel runs k
// passes of (row min -> lowest column among ties -> mask) over a VMEM
// block. Here the order is a total order on distinct keys:
//
//   o(x)   = bits(x) ^ (bits(x) < 0 ? 0x7FFFFFFF : 0)   (order-preserving)
//   exact  : the 64-bit key (o << 32) | col
//   packed : the 32-bit key (o & -1024) | col           (width <= 1024)
//
// so the k smallest keys are lax.top_k(-d, k)[1] exactly: -0.0 orders
// before +0.0, ties go to the lowest column, and no index repeats, even in
// a row with fewer than k finite entries. (The TPU kernel's exact body
// masks with +inf, so it repeats an index in such a row, and it ties -0.0
// with +0.0; its packed body agrees with this order.) The plain version,
// torch.topk over the same keys, gives the same indices bit for bit.
//
// Design, k <= 32: one warp a row, and the warp keeps the k smallest keys
// seen so far sorted across its lanes (warp_select.cuh, shared with K2).
// The lanes read the row once, coalesced, four floats a load where
// width % 4 == 0 and the block starts on 16 bytes; each step every lane
// offers one key, a ballot admits the keys below the k-th kept one, and
// each is inserted in a few shuffles: about k (1 + ln(width / k))
// insertions a row. The result is the first k lanes, already in order. Other k take the generic path: k rounds, each a pass
// over the row for the least key above the previous pick.
//
// Bound: bytes (d read once, idx written once). At B8 x 8192 the flagship
// pyramid's blocks are 2.86 GB a request, 0.855 ms on 3.35 TB/s.
#include <cstdint>

#include <cuda_runtime.h>

#include "warp_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using warp_select::order_bits;
using warp_select::warp_min;

template <bool kExact>
struct Key;

template <>
struct Key<true> {
  using T = long long;
  static constexpr T kMax = LLONG_MAX;
  __device__ static T make(float x, int col) {
    return (T)(((unsigned long long)(unsigned)order_bits(x) << 32) |
               (unsigned)col);
  }
  __device__ static int col(T key) { return (int)(key & 0xFFFFFFFFLL); }
};

template <>
struct Key<false> {
  using T = int;
  static constexpr T kMax = INT_MAX;
  __device__ static T make(float x, int col) {
    return (order_bits(x) & -1024) | col;
  }
  __device__ static int col(T key) { return key & 1023; }
};

template <bool kExact>
__global__ void __launch_bounds__(kThreads)
select_min_k_kernel(const float* __restrict__ d, int* __restrict__ out,
                    long long rows, int width, int k) {
  using K = Key<kExact>;
  using T = typename K::T;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;   // the warp's lanes exit together
  const float* dr = d + row * width;
  int* orow = out + row * k;

  if (k > 32) {
    // k passes, each the least key above the previous pick (a row's keys
    // are distinct, so no pick repeats; the first pass has no pick below)
    T prev = K::kMax;
    for (int sel = 0; sel < k; ++sel) {
      T best = K::kMax;
      for (int c = lane; c < width; c += 32) {
        const T key = K::make(__ldg(dr + c), c);
        if ((sel == 0 || key > prev) && key < best) best = key;
      }
      prev = warp_min(best);
      if (lane == 0) orow[sel] = K::col(prev);
    }
    return;
  }

  warp_select::MinK<T> top(k, lane);
  auto offer = [&](T key) { top.offer(key); };
  auto offer4 = [&](float4 v, int col, bool in) {
    offer(in ? K::make(v.x, col) : K::kMax);
    offer(in ? K::make(v.y, col + 1) : K::kMax);
    offer(in ? K::make(v.z, col + 2) : K::kMax);
    offer(in ? K::make(v.w, col + 3) : K::kMax);
  };
  if ((width & 3) == 0 && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    const float4* d4 = reinterpret_cast<const float4*>(dr);
    const int w4 = width >> 2;
    const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = 0; base < w4; base += 64) {   // two loads in flight
      const int c0 = base + lane, c1 = c0 + 32;
      const float4 a = c0 < w4 ? __ldcs(d4 + c0) : none;
      const float4 b = c1 < w4 ? __ldcs(d4 + c1) : none;
      offer4(a, 4 * c0, c0 < w4);
      offer4(b, 4 * c1, c1 < w4);
    }
  } else {
    for (int base = 0; base < width; base += 32) {
      const int c = base + lane;
      offer(c < width ? K::make(__ldcs(dr + c), c) : K::kMax);
    }
  }
  if (lane < k) orow[lane] = K::col(top.kept);
}

template <bool kExact>
int launch(const float* d, int* out, long long rows, int width, int k,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  select_min_k_kernel<kExact><<<grid, kThreads, 0, stream>>>(d, out, rows,
                                                             width, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int select_min_k_f32(const void* d, void* out, long long rows,
                                int width, int k, int exact, void* stream) {
  if (rows == 0 || k == 0) return -1;  // nothing to launch
  if (k > width || (!exact && width > 1024)) return (int)cudaErrorInvalidValue;
  return exact ? launch<true>((const float*)d, (int*)out, rows, width, k,
                              (cudaStream_t)stream)
               : launch<false>((const float*)d, (int*)out, rows, width, k,
                               (cudaStream_t)stream);
}
