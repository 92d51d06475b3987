// One warp's k smallest keys (k <= 32), shared by K6 (select_min_k.cu) and
// K2 (window_knn.cu).
//
// The warp keeps the k smallest keys offered so far sorted across its
// lanes (lane i holds the i-th, kMax where it holds none) and the k-th of
// them as the admission limit. Each offer gives one key per lane; a ballot
// finds the keys below the limit, and each of those is inserted in a few
// shuffles: its rank is a ballot's popcount and the keys above it move up
// one lane. The limit is the warp's true k-th smallest so far, so after
// the first k keys insertions are rare: about k (1 + ln(n / k)) over n
// keys, where a lane's own list of its k smallest would admit most keys
// while it fills. Keys must be distinct (a column in their low bits): the
// result is then the unique k smallest, in order.
#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace warp_select {

constexpr unsigned kAll = 0xFFFFFFFFu;

// The order-preserving int32 image of a float's bits: bits ^ 0x7FFFFFFF
// where the sign bit is set (-0.0 orders just below +0.0).
__device__ __forceinline__ int order_bits(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b < 0) ? 0x7FFFFFFF : 0);
}

template <typename T>
struct Max;
template <>
struct Max<int> {
  static constexpr int value = INT_MAX;
};
template <>
struct Max<long long> {
  static constexpr long long value = LLONG_MAX;
};

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T other = __shfl_xor_sync(kAll, v, off);
    v = other < v ? other : v;
  }
  return v;
}

template <typename T>
struct MinK {
  T kept = Max<T>::value;    // lane i: the i-th smallest key kept so far
  T limit = Max<T>::value;   // the k-th (lane k - 1's); only keys below it
                             // enter
  int k;
  int lane;

  __device__ MinK(int k_, int lane_) : k(k_), lane(lane_) {}

  // every lane offers one key (Max<T>::value offers nothing). A key
  // admitted below the limit that an earlier insertion of the same offer
  // pushed to rank k or above lands in a lane >= k (or none), which no
  // result reads, so the limit is taken again once per offer.
  __device__ __forceinline__ void offer(T key) {
    unsigned below = __ballot_sync(kAll, key < limit);
    if (!below) return;
    do {
      const int src = __ffs(below) - 1;
      below &= below - 1;
      const T x = __shfl_sync(kAll, key, src);
      const int rank = __popc(__ballot_sync(kAll, kept < x));
      const T up = __shfl_up_sync(kAll, kept, 1);
      kept = lane == rank ? x : (lane > rank ? up : kept);
    } while (below);
    limit = __shfl_sync(kAll, kept, k - 1);
  }
};

}  // namespace warp_select
