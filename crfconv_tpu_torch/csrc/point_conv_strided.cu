// K5: eval-mode strided point convolution with the residual rider, fused
// (point_conv.cuh).
//
// Replaces crfconv_tpu/ops/conv_pallas.py::point_conv_fused_strided
// (_kernel_conv_strided): the centers are the M coarse points sub_pos
// [B, M, 3], idx [B, M, K] indexes the N fine points through the bipartite
// window geometry (M output rows over N source rows), and the residual rider
// res [B, N, R] is max-pooled over the same neighbours into res_out
// [B, M, R]. The TPU kernel carries the rider as extra rows of its
// transposed VMEM window; here it is a second pass of the same block over
// its points, from L2.
//
// Bound: bytes. At Semantic3D's B16 x 65536 (conv2_1: H 16, M 16384,
// R 64) the rider dominates: res 268 MB read, x 67 MB, the outputs 84 MB.
#include "point_conv.cuh"

extern "C" int point_conv_strided_f32(const char* packed) {
  return point_conv_launch(packed, true);
}
