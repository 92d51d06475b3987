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
// its points.
//
// Bound: bytes. At Semantic3D's B16 x 65536 (conv2_1: H 16, M 16384,
// R 64) the rider dominates: res 268 MB read, x 67 MB, the outputs 84 MB.
#include "point_conv.cuh"

extern "C" int point_conv_strided_f32(
    const void* x, const void* pos, const void* sub_pos, const void* idx,
    const void* starts, const void* w0, const void* a0, const void* c0,
    const void* w1, const void* a1, const void* c1, const void* res,
    void* out, void* res_out, int b, int n, int m, int k, int h, int r,
    int tile, int width, int front, float slope, void* stream) {
  if (r == 0) return (int)cudaErrorInvalidValue;
  return point_conv_launch(x, pos, sub_pos, idx, starts, w0, a0, c0, w1, a1,
                           c1, res, out, res_out, b, n, m, k, h, r, tile,
                           width, front, slope, stream);
}
