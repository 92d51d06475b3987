// K3: eval-mode same-scale point convolution, fused (point_conv.cuh).
//
// Replaces crfconv_tpu/ops/conv_pallas.py::point_conv_fused_infer
// (_kernel_conv): each point is its own center, idx [B, N, K] indexes the
// same N points, and there is no rider.
#include "point_conv.cuh"

extern "C" int point_conv_infer_f32(const void* x, const void* pos,
                                    const void* idx, const void* starts,
                                    const void* w0, const void* a0,
                                    const void* c0, const void* w1,
                                    const void* a1, const void* c1, void* out,
                                    int b, int n, int k, int h, int tile,
                                    int width, int front, float slope,
                                    void* stream) {
  return point_conv_launch(x, pos, pos, idx, starts, w0, a0, c0, w1, a1, c1,
                           nullptr, out, nullptr, b, n, n, k, h, 0, tile,
                           width, front, slope, stream);
}
