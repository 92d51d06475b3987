// K3: eval-mode same-scale point convolution, fused (point_conv.cuh).
//
// Replaces crfconv_tpu/ops/conv_pallas.py::point_conv_fused_infer
// (_kernel_conv): each point is its own center, idx [B, N, K] indexes the
// same N points, and there is no rider (the packed res and res_out are 0).
//
// Bound: operations at every width of the main path (the weight MLP's H x H
// product, 2 H^2 + 11 H + 3 flops a neighbour).
#include "point_conv.cuh"

extern "C" int point_conv_infer_f32(const char* packed) {
  return point_conv_launch(packed, false);
}
