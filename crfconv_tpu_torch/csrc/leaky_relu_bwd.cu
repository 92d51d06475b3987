// The gradient of the leaky ReLU with flax's value at 0:
//
//   dx = x >= 0 ? g : g * slope
//
// flax's nn.leaky_relu is where(x >= 0, x, slope * x), whose gradient at
// x == 0 is 1; torch's leaky_relu backward takes the slope there. This
// replaces no TPU kernel: it keeps the port's train step at one launch per
// activation while its gradient agrees with the JAX package's.
//
// Bound: bytes (x and g read once, dx written once). One thread per float4,
// scalar where a pointer is not 16-byte aligned and for the tail. g may be
// a slice of a wider tensor (the backward of a concatenation): its rows of
// F floats lie ld apart, and each element is then a scalar.
#include <cuda_runtime.h>

#include <cstdint>

constexpr int kThreads = 256;

__device__ __forceinline__ float grad(float x, float g, float slope) {
  return x >= 0.0f ? g : __fmul_rn(g, slope);
}

__global__ void __launch_bounds__(kThreads)
    leaky_relu_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ g, float* __restrict__ dx,
                          long long n, long long vecs, float slope) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < vecs) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x) + i);
    const float4 b = __ldg(reinterpret_cast<const float4*>(g) + i);
    reinterpret_cast<float4*>(dx)[i] =
        make_float4(grad(a.x, b.x, slope), grad(a.y, b.y, slope),
                    grad(a.z, b.z, slope), grad(a.w, b.w, slope));
  }
  if (i < n - 4 * vecs) {  // the scalar rest
    const long long e = 4 * vecs + i;
    dx[e] = grad(x[e], g[e], slope);
  }
}

__global__ void __launch_bounds__(kThreads)
    leaky_relu_bwd_rows_kernel(const float* __restrict__ x,
                               const float* __restrict__ g,
                               float* __restrict__ dx, long long n, int f,
                               long long ld, float slope) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const long long row = e / f;
  dx[e] = grad(x[e], g[row * ld + (e - row * f)], slope);
}

extern "C" int leaky_relu_bwd_f32(const void* x, const void* g, void* dx,
                                  long long rows, int f, long long ld,
                                  float slope, void* stream) {
  const long long n = rows * f;
  if (n == 0) return -1;  // nothing to launch
  if (ld != f) {
    leaky_relu_bwd_rows_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                                 kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)g, (float*)dx, n, f, ld, slope);
    return (int)cudaGetLastError();
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(dx)) % 16 == 0;
  const long long vecs = aligned ? n / 4 : 0;
  const long long threads = vecs > n - 4 * vecs ? vecs : n - 4 * vecs;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  leaky_relu_bwd_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (float*)dx, n, vecs, slope);
  return (int)cudaGetLastError();
}
