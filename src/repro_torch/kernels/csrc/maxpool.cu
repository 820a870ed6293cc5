// VALID max-pool over NHWC, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maxpool.py::_maxpool_kernel
// (maxpool.py:19). It computes the same function: x (N,H,W,C) ->
// (N,OH,OW,C), OH = (H - window) // stride + 1, square window and stride,
// each output the largest of its window compared in fp32, stored in x's
// type (exactly one of the inputs, so the cast back is exact). A NaN in a
// window gives NaN, as jnp.maximum does: the comparison keeps NaN where
// fmaxf would drop it.
//
// Layout: one thread per output element, C fastest, so a warp's loads of
// one tap are consecutive channels of one pixel and coalesce. The window is
// walked in order, like the chip's sequential comparison lanes.
//
// What bounds it on this card: bytes (one comparison per input element
// read). The least time is the input read once plus the output written
// once, over 3.35 TB/s. What the design does about that: coalesced loads;
// overlapping windows (stride < window) re-read their shared rows, mostly
// from L2.
#include <cuda_runtime.h>
#include <math.h>

#include "cvt.cuh"

namespace {

using cvt::from_f32;
using cvt::to_f32;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int OH,
                   int OW, int window, int stride, long total) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int c = i % C;
  long t = i / C;
  const int ow = t % OW;
  t /= OW;
  const int oh = t % OH;
  const long n = t / OH;
  const T* base = x + ((n * H + (long)oh * stride) * W + (long)ow * stride) * C + c;
  float m = -INFINITY;
  for (int kh = 0; kh < window; ++kh)
    for (int kw = 0; kw < window; ++kw) {
      const float v = to_f32(base[((long)kh * W + kw) * C]);
      m = (v > m || v != v) ? v : m;  // a NaN, once taken, is never replaced
    }
  out[i] = from_f32<T>(m);
}

template <typename T>
int launch(const void* x, void* out, int N, int H, int W, int C, int OH, int OW, int window,
           int stride, cudaStream_t s) {
  const long total = (long)N * OH * OW * C;
  const long blocks = (total + kThreads - 1) / kThreads;
  maxpool_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, C, OH, OW, window, stride, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int maxpool_launch(const void* x, void* out, int N, int H, int W, int C, int OH, int OW,
                              int window, int stride, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, N, H, W, C, OH, OW, window, stride, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, N, H, W, C, OH, OW, window, stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
