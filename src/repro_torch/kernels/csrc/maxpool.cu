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
// What bounds it on this card: the bytes bound, the input read once and
// the output written once over 3.35 TB/s, is 1.2 us in fp32 and 0.6 us in
// bf16 at the ResNet-50 stem's 1x112x112x64, 3x3/2. The first port (one
// thread per output element, 64-bit index math, the window in a loop with
// runtime bounds) took 5.8 us in both types: instructions and latency set
// its time, not bytes.
//
// The design: one thread per output element, C fastest, so a warp's loads
// of one tap are consecutive channels of one pixel and coalesce.
// - 32-bit index math on a 3-D grid: (channel, output column) in x, the
//   output row in y, the image in z (each stepping on past its grid). The
//   one division splits x into channel and column. An input row of 2^31
//   elements or more (W * C) runs the same kernel with 64-bit indices.
// - (window, stride) as template parameters for 2/2, 3/2 and 3/3: the
//   loops unroll and every load of a thread is issued before the
//   comparisons. Any other window runs the same kernel's runtime loop.
// - The window is walked row by row, like the chip's sequential comparison
//   lanes, compared in fp32; a NaN, once taken, stays.
//
// What it reaches (launch/mha_pool_probe.py; device ms of a bare launch,
// inputs and outputs cycled past the L2 cache; H100 80GB HBM3, 700 W): the
// stem's pool at batch 1 takes 0.0032 fp32 and 0.0028 bf16 on 1,513 CTAs
// of 128 threads. An empty kernel on that grid takes 0.0017, and half the
// bytes (bf16) save little, so the launch of ~190,000 threads and one
// round trip to memory set the time, not the bytes (bound 0.0012 and
// 0.0006). At batch 8: 0.0128 fp32 (74% of its 0.0095 bound), 0.0115 bf16.
// Tried on the card and not kept (the same probe and run; the variants are
// csrc/maxpool_probe.cu's), batch 1 / batch 8:
// - 16-byte vectors (4 fp32, 8 bf16 channels a thread): fp32 0.0035 /
//   0.0131, bf16 0.0055 / 0.0115: too few threads at batch 1, no gain at 8;
// - strips of 2 outputs a thread sharing their overlapped column: in
//   vectors fp32 0.0041 / 0.0134, bf16 0.0078 / 0.0113; at element width
//   fp32 0.0052 / 0.0162, bf16 0.0049 / 0.0140;
// - the window taken column by column (each column's maximum over the rows
//   in registers, then across the columns), element width: fp32 0.0033 /
//   0.0151, bf16 0.0032 / 0.0146;
// - this kernel with a grid-stride loop over the row and 64-bit tap
//   offsets (a build before this one): 0.0039 fp32, 0.0034 bf16 at batch 1.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "cvt.cuh"

namespace {

constexpr int kThreads = 128;

// max(m, v) with a NaN, once taken, never replaced
__device__ __forceinline__ float take_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// One output element a thread: channel c of output column ow, in every
// output row (grid y) of every image (grid z). WIN > 0 fixes (window,
// stride) at (WIN, STR); WIN = 0 takes them at run time. I indexes a row:
// 32-bit unless an input row's W * C elements pass 2^31 (int offsets
// within a row are safe below that).
template <typename T, typename I, int WIN, int STR>
__global__ void __launch_bounds__(kThreads)
    pool(const T* __restrict__ x, T* __restrict__ out, int N, int H, int W, int C, int OH, int OW,
         int window, int stride) {
  const int win = WIN ? WIN : window, str = WIN ? STR : stride;
  const I g = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= static_cast<I>(C) * static_cast<I>(OW)) return;
  const int c = static_cast<int>(g % static_cast<I>(C));
  const int ow = static_cast<int>(g / static_cast<I>(C));
  for (int n = blockIdx.z; n < N; n += gridDim.z)
    for (int oh = blockIdx.y; oh < OH; oh += gridDim.y) {
      float m = -INFINITY;
#pragma unroll
      for (int kh = 0; kh < win; ++kh) {
        const T* row = x + (((long)n * H + oh * str + kh) * W + (I)ow * str) * C + c;
#pragma unroll
        for (int kw = 0; kw < win; ++kw) m = take_max(m, cvt::to_f32(row[(I)kw * C]));
      }
      out[(((long)n * OH + oh) * OW + ow) * C + c] = cvt::from_f32<T>(m);
    }
}

// (channel, column) blocks in x, output rows in y, images in z; 0 blocks
// where a row's outputs would need more blocks than a grid's x takes
dim3 grid_of(int N, int C, int OH, int OW) {
  const long long blocks = ((long long)C * OW + kThreads - 1) / kThreads;
  return dim3((unsigned)(blocks <= INT_MAX ? blocks : 0), (unsigned)(OH < 65535 ? OH : 65535),
              (unsigned)(N < 65535 ? N : 65535));
}

template <typename T>
int launch(const void* xv, void* ov, int N, int H, int W, int C, int OH, int OW, int window,
           int stride, cudaStream_t s) {
  const dim3 grid = grid_of(N, C, OH, OW);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(ov);
  if ((long long)W * C >= (1LL << 31))
    pool<T, unsigned long long, 0, 0>
        <<<grid, kThreads, 0, s>>>(x, out, N, H, W, C, OH, OW, window, stride);
  else if (window == 2 && stride == 2)
    pool<T, unsigned, 2, 2><<<grid, kThreads, 0, s>>>(x, out, N, H, W, C, OH, OW, 2, 2);
  else if (window == 3 && stride == 2)
    pool<T, unsigned, 3, 2><<<grid, kThreads, 0, s>>>(x, out, N, H, W, C, OH, OW, 3, 2);
  else if (window == 3 && stride == 3)
    pool<T, unsigned, 3, 3><<<grid, kThreads, 0, s>>>(x, out, N, H, W, C, OH, OW, 3, 3);
  else
    pool<T, unsigned, 0, 0><<<grid, kThreads, 0, s>>>(x, out, N, H, W, C, OH, OW, window, stride);
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
