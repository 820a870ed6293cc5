// Conv2D by implicit im2col, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/conv_im2col.py::_conv_kernel
// (conv_im2col.py:31). It computes the same function: x (N,H,W,C) NHWC
// against w (R,S,C,K) RSCK, SAME padding split (p//2, p - p//2) with
// OH = ceil(H / stride), fp32 accumulation, output (N,OH,OW,K) in x's type.
//
// Layout: an implicit GEMM. Rows are output pixels m = (n, oh, ow), columns
// are output channels, and the depth is the tap (kh, kw, c), so w is
// already the (R*S*C, K) row-major B of the GEMM. The kernel computes each
// input address itself, ih = oh*stride + kh - pad_top (likewise iw), and
// reads 0 outside the image: this is the chip's AGU walking a 6-D affine
// pattern. No padded copy of x and no im2col buffer is ever written. The
// tile loop (64 x 64 outputs per CTA, accumulator in registers) is the
// GEMM's, shared through os_tile.cuh; A is read one scalar at a time, since
// the ResNet-50 stem has C = 3 and admits no vector width over C.
//
// What bounds it on this card: operations at the ResNet-50 shapes (the
// fp32 stem does ~0.24 GFLOP on 0.6 MB of input and weights). The least time is the FLOPs
// of the in-image taps over 67 TFLOP/s (fp32) or 989 TFLOP/s (bf16). What
// the design does about that, for now: register tiling only, fp32 FMAs,
// plus an integer address walk per element of A. Tensor cores are later
// work.
#include "os_tile.cuh"

namespace {

using os_tile::kThreads;
using os_tile::kTile;

template <typename T>
struct Im2col {
  const T* x;
  int H, W, C, S, OH, OW, stride, pad_t, pad_l;
  __device__ __forceinline__ float operator()(int m, int k) const {
    const int ow = m % OW, t = m / OW, oh = t % OH, n = t / OH;
    const int c = k % C, tap = k / C, kw = tap % S, kh = tap / S;
    const int ih = oh * stride + kh - pad_t, iw = ow * stride + kw - pad_l;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return 0.f;
    return os_tile::to_f32(x[(((long)n * H + ih) * W + iw) * C + c]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_kernel(Im2col<T> a, const T* __restrict__ w, T* __restrict__ out, int M, int Cout,
                int depth) {
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  os_tile::accumulate(a, w, M, Cout, depth, m0, n0, acc);
  os_tile::store(out, M, Cout, m0, n0, acc);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int N, int H, int W, int C, int R, int S,
           int Cout, int OH, int OW, int stride, int pad_t, int pad_l, cudaStream_t s) {
  const int M = N * OH * OW;
  const Im2col<T> a{static_cast<const T*>(x), H, W, C, S, OH, OW, stride, pad_t, pad_l};
  const dim3 grid((Cout + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  conv_kernel<T><<<grid, kThreads, 0, s>>>(a, static_cast<const T*>(w), static_cast<T*>(out), M,
                                           Cout, R * S * C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, w and out alike). Returns the
// launch's cudaGetLastError() (0 = launched).
extern "C" int conv_im2col_launch(const void* x, const void* w, void* out, int N, int H, int W,
                                  int C, int R, int S, int Cout, int OH, int OW, int stride,
                                  int pad_t, int pad_l, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, out, N, H, W, C, R, S, Cout, OH, OW, stride, pad_t, pad_l, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, N, H, W, C, R, S, Cout, OH, OW, stride, pad_t, pad_l,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
