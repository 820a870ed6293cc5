// The data reshuffler's two layout passes, for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/reshuffle.py::_blocked_kernel
// (reshuffle.py:22) and ::_transpose_kernel (reshuffle.py:44):
//
//   blocked_layout   (H,W,C) -> (Cp/cb,H,W,cb), C zero-padded up to Cp, the
//                    next multiple of cb (the chip's C/8HWC8 at cb = 8);
//   tiled_transpose  (M,N) -> (N,M), the dedicated-transposer pass.
//
// Both move bits only, so they are written over the element width (4 bytes
// for float32, 2 for bfloat16) and every output is bitwise one input or 0.
//
// blocked_layout: one thread per output element, output order, so stores
// coalesce fully and loads coalesce in runs of cb channels. The padded
// channels are written as 0 here; no padded copy of x is made (the JAX
// wrapper pads with jnp.pad first).
// tiled_transpose: a 32 x 32 tile through shared memory, 32 x 8 threads,
// so that both the read of x's rows and the write of out's rows coalesce.
// The tile row is padded to 33 elements against bank conflicts, and the
// ragged edges are masked, so any M and N work without padding or cropping.
//
// What bounds both on this card: bytes. The least time is the input read
// once plus the output written once, over 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 32;  // transpose tile side
constexpr int kRows = 8;  // transpose rows per thread pass

template <typename E>
__global__ void __launch_bounds__(kThreads)
    blocked_kernel(const E* __restrict__ x, E* __restrict__ out, int HW, int C, int cb, long total) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int c = i % cb;
  const long t = i / cb;
  const long hw = t % HW;
  const int ch = (int)(t / HW) * cb + c;
  out[i] = ch < C ? x[hw * C + ch] : E(0);
}

template <typename E>
__global__ void __launch_bounds__(kT * kRows)
    transpose_kernel(const E* __restrict__ x, E* __restrict__ out, int M, int N) {
  __shared__ E tile[kT][kT + 1];
  const int n0 = blockIdx.x * kT, m0 = blockIdx.y * kT;
  for (int r = threadIdx.y; r < kT; r += kRows) {
    const int m = m0 + r, n = n0 + threadIdx.x;
    if (m < M && n < N) tile[r][threadIdx.x] = x[(long)m * N + n];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kT; r += kRows) {
    const int n = n0 + r, m = m0 + threadIdx.x;
    if (n < N && m < M) out[(long)n * M + m] = tile[threadIdx.x][r];
  }
}

template <typename E>
int launch_blocked(const void* x, void* out, int H, int W, int C, int cb, cudaStream_t s) {
  const int Cp = (C + cb - 1) / cb * cb;
  const long total = (long)H * W * Cp;
  const long blocks = (total + kThreads - 1) / kThreads;
  blocked_kernel<E><<<(unsigned)blocks, kThreads, 0, s>>>(static_cast<const E*>(x),
                                                          static_cast<E*>(out), H * W, C, cb, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_transpose(const void* x, void* out, int M, int N, cudaStream_t s) {
  const dim3 grid((N + kT - 1) / kT, (M + kT - 1) / kT);
  transpose_kernel<E><<<grid, dim3(kT, kRows), 0, s>>>(static_cast<const E*>(x),
                                                       static_cast<E*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem_bytes: 4 (float32) or 2 (bfloat16). Each returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int blocked_layout_launch(const void* x, void* out, int H, int W, int C, int cb,
                                     int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch_blocked<uint32_t>(x, out, H, W, C, cb, s);
  if (elem_bytes == 2) return launch_blocked<uint16_t>(x, out, H, W, C, cb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tiled_transpose_launch(const void* x, void* out, int M, int N, int elem_bytes,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch_transpose<uint32_t>(x, out, M, N, s);
  if (elem_bytes == 2) return launch_transpose<uint16_t>(x, out, M, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
