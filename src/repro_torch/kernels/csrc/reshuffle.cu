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
// blocked_layout: a copy in output order, so stores coalesce fully and
// loads coalesce in runs of cb channels; 2-D grid, y the channel block (a
// CTA steps on by gridDim.y past 65535 blocks) and x the (pixel, unit)
// pairs of that block, with 32-bit index math inside a block (the wrapper
// caps x and one channel block of out below 2^31 elements). A unit is one 16-byte
// vector (4 fp32 or 8 bf16 channels of one cb-run) where cb and C are
// multiples of the vector and x is 16-byte aligned; else one element. A
// unit of channels at or past C is all padding (C is a multiple of the
// unit), written as 0 without a load; no padded copy of x is made (the JAX
// wrapper pads with jnp.pad first). Each thread moves 4 units, the 4 loads
// issued before the stores (64 bytes a thread in flight), where that still
// leaves a CTA for each of an H100's 132 SMs; else 1. On an H100 (device
// ms, launch/paged_probe.py): 56x56x256 fp32 cb 8 0.0035, cb 128 0.0031,
// where contiguous() of the permuted view takes 0.0041 and the version this
// one replaced (one thread per element, a 64-bit division and two modulos
// each) took 0.0049 / 0.0048; its bound is 0.0019. 4 units a thread at
// 28x28x100 cb 128 (25 CTAs) took 0.0021 against that version's 0.0019.
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

// U: the unit one thread step moves (uint4, or the element itself); kU
// units a thread. C and cb are counted in units; unit j of pixel hw in
// channel block cbk comes from x[hw * C + cbk * cb + j] (0 at or past C).
template <typename U, int kU>
__global__ void __launch_bounds__(kThreads)
    blocked_kernel(const U* __restrict__ x, U* __restrict__ out, int HW, int C, int cb) {
  const int n = HW * cb;  // units of one channel block
  const int blocks = C / cb + (C % cb != 0);
  const int f0 = blockIdx.x * (kThreads * kU) + threadIdx.x;
  for (int cbk = blockIdx.y; cbk < blocks; cbk += gridDim.y) {
    const int c0 = cbk * cb;
    U* o = out + (long long)cbk * n;
    U v[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int f = f0 + k * kThreads;
      const int hw = f / cb, ch = c0 + f - hw * cb;
      v[k] = U{};
      if (f < n && ch < C) v[k] = x[hw * C + ch];
    }
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int f = f0 + k * kThreads;
      if (f < n) o[f] = v[k];
    }
  }
}

// 4 units a thread (the 4 loads issued before the stores) where that still
// leaves a CTA for every SM, else 1; at most 65535 CTAs in y
template <typename U>
void launch_units(const void* x, void* out, int HW, int C, int cb, cudaStream_t s) {
  const unsigned blocks = (unsigned)(C / cb + (C % cb != 0));
  const unsigned rows = blocks < 65535u ? blocks : 65535u;
  const int n = HW * cb;
  const unsigned wide = (unsigned)((n + kThreads * 4 - 1) / (kThreads * 4));
  if ((unsigned long long)wide * blocks >= 132)
    blocked_kernel<U, 4><<<dim3(wide, rows), kThreads, 0, s>>>(
        static_cast<const U*>(x), static_cast<U*>(out), HW, C, cb);
  else
    blocked_kernel<U, 1><<<dim3((unsigned)((n + kThreads - 1) / kThreads), rows), kThreads, 0,
                           s>>>(static_cast<const U*>(x), static_cast<U*>(out), HW, C, cb);
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

// E: the element; moved as 16-byte vectors of 16 / sizeof(E) where the
// shapes and the pointers allow it
template <typename E>
int launch_blocked(const void* x, void* out, int H, int W, int C, int cb, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(E);
  const bool vec = cb % kVec == 0 && C % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    launch_units<uint4>(x, out, H * W, C / kVec, cb / kVec, s);
  else
    launch_units<E>(x, out, H * W, C, cb, s);
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
