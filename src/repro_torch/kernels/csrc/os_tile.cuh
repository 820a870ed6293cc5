// The output-stationary float tile loop shared by gemm_os.cu and
// conv_im2col.cu: one CTA of 256 threads owns a 64 x 64 tile of C = A @ B
// and keeps it in registers (a 4 x 4 block per thread, rows ty + 16i,
// columns tx + 16j) for the whole sweep over the depth K, the way the TPU
// kernel kept its accumulator in VMEM scratch. A and B pass through shared
// memory 16 deep at a time as fp32 (bf16 widened on load, exactly). Every
// element is read with a bounds check, so ragged edges need no padded copy;
// a value past an edge reads as 0 and adds exactly 0.
//
// A is reached through a functor a(m, k) -> float: a row-major matrix for
// the GEMM, the implicit im2col address walk for the conv. B is the
// (K, N) row-major weight in both.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cvt.cuh"

namespace os_tile {

using cvt::from_f32;
using cvt::to_f32;

constexpr int kThreads = 256;
constexpr int kTile = 64;  // output rows and columns per CTA
constexpr int kDepth = 16; // depth per shared-memory stage

// acc[i][j] += sum_k a(m0 + ty + 16i, k) * b[k, n0 + tx + 16j], k ascending.
template <typename AFn, typename TB>
__device__ __forceinline__ void accumulate(const AFn& a, const TB* __restrict__ b, int M, int N,
                                           int K, int m0, int n0, float (&acc)[4][4]) {
  __shared__ float a_s[kDepth][kTile + 4];  // depth-major: a_s[k][m]
  __shared__ float b_s[kDepth][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int m = e / kDepth, k = e % kDepth;  // neighbours walk k: a row of A
      a_s[k][m] = (m0 + m < M && k0 + k < K) ? a(m0 + m, k0 + k) : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int k = e / kTile, n = e % kTile;    // neighbours walk n: a row of B
      b_s[k][n] = (k0 + k < K && n0 + n < N) ? to_f32(b[(long)(k0 + k) * N + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out[m, n] (row-major (M, N)) = acc, rounded to TO; edges masked.
template <typename TO>
__device__ __forceinline__ void store(TO* __restrict__ out, int M, int N, int m0, int n0,
                                      const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(long)m * N + n] = from_f32<TO>(acc[i][j]);
    }
  }
}

}  // namespace os_tile
