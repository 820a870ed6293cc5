// A bf16 tensor-core tile mainloop for output-stationary products, shared
// by the kernels whose bf16 path computes C (M x N, fp32) = A (M x K) B
// (K x N): conv_im2col.cu today, gemm_os.cu's float path next.
//
// One CTA of 4 warps owns a BM x BN tile of C in registers (each warp a
// WM x WN block of mma.sync.m16n8k16 accumulators, bf16 in, fp32 out) for
// the whole sweep over the depth K, BK deep per stage (a Shape). A ring of
// kStages shared-memory stages is filled ahead of the products: the
// caller's loader issues cp.async copies (or register-staged loads where
// its data admits no 16-byte copy) for stage s + kStages - 1 while stage s
// is multiplied, and zero-fills depth past K, so the MMA depth pads with
// zeros. Fragments come from shared memory through ldmatrix (A row-major,
// B through its transposing form, so B stays (K, N) row-major as the
// weights are stored). Row pitches of 16 (BK/8 + 1) bytes (A) and
// 16 (BN/8 + 1) bytes (B) put the 8 rows of each ldmatrix on distinct
// banks for BK, BN in {16, 32, 64}.
//
// mma.sync and not wgmma: at the sizes this serves (M = 784 at ResNet-50
// stage 3, N = 128) a 64-row wgmma tile leaves too few CTAs to fill 132
// SMs, and smaller tiles than 64 x 64 are what fill the card there; the
// FLOPs per CTA are small enough that the warp-level MMA's rate is not the
// limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cvt.cuh"
#include "hopper.cuh"

namespace tc_tile {

using hopper::smem_addr;

constexpr int kThreads = 128;  // 4 warps

// A tile shape: BM x BN outputs per CTA, WM x WN per warp, BK deep per
// stage, kStages stages in the ring.
template <int BM_, int BN_, int WM_, int WN_, int BK_, int kStages_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_;
  static constexpr int kStages = kStages_;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kPitchA = BK + 8;  // bf16 per A row in shared memory
  static constexpr int kPitchB = BN + 8;  // bf16 per B row
  static_assert((BM / WM) * (BN / WN) == kThreads / 32, "one warp per WM x WN block");
  static_assert(WN == 8 || WN % 16 == 0, "B fragments come in n8 blocks or pairs");
  static_assert(BK % 16 == 0, "whole k16 MMA steps per stage");
};

template <typename Sh>
struct Stages {
  __nv_bfloat16 a[Sh::kStages][Sh::BM][Sh::kPitchA];
  __nv_bfloat16 b[Sh::kStages][Sh::BK][Sh::kPitchB];
};

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads
// nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B over `steps` stages of depth BK. The loader fills stage s
// with depth [step * BK, step * BK + BK) of A (rows of the tile) and B
// (columns of the tile) in two calls: issue(st, s, step) starts the copies
// (cp.async, or global loads into the loader's registers), land(st, s)
// finishes them (stores those registers; nothing for cp.async). The ring
// issues stage step + kStages - 1 before multiplying stage `step` and
// lands it after, so register-staged loads too are in flight during the
// products. Accumulator layout (per warp, m16n8 blocks): acc[i][j][2 half
// + e] is row wm0 + 16i + lane/4 + 8 half, column wn0 + 8j + 2 (lane % 4)
// + e.
template <typename Sh, typename Load>
__device__ __forceinline__ void mainloop(Stages<Sh>& st, Load& load, int steps,
                                         float (&acc)[Sh::WM / 16][Sh::WN / 8][4]) {
  constexpr int WM = Sh::WM, WN = Sh::WN, kStages = Sh::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / Sh::kWarpsN) * WM, wn0 = (warp % Sh::kWarpsN) * WN;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load.issue(st, s, s);
      load.land(st, s);
    }
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // stage `step` has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage step - 1 is free
    const int next = step + kStages - 1;
    if (next < steps) load.issue(st, next % kStages, next);
    cp_async_commit();
    const int s = step % kStages;
#pragma unroll
    for (int kk = 0; kk < Sh::BK / 16; ++kk) {
      uint32_t a[WM / 16][4], b[WN / 8][2];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        ldsm_x4(a[i], &st.a[s][wm0 + 16 * i + lane % 16][16 * kk + (lane / 16) * 8]);
      if constexpr (WN == 8) {
        ldsm_x2_trans(b[0][0], b[0][1], &st.b[s][16 * kk + lane % 16][wn0]);
      } else {
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) {
          uint32_t r[4];
          ldsm_x4_trans(r, &st.b[s][16 * kk + lane % 16][wn0 + 16 * j + (lane / 16) * 8]);
          b[2 * j][0] = r[0];
          b[2 * j][1] = r[1];
          b[2 * j + 1][0] = r[2];
          b[2 * j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if (next < steps) load.land(st, next % kStages);
  }
  cp_async_wait<0>();
}

// out[m, n] (row-major (M, N)) = acc rounded to TO, for the CTA's tile at
// (m0, n0); edges masked.
template <typename Sh, typename TO>
__device__ __forceinline__ void store(TO* __restrict__ out, int M, int N, int m0, int n0,
                                      const float (&acc)[Sh::WM / 16][Sh::WN / 8][4]) {
  constexpr int WM = Sh::WM, WN = Sh::WN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = m0 + (warp / Sh::kWarpsN) * WM, wn0 = n0 + (warp % Sh::kWarpsN) * WN;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm0 + 16 * i + lane / 4 + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = wn0 + 8 * j + 2 * (lane % 4) + e;
          if (n < N) out[(long)m * N + n] = cvt::from_f32<TO>(acc[i][j][2 * half + e]);
        }
    }
}

}  // namespace tc_tile
