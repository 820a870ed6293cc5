// The tensor-core tile mainloop for output-stationary products C (M x N) =
// A (M x K) B (K x N), with B (K, N) row-major as weights are stored. Two
// users: conv_im2col.cu's bf16 path (A through the implicit-im2col address
// walk) and gemm_os.cu's bf16 and int8 paths (A row-major).
//
// One CTA of 4 warps owns a BM x BN tile of C in registers (each warp a
// WM x WN block of m16n8 accumulators) for the whole sweep over the depth
// K, BK deep per stage (a Shape). A ring of kStages shared-memory stages is
// filled ahead of the products: the caller's loader issues cp.async copies
// (or register-staged loads where its data admits no 16-byte copy) for
// stage s + kStages - 1 while stage s is multiplied, and zero-fills depth
// past K, so the MMA depth pads with zeros. A fragments come from shared
// memory through ldmatrix.x4 (A row-major: a 16-row x 32-byte tile is the
// A fragment of both MMAs below). Row pitches are 16 bytes longer than a
// row, an odd number of 16-byte chunks, so the 8 rows of each ldmatrix
// fall on distinct banks.
//
// A policy fixes the element type, the MMA shape and how B reaches its
// fragments:
//   Bf16: mma.sync.m16n8k16, bf16 in, fp32 accumulators. B's stage holds B
//     (BK x BN) as it is stored; fragments through ldmatrix.trans.
//   S8:   mma.sync.m16n8k32, s8 in, s32 accumulators. The MMA wants B
//     K-contiguous per column, and ldmatrix transposes only 16-bit elements
//     on sm_90, so B's stage holds B transposed (BN x BK): the loader
//     (TransposeB) reads words of four K rows into registers and
//     rearranges their bytes with prmt on the way to shared memory; plain
//     ldmatrix then gives the fragments.
//
// mma.sync and not wgmma: at ResNet-50 stage 3 (M = 784) a 64-row wgmma
// tile leaves too few CTAs to fill 132 SMs, and in both users the loads
// set most of the time (PERF.md).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cvt.cuh"
#include "hopper.cuh"

namespace tc_tile {

using hopper::smem_addr;

constexpr int kThreads = 128;  // 4 warps

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads
// nothing (src must still be a valid address). kL1: through L1 (.ca)
// rather than L2 only (.cg); the GEMM's 64 x 64 bf16 tiles ran 10% faster
// so (launch/gemm_probe.py); the conv keeps .cg.
template <bool kL1 = false>
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  if constexpr (kL1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
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

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
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

// ---- policies --------------------------------------------------------------
// kBT says how B reaches its fragments; the mainloop loads them in line
// (through a policy's member function, ptxas gave the conv's 32 x 16
// kernel more registers than before the policies).

struct Bf16 {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int kK = 16;       // depth of one MMA
  static constexpr bool kBT = false;  // B's stage holds B (BK x BN)

  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
        " {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct S8 {
  using T = int8_t;
  using Acc = int32_t;
  static constexpr int kK = 32;
  static constexpr bool kBT = true;   // B's stage holds B transposed (BN x BK)

  static __device__ __forceinline__ void mma(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
        " {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// A tile shape under policy P: BM x BN outputs per CTA, WM x WN per warp,
// BK deep per stage, kStages stages in the ring.
template <typename P_, int BM_, int BN_, int WM_, int WN_, int BK_, int kStages_>
struct Shape {
  using P = P_;
  using T = typename P::T;
  using Acc = typename P::Acc;
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_;
  static constexpr int kStages = kStages_;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kPad = 16 / sizeof(T);  // 16 bytes per row of padding
  static constexpr int kPitchA = BK + kPad;    // elements per A row in shared memory
  static constexpr int kRowsB = P::kBT ? BN : BK;
  static constexpr int kPitchB = (P::kBT ? BK : BN) + kPad;
  static_assert((BM / WM) * (BN / WN) == kThreads / 32, "one warp per WM x WN block");
  static_assert(WM % 16 == 0 && (WN == 8 || WN % 16 == 0), "whole m16 blocks; n8 blocks or pairs");
  static_assert(BK % P::kK == 0, "whole MMA steps per stage");
  static_assert((kPitchA * sizeof(T) / 16) % 2 == 1 && (kPitchB * sizeof(T) / 16) % 2 == 1,
                "an odd number of 16-byte chunks per row: conflict-free ldmatrix");
};

template <typename Sh>
struct Stages {
  typename Sh::T a[Sh::kStages][Sh::BM][Sh::kPitchA];
  typename Sh::T b[Sh::kStages][Sh::kRowsB][Sh::kPitchB];
};

// One warp's accumulators: acc[i][j][2 half + e] is row wm0 + 16i + lane/4
// + 8 half, column wn0 + 8j + 2 (lane % 4) + e.
template <typename Sh>
using Accum = typename Sh::Acc[Sh::WM / 16][Sh::WN / 8][4];

// acc += A B over `steps` stages of depth BK. The loader fills stage s
// with depth [step * BK, step * BK + BK) of A (rows of the tile) and B
// (columns of the tile) in two calls: issue(st, s, step) starts the copies
// (cp.async, or global loads into the loader's registers), land(st, s)
// finishes them (stores those registers; nothing for cp.async). The ring
// issues stage step + kStages - 1 before multiplying stage `step` and
// lands it after, so register-staged loads too are in flight during the
// products.
template <typename Sh, typename Load>
__device__ __forceinline__ void mainloop(Stages<Sh>& st, Load& load, int steps, Accum<Sh>& acc) {
  using P = typename Sh::P;
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
    for (int kk = 0; kk < Sh::BK / P::kK; ++kk) {
      uint32_t a[WM / 16][4], b[WN / 8][2];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)  // lanes 16-31: the step's second 16 bytes
        ldsm_x4(a[i], &st.a[s][wm0 + 16 * i + lane % 16][P::kK * kk + (lane / 16) * Sh::kPad]);
      // b[j]: columns wn0 + 8j, its pairs depth 0 .. kK/2 - 1 and kK/2 .. kK - 1
      if constexpr (!P::kBT) {  // B (BK x BN): transposing ldmatrix, k16 rows
        const int k = 16 * kk + lane % 16;
        if constexpr (WN == 8) {
          ldsm_x2_trans(b[0][0], b[0][1], &st.b[s][k][wn0]);
        } else {
#pragma unroll
          for (int j = 0; j < WN / 16; ++j) {
            uint32_t r[4];
            ldsm_x4_trans(r, &st.b[s][k][wn0 + 16 * j + (lane / 16) * 8]);
            b[2 * j][0] = r[0];
            b[2 * j][1] = r[1];
            b[2 * j + 1][0] = r[2];
            b[2 * j + 1][1] = r[3];
          }
        }
      } else {  // Bᵀ (BN x BK): lanes 8i .. 8i + 7 give rows of matrix i,
                // depth bytes 0-15 (i even) or 16-31 (i odd) of the step
        const int k = 32 * kk + ((lane / 8) % 2) * 16;
        if constexpr (WN == 8) {
          ldsm_x2(b[0][0], b[0][1], &st.b[s][wn0 + lane % 8][k]);
        } else {
#pragma unroll
          for (int j = 0; j < WN / 16; ++j) {
            uint32_t r[4];
            ldsm_x4(r, &st.b[s][wn0 + 16 * j + (lane / 16) * 8 + lane % 8][k]);
            b[2 * j][0] = r[0];
            b[2 * j][1] = r[1];
            b[2 * j + 1][0] = r[2];
            b[2 * j + 1][1] = r[3];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) P::mma(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if (next < steps) load.land(st, next % kStages);
  }
  cp_async_wait<0>();
}

// out[m, n] (row-major (M, N)) = epi(acc) for the CTA's tile at (m0, n0);
// edges masked.
template <typename Sh, typename TO, typename Epi>
__device__ __forceinline__ void store(TO* __restrict__ out, int M, int N, int m0, int n0,
                                      const Accum<Sh>& acc, Epi epi) {
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
          if (n < N) out[(long)m * N + n] = epi(acc[i][j][2 * half + e]);
        }
    }
}

// fp32 accumulators rounded to TO (the float paths' epilogue)
template <typename TO>
struct Round {
  __device__ __forceinline__ TO operator()(float v) const { return cvt::from_f32<TO>(v); }
};

// ---- loaders: issue / land for one operand -----------------------------
// Each fills its half of stage s with depth [k0, k0 + BK); depth past K,
// rows past M and columns past N read as zeros.

// the raw bits of one element, for packing elements into 32-bit words
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits(int8_t v) { return static_cast<uint8_t>(v); }

// A (M, K) row-major. kVec: K is a whole number of 16-byte chunks and a is
// 16-byte aligned: cp.async copies with zero-fill (through L1 if kL1).
// Else scalar loads packed into 32-bit words in registers (issue) and
// stored (land).
template <typename Sh, bool kVec, bool kL1>
struct RowMajorA {
  using T = typename Sh::T;
  static constexpr int BM = Sh::BM, BK = Sh::BK, kT = kThreads;
  static constexpr int kPerWord = 4 / sizeof(T), kRowWords = BK / kPerWord;
  static constexpr int kWords = kVec ? 1 : BM * kRowWords / kT;
  static_assert((BM * BK / Sh::kPad) % kT == 0 && (BM * kRowWords) % kT == 0,
                "whole chunks and words per thread");
  const T* a;
  int M, K, m0;
  uint32_t reg[kWords];

  __device__ __forceinline__ void issue(Stages<Sh>& st, int s, int k0) {
    if constexpr (kVec) {
      constexpr int kChunks = BK / Sh::kPad;  // 16-byte chunks per row
#pragma unroll
      for (int i = 0; i < BM * kChunks / kT; ++i) {
        const int e = threadIdx.x + kT * i, r = e / kChunks, c = Sh::kPad * (e % kChunks);
        const int m = m0 + r, k = k0 + c;
        const bool in = m < M && k < K;
        cp_async16<kL1>(&st.a[s][r][c], in ? a + (long)m * K + k : a, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int e = threadIdx.x + kT * i, r = e / kRowWords, c = kPerWord * (e % kRowWords);
        const int m = m0 + r;
        uint32_t word = 0;
#pragma unroll
        for (int u = 0; u < kPerWord; ++u)
          if (m < M && k0 + c + u < K) word |= bits(a[(long)m * K + k0 + c + u]) << (32 / kPerWord * u);
        reg[i] = word;
      }
    }
  }

  __device__ __forceinline__ void land(Stages<Sh>& st, int s) const {
    if constexpr (!kVec) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int e = threadIdx.x + kT * i;
        *reinterpret_cast<uint32_t*>(&st.a[s][e / kRowWords][kPerWord * (e % kRowWords)]) = reg[i];
      }
    }
  }
};

// B (K, N) row-major into a Bf16 stage as it is: rows [k0, k0 + BK),
// columns [n0, n0 + BN). kVec: N % 8 == 0 and b 16-byte aligned, cp.async
// copies of 8 columns (through L1 if kL1); else scalar loads staged in
// registers.
template <typename Sh, bool kVec, bool kL1 = false>
struct RowMajorB {
  using T = __nv_bfloat16;
  static_assert(std::is_same_v<typename Sh::T, T>, "a Bf16 stage");
  static constexpr int BN = Sh::BN, BK = Sh::BK, kT = kThreads;
  static constexpr int kScalar = kVec ? 1 : BK * BN / kT;
  static_assert((BK * BN) % kT == 0, "whole elements per thread");
  const T* b;
  int K, N, n0;
  T reg[kScalar];

  __device__ __forceinline__ void issue(Stages<Sh>& st, int s, int k0) {
    if constexpr (kVec) {
      constexpr int kChunks = BN / 8;
#pragma unroll
      for (int i = 0; i < (BK * kChunks + kT - 1) / kT; ++i) {
        const int e = threadIdx.x + kT * i;
        if (e >= BK * kChunks) break;
        const int kr = e / kChunks, cn = 8 * (e % kChunks);
        const int k = k0 + kr, n = n0 + cn;
        const bool in = k < K && n < N;
        cp_async16<kL1>(&st.b[s][kr][cn], in ? b + (long)k * N + n : b, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kScalar; ++i) {
        const int e = threadIdx.x + kT * i, kr = e / BN, cn = e % BN;
        const int k = k0 + kr, n = n0 + cn;
        reg[i] = (k < K && n < N) ? b[(long)k * N + n] : __float2bfloat16(0.f);
      }
    }
  }

  __device__ __forceinline__ void land(Stages<Sh>& st, int s) const {
    if constexpr (!kVec) {
#pragma unroll
      for (int i = 0; i < kScalar; ++i) {
        const int e = threadIdx.x + kT * i;
        st.b[s][e / BN][e % BN] = reg[i];
      }
    }
  }
};

// B (K, N) row-major, int8, into an S8 stage transposed: st.b[s][n][k].
// kVec: N % 16 == 0 and b 16-byte aligned. A thread takes a group of 4
// consecutive K rows x 16 columns: four 16-byte loads in issue; in land,
// each 4 x 4 block of bytes is transposed with prmt (__byte_perm) into 4
// words that each hold 4 K values of one column, stored as Bᵀ. Groups run
// columns-fastest across threads, so each load of a warp fills whole
// 32-byte sectors; its stores then meet 2 (BN = 32) or 4 (BN = 64) to a
// bank. Else one word per thread and step from 4 scalar loads down a
// column.
template <typename Sh, bool kVec>
struct TransposeB {
  using T = int8_t;
  static_assert(std::is_same_v<typename Sh::T, T>, "an S8 stage");
  static constexpr int BN = Sh::BN, BK = Sh::BK, kT = kThreads;
  static constexpr int kQuads = BK / 4;                   // 4-row depth groups
  static constexpr int kChunks = BN / 16;                 // 16-column groups
  static constexpr int kGroups = kQuads * kChunks;
  static constexpr int kPer = (kGroups + kT - 1) / kT;    // groups per thread
  static constexpr int kWords = kVec ? 1 : BN * kQuads / kT;
  static_assert(BN % 16 == 0 && (BN * kQuads) % kT == 0, "whole groups and words");
  const T* b;
  int K, N, n0;
  uint4 v[kVec ? kPer : 1][4];
  uint32_t reg[kWords];

  __device__ __forceinline__ void issue(Stages<Sh>& st, int s, int k0) {
    if constexpr (kVec) {
#pragma unroll
      for (int g = 0; g < kPer; ++g) {
        const int e = threadIdx.x + kT * g;
        if (kGroups % kT != 0 && e >= kGroups) break;
        const int k = k0 + 4 * (e / kChunks), n = n0 + 16 * (e % kChunks);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[g][r] = (k + r < K && n < N)
                        ? *reinterpret_cast<const uint4*>(b + (long)(k + r) * N + n)
                        : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int e = threadIdx.x + kT * i, n = n0 + e % BN, k = k0 + 4 * (e / BN);
        uint32_t word = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n < N && k + u < K) word |= bits(b[(long)(k + u) * N + n]) << (8 * u);
        reg[i] = word;
      }
    }
  }

  __device__ __forceinline__ void land(Stages<Sh>& st, int s) const {
    if constexpr (kVec) {
#pragma unroll
      for (int g = 0; g < kPer; ++g) {
        const int e = threadIdx.x + kT * g;
        if (kGroups % kT != 0 && e >= kGroups) break;
        const int kq = 4 * (e / kChunks), nc = 16 * (e % kChunks);
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // columns nc + 4q .. nc + 4q + 3
          const uint32_t w0 = (&v[g][0].x)[q], w1 = (&v[g][1].x)[q];
          const uint32_t w2 = (&v[g][2].x)[q], w3 = (&v[g][3].x)[q];
          // byte c of row r -> byte r of column c
          const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
          const uint32_t hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
          const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                                   __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            *reinterpret_cast<uint32_t*>(&st.b[s][nc + 4 * q + c][kq]) = col[c];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int e = threadIdx.x + kT * i;
        *reinterpret_cast<uint32_t*>(&st.b[s][e % BN][4 * (e / BN)]) = reg[i];
      }
    }
  }
};

// B's loader under the shape's policy (TransposeB loads through registers)
template <typename Sh, bool kVec, bool kL1>
using LoadB = std::conditional_t<Sh::P::kBT, TransposeB<Sh, kVec>, RowMajorB<Sh, kVec, kL1>>;

}  // namespace tc_tile
