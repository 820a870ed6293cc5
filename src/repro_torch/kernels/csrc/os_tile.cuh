// The output-stationary fp32 tile loop of the fp32 paths only: gemm_os.cu
// and conv_im2col.cu with float32 inputs (their bf16 and int8 paths run on
// the tensor cores, tc_tile.cuh). Exact fp32 on the FMA units: TF32 would
// miss the ref.sum_order_error limit, depth * 2^-24 * (|x| @ |w|).
//
// What bounds it: operations. 2 M N K flops over the H100's 67 TFLOP/s
// (fp32 outside the tensor cores) is 36 us at the BERT-Base FFN and 2 us at
// the kernel bench's 128 x 4096 x 128; the bytes take a tenth of that or
// less. Three things kept the first port's loop (one 64 x 64 tile per CTA
// over the whole depth, 4 x 4 outputs a thread, scalar loads, a barrier
// on each side of every stage) far from it: too few CTAs (4 at 128 x 4096
// x 128, 26 at ResNet-50 stage 3), 8 scalar shared loads per 16 FMAs, and
// no load in flight while the FMAs ran.
//
// The design:
// - 8 x 4 outputs a thread, read as float4: a CTA of 128 threads owns a
//   64 x 64 tile; thread (tx, ty) the rows ty + 8 i and columns 4 tx .. +3.
//   Per 4 depth values it loads 8 float4 of A (4 depth values of one row
//   each, A stored row-major [64][16 + 4]) and 4 float4 of B (stored as it
//   is, [16][64]) for 128 FMAs: 12 shared loads where the old loop took 64.
//   A warp is 8 columns x 4 rows of threads: its B loads cover 128
//   contiguous bytes, its A loads 4 rows whose pitch (20 floats) puts them
//   on distinct banks.
// - A ring of 4 cp.async stages, 16 deep, one barrier per stage: stage
//   i + 3 is in flight while stage i is multiplied. 16-byte copies
//   (tc_tile.cuh's cp_async16, through L1) where a row is a whole number of
//   16-byte chunks and the pointer is aligned (the launcher decides from
//   the pointers), 4-byte copies otherwise; past an edge the copy's source
//   size is 0 and it writes zeros, which add 0.
// - A depth split in a fixed order: each tile's depth is cut into `splits`
//   ranges of `chunk` values (whole stages; blockIdx.z is the rank), each
//   summed in fp32 in ascending depth by one thread per output and stored
//   to an fp32 workspace (splits, Mp, Np) that the wrapper allocates; a
//   second pass (reduce_splits) adds the partials in rank order, rank 0
//   first, and rounds once to the output type. No atomics: two runs give
//   the same bits. plan() picks the split from (M, N, depth, SMs): a
//   model of the busiest SM in which fewer than 12 resident warps run the
//   FMAs at a proportional rate, fitted to launch/gemm_probe.py --f32.
//
// What it reaches (launch/gemm_probe.py --f32, device ms on cold copies,
// H100 80GB HBM3 at 700 W; the PyTorch call in brackets): the FFN 0.0772
// (torch.matmul 0.0602), 47% of the FMA peak; 1024^3 0.0677 (0.0557);
// 512^3 0.0133 (0.0126); 128 x 4096 x 128 0.0124 (0.0102); stage 3 0.0141
// (F.conv2d 0.0359), the bench's 28 x 28 x 64 -> 128 conv 0.0097
// (0.0221), the stem 0.0162 (0.0171). What holds it back now: FMA issue
// at under half the peak where each SM has work (cuBLAS reaches 59% at
// the FFN), and where it has little, the second pass and the ring's
// first fill. The plan's pick was the fastest split timed at each of these
// shapes but 128 x 4096 x 128 (64 ranges; 32 took 0.0114).
//
// Tried on the card and not kept (the same probe):
// - a second tile, 128 x 128 with 8 x 8 a thread (256 threads, 189
//   registers, one CTA an SM): never the fastest plan at any shape above
//   (FFN 0.0864 at its best split against 0.0782; 1024^3 0.0715 against
//   0.0695; stage 3 0.0156 against 0.0142); capped at 128 registers for two
//   CTAs an SM it spilled and was no faster;
// - 64 x 64 with 8 x 8 a thread (64 threads): slower where each SM has
//   little work (stage 3 in 5 ranges 0.0263 against 0.0180);
// - 32-deep stages (3 or 4; 178 registers, two CTAs an SM): up to 8%
//   faster where each SM has little work, 0.1001 against 0.0774 at the FFN;
//   6 stages of 16: no faster anywhere, 1024^3 in 2 ranges 0.1046;
// - a second pass that issues 16 partials' loads ahead of their adds:
//   5-10 us slower at every split (1024^3 0.0793 against 0.0677); one
//   thread per output was within 3% of the float4 pass kept;
// - splitting only where the tiles alone are fewer than the SMs: 1024^3
//   (256 tiles) takes 0.0811 in 1 range and 0.0677 in 2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cvt.cuh"
#include "tc_tile.cuh"

namespace os_tile {

using cvt::from_f32;
using tc_tile::cp_async16;
using tc_tile::cp_async_commit;
using tc_tile::cp_async_wait;

// 4 bytes global -> shared through L1; valid false writes 4 zero bytes and
// reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

template <int BM_, int BN_, int TM_, int TN_, int BK_, int kStages_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_, kStages = kStages_;
  static constexpr int kTx = BN / TN, kTy = BM / TM;  // the CTA's thread grid
  static constexpr int kThreads = kTx * kTy;
  static constexpr int kPitchA = BK + 4;  // floats per row of A's stage
  static_assert(TN % 4 == 0 && BK % 4 == 0, "float4 reads of A and B");
  static_assert(kTx % 8 == 0 && kTy % 4 == 0, "a warp is 8 x 4 threads");
  static_assert(kThreads % BK == 0 && (BM * BK) % kThreads == 0 && (BK * BN) % kThreads == 0,
                "each thread copies a fixed depth column of A");
};

// 64 x 64 outputs, 8 x 4 a thread, 128 threads, 16 deep per stage, 4
// stages. Its kernels declare __launch_bounds__(kThreads, 1): with the
// thread count alone ptxas held the conv's kernel to 96 registers and
// spilled (12 bytes; stage 3 took 0.0146 ms against 0.0141, in two
// calls); with it, 121-128 registers, four CTAs an SM.
using Tile = Shape<64, 64, 8, 4, 16, 4>;

// the ring, in dynamic shared memory (Tile: 36,864 bytes, within the 48 KB
// a launch gets without raising its limit)
template <typename Sh>
struct Stages {
  float a[Sh::kStages][Sh::BM][Sh::kPitchA];  // A rows, depth contiguous
  float b[Sh::kStages][Sh::BK][Sh::BN];       // B as stored
};

template <typename Sh>
using Accum = float[Sh::TM][Sh::TN];

// this thread's place in the grid: a warp is 8 columns x 4 rows of threads
template <typename Sh>
__device__ __forceinline__ int thread_x() {
  return (threadIdx.x / 32) % (Sh::kTx / 8) * 8 + threadIdx.x % 8;
}
template <typename Sh>
__device__ __forceinline__ int thread_y() {
  return (threadIdx.x / 32) / (Sh::kTx / 8) * 4 + (threadIdx.x % 32) / 8;
}

// B = w (K, N) row-major: rows [k0, k_end) of the tile's columns. kVec (a
// runtime flag): N % 4 == 0 and w 16-byte aligned, 16-byte copies.
template <typename Sh>
struct LoadB {
  const float* w;
  int N, n0;
  bool vec;

  __device__ __forceinline__ void issue(Stages<Sh>& st, int s, int k0, int k_end) const {
    constexpr int BN = Sh::BN, kT = Sh::kThreads;
    if (vec) {
#pragma unroll
      for (int i = 0; i < Sh::BK * BN / 4 / kT; ++i) {
        const int e = threadIdx.x + kT * i, k = e / (BN / 4), n = 4 * (e % (BN / 4));
        const bool in = k0 + k < k_end && n0 + n < N;
        cp_async16<true>(&st.b[s][k][n], in ? w + (long)(k0 + k) * N + n0 + n : w, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < Sh::BK * BN / kT; ++i) {
        const int e = threadIdx.x + kT * i, k = e / BN, n = e % BN;
        const bool in = k0 + k < k_end && n0 + n < N;
        cp_async4(&st.b[s][k][n], in ? w + (long)(k0 + k) * N + n0 + n : w, in);
      }
    }
  }
};

__device__ __forceinline__ float part(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// the stage's BK depth values into the thread's outputs, k ascending
template <typename Sh>
__device__ __forceinline__ void multiply(const Stages<Sh>& st, int s, Accum<Sh>& acc) {
  constexpr int TM = Sh::TM, TN = Sh::TN;
  const int tx = thread_x<Sh>(), ty = thread_y<Sh>();
#pragma unroll
  for (int kk = 0; kk < Sh::BK; kk += 4) {
    float4 a[TM], b[TN / 4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(&st.a[s][ty + Sh::kTy * i][kk]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int g = 0; g < TN / 4; ++g)
        b[g] = *reinterpret_cast<const float4*>(&st.b[s][kk + j][4 * tx + 4 * Sh::kTx * g]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n)
          acc[i][n] = fmaf(part(a[i], j), part(b[n / 4], n % 4), acc[i][n]);
    }
  }
}

// acc += the products over depth [k_begin, k_end), k ascending. LoadA has
// issue(st, s, k0, k_end): the stage's A rows, depth [k0, k0 + BK), zeros
// at and past k_end.
template <typename Sh, typename LoadA>
__device__ __forceinline__ void mainloop(Stages<Sh>& st, const LoadA& la, const LoadB<Sh>& lb,
                                         int k_begin, int k_end, Accum<Sh>& acc) {
  constexpr int BK = Sh::BK, kStages = Sh::kStages;
  const int steps = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      la.issue(st, s, k_begin + s * BK, k_end);
      lb.issue(st, s, k_begin + s * BK, k_end);
    }
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // stage `step` has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage step - 1 is free
    const int next = step + kStages - 1;
    if (next < steps) {
      la.issue(st, next % kStages, k_begin + next * BK, k_end);
      lb.issue(st, next % kStages, k_begin + next * BK, k_end);
    }
    cp_async_commit();
    multiply<Sh>(st, step % kStages, acc);
  }
  cp_async_wait<0>();
}

// out[m, n] (row-major (M, N)) = acc rounded to TO, edges masked; four
// columns in one store where `vec` (N % 4 == 0, out aligned to 4 elements)
template <typename Sh, typename TO>
__device__ __forceinline__ void store(TO* __restrict__ out, int M, int N, int m0, int n0,
                                      const Accum<Sh>& acc, bool vec) {
  const int tx = thread_x<Sh>(), ty = thread_y<Sh>();
#pragma unroll
  for (int i = 0; i < Sh::TM; ++i) {
    const int m = m0 + ty + Sh::kTy * i;
    if (m >= M) continue;
#pragma unroll
    for (int g = 0; g < Sh::TN / 4; ++g) {
      const int n = n0 + 4 * tx + 4 * Sh::kTx * g;
      TO* dst = out + (long)m * N + n;
      if (vec && n + 3 < N) {
        if constexpr (sizeof(TO) == 4) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
        } else {
          *reinterpret_cast<uint2*>(dst) =
              make_uint2(cvt::pack_bf16x2(acc[i][4 * g], acc[i][4 * g + 1]),
                         cvt::pack_bf16x2(acc[i][4 * g + 2], acc[i][4 * g + 3]));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < N) dst[c] = from_f32<TO>(acc[i][4 * g + c]);
      }
    }
  }
}

// the CTA's partial sums into its rank's slice of the workspace, (Mp, Np)
// row-major with Mp, Np the grid's whole tiles: no edge to mask
template <typename Sh>
__device__ __forceinline__ void store_partial(float* __restrict__ ws, int m0, int n0,
                                              const Accum<Sh>& acc) {
  const int Np = gridDim.x * Sh::BN;
  float* slice = ws + (long)blockIdx.z * gridDim.y * Sh::BM * Np;
  const int tx = thread_x<Sh>(), ty = thread_y<Sh>();
#pragma unroll
  for (int i = 0; i < Sh::TM; ++i)
#pragma unroll
    for (int g = 0; g < Sh::TN / 4; ++g)
      *reinterpret_cast<float4*>(
          &slice[(long)(m0 + ty + Sh::kTy * i) * Np + n0 + 4 * tx + 4 * Sh::kTx * g]) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
}

// out[m, n] = ((p_0 + p_1) + p_2) + ... over the splits' partials p_r =
// ws[r, m, n], rounded once to TO: the fixed rank order. One thread per 4
// columns of a row: the workspace's rows are whole tiles, so its float4
// loads are aligned and in bounds; the stores are masked at N.
template <typename TO>
__global__ void __launch_bounds__(256)
    reduce_splits(const float* __restrict__ ws, TO* __restrict__ out, int M, int N, int Mp,
                  int Np, int splits) {
  const long q = (long)blockIdx.x * 256 + threadIdx.x, quads = (long)M * (Np / 4);
  if (q >= quads) return;
  const int m = static_cast<int>(q / (Np / 4)), n = 4 * static_cast<int>(q % (Np / 4));
  if (n >= N) return;
  const float4* p = reinterpret_cast<const float4*>(ws + (long)m * Np + n);
  const long slice = (long)Mp * Np / 4;
  float4 sum = p[0];
#pragma unroll 4
  for (int r = 1; r < splits; ++r) {
    const float4 v = p[r * slice];
    sum = make_float4(__fadd_rn(sum.x, v.x), __fadd_rn(sum.y, v.y), __fadd_rn(sum.z, v.z),
                      __fadd_rn(sum.w, v.w));
  }
  TO* dst = out + (long)m * N + n;
  const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n + c < N) dst[c] = from_f32<TO>(s4[c]);
}

// ---- the plan: how many depth ranges -------------------------------------

struct Plan {
  int chunk, splits;  // depth values per range (whole stages); ranges
};

inline long cdiv(long a, long b) { return (a + b - 1) / b; }

// Cycles of the busiest SM, in a model fitted to launch/gemm_probe.py
// --f32 on the H100 (PERF.md): its c = ceil(CTAs / SMs) CTAs each do
// 64 x 64 x range FMAs and load (64 + 64) x range fp32 values. FMAs run at
// 128 a clock once kSaturate warps are resident (at most kResident CTAs of
// 4 warps each: registers and the 36 KB ring allow that many), in
// proportion below. Loads and the split's workspace (written, then read by
// the second pass) move kBytes a clock per SM; the second pass also costs
// kPassClocks.
constexpr double kBytes = 16.0;
constexpr double kPassClocks = 2000.0;
constexpr int kSaturate = 12, kResident = 4;
constexpr int kMaxSplits = 64;

// Every range is a whole number of stages: per = stages per range, from
// all of the depth down to one stage, so ranges start on stage
// boundaries; `unit` > 1 (a tap's stages, the conv) keeps ranges that are
// whole taps or whole fractions of one. The cheapest plan wins, a tie the
// one with fewer splits.
inline Plan plan(int M, int N, int depth, int sms, int unit) {
  using T = Tile;
  const long tiles = cdiv(M, T::BM) * cdiv(N, T::BN);
  const int stages = static_cast<int>(cdiv(depth, T::BK));
  Plan best{stages * T::BK, 1};
  double best_cost = 1e300;
  for (int per = stages; per >= 1; --per) {
    const int splits = static_cast<int>(cdiv(stages, per));
    if (splits > kMaxSplits) break;
    if (unit > 1 && per % unit != 0 && unit % per != 0) continue;
    const double range = double(per) * T::BK;
    const long c = cdiv(tiles * splits, sms);
    const double warps = double(c < kResident ? c : kResident) * T::kThreads / 32;
    const double rate = warps < kSaturate ? warps / kSaturate : 1.0;
    double cost = c * (double(T::BM) * T::BN * range / 128.0 / rate +
                       double(T::BM + T::BN) * range * 4.0 / kBytes);
    if (splits > 1) cost += double(splits) * tiles * T::BM * T::BN * 8.0 / (kBytes * sms) + kPassClocks;
    if (cost < best_cost) {
      best_cost = cost;
      best = Plan{per * T::BK, splits};
    }
  }
  return best;
}

// The second pass where the plan split the depth; returns the first launch
// error of the two passes (0: both launched).
template <typename TO>
int finish(const float* ws, TO* out, int M, int N, int Mp, int Np, int splits, cudaStream_t s) {
  int err = static_cast<int>(cudaGetLastError());
  if (err || splits == 1) return err;
  reduce_splits<TO><<<static_cast<unsigned>(cdiv((long)M * (Np / 4), 256)), 256, 0, s>>>(
      ws, out, M, N, Mp, Np, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace os_tile
