// Flash-attention forward (GQA, causal, per-batch kv_valid), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention.py::_mha_kernel. It
// computes the same function: q (B,Sq,H,D) against k, v (B,Sk,KV,D), query
// head h reading KV head h / G; key kpos is visible to query row qpos iff
// kpos < kv_valid[b] (and kpos < Sk) and, when causal, qpos >= kpos. The
// softmax is online in fp32, masked keys get probability exactly 0, P is
// cast to V's dtype before the PV product (attention.py:68), and the
// denominator is floored at 1e-30, so fully masked rows come out 0. A null
// kv_valid means all Sk keys. q_off (>= 0) is the absolute position of query
// row 0: causal row i sees keys <= q_off + i, the suffix-only prefill
// against a cached prefix (the JAX package's layers.flash_attention
// q_offset); 0 is the TPU kernel's function. It moves each q block's key
// range, its mask and its tile skips; the summation order of an output stays
// one.
//
// What bounds it on this card: operations. At Sq = Sk = 1024 a causal head
// does ~128 FLOPs per byte of q/k/v, so the least time is the causal FLOPs
// over the tensor cores' 989 TFLOP/s (bf16).
//
// bf16: one kernel on the tensor cores (mha_wgmma_kernel). A CTA owns 64
// query rows of one head: one consumer warpgroup (128 threads) and one
// producer warp. The producer loads Q once and then keeps a ring of two
// 64-key K/V stages in flight with TMA, each stage completing on an
// mbarrier and released by the consumers on another. K and V rows of one
// KV head are strided rows of (B, Sk, KV, D): a 4-D tensor map with box
// (D, 1, 64, 1) reads them in place (no packed copy), zero-filling rows past
// Sk and Sq. S = Q K^T runs on wgmma with both operands in swizzled shared
// memory (K in its natural (key, D) layout is K-major for B); the softmax
// runs in registers (row max and sum over the 4 lanes of a row, scale
// folded into exp2f); P goes to bf16 in registers as the A operand of
// O += P V, V in its natural layout being MN-major (transpose bit). O stays
// fp32 in registers until the epilogue. Swizzle per head dim: 32 B (D=16),
// 64 B (32), 128 B (64), two 128-B column blocks (128). Under causal
// masking the last q blocks see the most keys; the grid launches them
// first, so the long CTAs do not start on a card that is already draining.
// What bounds it now: the consumer's serial chain, not the tensor cores'
// rate. It runs S, softmax and PV of a tile in series (each wgmma group is
// waited for before the softmax reads it), and at S = 1024 the device time
// is about the heaviest causal CTA's 16 tiles in a row (its partners
// finish early; PERF.md has the numbers); a second CTA on the SM slows
// that chain, and with 2 heads (one CTA an SM) it runs faster. Tried on
// the H100 in throwaway builds and not kept, each correct, none faster by
// more than a few percent at S <= 1024 and some slower at 2048: 3 or 4
// K/V stages, two S accumulator chains, 128-key tiles,
// S of the next tile issued before the softmax, the keys of a q block
// split over two warpgroups of the CTA or over a 2-CTA cluster (merged
// through distributed shared memory), and K/V tiles multicast to the two
// heads of a cluster. Next: two consumer warpgroups in ping-pong on one
// q block of 128 rows, as FlashAttention-3 does.
//
// fp32: the FMA kernel (mha_f32_kernel). It stays on the FMA units on
// purpose: TF32 tensor cores keep ~3 decimal digits and would miss the fp32
// row tolerance (1e-4 of the row's largest output).
// What bounds it on this card: operations, the causal FLOPs over the 67
// TFLOP/s FMA peak: 0.0160 ms at the kernel bench's B1 S1024 H8 KV2 D64,
// 0.0642 ms at the serving heads (H16 D128). The first port's kernel
// reached 8.9% of the first: one CTA per 64-row q block (128 CTAs, the
// causal heaviest 16 tiles against a mean of 8.5, the light ones launched
// first), 8 scalar shared loads per 16 FMAs, S and P through shared
// memory with one warp per row doing the softmax, four barriers a tile,
// no copy in flight.
// The design:
// - The work is laid out on the host from shapes (attention.f32_plan,
//   f32_ctas): a CTA of 8 warps owns q blocks of 16 RG rows, RG row groups
//   x 8 / RG key splits. Causal, CTA x takes blocks x and n - 1 - x in
//   turn, so every CTA sweeps the same number of keys to within a round.
//   The bench row takes 32-row blocks (128 CTAs of 9 rounds); the serving
//   heads 64-row blocks (128 CTAs of 17 rounds): one CTA an SM, 8 warps.
// - Register tiles: a lane holds S for 4 rows x 4 keys and O for 4 rows x
//   D / 8 columns. S takes 8 float4 reads per 64 FMAs (Q and K rows padded
//   so that a quarter-warp's 8 rows cover the 32 banks), P V 3 per 32.
// - The softmax stays in registers: a row's 32 scores are on the 8 lanes
//   of a quarter-warp (max by 3 shuffles, scale folded into ex2). P goes
//   to the warp's own P^T in shared memory (a __syncwarp, no barrier), so
//   that P V reads 4 rows' P as one float4.
// - K and V come through a 2-stage cp.async ring of rounds (KS x 32 keys),
//   rows past the block's keys zero-filled; one barrier a round. The next
//   q block's Q and first stage are copied while this one merges.
// - The key splits' partials (m, l, O) meet in shared memory and are
//   merged in ascending split order: one order per output, so two runs
//   give the same bits; no atomics.
// What it reaches (launch/mha_pool_probe.py, device ms, H100 80GB HBM3 at
// 700 W; the first port's kernel in brackets): the bench row 0.0417 (38% of its
// bound; 0.1810), the serving heads 0.1296 (50%; 0.4710), a ragged Sq =
// Sk = 100 at the serving heads 0.0264 (0.0406). 128-202 registers a
// thread (202 at D = 128), no spills.
// What bounds it now, from builds that drop one part (bench row, before
// the copy loop was streamlined, 0.0460): without P V 0.0340, without
// the K/V copies 0.0412, without Q's reloads 0.0434. The FMAs of an SM's
// 9 rounds (8 warps x 2048 a round) take 0.019 ms at the FMA peak the
// bound uses; the rest is rounds with idle key splits (a causal pair
// holds 33 tiles for 4 splits: 9 rounds for 8.25 rounds' work), a barrier
// a round at 8 warps an SM, the merge and the copies.
// Tried on the card and not kept (same probe, bench row unless said):
// - 64-row blocks in 2 splits at the bench row (half the CTAs): 0.0709;
// - P from the lanes holding it by 4 shuffles a key: 0.0497 against
//   0.0467 through P^T; exp2f in place of ex2: 0.0460 against 0.0458;
// - the copy loop dividing each chunk's index: 0.0460 against 0.0416.
// Not built: 16 warps an SM. The bench row's 8,192 query rows are 512
// warps' rows of 16 on 132 SMs, so more warps means more key splits a
// round, and two stages of 8 splits (256 keys) take 270 KB at D = 64;
// at 168-202 registers a thread (D >= 64) 16 warps would not fit the
// register file either. Nor 3xTF32 on mma.sync: 3 m16n8k8 products per
// fp32 product, 192 a warp tile, at mma.sync's share of the tensor cores'
// rate, against 2048 FMAs.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cvt.cuh"
#include "hopper.cuh"
#include "tc_tile.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ===========================================================================
// fp32: FMA kernel (cp.async ring, S and P in registers, keys split over warps)
// ===========================================================================

constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Keys = 32;  // keys of one warp's tile

// A CTA of 8 warps owns a q block of BQ = 16 RG query rows of one head: RG
// row groups of 16 rows x KS = 8 / RG key splits. A round stages KS tiles of
// 32 keys; warp (rg, ks) takes row group rg against tile ks. RG is the
// launcher's plan (attention.f32_plan): 4, or 2 where 64-row blocks leave
// SMs idle (D <= 64 only: a round of 128 keys at D = 128 would not fit twice
// in shared memory).
template <int D, int RG>
struct F32Geo {
  static constexpr int KS = kF32Warps / RG;
  static constexpr int BQ = 16 * RG;
  static constexpr int kRoundKeys = KS * kF32Keys;
  // Q and K rows padded by 4 floats: the float4 reads of 8 consecutive rows
  // (one quarter-warp) cover all 32 banks. V is read along its rows.
  static constexpr int QP = D + 4, KP = D + 4;
  static constexpr int VW = D >= 32 ? 4 : 2;  // a thread's O columns come VW at a time,
  static constexpr int NV = D / (8 * VW);     // NV such vectors
  // P^T of each warp's tile: key kk's row holds the tile's 16 rows, the
  // 4 of lane group ty at 4 ty .. 4 ty + 3; padded so that 8 keys' rows
  // stored at one column cover 32 banks
  static constexpr int PP = 20;
  // shared: Q, two stages of K and V, then P^T of the 8 warps
  static constexpr int kQ = BQ * QP, kK = kRoundKeys * KP, kStage = kK + kRoundKeys * D;
  static constexpr int kP = kF32Keys * PP;
  static constexpr size_t kSmem = sizeof(float) * (kQ + 2 * kStage + kF32Warps * kP);
  static_assert(kStage >= KS * BQ * (D + 2), "the merge's partials fit in one stage");
};

// kRows rows of D floats from a (rows, D) fp32 view with row stride
// `stride` -> shared rows of pitch `pitch`, by 16-byte cp.async; rows at or
// past `limit` are zero-filled and not read. A thread copies one column
// chunk, tid % (D / 4), of rows tid / (D / 4) + t RP: its addresses step by
// constants, so a copy costs a compare, a select and an add.
template <int D, int kRows>
__device__ __forceinline__ void copy_rows(float* dst, int pitch, const float* src, long stride,
                                          int row0, int limit) {
  constexpr int kVecs = D / 4, RP = kF32Threads / kVecs, kSteps = (kRows + RP - 1) / RP;
  const int r = threadIdx.x / kVecs, c = (threadIdx.x % kVecs) * 4;
  const float* s = src + (row0 + r) * stride + c;
  float* d = dst + r * pitch + c;
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    if (kRows % RP != 0 && r + t * RP >= kRows) break;
    const bool ok = row0 + r + t * RP < limit;
    tc_tile::cp_async16(d + t * RP * pitch, ok ? s + t * RP * stride : src, ok);
  }
}

// 2^x by the MUFU unit alone (max relative error 2^-22; a result below
// 2^-126 flushes to 0, a probability the fp32 tolerance cannot see):
// exp2f's guard for subnormal results cost 1.3% at the kernel bench's row
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warp's tile: its 16 query rows against 32 keys from k0. Lane (ty, tx)
// = (lane / 8, lane % 8) holds S for rows ty + 4i and keys tx + 8j (i, j <
// 4), and O for rows ty + 4i and columns (8u + tx) VW + e. q_s, k_s and v_s
// point at the warp's rows and keys, p_s at its P^T; r0 is the absolute
// position of its first query row (q_off included).
template <int D, int RG>
__device__ __forceinline__ void f32_tile(float (&o)[4][D / 8], float (&m)[4], float (&l)[4],
                                         const float* q_s, const float* k_s, const float* v_s,
                                         float* p_s, int r0, int k0, int valid, int causal,
                                         float scale_log2) {
  using G = F32Geo<D, RG>;
  const int ty = threadIdx.x % 32 / 8, tx = threadIdx.x % 8;

  // S = Q K^T: per 4 depth values, 8 float4 reads for 64 FMAs
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 4 * i) * G::QP + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = *reinterpret_cast<const float4*>(k_s + (tx + 8 * j) * G::KP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
      }
  }

  // The kernels' one predicate; masked scores -> -inf, whose exp2f is 0.
  // A tile wholly visible to all 16 rows skips it.
  if (k0 + kF32Keys > valid || (causal && k0 + kF32Keys - 1 > r0)) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 8 * j, qpos = r0 + ty + 4 * i;
        if (kpos >= valid || (causal && qpos < kpos)) s[i][j] = -CUDART_INF_F;
      }
  }

  // online softmax in registers: a row's 32 scores are on the 8 lanes of
  // one quarter-warp; l keeps this lane's share of the denominator; -inf
  // (masked) gives ex2 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float corr = ex2((m[i] - mx) * scale_log2);
    const float m_scaled = mx * scale_log2;
    m[i] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = ex2(fmaf(s[i][j], scale_log2, -m_scaled));
      sum += s[i][j];
    }
    l[i] = l[i] * corr + sum;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[i][c] *= corr;
  }

  // O += P V, keys in ascending order. P goes through the warp's P^T in
  // shared memory, so that a lane reads its 4 rows' P of key kk as one
  // float4 (4 shuffles from the lanes holding them took 6% longer at the
  // kernel bench's row); V's row kk comes as NV vectors.
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(p_s + (tx + 8 * j) * G::PP + 4 * ty) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < kF32Keys; ++kk) {
    const float4 pk = *reinterpret_cast<const float4*>(p_s + kk * G::PP + 4 * ty);
    const float p[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
    for (int u = 0; u < G::NV; ++u) {
      const float* vr = v_s + kk * D + (8 * u + tx) * G::VW;
      float vv[G::VW];
      if constexpr (G::VW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(vr);
        vv[0] = t.x, vv[1] = t.y, vv[2] = t.z, vv[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(vr);
        vv[0] = t.x, vv[1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < G::VW; ++e)
          o[i][u * G::VW + e] = fmaf(p[i], vv[e], o[i][u * G::VW + e]);
    }
  }
  __syncwarp();  // P^T is read before the warp's next tile writes it
}

// grid (x, H, B): causal, CTA x takes q blocks x and n - 1 - x (grid x =
// ceil(n / 2)), so that every CTA sweeps about the same number of keys;
// otherwise block x alone (grid x = n).
template <int D, int RG>
__global__ void __launch_bounds__(kF32Threads, 1) mha_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ kv_valid, float* __restrict__ out, int Sq, int Sk, int H, int KV,
    float scale_log2, int causal, int q_off) {
  using G = F32Geo<D, RG>;
  extern __shared__ __align__(16) float f32_smem[];
  float* q_s = f32_smem;
  float* ring = q_s + G::kQ;  // stage s: K at ring + s kStage, V kK further
  float* p_s = ring + 2 * G::kStage + (threadIdx.x / 32) * G::kP;  // this warp's P^T

  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % RG, ks = warp / RG;
  const int ty = lane / 8, tx = lane % 8;
  const int valid = max(kv_valid ? min(kv_valid[b], Sk) : Sk, 0);
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  const float* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const float* kb = k + (long)b * Sk * kv_stride + (long)kh * D;
  const float* vb = v + (long)b * Sk * kv_stride + (long)kh * D;
  float* ob = out + (long)b * Sq * q_stride + (long)h * D;

  // keys [key0, key0 + a round) of K and V -> stage st; rows at or past
  // kv_end are zero-filled
  auto load_stage = [&](int st, int key0, int kv_end) {
    float* dst = ring + st * G::kStage;
    copy_rows<D, G::kRoundKeys>(dst, G::KP, kb, kv_stride, key0, kv_end);
    copy_rows<D, G::kRoundKeys>(dst + G::kK, D, vb, kv_stride, key0, kv_end);
  };
  const int n_blocks = (Sq + G::BQ - 1) / G::BQ;
  const int first = blockIdx.x, second = causal ? n_blocks - 1 - first : first;
  const int passes = second > first ? 2 : 1;
  auto block_end = [&](int q0) { return causal ? min(valid, q_off + q0 + G::BQ) : valid; };
  // a pass's Q and first stage are in flight before it starts: the next
  // pass's are issued while this one merges
  copy_rows<D, G::BQ>(q_s, G::QP, qb, q_stride, first * G::BQ, Sq);
  if (block_end(first * G::BQ) > 0) load_stage(0, 0, block_end(first * G::BQ));
  tc_tile::cp_async_commit();

  for (int pass = 0; pass < passes; ++pass) {
    const int q0 = (pass ? second : first) * G::BQ;
    const int kv_end = block_end(q0);
    const int rounds = (kv_end + G::kRoundKeys - 1) / G::kRoundKeys;
    const int r0 = q0 + 16 * rg;  // this warp's first query row
    const int a0 = q_off + r0;    // and its absolute position
    float o[4][D / 8], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNeg;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) o[i][c] = 0.f;
    }
    for (int r = 0; r < rounds; ++r) {
      tc_tile::cp_async_wait<0>();
      __syncthreads();  // round r's stage is in; every warp is done with round r - 1's
      if (r + 1 < rounds) load_stage((r + 1) & 1, (r + 1) * G::kRoundKeys, kv_end);
      tc_tile::cp_async_commit();
      const int k0 = r * G::kRoundKeys + ks * kF32Keys;
      const float* st = ring + (r & 1) * G::kStage;
      if (k0 < kv_end && r0 < Sq && (!causal || k0 <= a0 + 15))
        f32_tile<D, RG>(o, m, l, q_s + 16 * rg * G::QP, st + ks * kF32Keys * G::KP,
                        st + G::kK + ks * kF32Keys * D, p_s, a0, k0, valid, causal,
                        scale_log2);
    }

    tc_tile::cp_async_wait<0>();
    __syncthreads();  // every warp is done with Q and both stages
    if (pass + 1 < passes) {
      copy_rows<D, G::BQ>(q_s, G::QP, qb, q_stride, second * G::BQ, Sq);
      if (block_end(second * G::BQ) > 0) load_stage(0, 0, block_end(second * G::BQ));
    }
    tc_tile::cp_async_commit();

    // merge the KS partials of each row in ascending ks, through stage 1:
    // one order, so two runs give the same bits
    float* part = ring + G::kStage;             // KS x BQ x D partial outputs,
    float* part_ml = part + G::KS * G::BQ * D;  // and (m, l) per partial row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
      const int row = ks * G::BQ + 16 * rg + ty + 4 * i;
      float* po = part + row * D;
#pragma unroll
      for (int u = 0; u < G::NV; ++u) {
        float* dst = po + (8 * u + tx) * G::VW;
        const float* src = &o[i][u * G::VW];
        if constexpr (G::VW == 4)
          *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
      }
      if (tx == 0) {
        part_ml[2 * row] = m[i];
        part_ml[2 * row + 1] = l[i];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < G::BQ * (D / 4); e += kF32Threads) {
      const int row = e / (D / 4), c = (e % (D / 4)) * 4;
      if (q0 + row >= Sq) continue;
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < G::KS; ++w) mx = fmaxf(mx, part_ml[2 * (w * G::BQ + row)]);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      float den = 0.f;
#pragma unroll
      for (int w = 0; w < G::KS; ++w) {
        const int pr = w * G::BQ + row;
        const float wt = exp2f((part_ml[2 * pr] - mx) * scale_log2);
        den += part_ml[2 * pr + 1] * wt;
        const float4 pv = *reinterpret_cast<const float4*>(part + pr * D + c);
        acc.x += pv.x * wt;
        acc.y += pv.y * wt;
        acc.z += pv.z * wt;
        acc.w += pv.w * wt;
      }
      den = fmaxf(den, 1e-30f);  // a fully masked row: 0 / 1e-30 = 0
      *reinterpret_cast<float4*>(ob + (q0 + row) * q_stride + c) =
          make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
    }
    // the next pass's first barrier orders these reads of stage 1 before
    // its copies into it
  }
}

template <int D, int RG>
int launch_f32(const void* q, const void* k, const void* v, const int* kv_valid, void* out, int B,
               int Sq, int Sk, int H, int KV, float scale, int causal, int q_off,
               cudaStream_t stream) {
  using G = F32Geo<D, RG>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(mha_f32_kernel<D, RG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int n_blocks = (Sq + G::BQ - 1) / G::BQ;
  const dim3 grid(causal ? (n_blocks + 1) / 2 : n_blocks, H, B);
  mha_f32_kernel<D, RG><<<grid, kF32Threads, G::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      kv_valid, static_cast<float*>(out), Sq, Sk, H, KV, scale * 1.4426950408889634f, causal,
      q_off);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// bf16: tensor-core kernel (TMA + mbarrier ring, wgmma)
// ===========================================================================

constexpr int kBQ = 64;            // query rows per CTA: one wgmma M
constexpr int kBK = 64;            // keys per stage: the N of S = Q K^T
constexpr int kStages = 2;         // K/V stages in flight
constexpr int kConsumers = 128;    // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp

template <int D>
struct Geo {
  static constexpr int kBox = D < 64 ? D : 64;   // elements per TMA box row
  static constexpr int kRow = kBox * 2;          // bytes per row = swizzle span
  static constexpr int kBlocks = D / kBox;       // column blocks (2 at D = 128)
  static constexpr uint32_t kSwizzle = kRow == 128 ? 1 : (kRow == 64 ? 2 : 3);
  static constexpr int kGroup = 8 * kRow;        // bytes of 8 rows: the SBO
  static constexpr int kQBlock = kBQ * kRow;     // bytes of one Q column block
  static constexpr int kKVBlock = kBK * kRow;    // bytes of one K or V column block
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;   // one K (or V) stage
  // Q, then K and V stages, each on a 1024-byte boundary; then the barriers
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// S (64 x kBK) = Q (64 x D) K^T for one stage: D/16 wgmma k-steps.
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[kBK / 2], const uint8_t* q_s,
                                           const uint8_t* k_s) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = (kk * 16) / G::kBox, off = ((kk * 16) % G::kBox) * 2;
    const uint64_t a = hopper::desc(q_s + blk * G::kQBlock + off, 16, G::kGroup, G::kSwizzle);
    const uint64_t b = hopper::desc(k_s + blk * G::kKVBlock + off, 16, G::kGroup, G::kSwizzle);
    hopper::wgmma_ss_n64(s, a, b, kk > 0);
  }
}

// O (64 x D) += P (64 x kBK, bf16 registers) V (kBK x D, MN-major).
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&p)[kBK / 16][4],
                                           const uint8_t* v_s) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t b = hopper::desc(v_s + kk * 16 * G::kRow, G::kKVBlock, G::kGroup, G::kSwizzle);
    if constexpr (D == 16) hopper::wgmma_rs_n16(o, p[kk], b);
    if constexpr (D == 32) hopper::wgmma_rs_n32(o, p[kk], b);
    if constexpr (D == 64) hopper::wgmma_rs_n64(o, p[kk], b);
    if constexpr (D == 128) hopper::wgmma_rs_n128(o, p[kk], b);
  }
}

// Register layout of a wgmma accumulator (64 x N, fp32) in the consumer
// warpgroup: thread (warp w, lane l) holds rows 16w + l/4 (half 0) and
// 16w + l/4 + 8 (half 1); element 4j + 2*half + e is column 8j + 2(l%4) + e.
// The S accumulator of keys [16kk, 16kk + 16) is then, pairwise, exactly
// the A fragment of a k16 step of P V.
template <int D>
__global__ void __launch_bounds__(kThreads, 2) mha_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const int* __restrict__ kv_valid,
    __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H, int KV, float scale_log2,
    int causal, int q_off) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + G::kQBytes;
  uint8_t* v_s = k_s + kStages * G::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(q_s + G::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal blocks first
  const int kh = h / (H / KV);
  const int valid = max(kv_valid ? min(kv_valid[b], Sk) : Sk, 0);
  const int a0 = q_off + q0;                          // absolute position of row 0
  const int kv_end = causal ? min(valid, a0 + kBQ) : valid;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp: one thread issues every copy
    if (threadIdx.x == kConsumers) {
      hopper::mbar_expect_tx(q_full, G::kQBytes);
      for (int c = 0; c < G::kBlocks; ++c)
        hopper::tma_load_4d(q_s + c * G::kQBlock, &q_map, q_full, c * G::kBox, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[s], (t / kStages - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * G::kKVBytes);
        uint8_t* ks = k_s + s * G::kKVBytes;
        uint8_t* vs = v_s + s * G::kKVBytes;
        for (int c = 0; c < G::kBlocks; ++c) {
          hopper::tma_load_4d(ks + c * G::kKVBlock, &k_map, &full[s], c * G::kBox, kh, t * kBK, b);
          hopper::tma_load_4d(vs + c * G::kKVBlock, &v_map, &full[s], c * G::kBox, kh, t * kBK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * 16 + lane / 4;  // + 8 for half 1
  const int col0 = 2 * (lane % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg};  // running row max of the raw scores
  float l[2] = {0.f, 0.f};    // this thread's share of the running denominator

  float sc[kBK / 2];
  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    hopper::wgmma_fence();
    qk_product<D>(sc, q_s, k_s + s * G::kKVBytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(sc);

    // Mask with the kernels' one predicate; masked scores -> -inf, whose
    // exp2f is exactly 0. A tile wholly inside the visible range (every
    // tile but the causal diagonal and the one holding kv_valid) skips it.
    const int k0 = t * kBK;
    if (k0 + kBK > valid || (causal && k0 + kBK - 1 > a0)) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + col0 + e, qpos = a0 + row0 + 8 * half;
            const bool ok = kpos < valid && (!causal || qpos >= kpos);
            if (!ok) sc[4 * j + 2 * half + e] = -CUDART_INF_F;
          }
    }
    float corr[2], m_scaled[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = m[half];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * half], sc[4 * j + 2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[half] = exp2f((m[half] - mx) * scale_log2);
      m[half] = mx;
      m_scaled[half] = mx * scale_log2;
      l[half] *= corr[half];
    }
    uint32_t p[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float p0 = exp2f(fmaf(sc[4 * j + 2 * half], scale_log2, -m_scaled[half]));
        const float p1 = exp2f(fmaf(sc[4 * j + 2 * half + 1], scale_log2, -m_scaled[half]));
        l[half] += p0 + p1;  // the denominator keeps fp32; PV takes P in bf16
        p[j / 2][2 * (j % 2) + half] = cvt::pack_bf16x2(p0, p1);
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        o[4 * j + 2 * half] *= corr[half];
        o[4 * j + 2 * half + 1] *= corr[half];
      }

    hopper::wgmma_fence();
    pv_product<D>(o, p, v_s + s * G::kKVBytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(o);
    hopper::mbar_arrive(&empty[s]);  // this thread is done with stage s
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lsum = l[half];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int qpos = q0 + row0 + 8 * half;
    if (qpos >= Sq) continue;
    const float den = fmaxf(lsum, 1e-30f);
    __nv_bfloat16* orow = out + (((long)b * Sq + qpos) * H + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          cvt::pack_bf16x2(o[4 * j + 2 * half] / den, o[4 * j + 2 * half + 1] / den);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query: no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, heads, D) bf16 rows as a 4-D map (D, heads, S, B) with box
// (box, 1, rows, 1) and the given swizzle.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int box,
              int rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const int* kv_valid, void* out,
                 int B, int Sq, int Sk, int H, int KV, float scale, int causal, int q_off,
                 cudaStream_t stream) {
  using G = Geo<D>;
  const CUtensorMapSwizzle sw = G::kRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::kRow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, Sq, H, D, G::kBox, kBQ, sw) ||
      !make_map(&km, k, B, Sk, KV, D, G::kBox, kBK, sw) ||
      !make_map(&vm, v, B, Sk, KV, D, G::kBox, kBK, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(mha_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  mha_wgmma_kernel<D><<<grid, kThreads, G::kSmem, stream>>>(
      qm, km, vm, kv_valid, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV,
      scale * 1.4426950408889634f, causal, q_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32 (FMA kernel), 1 bfloat16 (tensor-core kernel); D in
// {16, 32, 64, 128} (the tests', the kernel benchmark's and qwen2.5-3b's
// head dims). kv_valid: a (B,) int32 device array, or null for all Sk keys.
// q_off: the absolute position of query row 0 (>= 0; causal masking only).
// rg: float32 only, the row groups of 16 query rows a CTA owns
// (attention.f32_plan): 4, or 2 for D <= 64. Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int mha_fwd_launch_off(const void* q, const void* k, const void* v,
                                  const void* kv_valid, void* out, int B, int Sq, int Sk, int H,
                                  int KV, int D, int dtype, int causal, int q_off, float scale,
                                  int rg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* valid = static_cast<const int*>(kv_valid);
  if (q_off < 0) return static_cast<int>(cudaErrorInvalidValue);
#define MHA_F32(DD, RR) \
  launch_f32<DD, RR>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, q_off, s)
#define MHA_BF16(DD) \
  launch_wgmma<DD>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, q_off, s)
  if (dtype == 0) {
    if (rg == 4) {
      switch (D) {
        case 16: return MHA_F32(16, 4);
        case 32: return MHA_F32(32, 4);
        case 64: return MHA_F32(64, 4);
        case 128: return MHA_F32(128, 4);
      }
    } else if (rg == 2) {
      switch (D) {
        case 16: return MHA_F32(16, 2);
        case 32: return MHA_F32(32, 2);
        case 64: return MHA_F32(64, 2);
      }
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return MHA_BF16(16);
      case 32: return MHA_BF16(32);
      case 64: return MHA_BF16(64);
      case 128: return MHA_BF16(128);
    }
  }
#undef MHA_F32
#undef MHA_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

// mha_fwd_launch_off with q_off = 0: the TPU kernel's function, under the
// C signature of the trees before the offset (launch/mha_pool_probe.py
// --port-src launches an older tree's library through it, and so do the
// host-cost split and the bare-launch tests).
extern "C" int mha_fwd_launch(const void* q, const void* k, const void* v, const void* kv_valid,
                              void* out, int B, int Sq, int Sk, int H, int KV, int D, int dtype,
                              int causal, float scale, int rg, void* stream) {
  return mha_fwd_launch_off(q, k, v, kv_valid, out, B, Sq, Sk, H, KV, D, dtype, causal, 0, scale,
                            rg, stream);
}
