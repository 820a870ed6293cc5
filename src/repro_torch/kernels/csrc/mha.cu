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
// kv_valid means all Sk keys.
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
// fp32: the FMA kernel (mha_fma_kernel), one CTA per (64-row q block, q
// head), a 16x16 thread grid with 4x4 register tiles, K and V read into
// shared memory as fp32. It stays on the FMA units on purpose: TF32 tensor
// cores keep ~3 decimal digits and would miss the fp32 row tolerance (1e-4
// of the row's largest output).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cvt.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ===========================================================================
// fp32: FMA kernel
// ===========================================================================

constexpr int kFmaThreads = 256;
constexpr int kFmaBQ = 64;  // query rows per CTA
constexpr int kFmaBK = 64;  // keys per tile

// rows [row0, row0 + n) of a (rows, D) fp32 view with row stride `stride`
// elements -> shared, pitch `pitch`; rows at or past `limit` read as 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* src, long stride,
                                          int row0, int n, int limit) {
  constexpr int vecs = D / 4;
  for (int i = threadIdx.x; i < n * vecs; i += blockDim.x) {
    const int r = i / vecs, c = (i % vecs) * 4;
    float* d = dst + r * pitch + c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) v = *reinterpret_cast<const float4*>(src + (long)(row0 + r) * stride + c);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads) mha_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ kv_valid, float* __restrict__ out, int Sq, int Sk, int H, int KV,
    float scale, int causal) {
  constexpr int QP = D + 1, KP = D + 1, SP = kFmaBK + 1;  // padded pitches
  constexpr int NR = kFmaBQ / 16, NS = kFmaBK / 16, NO = D / 16;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                // kFmaBQ x QP
  float* k_s = q_s + kFmaBQ * QP;   // kFmaBK x KP
  float* v_s = k_s + kFmaBK * KP;   // kFmaBK x D
  float* p_s = v_s + kFmaBK * D;    // kFmaBQ x SP
  float* m_s = p_s + kFmaBQ * SP;   // kFmaBQ
  float* l_s = m_s + kFmaBQ;        // kFmaBQ
  float* c_s = l_s + kFmaBQ;        // kFmaBQ

  const int q0 = qb * kFmaBQ;
  const int valid = kv_valid ? min(kv_valid[b], Sk) : Sk;
  int kv_end = valid;
  if (causal) kv_end = min(kv_end, q0 + kFmaBQ);
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  load_tile<D>(q_s, QP, q + ((long)b * Sq * H + h) * D, q_stride, q0, kFmaBQ, Sq);
  for (int i = threadIdx.x; i < kFmaBQ; i += blockDim.x) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }
  float acc[NR][NO];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;

  const float* kb = k + ((long)b * Sk * KV + kh) * D;
  const float* vb = v + ((long)b * Sk * KV + kh) * D;
  for (int k0 = 0; k0 < kv_end; k0 += kFmaBK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(k_s, KP, kb, kv_stride, k0, kFmaBK, Sk);
    load_tile<D>(v_s, D, vb, kv_stride, k0, kFmaBK, Sk);
    __syncthreads();

    // S = Q K^T for rows ty + 16i, keys tx + 16j
    float s[NR][NS];
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[NR], kv[NS];
#pragma unroll
      for (int i = 0; i < NR; ++i) qv[i] = q_s[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) kv[j] = k_s[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) p_s[(ty + 16 * i) * SP + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();

    // online softmax, one warp per row, two keys per lane
    for (int r = warp; r < kFmaBQ; r += kFmaThreads / 32) {
      const int qpos = q0 + r;
      float sv[2], pv[2];
      bool ok[2];
      float mx = kNeg;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kpos = k0 + lane + 32 * u;
        ok[u] = kpos < valid && (!causal || qpos >= kpos);
        sv[u] = ok[u] ? p_s[r * SP + lane + 32 * u] : kNeg;
        mx = fmaxf(mx, sv[u]);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        pv[u] = ok[u] ? expf(sv[u] - m_new) : 0.f;
        sum += pv[u];
        p_s[r * SP + lane + 32 * u] = pv[u];
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * corr + P V for rows ty + 16i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float pv[NR], vv[NO];
#pragma unroll
      for (int i = 0; i < NR; ++i) pv[i] = p_s[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NO; ++j) vv[j] = v_s[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NO; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    if (qpos >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    float* o = out + (((long)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) o[tx + 16 * j] = acc[i][j] / l;
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const int* kv_valid, void* out, int B,
               int Sq, int Sk, int H, int KV, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * ((size_t)kFmaBQ * (D + 1) + (size_t)kFmaBK * (D + 1) +
                                           (size_t)kFmaBK * D + (size_t)kFmaBQ * (kFmaBK + 1) +
                                           3 * kFmaBQ);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(mha_fma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((Sq + kFmaBQ - 1) / kFmaBQ, H, B);
  mha_fma_kernel<D><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      kv_valid, static_cast<float*>(out), Sq, Sk, H, KV, scale, causal);
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
    int causal) {
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
  const int kv_end = causal ? min(valid, q0 + kBQ) : valid;
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
    if (k0 + kBK > valid || (causal && k0 + kBK - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + col0 + e, qpos = q0 + row0 + 8 * half;
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
                 int B, int Sq, int Sk, int H, int KV, float scale, int causal,
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
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32 (FMA kernel), 1 bfloat16 (tensor-core kernel); D in
// {16, 32, 64, 128} (the tests', the kernel benchmark's and qwen2.5-3b's
// head dims). kv_valid: a (B,) int32 device array, or null for all Sk keys.
// Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int mha_fwd_launch(const void* q, const void* k, const void* v, const void* kv_valid,
                              void* out, int B, int Sq, int Sk, int H, int KV, int D, int dtype,
                              int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* valid = static_cast<const int*>(kv_valid);
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_fma<16>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, s);
      case 32: return launch_fma<32>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, s);
      case 64: return launch_fma<64>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, s);
      case 128: return launch_fma<128>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_wgmma<16>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, s);
      case 32: return launch_wgmma<32>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, s);
      case 64: return launch_wgmma<64>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, s);
      case 128:
        return launch_wgmma<128>(q, k, v, valid, out, B, Sq, Sk, H, KV, scale, causal, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
