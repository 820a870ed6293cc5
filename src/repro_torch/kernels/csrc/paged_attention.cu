// Paged flash-decode over a shared KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_paged_kernel.
// It computes the same function: for request b and KV head h, the T*G query
// rows (row r = t*G + g holds query token t of head h*G + g) attend to the
// request's keys, found page by page through block_table[b, :]. Row t sits at
// absolute position base + t (base = lengths[b] - T) and sees keys at
// positions < base + t + 1 (and > base + t - window when window > 0). The
// softmax is online in fp32: masked keys get probability exactly 0, the
// denominator is floored at 1e-30. int8 pools are dequantized (x * kv_scale
// / 127) as their values are read into registers.
//
// What bounds it on this card: bytes. Each K/V element is used by T*G query
// rows only (8 at the serving shape, G = 8 and T = 1), far below the ~295
// operations per byte at which an H100 stops being memory bound, so the
// least time is the live K/V bytes over 3.35 TB/s: 0.0011 ms at the serving
// batch (B = 8, contexts 237-584, bf16), 0.0101 ms at B = 16 x 2048.
//
// The split. The live pages [first, last) of each (request, KV head) are
// cut into S contiguous ranges, rank r taking pages [first + n*r/S, first +
// n*(r+1)/S), n = last - first: the page sweep, which the TPU ran as a
// sequential grid axis, is spread over S CTAs. S comes from the host's plan
// (paged_attention.py: split_plan), which reads only shapes, never the
// lengths on the device. The S CTAs of a (request, KV head, row tile of 8
// query rows) form one thread-block cluster; each keeps its range's partial
// (m, l, acc) in its own shared memory, and after a cluster barrier every
// rank reads all ranks' partials through distributed shared memory and
// writes its share of the outputs, merging the partials with the
// log-sum-exp rule in rank order (rank 0 first), in fp32. Inside a CTA the
// 4 warps keep their own online softmax states, merged in warp order. One
// summation order per output and no atomics: the same inputs give the same
// bits. A rank whose range is empty contributes m = -1e30, l = 0, acc = 0.
// The split's other design, an fp32 workspace and a second pass that adds
// the partials in rank order (os_tile.cuh's), would need a second launch and
// a torch.empty per call on a path that is host-bound; the cluster needs
// neither, and 8 CTAs a cluster (the portable size) are enough here.
//
// The loads. A CTA walks its range through a ring of shared-memory stages in
// the pool's own dtype, filled ahead with 16-byte cp.async copies (each K/V
// row of one head is D contiguous values, strided by KV*D in the pool; rows
// past the range are zero-filled). Page indices come from a window of the
// request's table row staged in shared memory.
//
// Two bodies. bf16 q over bf16 pools (the serving path) runs on the tensor
// cores: a round of 64 keys fills one stage, each warp takes one 16-key
// tile of it, and with the roles of q and the keys swapped the tile's
// scores are S^T (16 keys x 8 rows) = K Q^T, one mma.sync.m16n8k16 per 16
// head dims with no padded rows; P^T reaches the B operand of O^T (D x 8) =
// V^T P^T through movmatrix, V^T through ldmatrix.trans, and each lane holds
// the softmax state of exactly the rows of its O^T accumulators, so the
// rescaling needs no exchange. P is rounded to bf16 for its product, as in
// mha.cu. Every other pair (fp32 q, fp32 or int8 pools) runs on the FMA
// units, 16 keys a stage, 4 a warp: a lane holds E = D/32 head dims of the 8
// query rows and of its accumulators; the 32 partial dot products (8 rows x
// 4 keys) are summed over the lanes by a transposing butterfly (31
// shuffles) that leaves lane i*4 + j with the score of row i and key j, and
// the probabilities reach every lane through a per-warp scratch in shared
// memory for P V. Above 256 head dims (no model of the repo has them) a
// lane's share of the rows and accumulators would not fit its registers:
// the wide body keeps the query rows and each warp's accumulators in shared
// memory in fp32 and reads the keys and values straight from the pool, a
// warp's lanes on neighbouring head dims of one row, 16 keys a tile and 4 a
// warp as in the FMA body. It takes head dims up to kMaxHeadDim (1438) for
// every pair; the kernel this one replaced sized its shared memory to the
// head dim and stopped near 1200 at 8 query rows.
//
// On an H100 80GB HBM3 at 700 W (device ms from torch.profiler, pools cycled
// past the L2 cache, launch/paged_probe.py; bf16, B = 8 at contexts 242-533
// / B = 16 x 2048): the kernel this one replaced (one CTA per request and
// KV head, a serial page loop) 0.2106-0.2119 / 0.7875-0.7920; this one 0.0119 /
// 0.0233 at the plan's S = 8 / 5, 41-43% of the 0.0101 bound at 2048 and
// set by latency at the serving batch (bound 0.0009). Tried and not kept:
// every pair on the FMA body, 0.0173 / 0.0464, as slow without its copies
// (0.0155 / 0.0447) and 0.0146 / 0.0283 without its arithmetic: each warp's
// chain of shuffles, exponentials and FMAs a tile set the time; the
// tensor-core body with two threads a key row (a warp's copy touching 16
// rows), 0.0105 / 0.0301; the row sources found a round ahead to save the
// barrier, 0.0120 / 0.0241-0.0245 against 0.0119 / 0.0233-0.0234 in the
// same call; the copy loop unrolled by 4, 2-3% faster at B = 8 and 5%
// slower at 2048. Splits at B = 16 x 2048, S = 1, 2, 4, 5, 8: 0.0697,
// 0.0390, 0.0245, 0.0232, 0.0328; at B = 8: 0.0234, 0.0164, 0.0125, 0.0116,
// 0.0120 (the plan takes ceil(132 / CTAs), at most 8).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "tc_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using tc_tile::cp_async16;
using tc_tile::cp_async_commit;
using tc_tile::cp_async_wait;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;       // query rows of one CTA (a row tile)
constexpr int kKeys = 16;      // keys of one warp tile (MMA) or one stage (FMA)
constexpr int kTable = 256;    // block-table entries staged at a time
constexpr int kMaxSplits = 8;  // a cluster's portable size
constexpr float kNeg = -1e30f;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one Hopper CTA may use

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* block_table;
  const int* lengths;
  void* out;
  int T, H, KV, D, page, n_blocks, G, R, n_rt, q_bf16, window;
  float scale, dequant;
};

// This CTA's share of the sweep: pages [pa, first + n*(rank+1)/S) of the
// n live pages [first, last), keys [key_begin, key_end). Pages at or past
// the length hold no live key; with a window, pages with (i+1)*page <=
// base - window + 1 lie wholly below the earliest row's window.
struct Range {
  int base, pa, key_begin, key_end;
};

__device__ __forceinline__ Range live_range(const Args& a, int b, int rank, int S) {
  Range g;
  const int len = a.lengths[b];
  g.base = len - a.T;
  int first = 0;
  if (a.window > 0 && g.base - a.window + 1 > 0) first = (g.base - a.window + 1) / a.page;
  const int last = min(a.n_blocks, (len + a.page - 1) / a.page);
  const int n = max(last - first, 0);
  g.pa = first + n * rank / S;
  g.key_begin = g.pa * a.page;
  g.key_end = min((first + n * (rank + 1) / S) * a.page, len);
  return g;
}

// A window [base, base + kTable) of one table row of n pages, in shared
// memory. The first window starts at page 0, so that its loads need not
// wait for the lengths. cover() is called by every thread of the CTA.
struct TableWindow {
  int* tbl;
  const int* bt;
  int base, n;
  __device__ __forceinline__ void fill() {
    for (int i = threadIdx.x; i < kTable; i += kThreads)
      tbl[i] = base + i < n ? bt[base + i] : 0;
  }
  // pages [lp, lp + span] must lie in the window (uniform across the CTA)
  __device__ __forceinline__ void cover(int lp, int span) {
    if (lp + span >= base + kTable) {
      __syncthreads();  // every reader of the old window is done
      base = lp;
      fill();
      __syncthreads();
    }
  }
  __device__ __forceinline__ long operator[](int lp) const { return tbl[lp - base]; }
};

// The warps' partials (kWarps x {acc [kRows][DP], m [kRows], l [kRows]} at
// wpart, written before the call) -> the CTA's partial at cpart, warps in
// order -> with the other ranks' (through distributed shared memory when S >
// 1), ranks in order -> this rank's share of the outputs. Every thread of
// every rank calls it; rw holds kMaxSplits * kRows + kRows floats. DP = 0:
// rows of a.D.
template <int DP>
__device__ __forceinline__ void merge_store(const Args& a, const float* wpart, float* cpart,
                                            float* rw, int rt, int b, int h) {
  const int dp = DP > 0 ? DP : a.D;
  const int kPart = kRows * dp + 2 * kRows;
  const int S = gridDim.x, rank = blockIdx.x;
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int i = threadIdx.x;
    float m = kNeg;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wpart[w * kPart + kRows * dp + i]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(wpart[w * kPart + kRows * dp + i] - m);
      rw[w * kRows + i] = wt;
      l = fmaf(wpart[w * kPart + kRows * dp + kRows + i], wt, l);
    }
    cpart[kRows * dp + i] = m;
    cpart[kRows * dp + kRows + i] = l;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < kRows * dp; x += kThreads) {
    const int i = x / dp;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s = fmaf(wpart[w * kPart + x], rw[w * kRows + i], s);
    cpart[x] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1)
    cluster.sync();  // every rank's partial is written
  else
    __syncthreads();
  auto part = [&](int q) -> const float* {
    return S > 1 ? cluster.map_shared_rank(cpart, q) : cpart;
  };
  if (threadIdx.x < kRows) {
    const int i = threadIdx.x;
    float M = kNeg;
    for (int q = 0; q < S; ++q) M = fmaxf(M, part(q)[kRows * dp + i]);
    float L = 0.f;
    for (int q = 0; q < S; ++q) {
      const float* pq = part(q);
      const float wt = expf(pq[kRows * dp + i] - M);
      rw[q * kRows + i] = wt;
      L = fmaf(pq[kRows * dp + kRows + i], wt, L);
    }
    rw[kMaxSplits * kRows + i] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int x = rank * kThreads + threadIdx.x; x < kRows * dp; x += S * kThreads) {
    const int i = x / dp, d = x - i * dp;
    const int r = rt * kRows + i;
    if (r >= a.R || d >= a.D) continue;
    float A = 0.f;
    for (int q = 0; q < S; ++q) A = fmaf(part(q)[x], rw[q * kRows + i], A);
    const float o = A / rw[kMaxSplits * kRows + i];
    const int t = r / a.G, g = r - t * a.G;
    const long at = ((long)(b * a.T + t) * a.H + h * a.G + g) * a.D + d;
    if (a.q_bf16)
      static_cast<__nv_bfloat16*>(a.out)[at] = __float2bfloat16(o);
    else
      static_cast<float*>(a.out)[at] = o;
  }
  if (S > 1) cluster.sync();  // no rank leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// bf16 q over bf16 pools: the tensor cores
// ---------------------------------------------------------------------------

template <int DP>
struct MmaLayout {
  static constexpr int kPitch = DP + 8;               // bf16 a stage row: ldmatrix rows on distinct banks
  static constexpr int kRound = kWarps * kKeys;       // keys a stage: one 16-key tile a warp
  static constexpr int kStage = 2 * kRound * kPitch;  // bf16 of one stage (K, V)
  static constexpr int kStages = 3;
  static constexpr int kRing = kStages * kStage * 2;  // bytes
  static constexpr int kPart = kRows * DP + 2 * kRows;
  static constexpr int kParts = (kWarps + 1) * kPart * 4;  // bytes, over the ring after the sweep
  static constexpr int kMain = kRing > kParts ? kRing : kParts;
  // + the row sources of each stage, the table window, the merge weights
  static constexpr size_t kSmem =
      kMain + kStages * kRound * 8 + kTable * 4 + (kMaxSplits * kRows + kRows) * 4;
};

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* row, int d, int D, bool ok) {
  const __nv_bfloat16 z = __float2bfloat16(0.f);
  const __nv_bfloat16 lo = ok && d < D ? row[d] : z, hi = ok && d + 1 < D ? row[d + 1] : z;
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) paged_decode_mma_kernel(const Args a) {
  using L = MmaLayout<DP>;
  constexpr int kP = L::kPitch;
  constexpr int kKS = DP / 16;  // 16-dim blocks
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* wpart = reinterpret_cast<float*>(smem);  // after the sweep, over the ring
  float* cpart = wpart + kWarps * L::kPart;
  long* rowsrc = reinterpret_cast<long*>(smem + L::kMain);
  int* tbl = reinterpret_cast<int*>(rowsrc + L::kStages * L::kRound);
  float* rw = reinterpret_cast<float*>(tbl + kTable);

  const int S = gridDim.x, rank = blockIdx.x;
  const int h = blockIdx.y / a.n_rt, rt = blockIdx.y - h * a.n_rt;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* k_pool = static_cast<const __nv_bfloat16*>(a.k_pool);
  const __nv_bfloat16* v_pool = static_cast<const __nv_bfloat16*>(a.v_pool);

  TableWindow win{tbl, a.block_table + (long)b * a.n_blocks, 0, a.n_blocks};
  win.fill();
  const Range g = live_range(a, b, rank, S);
  const int n_tiles = g.key_end > g.key_begin ? (g.key_end - g.key_begin + kKeys - 1) / kKeys : 0;
  const int n_rounds = (n_tiles + kWarps - 1) / kWarps;
  if (a.D < DP) {  // the padded columns stay zero: cp.async never writes them
    uint4* r4 = reinterpret_cast<uint4*>(ring);
    for (int i = threadIdx.x; i < L::kRing / 16; i += kThreads) r4[i] = make_uint4(0, 0, 0, 0);
  }

  // the loads, a round at a time, called by every thread: one thread a key
  // row finds its source (the element offset of the row in the pools, -1
  // past the range; one slot a stage), then neighbouring lanes copy
  // neighbouring 16-byte chunks of the rows. The round's first key is at
  // offset iss_off of page iss_lp.
  const int row_chunks = a.D / 8;
  int iss_lp = g.pa, iss_off = 0;
  auto issue = [&](int rd) {
    win.cover(iss_lp, L::kRound);
    long* src = rowsrc + (rd % L::kStages) * L::kRound;
    if (threadIdx.x < L::kRound) {
      const int r = threadIdx.x;
      long at = -1;
      if (g.key_begin + rd * L::kRound + r < g.key_end) {
        int lp = iss_lp, off = iss_off + r;
        while (off >= a.page) {
          off -= a.page;
          ++lp;
        }
        at = ((win[lp] * a.page + off) * a.KV + h) * (long)a.D;
      }
      src[r] = at;
    }
    iss_off += L::kRound;
    while (iss_off >= a.page) {
      iss_off -= a.page;
      ++iss_lp;
    }
    __syncthreads();
    __nv_bfloat16* st = ring + (rd % L::kStages) * L::kStage;
    constexpr int kCPR = DP / 8;  // 16-byte chunks of a row
    constexpr int kUnroll = DP <= 128 ? 16 : 4;  // all of them; at 256, short of spilling
#pragma unroll kUnroll
    for (int k = 0; k < 2 * L::kRound * kCPR / kThreads; ++k) {
      const int c = threadIdx.x + k * kThreads;
      const int which = c / (L::kRound * kCPR), rem = c % (L::kRound * kCPR);
      const int r = rem / kCPR, ch = rem % kCPR;
      if (ch >= row_chunks) continue;
      const long at = src[r];
      const __nv_bfloat16* pool = which ? v_pool : k_pool;
      cp_async16(st + (which * L::kRound + r) * kP + ch * 8, at >= 0 ? pool + at + ch * 8 : pool,
                 at >= 0);
    }
  };

  // Q^T as the B operand of S^T = K Q^T: n = the 8 rows of this row tile
  uint32_t qb[kKS][2];
  {
    const int r = rt * kRows + g8;
    const bool ok = r < a.R;
    const int t = r / a.G, gq = r - t * a.G;
    const __nv_bfloat16* row = static_cast<const __nv_bfloat16*>(a.q) +
                               ((long)(b * a.T + t) * a.H + h * a.G + gq) * a.D;
#pragma unroll
    for (int k = 0; k < kKS; ++k) {
      qb[k][0] = q_pair(row, k * 16 + 2 * t4, a.D, ok);
      qb[k][1] = q_pair(row, k * 16 + 2 * t4 + 8, a.D, ok);
    }
  }
  // this lane's two rows 2*t4 + j: limits and softmax state
  bool row_ok[2];
  int lim_hi[2], lim_lo[2];
  float m_run[2], l_run[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = rt * kRows + 2 * t4 + j;
    const int t = r / a.G;
    row_ok[j] = r < a.R;
    lim_hi[j] = g.base + t;
    lim_lo[j] = a.window > 0 ? g.base + t - a.window : INT_MIN;
    m_run[j] = kNeg;
    l_run[j] = 0.f;
  }
  float acc[kKS][4];  // O^T: rows d = 16m + g8 (+8), columns the rows 2*t4 + (0, 1)
#pragma unroll
  for (int m = 0; m < kKS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

  __syncthreads();  // the table window is filled, the padding zeroed
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_rounds) issue(s);
    cp_async_commit();
  }
  for (int rd = 0; rd < n_rounds; ++rd) {
    cp_async_wait<L::kStages - 2>();  // stage rd has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; stage rd - 1 is consumed
    if (rd + L::kStages - 1 < n_rounds) issue(rd + L::kStages - 1);
    cp_async_commit();
    const int u = rd * kWarps + warp;
    if (u >= n_tiles) continue;
    const __nv_bfloat16* kt = ring + (rd % L::kStages) * L::kStage + warp * kKeys * kP;
    const __nv_bfloat16* vt = kt + L::kRound * kP;

    // S^T (16 keys x 8 rows): two chains over the head dims, then summed
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* ka = kt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kP + (lane >> 4) * 8;
#pragma unroll
    for (int k = 0; k < kKS; ++k) {
      uint32_t af[4];
      tc_tile::ldsm_x4(af, ka + k * 16);
      tc_tile::Bf16::mma(k & 1 ? s1 : s0, af, qb[k][0], qb[k][1]);
    }
    // element e: key g8 + 8 * (e >> 1), row 2 * t4 + (e & 1)
    const int key0 = g.key_begin + u * kKeys + g8;
    float sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * (e >> 1), j = e & 1;
      const bool ok = row_ok[j] && key < g.key_end && key <= lim_hi[j] && key > lim_lo[j];
      sc[e] = ok ? (s0[e] + s1[e]) * a.scale : kNeg;
    }
    float p[4], corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = fmaxf(sc[j], sc[j + 2]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m_run[j], mx);
      corr[j] = expf(m_run[j] - m_new);
      p[j] = sc[j] > kNeg ? expf(sc[j] - m_new) : 0.f;
      p[j + 2] = sc[j + 2] > kNeg ? expf(sc[j + 2] - m_new) : 0.f;
      float ps = p[j] + p[j + 2];
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      ps += __shfl_xor_sync(0xffffffffu, ps, 8);
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      l_run[j] = fmaf(l_run[j], corr[j], ps);
      m_run[j] = m_new;
    }
    // P^T -> the B operand of O^T = V^T P^T: keys 0-7 and 8-15
    const uint32_t b0 = movmatrix_trans(cvt::pack_bf16x2(p[0], p[1]));
    const uint32_t b1 = movmatrix_trans(cvt::pack_bf16x2(p[2], p[3]));
    const __nv_bfloat16* va = vt + ((lane & 7) + (lane >> 4) * 8) * kP + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int m = 0; m < kKS; ++m) {
      acc[m][0] *= corr[0];
      acc[m][1] *= corr[1];
      acc[m][2] *= corr[0];
      acc[m][3] *= corr[1];
      uint32_t vf[4];
      tc_tile::ldsm_x4_trans(vf, va + m * 16);
      tc_tile::Bf16::mma(acc[m], vf, b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is consumed: the partials go over it

  float* wp = wpart + warp * L::kPart;
#pragma unroll
  for (int m = 0; m < kKS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) wp[(2 * t4 + (e & 1)) * DP + 16 * m + g8 + 8 * (e >> 1)] = acc[m][e];
  if (g8 == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wp[kRows * DP + 2 * t4 + j] = m_run[j];
      wp[kRows * DP + kRows + 2 * t4 + j] = l_run[j];
    }
  }
  merge_store<DP>(a, wpart, cpart, rw, rt, b, h);
}

// ---------------------------------------------------------------------------
// every other (q, pool) pair: the FMA units
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// E values of type KT at p (E * sizeof(KT)-byte aligned, in shared memory)
// -> fp32, int8 times mul
template <typename KT, int E>
__device__ __forceinline__ void load_f32(float (&x)[E], const KT* p, float mul) {
  constexpr int kBytes = E * sizeof(KT);
  alignas(16) KT e[E];
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k)
      reinterpret_cast<uint4*>(e)[k] = reinterpret_cast<const uint4*>(p)[k];
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(e) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<uint32_t*>(e) = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (kBytes == 2) {
    *reinterpret_cast<uint16_t*>(e) = *reinterpret_cast<const uint16_t*>(p);
  } else {
    e[0] = p[0];
  }
#pragma unroll
  for (int k = 0; k < E; ++k) {
    x[k] = to_f32(e[k]);
    if constexpr (std::is_same_v<KT, int8_t>) x[k] *= mul;
  }
}

// One step of the transposing butterfly: each lane keeps the half of its
// 2*HALF values that its bit HALF selects and adds the partner's copy of it.
template <int HALF>
__device__ __forceinline__ void reduce_step(float (&v)[32], int lane) {
  const bool upper = lane & HALF;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = upper ? v[k] : v[k + HALF];
    const float keep = upper ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// 32 values per lane -> v[0] of lane l = the sum over the warp of value l
__device__ __forceinline__ void transpose_reduce(float (&v)[32], int lane) {
  reduce_step<16>(v, lane);
  reduce_step<8>(v, lane);
  reduce_step<4>(v, lane);
  reduce_step<2>(v, lane);
  reduce_step<1>(v, lane);
}

template <typename KT, int E>
struct FmaLayout {
  static constexpr int DP = 32 * E;                            // head dim padded to the lanes
  static constexpr int kStages = 4;
  static constexpr int kStage = 2 * kKeys * DP;                // elements of one stage (K, V)
  static constexpr int kRing = kStages * kStage * sizeof(KT);  // bytes
  static constexpr int kPart = kRows * DP + 2 * kRows;         // floats: acc, then m, then l
  // floats after the ring and the table: per-warp scratch (32 P + 8 corr),
  // the warps' partials, the CTA's partial, the merge weights and sums
  static constexpr int kFloats =
      kWarps * 40 + kWarps * kPart + kPart + kMaxSplits * kRows + kRows;
  static constexpr size_t kSmem = kRing + kTable * sizeof(int) + kFloats * sizeof(float);
  static constexpr int kCPR = DP * sizeof(KT) / 16;            // 16-byte chunks of a padded row
  static constexpr int kChunks = 2 * kKeys * kCPR;             // per stage
};

template <typename KT, int E>
__global__ void __launch_bounds__(kThreads, 2) paged_decode_fma_kernel(const Args a) {
  using L = FmaLayout<KT, E>;
  constexpr int DP = L::DP;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* ring = reinterpret_cast<KT*>(smem);
  int* tbl = reinterpret_cast<int*>(smem + L::kRing);
  float* pscr = reinterpret_cast<float*>(tbl + kTable);
  float* wpart = pscr + kWarps * 40;
  float* cpart = wpart + kWarps * L::kPart;
  float* rw = cpart + L::kPart;

  const int S = gridDim.x, rank = blockIdx.x;
  const int h = blockIdx.y / a.n_rt, rt = blockIdx.y - h * a.n_rt;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const KT* k_pool = static_cast<const KT*>(a.k_pool);
  const KT* v_pool = static_cast<const KT*>(a.v_pool);

  TableWindow win{tbl, a.block_table + (long)b * a.n_blocks, 0, a.n_blocks};
  win.fill();
  const Range g = live_range(a, b, rank, S);
  const int n_tiles = g.key_end > g.key_begin ? (g.key_end - g.key_begin + kKeys - 1) / kKeys : 0;
  if (a.D < DP) {  // the padded columns stay zero: cp.async never writes them
    uint4* r4 = reinterpret_cast<uint4*>(ring);
    for (int i = threadIdx.x; i < L::kRing / 16; i += kThreads) r4[i] = make_uint4(0, 0, 0, 0);
  }

  // the issue stream's position: tile iss_u starts at offset iss_off of
  // page iss_lp (no division per tile)
  int iss_lp = g.pa, iss_off = 0;
  const int row_chunks = a.D * (int)sizeof(KT) / 16;
  auto issue = [&](int u) {  // called by every thread, tiles in order
    win.cover(iss_lp, kKeys);
    KT* st = ring + (u % L::kStages) * L::kStage;
    const int key0 = g.key_begin + u * kKeys;
#pragma unroll
    for (int k = 0; k < (L::kChunks + kThreads - 1) / kThreads; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (L::kChunks % kThreads != 0 && c >= L::kChunks) break;
      const int which = c / (kKeys * L::kCPR);
      const int rem = c % (kKeys * L::kCPR);
      const int r = rem / L::kCPR, ch = rem % L::kCPR;
      if (ch >= row_chunks) continue;
      const bool ok = key0 + r < g.key_end;
      const KT* src = which ? v_pool : k_pool;
      if (ok) {
        int lp = iss_lp, off = iss_off + r;
        while (off >= a.page) {
          off -= a.page;
          ++lp;
        }
        src += ((win[lp] * a.page + off) * a.KV + h) * (long)a.D + ch * (16 / (int)sizeof(KT));
      }
      cp_async16(st + (which * kKeys + r) * DP + ch * (16 / (int)sizeof(KT)), src, ok);
    }
    iss_off += kKeys;
    while (iss_off >= a.page) {
      iss_off -= a.page;
      ++iss_lp;
    }
  };

  // the 8 query rows of this row tile, E head dims a lane, in fp32
  float qr[kRows][E];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rt * kRows + i;
    const int t = r / a.G, gq = r - t * a.G;
    const long row = ((long)(b * a.T + t) * a.H + h * a.G + gq) * a.D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane * E + e;
      float v = 0.f;
      if (r < a.R && d < a.D)
        v = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[row + d])
                     : static_cast<const float*>(a.q)[row + d];
      qr[i][e] = v;
    }
  }
  // lane i*4 + j holds the score of row i and key j: its row's limits
  const int my_i = lane >> 2, my_j = lane & 3;
  const int my_r = rt * kRows + my_i;
  const bool my_row_ok = my_r < a.R;
  const int my_t = my_r / a.G;
  const int lim_hi = g.base + my_t;                                     // keys <= lim_hi
  const int lim_lo = a.window > 0 ? g.base + my_t - a.window : INT_MIN;  // keys > lim_lo
  float m_run = kNeg, l_run = 0.f;
  float acc[kRows][E];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;

  __syncthreads();  // the table window is filled, the padding zeroed
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }
  float* scr = pscr + warp * 40;
  for (int u = 0; u < n_tiles; ++u) {
    cp_async_wait<L::kStages - 2>();  // tile u has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; tile u - 1 is consumed
    if (u + L::kStages - 1 < n_tiles) issue(u + L::kStages - 1);
    cp_async_commit();

    const KT* ks = ring + (u % L::kStages) * L::kStage + warp * 4 * DP + lane * E;
    const KT* vs = ks + kKeys * DP;
    float v[32];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float kf[E];
      load_f32<KT, E>(kf, ks + j * DP, a.dequant);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[i][e], kf[e], s);
        v[i * 4 + j] = s;
      }
    }
    transpose_reduce(v, lane);

    const int key = g.key_begin + u * kKeys + warp * 4 + my_j;
    const bool ok = my_row_ok && key < g.key_end && key <= lim_hi && key > lim_lo;
    const float sc = ok ? v[0] * a.scale : kNeg;
    float mt = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_run, mt);
    const float p = ok ? expf(sc - m_new) : 0.f;
    const float corr = expf(m_run - m_new);
    float ps = p + __shfl_xor_sync(0xffffffffu, p, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l_run = fmaf(l_run, corr, ps);
    m_run = m_new;
    scr[lane] = p;
    if (my_j == 0) scr[32 + my_i] = corr;
    __syncwarp();

    float vf[4][E];
#pragma unroll
    for (int j = 0; j < 4; ++j) load_f32<KT, E>(vf[j], vs + j * DP, a.dequant);
    const float4* s4 = reinterpret_cast<const float4*>(scr);
    const float4 c0 = s4[8], c1 = s4[9];
    const float cr[kRows] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 pr = s4[i];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float x = acc[i][e] * cr[i];
        x = fmaf(pr.x, vf[0][e], x);
        x = fmaf(pr.y, vf[1][e], x);
        x = fmaf(pr.z, vf[2][e], x);
        acc[i][e] = fmaf(pr.w, vf[3][e], x);
      }
    }
    __syncwarp();  // the scratch is read before the next tile writes it
  }
  cp_async_wait<0>();

  float* wp = wpart + warp * L::kPart;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) wp[i * DP + lane * E + e] = acc[i][e];
  if (my_j == 0) {
    wp[kRows * DP + my_i] = m_run;
    wp[kRows * DP + kRows + my_i] = l_run;
  }
  merge_store<DP>(a, wpart, cpart, rw, rt, b, h);
}

// ---------------------------------------------------------------------------
// head dims above 256, every pair: the FMA units, rows in shared memory
// ---------------------------------------------------------------------------

// bytes of shared memory at head dim D: the table window, the per-warp
// scratch, the merge weights, the warps' partials and the CTA's partial
// (over the query rows, which the sweep is done with by then)
constexpr size_t wide_smem(int D) {
  return kTable * 4 +
         (size_t)((kWarps + 1) * (kRows * D + 2 * kRows) + kWarps * 40 + kMaxSplits * kRows + kRows) *
             4;
}
constexpr int kMaxHeadDim = (kSmemLimit - (int)wide_smem(0)) / ((kWarps + 1) * kRows * 4);

template <typename KT>
__global__ void __launch_bounds__(kThreads) paged_decode_wide_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, kPart = kRows * D + 2 * kRows;
  int* tbl = reinterpret_cast<int*>(smem);
  float* pscr = reinterpret_cast<float*>(tbl + kTable);
  float* rw = pscr + kWarps * 40;
  float* wpart = rw + kMaxSplits * kRows + kRows;
  float* cpart = wpart + kWarps * kPart;
  float* qs = cpart;  // the query rows (kRows x D, fp32) during the sweep

  const int S = gridDim.x, rank = blockIdx.x;
  const int h = blockIdx.y / a.n_rt, rt = blockIdx.y - h * a.n_rt;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const KT* k_pool = static_cast<const KT*>(a.k_pool);
  const KT* v_pool = static_cast<const KT*>(a.v_pool);
  const float mul = std::is_same_v<KT, int8_t> ? a.dequant : 1.f;

  TableWindow win{tbl, a.block_table + (long)b * a.n_blocks, 0, a.n_blocks};
  win.fill();
  const Range g = live_range(a, b, rank, S);
  const int n_tiles = g.key_end > g.key_begin ? (g.key_end - g.key_begin + kKeys - 1) / kKeys : 0;
  for (int x = threadIdx.x; x < kRows * D; x += kThreads) {
    const int i = x / D, d = x - i * D;
    const int r = rt * kRows + i;
    float v = 0.f;
    if (r < a.R) {
      const int t = r / a.G, gq = r - t * a.G;
      const long at = ((long)(b * a.T + t) * a.H + h * a.G + gq) * D + d;
      v = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[at])
                   : static_cast<const float*>(a.q)[at];
    }
    qs[x] = v;
  }
  float* acc = wpart + warp * kPart;  // this warp's accumulators, then m, then l
  for (int x = lane; x < kRows * D; x += 32) acc[x] = 0.f;
  // lane i*4 + j holds the score of row i and key j: its row's limits
  const int my_i = lane >> 2, my_j = lane & 3;
  const int my_r = rt * kRows + my_i;
  const bool my_row_ok = my_r < a.R;
  const int my_t = my_r / a.G;
  const int lim_hi = g.base + my_t;
  const int lim_lo = a.window > 0 ? g.base + my_t - a.window : INT_MIN;
  float m_run = kNeg, l_run = 0.f;
  __syncthreads();  // the table window and the query rows are in

  float* scr = pscr + warp * 40;
  int lp = g.pa, off = 0;  // tile u's first key: offset off of page lp
  for (int u = 0; u < n_tiles; ++u) {
    win.cover(lp, kKeys);
    // this warp's 4 keys: where their rows start in the pools
    long src[4];
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp * 4 + j;
      live[j] = g.key_begin + u * kKeys + r < g.key_end;
      int kp = lp, ko = off + r;
      while (ko >= a.page) {
        ko -= a.page;
        ++kp;
      }
      src[j] = live[j] ? ((win[kp] * a.page + ko) * a.KV + h) * (long)D : 0;
    }
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = 0.f;
    for (int d = lane; d < D; d += 32) {
      float qd[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qd[i] = qs[i * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kf = live[j] ? to_f32(k_pool[src[j] + d]) * mul : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) v[i * 4 + j] = fmaf(qd[i], kf, v[i * 4 + j]);
      }
    }
    transpose_reduce(v, lane);

    const int key = g.key_begin + u * kKeys + warp * 4 + my_j;
    const bool ok = my_row_ok && key < g.key_end && key <= lim_hi && key > lim_lo;
    const float sc = ok ? v[0] * a.scale : kNeg;
    float mt = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_run, mt);
    const float p = ok ? expf(sc - m_new) : 0.f;
    const float corr = expf(m_run - m_new);
    float ps = p + __shfl_xor_sync(0xffffffffu, p, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l_run = fmaf(l_run, corr, ps);
    m_run = m_new;
    scr[lane] = p;
    if (my_j == 0) scr[32 + my_i] = corr;
    __syncwarp();

    const float4* s4 = reinterpret_cast<const float4*>(scr);
    const float4 c0 = s4[8], c1 = s4[9];
    const float cr[kRows] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    for (int d = lane; d < D; d += 32) {
      float vf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vf[j] = live[j] ? to_f32(v_pool[src[j] + d]) * mul : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 pr = s4[i];
        float x = acc[i * D + d] * cr[i];
        x = fmaf(pr.x, vf[0], x);
        x = fmaf(pr.y, vf[1], x);
        x = fmaf(pr.z, vf[2], x);
        acc[i * D + d] = fmaf(pr.w, vf[3], x);
      }
    }
    __syncwarp();  // the scratch is read before the next tile writes it
    off += kKeys;
    while (off >= a.page) {
      off -= a.page;
      ++lp;
    }
  }
  if (my_j == 0) {
    acc[kRows * D + my_i] = m_run;
    acc[kRows * D + kRows + my_i] = l_run;
  }
  merge_store<0>(a, wpart, cpart, rw, rt, b, h);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// smem_limit: the dynamic shared memory the kernel is allowed, raised once a
// device; smem: this launch's
template <typename Kernel>
int launch(Kernel* kernel, size_t smem, size_t smem_limit, int& sized_for, const Args& a, int B,
           int splits, cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (sized_for != dev) {  // the device whose limit was raised
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_limit));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized_for = dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.KV * a.n_rt, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_mma(const Args& a, int B, int splits, cudaStream_t s) {
  static int sized_for = -1;
  return launch(paged_decode_mma_kernel<DP>, MmaLayout<DP>::kSmem, MmaLayout<DP>::kSmem, sized_for,
                a, B, splits, s);
}

template <typename KT, int E>
int launch_fma(const Args& a, int B, int splits, cudaStream_t s) {
  static int sized_for = -1;
  return launch(paged_decode_fma_kernel<KT, E>, FmaLayout<KT, E>::kSmem, FmaLayout<KT, E>::kSmem,
                sized_for, a, B, splits, s);
}

template <typename KT>
int launch_wide(const Args& a, int B, int splits, cudaStream_t s) {
  static int sized_for = -1;
  return launch(paged_decode_wide_kernel<KT>, wide_smem(a.D), wide_smem(kMaxHeadDim), sized_for, a,
                B, splits, s);
}

template <typename KT>
int launch_fma_d(const Args& a, int B, int splits, cudaStream_t s) {
  if (a.D <= 32) return launch_fma<KT, 1>(a, B, splits, s);
  if (a.D <= 64) return launch_fma<KT, 2>(a, B, splits, s);
  if (a.D <= 128) return launch_fma<KT, 4>(a, B, splits, s);
  return launch_fma<KT, 8>(a, B, splits, s);
}

int launch_mma_d(const Args& a, int B, int splits, cudaStream_t s) {
  if (a.D <= 16) return launch_mma<16>(a, B, splits, s);
  if (a.D <= 32) return launch_mma<32>(a, B, splits, s);
  if (a.D <= 64) return launch_mma<64>(a, B, splits, s);
  if (a.D <= 128) return launch_mma<128>(a, B, splits, s);
  return launch_mma<256>(a, B, splits, s);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only). q float32 or
// bfloat16 over pools of any of the three; the output has q's dtype. D <=
// kMaxHeadDim and D * sizeof(pool) a multiple of 16; splits in [1, 8] (the
// host's plan).
// Returns the launch's CUDA error (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_table, const void* lengths, void* out,
                                      int B, int T, int H, int KV, int D, int page, int n_blocks,
                                      int q_dtype, int kv_dtype, float scale, float dequant,
                                      int window, int splits, void* stream) {
  if (D < 1 || D > kMaxHeadDim || splits < 1 || splits > kMaxSplits || (q_dtype != 0 && q_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.block_table = static_cast<const int*>(block_table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.T = T;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.page = page;
  a.n_blocks = n_blocks;
  a.G = H / KV;
  a.R = T * a.G;
  a.n_rt = (a.R + kRows - 1) / kRows;
  a.q_bf16 = q_dtype == 1;
  a.window = window;
  a.scale = scale;
  a.dequant = dequant;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 256) {
    if (kv_dtype == 0) return launch_wide<float>(a, B, splits, s);
    if (kv_dtype == 1) return launch_wide<__nv_bfloat16>(a, B, splits, s);
    if (kv_dtype == 2) return launch_wide<int8_t>(a, B, splits, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kv_dtype == 1 && q_dtype == 1) return launch_mma_d(a, B, splits, s);
  if (kv_dtype == 0) return launch_fma_d<float>(a, B, splits, s);
  if (kv_dtype == 1) return launch_fma_d<__nv_bfloat16>(a, B, splits, s);
  if (kv_dtype == 2) return launch_fma_d<int8_t>(a, B, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
