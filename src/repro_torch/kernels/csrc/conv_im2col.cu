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
// pattern. No padded copy of x and no im2col buffer is ever written.
//
// What bounds it on this card: operations at the ResNet-50 shapes (the
// stem does ~0.24 GFLOP on 0.6 MB of input and weights). The least time is
// the FLOPs of the in-image taps over 989 TFLOP/s (bf16) or 67 TFLOP/s
// (fp32).
//
// bf16: the tensor-core mainloop of tc_tile.cuh under its Bf16 policy
// (mma.sync.m16n8k16, fp32 accumulators, a ring of cp.async stages; w
// through the header's RowMajorB loader). Each CTA first
// writes an address table: for every output row of its tile (n*H,
// oh*stride - pad_t, ow*stride - pad_l), once, into shared memory; each
// thread then works out (kh, kw, c) once per depth step for the one depth
// column (or 8-channel group) it always loads, and no division is left per
// element. Where C % 8 == 0 (stage 3, C = 128) A arrives as 16-byte
// cp.async copies of 8 channels of one tap, pixels outside the image
// zero-filled through the copy's source size; otherwise (the stem, C = 3)
// scalar loads, staged in registers across a stage's products, fill the
// same tile. Depth past R*S*C is zero-filled to the stage depth (147 -> 160
// at the stem). Tiles: 64 x 64, 32 deep, where that grid already covers the
// SMs (the stem: 196 CTAs), else 32 x 16, 64 deep (stage 3: M = 784,
// K = 128 gives 200 CTAs where 64 x 64 gave 26). Each output is
// summed by one thread in one order: two runs give the same bits. What
// bounds it now: not the tensor cores. At stage 3 the small tiles re-read
// A once per column tile (8 times) and B once per row tile (25 times),
// ~22 MB from L2 for a 0.5 MB problem, and each CTA waits on its loads
// through 18 short stages; 32 deep and 4 stages ran about twice as long
// as 64 deep and 5 (PERF.md). Next: 64 x 64 tiles with the taps split over
// CTAs and a second pass that adds the partial sums in a fixed order,
// which cuts that traffic threefold. At the stem, the scalar gather of
// C = 3 (16 two-byte loads per thread and stage).
//
// fp32: exact fp32 on the FMA units through os_tile.cuh (64 x 64 tiles,
// 8 x 4 outputs a thread, a ring of 4 cp.async stages 16 deep; TF32 would
// miss the ref.sum_order_error limit). A arrives through the same per-CTA
// address table as bf16's (fill_rows): each thread works out (kh, kw, c)
// once per stage for the depth column (or 4-channel group) it always
// loads. Where C % 4 == 0 (stage 3, C = 128; the bench's C = 64) A comes
// as 16-byte cp.async copies of 4 channels of one tap, pixels outside the
// image zero-filled through the copy's source size; otherwise (the stem,
// C = 3) as 4-byte copies. Where the tiles alone leave the SMs short of
// warps the taps are split over CTAs (os_tile::plan), ranges of whole taps
// or whole fractions of one where C is a whole number of stages: stage 3
// (26 tiles) in 18 ranges of half a tap, 468 CTAs; the partials are added
// in rank order by a second pass, so two runs give the same bits. What
// bounds it: operations, the in-image taps' FLOPs over 67 TFLOP/s.
#include <cuda_bf16.h>

#include "os_tile.cuh"
#include "tc_tile.cuh"

namespace {

constexpr int kOutside = -(1 << 28);  // an ih that no tap brings into the image

// Per output row r of the CTA's tile, once, into shared memory (both
// paths): row_n = n * H, row_h = oh * stride - pad_t (kOutside past M),
// row_w = ow * stride - pad_l. The loaders then add a tap's (kh, kw) and
// divide nothing per element.
template <int BM>
__device__ __forceinline__ void fill_rows(int* row_n, int* row_h, int* row_w, int m0, int M,
                                          int H, int OH, int OW, int stride, int pad_t,
                                          int pad_l, int threads) {
  for (int r = threadIdx.x; r < BM; r += threads) {
    const int m = m0 + r;
    if (m < M) {
      const int ow = m % OW, t = m / OW, oh = t % OH, n = t / OH;
      row_n[r] = n * H;
      row_h[r] = oh * stride - pad_t;
      row_w[r] = ow * stride - pad_l;
    } else {
      row_n[r] = 0;
      row_h[r] = kOutside;
      row_w[r] = 0;
    }
  }
}

// ===========================================================================
// fp32: the os_tile FMA loop
// ===========================================================================

// A = the implicit im2col rows of the tile, depth [k0, k0 + BK), zeros
// outside the image and at and past k_end. Each thread always loads the
// same depth column (vec: 4-channel group) of the stage, so it works out
// (kh, kw, c) once per stage; rows come from the table, no division per
// element. vec (runtime, uniform): C % 4 == 0 and x 16-byte aligned,
// 16-byte copies of 4 channels of one tap; else 4-byte copies.
template <typename Sh>
struct Im2colF32 {
  const float* x;
  int H, W, C, S;
  const int* row_n;  // the CTA's row table (fill_rows)
  const int* row_h;
  const int* row_w;
  bool vec;

  __device__ __forceinline__ void issue(os_tile::Stages<Sh>& st, int s, int k0, int k_end) const {
    constexpr int BK = Sh::BK, kT = Sh::kThreads;
    constexpr int kLanes = BK / 4;  // 4-channel groups per stage
    const int col = vec ? 4 * (threadIdx.x % kLanes) : threadIdx.x % BK;
    const int k = k0 + col;
    const int tap = k / C, c = k - tap * C, kh = tap / S, kw = tap - kh * S;
    const bool kin = k < k_end;
    if (vec) {
#pragma unroll
      for (int i = 0; i < Sh::BM * kLanes / kT; ++i) {
        const int r = threadIdx.x / kLanes + (kT / kLanes) * i;
        const int ih = row_h[r] + kh, iw = row_w[r] + kw;
        const bool in = kin && (unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W;
        os_tile::cp_async16<true>(&st.a[s][r][col],
                                  in ? x + ((long)(row_n[r] + ih) * W + iw) * C + c : x, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < Sh::BM * BK / kT; ++i) {
        const int r = threadIdx.x / BK + (kT / BK) * i;
        const int ih = row_h[r] + kh, iw = row_w[r] + kw;
        const bool in = kin && (unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W;
        os_tile::cp_async4(&st.a[s][r][col],
                           in ? x + ((long)(row_n[r] + ih) * W + iw) * C + c : x, in);
      }
    }
  }
};

struct ConvF32Args {
  const float* x;
  const float* w;
  float* out;
  float* ws;  // null: one range
  int H, W, C, S, OH, OW, stride, pad_t, pad_l, M, Cout, depth, chunk;
  bool vec_a, vec_b, vec_out;
};

__global__ void __launch_bounds__(os_tile::Tile::kThreads, 1)
    conv_f32_kernel(const ConvF32Args p) {
  using T = os_tile::Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  auto& st = *reinterpret_cast<os_tile::Stages<T>*>(smem);
  __shared__ int row_n[T::BM], row_h[T::BM], row_w[T::BM];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * p.chunk, k_end = min(p.depth, k_begin + p.chunk);
  fill_rows<T::BM>(row_n, row_h, row_w, m0, p.M, p.H, p.OH, p.OW, p.stride, p.pad_t, p.pad_l,
                   T::kThreads);
  __syncthreads();
  os_tile::Accum<T> acc = {};
  const Im2colF32<T> a{p.x, p.H, p.W, p.C, p.S, row_n, row_h, row_w, p.vec_a};
  const os_tile::LoadB<T> b{p.w, p.Cout, n0, p.vec_b};
  os_tile::mainloop<T>(st, a, b, k_begin, k_end, acc);
  if (p.ws)
    os_tile::store_partial<T>(p.ws, m0, n0, acc);
  else
    os_tile::store<T>(p.out, p.M, p.Cout, m0, n0, acc, p.vec_out);
}

int launch_f32(ConvF32Args p, cudaStream_t s) {
  using T = os_tile::Tile;
  const int splits = static_cast<int>(os_tile::cdiv(p.depth, p.chunk));
  const dim3 grid(os_tile::cdiv(p.Cout, T::BN), os_tile::cdiv(p.M, T::BM), splits);
  if (splits == 1) p.ws = nullptr;
  conv_f32_kernel<<<grid, T::kThreads, sizeof(os_tile::Stages<T>), s>>>(p);
  return os_tile::finish(p.ws, p.out, p.M, p.Cout, grid.y * T::BM, grid.x * T::BN, splits, s);
}

// ===========================================================================
// bf16: the tensor-core mainloop
// ===========================================================================

using bf16 = __nv_bfloat16;

struct ConvArgs {
  const bf16* x;
  const bf16* w;
  bf16* out;
  int H, W, C, S, OH, OW, stride, pad_t, pad_l, M, Cout, depth;
};

// Fills one stage: A = depth [k0, k0 + BK) of the tile's output rows, read
// through the address table; B = rows [k0, k0 + BK) of w, the tile's
// columns. kVecA: C % 8 == 0, 16-byte cp.async copies of 8 channels of one
// tap; else scalar loads staged in registers (issue) and stored (land).
// kVecB: Cout % 8 == 0 and w 16-byte aligned (tc_tile::RowMajorB).
template <typename Sh, bool kVecA, bool kVecB>
struct ConvLoad {
  static constexpr int BM = Sh::BM, BK = Sh::BK, kT = tc_tile::kThreads;
  static constexpr int kScalarA = kVecA ? 1 : BM * BK / kT;  // register-staged values
  static_assert(kT % (BK / 8) == 0 && kT % BK == 0 && (BM * BK) % kT == 0,
                "each thread keeps one depth column (or 8-channel group)");
  ConvArgs p;
  const int* row_n;  // n * H per tile row
  const int* row_h;  // oh * stride - pad_t (kOutside past M)
  const int* row_w;  // ow * stride - pad_l
  tc_tile::RowMajorB<Sh, kVecB> b;
  bf16 a_reg[kScalarA];

  // (kh, kw, c) of depth k, once per depth step and thread
  __device__ __forceinline__ void tap_of(int k, int& kh, int& kw, int& c) const {
    const int tap = k / p.C;
    c = k - tap * p.C;
    kh = tap / p.S;
    kw = tap - kh * p.S;
  }

  __device__ __forceinline__ void issue(tc_tile::Stages<Sh>& st, int s, int step) {
    const int k0 = step * BK;
    int kh, kw, c;
    if constexpr (kVecA) {
      constexpr int kGroups = BK / 8;  // thread t loads 8-channel group t % kGroups
      const int k = k0 + 8 * (threadIdx.x % kGroups);
      tap_of(k, kh, kw, c);
      const bool kin = k < p.depth;
#pragma unroll
      for (int i = 0; i < BM * kGroups / kT; ++i) {
        const int e = threadIdx.x + kT * i, r = e / kGroups;
        const int ih = row_h[r] + kh, iw = row_w[r] + kw;
        const bool in = kin && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W;
        const bf16* src = in ? p.x + ((long)(row_n[r] + ih) * p.W + iw) * p.C + c : p.x;
        tc_tile::cp_async16(&st.a[s][r][8 * (e % kGroups)], src, in);
      }
    } else {
      const int k = k0 + threadIdx.x % BK;  // thread t loads depth column t % BK
      tap_of(k, kh, kw, c);
      const bool kin = k < p.depth;
#pragma unroll
      for (int i = 0; i < kScalarA; ++i) {
        const int r = threadIdx.x / BK + (kT / BK) * i;
        const int ih = row_h[r] + kh, iw = row_w[r] + kw;
        const bool in = kin && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W;
        a_reg[i] = in ? p.x[((long)(row_n[r] + ih) * p.W + iw) * p.C + c] : __float2bfloat16(0.f);
      }
    }
    b.issue(st, s, k0);
  }

  __device__ __forceinline__ void land(tc_tile::Stages<Sh>& st, int s) const {
    if constexpr (!kVecA) {
#pragma unroll
      for (int i = 0; i < kScalarA; ++i)
        st.a[s][threadIdx.x / BK + (kT / BK) * i][threadIdx.x % BK] = a_reg[i];
    }
    b.land(st, s);
  }
};

template <typename Sh, bool kVecA, bool kVecB>
__global__ void __launch_bounds__(tc_tile::kThreads) conv_bf16_kernel(const ConvArgs p) {
  constexpr int BM = Sh::BM, BN = Sh::BN;
  __shared__ __align__(128) tc_tile::Stages<Sh> st;
  __shared__ int row_n[BM], row_h[BM], row_w[BM];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  fill_rows<BM>(row_n, row_h, row_w, m0, p.M, p.H, p.OH, p.OW, p.stride, p.pad_t, p.pad_l,
                tc_tile::kThreads);
  __syncthreads();
  tc_tile::Accum<Sh> acc = {};
  ConvLoad<Sh, kVecA, kVecB> load{p, row_n, row_h, row_w, {p.w, p.depth, p.Cout, n0}};
  tc_tile::mainloop<Sh>(st, load, (p.depth + Sh::BK - 1) / Sh::BK, acc);
  tc_tile::store<Sh>(p.out, p.M, p.Cout, m0, n0, acc, tc_tile::Round<bf16>{});
}

// 64 x 64 tiles, 32 deep: where they already give a CTA per SM (the stem:
// 196 CTAs, depth 147 -> 160). 32 x 16 tiles, 64 deep, 5 stages: small
// maps (stage 3: 200 CTAs); fewer, deeper stages keep more bytes in flight
// per SM, which is what a CTA of this size waits on.
using Big = tc_tile::Shape<tc_tile::Bf16, 64, 64, 32, 32, 32, 4>;
using Small = tc_tile::Shape<tc_tile::Bf16, 32, 16, 16, 8, 64, 5>;

template <typename Sh, bool kVecA, bool kVecB>
void launch_tile(const ConvArgs& p, cudaStream_t s) {
  const dim3 grid((p.Cout + Sh::BN - 1) / Sh::BN, (p.M + Sh::BM - 1) / Sh::BM);
  conv_bf16_kernel<Sh, kVecA, kVecB><<<grid, tc_tile::kThreads, 0, s>>>(p);
}

template <bool kVecA, bool kVecB>
void launch_bf16(const ConvArgs& p, cudaStream_t s) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long big_tiles = (long)((p.M + Big::BM - 1) / Big::BM) * ((p.Cout + Big::BN - 1) / Big::BN);
  if (big_tiles >= sms)
    launch_tile<Big, kVecA, kVecB>(p, s);
  else
    launch_tile<Small, kVecA, kVecB>(p, s);
}

}  // namespace

// The fp32 path's plan for a conv of M = N * OH * OW output pixels, Cout
// channels, an R x S x C depth, on `sms` SMs (os_tile::plan; where C is a
// whole number of stages, ranges are whole taps or whole fractions of
// one): plan[0..3] = tile rows, tile columns, depth values per range
// (`chunk`), ranges (`splits`). With splits > 1 the launch needs a
// workspace of splits * ceil(M / rows) * rows * ceil(Cout / cols) * cols
// floats.
extern "C" void conv_im2col_f32_plan(int M, int Cout, int C, int R, int S, int sms, int* plan) {
  constexpr int BK = os_tile::Tile::BK;
  const os_tile::Plan p = os_tile::plan(M, Cout, R * S * C, sms, C % BK == 0 ? C / BK : 0);
  plan[0] = os_tile::Tile::BM;
  plan[1] = os_tile::Tile::BN;
  plan[2] = p.chunk;
  plan[3] = p.splits;
}

// fp32 x, w -> out with the depth (kh, kw, c) cut into ranges of `chunk`
// values (a multiple of 16); ws: the workspace where there is more than
// one range, else unused. Returns the first launch error (0 = launched).
extern "C" int conv_im2col_f32_launch(const void* x, const void* w, void* out, void* ws, int N,
                                      int H, int W, int C, int R, int S, int Cout, int OH, int OW,
                                      int stride, int pad_t, int pad_l, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * OH * OW, depth = R * S * C;
  if (chunk < 1 || chunk % os_tile::Tile::BK != 0 || (chunk < depth && ws == nullptr) ||
      os_tile::cdiv(depth, chunk) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvF32Args p{static_cast<const float*>(x),
                      static_cast<const float*>(w),
                      static_cast<float*>(out),
                      static_cast<float*>(ws),
                      H, W, C, S, OH, OW, stride, pad_t, pad_l, M, Cout, depth, chunk,
                      C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0,
                      Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0,
                      Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0};
  return launch_f32(p, s);
}

// bfloat16 x, w and out (tensor cores; dtype 1; float32 goes through
// conv_im2col_f32_launch). Returns the launch's cudaGetLastError()
// (0 = launched).
extern "C" int conv_im2col_launch(const void* x, const void* w, void* out, int N, int H, int W,
                                  int C, int R, int S, int Cout, int OH, int OW, int stride,
                                  int pad_t, int pad_l, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * OH * OW;
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const ConvArgs p{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                   static_cast<bf16*>(out), H, W, C, S, OH, OW, stride, pad_t, pad_l, M, Cout,
                   R * S * C};
  const bool vec_a = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec_a && vec_b) launch_bf16<true, true>(p, s);
  else if (vec_a) launch_bf16<true, false>(p, s);
  else if (vec_b) launch_bf16<false, true>(p, s);
  else launch_bf16<false, false>(p, s);
  return static_cast<int>(cudaGetLastError());
}
