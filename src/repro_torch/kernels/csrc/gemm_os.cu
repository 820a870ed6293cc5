// Output-stationary GEMM, float and int8 with the fused quantisation
// epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gemm_os.py::_gemm_kernel
// (gemm_os.py:35). It computes the same function: out = x (M,K) @ w (K,N),
// both row-major. Float inputs (fp32, bf16) accumulate in fp32 and store in
// the requested float type; int8 inputs accumulate in int32 and store int32,
// or, with the epilogue, int8 = clip(rint(float(acc) * scale), -128, 127).
// rintf rounds half to even, as jnp.round does; acc becomes fp32 with
// __int2float_rn and the product is one fp32 multiply, as in JAX.
//
// Layout: one CTA per output tile, its accumulator in registers for its
// whole depth sweep, written once: the TPU kernel's VMEM-resident
// accumulator and Voltra's output-stationarity. Ragged edges are masked in
// the kernel: no padded copy of x or w is made, unlike the JAX wrapper's
// jnp.pad. Each output has one summation order: bf16 and int8 sum all of K
// in one thread; fp32 may split K into ranges over CTAs (a fixed-order
// split, below), each summed by one thread, the partials added in rank
// order by a second pass. No atomics: two runs give the same bits.
//
// What bounds it on this card, at the paper's BERT-Base FFN shapes: bytes,
// barely. bf16 512 x 768 x 3072: 8.7 MB over 3.35 TB/s = 2.6 us, its
// 2.4 GFLOP over 989 TFLOP/s 2.4 us. int8 512 x 3072 x 768 with the
// epilogue: 4.3 MB = 1.3 us, 2.4 GOP over 1,979 TOP/s 1.2 us.
//
// bf16 and int8: the tensor-core mainloop of tc_tile.cuh, mma.sync on a
// ring of 4 shared-memory stages (bf16: m16n8k16 with fp32 accumulators;
// int8: m16n8k32 with int32 accumulators, w transposed into its stages by
// the TransposeB loader, since the MMA wants w's K values contiguous per
// column). x arrives as 16-byte cp.async copies where its rows are whole
// 16-byte chunks and it is 16-byte aligned, w likewise by columns; else as
// scalar loads, staged in registers across a stage's products. The
// launcher decides this from the pointers: a contiguous view may start at
// any byte. Tiles: 64 x 64 or 32 x 32, whichever leaves the busiest SM
// fewer bytes to load (busiest_sm_rows): 64 x 64 at both FFN products.
// The int8 epilogue runs in registers on the accumulator fragments.
//
// What limits it now (launch/gemm_probe.py, H100): the loads first. With
// copies through L2 only (.cg) the mainloop without its MMAs took as long
// as the kernel (bf16 0.023 ms), and tiles from 64 x 64 to 128 x 128 all
// took 0.022-0.026 ms though the largest read half the bytes from L2.
// Copies through L1 (.ca) cut the loads to 0.016 ms and the kernel to
// 0.021; without its loads the kernel takes 0.014 (mma.sync, 4 warps a
// CTA), so both count now. int8 on cold inputs: 0.022 without its MMAs,
// 0.021 in all. cuBLAS takes 0.0061 ms at the bf16 shape and
// torch._int_mm with w column-major 0.0085 at the int8 one. Next: TMA into
// the ring, wgmma, and larger tiles shared over a cluster.
//
// fp32: exact fp32 on the FMA units (TF32 tensor cores would miss the
// ref.sum_order_error limit, depth * 2^-24 of |x| @ |w|), through
// os_tile.cuh: 64 x 64 tiles, 8 x 4 outputs a thread read as float4 from
// shared memory, a ring of 4 cp.async stages 16 deep, and the depth split
// over CTAs in a fixed order where the tiles alone leave the SMs short of
// warps (os_tile::plan). What bounds it: operations, 2 M N K over 67
// TFLOP/s. Its source note gives the design, what it reaches, and the
// variants tried and not kept.
#include <cuda_bf16.h>

#include "os_tile.cuh"
#include "tc_tile.cuh"

namespace {

// ===========================================================================
// fp32: the os_tile FMA loop
// ===========================================================================

// A = x (M, K) row-major: rows [m0, m0 + BM), depth [k0, k0 + BK) of the
// stage, zeros past M and at and past k_end. vec (a runtime flag, uniform
// over the grid): K % 4 == 0 and x 16-byte aligned, 16-byte copies of 4
// depth values; else 4-byte copies.
template <typename Sh>
struct RowMajorF32 {
  const float* x;
  int M, K, m0;
  bool vec;

  __device__ __forceinline__ void issue(os_tile::Stages<Sh>& st, int s, int k0, int k_end) const {
    constexpr int BK = Sh::BK, kT = Sh::kThreads;
    if (vec) {
#pragma unroll
      for (int i = 0; i < Sh::BM * BK / 4 / kT; ++i) {
        const int e = threadIdx.x + kT * i, r = e / (BK / 4), k = 4 * (e % (BK / 4));
        const bool in = m0 + r < M && k0 + k < k_end;
        os_tile::cp_async16<true>(&st.a[s][r][k], in ? x + (long)(m0 + r) * K + k0 + k : x, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < Sh::BM * BK / kT; ++i) {
        const int e = threadIdx.x + kT * i, r = e / BK, k = e % BK;
        const bool in = m0 + r < M && k0 + k < k_end;
        os_tile::cp_async4(&st.a[s][r][k], in ? x + (long)(m0 + r) * K + k0 + k : x, in);
      }
    }
  }
};

// One CTA: the tile (blockIdx.y, blockIdx.x) over depth range blockIdx.z
// of `chunk` values. ws null: one range, out written directly; else the
// partial sums into the workspace, for reduce_splits.
template <typename TO>
__global__ void __launch_bounds__(os_tile::Tile::kThreads, 1)
    gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, TO* __restrict__ out,
                    float* __restrict__ ws, int M, int N, int K, int chunk, bool vec_a, bool vec_b,
                    bool vec_out) {
  using T = os_tile::Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  auto& st = *reinterpret_cast<os_tile::Stages<T>*>(smem);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * chunk, k_end = min(K, k_begin + chunk);
  os_tile::Accum<T> acc = {};
  const RowMajorF32<T> a{x, M, K, m0, vec_a};
  const os_tile::LoadB<T> b{w, N, n0, vec_b};
  os_tile::mainloop<T>(st, a, b, k_begin, k_end, acc);
  if (ws)
    os_tile::store_partial<T>(ws, m0, n0, acc);
  else
    os_tile::store<T>(out, M, N, m0, n0, acc, vec_out);
}

template <typename TO>
int launch_f32(const void* x, const void* w, void* out, void* ws, int M, int N, int K, int chunk,
               cudaStream_t s) {
  using T = os_tile::Tile;
  const int splits = static_cast<int>(os_tile::cdiv(K, chunk));
  const dim3 grid(os_tile::cdiv(N, T::BN), os_tile::cdiv(M, T::BM), splits);
  const bool vec_a = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * sizeof(TO)) == 0;
  TO* o = static_cast<TO*>(out);
  float* partial = splits > 1 ? static_cast<float*>(ws) : nullptr;
  gemm_f32_kernel<TO><<<grid, T::kThreads, sizeof(os_tile::Stages<T>), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), o, partial, M, N, K, chunk, vec_a,
      vec_b, vec_out);
  return os_tile::finish(partial, o, M, N, grid.y * T::BM, grid.x * T::BN, splits, s);
}

// ===========================================================================
// bf16 and int8: the tensor-core mainloop
// ===========================================================================

using bf16 = __nv_bfloat16;
using tc_tile::Bf16;
using tc_tile::S8;

// x and w; the 16-byte copies go through L1 (.ca), which fed the 64 x 64
// bf16 tiles 10% faster than L2 only (.cg), the int8 ones within 3%
template <typename Sh, bool kVecA, bool kVecB>
struct GemmLoad {
  tc_tile::RowMajorA<Sh, kVecA, true> a;
  tc_tile::LoadB<Sh, kVecB, true> b;

  __device__ __forceinline__ void issue(tc_tile::Stages<Sh>& st, int s, int step) {
    a.issue(st, s, step * Sh::BK);
    b.issue(st, s, step * Sh::BK);
  }
  __device__ __forceinline__ void land(tc_tile::Stages<Sh>& st, int s) const {
    a.land(st, s);
    b.land(st, s);
  }
};

// int32 accumulators stored as they are
struct Exact {
  __device__ __forceinline__ int32_t operator()(int32_t acc) const { return acc; }
};

// the fused quant epilogue, bit for bit as ref.gemm_ref and the JAX kernel
struct Quant {
  float scale;
  __device__ __forceinline__ int8_t operator()(int32_t acc) const {
    const float q = rintf(__fmul_rn(__int2float_rn(acc), scale));
    return static_cast<int8_t>(fminf(fmaxf(q, -128.f), 127.f));
  }
};

// the ring lives in dynamic shared memory: the int8 64 x 64 stages take
// 72 KB, above the 48 KB a static array may hold
template <typename Sh, bool kVecA, bool kVecB, typename TO, typename Epi>
__global__ void __launch_bounds__(tc_tile::kThreads)
    gemm_tc_kernel(const typename Sh::T* __restrict__ x, const typename Sh::T* __restrict__ w,
                   TO* __restrict__ out, int M, int N, int K, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto& st = *reinterpret_cast<tc_tile::Stages<Sh>*>(smem);
  const int m0 = blockIdx.y * Sh::BM, n0 = blockIdx.x * Sh::BN;
  tc_tile::Accum<Sh> acc = {};
  GemmLoad<Sh, kVecA, kVecB> load{{x, M, K, m0}, {w, K, N, n0}};
  tc_tile::mainloop<Sh>(st, load, (K + Sh::BK - 1) / Sh::BK, acc);
  tc_tile::store<Sh>(out, M, N, m0, n0, acc, epi);
}

// Two tiles per policy, 4 stages each: 64 x 64, and 32 x 32 twice as deep
// per stage (more bytes in flight per CTA, as the conv's small tiles).
// int8 stages are 128 deep: at 64 deep the register-staged transpose of w
// has one stage's products to land in, and the FFN's second product took
// 0.038 ms instead of 0.021 on cold inputs (launch/gemm_probe.py).
template <typename P>
struct Tiles;
template <>
struct Tiles<Bf16> {
  using Big = tc_tile::Shape<Bf16, 64, 64, 32, 32, 32, 4>;
  using Small = tc_tile::Shape<Bf16, 32, 32, 16, 16, 64, 4>;
};
template <>
struct Tiles<S8> {
  using Big = tc_tile::Shape<S8, 64, 64, 32, 32, 128, 4>;
  using Small = tc_tile::Shape<S8, 32, 32, 16, 16, 128, 4>;
};

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename Sh, bool kVecA, bool kVecB, typename TO, typename Epi>
void launch_tile(const void* x, const void* w, void* out, int M, int N, int K, Epi epi,
                 cudaStream_t s) {
  using T = typename Sh::T;
  constexpr int kSmem = sizeof(tc_tile::Stages<Sh>);
  auto* kernel = gemm_tc_kernel<Sh, kVecA, kVecB, TO, Epi>;
  static int sized_for = -1;  // the device whose limit was raised; a failure shows at the launch
  int dev = 0;
  cudaGetDevice(&dev);
  if (sized_for != dev) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    sized_for = dev;
  }
  const dim3 grid((N + Sh::BN - 1) / Sh::BN, (M + Sh::BM - 1) / Sh::BM);
  kernel<<<grid, tc_tile::kThreads, kSmem, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                static_cast<TO*>(out), M, N, K, epi);
}

// Bytes of x and w that the busiest SM reads through shape Sh: its CTAs
// (tiles over SMs, rounded up) times (BM + BN) rows of depth each. The
// loads set most of the time of both paths (launch/gemm_probe.py), so the
// launcher takes the tile whose busiest SM reads less; a tie goes to
// 64 x 64, which reads less in all. The FFN's first product: 384 CTAs of
// 64 x 64 (3 per SM x 128 rows) against 1536 of 32 x 32 (12 x 64), 0.021
// against 0.033 ms; its second: 96 of 64 x 64 (1 x 128) against 384 of
// 32 x 32 (3 x 64), 0.021 against 0.023. At 256 x 1024 x 256, 32 x 32
// (64 against 128 rows): 0.0068 against 0.0130 ms (bf16), 0.0053 against
// 0.0069 (int8).
template <typename Sh>
long busiest_sm_rows(int M, int N) {
  const long tiles = (long)((M + Sh::BM - 1) / Sh::BM) * ((N + Sh::BN - 1) / Sh::BN);
  return (tiles + sm_count() - 1) / sm_count() * (Sh::BM + Sh::BN);
}

template <typename P, bool kVecA, bool kVecB, typename TO, typename Epi>
void launch_tiles(const void* x, const void* w, void* out, int M, int N, int K, Epi epi,
                  cudaStream_t s) {
  using Big = typename Tiles<P>::Big;
  using Small = typename Tiles<P>::Small;
  if (busiest_sm_rows<Big>(M, N) <= busiest_sm_rows<Small>(M, N))
    launch_tile<Big, kVecA, kVecB, TO>(x, w, out, M, N, K, epi, s);
  else
    launch_tile<Small, kVecA, kVecB, TO>(x, w, out, M, N, K, epi, s);
}

// 16-byte copies of x where K is a whole number of 16-byte chunks and x is
// 16-byte aligned; of w where N is, and w is
template <typename P, typename TO, typename Epi>
int launch_tc(const void* x, const void* w, void* out, int M, int N, int K, Epi epi,
              cudaStream_t s) {
  constexpr int kChunk = 16 / sizeof(typename P::T);
  const bool vec_a = K % kChunk == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = N % kChunk == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec_a && vec_b) launch_tiles<P, true, true, TO>(x, w, out, M, N, K, epi, s);
  else if (vec_a) launch_tiles<P, true, false, TO>(x, w, out, M, N, K, epi, s);
  else if (vec_b) launch_tiles<P, false, true, TO>(x, w, out, M, N, K, epi, s);
  else launch_tiles<P, false, false, TO>(x, w, out, M, N, K, epi, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 int32. Built here: bfloat16
// in (tensor cores) -> float32 or bfloat16 out; int8 in (tensor cores) ->
// int32 out (quant 0) or int8 out (quant 1, with scale). float32 in goes
// through gemm_os_f32_launch. Returns the launch's cudaGetLastError()
// (0 = launched).
extern "C" int gemm_os_launch(const void* x, const void* w, void* out, int M, int N, int K,
                              int in_dtype, int out_dtype, int quant, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_tc<Bf16, float>(x, w, out, M, N, K, tc_tile::Round<float>{}, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_tc<Bf16, bf16>(x, w, out, M, N, K, tc_tile::Round<bf16>{}, s);
  if (in_dtype == 2 && quant == 0 && out_dtype == 3)
    return launch_tc<S8, int32_t>(x, w, out, M, N, K, Exact{}, s);
  if (in_dtype == 2 && quant == 1 && out_dtype == 2)
    return launch_tc<S8, int8_t>(x, w, out, M, N, K, Quant{scale}, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fp32 path's plan for an (M, K) @ (K, N) product on `sms` SMs
// (os_tile::plan): plan[0..3] = tile rows, tile columns, depth values per
// range (`chunk`), ranges (`splits`). With splits > 1 the launch needs a
// workspace of splits * ceil(M / rows) * rows * ceil(N / cols) * cols
// floats.
extern "C" void gemm_os_f32_plan(int M, int N, int K, int sms, int* plan) {
  const os_tile::Plan p = os_tile::plan(M, N, K, sms, 0);
  plan[0] = os_tile::Tile::BM;
  plan[1] = os_tile::Tile::BN;
  plan[2] = p.chunk;
  plan[3] = p.splits;
}

// fp32 x (M, K) @ w (K, N) -> out (M, N), float32 (out_dtype 0) or
// bfloat16 (1), with the depth cut into ranges of `chunk` values (a
// multiple of 16); ws: the workspace where there is more than one range,
// else unused. Any chunk gives the same function up to the order of the
// sums; gemm_os_f32_plan's is the one the wrapper takes.
extern "C" int gemm_os_f32_launch(const void* x, const void* w, void* out, void* ws, int M,
                                  int N, int K, int out_dtype, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk % os_tile::Tile::BK != 0 || (chunk < K && ws == nullptr) ||
      os_tile::cdiv(K, chunk) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == 0) return launch_f32<float>(x, w, out, ws, M, N, K, chunk, s);
  if (out_dtype == 1) return launch_f32<bf16>(x, w, out, ws, M, N, K, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
