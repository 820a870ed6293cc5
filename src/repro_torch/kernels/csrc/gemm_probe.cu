// A measurement probe for gemm_os.cu's tensor-core paths, not part of the
// port's kernel layer (build.SOURCES leaves it out; launch/gemm_probe.py
// builds and drives it). It runs tc_tile.cuh's mainloop with gemm_os.cu's
// loaders under other tile shapes, with the 16-byte copies through L1
// (.ca) or L2 only (.cg), and without its global loads or without its
// MMAs, so that what sets the kernel's time can be read off the card.
#include "gemm_os.cu"

namespace {

// gemm_os.cu's loaders (16-byte copies through L1 if kL1), or none at all
// (kLoad false: the ring multiplies whatever its stages hold)
template <typename Sh, bool kL1, bool kLoad>
struct ProbeLoad {
  tc_tile::RowMajorA<Sh, true, kL1> a;
  tc_tile::LoadB<Sh, true, kL1> b;

  __device__ __forceinline__ void issue(tc_tile::Stages<Sh>& st, int s, int step) {
    if constexpr (kLoad) {
      a.issue(st, s, step * Sh::BK);
      b.issue(st, s, step * Sh::BK);
    }
  }
  __device__ __forceinline__ void land(tc_tile::Stages<Sh>& st, int s) const {
    if constexpr (kLoad) {
      a.land(st, s);
      b.land(st, s);
    }
  }
};

// policy P with its MMA left out: the mainloop still loads its stages and
// reads the fragments (ldmatrix)
template <typename P>
struct NoMma : P {
  template <typename D>
  static __device__ __forceinline__ void mma(D&, const uint32_t (&)[4], uint32_t, uint32_t) {}
};

enum Mode { kFull = 0, kNoLoads = 1, kNoMmas = 2 };

template <typename Sh, int kMode>
using ModeShape = std::conditional_t<
    kMode == kNoMmas,
    tc_tile::Shape<NoMma<typename Sh::P>, Sh::BM, Sh::BN, Sh::WM, Sh::WN, Sh::BK, Sh::kStages>,
    Sh>;

// tc_tile::mainloop itself, under the mode's loader and policy
template <typename Sh, bool kL1, int kMode, typename TO, typename Epi>
__global__ void __launch_bounds__(tc_tile::kThreads)
    probe_kernel(const typename Sh::T* __restrict__ x, const typename Sh::T* __restrict__ w,
                 TO* __restrict__ out, int M, int N, int K, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto& st = *reinterpret_cast<tc_tile::Stages<Sh>*>(smem);
  const int m0 = blockIdx.y * Sh::BM, n0 = blockIdx.x * Sh::BN;
  tc_tile::Accum<Sh> acc = {};
  ProbeLoad<Sh, kL1, kMode != kNoLoads> load{{x, M, K, m0}, {w, K, N, n0}};
  tc_tile::mainloop<Sh>(st, load, (K + Sh::BK - 1) / Sh::BK, acc);
  tc_tile::store<Sh>(out, M, N, m0, n0, acc, epi);
}

template <typename Sh0, bool kL1, int kMode>
int probe(const void* x, const void* w, void* out, int M, int N, int K, float scale,
          cudaStream_t s) {
  using Sh = ModeShape<Sh0, kMode>;
  using T = typename Sh::T;
  using TO = std::conditional_t<std::is_same_v<T, int8_t>, int8_t, bf16>;
  using Epi = std::conditional_t<std::is_same_v<T, int8_t>, Quant, tc_tile::Round<bf16>>;
  constexpr int kSmem = sizeof(tc_tile::Stages<Sh>);
  auto* kernel = probe_kernel<Sh, kL1, kMode, TO, Epi>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  const dim3 grid((N + Sh::BN - 1) / Sh::BN, (M + Sh::BM - 1) / Sh::BM);
  Epi epi;
  if constexpr (std::is_same_v<Epi, Quant>) epi.scale = scale;
  kernel<<<grid, tc_tile::kThreads, kSmem, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                static_cast<TO*>(out), M, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

using tc_tile::Shape;
using B64 = Tiles<Bf16>::Big;      // gemm_os.cu's tiles
using B32 = Tiles<Bf16>::Small;
using S64 = Tiles<S8>::Big;
using S32 = Tiles<S8>::Small;
using B128 = Shape<Bf16, 128, 128, 64, 64, 32, 4>;
using B128x64 = Shape<Bf16, 128, 64, 64, 32, 32, 4>;
using B64x128 = Shape<Bf16, 64, 128, 32, 64, 64, 4>;
using S64k64 = Shape<S8, 64, 64, 32, 32, 64, 4>;

}  // namespace

// Launches probe `variant` on bf16 (0-9) or int8 (10-16) inputs: bf16
// out, or int8 through the quant epilogue. The table of variants is
// launch/gemm_probe.py's VARIANTS. Returns cudaGetLastError(), or -1 for
// an unknown variant.
extern "C" int gemm_probe_launch(int variant, const void* x, const void* w, void* out, int M,
                                 int N, int K, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return probe<B64, true, kFull>(x, w, out, M, N, K, scale, s);
    case 1: return probe<B64, true, kNoMmas>(x, w, out, M, N, K, scale, s);
    case 2: return probe<B64, true, kNoLoads>(x, w, out, M, N, K, scale, s);
    case 3: return probe<B64, false, kFull>(x, w, out, M, N, K, scale, s);
    case 4: return probe<B64, false, kNoMmas>(x, w, out, M, N, K, scale, s);
    case 5: return probe<B128, false, kFull>(x, w, out, M, N, K, scale, s);
    case 6: return probe<B128, false, kNoMmas>(x, w, out, M, N, K, scale, s);
    case 7: return probe<B128x64, false, kFull>(x, w, out, M, N, K, scale, s);
    case 8: return probe<B64x128, false, kFull>(x, w, out, M, N, K, scale, s);
    case 9: return probe<B32, true, kFull>(x, w, out, M, N, K, scale, s);
    case 10: return probe<S64, true, kFull>(x, w, out, M, N, K, scale, s);
    case 11: return probe<S64, true, kNoMmas>(x, w, out, M, N, K, scale, s);
    case 12: return probe<S64, true, kNoLoads>(x, w, out, M, N, K, scale, s);
    case 13: return probe<S64, false, kFull>(x, w, out, M, N, K, scale, s);
    case 14: return probe<S64k64, true, kFull>(x, w, out, M, N, K, scale, s);
    case 15: return probe<S32, true, kFull>(x, w, out, M, N, K, scale, s);
    case 16: return probe<S32, true, kNoMmas>(x, w, out, M, N, K, scale, s);
  }
  return -1;
}
