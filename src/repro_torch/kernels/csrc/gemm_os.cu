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
// Layout: one CTA per 64 x 64 output tile, its accumulator in registers for
// the whole K sweep (os_tile.cuh for float; the int8 loop below), written
// once; this is the TPU kernel's VMEM-resident accumulator and Voltra's
// output-stationarity. Ragged edges are masked in the kernel: no padded copy
// of x or w is made, unlike the JAX wrapper's jnp.pad.
//
// What bounds it on this card: operations, at the paper's BERT-Base FFN
// shapes (512 x 768 x 3072: ~400 FLOPs per byte of inputs). The least time
// is 2MKN over the tensor cores' rate (989 TFLOP/s bf16, 1979 TOP/s int8),
// or over 67 TFLOP/s for fp32. What the design does about that, for now:
// register tiling only. Float products are fp32 FMAs (never TF32, which
// keeps ~3 digits); int8 products are __dp4a (4 MACs per instruction) on
// words packed in shared memory: w is (K, N) row-major, so the four K values
// of one column are strided in memory and are packed on the way in.
// Tensor-core tiles (wgmma, TMA) are later work.
#include "os_tile.cuh"

namespace {

using os_tile::kThreads;
using os_tile::kTile;

template <typename T>
struct RowMajor {
  const T* x;
  int K;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return os_tile::to_f32(x[(long)m * K + k]);
  }
};

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const TI* __restrict__ x, const TI* __restrict__ w, TO* __restrict__ out, int M,
                    int N, int K) {
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  os_tile::accumulate(RowMajor<TI>{x, K}, w, M, N, K, m0, n0, acc);
  os_tile::store(out, M, N, m0, n0, acc);
}

constexpr int kWords = 8;  // packed 4-byte words of depth per stage (32 K values)

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (int)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) | ((uint32_t)(uint8_t)c << 16) |
               ((uint32_t)(uint8_t)d << 24));
}

// quant == 0: out is int32 acc; quant == 1: out is the int8 epilogue.
__global__ void __launch_bounds__(kThreads)
    gemm_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, void* __restrict__ out,
                     int M, int N, int K, int quant, float scale) {
  __shared__ int a_s[kWords][kTile + 1];  // a_s[p][m] = x[m, k0+4p .. k0+4p+3]
  __shared__ int b_s[kWords][kTile];      // b_s[p][n] = w[k0+4p .. k0+4p+3, n]
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 4 * kWords) {
    for (int e = threadIdx.x; e < kTile * kWords; e += kThreads) {
      const int m = e / kWords, p = e % kWords;
      const int row = m0 + m, k = k0 + 4 * p;
      int8_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = (row < M && k + u < K) ? x[(long)row * K + k + u] : 0;
      a_s[p][m] = pack4(v[0], v[1], v[2], v[3]);
    }
    for (int e = threadIdx.x; e < kTile * kWords; e += kThreads) {
      const int p = e / kTile, n = e % kTile;
      const int col = n0 + n, k = k0 + 4 * p;
      int8_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = (col < N && k + u < K) ? w[(long)(k + u) * N + col] : 0;
      b_s[p][n] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kWords; ++p) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[p][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[p][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const long o = (long)m * N + n;
      if (quant) {
        const float q = rintf(__fmul_rn(__int2float_rn(acc[i][j]), scale));
        static_cast<int8_t*>(out)[o] = static_cast<int8_t>(fminf(fmaxf(q, -128.f), 127.f));
      } else {
        static_cast<int32_t*>(out)[o] = acc[i][j];
      }
    }
  }
}

template <typename TI, typename TO>
int launch_f32(const void* x, const void* w, void* out, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  gemm_f32_kernel<TI, TO><<<grid, kThreads, 0, s>>>(static_cast<const TI*>(x),
                                                    static_cast<const TI*>(w),
                                                    static_cast<TO*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 int32. Built: float32 or
// bfloat16 in -> float32 or bfloat16 out; int8 in -> int32 out (quant 0) or
// int8 out (quant 1, with scale). Returns the launch's cudaGetLastError()
// (0 = launched).
extern "C" int gemm_os_launch(const void* x, const void* w, void* out, int M, int N, int K,
                              int in_dtype, int out_dtype, int quant, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return launch_f32<float, float>(x, w, out, M, N, K, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_f32<float, __nv_bfloat16>(x, w, out, M, N, K, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_f32<__nv_bfloat16, float>(x, w, out, M, N, K, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_f32<__nv_bfloat16, __nv_bfloat16>(x, w, out, M, N, K, s);
  if (in_dtype == 2 && ((quant == 0 && out_dtype == 3) || (quant == 1 && out_dtype == 2))) {
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    gemm_int8_kernel<<<grid, kThreads, 0, s>>>(static_cast<const int8_t*>(x),
                                               static_cast<const int8_t*>(w), out, M, N, K, quant,
                                               scale);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
