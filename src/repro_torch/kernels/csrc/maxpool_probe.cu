// A measurement probe for maxpool.cu, not part of the port's kernel layer
// (build.SOURCES leaves it out; launch/mha_pool_probe.py builds and drives
// it). It runs the 3x3/2 pool in variants the kernel does not keep, so
// that they can be timed beside it with bare launches alike: a thread
// taking a 16-byte vector of channels (4 fp32, 8 bf16) or one element,
// along a strip of SW = 1 or 2 outputs of a row, where each input column's
// maximum over the window rows is taken once and shared by the strip's
// windows; and an empty kernel on maxpool.cu's grid.
#include "maxpool.cu"

#include <stdint.h>

namespace probe {

constexpr int kThreads = 128;

// VEC consecutive channels of T as fp32, and back
template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    f[0] = t.x, f[1] = t.y, f[2] = t.z, f[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// bf16 pairs in 32-bit words: widened exactly, narrowed by their high half
__device__ __forceinline__ void widen(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t narrow(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

template <>
struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    widen(t.x, f[0], f[1]);
    widen(t.y, f[2], f[3]);
    widen(t.z, f[4], f[5]);
    widen(t.w, f[6], f[7]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(narrow(f[0], f[1]), narrow(f[2], f[3]), narrow(f[4], f[5]), narrow(f[6], f[7]));
  }
};

template <typename T>
struct Pack<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&f)[1]) { f[0] = cvt::to_f32(*p); }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) {
    *p = cvt::from_f32<T>(f[0]);
  }
};

template <int VEC>
__device__ __forceinline__ void take_max(float (&m)[VEC], const float (&v)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) m[e] = (v[e] > m[e] || v[e] != v[e]) ? v[e] : m[e];
}

// 3x3/2, VEC channels and SW outputs a thread, 32-bit index math
template <typename T, int VEC, int SW>
__global__ void __launch_bounds__(kThreads)
    pool_vec(const T* __restrict__ x, T* __restrict__ out, int N, int H, int W, int C, int OH,
             int OW) {
  constexpr int WIN = 3, STR = 2, COLS = (SW - 1) * STR + WIN;
  const int cv = C / VEC;
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= static_cast<unsigned>(cv * ((OW + SW - 1) / SW))) return;
  const int c = static_cast<int>(g % cv) * VEC, ow0 = static_cast<int>(g / cv) * SW;
  for (int n = blockIdx.z; n < N; n += gridDim.z)
    for (int oh = blockIdx.y; oh < OH; oh += gridDim.y) {
      float col[COLS][VEC];  // each column's maximum over the window rows
#pragma unroll
      for (int kw = 0; kw < COLS; ++kw)
#pragma unroll
        for (int e = 0; e < VEC; ++e) col[kw][e] = -INFINITY;
#pragma unroll
      for (int kh = 0; kh < WIN; ++kh) {
        const T* row = x + (((long)n * H + oh * STR + kh) * W + ow0 * STR) * C + c;
#pragma unroll
        for (int kw = 0; kw < COLS; ++kw) {
          if (ow0 * STR + kw >= W) continue;  // serves only outputs past OW
          float v[VEC];
          Pack<T, VEC>::load(row + kw * C, v);
          take_max<VEC>(col[kw], v);
        }
      }
      T* o = out + (((long)n * OH + oh) * OW + ow0) * C + c;
#pragma unroll
      for (int j = 0; j < SW; ++j) {
        if (ow0 + j >= OW) break;
        float m[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) m[e] = col[j * STR][e];
#pragma unroll
        for (int kw = 1; kw < WIN; ++kw) take_max<VEC>(m, col[j * STR + kw]);
        Pack<T, VEC>::store(o + j * C, m);
      }
    }
}

template <typename T, int VEC>
int launch_vec(const void* x, void* out, int N, int H, int W, int C, int OH, int OW, int strip,
               cudaStream_t s) {
  const unsigned threads = (unsigned)(C / VEC) * ((OW + strip - 1) / strip);
  const dim3 grid((threads + kThreads - 1) / kThreads, OH < 65535 ? OH : 65535,
                  N < 65535 ? N : 65535);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (strip == 1)
    pool_vec<T, VEC, 1><<<grid, kThreads, 0, s>>>(xp, op, N, H, W, C, OH, OW);
  else if (strip == 2)
    pool_vec<T, VEC, 2><<<grid, kThreads, 0, s>>>(xp, op, N, H, W, C, OH, OW);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty() {}

}  // namespace probe

// 3x3/2 max-pool at vec channels (16 bytes' worth or 1; C a multiple, x
// 16-byte aligned) and strip outputs (1 or 2) a thread; dtype as
// maxpool_launch's. Returns the launch's cudaGetLastError().
extern "C" int maxpool_probe_launch(const void* x, void* out, int N, int H, int W, int C, int OH,
                                    int OW, int dtype, int vec, int strip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return probe::launch_vec<float, 4>(x, out, N, H, W, C, OH, OW, strip, s);
  if (dtype == 0 && vec == 1)
    return probe::launch_vec<float, 1>(x, out, N, H, W, C, OH, OW, strip, s);
  if (dtype == 1 && vec == 8)
    return probe::launch_vec<__nv_bfloat16, 8>(x, out, N, H, W, C, OH, OW, strip, s);
  if (dtype == 1 && vec == 1)
    return probe::launch_vec<__nv_bfloat16, 1>(x, out, N, H, W, C, OH, OW, strip, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// An empty kernel on the grid maxpool_launch takes: the card's floor for a
// launch of that shape.
extern "C" int maxpool_empty_launch(int N, int C, int OH, int OW, void* stream) {
  probe::empty<<<grid_of(N, C, OH, OW), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
