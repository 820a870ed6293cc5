// fp32 <-> storage-type conversions shared by the kernel-layer sources
// (os_tile.cuh, and through it gemm_os.cu and conv_im2col.cu; maxpool.cu;
// mha.cu; tc_tile.cuh):
// bf16 widens to fp32 exactly and narrows round-to-nearest-even.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace cvt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// two fp32 values -> one 32-bit word of bf16 (lo in the low half), round to
// nearest even: a bf16 register pair as the tensor cores take it
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace cvt
