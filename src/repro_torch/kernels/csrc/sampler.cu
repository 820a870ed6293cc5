// The sampler's Gumbel noise: jax.random.gumbel(key, (n,), float32) for
// every row's key, in one elementwise pass, for Hopper (sm_90a).
//
// Replaces what the JAX engine's step computes with jax.random (XLA, no
// Pallas kernel): src/repro/runtime/sampling.py gumbel_argmax, the noise of
// the categorical draw argmax(z + g). Row r's key is jax's
// fold_in(fold_in(fold_in(fold_in(key(seed[r]), rid[r]), idx[r]), draw):
// key(s) is the words (0, s) and fold_in(k, d) = threefry2x32(k, (0, d)).
// Element i of the row hashes the counter words (0, i) under that key with
// Threefry-2x32 (20 rounds, jax's rotations and key schedule), xors the two
// output words (jax_threefry_partitionable), takes 23 mantissa bits under
// the exponent of 1.0 for u in [0, 1), scales it onto [tiny, 1) and writes
// -log(-log(u)). The words are uint32 registers here, where the plain
// version (kernels/ref.py) masks int64 tensors: the same bits. logf is
// CUDA's accurate one (1 ulp), not __logf. Folding the key in the kernel
// keeps the ~170 small tensor ops of the plain fold off the decode graph.
//
// What bounds it on this card: the integer operations. Each element takes
// four hashes (three folds and its own, ~130 32-bit integer operations
// each; the folds are the same for a whole row and a thread redoes them,
// which costs less than a barrier) and two logs, and writes 4 bytes, so at a
// serving step's (8, 152064) the hashes, not the 4.9 MB written, set the
// least time. One thread an element, 256 threads a CTA, grid (ceil(n / 256),
// rows); there is no shared memory and no reuse to stage.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ void round4(uint32_t& a, uint32_t& b, int r0, int r1, int r2, int r3) {
  a += b; b = rotl(b, r0) ^ a;
  a += b; b = rotl(b, r1) ^ a;
  a += b; b = rotl(b, r2) ^ a;
  a += b; b = rotl(b, r3) ^ a;
}

// Threefry-2x32 of counter (x0, x1) under key (k0, k1), in place: (x0, x1)
// become the two output words.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t a = x0 + k0, b = x1 + k1;
  round4(a, b, 13, 15, 26, 6);
  a += k1; b += k2 + 1u;
  round4(a, b, 17, 29, 16, 24);
  a += k2; b += k0 + 2u;
  round4(a, b, 13, 15, 26, 6);
  a += k0; b += k1 + 3u;
  round4(a, b, 17, 29, 16, 24);
  a += k1; b += k2 + 4u;
  round4(a, b, 13, 15, 26, 6);
  a += k2; b += k0 + 5u;
  x0 = a;
  x1 = b;
}

// mode 0: Gumbel noise as float32; mode 1: the raw uint32 bits (a check).
__global__ void __launch_bounds__(256) sampler_noise_kernel(
    const int64_t* __restrict__ seed, const int64_t* __restrict__ rid,
    const int64_t* __restrict__ idx, uint32_t draw, void* __restrict__ out, int n, int mode) {
  const int r = blockIdx.y;
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  // key(seed) = (0, seed); three folds: rid, idx, draw
  uint32_t k0 = 0u, k1 = static_cast<uint32_t>(seed[r]);
  const uint32_t data[3] = {static_cast<uint32_t>(rid[r]), static_cast<uint32_t>(idx[r]), draw};
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    uint32_t x0 = 0u, x1 = data[f];
    threefry(k0, k1, x0, x1);
    k0 = x0;
    k1 = x1;
  }
  uint32_t x0 = 0u, x1 = static_cast<uint32_t>(i);
  threefry(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  const long at = (long)r * n + i;
  if (mode == 1) {
    static_cast<uint32_t*>(out)[at] = bits;
    return;
  }
  const float unit = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  // (1 - tiny) is 1.0f in float32, as jax computes maxval - minval
  const float tiny = 1.17549435e-38f;
  const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(unit, 1.0f), tiny));
  static_cast<float*>(out)[at] = -logf(-logf(u));
}

}  // namespace

// seed, rid, idx: (rows,) int64 (taken as uint32); out: (rows, n) float32
// (mode 0) or uint32 (mode 1). Returns the launch's cudaGetLastError().
extern "C" int sampler_noise_launch(const void* seed, const void* rid, const void* idx, int draw,
                                    void* out, int rows, int n, int mode, void* stream) {
  if (rows <= 0 || n <= 0 || rows > 65535 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + 255) / 256, rows);
  sampler_noise_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seed), static_cast<const int64_t*>(rid),
      static_cast<const int64_t*>(idx), static_cast<uint32_t>(draw), out, n, mode);
  return static_cast<int>(cudaGetLastError());
}
