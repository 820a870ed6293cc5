// Flash-attention forward (GQA, causal, per-batch kv_valid), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention.py::_mha_kernel. It
// computes the same function: q (B,Sq,H,D) against k, v (B,Sk,KV,D), query
// head h reading KV head h / G; key kpos is visible to query row qpos iff
// kpos < kv_valid[b] (and kpos < Sk) and, when causal, qpos >= kpos. The
// softmax is online in fp32, masked keys get probability exactly 0, P is
// cast to V's dtype before the PV product (attention.py:68), and the
// denominator is floored at 1e-30, so fully masked rows come out 0.
//
// Layout: one CTA per (64-row q block, q head, b), 256 threads as a 16x16
// grid. The TPU kernel folded the whole GQA group into a G*128-row q block
// (1024 rows at G=8), which does not fit a CTA; here each head gets its own
// CTA and re-reads the KV head's tiles (from L2 after the first of the G
// heads). The block loops over 64-key tiles up to the causal limit of its
// last row and to kv_valid, so tiles that are wholly masked are never read.
// K is used in its natural (key, D) layout: the score loop reads K rows from
// shared memory, no transposed copy exists anywhere. Each thread keeps a
// 4x4 score tile and a 4x(D/16) output tile in registers.
//
// What bounds it on this card: operations. At Sq = Sk = 1024 a causal head
// does ~128 FLOPs per byte of q/k/v, so the least time is the causal FLOPs
// over the tensor cores' 989 TFLOP/s. What the design does about that, for
// now: nothing beyond register tiling. Products run as fp32 FMAs from shared
// memory, not on the tensor cores; wgmma tiles fed by TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + n) of a (rows, D) view with row stride `stride`
// elements -> shared fp32, pitch `pitch`; rows at or past `limit` read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src, long stride,
                                          int row0, int n, int limit) {
  constexpr int V = 16 / sizeof(T);
  constexpr int vecs = D / V;
  for (int i = threadIdx.x; i < n * vecs; i += blockDim.x) {
    const int r = i / vecs, c = (i % vecs) * V;
    float* d = dst + r * pitch + c;
    if (row0 + r < limit) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = to_f32(e[k]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = 0.f;
    }
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) mha_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_valid, T* __restrict__ out, int Sq, int Sk, int H, int KV,
    float scale, int causal) {
  constexpr int QP = D + 1, KP = D + 1, SP = kBK + 1;  // padded pitches
  constexpr int NR = kBQ / 16, NS = kBK / 16, NO = D / 16;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* q_s = smem;              // kBQ x QP
  float* k_s = q_s + kBQ * QP;    // kBK x KP
  float* v_s = k_s + kBK * KP;    // kBK x D
  float* p_s = v_s + kBK * D;     // kBQ x SP
  float* m_s = p_s + kBQ * SP;    // kBQ
  float* l_s = m_s + kBQ;         // kBQ
  float* c_s = l_s + kBQ;         // kBQ

  const int q0 = qb * kBQ;
  const int valid = min(kv_valid[b], Sk);
  int kv_end = valid;
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  load_tile<T, D>(q_s, QP, q + ((long)b * Sq * H + h) * D, q_stride, q0, kBQ, Sq);
  for (int i = threadIdx.x; i < kBQ; i += blockDim.x) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }
  float acc[NR][NO];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;

  const T* kb = k + ((long)b * Sk * KV + kh) * D;
  const T* vb = v + ((long)b * Sk * KV + kh) * D;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, KP, kb, kv_stride, k0, kBK, Sk);
    load_tile<T, D>(v_s, D, vb, kv_stride, k0, kBK, Sk);
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
    for (int r = warp; r < kBQ; r += kThreads / 32) {
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
        // P in V's dtype for the PV product; the denominator keeps fp32
        p_s[r * SP + lane + 32 * u] = to_f32(from_f32<T>(pv[u]));
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
    for (int kk = 0; kk < kBK; ++kk) {
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
    T* o = out + (((long)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D + (size_t)kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, void* out, int B,
           int Sq, int Sk, int H, int KV, float scale, int causal, cudaStream_t stream) {
  auto kernel = mha_fwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_valid), static_cast<T*>(out), Sq, Sk, H, KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* kv_valid, void* out, int B,
             int Sq, int Sk, int H, int KV, int D, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, kv_valid, out, B, Sq, Sk, H, KV, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, kv_valid, out, B, Sq, Sk, H, KV, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, kv_valid, out, B, Sq, Sk, H, KV, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, kv_valid, out, B, Sq, Sk, H, KV, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16; D in {16, 32, 64, 128} (the tests',
// the kernel benchmark's and qwen2.5-3b's head dims). Returns the launch's cudaGetLastError() (0 =
// launched).
extern "C" int mha_fwd_launch(const void* q, const void* k, const void* v, const void* kv_valid,
                              void* out, int B, int Sq, int Sk, int H, int KV, int D, int dtype,
                              int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, kv_valid, out, B, Sq, Sk, H, KV, D, scale, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, kv_valid, out, B, Sq, Sk, H, KV, D, scale, causal,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
