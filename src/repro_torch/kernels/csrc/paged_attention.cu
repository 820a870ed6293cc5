// Paged flash-decode over a shared KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_paged_kernel.
// It computes the same function: for request b and KV head h, the T*G query
// rows (row r = t*G + g holds query token t of head h*G + g) attend to the
// request's keys, found page by page through block_table[b, :]. Row t sits at
// absolute position base + t (base = lengths[b] - T) and sees keys at
// positions < base + t + 1 (and > base + t - window when window > 0). The
// softmax is online in fp32: masked keys get probability exactly 0, the
// denominator is floored at 1e-30. int8 pools are dequantized per tile
// (x * kv_scale / 127) as they are loaded.
//
// Layout: one CTA per (kv_head, b). The TPU walked the pages as a sequential
// grid axis with the table in scalar prefetch; here the block loads its own
// table row and length and loops over the live pages itself. Per page it
// copies `page` rows of D elements (strided by KV*D in the pool) in chunks of
// at most 32 rows into shared memory as fp32, with 16-byte vector loads.
// Pages at or past lengths[b] are never read; with a window, pages wholly
// below the earliest row's window are skipped as well.
//
// What bounds it on this card: bytes. Each K/V element read is used by T*G
// query rows only (8 at G=8, T=1), far below the ~295 operations per byte
// at which an H100 stops being memory bound, so the least time is the live
// K/V bytes over 3.35 TB/s. What the design does about that: every live K/V
// byte is read from device memory once per (b, kv_head), shared by all the
// G heads of the group and all T rows (GQA and the T block are folded into
// the rows of one tile), and nothing but the output is written. Known
// weakness: the grid is B*KV CTAs (16 at the serving batch), far fewer than
// the 132 SMs, and each chunk's loads are not overlapped with compute;
// splitting the page sweep across CTAs and pipelining the loads are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows x D elements (row i at src + i * stride) -> shared fp32 * mul, row
// pitch `pitch` floats. 16-byte vector loads: the caller guarantees D,
// stride and the base pointer are multiples of 16 bytes.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src, long stride,
                                          int rows, int D, float mul) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = D / V;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs, c = (i % vecs) * V;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * pitch + c;
#pragma unroll
    for (int k = 0; k < V; ++k) d[k] = to_f32(e[k]) * mul;
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

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool, const KT* __restrict__ v_pool,
    const int* __restrict__ block_table, const int* __restrict__ lengths, QT* __restrict__ out,
    int T, int H, int KV, int D, int page, int n_blocks, int chunk, float scale, float dequant,
    int window) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int R = T * G;
  const int pitch = D + 1;  // padded rows: column reads hit distinct banks

  extern __shared__ float smem[];
  float* q_s = smem;                   // R x pitch
  float* k_s = q_s + R * pitch;        // chunk x pitch
  float* v_s = k_s + chunk * pitch;    // chunk x D
  float* p_s = v_s + chunk * D;        // R x chunk (scores, then probabilities)
  float* acc = p_s + R * chunk;        // R x D fp32 output accumulator
  float* m_s = acc + R * D;            // R running max
  float* l_s = m_s + R;                // R running denominator
  float* c_s = l_s + R;                // R correction of this chunk

  const int len = lengths[b];
  const int base = len - T;
  for (int t = 0; t < T; ++t)
    load_rows(q_s + t * G * pitch, pitch, q + ((long)(b * T + t) * H + h * G) * D, D, G, D, 1.f);
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) acc[i] = 0.f;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }

  // live pages: [first, last). Pages at or past the length hold no live
  // key; with a window, pages with (i+1)*page <= base - window + 1 lie
  // wholly below the earliest row's window.
  int first = 0;
  if (window > 0 && base - window + 1 > 0) first = (base - window + 1) / page;
  const int last = min(n_blocks, (len + page - 1) / page);
  const int* bt = block_table + (long)b * n_blocks;
  const long row_stride = (long)KV * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = first; i < last; ++i) {
    const long pg = bt[i];
    for (int c0 = 0; c0 < page; c0 += chunk) {
      const int pos0 = i * page + c0;
      if (pos0 >= len) break;  // uniform across the block
      __syncthreads();         // the previous chunk's readers are done
      const long off = (pg * page + c0) * row_stride + (long)h * D;
      load_rows(k_s, pitch, k_pool + off, row_stride, chunk, D, dequant);
      load_rows(v_s, D, v_pool + off, row_stride, chunk, D, dequant);
      __syncthreads();

      for (int idx = threadIdx.x; idx < R * chunk; idx += blockDim.x) {
        const int r = idx / chunk, j = idx % chunk;
        const float* qr = q_s + r * pitch;
        const float* kr = k_s + j * pitch;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        p_s[idx] = s * scale;
      }
      __syncthreads();

      // online softmax, one warp per row (chunk <= 32: one key per lane)
      for (int r = warp; r < R; r += kThreads / 32) {
        const int t = r / G;
        const int pos = pos0 + lane;
        bool ok = lane < chunk && pos < base + t + 1;
        if (window > 0) ok = ok && pos > base + t - window;
        const float s = ok ? p_s[r * chunk + lane] : kNeg;
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        if (lane < chunk) p_s[r * chunk + lane] = p;
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          c_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
        const int r = idx / D, d = idx % D;
        const float* pr = p_s + r * chunk;
        float a = acc[idx] * c_s[r];
        for (int j = 0; j < chunk; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
        acc[idx] = a;
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    const int t = r / G, g = r % G;
    out[((long)(b * T + t) * H + h * G + g) * D + d] =
        from_f32<QT>(acc[idx] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* block_table,
           const void* lengths, void* out, int B, int T, int H, int KV, int D, int page,
           int n_blocks, int chunk, float scale, float dequant, int window, size_t smem,
           cudaStream_t stream) {
  auto kernel = paged_decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool), static_cast<const KT*>(v_pool),
      static_cast<const int*>(block_table), static_cast<const int*>(lengths),
      static_cast<QT*>(out), T, H, KV, D, page, n_blocks, chunk, scale, dequant, window);
  return static_cast<int>(cudaGetLastError());
}

// keys per shared-memory tile: the whole page, or 32-row slices of it
int chunk_rows(int page) { return page <= 32 ? page : 32; }

size_t smem_bytes(int T, int H, int KV, int D, int page) {
  const size_t chunk = chunk_rows(page), R = (size_t)T * (H / KV);
  return sizeof(float) * (R * (D + 1) + chunk * (D + 1) + chunk * D + R * chunk + R * D + 3 * R);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only). Built for the
// (q, pool) pairs the engine and the tests use: fp32 q over fp32, bf16 or
// int8 pools, bf16 q over bf16 or int8 pools. Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_table, const void* lengths, void* out,
                                      int B, int T, int H, int KV, int D, int page, int n_blocks,
                                      int q_dtype, int kv_dtype, float scale, float dequant,
                                      int window, void* stream) {
  const int chunk = chunk_rows(page);
  const size_t smem = smem_bytes(T, H, KV, D, page);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_CASE(QC, KC, QT, KT)                                                            \
  if (q_dtype == QC && kv_dtype == KC)                                                        \
    return launch<QT, KT>(q, k_pool, v_pool, block_table, lengths, out, B, T, H, KV, D, page, \
                          n_blocks, chunk, scale, dequant, window, smem, s);
  PAGED_CASE(0, 0, float, float)
  PAGED_CASE(0, 1, float, __nv_bfloat16)
  PAGED_CASE(0, 2, float, int8_t)
  PAGED_CASE(1, 1, __nv_bfloat16, __nv_bfloat16)
  PAGED_CASE(1, 2, __nv_bfloat16, int8_t)
#undef PAGED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory (bytes) the launch above asks for; the wrapper
// checks it against the card's limit before launching.
extern "C" long paged_attention_smem_bytes(int T, int H, int KV, int D, int page) {
  return static_cast<long>(smem_bytes(T, H, KV, D, page));
}
