// One-token GQA decode attention over a paged KV cache, read through
// per-sequence block tables, in the two layouts the serving engine uses:
//   global    ONE shared pool (total, page, Hkv, D); table (B, P) entries
//             index it, NULL (>= total) marks an unallocated entry (the
//             zero-copy layout).
//   per-slot  one pool per sequence (B, n_pages, page, Hkv, D); table
//             (B, n_pages) is a permutation of slot b's own pages (the copy
//             baseline's layout).
// Both run the same device code: slot b's pages start at page
// b * slot_pages of the pool, with slot_pages = 0 for the global layout
// and n_pages for the per-slot one.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:paged_attention_global
// and :paged_attention (Pallas, scalar-prefetched block table driving each
// page's DMA).
//
// What bounds it on the H100: bytes. Each (sequence, KV head) reads its
// valid tokens' K and V once (2 * len * D elements) and does 4 * G * len * D
// flops on them, about G / itemsize flops per byte, far below the ~295
// flops/byte where the tensor cores would become the limit. The floor is
// the K/V bytes over 3.35 TB/s.
//
// Design: one block per (sequence, KV head, split of the sequence's tokens)
// serves that head's G query heads, so each K/V element is loaded from
// device memory once and used G times. The block loads its own table
// entries (the TPU's scalar prefetch), stages a tile of several pages in
// shared memory with coalesced row loads, and keeps the online-softmax state
// (m, l, acc) in shared memory in fp32. The splits (flash-decoding) put
// enough blocks on the card at small batch; a second small kernel merges
// their partial (m, l, acc).
// Pages at or past ``length`` are never loaded. A table entry outside the
// slot's pages (a global NULL, >= total) is read as a zero page, never
// dereferenced and never clamped to page 0: an inactive slot's all-NULL row
// then yields exactly what the plain version yields. Scores are masked to
// -inf before the max, so a row of length 0 returns zeros, not NaN.
//
// Kept simple on purpose: scalar fp32 FMAs, no cp.async/TMA double
// buffering of the page loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLd = 8;   // loads in flight per thread while staging a tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory (floats): K tile [TC][D+1], V tile [TC][D], q [G][D],
// scores/probs [G][TC], acc [G][D], m [G], l [G], corr [G]; then the tile's
// table entries (ints).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int32_t* __restrict__ table,
                    const int32_t* __restrict__ lengths, float* __restrict__ part,
                    int total, int slot_pages, int page, int hkv, int d, int g,
                    int n_table, int pages_per_tile, int n_split, float scale,
                    float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tc = pages_per_tile * page;     // tokens per tile
  const int kstride = d + 1;                // padded: conflict-free dot rows
  float* k_s = smem;
  float* v_s = k_s + tc * kstride;
  float* q_s = v_s + tc * d;
  float* p_s = q_s + g * d;
  float* acc_s = p_s + g * tc;
  float* m_s = acc_s + g * d;
  float* l_s = m_s + g;
  float* c_s = l_s + g;
  int* e_s = reinterpret_cast<int*>(c_s + g);   // the tile's table entries

  const int hq = hkv * g;
  const T* qb = q + ((size_t)b * hq + (size_t)h * g) * d;
  for (int i = tid; i < g * d; i += kThreads) {
    q_s[i] = to_f(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  int len = lengths[b];
  const int cap = n_table * page;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int32_t* row = table + (size_t)b * n_table;
  // This split's whole tiles of the row's [0, len) tokens.
  const int tiles_per_split = ((len + tc - 1) / tc + n_split - 1) / n_split;
  const int t_begin = split * tiles_per_split * tc;
  const int t_end = min(len, t_begin + tiles_per_split * tc);
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += tc) {
    // 1. The tile's table entries, then its K/V through them. Positions
    //    >= len and NULL entries become zeros without touching the pool.
    //    Each thread issues kLd loads before storing any, so they overlap.
    for (int i = tid; i < pages_per_tile; i += kThreads) {
      const int pg = t0 / page + i;
      e_s[i] = (t0 + i * page < len) ? row[pg] : -1;
    }
    __syncthreads();
    for (int base = tid; base < tc * d; base += kThreads * kLd) {
      float kx[kLd], vx[kLd];
#pragma unroll
      for (int u = 0; u < kLd; ++u) {
        const int i = base + u * kThreads;
        kx[u] = 0.f;
        vx[u] = 0.f;
        const int tt = i / d;
        const int pos = t0 + tt;
        if (i < tc * d && pos < len) {
          const int entry = e_s[tt / page];
          if (entry >= 0 && entry < total) {
            const size_t pg = (size_t)b * slot_pages + entry;
            const size_t off = ((pg * page + pos % page) * hkv + h) * d + (i - tt * d);
            kx[u] = to_f(k_pool[off]);
            vx[u] = to_f(v_pool[off]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLd; ++u) {
        const int i = base + u * kThreads;
        if (i < tc * d) {
          const int tt = i / d;
          k_s[tt * kstride + (i - tt * d)] = kx[u];
          v_s[i] = vx[u];
        }
      }
    }
    __syncthreads();
    // 2. Scores for the G heads, masked before the max.
    for (int i = tid; i < g * tc; i += kThreads) {
      const int gg = i / tc, tt = i - gg * tc;
      float s = -INFINITY;
      if (t0 + tt < len) {
        const float* qr = q_s + gg * d;
        const float* kr = k_s + tt * kstride;
        float acc = 0.f;
        for (int dd = 0; dd < d; ++dd) acc = fmaf(qr[dd], kr[dd], acc);
        s = acc * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      p_s[i] = s;
    }
    __syncthreads();
    // 3. Online-softmax update, one warp per query head.
    for (int gg = warp; gg < g; gg += kWarps) {
      float* pr = p_s + gg * tc;
      float mx = -INFINITY;
      for (int tt = lane; tt < tc; tt += 32) mx = fmaxf(mx, pr[tt]);
      mx = warp_max(mx);
      const float m_prev = m_s[gg];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
      for (int tt = lane; tt < tc; tt += 32) {
        const float s = pr[tt];
        const float p = isinf(s) ? 0.f : expf(s - m_safe);
        pr[tt] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = isinf(m_prev) ? 0.f : expf(m_prev - m_safe);
        c_s[gg] = corr;
        l_s[gg] = l_s[gg] * corr + sum;
        m_s[gg] = m_new;
      }
    }
    __syncthreads();
    // 4. acc = acc * corr + P @ V.
    for (int i = tid; i < g * d; i += kThreads) {
      const int gg = i / d, dd = i - gg * d;
      const float* pr = p_s + gg * tc;
      float acc = acc_s[i] * c_s[gg];
      for (int tt = 0; tt < tc; ++tt) acc = fmaf(pr[tt], v_s[tt * d + dd], acc);
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  // Partial state of this split: acc[0..d), then m, then l, per query head.
  for (int i = tid; i < g * (d + 2); i += kThreads) {
    const int gg = i / (d + 2), j = i - gg * (d + 2);
    const float x = j < d ? acc_s[gg * d + j] : (j == d ? m_s[gg] : l_s[gg]);
    part[(((size_t)b * hq + (size_t)h * g + gg) * n_split + split) * (d + 2) + j] = x;
  }
}

// Merge the splits of one (sequence, query head): rescale each split's
// (acc, l) to the common max and divide once.
template <typename T>
__global__ void paged_decode_combine(const float* __restrict__ part, T* __restrict__ out,
                                     int n_split, int d) {
  const size_t row = blockIdx.x;   // b * hq + head
  const float* pr = part + row * n_split * (d + 2);
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pr[s * (d + 2) + d]);
  const float m_safe = isinf(mx) ? 0.f : mx;
  float l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float m = pr[s * (d + 2) + d];
    l += isinf(m) ? 0.f : expf(m - m_safe) * pr[s * (d + 2) + d + 1];
  }
  const float den = fmaxf(l, 1e-20f);
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float m = pr[s * (d + 2) + d];
      if (!isinf(m)) acc += expf(m - m_safe) * pr[s * (d + 2) + j];
    }
    out[row * d + j] = from_f<T>(acc / den);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* lengths, void* part, void* out, int b, int hkv, int g, int d,
           int total, int slot_pages, int page, int n_table, int n_split, float scale,
           float softcap, cudaStream_t stream) {
  // About 64 tokens of K and V per tile (whole pages), ~32 KB of fp32 tiles.
  int pages_per_tile = (64 + page - 1) / page;
  if (pages_per_tile > n_table) pages_per_tile = n_table;
  if (pages_per_tile < 1) pages_per_tile = 1;
  const int tc = pages_per_tile * page;
  const size_t smem = sizeof(float) *
      ((size_t)tc * (d + 1) + (size_t)tc * d + (size_t)g * d + (size_t)g * tc +
       (size_t)g * d + 3 * (size_t)g) + sizeof(int) * pages_per_tile;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, hkv, n_split);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(part), total,
      slot_pages, page, hkv, d, g, n_table, pages_per_tile, n_split, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine<T><<<b * hkv * g, 64, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), n_split, d);
  return (int)cudaGetLastError();
}

// Both layouts, with slot_pages as above. Returns the cudaError_t of the
// launches (0 = success).
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* table,
             const void* lengths, void* part, void* out, int dtype, int b, int hkv,
             int g, int d, int total, int slot_pages, int page, int n_table,
             int n_split, float scale, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0) return 0;
  if (n_split < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, lengths, part, out, b, hkv, g, d,
                         total, slot_pages, page, n_table, n_split, scale, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, part, out, b, hkv,
                                 g, d, total, slot_pages, page, n_table, n_split, scale,
                                 softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means no softcap. part is
// fp32 scratch of b * hkv * g * n_split * (d + 2) floats.
// Global layout: pools (total, page, hkv, d), table (b, n_table).
extern "C" int paged_attention_global_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* part, void* out, int dtype, int b, int hkv, int g,
    int d, int total, int page, int n_table, int n_split, float scale, float softcap,
    void* stream) {
  return dispatch(q, k_pool, v_pool, table, lengths, part, out, dtype, b, hkv, g, d,
                  total, 0, page, n_table, n_split, scale, softcap, stream);
}

// Per-slot layout: pools (b, n_pages, page, hkv, d), table (b, n_pages).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* part, void* out, int dtype, int b, int hkv, int g,
    int d, int n_pages, int page, int n_split, float scale, float softcap,
    void* stream) {
  return dispatch(q, k_pool, v_pool, table, lengths, part, out, dtype, b, hkv, g, d,
                  n_pages, n_pages, page, n_pages, n_split, scale, softcap, stream);
}
