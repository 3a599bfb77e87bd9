// Attention forward with an online softmax over KV tiles: the prefill
// attention of the serving path, in the model's (B, S, H, D) layout.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd
// (Pallas), and with it the computation of
// src/repro/models/attention.py:flash_attention, whose masks it keeps:
// causal (kv_pos <= q_pos), a sliding ``window`` (q_pos - kv_pos < window),
// ``q_offset`` added to every query position, and an optional softcap.
//
// What bounds it on the H100: operations. A causal prefill at S=512, D=64
// does ~S/2 * 4 * D flops per query row on data read once, far above the
// ~295 flops/byte ridge; the floor is its causal flops over the bf16
// tensor-core peak (989 TFLOP/s), which only wgmma reaches.
//
// Two kernels; ops.py picks one by (dtype, head dim) alone.
//
// flash_fwd_wgmma_kernel (bf16, head dims 64, 112, 128, 256): one CTA per
// (128 query rows, q head, batch row), three warpgroups. The third is the
// producer: it gives up registers (setmaxnreg) and one thread issues TMA
// loads, the Q tile once and K/V tiles of 64 rows through a ring of 2-3
// stages, each stage a full/empty mbarrier pair. Tiles are 64-column slabs
// with 128-byte swizzle (a head dim of 128 or 256 is 2 or 4 slabs; 112 is
// 2, padded: see below). The two consumer warpgroups take the registers
// and own 64 query rows each; both
// read every K/V tile, which halves K/V traffic through shared memory per
// flop against one. Per tile a consumer runs S = Q K^T as wgmma from shared
// memory (K stored (kv, D) is the K-major B operand), the online softmax
// on the accumulator fragment (row max and sum over a quad with two
// shuffles; masks only on tiles that straddle an edge), rounds P to bf16
// in registers, where the m64n64 accumulator layout is the A fragment of
// the next product, and runs O += P V as wgmma with V (stored (kv, D), so
// MN-major) under the transpose bit. KV tiles wholly outside the causal
// or window range are never loaded. Head dim 112 (kimi-k2's) runs on two
// slabs: the tensor maps' inner dimension is 112, so the TMA fills columns
// 112-127 of the second box with zeros (OOB_FILL_NONE) and still counts the
// whole box's bytes; S = Q K^T takes only the 7 K steps of 16 real
// columns, O's second slab gets zero columns there from V, and the
// epilogue stores only the columns below D (the row stride is D, so a
// store past it would land in the next head's row). Later work: overlap
// of one warpgroup's softmax with the other's products (ping-pong), and of
// the softmax with the next tile's S inside a warpgroup.
//
// flash_fwd_kernel (fp32 at head dims 16, 32, 64; bf16 at 16, 32): one
// block per (64 query rows, q head, batch row); each thread owns one query
// row, with its q and fp32 accumulator in registers. K/V tiles of 32 rows
// are staged in shared memory as fp32 and read as warp-wide broadcasts;
// the products are fp32 FMAs on the CUDA cores (fp32 stays fp32: TF32
// would not hold the fp32 tolerance). KV tiles wholly above the causal
// diagonal or outside the window are skipped.
//
// In both, GQA is native: q head h reads KV head h / G, with no repeated
// copy of K/V. As in the reference, the probabilities are rounded to the
// value type before the P @ V product, and the row sum adds them unrounded.
// Given an lse buffer, both also write each row's log-sum-exp in their
// epilogue, the residual the training path's backward recomputes scores
// from (the reference's ``core_fwd`` saves the same): (B, Sq, Hq) fp32,
// (m if finite else 0) + ln(max(l, 1e-20)). Serving passes none.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block (one thread each)
constexpr int kBK = 32;   // KV rows per shared-memory tile
constexpr int kSC = 8;    // keys per online-softmax update

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                 int s_q, int s_kv, int hq, int hkv, int causal, int window, int q_offset,
                 float scale, float softcap) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kBK][D]
  float* v_s = k_s + kBK * D;                     // [kBK][D]

  const int r = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int qi = q0 + r;
  const bool row_ok = qi < s_q;
  const int qpos = qi + q_offset;

  float q_r[D];
  const T* qrow = q + (((size_t)b * s_q + qi) * hq + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) q_r[d] = row_ok ? to_f(qrow[d]) : 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  // KV range this q tile can see; tiles outside it are skipped whole.
  int kv_end = s_kv;
  if (causal) kv_end = min(s_kv, max(0, q0 + kBQ + q_offset));
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1);
  kv_begin = (kv_begin / kBK) * kBK;

  const T* kb = k + (size_t)b * s_kv * hkv * D;
  const T* vb = v + (size_t)b * s_kv * hkv * D;
  for (int j0 = kv_begin; j0 < kv_end; j0 += kBK) {
    __syncthreads();   // the previous tile is fully consumed
    // Loads go in batches of kLd per thread, all issued before their
    // stores, so they overlap instead of waiting on each other.
    constexpr int kPer = kBK * D / kBQ;
    constexpr int kLd = kPer < 8 ? kPer : 8;
#pragma unroll 1
    for (int u0 = 0; u0 < kPer; u0 += kLd) {
      float kx[kLd], vx[kLd];
#pragma unroll
      for (int u = 0; u < kLd; ++u) {
        const int i = r + (u0 + u) * kBQ;
        const int j = j0 + i / D;
        const size_t off = ((size_t)j * hkv + hk) * D + i % D;
        kx[u] = j < s_kv ? to_f(kb[off]) : 0.f;
        vx[u] = j < s_kv ? to_f(vb[off]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLd; ++u) {
        k_s[r + (u0 + u) * kBQ] = kx[u];
        v_s[r + (u0 + u) * kBQ] = vx[u];
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kBK; c0 += kSC) {
      float s[kSC];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kSC; ++c) {
        const int j = j0 + c0 + c;
        const float* kr = k_s + (c0 + c) * D;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(q_r[d], kr[d], dot);
        float sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        bool ok = j < s_kv;
        if (causal) ok = ok && j <= qpos;
        if (window > 0) ok = ok && (qpos - j) < window;
        s[c] = ok ? sc : -INFINITY;
        mx = fmaxf(mx, s[c]);
      }
      const float m_new = fmaxf(m, mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      const float corr = isinf(m) ? 0.f : expf(m - m_safe);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kSC; ++c) {
        const float p = isinf(s[c]) ? 0.f : expf(s[c] - m_safe);
        l += p;
        const float pr = to_f(from_f<T>(p));
        const float* vr = v_s + (c0 + c) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(pr, vr[d], acc[d]);
      }
      m = m_new;
    }
  }

  if (row_ok) {
    T* orow = out + (((size_t)b * s_q + qi) * hq + h) * D;
    const float den = fmaxf(l, 1e-20f);
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f<T>(acc[d] / den);
    // The reference's convention: a row with no visible key reads log(1e-20).
    if (lse != nullptr)
      lse[((size_t)b * s_q + qi) * hq + h] = (isinf(m) ? 0.f : m) + logf(den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
           int s_q, int s_kv, int hq, int hkv, int causal, int window, int q_offset,
           float scale, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)kBK * D;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_q + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kBQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s_q, s_kv, hq, hkv, causal, window, q_offset, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, float* lse, int b,
               int s_q, int s_kv, int hq, int hkv, int d, int causal, int window,
               int q_offset, float scale, float softcap, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, b, s_q, s_kv, hq, hkv, causal,
                                  window, q_offset, scale, softcap, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, b, s_q, s_kv, hq, hkv, causal,
                                  window, q_offset, scale, softcap, stream);
    case 64:   // bf16 at 64 runs the wgmma kernel
      if constexpr (std::is_same_v<T, float>)
        return launch<T, 64>(q, k, v, out, lse, b, s_q, s_kv, hq, hkv, causal, window,
                             q_offset, scale, softcap, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); out: (B, Sq, Hq, D), all
// contiguous; lse: (B, Sq, Hq) float32, or null for none. dtype: 0 = float32
// (d 16, 32, 64), 1 = bfloat16 (d 16, 32). window <= 0 and softcap <= 0 mean
// none. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* out, void* lse, int dtype, int b, int s_q,
                                          int s_kv, int hq, int hkv, int d, int causal,
                                          int window, int q_offset, float scale,
                                          float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (b == 0 || s_q == 0) return 0;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, l, b, s_q, s_kv, hq, hkv, d, causal, window,
                             q_offset, scale, softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, l, b, s_q, s_kv, hq, hkv, d, causal,
                                     window, q_offset, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ wgmma

namespace {

constexpr int kRowsWG = 64;                 // query rows per consumer warpgroup
constexpr int kConsumers = 2;               // consumer warpgroups per CTA
constexpr int kBQW = kRowsWG * kConsumers;  // query rows per CTA
constexpr int kBKW = 64;                    // KV rows per tile
constexpr int kThreadsW = 128 * (kConsumers + 1);
constexpr int kSlabQ = kBQW * 128;          // bytes of one 64-column slab
constexpr int kSlabKV = kBKW * 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgCfg {
  static_assert(D % 16 == 0, "wgmma steps K by 16 columns");
  static constexpr int kSlabs = (D + 63) / 64;  // a partial slab is zero-padded
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kQBytes = kSlabs * kSlabQ;
  static constexpr int kKVBytes = kSlabs * kSlabKV;  // K or V, one stage
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  // + the barriers, + slack to align the base to 1024 bytes
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

struct TileRange {
  int t0, t1;
};

// The KV tiles that query rows [lo, lo + n) can see; empty if n <= 0.
__device__ __forceinline__ TileRange kv_tiles(int lo, int n, int s_kv, int causal,
                                              int window, int q_offset) {
  if (n <= 0) return {0, 0};
  int end = s_kv;
  if (causal) end = min(s_kv, max(0, lo + n + q_offset));
  int begin = 0;
  if (window > 0) begin = max(0, lo + q_offset - window + 1);
  const int t0 = begin / kBKW;
  return {t0, max(t0, (end + kBKW - 1) / kBKW)};
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                       int s_q, int s_kv, int hq, int hkv, int causal, int window,
                       int q_offset, float scale, float softcap) {
  using C = WgCfg<D>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // [slab][kBQW][64]
  const uint32_t k_s = q_s + C::kQBytes;  // [stage][slab][kBKW][64]
  const uint32_t v_s = k_s + C::kStages * C::kKVBytes;
  const uint32_t q_bar = q_s + C::kBarOff;
  const uint32_t full_bar = q_bar + 8;                  // [stage]
  const uint32_t empty_bar = full_bar + 8 * C::kStages;  // [stage]

  const int q0 = blockIdx.x * kBQW;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const TileRange cta = kv_tiles(q0, min(kBQW, s_q - q0), s_kv, causal, window,
                                 q_offset);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, 128 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full
    regs_dec<24>();
    if (threadIdx.x == 128 * kConsumers) {
      const int hk = h / (hq / hkv);
      mbar_arrive_expect_tx(q_bar, C::kQBytes);
#pragma unroll
      for (int s = 0; s < C::kSlabs; ++s)
        tma_load_4d(q_s + s * kSlabQ, &tm_q, q_bar, 64 * s, h, q0, b);
      for (int t = cta.t0, i = 0; t < cta.t1; ++t, ++i) {
        const int st = i % C::kStages;
        mbar_wait(empty_bar + 8 * st, ((i / C::kStages) & 1) ^ 1);
        const uint32_t full = full_bar + 8 * st;
        mbar_arrive_expect_tx(full, 2 * C::kKVBytes);
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s) {
          const uint32_t off = st * C::kKVBytes + s * kSlabKV;
          tma_load_4d(k_s + off, &tm_k, full, 64 * s, hk, t * kBKW, b);
          tma_load_4d(v_s + off, &tm_v, full, 64 * s, hk, t * kBKW, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    regs_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int qw = q0 + kRowsWG * wg;
    const TileRange mine = kv_tiles(qw, min(kRowsWG, s_q - qw), s_kv, causal, window,
                                    q_offset);
    // This thread's accumulator rows are row0 and row0 + 8; in each group of
    // 8 columns it holds columns c0 and c0 + 1. Register i of a 64-column
    // fragment is row row0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + c0 +
    // (i & 1).
    const int row0 = qw + warp * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t q_wg = q_s + wg * (kRowsWG * 128);

    float o[C::kSlabs][32];
#pragma unroll
    for (int s = 0; s < C::kSlabs; ++s)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[s][i] = 0.f;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_bar, 0);
    for (int t = cta.t0, i = 0; t < cta.t1; ++t, ++i) {
      const int st = i % C::kStages;
      mbar_wait(full_bar + 8 * st, (i / C::kStages) & 1);
      if (t >= mine.t0 && t < mine.t1) {
        const uint32_t k_t = k_s + st * C::kKVBytes;
        const uint32_t v_t = v_s + st * C::kKVBytes;
        // S = Q K^T: K steps of 16 columns, 4 to a 128-byte slab row.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_m64n64k16_ss(sc, desc_sw128(q_wg + (kk / 4) * kSlabQ + off),
                             desc_sw128(k_t + (kk / 4) * kSlabKV + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // Scale, softcap, then the masks, in the reference's order.
        const int j0 = t * kBKW;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          float x = sc[r] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          sc[r] = x;
        }
        const bool edge = j0 + kBKW > s_kv ||
                          (causal && j0 + kBKW - 1 > qw + q_offset) ||
                          (window > 0 && qw + kRowsWG - 1 + q_offset - j0 >= window);
        if (edge) {
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const int j = j0 + 8 * (r >> 2) + c0 + (r & 1);
            const int qp = row0 + 8 * ((r >> 1) & 1) + q_offset;
            bool ok = j < s_kv;
            if (causal) ok = ok && j <= qp;
            if (window > 0) ok = ok && (qp - j) < window;
            if (!ok) sc[r] = -INFINITY;
          }
        }
        // Online softmax: row max over the quad, the m_safe/corr rule of
        // the reference, p unrounded into the row sum.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int r = 0; r < 32; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
        float msafe[2], corr[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
          mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
          msafe[x] = isinf(mx[x]) ? 0.f : mx[x];
          corr[x] = isinf(m[x]) ? 0.f : exp2f((m[x] - msafe[x]) * kLog2e);
          m[x] = mx[x];
          l[x] *= corr[x];
        }
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int x = (r >> 1) & 1;
          const float p = exp2f((sc[r] - msafe[x]) * kLog2e);
          l[x] += p;
          sc[r] = p;
        }
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s)
#pragma unroll
          for (int r = 0; r < 32; ++r) o[s][r] *= corr[(r >> 1) & 1];
        // P in bf16 as the A fragments of O += P V, one per 16 KV rows.
        uint32_t pa[kBKW / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBKW / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s) fence_regs(o[s]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBKW / 16; ++kk)
#pragma unroll
          for (int s = 0; s < C::kSlabs; ++s)
            wgmma_m64n64k16_rs_tn(o[s], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3],
                                  desc_sw128(v_t + s * kSlabKV + kk * 16 * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s) fence_regs(o[s]);
      }
      mbar_arrive(empty_bar + 8 * st);
    }

    // Epilogue: the quad's row sums, then O / max(l, 1e-20) in bf16, and
    // lse = m + ln(max(l, 1e-20)): m is kept in natural units (only the
    // exponentials go through exp2f), so l is a sum of exp(s - m).
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
      const int row = row0 + 8 * x;
      if (row < s_q) {
        const float den = fmaxf(l[x], 1e-20f);
        __nv_bfloat16* orow = out + (((size_t)b * s_q + row) * hq + h) * D;
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s)
#pragma unroll
          for (int g = 0; g < 8; ++g)
            if (64 * s + 8 * g < D)   // D 112: the padded columns stay unstored
              *reinterpret_cast<__nv_bfloat162*>(orow + 64 * s + 8 * g + c0) =
                  __floats2bfloat162_rn(o[s][4 * g + 2 * x] / den,
                                        o[s][4 * g + 2 * x + 1] / den);
        if (lse != nullptr && c0 == 0)
          lse[((size_t)b * s_q + row) * hq + h] = (isinf(m[x]) ? 0.f : m[x]) + logf(den);
      }
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                 int b, int s_q, int s_kv, int hq, int hkv, int causal, int window,
                 int q_offset, float scale, float softcap, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = hopper::encode_bshd_bf16(&tq, q, b, s_q, hq, D, kBQW);
  if (e == 0) e = hopper::encode_bshd_bf16(&tk, k, b, s_kv, hkv, D, kBKW);
  if (e == 0) e = hopper::encode_bshd_bf16(&tv, v, b, s_kv, hkv, D, kBKW);
  if (e != 0) return e;
  constexpr int smem = WgCfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_q + kBQW - 1) / kBQW, hq, b);
  flash_fwd_wgmma_kernel<D><<<grid, kThreadsW, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, s_q, s_kv, hq, hkv, causal,
      window, q_offset, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only. q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); out: (B, Sq, Hq, D),
// all contiguous with 16-byte-aligned bases; lse: (B, Sq, Hq) float32, or
// null for none; d is 64, 112, 128 or 256. window
// <= 0 and softcap <= 0 mean none. Returns the cudaError_t of the launch
// (0 = success), or a negative code when a tensor map cannot be encoded
// (-1: the CUDA driver has no encoder; -(1000 + CUresult): the map is
// refused).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* out, void* lse, int b, int s_q,
                                            int s_kv, int hq, int hkv, int d, int causal,
                                            int window, int q_offset, float scale,
                                            float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (b == 0 || s_q == 0) return 0;
  switch (d) {
    case 64: return launch_wgmma<64>(q, k, v, out, l, b, s_q, s_kv, hq, hkv, causal,
                                     window, q_offset, scale, softcap, s);
    case 112: return launch_wgmma<112>(q, k, v, out, l, b, s_q, s_kv, hq, hkv, causal,
                                       window, q_offset, scale, softcap, s);
    case 128: return launch_wgmma<128>(q, k, v, out, l, b, s_q, s_kv, hq, hkv, causal,
                                       window, q_offset, scale, softcap, s);
    case 256: return launch_wgmma<256>(q, k, v, out, l, b, s_q, s_kv, hq, hkv, causal,
                                       window, q_offset, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
