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
// tensor-core peak (989 TFLOP/s).
//
// Design: one block per (q tile of 64 rows, q head, batch row); each thread
// owns one query row, with its q and fp32 accumulator in registers (head
// dims 16, 32 and 64). K/V tiles of 32 rows are staged in shared memory as fp32 and
// read as warp-wide broadcasts. KV tiles wholly above the causal diagonal
// or wholly outside the window are skipped. GQA is native: q head h reads
// KV head h / G, with no repeated copy of K/V. As in the reference, the
// probabilities are rounded to the value type before the P @ V product.
//
// Kept simple on purpose: the products run on the CUDA cores in fp32, not on
// the tensor cores, so it stays far from the bound. wgmma with TMA-fed
// tiles is the path to the bound and is left to later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
                 const T* __restrict__ v, T* __restrict__ out, int s_q, int s_kv,
                 int hq, int hkv, int causal, int window, int q_offset, float scale,
                 float softcap) {
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
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s_q,
           int s_kv, int hq, int hkv, int causal, int window, int q_offset, float scale,
           float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)kBK * D;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_q + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kBQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s_q, s_kv, hq, hkv, causal, window, q_offset, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int b, int s_q,
               int s_kv, int hq, int hkv, int d, int causal, int window, int q_offset,
               float scale, float softcap, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, b, s_q, s_kv, hq, hkv, causal, window,
                                  q_offset, scale, softcap, stream);
    case 32: return launch<T, 32>(q, k, v, out, b, s_q, s_kv, hq, hkv, causal, window,
                                  q_offset, scale, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, s_q, s_kv, hq, hkv, causal, window,
                                  q_offset, scale, softcap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); out: (B, Sq, Hq, D), all
// contiguous. dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0
// mean none. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* out, int dtype, int b, int s_q, int s_kv,
                                          int hq, int hkv, int d, int causal, int window,
                                          int q_offset, float scale, float softcap,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || s_q == 0) return 0;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, b, s_q, s_kv, hq, hkv, d, causal, window,
                             q_offset, scale, softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, b, s_q, s_kv, hq, hkv, d, causal,
                                     window, q_offset, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
