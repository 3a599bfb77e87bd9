// Fused gesummv, y = alpha * A @ x + beta * B @ x, reading A and B once:
// paper kernel #2.
//
// Replaces: src/repro/kernels/gesummv/kernel.py:gesummv (Pallas, pallas_call
// at :33), the entry point of src/repro/kernels/gesummv/ops.py:gesummv_op.
//
// What bounds it on the H100: bytes. Each element of A and B is read once and
// used in one multiply-add: at N = K = 16384 in fp32, 2.1 GB of A and B over
// 3.35 TB/s is 0.64 ms, against 1.1 GFLOP.
//
// Design: one warp per row, eight rows per block. The warp walks the row
// of A and of B in 16-byte chunks (4 fp32 or 8 bf16 a lane), read with
// streaming (evict-first) loads since nothing reads them again; x, read by
// every row, goes through the read-only cache and stays in L1/L2. Both dot
// products accumulate in fp32 registers and are reduced with warp
// shuffles; lane 0 writes alpha * (A x) + beta * (B x), rounded once to the
// output type. Rows that are not 16-byte aligned (K not a multiple of the
// chunk, or an unaligned pointer) take one element per lane instead.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // rows per block

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// sa += a . x and sb += b . x over one 32-bit word of each.
template <bool kBf16>
__device__ __forceinline__ void dot_word(uint32_t a, uint32_t b, uint32_t x, float& sa,
                                         float& sb) {
  if (kBf16) {
    const float x0 = lo_bf16(x), x1 = hi_bf16(x);
    sa = fmaf(lo_bf16(a), x0, sa);
    sa = fmaf(hi_bf16(a), x1, sa);
    sb = fmaf(lo_bf16(b), x0, sb);
    sb = fmaf(hi_bf16(b), x1, sb);
  } else {
    const float xv = __uint_as_float(x);
    sa = fmaf(__uint_as_float(a), xv, sa);
    sb = fmaf(__uint_as_float(b), xv, sb);
  }
}

template <bool kBf16>
__device__ __forceinline__ float elem(const void* p, long long i) {
  if (kBf16) return __uint_as_float((uint32_t) static_cast<const uint16_t*>(p)[i] << 16);
  return static_cast<const float*>(p)[i];
}

template <bool kBf16, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gesummv_kernel(const void* __restrict__ a, const void* __restrict__ b,
               const void* __restrict__ x, void* __restrict__ y, int n, int k, float alpha,
               float beta) {
  constexpr int kElem = kBf16 ? 2 : 4;   // bytes per element
  constexpr int kVecElems = 16 / kElem;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const long long base = (long long)row * k;
  float sa = 0.f, sb = 0.f;
  if (kVec) {
    const uint4* ar = reinterpret_cast<const uint4*>(static_cast<const char*>(a) + base * kElem);
    const uint4* br = reinterpret_cast<const uint4*>(static_cast<const char*>(b) + base * kElem);
    const uint4* xv = static_cast<const uint4*>(x);
    const int chunks = k / kVecElems;
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) {
      const uint4 va = __ldcs(ar + c), vb = __ldcs(br + c), vx = __ldg(xv + c);
      dot_word<kBf16>(va.x, vb.x, vx.x, sa, sb);
      dot_word<kBf16>(va.y, vb.y, vx.y, sa, sb);
      dot_word<kBf16>(va.z, vb.z, vx.z, sa, sb);
      dot_word<kBf16>(va.w, vb.w, vx.w, sa, sb);
    }
  } else {
    for (int c = lane; c < k; c += 32) {
      const float xv = elem<kBf16>(x, c);
      sa = fmaf(elem<kBf16>(a, base + c), xv, sa);
      sb = fmaf(elem<kBf16>(b, base + c), xv, sb);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  if (lane == 0) {
    const float r = __fadd_rn(__fmul_rn(alpha, sa), __fmul_rn(beta, sb));
    if (kBf16)
      static_cast<uint16_t*>(y)[row] = __bfloat16_as_ushort(__float2bfloat16_rn(r));
    else
      static_cast<float*>(y)[row] = r;
  }
}

template <bool kBf16>
int launch(const void* a, const void* b, const void* x, void* y, int n, int k, float alpha,
           float beta, cudaStream_t stream) {
  constexpr int kVecElems = kBf16 ? 8 : 4;
  const bool vec = k % kVecElems == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                   (uintptr_t)x % 16 == 0;
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  if (vec)
    gesummv_kernel<kBf16, true><<<blocks, kWarps * 32, 0, stream>>>(a, b, x, y, n, k, alpha,
                                                                      beta);
  else
    gesummv_kernel<kBf16, false><<<blocks, kWarps * 32, 0, stream>>>(a, b, x, y, n, k, alpha,
                                                                       beta);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b: (N, K); x: (K,); y: (N,), all contiguous and of one dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launch (0 = success).
extern "C" int gesummv_launch(const void* a, const void* b, const void* x, void* y,
                              int dtype, int n, int k, float alpha, float beta,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (dtype == 0) return launch<false>(a, b, x, y, n, k, alpha, beta, s);
  if (dtype == 1) return launch<true>(a, b, x, y, n, k, alpha, beta, s);
  return (int)cudaErrorInvalidValue;
}
