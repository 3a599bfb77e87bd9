// Streaming axpy, out = a * x + y over 1-D x and y: paper kernel #4, the
// kernel of the paper's copy against zero-copy comparison.
//
// Replaces: src/repro/kernels/axpy/kernel.py:axpy (Pallas, pallas_call at
// :20), the entry point of src/repro/kernels/axpy/ops.py:axpy_op.
//
// What bounds it on the H100: bytes. Two operations per element against
// three elements moved (x and y read, out written): at n = 2^28 in fp32,
// 3.2 GB over 3.35 TB/s is 0.96 ms, and the 0.54 GFLOP is nothing beside it.
//
// Design: each thread takes kU 16-byte chunks (4 fp32 or 8 bf16 each) of x
// and of y, kThreads apart so a warp's accesses stay contiguous, and issues
// all 2 kU loads before any arithmetic: 128 bytes of loads in flight a
// thread, a block for every 4096 fp32 (8192 bf16) elements. (A grid of one
// resident wave walking the vectors in grid strides ran slower on the H100
// than this one-step grid.) The 16-byte accesses are streaming ones
// (evict-first, __ldcs / __stcs): nothing reads x, y or out again, and on
// the H100 they ran about 0.5% faster than plain accesses (PERF.md).
// The last n % 4 (or % 8) elements go one per thread; where a pointer is
// not 16-byte aligned every element does. No tile has to divide n.
//
// Rounding, as the Pallas kernel does it: a is cast to the dtype first, then
// the product is rounded to the dtype and the sum again. In bf16 that is two
// roundings to bf16; __fmul_rn / __fadd_rn keep nvcc from contracting the
// two into one FMA, which would round once and differ.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kU = 4;   // 16-byte chunks of x and of y a thread

__device__ __forceinline__ float bf16_bits_to_f(uint32_t h) { return __uint_as_float(h << 16); }
__device__ __forceinline__ uint32_t f_to_bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// One element; a is already a value of the element type.
__device__ __forceinline__ uint32_t axpy_f32(float a, uint32_t x, uint32_t y) {
  return __float_as_uint(__fadd_rn(__fmul_rn(a, __uint_as_float(x)), __uint_as_float(y)));
}
__device__ __forceinline__ uint32_t axpy_bf16(float a, uint32_t x, uint32_t y) {
  const float p = bf16_bits_to_f(f_to_bf16_bits(__fmul_rn(a, bf16_bits_to_f(x))));
  return f_to_bf16_bits(__fadd_rn(p, bf16_bits_to_f(y)));
}

// One 32-bit word: one fp32 element or two bf16 elements.
template <bool kBf16>
__device__ __forceinline__ uint32_t axpy_word(float a, uint32_t x, uint32_t y) {
  if (!kBf16) return axpy_f32(a, x, y);
  return axpy_bf16(a, x & 0xffffu, y & 0xffffu) | (axpy_bf16(a, x >> 16, y >> 16) << 16);
}

template <bool kBf16>
__device__ __forceinline__ uint4 axpy_chunk(float a, uint4 x, uint4 y) {
  return make_uint4(axpy_word<kBf16>(a, x.x, y.x), axpy_word<kBf16>(a, x.y, y.y),
                    axpy_word<kBf16>(a, x.z, y.z), axpy_word<kBf16>(a, x.w, y.w));
}

// Chunks [i0, i0 + kU * kThreads) of [0, n_vec), kThreads apart, for the
// block's i0; then element n_vec * kVec + (global thread index) if < n.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
axpy_kernel(const void* __restrict__ x, const void* __restrict__ y, void* __restrict__ out,
            long long n_vec, long long n, float a) {
  constexpr int kVec = kBf16 ? 8 : 4;
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* yv = static_cast<const uint4*>(y);
  uint4* ov = static_cast<uint4*>(out);
  const long long i0 = (long long)blockIdx.x * kThreads * kU + threadIdx.x;
  uint4 vx[kU], vy[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long i = i0 + (long long)u * kThreads;
    if (i < n_vec) {
      vx[u] = __ldcs(xv + i);
      vy[u] = __ldcs(yv + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long i = i0 + (long long)u * kThreads;
    if (i < n_vec) __stcs(ov + i, axpy_chunk<kBf16>(a, vx[u], vy[u]));
  }
  const long long e = n_vec * kVec + (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e < n) {
    if (kBf16) {
      const uint16_t* xs = static_cast<const uint16_t*>(x);
      const uint16_t* ys = static_cast<const uint16_t*>(y);
      static_cast<uint16_t*>(out)[e] = (uint16_t)axpy_bf16(a, xs[e], ys[e]);
    } else {
      const uint32_t* xs = static_cast<const uint32_t*>(x);
      const uint32_t* ys = static_cast<const uint32_t*>(y);
      static_cast<uint32_t*>(out)[e] = axpy_f32(a, xs[e], ys[e]);
    }
  }
}

template <bool kBf16>
int launch(const void* x, const void* y, void* out, long long n, float a,
           cudaStream_t stream) {
  constexpr int kVec = kBf16 ? 8 : 4;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0);
  const long long n_vec = aligned ? n / kVec : 0;
  const long long n_tail = n - n_vec * kVec;
  const long long vec_blocks = (n_vec + (long long)kThreads * kU - 1) / (kThreads * kU);
  const long long tail_blocks = (n_tail + kThreads - 1) / kThreads;
  const long long blocks = vec_blocks > tail_blocks ? vec_blocks : tail_blocks;
  if (kBf16) a = __bfloat162float(__float2bfloat16_rn(a));
  axpy_kernel<kBf16><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, out, n_vec, n, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y, out: (n,) contiguous, of one dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int axpy_launch(const void* x, const void* y, void* out, int dtype, long long n,
                           float a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (dtype == 0) return launch<false>(x, y, out, n, a, s);
  if (dtype == 1) return launch<true>(x, y, out, n, a, s);
  return (int)cudaErrorInvalidValue;
}
