// Bitonic sort of a 1-D array, paper kernel #5: the block sort and the
// cross-block merge ladder, with the same pairs in the same order of levels
// and stages as the JAX network, so that the output is bit-equal to it.
//
// Replaces: src/repro/kernels/mergesort/kernel.py:block_sort (Pallas,
// pallas_call at :53) and the jnp ladder of
// src/repro/kernels/mergesort/ops.py:mergesort (_global_stage at :16 and the
// flip of the odd half-blocks at :43-48).
//
// Three kernels, each launched by its own C function below:
//   block_sort_kernel   one CTA per tile of `tile` elements in shared memory
//                       runs levels 2..kmax of the alternating network of
//                       _bitonic_block and writes the tile out of place;
//   merge_stage_kernel  one stage at a stride j >= tile over the whole
//                       array, in place, a thread per pair (or per two
//                       mirrored pairs, see below);
//   merge_tile_kernel   the stages j = min(k, tile)/2..1 of one level k, a
//                       tile per CTA in shared memory, in place.
// Element i sorts ascending at level k where (i % block) & k is 0: the
// alternating directions inside a block, all ascending on the ladder.
//
// The flip. The ladder reverses the odd half-blocks of each level and then
// runs an ascending stage at j = k/2. The first stage reads the upper half
// mirrored instead: the pair of lower position q is (x[q], x[k-1-q]), whose
// outputs go to q and h+q (h = k/2). Its read of k-1-q is the write of the
// mirrored pair h-1-q, so one thread owns both pairs and touches four
// elements, which it alone reads and writes: no race in place.
//
// Compare-exchange semantics are those of jnp.minimum / jnp.maximum as XLA
// computes them on an x86 CPU, on the elements' bits: a NaN propagates to
// both outputs with its bits (where both are NaN, the "first" operand wins:
// for minimum b if a's sign bit is set, else a; for maximum the other way
// round), and -0.0 sorts before +0.0. Non-NaN values compare through a key
// that turns the sign-magnitude bits into an unsigned order (-0 just below
// +0). fminf / fmaxf would drop a NaN and a < b ? a : b would order +-0 by
// argument position, so neither is used. bf16 is compared on its own 16 bits, with
// no conversion at all; int32 compares as a signed integer. Subnormals
// compare as their values (XLA's CPU code reads them as zero: the one
// difference from the JAX sort, kept deliberately).
//
// What bounds it on the H100: bytes, per launch. A merge_stage reads and
// writes the array once (at n = 2^26 fp32, 512 MiB over 3.35 TB/s is 0.16
// ms) for n/2 compare-exchanges; the tile kernels do their log stages in
// shared memory between one read and one write. The ladder of a sort of n =
// 2^26 with blocks of 1024 and tiles of 8192 is 91 merge_stage and 16
// merge_tile launches after one block_sort: 108 passes, against the one
// pass of the function itself. Simple first: one element (or pair) per
// thread, no cp.async or TMA, and no fusing of several global stages into
// one pass; those are for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;     // tile kernels
constexpr int kStageThreads = 256;
constexpr int kMaxTile = 8192;     // elements of a tile (TILE in ops.py)

struct F32 {
  using Bits = uint32_t;
  __device__ static bool isnan(Bits b) { return (b & 0x7fffffffu) > 0x7f800000u; }
  __device__ static bool sign(Bits b) { return b >> 31; }
  __device__ static uint32_t key(Bits b) { return (b & 0x80000000u) ? ~b : (b | 0x80000000u); }
};
struct BF16 {
  using Bits = uint16_t;
  __device__ static bool isnan(Bits b) { return (b & 0x7fffu) > 0x7f80u; }
  __device__ static bool sign(Bits b) { return b >> 15; }
  __device__ static uint32_t key(Bits b) {
    const uint32_t u = b;
    return (u & 0x8000u) ? (~u & 0xffffu) : (u | 0x8000u);
  }
};
struct I32 {
  using Bits = uint32_t;
  __device__ static bool isnan(Bits) { return false; }
  __device__ static bool sign(Bits) { return false; }
  __device__ static uint32_t key(Bits b) { return b ^ 0x80000000u; }
};

// The first operand decides between two NaNs (see the note at the top).
template <class T>
__device__ __forceinline__ typename T::Bits vmin(typename T::Bits a, typename T::Bits b) {
  const bool b_first = T::sign(a);
  const typename T::Bits first = b_first ? b : a, second = b_first ? a : b;
  if (T::isnan(first)) return first;
  if (T::isnan(second)) return second;
  return T::key(b) < T::key(a) ? b : a;
}
template <class T>
__device__ __forceinline__ typename T::Bits vmax(typename T::Bits a, typename T::Bits b) {
  const bool b_first = !T::sign(a);
  const typename T::Bits first = b_first ? b : a, second = b_first ? a : b;
  if (T::isnan(first)) return first;
  if (T::isnan(second)) return second;
  return T::key(b) < T::key(a) ? a : b;
}

// The pair whose lower position holds a and upper b. Each side takes the
// min or max with its own value first, as the JAX stage computes it:
// ascending (min(a, b), max(b, a)), descending (max(a, b), min(b, a)).
template <class T>
__device__ __forceinline__ void exchange(typename T::Bits& a, typename T::Bits& b, bool up) {
  const typename T::Bits lo = up ? vmin<T>(a, b) : vmax<T>(a, b);
  const typename T::Bits hi = up ? vmax<T>(b, a) : vmin<T>(b, a);
  a = lo;
  b = hi;
}

// Lower position of pair p at stride j: p with a zero bit inserted at j.
__device__ __forceinline__ long long lower_of(long long p, long long j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// The flipped first stage of a ladder level k (h = k/2 >= 2) for quad u:
// the pairs q and h-1-q of one k-block (see the note at the top).
template <class T, class Ptr>
__device__ __forceinline__ void flip_quad(Ptr x, long long u, long long k) {
  const long long h = k >> 1, hq = h >> 1;
  const long long kb = (u & ~(hq - 1)) << 2, q = u & (hq - 1);
  typename T::Bits v0 = x[kb + q], v1 = x[kb + h - 1 - q];
  typename T::Bits v2 = x[kb + h + q], v3 = x[kb + k - 1 - q];
  exchange<T>(v0, v3, true);   // pair q: x[q] against x[k-1-q]
  exchange<T>(v1, v2, true);   // pair h-1-q: x[h-1-q] against x[h+q]
  x[kb + q] = v0;
  x[kb + h + q] = v3;
  x[kb + h - 1 - q] = v1;
  x[kb + k - 1 - q] = v2;
}

// One stage at stride j over a tile in shared memory; `base` is the tile's
// first index in the array, for the direction.
template <class T>
__device__ __forceinline__ void tile_stage(typename T::Bits* s, int tile, long long base, int j,
                                           long long dmask) {
  for (int p = threadIdx.x; p < tile / 2; p += kThreads) {
    const int i = (int)lower_of(p, j);
    typename T::Bits a = s[i], b = s[i + j];
    exchange<T>(a, b, ((base + i) & dmask) == 0);
    s[i] = a;
    s[i + j] = b;
  }
}

template <class T>
__device__ __forceinline__ void tile_load(typename T::Bits* s, const typename T::Bits* x,
                                          long long base, int tile) {
  for (int e = threadIdx.x; e < tile; e += kThreads) s[e] = x[base + e];
  __syncthreads();
}
template <class T>
__device__ __forceinline__ void tile_store(typename T::Bits* x, const typename T::Bits* s,
                                           long long base, int tile) {
  __syncthreads();
  for (int e = threadIdx.x; e < tile; e += kThreads) x[base + e] = s[e];
}

template <class T>
__global__ void __launch_bounds__(kThreads)
block_sort_kernel(const typename T::Bits* __restrict__ in, typename T::Bits* __restrict__ out,
                  int tile, int kmax, long long block) {
  __shared__ typename T::Bits s[kMaxTile];
  const long long base = (long long)blockIdx.x * tile;
  tile_load<T>(s, in, base, tile);
  for (int k = 2; k <= kmax; k <<= 1) {
    const long long dmask = (block - 1) & k;
    for (int j = k >> 1; j > 0; j >>= 1) {
      tile_stage<T>(s, tile, base, j, dmask);
      __syncthreads();
    }
  }
  tile_store<T>(out, s, base, tile);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
merge_tile_kernel(typename T::Bits* __restrict__ x, int tile, long long k, long long block,
                  int flip) {
  __shared__ typename T::Bits s[kMaxTile];
  const long long base = (long long)blockIdx.x * tile;
  const long long dmask = (block - 1) & k;
  tile_load<T>(s, x, base, tile);
  int j = (int)((k < tile ? k : tile) >> 1);
  if (flip && j >= 2) {            // j == k/2: the flipped first stage
    for (int u = threadIdx.x; u < tile / 4; u += kThreads) flip_quad<T>(s, u, k);
    __syncthreads();
    j >>= 1;
  }
  for (; j > 0; j >>= 1) {
    tile_stage<T>(s, tile, base, j, dmask);
    __syncthreads();
  }
  tile_store<T>(x, s, base, tile);
}

template <class T>
__global__ void __launch_bounds__(kStageThreads)
merge_stage_kernel(typename T::Bits* __restrict__ x, long long n, long long k, long long j,
                   long long block, int flip) {
  const long long t = (long long)blockIdx.x * kStageThreads + threadIdx.x;
  if (flip) {                      // j == k/2 >= 2
    if (t < (n >> 2)) flip_quad<T>(x, t, k);
    return;
  }
  if (t >= (n >> 1)) return;
  const long long i = lower_of(t, j);
  typename T::Bits a = x[i], b = x[i + j];
  exchange<T>(a, b, (i & ((block - 1) & k)) == 0);
  x[i] = a;
  x[i + j] = b;
}

bool pow2(long long v) { return v >= 1 && (v & (v - 1)) == 0; }

template <class T>
int block_sort(const void* in, void* out, long long n, int tile, int kmax, long long block,
               cudaStream_t s) {
  using B = typename T::Bits;
  block_sort_kernel<T><<<(unsigned)(n / tile), kThreads, 0, s>>>(
      static_cast<const B*>(in), static_cast<B*>(out), tile, kmax, block);
  return (int)cudaGetLastError();
}

template <class T>
int merge_stage(void* x, long long n, long long k, long long j, long long block, int flip,
                cudaStream_t s) {
  const long long threads = flip ? n / 4 : n / 2;
  const long long grid = (threads + kStageThreads - 1) / kStageThreads;
  merge_stage_kernel<T><<<(unsigned)grid, kStageThreads, 0, s>>>(
      static_cast<typename T::Bits*>(x), n, k, j, block, flip);
  return (int)cudaGetLastError();
}

template <class T>
int merge_tile(void* x, long long n, int tile, long long k, long long block, int flip,
               cudaStream_t s) {
  merge_tile_kernel<T><<<(unsigned)(n / tile), kThreads, 0, s>>>(
      static_cast<typename T::Bits*>(x), tile, k, block, flip);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int32. Every array is (n,) and
// contiguous; n is a multiple of tile, tile a power of two <= 8192, k and j
// powers of two. Each returns the cudaError_t of its launch (0 = success),
// or cudaErrorInvalidValue for arguments it does not take.

// Levels 2..kmax (kmax <= min(tile, block)) of the block sort of blocks of
// `block` elements, tile by tile, from in to out.
extern "C" int mergesort_block_sort_launch(const void* in, void* out, int dtype, long long n,
                                           int tile, int kmax, long long block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pow2(tile) || tile > kMaxTile || n <= 0 || n % tile || !pow2(block) || !pow2(kmax) ||
      kmax < 2 || kmax > tile || kmax > block || n % block)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return block_sort<F32>(in, out, n, tile, kmax, block, s);
  if (dtype == 1) return block_sort<BF16>(in, out, n, tile, kmax, block, s);
  if (dtype == 2) return block_sort<I32>(in, out, n, tile, kmax, block, s);
  return (int)cudaErrorInvalidValue;
}

// Stage j of level k over all of x, in place; flip only for j == k/2 >= 2.
extern "C" int mergesort_merge_stage_launch(void* x, int dtype, long long n, long long k,
                                            long long j, long long block, int flip,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || !pow2(k) || !pow2(j) || j >= k || n % k || !pow2(block) ||
      (flip && (j != k / 2 || j < 2)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return merge_stage<F32>(x, n, k, j, block, flip, s);
  if (dtype == 1) return merge_stage<BF16>(x, n, k, j, block, flip, s);
  if (dtype == 2) return merge_stage<I32>(x, n, k, j, block, flip, s);
  return (int)cudaErrorInvalidValue;
}

// Stages min(k, tile)/2..1 of level k, in place; flip only for k <= tile.
extern "C" int mergesort_merge_tile_launch(void* x, int dtype, long long n, int tile,
                                           long long k, long long block, int flip,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pow2(tile) || tile < 2 || tile > kMaxTile || n <= 0 || n % tile || !pow2(k) || k < 2 ||
      !pow2(block) || (flip && k > tile))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return merge_tile<F32>(x, n, tile, k, block, flip, s);
  if (dtype == 1) return merge_tile<BF16>(x, n, tile, k, block, flip, s);
  if (dtype == 2) return merge_tile<I32>(x, n, tile, k, block, flip, s);
  return (int)cudaErrorInvalidValue;
}
