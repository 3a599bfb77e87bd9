// One heat3d step, a 7-point stencil with a fixed boundary: paper kernel #3.
// out = c0 * center + c1 * (z- + z+ + y- + y+ + x- + x+) on the interior of
// a contiguous (Z, Y, X) volume; every boundary point is copied.
//
// Replaces: src/repro/kernels/heat3d/kernel.py:heat3d_step (Pallas,
// pallas_call at :32), stepped by src/repro/kernels/heat3d/ops.py:heat3d.
//
// What bounds it on the H100: bytes. Eight operations a point against one
// element read and one written: at 512^3, 1.07 GB a step in fp32 over
// 3.35 TB/s is 0.32 ms, 0.16 ms in bf16.
//
// Design: one kernel, heat3d_ring_kernel, for every shape the wrapper takes,
// instantiated by dtype and by kRows16 (rows are 16-byte strides at a
// 16-byte-aligned base, so every read is one aligned 16-byte load).
// - Work is cut along 16-byte chunks of the output (4 fp32 or 8 bf16
//   consecutive x points); the output starts at the input's offset within
//   16 bytes, so the two share one grid of 16-byte words. A half-warp owns
//   16 chunks of a row, a block 16 chunks of 16 rows, and it marches z
//   through 16 planes. Each lane writes its chunk with one 16-byte store;
//   only a chunk that a row shares with the next is stored point by point.
// - A ring of kAhead + 3 planes in shared memory holds planes z-1, z, z+1
//   and the kAhead = 4 planes in flight ahead of them: per plane 18 window
//   rows (the tile and its y halo) of 18 aligned 16-byte words (its chunks
//   and one word of x halo each side), copied with cp.async 16 bytes at a
//   time. One __syncthreads a plane frees the oldest slot and publishes the
//   plane that landed.
// - A row that is not a 16-byte stride starts at another offset within 16
//   bytes than its neighbours. Each window row is copied as whole aligned
//   words, so a neighbour's 16 bytes sit s bytes into an aligned word, where
//   s is the row (y) or plane (z) stride mod 16: the same for every lane and
//   every row of the launch. They are read as the two aligned words around
//   them and shifted into place in registers; a shift of 0 is one load.
//   Only words that hold a byte of the input are copied: such a word lies
//   in the input's allocation, whose ends are 16-byte aligned.
// Rounding, as the JAX reference does it: the neighbours are added in the
// order z-, z+, y-, y+, x-, x+; c0 and c1 are values of the element type;
// every add and multiply is rounded to the element type, and nothing is
// contracted into an FMA (fp32: __fadd_rn / __fmul_rn; bf16: add.rn.bf16x2 /
// mul.rn.bf16x2 on packed pairs, whose one rounding of two bf16 operands
// equals the plain version's fp32 op rounded to bf16). The result is
// bit-equal to the plain version in fp32 and in bf16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 16;                    // 16-byte output chunks a row: one a lane
constexpr int kTileY = 2 * kWarps;             // output rows a block: one a half-warp
constexpr int kRows = kTileY + 2;              // window rows a plane: tile and y halo
constexpr int kZChunk = 16;                    // planes a block marches
constexpr int kAhead = 4;                      // planes in flight ahead of z + 1
constexpr int kSlots = kAhead + 3;             // ring: z-1, z, z+1 and those in flight

constexpr int kWords = kChunks + 2;            // 16-byte words a window row: chunks and x halo
constexpr int kSlot = kRows * kWords * 16;     // bytes a plane
constexpr int kRingBytes = kSlots * kSlot;
static_assert(kRingBytes <= 48 * 1024, "the ring must fit the default dynamic shared memory");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rounded ops on one 32-bit word: one fp32 value or a pair of bf16 values.
template <typename T> struct Arith;
template <> struct Arith<float> {
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ static uint32_t mul(uint32_t a, uint32_t b) {
    return __float_as_uint(__fmul_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ static uint32_t splat(float c) { return __float_as_uint(c); }
};
template <> struct Arith<__nv_bfloat16> {
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static uint32_t splat(float c) {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(c));
    return h | (h << 16);
  }
};

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The 16 bytes that start s bytes (a multiple of the element size) into the
// aligned word at byte `word` of a window row. s is the same in every lane
// and for the whole launch (it depends on the row and plane strides only),
// so the branch is uniform and the selects' predicates stay in registers.
template <bool kRows16>
__device__ __forceinline__ uint4 window16(const unsigned char* row, int word, int s) {
  const uint4 a = lds128(row + word);
  if (kRows16 || s == 0) return a;
  const uint4 b = lds128(row + word + 16);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t t[6], u[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) t[j] = (s & 8) ? w[j + 2] : w[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) u[j] = (s & 4) ? t[j + 1] : t[j];
  const uint32_t bits = (s & 3) * 8;           // 16 for an odd bf16 offset, else 0
  return make_uint4(__funnelshift_r(u[0], u[1], bits), __funnelshift_r(u[1], u[2], bits),
                    __funnelshift_r(u[2], u[3], bits), __funnelshift_r(u[3], u[4], bits));
}

template <typename T> __device__ __forceinline__ uint32_t lds_elem(const unsigned char* p) {
  if constexpr (sizeof(T) == 4) return *reinterpret_cast<const uint32_t*>(p);
  else return *reinterpret_cast<const uint16_t*>(p);
}

// Element j of a 16-byte chunk, as its bits.
template <typename T> __device__ __forceinline__ uint32_t elem(const uint32_t (&w)[4], int j) {
  if constexpr (sizeof(T) == 4) return w[j];
  else return (w[j >> 1] >> (16 * (j & 1))) & 0xffffu;
}
template <typename T>
__device__ __forceinline__ void set_elem(uint32_t (&w)[4], int j, uint32_t v) {
  if constexpr (sizeof(T) == 4) {
    w[j] = v;
  } else {
    const int sh = 16 * (j & 1);
    w[j >> 1] = (w[j >> 1] & ~(0xffffu << sh)) | (v << sh);
  }
}

// The stencil on one chunk c (xm, xp: the elements just before and after
// it), in the reference's order of adds.
template <typename T>
__device__ __forceinline__ void stencil(uint32_t (&r)[4], const uint4& c, uint32_t xm, uint32_t xp,
                                        const uint4& zm, const uint4& zp, const uint4& ym,
                                        const uint4& yp, uint32_t c0, uint32_t c1) {
  using A = Arith<T>;
  const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
  const uint32_t zmw[4] = {zm.x, zm.y, zm.z, zm.w}, zpw[4] = {zp.x, zp.y, zp.z, zp.w};
  const uint32_t ymw[4] = {ym.x, ym.y, ym.z, ym.w}, ypw[4] = {yp.x, yp.y, yp.z, yp.w};
  uint32_t xmw[4], xpw[4];
  if constexpr (sizeof(T) == 4) {
    xmw[0] = xm; xmw[1] = cw[0]; xmw[2] = cw[1]; xmw[3] = cw[2];
    xpw[0] = cw[1]; xpw[1] = cw[2]; xpw[2] = cw[3]; xpw[3] = xp;
  } else {
    xmw[0] = __funnelshift_r(xm << 16, cw[0], 16);
#pragma unroll
    for (int i = 1; i < 4; ++i) xmw[i] = __funnelshift_r(cw[i - 1], cw[i], 16);
#pragma unroll
    for (int i = 0; i < 3; ++i) xpw[i] = __funnelshift_r(cw[i], cw[i + 1], 16);
    xpw[3] = __funnelshift_r(cw[3], xp, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t s = A::add(zmw[i], zpw[i]);
    s = A::add(s, ymw[i]);
    s = A::add(s, ypw[i]);
    s = A::add(s, xmw[i]);
    s = A::add(s, xpw[i]);
    r[i] = A::add(A::mul(c0, cw[i]), A::mul(c1, s));
  }
}

template <typename T, bool kRows16>
__global__ void __launch_bounds__(kThreads, 2)
heat3d_ring_kernel(const T* __restrict__ u, T* __restrict__ out, int nz, int ny, int nx,
                   float c0f, float c1f) {
  constexpr int kE = sizeof(T), kV = 16 / kE;      // bytes an element, elements a chunk
  constexpr int kTasks = (kRows * kWords + kThreads - 1) / kThreads;  // copies a thread a plane
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int cl = tid & 15;                         // the lane's chunk of its row
  const int r = 1 + 2 * warp + ((tid >> 4) & 1);   // the lane's window row
  const int y0 = blockIdx.y * kTileY, y = y0 + r - 1;
  const int z0 = blockIdx.z * kZChunk, z1 = min(nz, z0 + kZChunk);
  const int rb = nx * kE;                          // bytes a row
  const long long pb = (long long)ny * rb;         // bytes a plane
  const uintptr_t in_lo = reinterpret_cast<uintptr_t>(u), in_hi = in_lo + nz * pb;
  const int xb = blockIdx.x * (kChunks * 16);      // the block's first chunk past a row's start
  const int row_chunks = (rb + (kRows16 ? 0 : 16 - kE) + 15) >> 4;  // most chunks a row spans
  const int n_words = min(kWords, row_chunks - (int)blockIdx.x * kChunks + 2);
  const bool clamp = z0 == 0 || z1 >= nz - 1;      // a window may reach past the input's ends
  const uint32_t c0 = Arith<T>::splat(c0f), c1 = Arith<T>::splat(c1f);

  // Copy tasks: word c of window row r (y = y0 - 1 + r) for i = tid + k * kThreads.
  // src runs over the row's start u + (p * ny + y) * rb, plane after plane;
  // the word is 16 * c past the aligned word before the block's first chunk.
  uintptr_t src[kTasks];
  int woff[kTasks];
  uint32_t dst[kTasks];
#pragma unroll
  for (int k = 0; k < kTasks; ++k) {
    const int i = tid + k * kThreads, r = i / kWords, c = i - r * kWords, y = y0 - 1 + r;
    const bool used = i < kRows * kWords && y >= 0 && y < ny && c < n_words;
    dst[k] = used ? (uint32_t)(r * kWords + c) * 16 : ~0u;
    src[k] = in_lo + ((long long)(z0 - 1) * ny + y) * rb;
    woff[k] = xb - 16 + 16 * c;
  }
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  // Plane p (the next in order) into a slot; one commit group a plane, empty
  // for a plane that is not read.
  auto load_plane = [&](int p, int slot) {
    const bool live = p >= 0 && p < nz && p <= z1;
    const uint32_t base = ring_s + slot * kSlot;
#pragma unroll
    for (int k = 0; k < kTasks; ++k) {
      const uintptr_t a = (src[k] & ~(uintptr_t)15) + woff[k];
      src[k] += pb;
      if (live && dst[k] != ~0u && (!clamp || (a + 16 > in_lo && a < in_hi)))
        cp_async16(base + dst[k], reinterpret_cast<const void*>(a));
    }
    cp_async_commit();
  };
  // The lane's row's start in the output at plane z, plane after plane. The
  // output lies at the input's offset within 16 bytes, so a row starts at
  // the same offset (its phase) in both.
  uintptr_t orow = reinterpret_cast<uintptr_t>(out) + ((long long)z0 * ny + y) * rb;
  // A neighbour row's points sit `step` bytes further on within 16 bytes
  // than the row's own: their shift is `step` (mod 16), the same for every row.
  const int rb16 = rb & 15, pb16 = (int)(pb & 15);
  const int s_ym = -rb16 & 15, s_yp = rb16, s_zm = -pb16 & 15, s_zp = pb16;
  auto wrap = [](int s) { return s >= kSlots ? s - kSlots : s; };

#pragma unroll 1
  for (int i = 0; i < kAhead + 2; ++i) load_plane(z0 - 1 + i, i);
  int s_m = 0;                                     // slot of plane z - 1
#pragma unroll 1
  for (int z = z0; z < z1; ++z) {
    cp_async_wait<kAhead - 1>();                   // planes up to z + 1 have landed
    __syncthreads();                               // ... for every thread; z - 2 is free
    load_plane(z + kAhead + 1, wrap(s_m + kSlots - 1));
    const int s_0 = wrap(s_m + 1), s_p = wrap(s_m + 2);
    const uintptr_t o = orow;
    orow += pb;
    const int ph = kRows16 ? 0 : (int)(o & 15);    // the row's phase
    const int x0 = (xb + 16 * cl - ph) / kE;       // x of the chunk's first point
    if (y < ny && x0 < nx) {
      const int off = 16 + 16 * cl;                // the chunk's word in its window row
      const unsigned char* row = ring + s_0 * kSlot + r * kWords * 16;
      const uint4 c = lds128(row + off);
      uint32_t res[4] = {c.x, c.y, c.z, c.w};
      if (z > 0 && z < nz - 1 && y > 0 && y < ny - 1) {
        // The aligned word that holds a neighbour's first point.
        auto word = [&](int step, int s) { return off + ((ph + step) & 15) - ph - s; };
        const uint4 ym = window16<kRows16>(row - kWords * 16, word(-rb16, s_ym), s_ym);
        const uint4 yp = window16<kRows16>(row + kWords * 16, word(rb16, s_yp), s_yp);
        const uint4 zm = window16<kRows16>(ring + s_m * kSlot + r * kWords * 16,
                                           word(-pb16, s_zm), s_zm);
        const uint4 zp = window16<kRows16>(ring + s_p * kSlot + r * kWords * 16,
                                           word(pb16, s_zp), s_zp);
        const uint32_t xm = lds_elem<T>(row + off - kE), xp = lds_elem<T>(row + off + 16);
        stencil<T>(res, c, xm, xp, zm, zp, ym, yp, c0, c1);
        if (x0 < 1 || x0 + kV > nx - 1) {          // the chunk holds x = 0 or nx - 1
          const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int j = 0; j < kV; ++j)
            if (x0 + j == 0 || x0 + j == nx - 1) set_elem<T>(res, j, elem<T>(cw, j));
        }
      }
      unsigned char* dst_g =
          reinterpret_cast<unsigned char*>((o & ~(uintptr_t)15) + xb + 16 * cl);
      if (x0 >= 0 && x0 + kV <= nx) {
        *reinterpret_cast<uint4*>(dst_g) = make_uint4(res[0], res[1], res[2], res[3]);
      } else {                                     // a chunk shared with the next row
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if (x0 + j < 0 || x0 + j >= nx) continue;
          if constexpr (kE == 4) *reinterpret_cast<uint32_t*>(dst_g + 4 * j) = elem<T>(res, j);
          else *reinterpret_cast<uint16_t*>(dst_g + 2 * j) = (uint16_t)elem<T>(res, j);
        }
      }
    }
    s_m = s_0;
  }
  cp_async_wait<0>();
}

template <typename T, bool kRows16>
int launch(const void* u, void* out, int nz, int ny, int nx, float c0, float c1,
           cudaStream_t stream) {
  constexpr int kE = sizeof(T);
  const int row_chunks = (nx * kE + (kRows16 ? 0 : 16 - kE) + 15) / 16;
  dim3 grid((row_chunks + kChunks - 1) / kChunks, (ny + kTileY - 1) / kTileY,
            (nz + kZChunk - 1) / kZChunk);
  heat3d_ring_kernel<T, kRows16><<<grid, kThreads, kRingBytes, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(out), nz, ny, nx, c0, c1);
  return (int)cudaGetLastError();
}

}  // namespace

// u, out: (Z, Y, X) contiguous, every dimension >= 3, of one dtype: 0 =
// float32, 1 = bfloat16, out at the same offset within 16 bytes as u and not
// overlapping it. rows16 = 1 takes the instantiation for rows that are
// 16-byte strides at 16-byte-aligned bases (refused otherwise). The kernel
// rounds c0 and c1 to the dtype. Returns the cudaError_t of the launch (0 =
// success).
extern "C" int heat3d_step_launch(const void* u, void* out, int dtype, int rows16, int nz, int ny,
                                  int nx, float c0, float c1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nz < 3 || ny < 3 || nx < 3 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const uintptr_t pu = reinterpret_cast<uintptr_t>(u), po = reinterpret_cast<uintptr_t>(out);
  if (pu % es || (pu - po) % 16) return (int)cudaErrorMisalignedAddress;
  if (rows16 && (pu % 16 || ((long long)nx * es) % 16)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return rows16 ? launch<float, true>(u, out, nz, ny, nx, c0, c1, s)
                  : launch<float, false>(u, out, nz, ny, nx, c0, c1, s);
  }
  return rows16 ? launch<__nv_bfloat16, true>(u, out, nz, ny, nx, c0, c1, s)
                : launch<__nv_bfloat16, false>(u, out, nz, ny, nx, c0, c1, s);
}
