// C = A @ B for A (M, K) and B (K, N), row-major, with fp32 accumulation and
// C in the inputs' type: paper kernel #1, the kernel behind the paper's
// IOMMU overhead figures.
//
// Replaces: src/repro/kernels/gemm/kernel.py:gemm (Pallas, pallas_call at
// :43), the entry point of src/repro/kernels/gemm/ops.py:matmul.
//
// What bounds it on the H100: operations. 2 M N K flops on (M K + K N + M N)
// elements: at 8192^3, 1.1e12 flops take 16.4 ms in fp32 on the CUDA cores
// (67 TFLOP/s) and 1.11 ms in bf16 on the tensor cores (989 TFLOP/s), against
// 0.24 ms (fp32) and 0.12 ms (bf16) to move the three matrices once.
//
// Three kernels; ops.py picks one by dtype, N, K and the bases' alignment
// before the launch.
//
// bgemm_wgmma_kernel (bf16, K and N multiples of 8, 16-byte-aligned bases):
// the only route to the tensor cores' full rate is wgmma fed by TMA. A
// persistent grid of one CTA an SM walks 128 x 256 output tiles in groups
// of kGroupM M-tiles (a wave's CTAs then share B panels in L2). Three
// warpgroups: one thread of the third issues TMA loads (A as one 128 x 64
// box, B as four 64 x 64 boxes, all with 128-byte swizzle) into a ring of 4
// stages of 48 KB, each a full/empty mbarrier pair; the two consumer
// warpgroups own 64 rows each and run m64n256k16 products straight from
// shared memory, A K-major and B (row-major (K, N), so N-major) under the
// transpose bit, one product spanning B's four 64-column slabs through the
// descriptor's leading byte offset. A consumer keeps one group of 4
// products in flight and frees a stage once its group has completed; the
// producer runs ahead into the next tile while the consumers store the
// last one. TMA zero-fills the ragged M, N and K edges.
//
// bgemm_kernel (other bf16: rows that are not 16-byte strides, or a base off
// 16 bytes): mma.sync m16n8k16 on the tensor cores, a 128 x 128 tile with 8
// warps of 64 x 32, K 32 at a time through padded shared memory, guarded
// loads.
//
// sgemm_kernel (fp32): true fp32 on the CUDA cores, no TF32. A block
// computes a 128 x 128 tile with 256 threads, each an 8 x 8 micro-tile (two
// 4-row by two 4-column pieces, so shared-memory reads are conflict-free
// float4s). K advances 16 at a time through two shared-memory buffers (A
// stored transposed), one barrier a step: the next K tile is loaded into
// registers (16-byte loads where the rows allow) while the current one is
// used, then stored into the other buffer.
//
// The two CUDA-core-fed kernels guard every load, so M, N and K need not
// divide the tiles; a missing element reads as zero and a C element outside
// (M, N) is not written.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------- fp32 path
constexpr int kSM = 128, kSN = 128, kSK = 16;

// Four consecutive floats of row r from column c of a (rows, cols) matrix
// with row stride ld; elements outside it read as zero.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int r, int c, int rows,
                                        int cols, int ld, bool vec) {
  if (vec && r < rows && c + 4 <= cols)
    return *reinterpret_cast<const float4*>(p + (size_t)r * ld + c);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (r < rows && c + j < cols) ? p[(size_t)r * ld + c + j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads, 2)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
             int m, int n, int k, int a_vec, int b_vec) {
  __shared__ __align__(16) float as[2][kSK][kSM];   // A tiles, transposed: [k][row]
  __shared__ __align__(16) float bs[2][kSK][kSN];   // B tiles: [k][col]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSM, n0 = blockIdx.x * kSN;
  // Loads: two float4 each of A (128 rows x 4 k quads) and B (16 k x 32
  // column quads).
  float4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      ra[i] = load4(a, m0 + idx / 4, k0 + (idx % 4) * 4, m, k, k, a_vec);
      rb[i] = load4(b, k0 + idx / 32, n0 + (idx % 32) * 4, k, n, n, b_vec);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / 4, kq = (idx % 4) * 4;
      as[buf][kq + 0][row] = ra[i].x;
      as[buf][kq + 1][row] = ra[i].y;
      as[buf][kq + 2][row] = ra[i].z;
      as[buf][kq + 3][row] = ra[i].w;
      *reinterpret_cast<float4*>(&bs[buf][idx / 32][(idx % 32) * 4]) = rb[i];
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (k + kSK - 1) / kSK;
  if (nk > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) load((t + 1) * kSK);
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read in step t - 1, before that step's barrier.
    if (t + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
  const bool c_vec = n % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + tx * 4;
      float* dst = c + (size_t)r * n + col;
      if (c_vec && col + 4 <= n) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                                      acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) dst[j] = acc[i][4 * h + j];
      }
    }
  }
}

// ------------------------------------------------------- bf16 path, mma.sync
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kAStride = kBK + 8;    // bf16 per row of the A tile: 20 words
constexpr int kBStride = kBN + 8;    // bf16 per row of the B tile: 68 words

// Eight consecutive bf16 of row r from column c of a (rows, cols) matrix with
// row stride ld; elements outside it read as zero.
__device__ __forceinline__ uint4 load8(const uint16_t* __restrict__ p, int r, int c, int rows,
                                       int cols, int ld, bool vec) {
  if (vec && r < rows && c + 8 <= cols)
    return *reinterpret_cast<const uint4*>(p + (size_t)r * ld + c);
  uint16_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = (r < rows && c + j < cols) ? p[(size_t)r * ld + c + j] : 0;
  return make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16,
                    h[4] | (uint32_t)h[5] << 16, h[6] | (uint32_t)h[7] << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint16_t f_to_bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__global__ void __launch_bounds__(kThreads)
bgemm_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
             uint16_t* __restrict__ c, int m, int n, int k, int a_vec, int b_vec) {
  __shared__ __align__(16) uint16_t as[kBM * kAStride];   // [row][k]
  __shared__ __align__(16) uint16_t bs[kBK * kBStride];   // [k][col]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                   // mma fragment coordinates
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;   // this warp's piece
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // Loads: two 8-element chunks each of A (128 rows x 4 chunks) and B (32 k
  // rows x 16 chunks).
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      ra[i] = load8(a, m0 + idx / 4, k0 + (idx % 4) * 8, m, k, k, a_vec);
      rb[i] = load8(b, k0 + idx / 16, n0 + (idx % 16) * 8, k, n, n, b_vec);
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load(0);
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&as[(idx / 4) * kAStride + (idx % 4) * 8]) = ra[i];
      *reinterpret_cast<uint4*>(&bs[(idx / 16) * kBStride + (idx % 16) * 8]) = rb[i];
    }
    __syncthreads();
    if (k0 + kBK < k) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A fragment (16 x 16, row-major): rows g and g + 8, k pairs 2t and 2t + 8.
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint16_t* r0 = &as[(wm + mi * 16 + g) * kAStride + kk + 2 * t];
        const uint16_t* r8 = r0 + 8 * kAStride;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
      // B fragment (16 x 8, by column): column g, k pairs 2t and 2t + 8.
      uint32_t bf[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint16_t* p = &bs[(kk + 2 * t) * kBStride + wn + ni * 8 + g];
        bf[ni][0] = p[0] | (uint32_t)p[kBStride] << 16;
        bf[ni][1] = p[8 * kBStride] | (uint32_t)p[9 * kBStride] << 16;
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
  // C fragment: rows g and g + 8, columns 2t and 2t + 1.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + 8 * h;
        if (r >= m) continue;
        if (col < n) c[(size_t)r * n + col] = f_to_bf16_bits(acc[mi][ni][2 * h]);
        if (col + 1 < n) c[(size_t)r * n + col + 1] = f_to_bf16_bits(acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------- bf16 path, wgmma
constexpr int kWM = 128, kWN = 256, kWK = 64;   // CTA tile and K step
constexpr int kConsumers = 2;                   // warpgroups of 64 rows each
constexpr int kThreadsW = 128 * (kConsumers + 1);
constexpr int kStages = 4;
constexpr int kGroupM = 8;                      // M-tiles per raster group
constexpr int kSlabB = kWK * 128;               // one 64-column slab of B: 8 KB
constexpr int kABytes = kWM * 128;              // 16 KB
constexpr int kStageBytes = kABytes + (kWN / 64) * kSlabB;   // 48 KB
constexpr int kBarOff = kStages * kStageBytes;
// + full and empty barriers, + slack to align the base to 1024 bytes
constexpr int kSmemW = kBarOff + 16 * kStages + 1024;

// Output tile t of a tiles_m x tiles_n grid, walked down kGroupM M-tiles
// before moving one N-tile on.
__device__ __forceinline__ void tile_of(int t, int tiles_m, int tiles_n, int& mt, int& nt) {
  const int per_group = kGroupM * tiles_n;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int r = t % per_group;
  mt = first + r % rows;
  nt = r / rows;
}

__global__ void __launch_bounds__(kThreadsW, 1)
bgemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b, __nv_bfloat16* __restrict__ c,
                   int m, int n, int k) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  // Stage s: A [128 rows][64 k] at s * kStageBytes, then B as 4 slabs
  // [64 k][64 columns], all rows of 128 bytes in the TMA's swizzle.
  const uint32_t tiles_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full_bar = tiles_s + kBarOff;            // [stage]
  const uint32_t empty_bar = full_bar + 8 * kStages;      // [stage]
  const int tiles_m = (m + kWM - 1) / kWM, tiles_n = (n + kWN - 1) / kWN;
  const int n_tiles = tiles_m * tiles_n;
  const int k_steps = (k + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, 4 * kConsumers);   // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full, across tiles
    regs_dec<40>();
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int mt, nt;
        tile_of(t, tiles_m, tiles_n, mt, nt);
        const int n0 = nt * kWN;
        // B slabs wholly past N are not loaded: they would only feed
        // columns of C that are not stored.
        const int slabs = min(kWN / 64, (n - n0 + 63) / 64);
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int st = it % kStages;
          mbar_wait(empty_bar + 8 * st, ((it / kStages) & 1) ^ 1);
          const uint32_t full = full_bar + 8 * st;
          const uint32_t base = tiles_s + st * kStageBytes;
          mbar_arrive_expect_tx(full, kABytes + slabs * kSlabB);
          tma_load_2d(base, &tm_a, full, ks * kWK, mt * kWM);
          for (int s = 0; s < slabs; ++s)
            tma_load_2d(base + kABytes + s * kSlabB, &tm_b, full, n0 + 64 * s, ks * kWK);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows x 256 columns each
    regs_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    float acc[128];
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int mt, nt;
      tile_of(t, tiles_m, tiles_n, mt, nt);
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int st = it % kStages;
        mbar_wait(full_bar + 8 * st, (it / kStages) & 1);
        const uint32_t a_s = tiles_s + st * kStageBytes + wg * (64 * 128);
        const uint32_t b_s = tiles_s + st * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk)
          wgmma_m64n256k16_ss_tn(acc, desc_sw128(a_s + kk * 32),
                                 desc_sw128_lbo(b_s + kk * 16 * 128, kSlabB),
                                 ks > 0 || kk > 0);
        wgmma_commit();
        // The previous step's products have completed: free its stage.
        wgmma_wait<1>();
        if (ks > 0 && lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % kStages));

      // Epilogue: rows r0 and r0 + 8, columns c0 and c0 + 1 of every group
      // of 8, rounded to bf16 as the plain version rounds.
      const int r0 = mt * kWM + wg * 64 + warp * 16 + lane / 4;
      const int c0 = nt * kWN + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= m) continue;
        __nv_bfloat16* crow = c + (size_t)row * n;
#pragma unroll
        for (int j = 0; j < kWN / 8; ++j) {
          const int col = c0 + 8 * j;
          if (col < n)   // n is even, so col + 1 < n too
            *reinterpret_cast<__nv_bfloat162*>(crow + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

}  // namespace

// a: (M, K), b: (K, N), c: (M, N), all contiguous and row-major, of one
// dtype: 0 = float32 (sgemm_kernel), 1 = bfloat16 (bgemm_kernel). Returns
// the cudaError_t of the launch (0 = success).
extern "C" int gemm_launch(const void* a, const void* b, void* c, int dtype, int m, int n,
                           int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (dtype == 0) {
    const int a_vec = k % 4 == 0 && (uintptr_t)a % 16 == 0;
    const int b_vec = n % 4 == 0 && (uintptr_t)b % 16 == 0;
    dim3 grid((n + kSN - 1) / kSN, (m + kSM - 1) / kSM);
    sgemm_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(a),
                                           static_cast<const float*>(b),
                                           static_cast<float*>(c), m, n, k, a_vec, b_vec);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    const int a_vec = k % 8 == 0 && (uintptr_t)a % 16 == 0;
    const int b_vec = n % 8 == 0 && (uintptr_t)b % 16 == 0;
    dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    bgemm_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint16_t*>(a),
                                           static_cast<const uint16_t*>(b),
                                           static_cast<uint16_t*>(c), m, n, k, a_vec, b_vec);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 only, on bgemm_wgmma_kernel. a: (M, K), b: (K, N), c: (M, N), all
// contiguous and row-major with 16-byte-aligned bases; K and N multiples of
// 8, K > 0. Returns the cudaError_t of the launch (0 = success), or a
// negative code when a tensor map cannot be encoded (-1: the CUDA driver
// has no encoder; -(1000 + CUresult): the map is refused).
extern "C" int gemm_wgmma_launch(const void* a, const void* b, void* c, int m, int n, int k,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 8 != 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int e = hopper::encode_2d_bf16(&ta, a, m, k, kWM);
  if (e == 0) e = hopper::encode_2d_bf16(&tb, b, k, n, kWK);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(bgemm_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemW);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((m + kWM - 1) / kWM) * ((n + kWN - 1) / kWN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  bgemm_wgmma_kernel<<<grid, kThreadsW, kSmemW, s>>>(ta, tb, static_cast<__nv_bfloat16*>(c),
                                                     m, n, k);
  return (int)cudaGetLastError();
}
