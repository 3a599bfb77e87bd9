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
// Design, kept simple on purpose (no TMA, no wgmma, no cp.async pipeline):
// - fp32: true fp32 on the CUDA cores, no TF32. A block computes a 128 x 128
//   tile of C with 256 threads, each an 8 x 8 micro-tile (two 4-row by two
//   4-column pieces, so shared-memory reads are conflict-free float4s). K
//   advances 8 at a time through shared memory (A stored transposed); the
//   next K tile is loaded into registers while the current one is used.
// - bf16: mma.sync m16n8k16 (bf16 in, fp32 accumulate) on the tensor cores.
//   A block computes a 128 x 128 tile with 8 warps, each a 64 x 32 piece
//   (4 x 4 mma tiles). K advances 32 at a time through shared memory, A as
//   [row][k] and B as [k][n], both padded so the fragment reads are free of
//   bank conflicts; the next K tile is loaded into registers (16-byte loads
//   where the rows allow) while the current one is used.
// Every load is guarded, so M, N and K need not divide the tiles; a missing
// element reads as zero and a C element outside (M, N) is not written.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------- fp32 path
constexpr int kSM = 128, kSN = 128, kSK = 8;

__global__ void __launch_bounds__(kThreads)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
             int m, int n, int k) {
  __shared__ __align__(16) float as[kSK][kSM];   // A tile, transposed: [k][row]
  __shared__ __align__(16) float bs[kSK][kSN];   // B tile: [k][col]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSM, n0 = blockIdx.x * kSN;
  // Loads: A as 128 rows x (2 x 4) k, B as 8 k x (32 x 4) columns.
  const int a_row = tid / 2, a_k = (tid % 2) * 4;
  const int b_k = tid / 32, b_col = (tid % 32) * 4;
  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ar = m0 + a_row, ak = k0 + a_k + i;
      ra[i] = (ar < m && ak < k) ? a[(size_t)ar * k + ak] : 0.f;
      const int bk = k0 + b_k, bc = n0 + b_col + i;
      rb[i] = (bk < k && bc < n) ? b[(size_t)bk * n + bc] : 0.f;
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < k; k0 += kSK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) as[a_k + i][a_row] = ra[i];
    *reinterpret_cast<float4*>(&bs[b_k][b_col]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
    if (k0 + kSK < k) load(k0 + kSK);
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < n) c[(size_t)r * n + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- bf16 path
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

}  // namespace

// a: (M, K), b: (K, N), c: (M, N), all contiguous and row-major, of one
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int gemm_launch(const void* a, const void* b, void* c, int dtype, int m, int n,
                           int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (dtype == 0) {
    dim3 grid((n + kSN - 1) / kSN, (m + kSM - 1) / kSM);
    sgemm_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(a),
                                           static_cast<const float*>(b),
                                           static_cast<float*>(c), m, n, k);
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
