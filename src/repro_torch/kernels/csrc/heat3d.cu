// One heat3d step, a 7-point stencil with a fixed boundary: paper kernel #3.
// out = c0 * center + c1 * (z- + z+ + y- + y+ + x- + x+) on the interior of
// (Z, Y, X); every boundary point is copied from the input.
//
// Replaces: src/repro/kernels/heat3d/kernel.py:heat3d_step (Pallas,
// pallas_call at :32), stepped by src/repro/kernels/heat3d/ops.py:heat3d.
//
// What bounds it on the H100: bytes. Eight operations per point against one
// element read and one written: at 512^3 in fp32, 1.07 GB a step over
// 3.35 TB/s is 0.32 ms.
//
// Design: a block owns a 32 x 8 tile of (x, y) columns and marches through a
// chunk of 32 planes in z. Each thread keeps its column's z-1, z and z+1
// values in registers, so each plane is read from device memory once (and
// once more at the chunk's two ends). The current plane's tile is staged in
// shared memory with a one-cell halo in x and y, from which the four
// in-plane neighbours are read. The output is written whole, boundary
// included, into a buffer other than the input: no step writes what it
// reads.
//
// Rounding, as the JAX reference does it: the neighbours are added in the
// order z-, z+, y-, y+, x-, x+; c0 and c1 are values of the element type;
// every add and multiply is rounded to the element type (__fadd_rn /
// __fmul_rn, so nothing is contracted into an FMA). In fp32 and in bf16 the
// result is then bit-equal to the plain version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32, kTY = 8;   // (x, y) tile per block, one thread per column
constexpr int kZChunk = 32;        // planes per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and held as a float.
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

template <typename T>
__device__ __forceinline__ float stencil(float c0, float c1, float center, float zm, float zp,
                                         float ym, float yp, float xm, float xp) {
  float s = rnd<T>(__fadd_rn(zm, zp));
  s = rnd<T>(__fadd_rn(s, ym));
  s = rnd<T>(__fadd_rn(s, yp));
  s = rnd<T>(__fadd_rn(s, xm));
  s = rnd<T>(__fadd_rn(s, xp));
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(c0, center)), rnd<T>(__fmul_rn(c1, s))));
}

template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
heat3d_kernel(const T* __restrict__ u, T* __restrict__ out, int nz, int ny, int nx, float c0,
              float c1) {
  __shared__ float tile[kTY + 2][kTX + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * kTX + tx, y = blockIdx.y * kTY + ty;
  const int z0 = blockIdx.z * kZChunk, z1 = min(nz, z0 + kZChunk);
  const bool in = x < nx && y < ny;
  const bool edge = x == 0 || y == 0 || x == nx - 1 || y == ny - 1;
  const long long plane = (long long)ny * nx;
  const long long col = (long long)y * nx + x;
  auto at = [&](int z, long long c) { return to_f(u[z * plane + c]); };

  float below = (in && z0 > 0) ? at(z0 - 1, col) : 0.f;
  float cur = in ? at(z0, col) : 0.f;
  for (int z = z0; z < z1; ++z) {
    const float above = (in && z + 1 < nz) ? at(z + 1, col) : 0.f;
    // Plane z with its halo. A halo cell is read only by an interior point,
    // whose neighbours all lie inside the volume.
    tile[ty + 1][tx + 1] = cur;
    if (tx == 0) tile[ty + 1][0] = (y < ny && x > 0 && x - 1 < nx) ? at(z, col - 1) : 0.f;
    if (tx == kTX - 1) tile[ty + 1][kTX + 1] = (y < ny && x + 1 < nx) ? at(z, col + 1) : 0.f;
    if (ty == 0) tile[0][tx + 1] = (x < nx && y > 0 && y - 1 < ny) ? at(z, col - nx) : 0.f;
    if (ty == kTY - 1) tile[kTY + 1][tx + 1] = (x < nx && y + 1 < ny) ? at(z, col + nx) : 0.f;
    __syncthreads();
    if (in) {
      float r = cur;
      if (!edge && z > 0 && z < nz - 1)
        r = stencil<T>(c0, c1, cur, below, above, tile[ty][tx + 1], tile[ty + 2][tx + 1],
                       tile[ty + 1][tx], tile[ty + 1][tx + 2]);
      out[z * plane + col] = from_f<T>(r);
    }
    __syncthreads();
    below = cur;
    cur = above;
  }
}

template <typename T>
int launch(const void* u, void* out, int nz, int ny, int nx, float c0, float c1,
           cudaStream_t stream) {
  dim3 block(kTX, kTY);
  dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, (nz + kZChunk - 1) / kZChunk);
  heat3d_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(u), static_cast<T*>(out),
                                               nz, ny, nx, c0, c1);
  return (int)cudaGetLastError();
}

}  // namespace

// u, out: (Z, Y, X) contiguous, of one dtype: 0 = float32, 1 = bfloat16;
// out must not overlap u. c0 and c1 are rounded to the dtype. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int heat3d_step_launch(const void* u, void* out, int dtype, int nz, int ny, int nx,
                                  float c0, float c1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nz <= 0 || ny <= 0 || nx <= 0) return 0;
  if (dtype == 0) return launch<float>(u, out, nz, ny, nx, c0, c1, s);
  if (dtype == 1) {
    c0 = __bfloat162float(__float2bfloat16_rn(c0));
    c1 = __bfloat162float(__float2bfloat16_rn(c1));
    return launch<__nv_bfloat16>(u, out, nz, ny, nx, c0, c1, s);
  }
  return (int)cudaErrorInvalidValue;
}
