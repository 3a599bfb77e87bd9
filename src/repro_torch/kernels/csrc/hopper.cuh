// Hopper (sm_90a) building blocks shared by the hand-written kernels:
// mbarriers, 1-D bulk copies, TMA tensor loads and host-side tensor-map
// encoding, wgmma
// shared-memory descriptors and the m64n64k16 and m64n256k16 bf16 products,
// and register hand-over between warpgroups (setmaxnreg).
//
// Shared-memory tiles are in the layout a TMA load with 128-byte swizzle
// writes: rows of 64 bf16 (128 bytes), 8 rows to a 1024-byte swizzle atom,
// each tile 1024-byte aligned. A matrix wider than 64 columns is kept as
// slabs of 64 columns, one TMA box each; a product reads one slab per
// descriptor, or (MN-major, desc_sw128_lbo) several slabs from one.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy; follow
// with a __syncthreads() before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also tells the barrier how many bytes the TMA loads of
// this phase will deliver.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Blocks until the phase of parity ``parity`` has completed. A fresh
// barrier is in phase 0, so waiting on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------- bulk copy

// Copies ``bytes`` contiguous bytes from global memory at ``src`` to shared
// memory at ``dst`` through the TMA unit, without a tensor map; completion
// is reported to ``bar`` as transaction bytes (announce them first with
// mbar_arrive_expect_tx). ``src`` and ``dst`` must be 16-byte aligned and
// ``bytes`` a multiple of 16: the hardware refuses anything else. Without a
// cluster launch a CTA's shared::cluster address is its shared::cta one.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------- TMA

// A 4-D box load; coordinates innermost first. Completion is reported to
// ``bar`` as transaction bytes. Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// A 2-D box load; coordinates innermost (column) first.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver through the runtime, so that
// the library needs no -lcuda. Null if the CUDA driver does not have it.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                       12000, cudaEnableDefault, &q);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor of the model's (B, S, H, D) layout as a 4-D map with dims
// (D, H, S, B), read in boxes of 64 columns x 1 head x ``rows`` x 1 batch
// row with 128-byte swizzle. Returns 0, or a negative code: -1 when the
// CUDA driver has no encoder, -(1000 + CUresult) when it refuses the map.
inline int encode_bshd_bf16(CUtensorMap* map, const void* base, int b, int s, int h,
                            int d, int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)s * h * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(1000 + (int)r);
}

// A row-major (rows, cols) bf16 matrix as a 2-D map with dims (cols, rows),
// read in boxes of 64 columns x ``box_rows`` rows with 128-byte swizzle.
// ``cols`` must be a multiple of 8 (a 16-byte row stride). Returns as
// encode_bshd_bf16 does.
inline int encode_2d_bf16(CUtensorMap* map, const void* base, int rows, int cols,
                          int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(1000 + (int)r);
}

// ----------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled bf16 tile at shared address ``addr``
// (1024-byte aligned, or offset by a multiple of 32 bytes inside a row to
// step along K of a K-major operand). Start address, leading and stride
// byte offsets are in 16-byte units. The stride offset (SBO) is the step
// from one 8-row group to the next: 1024 bytes. The leading offset (LBO) is
// the step between 64-column swizzle atoms along M/N of an MN-major
// operand; with one atom per instruction it is never taken, and K-major
// swizzled operands ignore it. Layout type 1 is the 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same descriptor with the leading byte offset given: an MN-major
// operand wider than one 64-column swizzle atom (N > 64 in one product)
// steps ``lbo`` bytes from one atom to the next, the stride between the
// tile's 64-column slabs. The stride offset stays the 1024-byte 8-row group.
__device__ __forceinline__ uint64_t desc_sw128_lbo(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous product: call on every register of the fragment
// after wgmma_wait and before the wgmma that reads it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HOPPER_D32(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),          \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),    \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),             \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),             \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),             \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_D32O(d, o)                                                          \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),                  \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]),              \
      "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]),            \
      "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15]),          \
      "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]),          \
      "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]),          \
      "+f"(d[o + 24]), "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]),          \
      "+f"(d[o + 28]), "+f"(d[o + 29]), "+f"(d[o + 30]), "+f"(d[o + 31])
#define HOPPER_R32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "        \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "    \
  "%31}"

// d(64x64, fp32) (+)= A(64x16) @ B(16x64), both from shared memory, both
// K-major (K contiguous). ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d(64x64, fp32) (+)= A(64x16) @ B(16x64), A from registers (four bf16
// pairs a thread, in the accumulator's row/column order), B from shared
// memory MN-major (N contiguous: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tn(float (&d)[32], uint32_t a0,
                                                      uint32_t a1, uint32_t a2,
                                                      uint32_t a3, uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// d(64x256, fp32) (+)= A(64x16) @ B(16x256), both from shared memory: A
// K-major, B MN-major (N contiguous: the transpose bit set), its four
// 64-column atoms ``desc_sw128_lbo``'s leading offset apart. Register i of
// d is row r0 + 8 * ((i >> 1) & 1), column c0 + 8 * (i >> 2) + (i & 1), where
// r0 = 16 * warp + lane / 4 and c0 = 2 * (lane % 4) in the warpgroup.
__device__ __forceinline__ void wgmma_m64n256k16_ss_tn(float (&d)[128], uint64_t a,
                                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}"
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : HOPPER_D32O(d, 0), HOPPER_D32O(d, 32), HOPPER_D32O(d, 64), HOPPER_D32O(d, 96)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef HOPPER_D32
#undef HOPPER_D32O
#undef HOPPER_R32

// ------------------------------------------------------------- registers

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace hopper
