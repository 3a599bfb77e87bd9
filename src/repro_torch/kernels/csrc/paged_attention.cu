// One-token GQA decode attention over a paged KV cache, read through
// per-sequence block tables, in the two layouts the serving engine uses:
//   global    ONE shared pool (total, page, Hkv, D); table (B, P) entries
//             index it, NULL (>= total) marks an unallocated entry (the
//             zero-copy layout).
//   per-slot  one pool per sequence (B, n_pages, page, Hkv, D); table
//             (B, n_pages) is a permutation of slot b's own pages (the copy
//             baseline's layout).
// Both run the same device code: slot b's pages start at page
// b * slot_pages of the pool, with slot_pages = 0 for the global layout
// and n_pages for the per-slot one.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:paged_attention_global
// and :paged_attention (Pallas, the scalar-prefetched block table driving
// each page's DMA).
//
// What bounds it on the H100: bytes. Every valid token's K and V are read
// once for all G query heads of their KV head: 4 * G * D flops on
// 2 * D * itemsize bytes, G / itemsize flops a byte, far below the ~295 a
// byte where the tensor cores would become the limit. The floor is the
// valid K/V bytes over 3.35 TB/s. The CUDA cores alone do not reach it in
// bf16: a 16-byte lane vector costs a conversion, a shuffle tree and a
// per-token softmax besides its FMAs, and a design that did all of it on
// them reached 0.25 (G = 7, D = 128) to 0.58 (G = 4, D = 64) of the byte
// bound on an H100 80GB HBM3 (700 W), bound by its compute. So bf16 runs
// its two products on the tensor cores; fp32, whose products must stay
// fp32, runs them on the CUDA cores.
//
// Design. The page is the unit of copy, as it is the unit of DMA in the
// Pallas kernel: a page's K (and its V) for all KV heads is one contiguous
// run of the pool, a row of Hkv * D a token.
//  - Grid: one CTA per (split of a row's pages, row, head group). A head
//    group is every KV head (up to 8; more are cut into groups of a divisor
//    of Hkv) and up to 8 of their query heads. The host picks the split
//    count from B, the table's capacity and the SM count; the CTA reads
//    its row's length and takes its share of the row's valid pages (the
//    host never reads the lengths).
//  - Copies: a producer warp reads the table entries (one page ahead) and
//    issues 1-D bulk copies (hopper::bulk_load) of K, then V, of ``tpc``
//    tokens of one page into a ring of stages in shared memory: one copy a
//    token row of the group's heads, each row padded to an odd number of
//    16-byte units so that the rows of one head fall in distinct banks.
//    A stage completes on its "full" mbarrier and is handed back on its
//    "empty" one. ``tpc`` is the largest divisor of the page that keeps a
//    stage's K + V within 32 KB (at the serving width, bf16, Hkv 8, D 64,
//    page 16: the whole page). K and V stay in the working dtype. A chunk
//    past the length is never copied; a NULL entry (or one outside slot
//    b's pages) issues no copy and reads as a zero page: its tokens score 0
//    and add nothing to P.V, never dereferenced, never clamped to page 0.
//  - Compute: eight consumer warps; warps are assigned to KV heads, and
//    the warps of one head take its stages in turn (the ring's depth is a
//    multiple of them, so each sees every phase of its stages' barriers).
//    bf16 (D 16, 32, 64, 128, 256): per 16 tokens, S^T = K Q^T and
//    O^T += V^T P^T as mma.sync m16n8k16 with the tokens as M and the
//    group's (up to 8) query heads as N; K and V come from ldmatrix, Q sits
//    in registers, P is split into two bf16 terms (hi = bf16(P), lo =
//    bf16(P - hi)), each turned into a B operand with movmatrix and
//    multiplied into the same fp32 O^T, so P keeps ~16 bits (the reference
//    keeps it in fp32; one bf16 term would keep 8). Other shapes and fp32: a lane holds 16 bytes of a K row,
//    a score is a dot product and a shuffle reduction within the lanes of
//    a row. Both keep the online softmax (m, l in log2 units) in registers
//    and rescale only when a max grows by more than 2^8 (the same softmax).
//  - Merge in the same launch: the warps of a head merge through shared
//    memory; a CTA writes its split's fp32 partial; the last CTA of a
//    (row, head group) to finish, known from an atomicAdd on a per-(row,
//    head group) counter after a __threadfence(), merges the row's
//    partials and resets the counter to 0 for the next call. With one
//    split the CTA writes the output directly.
//  - Log-sum-exp, when the caller gives a buffer: the CTA that writes a
//    row's output also writes lse[b, h] = M + log L (natural units) of
//    each of its query heads, from the (M, L) it merged, and writes the
//    output in fp32, unrounded: the partial over these pages that a merge
//    with partials over a sequence's other pages takes (sequence-parallel
//    decode). A row of length 0 writes -inf. Without a buffer nothing
//    more is stored and the output is in the working dtype.
// Scores are masked before the max, so a row of length 0 returns zeros,
// not NaN, and an inactive all-NULL row of length 1 returns zeros.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 8;                      // consumer warps
constexpr int kThreads = (kConsumers + 1) * 32;    // and one producer warp
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 96 * 1024;    // K + V of the ring, unpadded: two CTAs an SM
constexpr int kHeader = 256;             // barriers and flags ahead of the ring
constexpr int kMaxSmem = 232448;         // 227 KB, the H100's per-block maximum
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLazy = 8.f;             // rescale when a max grows by 2^8
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const unsigned char* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const unsigned char* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {        // the low half is the first element
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ----------------------------------------------------- tensor-core pieces

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// d (16x8, fp32) += a (16x16 bf16, row) @ b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// (x, y) as two packed bf16 pairs, hi = bf16(x, y) and lo = bf16 of the
// remainders (exact in fp32): hi + lo holds x and y to about 16 bits.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

struct Params {
  const void* q;
  const unsigned char* k_pool;
  const unsigned char* v_pool;
  const int32_t* table;
  const int32_t* lengths;
  float* part;          // acc (B, Hq, n_split, D), then (m, l) (B, Hq, n_split, 2)
  int* counters;        // (B, n_z), zero between calls
  void* out;
  float* lse;           // (B, Hq) fp32, or null: no log-sum-exp asked for
  int hq, hkv, g, d, total, slot_pages, page, n_table, n_split;
  int hg, gq, n_qg;     // KV heads, query heads a head, query groups: of a CTA
  int wph;              // consumer warps a KV head
  int tpc, stages;      // tokens a stage, stages of the ring
  int run_bytes;        // one token's K row for the group's heads (hg * D * itemsize)
  int tok_stride;       // the same row in shared memory, padded
  int lpr, gs;          // 16-byte vectors of a head's row; lanes of a row group
  float scale, softcap;
};

// Shared memory: the full and empty barriers, the stages' NULL flags and
// the last-CTA flag (kHeader bytes), then the ring: stage s holds K then V
// of tpc padded token rows. After the loop the ring holds each warp's
// softmax state, [warp][8 query heads][D + 2] floats, for the merges, and
// in the last CTA the splits' (m, l), [heads][splits] each.

// One consumer warp's softmax state for the SIMT path: lane group grp owns
// tokens grp, grp + tpw, ... of each stage, columns lig (+ 32) of the row.
template <typename T, int kG, int kNV, bool kCap>
struct SimtState {
  static constexpr int VEC = Vec16<T>::N;
  static constexpr int EPL = kNV * VEC;
  float q[kG][EPL], acc[kG][EPL], m[kG], l[kG];

  __device__ void init(const Params& p, const T* qrow, int gcount, int lig) {
#pragma unroll
    for (int gg = 0; gg < kG; ++gg) {
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const int j = lig + 32 * v;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          q[gg][v * VEC + e] = (gg < gcount && j < p.lpr)
              ? to_f(qrow[(size_t)gg * p.d + j * VEC + e]) : 0.f;
          acc[gg][v * VEC + e] = 0.f;
        }
      }
      m[gg] = -INFINITY;
      l[gg] = 0.f;
    }
  }

  __device__ void stage(const Params& p, const unsigned char* ks, const unsigned char* vs,
                        int tcount, bool null, int grp, int lig, float sl) {
    const int tpw = 32 / p.gs;
    for (int t0 = 0; t0 < tcount; t0 += tpw) {   // warp-uniform
      const int t = t0 + grp;
      const bool valid = t < tcount;
      float s[kG];
#pragma unroll
      for (int gg = 0; gg < kG; ++gg) s[gg] = 0.f;
      if (!null) {
        float kf[EPL];
#pragma unroll
        for (int v = 0; v < kNV; ++v) {
          const int j = lig + 32 * v;
          if (valid && j < p.lpr) {
            Vec16<T>::load(ks + (size_t)t * p.tok_stride + j * 16, kf + v * VEC);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kf[v * VEC + e] = 0.f;
          }
        }
#pragma unroll
        for (int gg = 0; gg < kG; ++gg)
#pragma unroll
          for (int e = 0; e < EPL; ++e) s[gg] = fmaf(q[gg][e], kf[e], s[gg]);
        for (int o = p.gs >> 1; o > 0; o >>= 1)
#pragma unroll
          for (int gg = 0; gg < kG; ++gg) s[gg] += __shfl_xor_sync(kFull, s[gg], o);
      }
      if (!valid) continue;
#pragma unroll
      for (int gg = 0; gg < kG; ++gg) {
        const float x = kCap ? p.softcap * tanhf(s[gg] * p.scale / p.softcap) * kLog2e
                             : s[gg] * sl;
        if (x > m[gg] + kLazy) {           // m = -inf: the first token
          const float corr = ex2(m[gg] - x);
          l[gg] *= corr;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[gg][e] *= corr;
          m[gg] = x;
        }
        s[gg] = ex2(x - m[gg]);
        l[gg] += s[gg];
      }
      if (null) continue;
      float vf[EPL];
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const int j = lig + 32 * v;
        if (j < p.lpr) {
          Vec16<T>::load(vs + (size_t)t * p.tok_stride + j * 16, vf + v * VEC);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vf[v * VEC + e] = 0.f;
        }
      }
#pragma unroll
      for (int gg = 0; gg < kG; ++gg)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[gg][e] = fmaf(s[gg], vf[e], acc[gg][e]);
    }
  }

  // Merge the lane groups, then lane group 0 writes the state to red[8][d + 2].
  __device__ void dump(const Params& p, float* red, int lane) {
    const int gs = p.gs, lig = lane % gs;
#pragma unroll
    for (int gg = 0; gg < kG; ++gg) {
      float mx = m[gg];
      for (int o = gs; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float f = m[gg] == -INFINITY ? 0.f : ex2(m[gg] - mx);
      l[gg] *= f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[gg][e] *= f;
      for (int o = gs; o < 32; o <<= 1) {
        l[gg] += __shfl_xor_sync(kFull, l[gg], o);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[gg][e] += __shfl_xor_sync(kFull, acc[gg][e], o);
      }
      if (lane < gs) {
        float* r = red + gg * (p.d + 2);
#pragma unroll
        for (int v = 0; v < kNV; ++v) {
          const int j = lig + 32 * v;
          if (j < p.lpr)
#pragma unroll
            for (int e = 0; e < VEC; ++e) r[j * VEC + e] = acc[gg][v * VEC + e];
        }
        if (lane == 0) {
          r[p.d] = mx;
          r[p.d + 1] = l[gg];
        }
      }
    }
  }
};

// One consumer warp's state for the tensor-core path (bf16, D = kD): per
// 16 tokens S^T (tokens x 8 query heads) and O^T (D x 8 query heads) in
// mma fragments. Lane (gi = lane / 4, ti = lane % 4) holds query heads
// 2 ti and 2 ti + 1.
template <int kD, bool kCap>
struct MmaState {
  static constexpr int KS = kD / 16;       // k-steps of S, m-tiles of O
  uint32_t qf[KS][2];                      // Q^T as the B operand of S
  float o[KS][4];
  float m[2], l[2];

  __device__ void init(const __nv_bfloat16* qrow, int gcount, int lane) {
    const int gi = lane >> 2, ti = lane & 3;
    const uint16_t* qb = reinterpret_cast<const uint16_t*>(qrow) + (size_t)gi * kD;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 16 * k + 8 * h + 2 * ti;
        qf[k][h] = gi < gcount ? (uint32_t)qb[c] | (uint32_t)qb[c + 1] << 16 : 0u;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) o[k][r] = 0.f;
    }
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  __device__ void stage(const Params& p, const unsigned char* ks, const unsigned char* vs,
                        int tcount, bool null, int lane, float sl) {
    const int gi = lane >> 2;
    for (int m0 = 0; m0 < tcount; m0 += 16) {
      // S^T = K Q^T: A = 16 token rows of K (ldmatrix; rows past the stage's
      // tokens read a valid row and are masked below), B = Q^T.
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if (!null) {
        int tr = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        tr = tr < tcount ? tr : m0;
        const uint32_t ka = hopper::smem_u32(ks + (size_t)tr * p.tok_stride + (lane >> 4) * 16);
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          uint32_t a[4];
          ldsm_x4(a, ka + 32 * k);
          mma_bf16(c, a, qf[k][0], qf[k][1]);
        }
      }
      const bool v0 = m0 + gi < tcount, v1 = m0 + gi + 8 < tcount;
      float pr[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s0 = kCap ? p.softcap * tanhf(c[h] * p.scale / p.softcap) * kLog2e : c[h] * sl;
        float s1 = kCap ? p.softcap * tanhf(c[2 + h] * p.scale / p.softcap) * kLog2e
                        : c[2 + h] * sl;
        s0 = v0 ? s0 : -INFINITY;
        s1 = v1 ? s1 : -INFINITY;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
        if (mx > m[h] + kLazy) {           // uniform over the lanes of ti
          const float corr = ex2(m[h] - mx);
          l[h] *= corr;
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            o[k][h] *= corr;
            o[k][2 + h] *= corr;
          }
          m[h] = mx;
        }
        pr[h] = ex2(s0 - m[h]);
        pr[2 + h] = ex2(s1 - m[h]);
        l[h] += pr[h] + pr[2 + h];
      }
      if (null) continue;
      // O^T += V^T P^T: A = V^T (ldmatrix.trans of 16 token rows), B = P^T
      // (the S^T fragment, transposed per 8x8 block by movmatrix). P is
      // carried as hi + lo, two bf16 terms (hi = bf16(P), lo = bf16(P - hi),
      // ~16 bits of P), in two products into the same fp32 accumulator: the
      // reference keeps P in fp32, and l above sums the unrounded P.
      uint32_t bh[2], bl[2];
      split_bf16(pr[0], pr[1], bh[0], bl[0]);
      split_bf16(pr[2], pr[3], bh[1], bl[1]);
      const uint32_t b0 = movmatrix_t(bh[0]), b1 = movmatrix_t(bh[1]);
      const uint32_t c0 = movmatrix_t(bl[0]), c1 = movmatrix_t(bl[1]);
      int tv = m0 + (lane & 7) + (lane >> 4) * 8;
      tv = tv < tcount ? tv : m0;
      const uint32_t va = hopper::smem_u32(vs + (size_t)tv * p.tok_stride + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        uint32_t a[4];
        ldsm_x4_t(a, va + 32 * k);
        mma_bf16(o[k], a, b0, b1);
        mma_bf16(o[k], a, c0, c1);
      }
    }
  }

  // Lane (gi, ti) holds O^T rows (dims) 16 k + gi and 16 k + gi + 8 of
  // query heads 2 ti, 2 ti + 1: into red[8][kD + 2].
  __device__ void dump(const Params& p, float* red, int lane) {
    const int gi = lane >> 2, ti = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ls = l[h];
      ls += __shfl_xor_sync(kFull, ls, 4);
      ls += __shfl_xor_sync(kFull, ls, 8);
      ls += __shfl_xor_sync(kFull, ls, 16);
      float* r = red + (2 * ti + h) * (kD + 2);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        r[16 * k + gi] = o[k][h];
        r[16 * k + gi + 8] = o[k][2 + h];
      }
      if (gi == 0) {
        r[kD] = m[h];
        r[kD + 1] = ls;
      }
    }
  }
};

// The output in the working dtype, or in fp32 when an lse is asked for.
template <typename T>
__device__ __forceinline__ void store_out(const Params& p, size_t i, float v) {
  if (p.lse != nullptr) {
    static_cast<float*>(p.out)[i] = v;
  } else {
    static_cast<T*>(p.out)[i] = from_f<T>(v);
  }
}

template <bool kMma, typename A, typename B> struct Pick { using type = A; };
template <typename A, typename B> struct Pick<false, A, B> { using type = B; };

constexpr int min_blocks(int kG, int kD) { return kD == 0 ? (kG <= 4 ? 2 : 1) : (kD <= 128 ? 2 : 1); }

// kD > 0: the tensor-core path (bf16, D = kD); kD = 0: the CUDA-core path.
template <typename T, int kG, int kNV, int kD, bool kCap>
__global__ void __launch_bounds__(kThreads, min_blocks(kG, kD))
paged_decode_ring_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* null_s = reinterpret_cast<int*>(empty + kMaxStages);
  int* last_s = null_s + kMaxStages;
  unsigned char* ring = smem + kHeader;
  constexpr int IT = sizeof(T);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int h0 = (z / p.n_qg) * p.hg;     // first KV head of the CTA
  const int g0 = (z % p.n_qg) * p.gq;     // first query head of each KV head
  const int gcount = min(p.gq, p.g - g0);
  const int d = p.d;

  // This split's pages of the row's valid ones, and their chunks ("items").
  int len = p.lengths[b];
  const int cap = p.n_table * p.page;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int n_valid = (len + p.page - 1) / p.page;
  const int pps = (n_valid + p.n_split - 1) / p.n_split;
  const int t_begin = split * pps * p.page;
  const int t_end = min(len, (split + 1) * pps * p.page);
  const int n_items = t_end > t_begin ? (t_end - t_begin + p.tpc - 1) / p.tpc : 0;
  const size_t stage_bytes = (size_t)p.tpc * p.tok_stride;   // K (or V) of a stage

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(hopper::smem_u32(&full[s]), 1);
      hopper::mbar_init(hopper::smem_u32(&empty[s]), p.hg);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int hl = warp / p.wph, sub = warp - hl * p.wph;
  const bool active = warp < kConsumers && hl < p.hg;
  typename Pick<(kD > 0), MmaState<kD, kCap>, SimtState<T, kG, kNV, kCap>>::type st;
  if (warp == kConsumers) {
    // ---- producer: item j into stage j % stages once its consumers are done
    if (lane == 0 && n_items > 0) {
      const int32_t* row = p.table + (size_t)b * p.n_table;
      const size_t tok_bytes = (size_t)p.hkv * d * IT;   // one pool token, all heads
      const unsigned char* kbase = p.k_pool + (size_t)h0 * d * IT;
      const unsigned char* vbase = p.v_pool + (size_t)h0 * d * IT;
      int pg = t_begin / p.page;
      int entry = row[pg];
      int next = (pg + 1) * p.page < t_end ? row[pg + 1] : 0;
      for (int j = 0; j < n_items; ++j) {
        const int s = j % p.stages;
        const int tok = t_begin + j * p.tpc;
        if (tok / p.page != pg) {           // the next page: its entry, and a read ahead
          ++pg;
          entry = next;
          next = (pg + 1) * p.page < t_end ? row[pg + 1] : 0;
        }
        if (j >= p.stages)
          hopper::mbar_wait(hopper::smem_u32(&empty[s]), ((j / p.stages) - 1) & 1);
        const bool null = entry < 0 || entry >= p.total;
        null_s[s] = null;
        const uint32_t bar = hopper::smem_u32(&full[s]);
        if (null) {
          hopper::mbar_arrive(bar);
          continue;
        }
        const size_t src = ((size_t)b * p.slot_pages + entry) * p.page + tok % p.page;
        const uint32_t kd = hopper::smem_u32(ring + (size_t)s * 2 * stage_bytes);
        const uint32_t vd = kd + (uint32_t)stage_bytes;
        hopper::mbar_arrive_expect_tx(bar, 2 * p.tpc * p.run_bytes);
        for (int t = 0; t < p.tpc; ++t) {
          hopper::bulk_load(kd + t * p.tok_stride, kbase + (src + t) * tok_bytes, p.run_bytes, bar);
          hopper::bulk_load(vd + t * p.tok_stride, vbase + (src + t) * tok_bytes, p.run_bytes, bar);
        }
      }
    }
  } else if (active) {
    // ---- consumers: the warps of head hl take its stages in turn
    const T* qrow = static_cast<const T*>(p.q) +
                    ((size_t)b * p.hq + (size_t)(h0 + hl) * p.g + g0) * d;
    const float sl = p.scale * kLog2e;
    if constexpr (kD > 0) {
      st.init(qrow, gcount, lane);
    } else {
      st.init(p, qrow, gcount, lane % p.gs);
    }
    for (int i = sub; i < n_items; i += p.wph) {
      const int s = i % p.stages;
      hopper::mbar_wait(hopper::smem_u32(&full[s]), (i / p.stages) & 1);
      const bool null = null_s[s];
      const int tcount = min(p.tpc, t_end - (t_begin + i * p.tpc));
      const unsigned char* ks = ring + (size_t)s * 2 * stage_bytes + hl * d * IT;
      const unsigned char* vs = ks + stage_bytes;
      if constexpr (kD > 0) {
        st.stage(p, ks, vs, tcount, null, lane, sl);
      } else {
        st.stage(p, ks, vs, tcount, null, lane / p.gs, lane % p.gs, sl);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(hopper::smem_u32(&empty[s]));
    }
  }
  // Every issued copy has landed and been read: the ring is free.
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);     // [warp][8][d + 2]
  if (active) st.dump(p, red + (size_t)warp * 8 * (d + 2), lane);
  __syncthreads();

  // Merge the warps of each head; write the output (one split) or this
  // split's partial.
  float* part_acc = p.part;
  float* part_ml = p.part + (size_t)gridDim.y * p.hq * p.n_split * d;
  const int d2 = d + 2;
  if (p.n_split == 1 || n_items > 0) {
    for (int e = tid; e < p.hg * gcount * d; e += kThreads) {
      const int c = e % d, k = e / d;
      const int gg = k % gcount, h = k / gcount;
      const float* r = red + ((size_t)h * p.wph * 8 + gg) * d2;
      float mx = -INFINITY;
      for (int w = 0; w < p.wph; ++w) mx = fmaxf(mx, r[(size_t)w * 8 * d2 + d]);
      float ls = 0.f, a = 0.f;
      for (int w = 0; w < p.wph; ++w) {
        const float* rw = r + (size_t)w * 8 * d2;
        const float f = rw[d] == -INFINITY ? 0.f : ex2(rw[d] - mx);
        ls += f * rw[d + 1];
        a += f * rw[c];
      }
      const size_t qh = (size_t)(h0 + h) * p.g + g0 + gg;
      if (p.n_split == 1) {
        store_out<T>(p, ((size_t)b * p.hq + qh) * d + c, a / fmaxf(ls, 1e-20f));
        if (p.lse != nullptr && c == 0)
          p.lse[(size_t)b * p.hq + qh] = ls > 0.f ? (mx + log2f(ls)) * kLn2 : -INFINITY;
      } else {
        const size_t slot = ((size_t)b * p.hq + qh) * p.n_split + split;
        part_acc[slot * d + c] = a;
        if (c == 0) {
          part_ml[slot * 2] = mx;
          part_ml[slot * 2 + 1] = ls;
        }
      }
    }
  }
  if (p.n_split == 1) return;

  // The last CTA of this (row, head group) merges the splits.
  __threadfence();
  __syncthreads();
  int* counter = p.counters + (size_t)b * gridDim.z + z;
  if (tid == 0) *last_s = atomicAdd(counter, 1) == p.n_split - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // Every head of the group at once: the splits' (m, l) into shared memory
  // (one round of loads), the weights exp2(m - M) / L there, then one pass
  // over the partials with sixteen loads in flight a thread.
  const int n_used = pps > 0 ? (n_valid + pps - 1) / pps : 0;   // splits with pages
  const int heads = p.hg * gcount, nv4 = d / 4;
  auto qhead = [&](int k) { return (size_t)(h0 + k / gcount) * p.g + g0 + k % gcount; };
  float* wsm = reinterpret_cast<float*>(ring);       // [heads][n_used]: m, then the weight
  float* lsm = wsm + (size_t)heads * n_used;         // [heads][n_used]: l
  const float2* ml2 = reinterpret_cast<const float2*>(part_ml);
  for (int i = tid; i < heads * n_used; i += kThreads) {
    const int k = i / n_used;
    const float2 v = __ldcg(ml2 + ((size_t)b * p.hq + qhead(k)) * p.n_split + i - k * n_used);
    wsm[i] = v.x;
    lsm[i] = v.y;
  }
  __syncthreads();
  for (int k = warp; k < heads; k += kThreads / 32) {
    float* w = wsm + (size_t)k * n_used;
    const float* l = lsm + (size_t)k * n_used;
    float mx = -INFINITY;
    for (int s = lane; s < n_used; s += 32) mx = fmaxf(mx, w[s]);
    mx = warp_max(mx);
    const float ms = mx == -INFINITY ? 0.f : mx;
    float ls = 0.f;
    for (int s = lane; s < n_used; s += 32) ls += l[s] * ex2(w[s] - ms);
    ls = warp_sum(ls);
    const float inv = 1.f / fmaxf(ls, 1e-20f);
    if (p.lse != nullptr && lane == 0)
      p.lse[(size_t)b * p.hq + qhead(k)] = ls > 0.f ? (ms + log2f(ls)) * kLn2 : -INFINITY;
    __syncwarp();
    for (int s = lane; s < n_used; s += 32) w[s] = ex2(w[s] - ms) * inv;
  }
  __syncthreads();
  for (int i = tid; i < heads * nv4; i += kThreads) {
    const int k = i / nv4, c = i - k * nv4;
    const size_t qh = qhead(k);
    const float4* pa = reinterpret_cast<const float4*>(
        part_acc + ((size_t)b * p.hq + qh) * p.n_split * d) + c;
    const float* w = wsm + (size_t)k * n_used;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_used; s0 += 16) {
      float4 a[16];
#pragma unroll
      for (int x = 0; x < 16; ++x)
        a[x] = s0 + x < n_used ? __ldcg(pa + (size_t)(s0 + x) * nv4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float wx = s0 + x < n_used ? w[s0 + x] : 0.f;
        o.x = fmaf(wx, a[x].x, o.x);
        o.y = fmaf(wx, a[x].y, o.y);
        o.z = fmaf(wx, a[x].z, o.z);
        o.w = fmaf(wx, a[x].w, o.w);
      }
    }
    const size_t dst = ((size_t)b * p.hq + qh) * d + 4 * c;
    store_out<T>(p, dst, o.x);
    store_out<T>(p, dst + 1, o.y);
    store_out<T>(p, dst + 2, o.z);
    store_out<T>(p, dst + 3, o.w);
  }
  if (tid == 0) *counter = 0;               // ready for the next call
}

constexpr int kMaxDevices = 64;

template <typename T, int kG, int kNV, int kD, bool kCap>
int launch(const Params& p, int b, int n_z, size_t smem, cudaStream_t stream) {
  // The shared-memory ceiling is raised once per device, not per call.
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(paged_decode_ring_kernel<T, kG, kNV, kD, kCap>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  dim3 grid(p.n_split, b, n_z);
  paged_decode_ring_kernel<T, kG, kNV, kD, kCap><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int kNV, bool kCap>
int launch_simt(const Params& p, int b, int n_z, size_t smem, cudaStream_t s) {
  if (p.gq <= 1) return launch<T, 1, kNV, 0, kCap>(p, b, n_z, smem, s);
  if (p.gq <= 2) return launch<T, 2, kNV, 0, kCap>(p, b, n_z, smem, s);
  if (p.gq <= 4) return launch<T, 4, kNV, 0, kCap>(p, b, n_z, smem, s);
  return launch<T, 8, kNV, 0, kCap>(p, b, n_z, smem, s);
}

template <bool kCap>
int launch_cap(const Params& p, int dtype, int b, int n_z, size_t smem, cudaStream_t s) {
  if (dtype == 0)
    return p.lpr <= 32 ? launch_simt<float, 1, kCap>(p, b, n_z, smem, s)
                       : launch_simt<float, 2, kCap>(p, b, n_z, smem, s);
  using bf = __nv_bfloat16;
  switch (p.d) {             // the tensor-core path
    case 16: return launch<bf, 8, 1, 16, kCap>(p, b, n_z, smem, s);
    case 32: return launch<bf, 8, 1, 32, kCap>(p, b, n_z, smem, s);
    case 64: return launch<bf, 8, 1, 64, kCap>(p, b, n_z, smem, s);
    case 128: return launch<bf, 8, 1, 128, kCap>(p, b, n_z, smem, s);
    case 256: return launch<bf, 8, 1, 256, kCap>(p, b, n_z, smem, s);
    default: return launch_simt<bf, 1, kCap>(p, b, n_z, smem, s);
  }
}

// Both layouts, with slot_pages as above. hg (KV heads a CTA, a divisor of
// hkv, at most 8), gq (query heads a KV head a CTA, at most 8), tpc (tokens
// a copy, a divisor of page) and n_split come from the wrapper. Returns
// the cudaError_t of the launch (0 = success), or cudaErrorInvalidValue
// for inputs the kernel does not take.
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* table,
             const void* lengths, void* part, void* counters, void* out, void* lse, int dtype,
             int b, int hkv, int g, int d, int total, int slot_pages, int page,
             int n_table, int hg, int gq, int tpc, int n_split, float scale,
             float softcap, void* stream) {
  if (b == 0) return 0;
  const int it = dtype == 0 ? 4 : (dtype == 1 ? 2 : 0);
  const int row_bytes = d * it;            // one head's K row
  if (it == 0 || row_bytes <= 0 || row_bytes % 16 != 0 || row_bytes > 64 * 16 ||
      (dtype == 1 && row_bytes > 32 * 16) || hg < 1 || hg > kConsumers || hkv % hg != 0 ||
      gq < 1 || gq > 8 || g < 1 || tpc < 1 || page % tpc != 0 || n_split < 1 ||
      (reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pool = static_cast<const unsigned char*>(k_pool);
  p.v_pool = static_cast<const unsigned char*>(v_pool);
  p.table = static_cast<const int32_t*>(table);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.hq = hkv * g;
  p.hkv = hkv;
  p.g = g;
  p.d = d;
  p.total = total;
  p.slot_pages = slot_pages;
  p.page = page;
  p.n_table = n_table;
  p.n_split = n_split;
  p.hg = hg;
  p.gq = gq;
  p.n_qg = (g + gq - 1) / gq;
  p.tpc = tpc;
  p.run_bytes = hg * row_bytes;
  // Rows of one head sit an odd number of 16-byte units apart: ldmatrix's
  // eight rows (and a quarter-warp's) then fall in distinct banks.
  p.tok_stride = p.run_bytes + ((p.run_bytes / 16) % 2 == 0 ? 16 : 0);
  int stages = kRingBytes / (2 * tpc * p.run_bytes);
  stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
  // The warps of a head take its stages in turn: a multiple of them.
  p.wph = kConsumers / hg < stages ? kConsumers / hg : stages;
  p.stages = stages - stages % p.wph;
  p.lpr = row_bytes / 16;
  p.gs = 1;
  while (p.gs < p.lpr && p.gs < 32) p.gs <<= 1;
  p.scale = scale;
  p.softcap = softcap;
  const int n_z = (hkv / hg) * p.n_qg;
  const size_t ring = (size_t)p.stages * 2 * tpc * p.tok_stride;
  const size_t red = (size_t)kConsumers * 8 * (d + 2) * sizeof(float);
  const size_t merge = n_split > 1 ? (size_t)hg * (g < gq ? g : gq) * n_split * 2 * sizeof(float) : 0;
  size_t smem = ring > red ? ring : red;
  smem = kHeader + (smem > merge ? smem : merge);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return softcap > 0.f ? launch_cap<true>(p, dtype, b, n_z, smem, s)
                       : launch_cap<false>(p, dtype, b, n_z, smem, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means no softcap. part is
// fp32 scratch of b * hkv * g * n_split * (d + 2) floats; counters are
// b * (hkv / hg) * ceil(g / gq) ints, zero before the call and after it.
// lse is null, or (b, hkv * g) fp32 that receives each row's log-sum-exp;
// with it, out is fp32 (b, hkv * g, d), else in the dtype of q.
// Global layout: pools (total, page, hkv, d), table (b, n_table).
extern "C" int paged_attention_global_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* part, void* counters, void* out, void* lse, int dtype, int b,
    int hkv, int g, int d, int total, int page, int n_table, int hg, int gq, int tpc,
    int n_split, float scale, float softcap, void* stream) {
  return dispatch(q, k_pool, v_pool, table, lengths, part, counters, out, lse, dtype, b, hkv,
                  g, d, total, 0, page, n_table, hg, gq, tpc, n_split, scale, softcap,
                  stream);
}

// Per-slot layout: pools (b, n_pages, page, hkv, d), table (b, n_pages).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* part, void* counters, void* out, void* lse, int dtype, int b,
    int hkv, int g, int d, int n_pages, int page, int hg, int gq, int tpc, int n_split,
    float scale, float softcap, void* stream) {
  return dispatch(q, k_pool, v_pool, table, lengths, part, counters, out, lse, dtype, b, hkv,
                  g, d, n_pages, n_pages, page, n_pages, hg, gq, tpc, n_split, scale,
                  softcap, stream);
}
