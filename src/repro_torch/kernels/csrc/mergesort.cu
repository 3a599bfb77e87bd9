// Bitonic sort of a 1-D array, paper kernel #5: the block sort and the
// cross-block merge ladder, with the same pairs in the same order of levels
// and stages as the JAX network, so that the output is bit-equal to it.
//
// Replaces: src/repro/kernels/mergesort/kernel.py:block_sort (Pallas,
// pallas_call at :53) and the jnp ladder of
// src/repro/kernels/mergesort/ops.py:mergesort (_global_stage at :16 and the
// flip of the odd half-blocks at :43-48).
//
// Level k runs the stages j = k/2, k/4, .., 1. Element i sorts ascending at
// level k where (i % block) & k is 0: the alternating directions inside a
// block, all ascending on the ladder (the levels k > block), whose first
// stage reads the odd half-blocks reversed (the flip).
//
// Three launches, each by its own C function below, of two kernels:
//   block_sort   tile_kernel: one CTA per tile runs levels 2..kmax (kmax <=
//                tile) from in to out: the block sort's levels and, in a
//                full sort, the ladder's levels that fit a tile;
//   merge_stage  merge_stage_kernel: one pass over the whole array, in
//                place, that runs S <= kMaxStages consecutive stages
//                j_hi..j_lo >= tile of one level in registers;
//   merge_tile   tile_kernel: the stages j = tile/2..1 of one level k >
//                tile, a tile per CTA, in place.
//
// The tile kernel. A tile is kMaxTile = 16384 elements (256 threads of 64,
// two CTAs an SM) or, where that does not divide n, a small one of at most
// kSmallTile (threads of 2). A stage runs in registers: each thread holds
// its elements in one of three layouts ("windows", see TileNet), and a
// stride whose bit the current window lacks costs one trip of the tile
// through shared memory into a window that has it. A merge_tile is 2 such
// trips for 14 stages, and reads and writes the tile once; no stage needs a
// barrier of its own. Shared memory is padded so that each trip is free of
// bank conflicts for 4-byte elements (bf16 sees two-way ones in window 0).
// Tile size and windows are template parameters, so every register index
// and address is a constant.
//
// Global passes (merge_stage). A thread holds the 2^S 16-byte vectors at
// base + a*j_lo (a < 2^S): the closure of its pairs under the S strides,
// all >= the tile, so the lanes of a vector never meet. It runs the S
// stages in registers and writes each vector back once: at S = 4 the 78
// global stages of a sort of 2^26 take 24 passes. A ladder level's first
// pass is flipped: the thread owning column c of a 2^S-vector chunk also
// owns the mirrored column j_lo - V - c, reads each one's upper half from
// the other, lanes reversed, and writes both; it alone reads and writes
// those elements, so the pass is race-free in place.
//
// The compare. jnp.minimum / jnp.maximum as XLA computes them on an x86
// CPU, on the elements' bits: a NaN propagates to both outputs with its
// bits (where both are NaN, the "first" operand wins: for minimum b if a's
// sign bit is set, else a; for maximum the other way round), and -0.0 sorts
// before +0.0. fminf / fmaxf would drop a NaN and a < b ? a : b would order
// +-0 by argument position, so neither is used. bf16 is compared on its own
// 16 bits; int32 compares as a signed integer. Subnormals compare as their
// values (XLA's CPU code reads them as zero: the one difference from the
// JAX sort, kept deliberately). Without NaN that compare is an unsigned
// min/max of a key, the bits turned into an unsigned order (-0 just below
// +0), a bijection: equal keys are equal bits. A compare-exchange only mixes
// elements that one unit of work holds (a tile's CTA, a pass's thread), so
// each unit checks its own elements for NaN (a tile with
// __syncthreads_or): without one it converts to keys on load and back on
// store, and XORs the key of an element that sorts descending at the
// current level with all ones (which reverses the order), so that every
// exchange is one min and one max (__vminu2/__vmaxu2 on bf16 pairs in the
// passes); with one it runs the exact compare (vmin / vmax below). int32 has
// no NaN and always takes the keys. Either way the output is the network's,
// bit for bit.
//
// What bounds it on the H100: bytes. The function needs one read and one
// write of the array (at n = 2^26 fp32, 512 MiB over 3.35 TB/s is 0.16
// ms); the network, as launched here, makes one such pass per launch: 1 +
// 24 + 12 = 37 at n = 2^26 (tiles of 16384, R = 4 stages a pass), against
// 108 with tiles of 8192 and one stage per global launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int ilog2(long long v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

constexpr int kThreads = 256;        // threads of a tile CTA
constexpr int kPerThread = 64;       // E: elements a thread holds in a tile
constexpr int kTileCtas = 2;         // tile CTAs an SM holds (registers)
constexpr int kMaxTile = kThreads * kPerThread;   // TILE in ops.py
constexpr int kMaxLog = ilog2(kMaxTile);
constexpr int kSmallE = 2;           // E of a small tile, one not kMaxTile
constexpr int kSmallTile = kThreads * kSmallE;   // SMALL_TILE in ops.py
constexpr int kSmallLog = ilog2(kSmallTile);
constexpr int kPassThreads = 256;
constexpr int kMaxStages = 4;        // most stages a merge_stage pass fuses (R)
constexpr int kSmemDefault = 48 * 1024;

// Element traits. Values travel as uint32_t (bf16 in the low 16 bits);
// key() maps the bits to an unsigned order, unkey() back; a key XOR
// kKeyMask reverses that order.
struct F32 {
  using Bits = uint32_t;
  static constexpr bool kHasNan = true;
  static constexpr uint32_t kKeyMask = 0xffffffffu;
  __device__ static bool isnan(uint32_t b) { return (b & 0x7fffffffu) > 0x7f800000u; }
  __device__ static bool sign(uint32_t b) { return b >> 31; }
  // negative: all bits flipped; else the sign bit set
  __device__ static uint32_t key(uint32_t b) { return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u); }
  __device__ static uint32_t unkey(uint32_t k) { return k ^ ((uint32_t)((int32_t)~k >> 31) | 0x80000000u); }
};
struct BF16 {
  using Bits = uint16_t;
  static constexpr bool kHasNan = true;
  static constexpr uint32_t kKeyMask = 0xffffu;
  __device__ static bool isnan(uint32_t b) { return (b & 0x7fffu) > 0x7f80u; }
  __device__ static bool sign(uint32_t b) { return (b >> 15) & 1; }
  __device__ static uint32_t key(uint32_t b) { return (b & 0x8000u) ? (~b & 0xffffu) : (b | 0x8000u); }
  __device__ static uint32_t unkey(uint32_t k) { return (k & 0x8000u) ? (k & 0x7fffu) : (~k & 0xffffu); }
};
struct I32 {
  using Bits = uint32_t;
  static constexpr bool kHasNan = false;
  static constexpr uint32_t kKeyMask = 0xffffffffu;
  __device__ static bool isnan(uint32_t) { return false; }
  __device__ static bool sign(uint32_t) { return false; }
  __device__ static uint32_t key(uint32_t b) { return b ^ 0x80000000u; }
  __device__ static uint32_t unkey(uint32_t k) { return k ^ 0x80000000u; }
};

// The exact compare; the first operand decides between two NaNs.
template <class T>
__device__ __forceinline__ uint32_t vmin(uint32_t a, uint32_t b) {
  const bool b_first = T::sign(a);
  const uint32_t first = b_first ? b : a, second = b_first ? a : b;
  if (T::isnan(first)) return first;
  if (T::isnan(second)) return second;
  return T::key(b) < T::key(a) ? b : a;
}
template <class T>
__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
  const bool b_first = !T::sign(a);
  const uint32_t first = b_first ? b : a, second = b_first ? a : b;
  if (T::isnan(first)) return first;
  if (T::isnan(second)) return second;
  return T::key(b) < T::key(a) ? a : b;
}

// The pair whose lower position holds a and upper b, exactly. Each side
// takes the min or max with its own value first, as the JAX stage computes
// it: ascending (min(a, b), max(b, a)), descending (max(a, b), min(b, a)).
template <class T>
__device__ __forceinline__ void exchange(uint32_t& a, uint32_t& b, bool up) {
  const uint32_t lo = up ? vmin<T>(a, b) : vmax<T>(a, b);
  const uint32_t hi = up ? vmax<T>(b, a) : vmin<T>(b, a);
  a = lo;
  b = hi;
}

// ---- words: 4 bytes of a 16-byte vector, one fp32/int32 or two bf16 (the
// element at the lower address in the low half).

template <class T>
__host__ __device__ constexpr int per_word() { return 4 / (int)sizeof(typename T::Bits); }

template <class T>
__device__ __forceinline__ bool word_has_nan(uint32_t w) {
  if constexpr (!T::kHasNan) return false;
  else if constexpr (per_word<T>() == 1) return T::isnan(w);
  else return T::isnan(w & 0xffffu) || T::isnan(w >> 16);
}
// bf16: both halves at once; a half's sign bit spread over its low 15 bits
template <class T>
__device__ __forceinline__ uint32_t word_key(uint32_t w) {
  if constexpr (per_word<T>() == 1) return T::key(w);
  else return w ^ (((w >> 15) & 0x10001u) * 0x7fffu | 0x80008000u);
}
template <class T>
__device__ __forceinline__ uint32_t word_unkey(uint32_t w) {
  if constexpr (per_word<T>() == 1) return T::unkey(w);
  else return w ^ ((((~w) >> 15) & 0x10001u) * 0x7fffu | 0x80008000u);
}
// The word's elements in reverse order.
template <class T>
__device__ __forceinline__ uint32_t word_reverse(uint32_t w) {
  if constexpr (per_word<T>() == 1) return w;
  else return __byte_perm(w, 0, 0x1032);
}
// exchange() of each element of a against the same element of b; on keys
// ascending only, the direction being folded into the keys.
template <class T, bool KEY>
__device__ __forceinline__ void exchange_word(uint32_t& a, uint32_t& b, bool up) {
  if constexpr (KEY && per_word<T>() == 1) {
    const uint32_t mn = a < b ? a : b, mx = a < b ? b : a;
    a = mn;
    b = mx;
  } else if constexpr (KEY) {
    const uint32_t mn = __vminu2(a, b), mx = __vmaxu2(a, b);
    a = mn;
    b = mx;
  } else if constexpr (per_word<T>() == 1) {
    exchange<T>(a, b, up);
  } else {
    uint32_t a0 = a & 0xffffu, a1 = a >> 16, b0 = b & 0xffffu, b1 = b >> 16;
    exchange<T>(a0, b0, up);
    exchange<T>(a1, b1, up);
    a = a0 | a1 << 16;
    b = b0 | b1 << 16;
  }
}

// ------------------------------------------------------------ tile kernels

constexpr int kSmem = -1;   // TileNet::at when the tile is in shared memory

// Shared memory holds a tile with one pad element after every 64, so that
// a warp reading a window's register r hits 32 banks. pad() is additive
// over positions with disjoint bits.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 6); }

// A tile of 2^LT elements held by P = 2^p threads of E = 2^e elements
// each, in registers in the layout of window c: register r of thread th
// holds position (th_hi << (c + e)) | (r << c) | th_lo, th_lo the low c
// bits of th. A stage at stride 2^b runs in registers in the window that
// holds bit b: c = e * (b / e) where that is below p, else c = p (layout
// A; 0 is layout B); moving between windows is one trip through shared
// memory.
// Tile and windows are compile-time: in window c a position is the
// thread's part ORed with the immediate r << c, and so is its padded
// address. Runs the stages on keys (KEY) or on the bits.
template <class T, int E, int LT, bool KEY>
struct TileNet {
  using B = typename T::Bits;
  static constexpr int e = ilog2(E), p = LT - e;
  B* s;                  // the tile in shared memory, padded
  int th;
  int at;                // the window the elements are in, or kSmem
  bool up_tile;          // the level's direction: ascending where up_tile
  int dm;                //   and position & dm is 0
  bool key_up = true;    // KEY: the direction folded into the keys (a
  int key_dm = 0;        //   descending element's key XOR kKeyMask)
  uint32_t v[E];

  __host__ __device__ static constexpr bool is_window(int c) { return c == p || c % e == 0; }
  // The window below window C, and the highest stride bit C runs.
  __host__ __device__ static constexpr int below(int c) { return c == p ? e * ((p - 1) / e) : c - e; }
  __host__ __device__ static constexpr int top_bit(int c) { return c == p ? LT - 1 : (c + e < p ? c + e : p) - 1; }
  // The thread's bits of a position in window C.
  template <int C>
  __device__ int thread_part() const {
    return ((th >> C) << (C + e)) | (th & ((1 << C) - 1));
  }
  // Direction of level k in the tile at `base`: (base + i) & dmask == 0.
  __device__ void level(long long base, long long dmask) {
    up_tile = (base & dmask) == 0;
    dm = (int)(dmask & ((1LL << LT) - 1));
  }
  // Whether register r in window C descends under the direction (up, m):
  // bit m of its position is either the thread's (tp) or r's.
  template <int C>
  __device__ static bool down_in(bool up, int m, int tp, int r) {
    return !up || (tp & m) || (r & ((m >> C) & (E - 1)));
  }

  // The pair at positions of registers ra (a) and ra + M (b) of window C.
  // On keys whose direction is folded in every pair is ascending.
  template <int C>
  __device__ void cx(uint32_t& a, uint32_t& b, int tp, int ra) const {
    if constexpr (KEY) {
      const uint32_t mn = a < b ? a : b, mx = a < b ? b : a;
      a = mn;
      b = mx;
    } else {
      exchange<T>(a, b, !down_in<C>(up_tile, dm, tp, ra));
    }
  }
  // KEY: fold the current level's direction into the keys in place of the
  // one folded in now; the elements are in registers.
  template <int C = p>
  __device__ void redirect() {
    if (C == p && (key_dm | dm) == 0) {    // one direction for the whole tile
      const uint32_t x = key_up == up_tile ? 0u : T::kKeyMask;
#pragma unroll
      for (int r = 0; r < E; ++r) v[r] ^= x;
      key_up = up_tile;
      return;
    }
    if constexpr (is_window(C)) {
      if (at == C) {
        const int tp = thread_part<C>();
#pragma unroll
        for (int r = 0; r < E; ++r)
          if (down_in<C>(key_up, key_dm, tp, r) != down_in<C>(up_tile, dm, tp, r))
            v[r] ^= T::kKeyMask;
        key_up = up_tile;
        key_dm = dm;
        return;
      }
    }
    if constexpr (C > 0) redirect<C - 1>();
  }
  // The registers of window `at` to shared memory.
  template <int C = p>
  __device__ void store_window() {
    if constexpr (is_window(C)) {
      if (at == C) {
        B* q = s + pad(thread_part<C>());
#pragma unroll
        for (int r = 0; r < E; ++r) q[pad(r << C)] = (B)v[r];
        return;
      }
    }
    if constexpr (C > 0) store_window<C - 1>();
  }
  __device__ void to_smem() {
    if (at == kSmem) return;
    __syncthreads();
    store_window();
    at = kSmem;
  }
  template <int C>
  __device__ void to_regs() {
    if (at == C) return;
    to_smem();
    __syncthreads();
    at = C;
    const B* q = s + pad(thread_part<C>());
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = q[pad(r << C)];
  }
  // The stages at strides 2^min(top, Bt) .. 2^C, in registers in window C.
  template <int C, int Bt = top_bit(C)>
  __device__ void window_stages(int top) {
    if (Bt <= top) {
      constexpr int M = 1 << (Bt - C);
      const int tp = thread_part<C>();
#pragma unroll
      for (int r = 0; r < E; ++r)
        if (!(r & M)) cx<C>(v[r], v[r | M], tp, r);
    }
    if constexpr (Bt > C) window_stages<C, Bt - 1>(top);
  }
  // The stages at strides 2^top .. 1, window by window from the top.
  template <int C = p>
  __device__ void stages(int top) {
    if (top >= C) {
      to_regs<C>();
      window_stages<C>(top);
    }
    if constexpr (C > 0) stages<below(C)>(top);
  }
  // Reverse the upper half (h >= 2 elements) of every 2h-block of the tile.
  __device__ void flip(int h) {
    if constexpr (LT >= 2) {
      to_smem();
      __syncthreads();
      const int hq = h >> 1;
      for (int u = th; u < (1 << (LT - 2)); u += (1 << p)) {
        const int i = ((u & ~(hq - 1)) << 2) + h + (u & (hq - 1));
        const int m = i ^ (h - 1);
        const B a = s[pad(i)];
        s[pad(i)] = s[pad(m)];
        s[pad(m)] = a;
      }
    }
  }
};

// E consecutive elements of x from index i, as 16-byte vectors where they
// fill whole ones.
template <class T, int E>
__device__ __forceinline__ void load_run(const typename T::Bits* x, long long i, uint32_t (&v)[E]) {
  using B = typename T::Bits;
  if constexpr (E * sizeof(B) % 16 == 0) {
    constexpr int W = per_word<T>();
    const uint4* q = reinterpret_cast<const uint4*>(x + i);
#pragma unroll
    for (int c = 0; c < E * (int)sizeof(B) / 16; ++c) {
      const uint4 u = q[c];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4 * W; ++k)
        v[c * 4 * W + k] = W == 1 ? w[k] : (w[k / W] >> (16 * (k % W))) & 0xffffu;
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = x[i + r];
  }
}
template <class T, int E>
__device__ __forceinline__ void store_run(typename T::Bits* x, long long i, const uint32_t (&v)[E]) {
  using B = typename T::Bits;
  if constexpr (E * sizeof(B) % 16 == 0) {
    constexpr int W = per_word<T>();
    uint4* q = reinterpret_cast<uint4*>(x + i);
#pragma unroll
    for (int c = 0; c < E * (int)sizeof(B) / 16; ++c) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = W == 1 ? v[c * 4 + k] : (v[c * 8 + 2 * k] | v[c * 8 + 2 * k + 1] << 16);
      q[c] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) x[i + r] = (B)v[r];
  }
}

// Levels lk_first..lk_last (log2 k) of the network on the tile at `base`,
// whose elements are in registers in window `at`, then the tile to out.
template <class T, int E, int LT, bool KEY>
__device__ __forceinline__ void tile_network(typename T::Bits* s,
                                             typename T::Bits* __restrict__ out,
                                             uint32_t (&v)[E], int at, long long base,
                                             int lk_first, int lk_last, long long block) {
  TileNet<T, E, LT, KEY> net;
  net.s = s;
  net.th = threadIdx.x;
  net.at = at;
#pragma unroll
  for (int r = 0; r < E; ++r) net.v[r] = KEY ? T::key(v[r]) : v[r];
  for (int lk = lk_first; lk <= lk_last; ++lk) {
    const long long k = 1LL << lk;
    net.level(base, (block - 1) & k);
    if constexpr (KEY) net.redirect();
    const int top = (lk < LT ? lk : LT) - 1;
    if (k > block && lk <= LT && top >= 1) net.flip((int)(k >> 1));
    net.stages(top);
  }
  net.template to_regs<0>();
  if constexpr (KEY) {
    net.level(base, 0);
    net.redirect();
  }
#pragma unroll
  for (int r = 0; r < E; ++r) net.v[r] = KEY ? T::unkey(net.v[r]) : net.v[r];
  store_run<T, E>(out, base + ((long long)net.th << ilog2(E)), net.v);
}

// Levels lk_first..lk_last of the network, one tile per CTA, from in to
// out (the same array for a tile merge): load (in window 0 for the block
// sort, whose first stage is at stride 1; in layout A for a tile merge,
// whose first is at stride 2^(LT-1)), the NaN vote, then the network on
// keys or on the bits. block_sort and merge_tile both launch it.
template <class T, int E, int LT>
__global__ void __launch_bounds__(kThreads, kTileCtas)
tile_kernel(const typename T::Bits* in, typename T::Bits* out, int lk_first, int lk_last,
            long long block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using B = typename T::Bits;
  B* s = reinterpret_cast<B*>(smem_raw);
  constexpr int e = ilog2(E), p = LT - e;
  const int th = threadIdx.x;
  const long long base = (long long)blockIdx.x << LT;
  const int at = lk_first == 1 ? 0 : p;
  uint32_t v[E];
  if (at == 0) {
    load_run<T, E>(in, base + ((long long)th << e), v);
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = in[base + ((long long)r << p) + th];
  }
  bool nan = false;
  if constexpr (T::kHasNan) {
#pragma unroll
    for (int r = 0; r < E; ++r) nan |= T::isnan(v[r]);
  }
  if (__syncthreads_or(nan))
    tile_network<T, E, LT, false>(s, out, v, at, base, lk_first, lk_last, block);
  else
    tile_network<T, E, LT, true>(s, out, v, at, base, lk_first, lk_last, block);
}

// ------------------------------------------------------------ global pass

// The S stages of a pass on the C columns of vectors a thread holds.
template <class T, int S, int C, bool KEY>
__device__ __forceinline__ void pass_stages(uint32_t (&y)[C][1 << S][4], bool up) {
#pragma unroll
  for (int st = S - 1; st >= 0; --st)
#pragma unroll
    for (int col = 0; col < C; ++col)
#pragma unroll
      for (int a = 0; a < (1 << S); ++a)
        if (!(a & (1 << st)))
#pragma unroll
          for (int k = 0; k < 4; ++k)
            exchange_word<T, KEY>(y[col][a][k], y[col][a | (1 << st)][k], up);
}

// Stages j_lo*2^(S-1) .. j_lo of level k over the whole array, in place.
// Units are 16-byte vectors of V elements: jv = j_lo / V, nvec = n / V.
// FLIP: the first of the S stages is the level's flipped stage k/2.
template <class T, int S, bool FLIP>
__global__ void __launch_bounds__(kPassThreads)
merge_stage_kernel(uint4* __restrict__ x, long long nvec, long long jv, long long dmask) {
  constexpr int A = 1 << S, C = FLIP ? 2 : 1, H = A / 2;
  constexpr int V = 16 / (int)sizeof(typename T::Bits);
  const long long t = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (t >= nvec / (A * C)) return;
  // thread t: column c of chunk `chunk` (a chunk is A*jv vectors); FLIP
  // takes the columns c < jv/2 and the mirrored jv-1-c with each
  const long long cols = jv / C;
  const long long chunk = t / cols, c = t % cols;
  long long at[C];
  at[0] = chunk * A * jv + c;
  if (FLIP) at[C - 1] = chunk * A * jv + (jv - 1 - c);
  uint32_t w[C][A][4];
  bool nan = false;
#pragma unroll
  for (int col = 0; col < C; ++col) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const uint4 u = x[at[col] + a * jv];
      w[col][a][0] = u.x;
      w[col][a][1] = u.y;
      w[col][a][2] = u.z;
      w[col][a][3] = u.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) nan |= word_has_nan<T>(w[col][a][k]);
    }
  }
  uint32_t y[C][A][4];
#pragma unroll
  for (int col = 0; col < C; ++col) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // the flip: the upper half of a column is the other column's
        // upper half, vectors and lanes in reverse order
        y[col][a][k] = (FLIP && a >= H) ? word_reverse<T>(w[C - 1 - col][3 * H - 1 - a][3 - k])
                                        : w[col][a][k];
      }
    }
  }
  const bool up = ((at[0] * V) & dmask) == 0;
  const uint32_t down = up ? 0u : 0xffffffffu;   // reverses every key's order
  if (nan) {
    pass_stages<T, S, C, false>(y, up);
  } else {
#pragma unroll
    for (int col = 0; col < C; ++col)
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) y[col][a][k] = word_key<T>(y[col][a][k]) ^ down;
    pass_stages<T, S, C, true>(y, up);
#pragma unroll
    for (int col = 0; col < C; ++col)
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) y[col][a][k] = word_unkey<T>(y[col][a][k] ^ down);
  }
#pragma unroll
  for (int col = 0; col < C; ++col)
#pragma unroll
    for (int a = 0; a < A; ++a)
      x[at[col] + a * jv] = make_uint4(y[col][a][0], y[col][a][1], y[col][a][2], y[col][a][3]);
}

// ------------------------------------------------------------ launches

bool pow2(long long v) { return v >= 1 && (v & (v - 1)) == 0; }
bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }
bool tile_ok(long long tile) { return tile == kMaxTile || (pow2(tile) && tile >= 2 && tile <= kSmallTile); }

// Allow the tile's dynamic shared memory above the 48 KB default.
template <class K>
int smem_fits(K kernel, size_t bytes) {
  if (bytes <= (size_t)kSmemDefault) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Launch tile_kernel for a tile of 2^t elements: the full tile at
// kPerThread elements a thread, or a small one (2^t <= kSmallTile) at
// kSmallE. Returns cudaErrorInvalidValue for any other tile.
template <class T, int LT = kSmallLog>
int tile_launch(int t, unsigned grid, cudaStream_t s, const void* in, void* out, int lk_first,
                int lk_last, long long block) {
  using B = typename T::Bits;
  if (t == kMaxLog) {
    const size_t bytes = (size_t)pad(kMaxTile) * sizeof(B);
    if (int err = smem_fits(tile_kernel<T, kPerThread, kMaxLog>, bytes)) return err;
    tile_kernel<T, kPerThread, kMaxLog><<<grid, kThreads, bytes, s>>>(
        static_cast<const B*>(in), static_cast<B*>(out), lk_first, lk_last, block);
    return (int)cudaGetLastError();
  }
  if (t == LT) {
    const size_t bytes = (size_t)pad(1 << LT) * sizeof(B);
    tile_kernel<T, kSmallE, LT><<<grid, (1 << LT) / kSmallE, bytes, s>>>(
        static_cast<const B*>(in), static_cast<B*>(out), lk_first, lk_last, block);
    return (int)cudaGetLastError();
  }
  if constexpr (LT > 1) return tile_launch<T, LT - 1>(t, grid, s, in, out, lk_first, lk_last,
                                                      block);
  return (int)cudaErrorInvalidValue;
}

template <class T>
int block_sort(const void* in, void* out, long long n, int tile, int kmax, long long block,
               cudaStream_t s) {
  return tile_launch<T>(ilog2(tile), (unsigned)(n / tile), s, in, out, 1, ilog2(kmax), block);
}

template <class T>
int merge_tile(void* x, long long n, int tile, long long k, long long block, cudaStream_t s) {
  return tile_launch<T>(ilog2(tile), (unsigned)(n / tile), s, x, x, ilog2(k), ilog2(k), block);
}

template <class T, int S, bool FLIP>
int merge_pass(void* x, long long n, long long k, long long j_lo, long long block,
               cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(typename T::Bits);
  const long long threads = n / V / (FLIP ? 2 : 1) >> S;
  const long long grid = (threads + kPassThreads - 1) / kPassThreads;
  merge_stage_kernel<T, S, FLIP><<<(unsigned)grid, kPassThreads, 0, s>>>(
      static_cast<uint4*>(x), n / V, j_lo / V, (block - 1) & k);
  return (int)cudaGetLastError();
}

template <class T>
int merge_stage(void* x, long long n, long long k, long long j_lo, int stages, long long block,
                int flip, cudaStream_t s) {
  switch (stages * 2 + (flip ? 1 : 0)) {
    case 2: return merge_pass<T, 1, false>(x, n, k, j_lo, block, s);
    case 3: return merge_pass<T, 1, true>(x, n, k, j_lo, block, s);
    case 4: return merge_pass<T, 2, false>(x, n, k, j_lo, block, s);
    case 5: return merge_pass<T, 2, true>(x, n, k, j_lo, block, s);
    case 6: return merge_pass<T, 3, false>(x, n, k, j_lo, block, s);
    case 7: return merge_pass<T, 3, true>(x, n, k, j_lo, block, s);
    case 8: return merge_pass<T, 4, false>(x, n, k, j_lo, block, s);
    case 9: return merge_pass<T, 4, true>(x, n, k, j_lo, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int32. Every array is (n,) and
// contiguous; n is a multiple of tile, which is kMaxTile or a power of two
// up to kSmallTile; k and j are powers of two. Each returns the cudaError_t of its launch (0 =
// success), or cudaErrorInvalidValue for arguments it does not take.

// Levels 2..kmax (kmax <= tile) of the network with blocks of `block`
// elements (levels k > block are the ladder's, flipped), tile by tile,
// from in to out; both 16-byte aligned.
extern "C" int mergesort_block_sort_launch(const void* in, void* out, int dtype, long long n,
                                           int tile, int kmax, long long block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tile_ok(tile) || n <= 0 || n % tile || !pow2(block) ||
      !pow2(kmax) || kmax < 2 || kmax > tile || n % block || !aligned16(in) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return block_sort<F32>(in, out, n, tile, kmax, block, s);
  if (dtype == 1) return block_sort<BF16>(in, out, n, tile, kmax, block, s);
  if (dtype == 2) return block_sort<I32>(in, out, n, tile, kmax, block, s);
  return (int)cudaErrorInvalidValue;
}

// Stages j_hi..j_lo of level k over all of x, in place, in one pass of at
// most kMaxStages stages; flip only where j_hi == k/2. x 16-byte aligned,
// j_lo at least two vectors.
extern "C" int mergesort_merge_stage_launch(void* x, int dtype, long long n, long long k,
                                            long long j_hi, long long j_lo, long long block,
                                            int flip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long vec = dtype == 1 ? 8 : 4;
  if (n <= 0 || !pow2(k) || !pow2(j_hi) || !pow2(j_lo) || j_lo > j_hi || j_hi >= k || n % k ||
      j_lo < 2 * vec || !pow2(block) || (flip && j_hi != k / 2) || !aligned16(x))
    return (int)cudaErrorInvalidValue;
  const int stages = ilog2(j_hi / j_lo) + 1;
  if (stages > kMaxStages) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return merge_stage<F32>(x, n, k, j_lo, stages, block, flip, s);
  if (dtype == 1) return merge_stage<BF16>(x, n, k, j_lo, stages, block, flip, s);
  if (dtype == 2) return merge_stage<I32>(x, n, k, j_lo, stages, block, flip, s);
  return (int)cudaErrorInvalidValue;
}

// Stages tile/2..1 of level k > tile, in place, each tile on its own.
extern "C" int mergesort_merge_tile_launch(void* x, int dtype, long long n, int tile,
                                           long long k, long long block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tile_ok(tile) || n <= 0 || n % tile || !pow2(k) ||
      k <= tile || !pow2(block) || !aligned16(x))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return merge_tile<F32>(x, n, tile, k, block, s);
  if (dtype == 1) return merge_tile<BF16>(x, n, tile, k, block, s);
  if (dtype == 2) return merge_tile<I32>(x, n, tile, k, block, s);
  return (int)cudaErrorInvalidValue;
}
