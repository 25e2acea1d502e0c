// The per-lane tANS decode of B1 (pl_decode.cu), templated on the format of
// a decode-table entry: B1 instantiates FlatFormat, the layout kernel B4/B5
// (pl_decode_layout.cu) all five formats, so that the layout harness
// measures table layouts on the kernel that ships.
//
// Block b, lane i decodes the reference-format single-stream FSE payload
// held in column i of words[b] (bit j of the stream is bit j & 31 of word
// j >> 5). The cursor starts at size - L, the initial state is the top L
// bits; each of R rounds looks up (sym, nb, base) = table[state], moves the
// cursor down by nb, sets state = base + bits[c, c + nb) and writes sym. The
// lane's final symbol is table[state].sym, and its final cursor is written
// out: a lane that does not end at exactly 0 marks a corrupt stream.
//
// The design: one thread per lane, T lanes of one block a CTA (T picked by
// the wrapper, ops/pl_coder.py lane_config), the block's table in dynamic
// shared memory in the format's layout. The chain of a round is: one shared
// load of the entry, nb, the cursor, one 64-bit funnel shift of the bit
// buffer, a mask, an add and a mask; the state is kept as the entry's byte
// offset (state << SH, SH = log2 of the format's bytes a lookup). A format
// turns the loaded entry into (next, nb, sym), `next` holding base << SH in
// the bits the state's mask keeps. Everything else is off the chain:
//   - the bit buffer holds 64 stream bits with at least TH of them below the
//     cursor before every group of RF rounds (RF = 2 while two rounds take
//     at most 20 bits, L <= 10), so no read waits for a refill; the refill,
//     predicated and without a branch, runs after the group;
//   - a lane's next words come from a ring of 32 word slots in shared
//     memory that cp.async tops up once a tile of 32 rounds, to 2(L+1) rows
//     below the cursor: every row the tile can take in landed a tile
//     earlier;
//   - the symbols go into a shared tile of 32 rounds x T lanes (double
//     buffered, one barrier a tile) and leave it as 16-byte stores of whole
//     rows, not one byte a round;
//   - index math in the loop is 32-bit; the ring slot is a masked byte
//     offset.
//
// Rows outside [0, W) read as zero, as the JAX kernel's _fetch_chunk makes
// them: on a corrupt stream the cursor goes negative and no load leaves the
// words array. States are masked to L bits, so no lookup leaves the table.
// Entries must come from a decode table as build_decode_tables makes it
// (nb <= L); any entry keeps every access inside the arrays.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_launch.cuh"

namespace ect_lane {
// each source that includes this header gets its own kernels
namespace {

constexpr int kRows = 32;  // rounds per staged output tile
constexpr int kRing = 32;  // word slots a lane keeps: its rows mod 32

// A format says how a block's table lies in shared memory and what a round
// takes from it: `word` loads the entry of the state kept as its byte
// offset st (state << SH); `nb` is the bits to read; `next` has base << SH
// in its low L + SH bits (bits above are masked off); `sym` is the output
// byte (its low 8 bits), from the entry and the state it was loaded at.
// Each is evaluated where B1's chain needs it, so that the flat format
// compiles to B1's own code.

// Copies one block's plane of `bytes` (a multiple of 16) into shared memory.
template <int T>
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       uint32_t bytes) {
  for (uint32_t j = threadIdx.x; j < bytes / 16; j += T)
    reinterpret_cast<uint4*>(dst)[j] =
        __ldg(reinterpret_cast<const uint4*>(src) + j);
}

// flat, 4 bytes: the u32 sym << 24 | nb << 16 | base of build_decode_tables
// (plane0), re-laid as the chain wants it: base << SH in bits 0-16 (the next
// lookup's byte offset), sym in bits 20-27, nb in bits 28-31. B1's format.
struct FlatFormat {
  static constexpr int SH = 2;
  using Table = const uint32_t* __restrict__;
  static Table table(const void* plane0, const void*) {
    return static_cast<const uint32_t*>(plane0);
  }
  __host__ __device__ static uint32_t table_words(uint32_t n_tab) {
    return n_tab;
  }
  template <int T>
  __device__ static void load(uint32_t* s_tab, Table dtab, int64_t b,
                              uint32_t n_tab) {
    const uint32_t* tab_g = dtab + b * n_tab;
    for (uint32_t j = threadIdx.x; j < n_tab; j += T) {
      const uint32_t e = tab_g[j];
      s_tab[j] = ((e & 0xFFFFu) << SH) | ((e >> 24) << 20) |
                 (((e >> 16) & 0xFu) << 28);
    }
  }
  __device__ static uint32_t word(const char* s, uint32_t st) {
    return *reinterpret_cast<const uint32_t*>(s + st);
  }
  __device__ static uint32_t nb(uint32_t e, int) { return e >> 28; }
  __device__ static uint32_t next(uint32_t e, int) { return e; }
  __device__ static uint32_t sym(uint32_t e, const char*, uint32_t, int) {
    return e >> 20;
  }
};

// The u16 nb << 12 | base half-entry of split and nosym (L <= 12).
struct HalfEntry {
  static constexpr int SH = 1;
  __device__ static uint32_t word(const char* s, uint32_t st) {
    return *reinterpret_cast<const uint16_t*>(s + st);
  }
  __device__ static uint32_t nb(uint32_t h, int) { return h >> 12; }
  __device__ static uint32_t next(uint32_t h, int) {
    return (h & 0xFFFu) << SH;
  }
};

// split, 3 bytes (L <= 12): a u16 nb << 12 | base plane (plane0) and a u8
// sym plane (plane1), after it in shared memory.
struct SplitFormat : HalfEntry {
  struct Table {
    const char* half;
    const char* sym;
  };
  static Table table(const void* plane0, const void* plane1) {
    return {static_cast<const char*>(plane0), static_cast<const char*>(plane1)};
  }
  __host__ __device__ static uint32_t table_words(uint32_t n_tab) {
    return 3 * n_tab / 4;
  }
  template <int T>
  __device__ static void load(uint32_t* s_tab, Table t, int64_t b,
                              uint32_t n_tab) {
    copy16<T>(s_tab, t.half + b * 2 * n_tab, 2 * n_tab);
    copy16<T>(reinterpret_cast<char*>(s_tab) + 2 * n_tab, t.sym + b * n_tab,
              n_tab);
  }
  __device__ static uint32_t sym(uint32_t, const char* s, uint32_t st,
                                 int L) {
    return *reinterpret_cast<const uint8_t*>(s + (2u << L) + (st >> 1));
  }
};

// nosym, 2 bytes (L <= 12): the u16 nb << 12 | base plane alone, sym = its
// low byte: wrong bytes by design, the bound for any layout that still
// fetches (nb, base).
struct NosymFormat : HalfEntry {
  using Table = const char* __restrict__;
  static Table table(const void* plane0, const void*) {
    return static_cast<const char*>(plane0);
  }
  __host__ __device__ static uint32_t table_words(uint32_t n_tab) {
    return n_tab / 2;
  }
  template <int T>
  __device__ static void load(uint32_t* s_tab, Table t, int64_t b,
                              uint32_t n_tab) {
    copy16<T>(s_tab, t + b * 2 * n_tab, 2 * n_tab);
  }
  __device__ static uint32_t sym(uint32_t h, const char*, uint32_t, int) {
    return h;
  }
};

// upack, 2 bytes: u16 sym << 9 | u, u the spread-source state (u < 512):
// nb = L - ilog2(u), base = (u << nb) - 2^L.
struct UpackFormat {
  static constexpr int SH = 1;
  using Table = const char* __restrict__;
  static Table table(const void* plane0, const void*) {
    return static_cast<const char*>(plane0);
  }
  __host__ __device__ static uint32_t table_words(uint32_t n_tab) {
    return n_tab / 2;
  }
  template <int T>
  __device__ static void load(uint32_t* s_tab, Table t, int64_t b,
                              uint32_t n_tab) {
    copy16<T>(s_tab, t + b * 2 * n_tab, 2 * n_tab);
  }
  __device__ static uint32_t word(const char* s, uint32_t st) {
    return *reinterpret_cast<const uint16_t*>(s + st);
  }
  __device__ static uint32_t nb(uint32_t h, int L) {
    return (uint32_t)(L - (31 - __clz(h & 0x1FFu)));  // exact for u < 512
  }
  __device__ static uint32_t next(uint32_t h, int L) {
    const uint32_t u = h & 0x1FFu;
    return ((u << nb(h, L)) - (1u << L)) << SH;
  }
  __device__ static uint32_t sym(uint32_t h, const char*, uint32_t, int) {
    return h >> 9;
  }
};

// fused, 4 bytes: u32 sym << (L + 4) | nb << L | base.
struct FusedFormat {
  static constexpr int SH = 2;
  using Table = const char* __restrict__;
  static Table table(const void* plane0, const void*) {
    return static_cast<const char*>(plane0);
  }
  __host__ __device__ static uint32_t table_words(uint32_t n_tab) {
    return n_tab;
  }
  template <int T>
  __device__ static void load(uint32_t* s_tab, Table t, int64_t b,
                              uint32_t n_tab) {
    copy16<T>(s_tab, t + b * 4 * n_tab, 4 * n_tab);
  }
  __device__ static uint32_t word(const char* s, uint32_t st) {
    return *reinterpret_cast<const uint32_t*>(s + st);
  }
  __device__ static uint32_t nb(uint32_t v, int L) { return (v >> L) & 0xFu; }
  __device__ static uint32_t next(uint32_t v, int) { return v << SH; }
  __device__ static uint32_t sym(uint32_t v, const char*, uint32_t, int L) {
    return v >> (L + 4);
  }
};

// nb ones from bit SH (nb <= 16)
template <int SH>
__device__ __forceinline__ uint32_t bits_mask(uint32_t nb) {
  uint32_t mask;
  asm("bmsk.clamp.b32 %0, %1, %2;" : "=r"(mask) : "n"(SH), "r"(nb));
  return mask;
}

// Predicated refill: while the cursor is below TH, the word w goes below
// the buffer (hi <- lo, lo <- w), the cursor moves up 32 and the ring
// offset down one row (step bytes).
template <int TH>
__device__ __forceinline__ void refill_if(uint32_t& lo, uint32_t& hi,
                                          int& cur, uint32_t& rs, uint32_t w,
                                          uint32_t step) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.s32 p, %2, %6;\n\t"
      "@p mov.b32 %1, %0;\n\t"
      "@p mov.b32 %0, %4;\n\t"
      "@p add.s32 %2, %2, 32;\n\t"
      "@p sub.s32 %3, %3, %5;\n\t}"
      : "+r"(lo), "+r"(hi), "+r"(cur), "+r"(rs)
      : "r"(w), "r"(step), "n"(TH));
}

// RF = rounds between refill checks: 2 while two rounds take at most 20
// bits (L <= 10), else 1
template <class F, int T, int RF>
__global__ void __launch_bounds__(T)
lane_decode_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ sizes,
                   typename F::Table table,
                   uint8_t* __restrict__ syms, uint8_t* __restrict__ finals,
                   int32_t* __restrict__ cursors, int W, int k, int L, int R,
                   int b0) {
  extern __shared__ __align__(16) uint32_t s_tab[];
  constexpr int SH = F::SH;
  const int tid = threadIdx.x;
  const int64_t b = b0 + blockIdx.y;
  const int lane0 = blockIdx.x * T;
  const uint32_t n_tab = 1u << L;
  const uint32_t mask_L = n_tab - 1u;
  const uint32_t n_words = F::table_words(n_tab);  // the table's u32 words
  uint32_t* ring = s_tab + n_words + tid;  // slot s of this lane: ring[s * T]
  uint8_t* s_out = reinterpret_cast<uint8_t*>(s_tab + n_words + kRing * T);

  F::template load<T>(s_tab, table, b, n_tab);
  const char* s_tab4 = reinterpret_cast<const char*>(s_tab);

  const uint32_t* col = words + b * (int64_t)W * k + lane0 + tid;
  auto load = [&](int r) -> uint32_t {
    return (unsigned)r < (unsigned)W ? __ldg(col + r * k) : 0u;
  };
  // row r of the lane's column into its ring slot (rows outside [0, W)
  // are zero)
  auto fetch = [&](int r) {
    uint32_t* slot = ring + (r & (kRing - 1)) * T;
    if ((unsigned)r < (unsigned)W)
      cp_async4(slot, col + r * k);
    else
      *slot = 0u;
  };

  // buf holds stream bits [32 * row, 32 * row + 64); cur = cursor - 32 * row
  // - SH stays in [TH, TH + 32) before every group of RF rounds, so the
  // group's reads (RF * L <= TH bits below the cursor) never need a refill
  // first, and a read lands SH bits up. The highest bit any read touches is
  // TH + 30 + SH <= 52.
  constexpr int TH = RF == 2 ? 20 : 15;
  const int c0 = sizes[b * k + lane0 + tid] - L;
  const uint32_t mask_st = mask_L << SH;
  uint32_t st;  // the initial state, the top L bits, from c0's words, << SH
  {
    const int r0 = c0 >> 5;  // floor, also for a negative (corrupt) cursor
    const uint64_t w = (uint64_t)load(r0) | ((uint64_t)load(r0 + 1) << 32);
    st = ((uint32_t)(w >> (c0 & 31)) & mask_L) << SH;
  }
  int row = (c0 - TH - SH) >> 5;
  int cur = c0 - row * 32 - SH;
  const uint64_t buf = (uint64_t)load(row) | ((uint64_t)load(row + 1) << 32);
  __syncthreads();  // the table is in

  // A tile of kRows rounds takes in at most Q = L + 1 words (nb <= L bits a
  // round, and cur ends where it started, within 32). Before each tile the
  // ring is topped up to the 2Q rows below the cursor's row, one commit
  // group a tile, and the previous group is waited for: it holds every row
  // this tile can take in. 2Q <= 32 slots are live, so a row in flight
  // never lands on one a lane still reads.
  const int Q = L + 1;
  int fetched = row;  // the lowest row requested so far
  auto top_up = [&]() {
    for (int r = fetched - 1; r >= row - 2 * Q; --r) fetch(r);
    fetched = fetched < row - 2 * Q ? fetched : row - 2 * Q;
    cp_async_commit();
  };
  top_up();

  // the chain of a round: the entry, nb, the cursor, one funnel shift, a
  // mask, an add, a mask, the next entry. The refill's ring slot is kept as
  // rs = (row - 1) * 4T + 4 * tid mod 2^32: masked, it is the slot's byte
  // offset (no index math in the loop); row follows from how far rs moved.
  const char* ring_b = reinterpret_cast<const char*>(s_tab + n_words);
  const uint32_t ring_mask = kRing * 4u * T - 1u;
  uint32_t rs = (uint32_t)(row - 1) * (4u * T) + 4u * tid;
  uint32_t lo = (uint32_t)buf, hi = (uint32_t)(buf >> 32);
  auto step = [&](uint8_t* out) {
    const uint32_t st0 = st;
    const uint32_t e = F::word(s_tab4, st);
    const uint32_t nb = F::nb(e, L);
    cur -= (int)nb;
    const uint32_t mask = bits_mask<SH>(nb);  // nb ones from bit SH
    const uint32_t low =
        (uint32_t)((((uint64_t)hi << 32) | lo) >> cur) & mask;
    // next's low L + SH bits are base << SH: the sum is right mod 2^(L + SH)
    st = (F::next(e, L) + low) & mask_st;
    *out = (uint8_t)F::sym(e, s_tab4, st0, L);
  };
  auto refill = [&]() {  // predicated: the next word comes from the ring
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(ring_b + (rs & ring_mask));
    refill_if<TH>(lo, hi, cur, rs, w, 4u * T);
  };

  uint8_t* dst = syms + b * (int64_t)R * k + lane0;
  const int n_tiles = (R + kRows - 1) / kRows;
  uint32_t rs0 = rs;
  for (int t = 0; t < n_tiles; ++t) {
    row -= (int)((rs0 - rs) / (4u * T));  // the refills of the last tile
    rs0 = rs;
    top_up();
    cp_async_wait<1>();  // every group but the one just committed is in
    uint8_t* tile = s_out + (t & 1) * kRows * T;
    const int n = R - t * kRows < kRows ? R - t * kRows : kRows;
    if (n == kRows) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        step(tile + i * T + tid);
        if (i % RF == RF - 1) refill();
      }
    } else {
      for (int i = 0; i < n; ++i) {
        step(tile + i * T + tid);
        refill();
      }
    }
    // the tile's rounds are in; the other buffer's copy-out finished
    // before this tile began (each thread copies, then decodes the next)
    __syncthreads();
    uint8_t* out = dst + t * kRows * k;
    for (int c = tid; c < n * (T / 16); c += T) {
      const int r = c / (T / 16), q = (c % (T / 16)) * 16;
      *reinterpret_cast<uint4*>(out + r * k + q) =
          *reinterpret_cast<const uint4*>(tile + r * T + q);
    }
  }
  cp_async_wait<0>();
  row -= (int)((rs0 - rs) / (4u * T));
  finals[b * k + lane0 + tid] =
      (uint8_t)F::sym(F::word(s_tab4, st), s_tab4, st, L);
  cursors[b * k + lane0 + tid] = row * 32 + cur + SH;
}

// --- host launchers ---

// dynamic shared memory: the table (F::table_words) | u32 ring[kRing][T] |
// u8 tiles[2][kRows][T]
template <class F>
inline size_t decode_smem_bytes(int T, int L) {
  return sizeof(uint32_t) * (size_t)F::table_words(1u << L) +
         kRing * sizeof(uint32_t) * (size_t)T + 2 * kRows * (size_t)T;
}

template <class F, int T, int RF>
int decode_launch(const void* words, const void* sizes, const void* plane0,
                  const void* plane1, void* syms, void* finals, void* cursors,
                  int B, int W, int k, int L, int R, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<F>(T, L);
  cudaError_t err = set_smem(lane_decode_kernel<F, T, RF>, smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    lane_decode_kernel<F, T, RF><<<dim3(k / T, nb), T, smem, stream>>>(
        (const uint32_t*)words, (const int32_t*)sizes,
        F::table(plane0, plane1), (uint8_t*)syms, (uint8_t*)finals,
        (int32_t*)cursors, W, k, L, R, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The launch of format F with T threads (128, 256 or 512, dividing k) and a
// refill check every RF rounds (2 only for L <= 10); cudaErrorInvalidValue
// for a pick outside these.
template <class F>
int decode_launch_pick(const void* words, const void* sizes,
                       const void* plane0, const void* plane1, void* syms,
                       void* finals, void* cursors, int B, int W, int k, int L,
                       int R, int T, int RF, cudaStream_t s) {
  if (T <= 0 || k % T || (RF == 2 && L > 10)) return (int)cudaErrorInvalidValue;
#define ECT_DECODE_CASE(TT, RR)                                             \
  if (T == TT && RF == RR)                                                  \
    return decode_launch<F, TT, RR>(words, sizes, plane0, plane1, syms,     \
                                    finals, cursors, B, W, k, L, R, s);
  ECT_DECODE_CASE(512, 2) ECT_DECODE_CASE(256, 2) ECT_DECODE_CASE(128, 2)
  ECT_DECODE_CASE(512, 1) ECT_DECODE_CASE(256, 1) ECT_DECODE_CASE(128, 1)
#undef ECT_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

// Co-resident CTAs an SM of format F's kernel with T threads at table log L
// (its table, ring and tiles in shared memory, and its registers), or
// -(CUDA error).
template <class F>
int decode_occupancy(int L, int T, int RF) {
#define ECT_DECODE_OCC(TT, RR)                                              \
  if (T == TT && RF == RR) {                                                \
    const size_t smem = decode_smem_bytes<F>(TT, L);                       \
    cudaError_t err = set_smem(lane_decode_kernel<F, TT, RR>, smem);        \
    if (err != cudaSuccess) return -(int)err;                               \
    int n = 0;                                                              \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
        &n, lane_decode_kernel<F, TT, RR>, TT, smem);                       \
    return err == cudaSuccess ? n : -(int)err;                              \
  }
  ECT_DECODE_OCC(512, 2) ECT_DECODE_OCC(256, 2) ECT_DECODE_OCC(128, 2)
  ECT_DECODE_OCC(512, 1) ECT_DECODE_OCC(256, 1) ECT_DECODE_OCC(128, 1)
#undef ECT_DECODE_OCC
  return -(int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ect_lane
