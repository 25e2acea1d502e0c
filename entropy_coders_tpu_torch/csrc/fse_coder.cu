// D4 and D5: the shared-stream (MODE_FSE) k-way interleaved tANS coder, for
// Hopper (sm_90a).
//
// Replaces entropy_coders_tpu/ops/coder.py:62 _encode_core (D4) and :166
// _decode_core (D5): XLA lax.scans over R rounds, vmapped over blocks
// (entropy_coders_tpu/frame.py:55, :64). k lanes share one bitstream: in
// each round every lane codes one symbol, and an exclusive prefix sum of the
// lanes' bit counts gives each lane its bit offset. Same function, bit for
// bit, as the plain versions ops/coder.py encode_core_ref / decode_core_ref,
// on every input whose tables are built from valid counts (a decode entry's
// bit count <= 16); a table index or bit offset out of range is clamped as
// the JAX gathers clamp it, or, with an error word given (utils.checked),
// also recorded: the smallest check sequence number of the plain version's
// order that failed in the block (see ops/coder.py _check_error).
//
// One launch a call, of one of three kernels the launch rule picks by k
// (rule): D5's one-thread kernel up to 2 lanes, a one-warp kernel (each
// direction has one) up to 32, a wide one past that. One CTA a block in
// all of them; every table a block uses sits in its CTA's shared memory.
// No scratch in device memory.
//
// What bounds them on this card. Small k: a round's dependent chain (65,535
// rounds at 128 KiB blocks and k = 2; D5 a table lookup and a bit read in
// series, D4 a lookup, two shifts and two adds) and the instructions a
// round issues: a warp with few busy lanes issues in order, and ~8 such
// warps an SM share its issue slots, so D5's one-thread kernel puts up to
// kOneGroup blocks in one warp (a warp instruction then serves each).
// Large k: the bytes (the symbols once, the
// payload once) and the instructions a round issues per lane, with a
// CTA-wide scan each round.
//
// The small-k kernels (D5 fse_decode_one and fse_decode_warp, D4
// fse_encode_warp) code a tile of kOneTile slots at a time on shared
// memory alone: no load from device memory on the chain. A helper warp
// works a tile apart behind __syncthreads. D5's helper copies into a
// payload ring the words the next tile may read (the cursor falls at most
// 16 bits a slot) and stores the last tile's symbols in 16-byte chunks.
// D5 one-thread: thread g decodes both lanes of the CTA's block g, no
// scan, no shuffle, its next bits in a 64-bit window of two registers with
// a 32-bit cursor, refilled a word at a time by selects from the ring. D5
// one-warp: lane j decodes lane j; a shuffle scan of the round's bit
// counts, each lane's bits from the ring, a ballot for the failed lane. D4
// one-warp: lane j runs lane j's chain (the lanes' chains are
// independent) and writes each slot's bit count and value to a buffer;
// its helper stages the next tile's symbols as records of their
// transforms and packs the last tile's bits into the stream (a warp scan,
// words staged in shared memory, whole words out, the partial word
// carried).
//
// The wide kernels (D5 fse_decode_wide, D4 fse_encode_wide): J neighbouring
// lanes a thread, at most 128 threads (wide_lanes; more only past 8,192
// lanes), so that the 1,024 blocks of a 128 MiB launch fit the card at
// once. A round: the lanes' lookups or chain steps, one warp scan of the
// threads' bit counts, one __syncthreads, a second level over the warp sums
// read from shared memory. D5 then reads each lane's bits from a ring of
// payload words in shared memory: the cursor only falls, so the ring is
// refilled with cp.async behind it, the words a round frees copied for the
// rounds ahead, and a round reads only words whose copies the round before
// waited for (cp.async.wait_group 1 ahead of the barrier); its symbols go
// out as J-byte words. D4 ORs each thread's J slots' bits into a ring of
// staged words in shared memory (the first and last word, which it may
// share, by atomicOr: exact, as the JAX scatter-add of disjoint bit ranges
// is); after the next barrier the words a round completed go out whole and
// coalesced and their slots are zeroed for reuse. D4 loads each round's
// symbols and valid flags a round ahead. The final states wait in shared
// memory for the finals, which go through the same emission (k slots of L
// bits in finish_slots order, then the marker bit).
// A k too wide for the ring is emitted in sub-rounds of fewer threads
// (encode_sub_threads). Every kernel stores each of the W words of its
// block once, the words past the stream as zeros.
//
// Both decodes keep their fast path for what the plain version does without
// a clamp: a closed table (load_decode_table: every entry's next states in
// range, so every state the decode makes is in range) and a cursor in [0,
// 32 (Wd - 1)). A round outside that (a corrupt or truncated stream, a
// table too small, the round where the stream ends) runs the plain
// version's clamped reads from device memory, with the checks. The lanes
// that fit are a prefix of the lanes, since the prefix sums never
// decrease: when the round's total fits (every round but the last) all
// lanes move and the cursor falls by the total; otherwise the one lane
// where the prefix first passes the cursor is the failed lane (one thread
// writes it, then a barrier), the lanes before it move, and the block is
// done. A done block writes its frozen states' symbols for the rounds
// left, as the scan does; the final symbols flush cyclically from the
// failed lane, each lane writing its own to finals[(lane - failed) mod k].
//
// In every kernel the next-state and table lookups take no clamp on their
// in-range path: D5's closed table keeps its states in range, D4 masks the
// index into a table padded to a power of two and redoes the lookup
// clamped (and records the check) only when the index left the table.
// Checks are compiled only into the checked instantiations (kChecked).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_launch.cuh"

namespace {

using ect_lane::cp_async4;
using ect_lane::cp_async_commit;
using ect_lane::cp_async_wait;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWideThreads = 128;  // the wide kernels' CTA, up to 8,192 lanes
constexpr int kMaxThreads = 1024;
constexpr int kOneCta = 64;        // small-k kernels: the coder's warp, a helper
constexpr int kOneTile = 512;      // small-k kernels: slots a tile
constexpr int kOnePay = 1024;      // D5 one-thread: payload ring (words)
constexpr int kOneGroup = 4;       // D5 one-thread: the most blocks a CTA

// The kernels, by path number: 0 one-thread (D5, k <= 2), 1 wide, 2
// one-warp (k <= 32). The launch rule (measured: each kernel's time at k =
// 1 .. 1,024, PERF.md): D5 one-thread up to kDecodeOneThread lanes, then
// one-warp up to kOneWarp; D4 one-warp up to kOneWarp; wide past that.
constexpr int kDecodeOneThread = 2;
constexpr int kOneWarp = 32;

int rule(int dir, int k) {  // dir 0 decode, 1 encode
  if (dir == 0 && k <= kDecodeOneThread) return 0;
  return k <= kOneWarp ? 2 : 1;
}

// J (lanes a thread) of the wide kernels for k lanes: the smallest power
// of two that keeps the CTA within kWideThreads, up to 64 lanes a thread
// (then up to 1,024 threads).
int wide_lanes(int k) {
  int J = 1;
  while (J < 64 && (k + J - 1) / J > kWideThreads) J <<= 1;
  return J;
}

int wide_threads(int k, int J) { return ((k + J - 1) / J + 31) / 32 * 32; }

int pow2_at_least(long long n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The next-state table's slots in D4's shared memory: size rounded up to a
// power of two (the in-range lookup masks its index), at least 8 (so that
// what follows the table stays 16-byte aligned).
int encode_table_slots(int size) { return pow2_at_least(size < 8 ? 8 : size); }

// D5 one-thread's shared memory a block (bytes): the table, the payload
// ring and two symbol buffers; and its blocks a CTA: up to kOneGroup, as
// many as fit 96 KiB (one at the largest tables)
int one_thread_segment(int size) {
  return (size + 4) / 4 * 16 + 4 * kOnePay + 2 * (kOneTile + 16);
}
int one_thread_group(int size) {
  const int g = 96 * 1024 / one_thread_segment(size);
  return g < 1 ? 1 : (g > kOneGroup ? kOneGroup : g);
}

// D5 wide's payload ring (words): three rounds of k lanes at L bits each
// and a margin, at least 256, at most 16,384 words (64 KiB). A round whose
// words are not in the ring reads them from device memory.
int decode_ring_words(int k, int L) {
  const long long round_words = ((long long)k * L + 31) / 32;
  const long long want = 3 * round_words + 64;
  return pow2_at_least(want < 256 ? 256 : (want > 16384 ? 16384 : want));
}

// D4 wide's staged-word ring for sub-rounds of `sub` threads of J lanes:
// twice a sub-round's words at L + 1 bits a slot and a margin (so that the
// words a round ORs never share a slot with the words the next round stores
// and zeroes).
int encode_ring_words(int sub, int J, int L) {
  return pow2_at_least(2 * (((long long)sub * J * (L + 1) + 31) / 32) + 4);
}

// The threads a sub-round of D4 wide emits: all T unless their ring would
// pass 8,192 words (32 KiB); then fewer, a multiple of 32.
int encode_sub_threads(int T, int J, int L) {
  int sub = T;
  while (sub > 32 && encode_ring_words(sub, J, L) > 8192) sub -= 32;
  return sub;
}

__device__ __forceinline__ void record(long long* err, long long seq) {
  atomicMin(reinterpret_cast<unsigned long long*>(err),
            (unsigned long long)seq);
}

__device__ __forceinline__ uint32_t low_mask(int width) {
  return width >= 32 ? kFull : (1u << width) - 1u;
}

// `width` bits from bit `start` of a block's little-endian u32 words (Wd of
// them); as ops/coder.py _extract_bits: start clamped at 0, the word index
// at Wd - 1, and only the next word's low 16 bits read.
__device__ __forceinline__ uint32_t read_bits(const uint32_t* __restrict__ w,
                                              long long Wd, long long start,
                                              int width) {
  if (start < 0) start = 0;
  long long i = start >> 5;
  if (i > Wd - 1) i = Wd - 1;
  const long long i1 = i + 1 > Wd - 1 ? Wd - 1 : i + 1;
  const uint64_t v =
      ((uint64_t)(__ldg(w + i1) & 0xFFFFu) << 32) | __ldg(w + i);
  return (uint32_t)(v >> (start & 31)) & low_mask(width);
}

// a decode entry's bit count (sym << 24 | nb << 16 | base): its byte 2
__device__ __forceinline__ int entry_bits(uint32_t e) {
  return (int)__byte_perm(e, 0, 0x4442);
}

__device__ __forceinline__ int clamp_index(int s, int size) {
  return s < 0 ? 0 : (s >= size ? size - 1 : s);
}

// four decode entries' symbols (their top bytes) as one little-endian word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return (a >> 24) | ((b >> 16) & 0xFF00u) | ((c >> 8) & 0xFF0000u) |
         (d & 0xFF000000u);
}

// Stores the symbols of J decode entries at p (n of them belong to the
// block): one J-byte store when all do and p is aligned, else byte by byte.
template <int J>
__device__ __forceinline__ void store_syms(uint8_t* p, const uint32_t* e,
                                           int n) {
  if (n == J && ((uintptr_t)p & (J - 1)) == 0) {
    if constexpr (J == 1) {
      *p = (uint8_t)(e[0] >> 24);
    } else if constexpr (J == 2) {
      *reinterpret_cast<uint16_t*>(p) =
          (uint16_t)((e[0] >> 24) | ((e[1] >> 16) & 0xFF00u));
    } else if constexpr (J == 4) {
      *reinterpret_cast<uint32_t*>(p) = pack4(e[0], e[1], e[2], e[3]);
    } else if constexpr (J == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(
          pack4(e[0], e[1], e[2], e[3]), pack4(e[4], e[5], e[6], e[7]));
    } else {
#pragma unroll
      for (int q = 0; q < J / 16; q++) {
        const uint32_t* f = e + 16 * q;
        reinterpret_cast<uint4*>(p)[q] = make_uint4(
            pack4(f[0], f[1], f[2], f[3]), pack4(f[4], f[5], f[6], f[7]),
            pack4(f[8], f[9], f[10], f[11]),
            pack4(f[12], f[13], f[14], f[15]));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < J; j++)
      if (j < n) p[j] = (uint8_t)(e[j] >> 24);
  }
}

// Loads J bytes from p (n of them belong to the block; the rest read as 0)
// into little-endian words: one J-byte load when all do and p is aligned.
template <int J>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ p,
                                           int n, uint32_t* v) {
  if (n == J && ((uintptr_t)p & (J - 1)) == 0) {
    if constexpr (J == 1) {
      v[0] = __ldg(p);
    } else if constexpr (J == 2) {
      v[0] = __ldg(reinterpret_cast<const uint16_t*>(p));
    } else if constexpr (J == 4) {
      v[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    } else if constexpr (J == 8) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = x.x;
      v[1] = x.y;
    } else {
#pragma unroll
      for (int q = 0; q < J / 16; q++) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + q);
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < (J + 3) / 4; i++) v[i] = 0;
#pragma unroll
    for (int j = 0; j < J; j++)
      if (j < n) v[j >> 2] |= (uint32_t)__ldg(p + j) << (8 * (j & 3));
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* v, int j) {
  return (v[j >> 2] >> (8 * (j & 3))) & 0xFFu;
}

// --- D5 --------------------------------------------------------------------

// Check sequence numbers of the plain decode (ops/coder.py): 1 the
// initial bit offsets, 2 + 2r round r's table indices, 3 + 2r its bit
// offsets, 2 + 2R the final table indices.

// Copies a block's decode table (size entries) into shared memory, with a
// sentinel entry at tab[size] (next state size, no bits: a lane past k that
// holds it moves nowhere), and says whether the table is closed: size >=
// 2^L and every entry's next states base + [0, 2^nb) lie in [0, size) with
// nb <= 16. The initial states are L-bit reads, so in a closed table every
// state the decode makes is in range and every read at most 16 bits wide.
__device__ __forceinline__ bool load_decode_table(
    uint32_t* tab, const uint32_t* __restrict__ pk, int size, int L) {
  int bad = size < (1 << L);
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const uint32_t e = __ldg(pk + i);
    tab[i] = e;
    const uint32_t nb = (e >> 16) & 0xFF;
    bad |= nb > 16 || (e & 0xFFFF) + (1u << (nb & 31)) > (uint32_t)size;
  }
  if (threadIdx.x == 0) tab[size] = (uint32_t)size;
  return !__syncthreads_or(bad);
}

// A helper warp's copy into a payload ring (kOnePay words) of the words the
// tiles that start at cursor c may read: the cursor falls at most 16 bits
// a slot, so two tiles' worth below it; `staged` is the lowest word the
// ring holds, and only the words below it are copied.
__device__ __forceinline__ void stage_payload(uint32_t* pay,
                                              const uint32_t* __restrict__ w,
                                              long long Wd, long long c,
                                              int& staged, int lane) {
  if (c < 0) return;
  const long long top = (c >> 5) + 1 < Wd - 1 ? (c >> 5) + 1 : Wd - 1;
  const long long want = top - 2 * (kOneTile / 2 + 2) - 8;
  const int lo = want > 0 ? (int)want : 0;
  const int hi = staged < (int)top + 1 ? staged : (int)top + 1;
  for (int x = lo + lane; x < hi; x += 32) pay[x & (kOnePay - 1)] = __ldg(w + x);
  staged = lo < staged ? lo : staged;
}

// A helper warp's store of a tile's symbols, bytes [dst, end) of the output,
// from a buffer that holds them at their address mod 16: 16-byte chunks
// where whole, the chunks a neighbouring block shares byte by byte.
__device__ __forceinline__ void store_symbols(uint8_t* dst, uint8_t* end,
                                              const uint8_t* src, int lane) {
  uint8_t* base = dst - ((uintptr_t)dst & 15);
  const int n_chunks = (int)((end - base + 15) >> 4);
  for (int i = lane; i < n_chunks; i += 32) {
    uint8_t* q0 = base + 16 * i;
    if (q0 >= dst && q0 + 16 <= end) {
      *reinterpret_cast<uint4*>(q0) =
          *reinterpret_cast<const uint4*>(src + 16 * i);
    } else {
      for (int q = 0; q < 16; q++)
        if (q0 + q >= dst && q0 + q < end) q0[q] = src[16 * i + q];
    }
  }
}

// D5 one-thread (k <= 2): thread g < G of warp 0 decodes the K = k lanes
// of the CTA's block g (G blocks a CTA, one_thread_group: a warp then
// issues for G blocks at once, where ~8 CTAs of one busy thread an SM
// bound the SM's issue slots), a tile of TR = kOneTile / k rounds at a
// time; warp 1 keeps each block's payload words in a ring in shared memory
// and stores its symbols: while warp 0 decodes tile t into staging
// buffers, warp 1 stores tile t - 1's symbols (16-byte chunks where they
// are whole, a block's end chunks byte by byte) and copies the words tile
// t + 1 may read (from the cursor at the start of tile t, at most 16 bits
// a slot over two tiles) into the rings; a __syncthreads between tiles. A
// block's tile runs the window when it starts with a closed table and its
// cursor in [0, bits_max), else the plain version's reads. Dynamic shared
// memory: `seg` bytes a block, its table (size + 1 entries, padded to 16
// bytes), its payload ring (kOnePay words), two symbol buffers.
template <int K, bool kChecked>
__global__ void __launch_bounds__(kOneCta)
fse_decode_one(const uint32_t* __restrict__ words, long long Wd,
               const long long* __restrict__ total_bits,
               const uint32_t* __restrict__ packed, int size,
               uint8_t* __restrict__ syms, long long* __restrict__ emit_out,
               uint8_t* __restrict__ finals, uint8_t* __restrict__ done_out,
               long long* __restrict__ cursor_out, long long* err, int k,
               int L, int R, int B, int G, int seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long s_c[kOneGroup][2];  // a tile's start cursor, by parity

  constexpr int M = kOnePay - 1;
  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * G;
  const int nG = B - b0 < G ? (int)(B - b0) : G;
  auto tab_of = [&](int g) {
    return reinterpret_cast<uint32_t*>(smem_raw + g * seg);
  };
  auto pay_of = [&](int g) { return tab_of(g) + (size + 4) / 4 * 4; };
  auto sbuf_of = [&](int g) {
    return reinterpret_cast<uint8_t*>(pay_of(g) + kOnePay);
  };
  bool closed = false;  // thread g's block's table
  for (int g = 0; g < nG; g++) {
    const bool cl =
        load_decode_table(tab_of(g), packed + (b0 + g) * size, size, L);
    if (t == g) closed = cl;
  }
  const long long bits_max = 32 * (Wd - 1);
  const int TR = kOneTile / k;
  const long long n_tiles = ((long long)R + TR - 1) / TR;
  // a tile's first output byte (its address mod 16 is its offset in the
  // buffer, so that buffer and output chunks line up)
  auto tile_dst = [&](int g, long long tile) {
    return syms + (b0 + g) * R * k + tile * TR * k;
  };

  // warp 1: each block's ring and symbols
  int staged[kOneGroup];  // the lowest word in each ring
#pragma unroll
  for (int g = 0; g < kOneGroup; g++) staged[g] = INT_MAX;
  auto stage = [&](int g, long long c) {
    stage_payload(pay_of(g), words + (b0 + g) * Wd, Wd, c, staged[g],
                  t - 32);
  };
  auto store_tile = [&](int g, long long tile, int buf) {
    uint8_t* dst = tile_dst(g, tile);
    uint8_t* out_end = tile_dst(g, 0) + (long long)R * k;
    store_symbols(dst, dst + (long long)TR * k < out_end ? dst + TR * k
                                                        : out_end,
                  sbuf_of(g) + buf * (kOneTile + 16), t - 32);
  };

  // warp 0's thread g < nG: block g
  const bool mine = t < nG;
  const int g = mine ? t : 0;
  const long long b = b0 + g;
  const uint32_t* tab = tab_of(g);
  const uint32_t* pay = pay_of(g);
  uint8_t* const sbuf = sbuf_of(g);
  const uint32_t* w = words + b * Wd;
  const bool fast_ok = closed && bits_max <= INT_MAX;
  long long first_err = LLONG_MAX;
  int st[K];  // k == K
  long long c = 0, emit = 0;
  bool done = false;
  int fail = -1;
  uint32_t fsym[K];
  if (mine) {
    // decoder init, lane 0 first: lane s reads L bits at [c - (s+1)L, c - sL)
    const long long tb = total_bits[b];
#pragma unroll
    for (int j = 0; j < K; j++) {
      const long long start = tb - (long long)(j + 1) * L;
      if (kChecked && (start < 0 || start >= bits_max)) first_err = 1;
      st[j] = (int)read_bits(w, Wd, start, L);
    }
    c = tb - (long long)k * L;
    s_c[g][0] = c;
  }
  __syncthreads();
  if (t >= 32 && bits_max <= INT_MAX) {
#pragma unroll
    for (int q = 0; q < kOneGroup; q++)
      if (q < nG) stage(q, s_c[q][0]);
  }
  __syncthreads();

  // done: the frozen states' symbols, and their one lookup check
  auto freeze = [&](long long r_next) {
    done = true;
    if (kChecked) {
#pragma unroll
      for (int j = 0; j < K; j++)
        if (st[j] < 0 || st[j] >= size)
          first_err = min(first_err, 2 + 2 * r_next);
    }
#pragma unroll
    for (int j = 0; j < K; j++) fsym[j] = tab[clamp_index(st[j], size)] >> 24;
  };

  for (long long tile = 0; tile <= n_tiles; tile++) {
    if (t >= 32) {  // warp 1: the tile before's symbols, the next's words
#pragma unroll
      for (int q = 0; q < kOneGroup; q++) {
        if (q >= nG) continue;
        if (tile > 0) store_tile(q, tile - 1, (int)((tile - 1) & 1));
        if (bits_max <= INT_MAX && tile + 1 < n_tiles)
          stage(q, s_c[q][tile & 1]);
      }
    } else if (mine && tile < n_tiles) {
      const long long r0 = tile * TR;
      const int nr = (int)((long long)R - r0 < TR ? (long long)R - r0 : TR);
      uint8_t* sb = sbuf + (int)(tile & 1) * (kOneTile + 16) +
                    ((uintptr_t)tile_dst(g, tile) & 15);
      int rr = 0;
      if (!done && fast_ok && c >= 0 && c < bits_max) {
        // the window: bits [32 bi, 32 bi + 64) in (whi:wlo), the cursor o
        // bits above its bottom, the word below in nxt; o >= 32 before
        // every pair of lanes, since a refill moves the window one word
        // down when o < 32
        int cc = (int)c;
        int bi = (cc >> 5) - 1;
        uint32_t whi = pay[(bi + 1) & M];
        uint32_t wlo = bi >= 0 ? pay[bi & M] : 0u;
        uint32_t nxt = pay[(bi - 1) & M];
        int o = cc - 32 * bi;
        uint8_t* sp = sb;
        for (; rr < nr; rr++, sp += k) {
          uint32_t e[K];
          int tot = 0;
#pragma unroll
          for (int j = 0; j < K; j++) {
            e[j] = tab[st[j]];
            tot += entry_bits(e[j]);
          }
#pragma unroll
          for (int j = 0; j < K; j++) sp[j] = (uint8_t)(e[j] >> 24);
          if (tot > cc) {  // the round where the stream ends: once a block
            int run = 0, f = k, sum = 0;
#pragma unroll
            for (int j = 0; j < K; j++) {
              const int nb = entry_bits(e[j]);
              run += nb;
              if (f == k) {
                if (run <= cc)
                  st[j] = (int)(e[j] & 0xFFFF) +
                          (int)read_bits(w, Wd, cc - run, nb);
                else {
                  f = j;
                  sum = run - nb;
                }
              }
            }
            fail = f;
            emit += f;
            cc -= sum;
            freeze(r0 + rr + 1);
            break;
          }
#pragma unroll
          for (int j = 0; j < K; j++) {
            if ((j & 1) == 0) {  // refill: the word below moves in
              const bool p = o < 32;
              whi = p ? wlo : whi;
              wlo = p ? nxt : wlo;
              o += p ? 32 : 0;
              bi -= p ? 1 : 0;
              nxt = pay[(bi - 1) & M];
            }
            const int nb = entry_bits(e[j]);
            o -= nb;
            const uint64_t win = ((uint64_t)whi << 32) | wlo;
            st[j] = (int)(e[j] & 0xFFFF) +
                    (int)((uint32_t)(win >> o) & ((1u << nb) - 1u));
          }
          cc -= tot;
        }
        emit += (long long)(done ? rr : nr) * k;  // the rounds all moved in
        if (done) rr++;
        c = cc;
      }
      for (; rr < nr; rr++) {
        if (done) {
#pragma unroll
          for (int j = 0; j < K; j++) sb[rr * k + j] = (uint8_t)fsym[j];
          continue;
        }
        // the plain version's round: clamped reads from device memory
        const long long r = r0 + rr;
        uint32_t e[K];
#pragma unroll
        for (int j = 0; j < K; j++) {
          if (kChecked && (st[j] < 0 || st[j] >= size))
            first_err = min(first_err, 2 + 2 * r);
          e[j] = tab[clamp_index(st[j], size)];
          sb[rr * k + j] = (uint8_t)(e[j] >> 24);
        }
        long long run = 0, sum = 0;
        int f = k;
#pragma unroll
        for (int j = 0; j < K; j++) {
          const int nb = entry_bits(e[j]);
          run += nb;
          if (f == k) {
            if (run <= c) {
              const long long start = c - run;
              if (kChecked && start >= bits_max)
                first_err = min(first_err, 3 + 2 * r);
              st[j] = (int)(e[j] & 0xFFFF) + (int)read_bits(w, Wd, start, nb);
            } else {
              f = j;
              sum = run - nb;
            }
          }
        }
        if (f == k) {
          c -= run;
          emit += k;
        } else {  // once a block: the failed lane ends the stream
          fail = f;
          emit += f;
          c -= sum;
          freeze(r + 1);
        }
      }
      s_c[g][(tile + 1) & 1] = c;
    }
    __syncthreads();
  }

  if (mine) {
    if (!done) freeze(R);
    done = fail >= 0;
    // pending final-state symbols flush cyclically from the failed lane
#pragma unroll
    for (int j = 0; j < K; j++)
      finals[b * k + ((j - fail) % k + k) % k] = (uint8_t)fsym[j];
    emit_out[b] = emit;
    done_out[b] = done ? 1 : 0;
    cursor_out[b] = c;
    if (kChecked && first_err != LLONG_MAX) record(err + b, first_err);
  }
}

// D5 one-warp (k <= 32): lane j of warp 0 decodes lane j, a tile of TR =
// kOneTile / k rounds at a time, with a helper warp and buffers as the
// one-thread kernel's. A round: the lanes' lookups, a shuffle scan of their bit
// counts (log2 k steps), then each lane's bits from the payload ring at
// the cursor less its inclusive prefix; the round where the stream ends
// takes the first lane whose prefix passes the cursor from a ballot.
template <bool kChecked>
__global__ void __launch_bounds__(kOneCta)
fse_decode_warp(const uint32_t* __restrict__ words, long long Wd,
                const long long* __restrict__ total_bits,
                const uint32_t* __restrict__ packed, int size,
                uint8_t* __restrict__ syms, long long* __restrict__ emit_out,
                uint8_t* __restrict__ finals, uint8_t* __restrict__ done_out,
                long long* __restrict__ cursor_out, long long* err, int k,
                int L, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* pay = tab + (size + 4) / 4 * 4;
  uint8_t* sbuf = reinterpret_cast<uint8_t*>(pay + kOnePay);
  __shared__ long long s_c[2];  // the cursor at a tile's start, by parity

  constexpr int M = kOnePay - 1;
  const long long b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31;
  const bool closed = load_decode_table(tab, packed + b * size, size, L);
  const uint32_t* w = words + b * Wd;
  const long long bits_max = 32 * (Wd - 1);
  const bool fast_ok = closed && bits_max <= INT_MAX;
  const int TR = kOneTile / k;
  const long long n_tiles = ((long long)R + TR - 1) / TR;
  uint8_t* const out0 = syms + b * R * k;
  uint8_t* const out_end = out0 + (long long)R * k;
  auto tile_dst = [&](long long tile) { return out0 + tile * TR * k; };

  int staged = INT_MAX;  // warp 1: the lowest word in the ring
  auto stage = [&](long long c) {
    stage_payload(pay, w, Wd, c, staged, lane);
  };
  auto store_tile = [&](long long tile, int buf) {
    uint8_t* dst = tile_dst(tile);
    store_symbols(dst, dst + (long long)TR * k < out_end ? dst + TR * k
                                                        : out_end,
                  sbuf + buf * (kOneTile + 16), lane);
  };

  const bool mine = t < k;  // warp 0's lanes that hold a lane
  long long first_err = LLONG_MAX;
  int st = size;  // a lane past k: the sentinel
  long long c = 0, emit = 0;
  bool done = false;
  int fail = -1;
  uint32_t fsym = 0;
  if (t < 32) {
    const long long tb = total_bits[b];
    if (mine) {
      const long long start = tb - (long long)(lane + 1) * L;
      if (kChecked && (start < 0 || start >= bits_max)) first_err = 1;
      st = (int)read_bits(w, Wd, start, L);
    }
    c = tb - (long long)k * L;
    if (t == 0) s_c[0] = c;
  }
  __syncthreads();
  if (t >= 32 && fast_ok) stage(s_c[0]);
  __syncthreads();

  // the inclusive prefix of the lanes' bit counts, and the round's total
  auto scan = [&](int nb, int& tot) {
    int incl = nb;
    for (int d = 1; d < k; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    tot = __shfl_sync(kFull, incl, k - 1);
    return incl;
  };
  // the round where the stream ends: the lanes whose prefix fits moved (a
  // prefix of the lanes), the first that does not is the failed lane
  auto end_round = [&](int incl, int nb, long long cur, long long r) {
    const unsigned fit = __ballot_sync(kFull, !mine || (long long)incl <= cur);
    const int f = __ffs(~fit) - 1;
    const int before = __shfl_sync(kFull, incl - nb, f);
    fail = f;
    emit += f;
    done = true;
    if (kChecked && mine && (st < 0 || st >= size))
      first_err = min(first_err, 2 + 2 * (r + 1));
    fsym = tab[clamp_index(st, size)] >> 24;
    return cur - before;
  };

  for (long long tile = 0; tile <= n_tiles; tile++) {
    if (t >= 32) {  // warp 1: the tile before's symbols, the next's words
      if (tile > 0) store_tile(tile - 1, (int)((tile - 1) & 1));
      if (fast_ok && tile + 1 < n_tiles) stage(s_c[tile & 1]);
    } else if (tile < n_tiles) {
      const long long r0 = tile * TR;
      const int nr = (int)((long long)R - r0 < TR ? (long long)R - r0 : TR);
      uint8_t* sb = sbuf + (int)(tile & 1) * (kOneTile + 16) +
                    ((uintptr_t)tile_dst(tile) & 15) + lane;
      int rr = 0;
      if (!done && fast_ok && c >= 0 && c < bits_max) {
        int cc = (int)c;
        for (; rr < nr; rr++) {
          const uint32_t e = tab[st];
          const int nb = entry_bits(e);
          int tot;
          const int incl = scan(nb, tot);
          if (mine) sb[rr * k] = (uint8_t)(e >> 24);
          if (tot > cc) {  // once a block
            if (mine && incl <= cc)
              st = (int)(e & 0xFFFF) + (int)read_bits(w, Wd, cc - incl, nb);
            cc = (int)end_round(incl, nb, cc, r0 + rr);
            break;
          }
          const int start = cc - incl;
          const int wi = start >> 5;
          st = (int)(e & 0xFFFF) +
               (int)(__funnelshift_r(pay[wi & M], pay[(wi + 1) & M],
                                     start & 31) & ((1u << nb) - 1u));
          cc -= tot;
        }
        emit += (long long)(done ? rr : nr) * k;  // the rounds all moved in
        if (done) rr++;
        c = cc;
      }
      for (; rr < nr; rr++) {
        if (done) {
          if (mine) sb[rr * k] = (uint8_t)fsym;
          continue;
        }
        // the plain version's round: clamped reads from device memory
        const long long r = r0 + rr;
        uint32_t e = 0;
        if (mine) {
          if (kChecked && (st < 0 || st >= size))
            first_err = min(first_err, 2 + 2 * r);
          e = tab[clamp_index(st, size)];
          sb[rr * k] = (uint8_t)(e >> 24);
        }
        const int nb = entry_bits(e);
        int tot;
        const int incl = scan(nb, tot);
        if (mine && (long long)incl <= c) {
          const long long start = c - incl;
          if (kChecked && start >= bits_max)
            first_err = min(first_err, 3 + 2 * r);
          st = (int)(e & 0xFFFF) + (int)read_bits(w, Wd, start, nb);
        }
        if ((long long)tot <= c) {
          c -= tot;
          emit += k;
        } else {
          c = end_round(incl, nb, c, r);
        }
      }
      if (t == 0) s_c[(tile + 1) & 1] = c;
    }
    __syncthreads();
  }

  if (t < 32) {
    if (!done) {
      if (kChecked && mine && (st < 0 || st >= size))
        first_err = min(first_err, 2 + 2LL * R);
      fsym = tab[clamp_index(st, size)] >> 24;
    }
    // pending final-state symbols flush cyclically from the failed lane
    if (mine) finals[b * k + ((lane - fail) % k + k) % k] = (uint8_t)fsym;
    if (t == 0) {
      emit_out[b] = emit;
      done_out[b] = done ? 1 : 0;
      cursor_out[b] = c;
    }
    if (kChecked && first_err != LLONG_MAX) record(err + b, first_err);
  }
}

// D5 wide: J lanes a thread, T = blockDim.x threads; dynamic shared memory
// the table (size + 1 entries, padded to 16 bytes) and the payload ring
// (ring_words, a power of two).
template <int J, bool kChecked>
__global__ void __launch_bounds__(J < 64 ? kWideThreads : kMaxThreads)
fse_decode_wide(const uint32_t* __restrict__ words, long long Wd,
                const long long* __restrict__ total_bits,
                const uint32_t* __restrict__ packed, int size,
                uint8_t* __restrict__ syms, long long* __restrict__ emit_out,
                uint8_t* __restrict__ finals, uint8_t* __restrict__ done_out,
                long long* __restrict__ cursor_out, long long* err, int k,
                int L, int R, int ring_words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* ring = tab + (size + 4) / 4 * 4;
  __shared__ int warp_sums[2][32];
  __shared__ int s_fail, s_sum;

  const long long b = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const int lane_id = t & 31, warp = t >> 5, n_warps = T >> 5;
  const bool closed = load_decode_table(tab, packed + b * size, size, L);

  const uint32_t* w = words + b * Wd;
  const long long tb = total_bits[b];
  const long long bits_max = 32 * (Wd - 1);
  long long first_err = LLONG_MAX;
  const int lane0 = t * J;
  const int n_mine = k - lane0 < 0 ? 0 : (k - lane0 > J ? J : k - lane0);

  int st[J];
#pragma unroll
  for (int j = 0; j < J; j++) {
    st[j] = size;  // a lane past k: the sentinel
    if (j < n_mine) {
      const long long start = tb - (long long)(lane0 + j + 1) * L;
      if (kChecked && (start < 0 || start >= bits_max)) first_err = 1;
      st[j] = (int)read_bits(w, Wd, start, L);
      if (!closed) {  // kept clamped; checked where the plain version looks
        if (kChecked && st[j] >= size) first_err = min(first_err, 2LL);
        st[j] = clamp_index(st[j], size);
      }
    }
  }
  long long c = tb - (long long)k * L;
  bool done = false;
  int fail = -1;
  long long emit = 0;
  uint8_t* out = syms + b * R * k + lane0;

  // the payload ring: words [f_ready, top] landed, f_issued the lowest
  // copied; f_e1 / f_e2 the lowest issued by the end of the last round
  // and the one before (a round reads what the one before it waited for)
  const int M = ring_words - 1;
  const bool fast_ok = closed && bits_max <= INT_MAX;
  bool ring_live = false;
  int f_issued = 0, f_e1 = 0, f_e2 = 0;

  int r = 0;
  for (; r < R; r++) {
    uint32_t e[J];
    int local = 0;
#pragma unroll
    for (int j = 0; j < J; j++) {
      e[j] = tab[st[j]];
      local += (e[j] >> 16) & 0xFF;
    }
    store_syms<J>(out + (long long)r * k, e, n_mine);

    // the threads' bit counts: a warp scan, one barrier, the warp sums
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane_id >= d) incl += y;
    }
    if (lane_id == 31) warp_sums[r & 1][warp] = incl;
    if (ring_live) cp_async_wait<1>();
    __syncthreads();
    int total = 0, before = incl - local;
    for (int v = 0; v < n_warps; v++) {
      const int s = warp_sums[r & 1][v];
      total += s;
      before += v < warp ? s : 0;
    }

    const bool fits = (long long)total <= c;
    if (!ring_live && fast_ok && fits && c < bits_max) {
      const int top = (int)(c >> 5) + 1;
      f_issued = top - M > 0 ? top - M : 0;
      for (int x = f_issued + t; x <= top; x += T) cp_async4(&ring[x & M], w + x);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      ring_live = true;
      f_e1 = f_e2 = f_issued;
    }

    if (ring_live && fits && c < bits_max && (int)((c - total) >> 5) >= f_e2) {
      const int ci = (int)c;
      int run = before;
#pragma unroll
      for (int j = 0; j < J; j++) {
        const int nb = (e[j] >> 16) & 0xFF;
        run += nb;
        const int start = ci - run;
        const int wi = start >> 5;
        const uint32_t x = __funnelshift_r(ring[wi & M], ring[(wi + 1) & M],
                                           start & 31) & ((1u << nb) - 1u);
        st[j] = (int)(e[j] & 0xFFFF) + (int)x;
      }
    } else {  // the plain version's reads, clamped and checked
      long long run = before;
      int prev = 0;
#pragma unroll
      for (int j = 0; j < J; j++) {
        const int nb = (e[j] >> 16) & 0xFF;
        prev = (int)run;
        run += nb;
        if (j >= n_mine) continue;
        if (run <= c) {
          const long long start = c - run;
          if (kChecked && start >= bits_max)
            first_err = min(first_err, 3 + 2LL * r);
          st[j] = (int)(e[j] & 0xFFFF) + (int)read_bits(w, Wd, start, nb);
          if (!closed) {
            if (kChecked && (st[j] < 0 || st[j] >= size))
              first_err = min(first_err, 4 + 2LL * r);
            st[j] = clamp_index(st[j], size);
          }
        } else if (!fits && (lane0 + j == 0 || prev <= c)) {
          // the first lane whose prefix passes c: the lanes before it moved
          s_fail = lane0 + j;
          s_sum = prev;
        }
      }
    }

    if (ring_live) {  // the words this round frees, copied for the rounds ahead
      const int target = (int)(c >> 5) + 2 - ring_words;
      const int lo = target > 0 ? target : 0;
      for (int x = lo + t; x < f_issued; x += T) cp_async4(&ring[x & M], w + x);
      cp_async_commit();
      if (lo < f_issued) f_issued = lo;
      f_e2 = f_e1;
      f_e1 = f_issued;
    }
    if (fits) {
      c -= total;
      emit += k;
    } else {  // once a block: the failed lane ends the stream
      __syncthreads();
      fail = s_fail;
      emit += s_fail;
      c -= s_sum;
      done = true;
      r++;
      break;
    }
  }

  // done: the frozen states' symbols for the rounds left
  uint32_t e[J];
#pragma unroll
  for (int j = 0; j < J; j++) e[j] = tab[st[j]];
  for (; r < R; r++) store_syms<J>(out + (long long)r * k, e, n_mine);

  // pending final-state symbols flush cyclically from the failed lane
#pragma unroll
  for (int j = 0; j < J; j++)
    if (j < n_mine)
      finals[b * k + ((lane0 + j - fail) % k + k) % k] = (uint8_t)(e[j] >> 24);
  if (t == 0) {
    emit_out[b] = emit;
    done_out[b] = done ? 1 : 0;
    cursor_out[b] = c;
  }
  if (kChecked && first_err != LLONG_MAX) record(err + b, first_err);
  cp_async_wait<0>();
}

// --- D4 --------------------------------------------------------------------

// Check sequence numbers of the plain encode: 1 the initial next-state
// indices, 2 + r round r's (of valid slots), R + 2 the last bit's word.

// Copies a block's encode tables into shared memory: the symbol transforms
// and the next-state table (size entries of a power-of-two `tsize`).
__device__ __forceinline__ void load_encode_tables(
    uint32_t* tbits, int32_t* tfs, uint16_t* tab,
    const uint32_t* __restrict__ tt_bits, const int32_t* __restrict__ tt_fs,
    const uint16_t* __restrict__ table, long long b, int size) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    tbits[i] = __ldg(tt_bits + b * 256 + i);
    tfs[i] = __ldg(tt_fs + b * 256 + i);
  }
  for (int i = threadIdx.x; i < size; i += blockDim.x)
    tab[i] = __ldg(table + b * size + i);
}

// new_first_symbol, floor+1 form (reference src/fse.rs:210-218)
__device__ __forceinline__ uint32_t first_state(const uint32_t* tbits,
                                                const int32_t* tfs,
                                                const uint16_t* tab, int s0,
                                                int size, long long& idx0) {
  const long long b0 = tbits[s0];
  const long long out0 = (b0 >> 16) + 1;
  idx0 = ((((out0 << 16) - b0)) >> (out0 & 63)) + tfs[s0];
  return tab[idx0 < 0 ? 0 : (idx0 >= size ? size - 1 : idx0)];
}

// One slot of a lane's chain: the bits the state emits (`nb`, `val`) and
// its next state. The next-state index is masked into the power-of-two
// table and the lookup redone clamped only when the index left [0, size).
template <bool kChecked>
__device__ __forceinline__ uint32_t encode_step(
    const uint32_t* tbits, const int32_t* tfs, const uint16_t* tab,
    int tmask, int size, uint32_t s, uint32_t state, int& nb, uint32_t& val,
    bool v, long long seq, long long& first_err) {
  const uint32_t sh = ((tbits[s] + state) >> 16) & 31;
  nb = (int)sh;
  val = state & ((1u << sh) - 1u);
  const int idx = (int)(state >> sh) + tfs[s];
  uint32_t nxt = tab[idx & tmask];
  if ((unsigned)idx >= (unsigned)size) {
    if (kChecked && v) first_err = min(first_err, seq);
    nxt = tab[clamp_index(idx, size)];
  }
  return v ? nxt : state;
}

// D4 one-warp (k <= 32): lane j of warp 0 runs lane j's chain, a tile of
// TR = kOneTile / k rounds at a time, and writes each slot's bits (count <<
// 16 | value) to a buffer; warp 1 does the rest a tile apart: it stages
// tile t + 1 as one record a slot of what does not depend on the state (the
// symbol's transforms tt_bits, tt_fs; a padding slot (2^31, INT_MIN): no
// bits out, a next-state index out of range, the state kept), and packs
// tile t - 1's bits into the stream (a warp scan of the counts, the bits
// ORed into a row of staged words in shared memory, whole words stored,
// the partial one carried); a __syncthreads between tiles. A tile's chains
// take no clamp: an index that leaves [0, size) (a padding slot's always
// does) has the warp code the tile again from its first states with the
// clamps and the checks. After the last tile the final states (in
// finish_slots order) and the marker go through the pack as one more
// tile. Dynamic shared memory: the tables (tsize u16 entries after 2 KiB
// of transforms), two record buffers, two bit buffers, the staged row
// (kOneTile + 2 words).
template <bool kChecked>
__global__ void __launch_bounds__(kOneCta)
fse_encode_warp(const uint8_t* __restrict__ syms,
                const uint8_t* __restrict__ valid,
                const uint8_t* __restrict__ init_syms,
                const long long* __restrict__ finish_slots,
                const uint16_t* __restrict__ table,
                const uint32_t* __restrict__ tt_bits,
                const int32_t* __restrict__ tt_fs, int size, int tsize,
                uint32_t* __restrict__ words,
                long long* __restrict__ total_bits, long long* err, int k,
                int L, int R, long long W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* tbits = reinterpret_cast<uint32_t*>(smem_raw);
  int32_t* tfs = reinterpret_cast<int32_t*>(tbits + 256);
  uint16_t* tab = reinterpret_cast<uint16_t*>(tfs + 256);
  uint2* in = reinterpret_cast<uint2*>(tab + tsize);  // [2][kOneTile]
  uint32_t* bits = reinterpret_cast<uint32_t*>(in + 2 * kOneTile);
  uint32_t* sw = bits + 2 * kOneTile;  // kOneTile + 2 staged words
  __shared__ uint32_t s_state[32];
  __shared__ long long s_total;

  const long long b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31;
  const int TR = kOneTile / k, TS = TR * k;
  const long long Rk = (long long)R * k;
  const uint8_t* sy = syms + b * Rk;
  uint32_t* wo = words + b * W;
  load_encode_tables(tbits, tfs, tab, tt_bits, tt_fs, table, b, size);
  for (int i = t; i < kOneTile + 2; i += blockDim.x) sw[i] = 0;
  __syncthreads();  // the transforms, which the helper reads

  const long long n_tiles = ((long long)R + TR - 1) / TR;
  auto slots = [&](long long tile) {
    return tile < n_tiles ? (int)(Rk - tile * TS < TS ? Rk - tile * TS : TS)
                          : k + 1;
  };
  // warp 1: tile `tile`'s records
  auto stage_tile = [&](long long tile) {
    uint2* rec = in + kOneTile * (int)(tile & 1);
    const long long s0 = tile * TS;
    const int n = slots(tile);
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
      const uint32_t s = __ldg(sy + s0 + i);
      rec[i] = __ldg(valid + s0 + i)
                   ? make_uint2(tbits[s], (uint32_t)tfs[s])
                   : make_uint2(0x80000000u, 0x80000000u);
    }
  };
  // warp 1: n slots' bits (count << 16 | value) into the stream at bit
  // `carry`, whole words out, the partial one kept at sw[0]
  long long carry = 0;
  auto pack = [&](const uint32_t* nbv, int n) {
    const int m = (n + 31) / 32, i0 = lane * m, i1 = i0 + m < n ? i0 + m : n;
    int mine = 0;
    for (int i = i0; i < i1; i++) mine += nbv[i] >> 16;
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int tile_bits = __shfl_sync(kFull, incl, 31);
    const int p = (int)(carry & 31) + incl - mine;
    uint64_t acc = 0;
    int n_acc = p & 31, at = p >> 5;
    bool first = true;
    for (int i = i0; i < i1; i++) {
      acc |= (uint64_t)(nbv[i] & 0xFFFF) << n_acc;
      n_acc += nbv[i] >> 16;
      if (n_acc >= 32) {  // a word it shares (the first) by atomicOr
        if (first)
          atomicOr(sw + at, (uint32_t)acc);
        else
          sw[at] = (uint32_t)acc;
        first = false;
        acc >>= 32;
        n_acc -= 32;
        at++;
      }
    }
    if (mine > 0 && n_acc > 0) atomicOr(sw + at, (uint32_t)acc);
    __syncwarp();
    const int end = (int)(carry & 31) + tile_bits;
    const long long w0 = carry >> 5;
    for (int i = lane; i < end >> 5; i += 32)
      if (w0 + i < W) wo[w0 + i] = sw[i];  // past W: dropped, as in JAX
    const uint32_t partial = sw[end >> 5];
    __syncwarp();
    for (int i = lane; i <= end >> 5; i += 32) sw[i] = i == 0 ? partial : 0;
    __syncwarp();
    carry += tile_bits;
  };

  long long first_err = LLONG_MAX;
  const bool mine = t < k;  // warp 0's lanes with a chain
  uint32_t state = 0;
  if (t >= 32 && n_tiles > 0) stage_tile(0);
  if (mine) {
    long long idx0;
    state = first_state(tbits, tfs, tab, init_syms[b * k + t], size, idx0);
    if (kChecked && (idx0 < 0 || idx0 >= size)) first_err = 1;
  }
  __syncthreads();  // the first tile's records
  const int tmask = tsize - 1;
  for (long long tile = 0; tile <= n_tiles; tile++) {
    if (t >= 32) {  // warp 1: the next tile's records, the last one's bits
      if (tile + 1 < n_tiles) stage_tile(tile + 1);
      if (tile > 0)
        pack(bits + kOneTile * (int)((tile - 1) & 1), slots(tile - 1));
    } else {
      uint32_t* nbv = bits + kOneTile * (int)(tile & 1);
      if (tile < n_tiles) {
        const uint2* rec = in + kOneTile * (int)(tile & 1);
        const long long r0 = tile * TR;
        const int nr = (int)((long long)R - r0 < TR ? (long long)R - r0 : TR);
        const uint32_t state0 = state;
        bool out = false;
        if (mine) {
          for (int rr = 0; rr < nr; rr++) {
            const int i = rr * k + t;
            const uint2 x = rec[i];
            const uint32_t st0 = state;
            const uint32_t sh = ((x.x + st0) >> 16) & 31;
            const int idx = (int)(st0 >> sh) + (int)x.y;
            out |= (unsigned)idx >= (unsigned)size;
            state = tab[idx & tmask];
            nbv[i] = (sh << 16) | (st0 & ((1u << sh) - 1u));
          }
        }
        if (__any_sync(kFull, out) && mine) {  // again, clamped and checked
          state = state0;
          for (int rr = 0; rr < nr; rr++) {
            const int i = rr * k + t;
            const uint2 x = rec[i];
            const uint32_t st0 = state;
            const uint32_t sh = ((x.x + st0) >> 16) & 31;
            const int idx = (int)(st0 >> sh) + (int)x.y;
            const bool pad = x.x == 0x80000000u && x.y == 0x80000000u;
            if (kChecked && !pad && (unsigned)idx >= (unsigned)size)
              first_err = min(first_err, 2 + r0 + rr);
            state = pad ? st0 : tab[clamp_index(idx, size)];
            nbv[i] = (sh << 16) | (st0 & ((1u << sh) - 1u));
          }
        }
      } else {
        // stream close: the final states in finish_slots order, L bits
        // each, then the marker bit (reference: src/lib.rs:178-182)
        if (mine) s_state[t] = state;
        __syncwarp();
        const uint32_t mask_L = (1u << L) - 1u;
        for (int i = lane; i < k; i += 32)
          nbv[i] = ((uint32_t)L << 16) | (s_state[finish_slots[i]] & mask_L);
        if (lane == 0) nbv[k] = (1u << 16) | 1u;
      }
    }
    __syncthreads();
  }
  if (t >= 32) {
    pack(bits + kOneTile * (int)(n_tiles & 1), k + 1);
    if (lane == 0) {
      if ((carry & 31) && (carry >> 5) < W) wo[carry >> 5] = sw[0];
      s_total = carry;
      total_bits[b] = carry;
    }
  }
  __syncthreads();
  const long long total = s_total;
  if (kChecked && t == 0 && ((total - 1) >> 5) + 1 >= W)
    first_err = min(first_err, (long long)R + 2);
  if (kChecked && first_err != LLONG_MAX) record(err + b, first_err);
  for (long long i = ((total + 31) >> 5) + t; i < W; i += blockDim.x)
    wo[i] = 0;
}

// One sub-round of D4 wide's emission: every thread's bit count scanned
// (a warp scan, one barrier, the warp sums), then the words the sub-rounds
// before completed go out and their slots are zeroed, and each active
// thread ORs its slots' bits (nbv[j]: the bit count in the low 8 bits, the
// value above) into the staged words from bit `pos` + the bits before it.
template <int J>
__device__ __forceinline__ void emit_slots(const uint32_t* nbv, int mine,
                                           bool active, uint32_t* ring,
                                           int M, int (*warp_sums)[32],
                                           int& sbuf, long long& pos,
                                           long long& stored,
                                           uint32_t* __restrict__ wo,
                                           long long W) {
  const int t = threadIdx.x, T = blockDim.x;
  const int lane_id = t & 31, warp = t >> 5, n_warps = T >> 5;
  const int my = active ? mine : 0;
  int incl = my;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane_id >= d) incl += y;
  }
  if (lane_id == 31) warp_sums[sbuf][warp] = incl;
  __syncthreads();
  int total = 0, before = incl - my;
  for (int v = 0; v < n_warps; v++) {
    const int s = warp_sums[sbuf][v];
    total += s;
    before += v < warp ? s : 0;
  }
  sbuf ^= 1;

  // the whole words of the sub-rounds before, coalesced
  const long long end = pos >> 5;
  for (long long x = stored + t; x < end; x += T) {
    if (x < W) wo[x] = ring[x & M];  // past W: dropped, as in JAX
    ring[x & M] = 0;
  }
  stored = end;

  if (active && my > 0) {
    const long long p = pos + before;
    uint64_t acc = 0;
    int n_acc = (int)(p & 31);
    long long at = p >> 5;
    bool first = true;
#pragma unroll
    for (int j = 0; j < J; j++) {
      const int nb = nbv[j] & 0xFF;
      acc |= (uint64_t)(nbv[j] >> 8) << n_acc;
      n_acc += nb;
      if (n_acc >= 32) {  // a word it shares (the first) by atomicOr
        if (first)
          atomicOr(ring + (at & M), (uint32_t)acc);
        else
          ring[at & M] = (uint32_t)acc;
        first = false;
        acc >>= 32;
        n_acc -= 32;
        at++;
      }
    }
    if (n_acc > 0) atomicOr(ring + (at & M), (uint32_t)acc);
  }
  pos += total;
}

// D4 wide: J lanes a thread, T = blockDim.x threads, sub-rounds of `sub`
// threads. Dynamic shared memory: the tables (tsize u16 entries after 2
// KiB of transforms), the final states (k u16, padded to 16 bytes), the
// staged-word ring (ring_words, a power of two).
template <int J, bool kChecked>
__global__ void __launch_bounds__(J < 64 ? kWideThreads : kMaxThreads)
fse_encode_wide(const uint8_t* __restrict__ syms,
                const uint8_t* __restrict__ valid,
                const uint8_t* __restrict__ init_syms,
                const long long* __restrict__ finish_slots,
                const uint16_t* __restrict__ table,
                const uint32_t* __restrict__ tt_bits,
                const int32_t* __restrict__ tt_fs, int size, int tsize,
                uint32_t* __restrict__ words,
                long long* __restrict__ total_bits, long long* err, int k,
                int L, int R, long long W, int ring_words, int sub) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* tbits = reinterpret_cast<uint32_t*>(smem_raw);
  int32_t* tfs = reinterpret_cast<int32_t*>(tbits + 256);
  uint16_t* tab = reinterpret_cast<uint16_t*>(tfs + 256);
  uint16_t* fstate = tab + tsize;
  uint32_t* ring = reinterpret_cast<uint32_t*>(fstate + (k + 7) / 8 * 8);
  __shared__ int warp_sums[2][32];

  const long long b = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const int M = ring_words - 1;
  const int lane0 = t * J;
  const int n_mine = k - lane0 < 0 ? 0 : (k - lane0 > J ? J : k - lane0);
  const long long Rk = (long long)R * k;
  const uint8_t* sy = syms + b * Rk + lane0;
  const uint8_t* va = valid + lane0;
  uint32_t* wo = words + b * W;
  load_encode_tables(tbits, tfs, tab, tt_bits, tt_fs, table, b, size);
  for (int i = t; i < ring_words; i += T) ring[i] = 0;
  __syncthreads();

  long long first_err = LLONG_MAX;
  uint32_t state[J];
#pragma unroll
  for (int j = 0; j < J; j++) {
    state[j] = 0;
    if (j < n_mine) {
      long long idx0;
      state[j] = first_state(tbits, tfs, tab, init_syms[b * k + lane0 + j],
                             size, idx0);
      if (kChecked && (idx0 < 0 || idx0 >= size)) first_err = 1;
    }
  }

  const int tmask = tsize - 1;
  int sbuf = 0;
  long long pos = 0, stored = 0;
  constexpr int NV = (J + 3) / 4;
  uint32_t sb[NV], vb[NV], sb_next[NV], vb_next[NV];
  if (R > 0) {
    load_bytes<J>(sy, n_mine, sb);
    load_bytes<J>(va, n_mine, vb);
  }
  for (int r = 0; r < R; r++) {
    if (r + 1 < R) {  // the next round's symbols, a round ahead
      load_bytes<J>(sy + (long long)(r + 1) * k, n_mine, sb_next);
      load_bytes<J>(va + (long long)(r + 1) * k, n_mine, vb_next);
    }
    uint32_t nbv[J];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < J; j++) {
      const bool v = byte_of(vb, j) != 0;  // 0 past n_mine
      int nb;
      uint32_t val;
      state[j] = encode_step<kChecked>(tbits, tfs, tab, tmask, size,
                                       byte_of(sb, j), state[j], nb, val, v,
                                       2LL + r, first_err);
      nbv[j] = v ? (val << 8) | (uint32_t)nb : 0u;
      mine += v ? nb : 0;
    }
    for (int t0 = 0; t0 < T; t0 += sub)
      emit_slots<J>(nbv, mine, t >= t0 && t < t0 + sub, ring, M, warp_sums,
                    sbuf, pos, stored, wo, W);
#pragma unroll
    for (int i = 0; i < NV; i++) {
      sb[i] = sb_next[i];
      vb[i] = vb_next[i];
    }
  }

  // stream close: the final states of the lanes in finish_slots order, L
  // bits each, then the marker bit (reference: src/lib.rs:178-182), k + 1
  // slots emitted J a thread as the rounds' are
#pragma unroll
  for (int j = 0; j < J; j++)
    if (j < n_mine) fstate[lane0 + j] = (uint16_t)state[j];
  __syncthreads();
  const uint32_t mask_L = (1u << L) - 1u;
  for (long long f0 = 0; f0 <= k; f0 += (long long)T * J) {
    uint32_t nbv[J];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < J; j++) {
      const long long i = f0 + lane0 + j;
      nbv[j] = i < k ? ((fstate[finish_slots[i]] & mask_L) << 8) | (uint32_t)L
                     : (i == k ? (1u << 8) | 1u : 0u);
      mine += nbv[j] & 0xFF;
    }
    for (int t0 = 0; t0 < T; t0 += sub)
      emit_slots<J>(nbv, mine, t >= t0 && t < t0 + sub, ring, M, warp_sums,
                    sbuf, pos, stored, wo, W);
  }
  __syncthreads();
  // the last words (the partial one included), then zeros to W
  const long long end = (pos + 31) >> 5;
  for (long long x = stored + t; x < end; x += T)
    if (x < W) wo[x] = ring[x & M];
  for (long long x = end + t; x < W; x += T) wo[x] = 0;
  if (t == 0) {
    total_bits[b] = pos;
    if (kChecked && ((pos - 1) >> 5) + 1 >= W)
      first_err = min(first_err, (long long)R + 2);
  }
  if (kChecked && first_err != LLONG_MAX) record(err + b, first_err);
}

}  // namespace

// --- host launchers ---

#include <type_traits>

namespace {

template <int N>
using IntC = std::integral_constant<int, N>;

// f(IntC<K>) for D5's one-thread instantiation of k lanes (K == k)
template <class F>
int with_one_thread(int k, F f) {
  switch (k) {
    case 1: return f(IntC<1>{});
    case 2: return f(IntC<2>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// f(IntC<J>) for the wide instantiation of k lanes
template <class F>
int with_wide(int k, F f) {
  switch (wide_lanes(k)) {
    case 1: return f(IntC<1>{});
    case 2: return f(IntC<2>{});
    case 4: return f(IntC<4>{});
    case 8: return f(IntC<8>{});
    case 16: return f(IntC<16>{});
    case 32: return f(IntC<32>{});
    case 64: return f(IntC<64>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

template <class Kern>
int allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return e == cudaSuccess ? 0 : fail(e);
}

// path: a kernel's number, or -1: the launch rule's
int pick(int path, int dir, int k) { return path >= 0 ? path : rule(dir, k); }

// What a launch takes: the kernel, its CTA, its dynamic shared memory and
// its ring's and sub-round's sizes.
struct Launch {
  const void* kernel = nullptr;
  int threads = 0;
  size_t smem = 0;
  int ring = 0;
  int sub = 0;
  int lanes = 0;  // K or J
  int group = 1;  // blocks a CTA
  int seg = 0;    // shared memory a block (D5 one-thread)
};

template <bool kChecked>
int decode_launch_of(int path, int k, int L, int size, Launch& out) {
  if (path == 2) {
    if (k > kOneWarp) return (int)cudaErrorInvalidValue;
    out.kernel = (const void*)fse_decode_warp<kChecked>;
    out.threads = kOneCta;
    out.smem = (size_t)(size + 4) / 4 * 16 + 4 * kOnePay + 2 * (kOneTile + 16);
    out.lanes = 1;
    return 0;
  }
  if (path == 0) {
    return with_one_thread(k, [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      out.kernel = (const void*)fse_decode_one<K, kChecked>;
      out.threads = kOneCta;
      out.seg = one_thread_segment(size);
      out.group = one_thread_group(size);
      out.smem = (size_t)out.group * out.seg;
      out.lanes = K;
      return 0;
    });
  }
  return with_wide(k, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    out.kernel = (const void*)fse_decode_wide<J, kChecked>;
    out.threads = wide_threads(k, J);
    out.ring = decode_ring_words(k, L);
    out.smem = (size_t)(size + 4) / 4 * 16 + (size_t)out.ring * 4;
    out.lanes = J;
    return 0;
  });
}

template <bool kChecked>
int encode_launch_of(int path, int k, int L, int size, Launch& out) {
  const int tsize = encode_table_slots(size);
  const size_t tables = 2 * 256 * 4 + (size_t)tsize * 2;
  if (path == 0) return (int)cudaErrorInvalidValue;  // no one-thread D4
  if (path == 2) {
    if (k > kOneWarp) return (int)cudaErrorInvalidValue;
    out.kernel = (const void*)fse_encode_warp<kChecked>;
    out.threads = kOneCta;
    out.smem = tables + 24 * (size_t)kOneTile + 4 * (kOneTile + 2);
    out.lanes = 1;
    return 0;
  }
  return with_wide(k, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    out.kernel = (const void*)fse_encode_wide<J, kChecked>;
    out.threads = wide_threads(k, J);
    out.sub = encode_sub_threads(out.threads, J, L);
    out.ring = encode_ring_words(out.sub, J, L);
    out.smem = tables + (size_t)(k + 7) / 8 * 16 + (size_t)out.ring * 4;
    out.lanes = J;
    return 0;
  });
}

int decode_with(int path, const void* words, const void* total_bits,
                const void* packed, void* syms, void* emit, void* finals,
                void* done, void* cursor, void* err, int B, long long Wd,
                int k, int L, int size, int R, cudaStream_t stream) {
  if (B < 0 || Wd < 1 || k < 1 || k > 0xFFFF || L < 1 || L > 16 ||
      size < 1 || size > 0xFFFF || R < 0 || path < -1 || path > 2 ||
      !words || !total_bits || !packed || !syms || !emit || !finals ||
      !done || !cursor)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  path = pick(path, 0, k);
  Launch x;
  const int e = err ? decode_launch_of<true>(path, k, L, size, x)
                    : decode_launch_of<false>(path, k, L, size, x);
  if (e) return e;
  if (const int a = allow_smem(x.kernel, x.smem)) return a;
  void* args[] = {&words, &Wd, &total_bits, &packed, &size, &syms, &emit,
                  &finals, &done, &cursor, &err, &k, &L, &R,
                  path == 0 ? (void*)&B : (void*)&x.ring, &x.group, &x.seg};
  const cudaError_t rc =
      cudaLaunchKernel(x.kernel, dim3((B + x.group - 1) / x.group),
                       dim3(x.threads), args, x.smem, stream);
  return rc == cudaSuccess ? (int)cudaGetLastError() : fail(rc);
}

int encode_with(int path, const void* syms, const void* valid,
                const void* init_syms, const void* finish_slots,
                const void* table, const void* tt_bits, const void* tt_fs,
                void* words, void* total_bits, void* err, int B, int R, int k,
                int L, int size, long long W, cudaStream_t stream) {
  if (B < 0 || R < 0 || k < 1 || k > 0xFFFF || L < 1 || L > 16 || size < 1 ||
      size > 0x10000 || W < 1 || path < -1 || path > 2 || !syms || !valid ||
      !init_syms || !finish_slots || !table || !tt_bits || !tt_fs || !words ||
      !total_bits)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  path = pick(path, 1, k);
  Launch x;
  const int e = err ? encode_launch_of<true>(path, k, L, size, x)
                    : encode_launch_of<false>(path, k, L, size, x);
  if (e) return e;
  if (const int a = allow_smem(x.kernel, x.smem)) return a;
  int tsize = encode_table_slots(size);
  void* args[] = {&syms, &valid, &init_syms, &finish_slots, &table, &tt_bits,
                  &tt_fs, &size, &tsize, &words, &total_bits, &err, &k, &L,
                  &R, &W, &x.ring, &x.sub};
  const cudaError_t rc =
      cudaLaunchKernel(x.kernel, dim3((B + x.group - 1) / x.group),
                       dim3(x.threads), args, x.smem, stream);
  return rc == cudaSuccess ? (int)cudaGetLastError() : fail(rc);
}

}  // namespace

// D5 on B blocks: words (B, Wd) u32, total_bits (B,) i64, packed (B, size)
// u32 -> syms (B, R, k) u8, emit (B,) i64, finals (B, k) u8, done (B,) u8,
// cursor (B,) i64; err (B,) i64 set to -1 by the caller, or null (the
// unchecked kernels). One launch; the kernel by the launch rule.
extern "C" int ect_fse_decode(const void* words, const void* total_bits,
                              const void* packed, void* syms, void* emit,
                              void* finals, void* done, void* cursor,
                              void* err, int B, long long Wd, int k, int L,
                              int size, int R, cudaStream_t stream) {
  return decode_with(-1, words, total_bits, packed, syms, emit, finals, done,
                     cursor, err, B, Wd, k, L, size, R, stream);
}

// D4 on B blocks: syms (B, R, k) u8, valid (R, k) u8, init_syms (B, k) u8,
// finish_slots (k,) i64 in [0, k), table (B, size) u16, tt_bits (B, 256)
// u32, tt_fs (B, 256) i32 -> words (B, W) u32 (every word written),
// total_bits (B,) i64; err as for D5. One launch; no scratch.
extern "C" int ect_fse_encode(const void* syms, const void* valid,
                              const void* init_syms, const void* finish_slots,
                              const void* table, const void* tt_bits,
                              const void* tt_fs, void* words, void* total_bits,
                              void* err, int B, int R, int k, int L, int size,
                              long long W, cudaStream_t stream) {
  return encode_with(-1, syms, valid, init_syms, finish_slots, table, tt_bits,
                     tt_fs, words, total_bits, err, B, R, k, L, size, W,
                     stream);
}

// The same launches with the kernel named by its number (rule), for
// measuring where the launch rule's thresholds lie; the wrappers call the
// two above.
extern "C" int ect_fse_decode_path(int path, const void* words,
                                   const void* total_bits, const void* packed,
                                   void* syms, void* emit, void* finals,
                                   void* done, void* cursor, void* err, int B,
                                   long long Wd, int k, int L, int size,
                                   int R, cudaStream_t stream) {
  return decode_with(path, words, total_bits, packed, syms, emit, finals,
                     done, cursor, err, B, Wd, k, L, size, R, stream);
}

extern "C" int ect_fse_encode_path(int path, const void* syms,
                                   const void* valid, const void* init_syms,
                                   const void* finish_slots, const void* table,
                                   const void* tt_bits, const void* tt_fs,
                                   void* words, void* total_bits, void* err,
                                   int B, int R, int k, int L, int size,
                                   long long W, cudaStream_t stream) {
  return encode_with(path, syms, valid, init_syms, finish_slots, table,
                     tt_bits, tt_fs, words, total_bits, err, B, R, k, L, size,
                     W, stream);
}

// What a launch of direction `dir` (0 decode, 1 encode) at k lanes, table
// log L and table size `size` takes, on the current device: out[0] the
// kernel's number (rule), [1] K or J, [2] threads, [3] dynamic shared
// memory (bytes), [4] registers a thread, [5] local memory a thread (bytes:
// spills), [6] resident CTAs an SM, [7] ring words, [8] sub-round threads,
// [9] blocks a CTA. `path` as for ect_fse_decode_path (-1: the rule's).
extern "C" int ect_fse_launch_info(int dir, int path, int k, int L, int size,
                                   int checked, int* out) {
  if (dir < 0 || dir > 1 || k < 1 || k > 0xFFFF || L < 1 || L > 16 ||
      size < 1 || !out)
    return (int)cudaErrorInvalidValue;
  path = pick(path, dir, k);
  Launch x;
  int e;
  if (dir == 0)
    e = checked ? decode_launch_of<true>(path, k, L, size, x)
                : decode_launch_of<false>(path, k, L, size, x);
  else
    e = checked ? encode_launch_of<true>(path, k, L, size, x)
                : encode_launch_of<false>(path, k, L, size, x);
  if (e) return e;
  if (const int a = allow_smem(x.kernel, x.smem)) return a;
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, x.kernel);
  if (rc != cudaSuccess) return fail(rc);
  int ctas = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, x.kernel,
                                                     x.threads, x.smem);
  if (rc != cudaSuccess) return fail(rc);
  const int vals[10] = {path,        x.lanes, x.threads, (int)x.smem,
                        attr.numRegs, (int)attr.localSizeBytes, ctas,
                        x.ring,      x.sub,   x.group};
  for (int i = 0; i < 10; i++) out[i] = vals[i];
  return 0;
}
