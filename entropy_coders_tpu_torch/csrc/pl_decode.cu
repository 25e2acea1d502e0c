// B1: per-lane tANS decode for the MODE_FSE_PL container, for Hopper (sm_90a).
//
// Replaces entropy_coders_tpu/ops/pl_coder.py:285 (_decode_kernel), the
// Pallas TPU kernel launched by _decode_call. Same function, same layouts at
// the boundary: block b, lane i decodes the reference-format single-stream
// FSE payload held in column i of words[b] (bit j of the stream is bit j & 31
// of word j >> 5). The cursor starts at size - L, the initial state is the
// top L bits; each of R rounds looks up (sym, nb, base) = table[state], moves
// the cursor down by nb, sets state = base + bits[c, c + nb) and writes sym.
// The lane's final symbol is table[state].sym, and its final cursor is
// written out: a lane that does not end at exactly 0 marks a corrupt stream.
//
// What bounds it, at the main path's launch shapes (one launch per ~64 MiB
// chunk; tools/lane_shapes.py counts the bounds from this kernel's SASS and
// the card's measured latencies, PERF.md has the numbers):
//   throughput  B=4,   k=16384, R=1023, L=8   65,536 lanes, 16 warps an SM:
//               the integer ALU (~7.5 ALU instructions a warp a round, at 2
//               a clock an SM) and the bytes (~34 MB of words read, 67 MB
//               of symbols written), about equal, above the chain (~47
//               cycles a round: one shared load and six integer steps);
//   parity      B=4,   k=8192,  R=2047, L=11  32,768 lanes, 8 warps an SM:
//               R rounds of the chain bind;
//   default     B=512, k=1024,  R=127,  L=10  524,288 lanes: the bytes,
//               just above the ALU.
//
// The design: one thread per lane, T lanes of one block a CTA (T picked by
// the wrapper, ops/pl_coder.py lane_config, as for B2), the block's 2^L
// entries in dynamic shared memory, re-laid as the chain wants them. The
// chain of a round is: one shared load of the entry, nb (one shift), the
// cursor, one 64-bit funnel shift of the bit buffer, a mask, an add and a
// mask; the state is kept times 4, the next entry's byte offset. Everything
// else is off it:
//   - the bit buffer holds 64 stream bits with at least TH of them below the
//     cursor before every group of RF rounds (RF = 2 while two rounds take
//     at most 20 bits, L <= 10), so no read waits for a refill; the refill,
//     predicated and without a branch, runs after the group;
//   - a lane's next words come from a ring of 32 word slots in shared
//     memory that cp.async tops up once a tile of 32 rounds, to 2(L+1) rows
//     below the cursor: every row the tile can take in landed a tile
//     earlier. A register prefetch one refill ahead did not hide the load:
//     the lanes of a warp refill in different rounds, and a warp waits for
//     the newest load any of its lanes issued into the register;
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

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_launch.cuh"

namespace {

using namespace ect_lane;

constexpr int kRows = 32;  // rounds per staged output tile
constexpr int kRing = 32;  // word slots a lane keeps: its rows mod 32

// dynamic shared memory: u32 table[2^L] | u32 ring[kRing][T] |
// u8 tiles[2][kRows][T]
inline size_t smem_bytes(int T, int L) {
  return (sizeof(uint32_t) << L) + kRing * sizeof(uint32_t) * (size_t)T +
         2 * kRows * (size_t)T;
}

// RF = rounds between refill checks: 2 while two rounds take at most 20
// bits (L <= 10), else 1
template <int T, int RF>
__global__ void __launch_bounds__(T)
pl_decode_kernel(const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ sizes,
                 const uint32_t* __restrict__ dtab,
                 uint8_t* __restrict__ syms, uint8_t* __restrict__ finals,
                 int32_t* __restrict__ cursors, int W, int k, int L, int R,
                 int b0) {
  extern __shared__ __align__(16) uint32_t s_tab[];
  const int tid = threadIdx.x;
  const int64_t b = b0 + blockIdx.y;
  const int lane0 = blockIdx.x * T;
  const uint32_t n_tab = 1u << L;
  const uint32_t mask_L = n_tab - 1u;
  uint32_t* ring = s_tab + n_tab + tid;  // slot s of this lane: ring[s * T]
  uint8_t* s_out = reinterpret_cast<uint8_t*>(s_tab + n_tab + kRing * T);

  // The entries are re-laid for the chain: base << SH in bits 0-16 (the next
  // lookup's byte offset), sym in bits 20-27, nb in bits 28-31. The state is
  // kept as that byte offset, state << SH.
  constexpr int SH = 2;
  const uint32_t* tab_g = dtab + b * n_tab;
  for (uint32_t j = tid; j < n_tab; j += T) {
    const uint32_t e = tab_g[j];
    s_tab[j] = ((e & 0xFFFFu) << SH) | ((e >> 24) << 20) |
               (((e >> 16) & 0xFu) << 28);
  }
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
  const uint32_t mask4 = mask_L << SH;
  uint32_t state4;  // 4 x the initial state, the top L bits, from c0's words
  {
    const int r0 = c0 >> 5;  // floor, also for a negative (corrupt) cursor
    const uint64_t w = (uint64_t)load(r0) | ((uint64_t)load(r0 + 1) << 32);
    state4 = ((uint32_t)(w >> (c0 & 31)) & mask_L) << SH;
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
  const char* ring_b = reinterpret_cast<const char*>(s_tab + n_tab);
  const uint32_t ring_mask = kRing * 4u * T - 1u;
  uint32_t rs = (uint32_t)(row - 1) * (4u * T) + 4u * tid;
  uint32_t lo = (uint32_t)buf, hi = (uint32_t)(buf >> 32);
  auto step = [&](uint8_t* out) {
    const uint32_t e = *reinterpret_cast<const uint32_t*>(s_tab4 + state4);
    const uint32_t nb = e >> 28;
    cur -= (int)nb;
    uint32_t mask;  // nb ones from bit SH
    asm("bmsk.clamp.b32 %0, %1, %2;" : "=r"(mask) : "n"(SH), "r"(nb));
    const uint32_t low =
        (uint32_t)((((uint64_t)hi << 32) | lo) >> cur) & mask;
    // e's low 20 bits are base << SH: the sum is right mod 2^(L + SH)
    state4 = (e + low) & mask4;
    *out = (uint8_t)(e >> 20);
  };
  auto refill = [&]() {  // predicated: the next word comes from the ring
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(ring_b + (rs & ring_mask));
    asm("{\n\t.reg .pred p;\n\t"
        "setp.lt.s32 p, %2, %6;\n\t"
        "@p mov.b32 %1, %0;\n\t"
        "@p mov.b32 %0, %4;\n\t"
        "@p add.s32 %2, %2, 32;\n\t"
        "@p sub.s32 %3, %3, %5;\n\t}"
        : "+r"(lo), "+r"(hi), "+r"(cur), "+r"(rs)
        : "r"(w), "r"(4u * T), "n"(TH));
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
      (uint8_t)(*reinterpret_cast<const uint32_t*>(s_tab4 + state4) >> 20);
  cursors[b * k + lane0 + tid] = row * 32 + cur + SH;
}

template <int T, int RF>
int launch(const void* words, const void* sizes, const void* dtab, void* syms,
           void* finals, void* cursors, int B, int W, int k, int L, int R,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(T, L);
  cudaError_t err = set_smem(pl_decode_kernel<T, RF>, smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    pl_decode_kernel<T, RF><<<dim3(k / T, nb), T, smem, stream>>>(
        (const uint32_t*)words, (const int32_t*)sizes, (const uint32_t*)dtab,
        (uint8_t*)syms, (uint8_t*)finals, (int32_t*)cursors, W, k, L, R, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int RF>
int launch_t(const void* words, const void* sizes, const void* dtab,
             void* syms, void* finals, void* cursors, int B, int W, int k,
             int L, int R, int T, cudaStream_t s) {
  switch (T) {
    case 512: return launch<512, RF>(words, sizes, dtab, syms, finals, cursors,
                                     B, W, k, L, R, s);
    case 256: return launch<256, RF>(words, sizes, dtab, syms, finals, cursors,
                                     B, W, k, L, R, s);
    case 128: return launch<128, RF>(words, sizes, dtab, syms, finals, cursors,
                                     B, W, k, L, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// words (B, W, k) u32, sizes (B, k) i32 bit counts, dtab (B, 2^L) u32 ->
// syms (B, R, k) u8, finals (B, k) u8, cursors (B, k) i32. T threads a CTA
// (128, 256 or 512, dividing k) and a refill check every RF rounds
// (2 while two rounds take at most 20 bits, L <= 10; else 1). Every pointer
// 16-byte aligned; W*k and R*k below 2^31. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was taken), or cudaErrorInvalidValue
// for a pick outside these.
extern "C" int ect_pl_decode(const void* words, const void* sizes,
                             const void* dtab, void* syms, void* finals,
                             void* cursors, int B, int W, int k, int L, int R,
                             int T, int RF, void* stream) {
  if (T <= 0 || k % T || (RF == 2 && L > 10)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (RF) {
    case 2: return launch_t<2>(words, sizes, dtab, syms, finals, cursors, B, W,
                               k, L, R, T, s);
    case 1: return launch_t<1>(words, sizes, dtab, syms, finals, cursors, B, W,
                               k, L, R, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
