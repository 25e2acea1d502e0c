// D1 / D2: the lane repack of the MODE_FSE_PL container on the card, for
// Hopper (sm_90a): lane words (B, W, k) <-> the wire's concatenated lane
// streams.
//
// Replaces entropy_coders_tpu/ops/device_repack.py:56 (merge_bits_device)
// and :79 (split_bits_device), XLA code (two scatter-adds / two gathers per
// word at prefix-sum offsets, the prefix sum a jnp.cumsum outside), and
// covers the byte-aligned wire form too, which the JAX package only has on
// the host (native lane_merge_batch / lane_split_batch; the port's copies
// are the oracle these kernels are held against, byte for byte).
//
// Both wire forms are one function. Lane i of block b is a run of len bits:
// len = sizes[b, i] when the lanes are bit-packed (FLAG_PACKED), and
// 8 * ceil(sizes / 8) when they are byte-aligned, so that, as the host code
// does, a byte-aligned merge copies a lane's last byte whole (B2 leaves its
// dead bits zero) and a byte-aligned split keeps it whole (the container
// checks the dead bits). Bit j of the run is bit j & 31 of
// words[b, j >> 5, i]. A lane starts at the exclusive prefix sum of the
// lengths within its block; a block at a byte boundary after the blocks
// before it (merge) or at the given block_offs (split). Offsets are 64 bit:
// a 512 MiB call passes 2^32 bits.
//
// What bounds them: bytes. A merge reads the populated word rows and the
// sizes once and writes the payload once (at the throughput launch, 4
// blocks of 16 MiB at k=16384 and L=8: ~31 MB each way, ~0.02 ms at 3.35
// TB/s); a split the reverse, and it writes all W rows. No product: tensor
// cores play no part.
//
// The design: two launches a call and no other device work but the
// wrapper's allocations (no torch scan, no zero fill, no atomics).
//  1. lane_scan_kernel, a CTA a block: the sums of the block's 32-lane
//     groups (sizes read 16 bytes a thread, coalesced), their exclusive
//     scan (the group offsets, `goff`) and the block's payload bytes.
//  2. lane_merge_kernel / lane_split_kernel: a warp a unit of C 32-row
//     tiles of one group (C from the launch's size: enough warps to fill
//     the card; two tiles and a double buffer, one tile in flight while
//     the other is shifted, where there are enough). A warp issues every
//     load that waits on no other at once (its lanes' sizes, the group's
//     offset, the lane after each and, for the merge, its CTA's share of
//     the blocks before its block: a CTA's warps lie in one block), turns
//     the lengths into offsets with a shuffle scan, and keeps each lane's
//     values for a tile in shared memory. Tiles come in by 16-byte
//     cp.async. A warp past its group's streams stops after its loads.
//     (W, k) is lane-minor and the wire lane-major, so the repack is a
//     ragged transpose with a bit shift. The merge's tile holds 33 rows (the
//     next tile's first row feeds the funnel of the last word) with 16-byte
//     chunks XOR-swizzled by row, so that a thread reads its row of 4 lanes
//     as one conflict-free 16-byte load; thread t then forms the t-th wire
//     word of each lane from rows t and t + 1 (one funnel shift; a mask only
//     on the lane's last word; which words a lane stores in the tile is
//     counted once a tile) and stores it (32 consecutive words a warp).
//     Every wire word up to the payload's end is written once, by the lane
//     whose run holds the word's first bit (bit 32w is never a block's
//     padding: a block starts on a byte boundary). When the lane ends
//     inside the word, its owner ORs in the
//     first bits of the lane after it (kept from the warp's first loads)
//     or, when that lane is too short or in the next block, of the lanes
//     after it, read from row 0 of `words` (the zero padding to the block's
//     byte boundary stays zero).
//     The split copies each lane's 33 wire words from a 16-byte boundary,
//     forms row t of all 32 lanes in thread t's registers, stages the rows
//     in the same buffer (swizzled) and stores every row 16 bytes a thread,
//     the zero rows past the group's streams too (B1 reads them).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;          // warps a repack CTA
constexpr int kScanThreads = 512;  // threads a scan CTA
constexpr int kMaxGroups = 2048;   // k / 32: k < 65536 (the frame's u16)
constexpr int kMaxScanCtas = 4096;
constexpr int kTileRows = 33;      // a merge tile's rows: 32 and the next one
constexpr int kLaneWords = 36;     // a split tile's words a lane: 33 from a
                                   // 16-byte boundary
constexpr unsigned kFull = 0xFFFFFFFFu;

// 16-byte asynchronous copy global -> shared of the first `src_bytes` of
// `gmem`, the rest of the 16 zero-filled (sm_80+)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the one committed last has landed
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ int lane_len(int size, int pack) {
  size = size < 0 ? 0 : size;
  return pack ? size : ((size + 7) >> 3) << 3;
}

// the low `rem` bits of v (all of them from 32 on, none at 0 or below)
__device__ __forceinline__ uint32_t keep_bits(uint32_t v, int rem) {
  return rem >= 32 ? v : rem > 0 ? v & ((1u << rem) - 1u) : 0u;
}

__device__ __forceinline__ uint32_t pick(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// 16-byte chunk c of row r of a swizzled 32-lane tile: no two of 8
// consecutive rows put the same chunk in the same banks
__device__ __forceinline__ int swz(int r, int c) {
  return (c ^ (r & 7)) << 2;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// ---- 1. the scan ------------------------------------------------------------

// sizes (B, k) -> goff (B, k/32): each 32-lane group's first bit within its
// block; bytes (B,): each block's payload bytes (nullptr: not wanted).
// The sizes come in 16 bytes a thread, coalesced, 8 threads a group.
__global__ void __launch_bounds__(kScanThreads)
lane_scan_kernel(const int32_t* __restrict__ sizes, int B, int k, int pack,
                 long long* __restrict__ goff, long long* __restrict__ bytes) {
  __shared__ long long gsum[kMaxGroups];
  __shared__ long long wsum[kScanThreads / 32];
  const int G = k >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (G + kScanThreads - 1) / kScanThreads;
  const int g0 = threadIdx.x * per;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int4* s = reinterpret_cast<const int4*>(sizes + (size_t)b * k);
#pragma unroll 8
    for (int i = threadIdx.x; i < k / 4; i += kScanThreads) {
      // k / 4 is a multiple of 32: a warp is in or out whole
      const int4 v = __ldg(s + i);
      long long t = (long long)lane_len(v.x, pack) + lane_len(v.y, pack) +
                    lane_len(v.z, pack) + lane_len(v.w, pack);
      t += __shfl_xor_sync(kFull, t, 1);
      t += __shfl_xor_sync(kFull, t, 2);
      t += __shfl_xor_sync(kFull, t, 4);
      if ((i & 7) == 0) gsum[i >> 3] = t;
    }
    __syncthreads();
    long long run = 0;  // this thread's `per` groups
    for (int j = 0; j < per && g0 + j < G; j++) run += gsum[g0 + j];
    long long inc = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    long long acc = inc - run, total = 0;
    for (int w = 0; w < kScanThreads / 32; w++) {
      if (w < warp) acc += wsum[w];
      total += wsum[w];
    }
    for (int j = 0; j < per && g0 + j < G; j++) {
      const long long v = gsum[g0 + j];
      goff[(size_t)b * G + g0 + j] = acc;
      acc += v;
    }
    if (bytes != nullptr && threadIdx.x == 0) bytes[b] = (total + 7) >> 3;
    __syncthreads();  // gsum and wsum serve the next block
  }
}

// ---- 2. the repack ----------------------------------------------------------

// A warp's unit of work: `C` consecutive 32-row tiles of one 32-lane group
// of one block. Units go in (chunk, block, group) order: a CTA's kWarps
// units are one chunk of neighbouring groups of one block (k / 32 is a
// multiple of 4), so that the CTAs of chunks past every stream (most of
// them where W is far above the rows in use) end at once, and a CTA moves
// whole rows of 4 x 128 bytes.
struct Unit {
  int b, g, t_lo, t_hi;  // tiles [t_lo, t_hi) of group g of block b
};

__device__ __forceinline__ Unit unit_of(long long u, int B, int G, int C,
                                        int T) {
  Unit it;
  it.g = (int)(u % G);
  it.b = (int)((u / G) % B);
  it.t_lo = (int)(u / ((long long)G * B)) * C;
  it.t_hi = min(it.t_lo + C, T);
  return it;
}

// this lane's length in the wire form and the group's rows (up to its
// longest stream, not cut to W)
__device__ __forceinline__ int group_rows(int len) {
  int mx = len;
#pragma unroll
  for (int d = 16; d; d >>= 1) mx = max(mx, __shfl_xor_sync(kFull, mx, d));
  return (mx + 31) >> 5;
}

// the lane's first bit: the group's offset in its block (`goff`), the
// lanes before it in the group (a shuffle scan) and the block's first byte
__device__ __forceinline__ long long lane_first_bit(int len, long long gof,
                                                    long long blk) {
  const int lane = threadIdx.x & 31;
  long long inc = len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  return 8 * blk + gof + inc - len;
}

// A merge warp's shared memory: its lanes' values for each buffered tile
// and the lane after each, then `nbuf` tiles of kTileRows rows (swizzled
// 16-byte chunks).
struct MergeLanes {
  int4 tile[2][32];  // first owned word (lo, hi), words to store | shift to
                     // the word grid << 8, the lane's bits from row 0
  int next_len[32];  // the next lane's length and first word
  uint32_t next_word[32];
};
constexpr int kTileWords = kTileRows * 32;

__host__ __device__ constexpr size_t merge_warp_bytes(int nbuf) {
  return sizeof(MergeLanes) + (size_t)nbuf * kTileWords * 4;
}

// The owner of a wire word whose lane ends inside it, when the lane after
// it is too short to fill the word or lies in the next block: OR in the
// lanes after it, from bit `cur` (the lane's end) to `lim` (the word's end),
// starting at lane `i` of block `b` whose first byte is `blk`.
__device__ uint32_t fill_tail(uint32_t word, long long cur, long long lim,
                              int b, int i, long long blk,
                              const uint32_t* __restrict__ words,
                              const int32_t* __restrict__ sizes,
                              const long long* __restrict__ bytes, int B,
                              int W, int k, int pack) {
  while (cur < lim) {
    if (i == k) {  // the block ends: zero padding up to the next byte
      blk += bytes[b];
      cur = 8 * blk;
      if (++b >= B) break;
      i = 0;
      continue;
    }
    const int len = lane_len(sizes[(size_t)b * k + i], pack);
    if (len > 0) {
      const long long room = lim - cur;
      const uint32_t v = keep_bits(words[(size_t)b * W * k + i],
                                   len < room ? len : (int)room);
      word |= v << (int)(cur - (lim - 32));
      cur += len;
    }
    i++;
  }
  return word;
}

__global__ void __launch_bounds__(kWarps * 32)
lane_merge_kernel(const uint32_t* __restrict__ words,
                  const int32_t* __restrict__ sizes,
                  const long long* __restrict__ goff,
                  const long long* __restrict__ bytes,
                  long long* __restrict__ offs, uint32_t* __restrict__ out,
                  long long n_out, int B, int W, int k, int pack, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long red[kWarps];
  const int G = k >> 5, T = (W + 31) >> 5, n_chunks = (T + C - 1) / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* base = smem_raw + warp * merge_warp_bytes(C > 1 ? 2 : 1);
  MergeLanes& ml = *reinterpret_cast<MergeLanes*>(base);
  uint32_t* tiles = reinterpret_cast<uint32_t*>(base + sizeof(MergeLanes));
  const long long n_units = (long long)B * G * n_chunks;
  const long long u0 = (long long)blockIdx.x * kWarps, u = u0 + warp;
  const bool live = u < n_units;
  const Unit it = unit_of(live ? u : u0, B, G, C, T);
  const int b_cta = (int)((u0 / G) % B);

  // every load that waits on no other, together: the CTA's share of the
  // blocks before its block, the lane's size, the next lane's size and
  // first word, the group's offset
  long long before = 0;
  for (int i = threadIdx.x; i < b_cta; i += kWarps * 32) before += bytes[i];
  const int col = it.g * 32 + lane;
  const int32_t* sz = sizes + (size_t)it.b * k;
  const bool more = col + 1 < k;  // the next lane is in this block
  const int size = sz[col];
  const int next_size = more && lane == 31 ? sz[col + 1] : 0;
  const uint32_t next_word = more ? words[(size_t)it.b * W * k + col + 1] : 0u;
  const long long gof = goff[(size_t)it.b * G + it.g];
  const long long block_bytes = bytes[it.b];

  const int len = lane_len(size, pack);
  const int n_rows = group_rows(len);
  const int t_hi = live ? min(it.t_hi, (n_rows + 31) >> 5) : it.t_lo;
  const uint32_t* src = words + (size_t)it.b * W * k + it.g * 32;
  // tile t's rows on their way (rows past W, a size past 32 W, as zeros)
  auto issue_rows = [&](int t, int buf) {
    uint32_t* tile = tiles + buf * kTileWords;
    for (int j = lane; j < kTileRows * 8; j += 32) {
      const int r = j >> 3, c = j & 7, row = 32 * t + r;
      if (row >= n_rows) break;
      const bool in = row < W;
      cp_async16(tile + r * 32 + swz(r, c),
                 in ? src + (size_t)row * k + c * 4 : src, in ? 16 : 0);
    }
    cp_async_commit();
  };
  if (it.t_lo < t_hi) issue_rows(it.t_lo, 0);

  before = warp_sum(before);
  if (lane == 0) red[warp] = before;
  __syncthreads();
  long long blk = 0;  // the block's first byte
  for (int w = 0; w < kWarps; w++) blk += red[w];
  if (live && it.g == 0 && it.t_lo == 0 && lane == 0) {
    if (it.b == 0) offs[0] = 0;
    offs[it.b + 1] = blk + block_bytes;
  }
  if (it.t_lo >= t_hi) return;  // uniform: past the group's streams

  const int up = __shfl_down_sync(kFull, len, 1);
  ml.next_len[lane] = !more ? -1 : lane == 31 ? lane_len(next_size, pack) : up;
  ml.next_word[lane] = next_word;
  const long long off = lane_first_bit(len, gof, blk);
  // this lane's values for tile t: word j of the tile holds its bits from
  // sp + 32 j on (rows j and j + 1), for the j whose first bit is one of
  // them, and not past n_out
  auto lane_values = [&](int t, int buf) {
    const long long tile_lo = off + 1024LL * t;
    const int sp = (int)(-tile_lo & 31), rem_end = len - 1024 * t;
    const long long w0 = (tile_lo + sp) >> 5;
    const int e = min(rem_end, 1024) - sp;
    const long long n = min(e > 0 ? (long long)((e + 31) >> 5) : 0LL,
                            max(n_out - w0, 0LL));
    ml.tile[buf][lane] = make_int4((int)(w0 & 0xFFFFFFFF), (int)(w0 >> 32),
                                   (int)n | sp << 8, rem_end);
  };
  lane_values(it.t_lo, 0);

  for (int t = it.t_lo; t < t_hi; t++) {
    const int buf = (t - it.t_lo) & 1;
    if (t + 1 < t_hi) {
      lane_values(t + 1, buf ^ 1);
      issue_rows(t + 1, buf ^ 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait1();
    __syncwarp();
    const uint32_t* tile = tiles + buf * kTileWords;
#pragma unroll 1
    for (int c = 0; c < 8; c++) {
      // rows `lane` and `lane` + 1 of lanes 4c .. 4c + 3
      const uint4 x = *reinterpret_cast<const uint4*>(
          tile + lane * 32 + swz(lane, c));
      const uint4 y = *reinterpret_cast<const uint4*>(
          tile + (lane + 1) * 32 + swz(lane + 1, c));
#pragma unroll
      for (int q = 0; q < 4; q++) {
        const int l = 4 * c + q;
        const int4 m = ml.tile[buf][l];
        if (lane >= (m.z & 0xFF)) continue;  // no word of lane l here
        const int sp = m.z >> 8;
        uint32_t word = __funnelshift_r(pick(x, q), pick(y, q), sp);
        const long long w = ((long long)m.y << 32 | (unsigned)m.x) + lane;
        // bits of the word past lane l's end (fewer than 32: the word's
        // first bit is lane l's), which the lanes after it fill
        const int room = sp + 32 * lane + 32 - m.w;
        if (room > 0) {
          word &= (1u << (32 - room)) - 1u;
          if (ml.next_len[l] >= room)  // the next lane fills the word
            word |= ml.next_word[l] << (32 - room);
          else
            word = fill_tail(word, 32 * w + 32 - room, 32 * w + 32, it.b,
                             it.g * 32 + l + 1, blk, words, sizes, bytes, B,
                             W, k, pack);
        }
        out[w] = word;
      }
    }
    __syncwarp();
  }
}

// A split warp's shared memory: its lanes' values for each buffered tile,
// then `nbuf` buffers of each lane's wire words (33 from a 16-byte
// boundary), which also stage the tile's rows on their way out.
struct SplitLanes {
  int4 tile[2][32];  // first 16-byte chunk (lo, hi), the lane's bits from
                     // the tile's row 0, shift | word in chunk | chunks
};
constexpr int kLaneBufWords = 32 * kLaneWords;

__host__ __device__ constexpr size_t split_warp_bytes(int nbuf) {
  return sizeof(SplitLanes) + (size_t)nbuf * kLaneBufWords * 4;
}

__global__ void __launch_bounds__(kWarps * 32)
lane_split_kernel(const uint32_t* __restrict__ packed, long long n_packed,
                  const int32_t* __restrict__ sizes,
                  const long long* __restrict__ block_offs,
                  const long long* __restrict__ goff,
                  uint32_t* __restrict__ words, int B, int W, int k, int pack,
                  int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = k >> 5, T = (W + 31) >> 5, n_chunks = (T + C - 1) / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* base = smem_raw + warp * split_warp_bytes(C > 1 ? 2 : 1);
  SplitLanes& sl = *reinterpret_cast<SplitLanes*>(base);
  uint32_t* bufs = reinterpret_cast<uint32_t*>(base + sizeof(SplitLanes));
  const long long u = (long long)blockIdx.x * kWarps + warp;
  if (u >= (long long)B * G * n_chunks) return;
  const Unit it = unit_of(u, B, G, C, T);
  // the loads that wait on no other, together
  const int size = sizes[(size_t)it.b * k + it.g * 32 + lane];
  const long long gof = goff[(size_t)it.b * G + it.g];
  const long long first = block_offs[it.b];
  const int len = lane_len(size, pack);
  const int n_rows = group_rows(len);
  const int t_pop = min(it.t_hi, (n_rows + 31) >> 5);  // tiles with bits
  uint32_t* dst = words + (size_t)it.b * W * k + it.g * 32;

  if (it.t_lo < t_pop) {
    const long long off = lane_first_bit(len, gof, first);
    // this lane's values for tile t, then every lane's words on their way
    auto issue = [&](int t, int buf) {
      const int rem_end = len - 1024 * t;
      const long long tile_lo = off + 1024LL * t;
      const long long a = (tile_lo >> 5) & ~3LL;  // first 16-byte chunk
      const long long e =  // the last word holding a bit of the tile
          (tile_lo + (rem_end < 1024 ? rem_end : 1024) - 1) >> 5;
      const int n_ch = rem_end > 0 ? (int)((e - a) >> 2) + 1 : 0;
      sl.tile[buf][lane] = make_int4(
          (int)(a & 0xFFFFFFFF), (int)(a >> 32), rem_end,
          (int)(tile_lo & 31) | (int)((tile_lo >> 5) & 3) << 8 | n_ch << 16);
      __syncwarp();
      uint32_t* in = bufs + buf * kLaneBufWords;
      for (int j = lane; j < 32 * 9; j += 32) {
        const int l = j / 9, c = j - 9 * l;
        const int4 m = sl.tile[buf][l];
        if (c >= (m.w >> 16)) continue;
        const long long at = ((long long)m.y << 32 | (unsigned)m.x) + 4 * c;
        const long long left = (n_packed - at) * 4;  // reads past are zeros
        const int nb = left >= 16 ? 16 : left > 0 ? (int)left : 0;
        cp_async16(in + l * kLaneWords + 4 * c, nb ? packed + at : packed,
                   nb);
      }
      cp_async_commit();
    };

    issue(it.t_lo, 0);
    for (int t = it.t_lo; t < t_pop; t++) {
      const int buf = (t - it.t_lo) & 1;
      if (t + 1 < t_pop)
        issue(t + 1, buf ^ 1);
      else
        cp_async_commit();
      cp_async_wait1();
      __syncwarp();
      uint32_t* in = bufs + buf * kLaneBufWords;
      uint32_t v[32];  // row `lane` of the tile, lane by lane
#pragma unroll
      for (int l = 0; l < 32; l++) {
        const int4 m = sl.tile[buf][l];
        v[l] = 0;
        if (m.z <= 0) continue;  // uniform: the lane ended before
        const uint32_t* lw = in + l * kLaneWords + ((m.w >> 8) & 3) + lane;
        const uint32_t w = __funnelshift_r(lw[0], lw[1], m.w & 31);
        const int rem = m.z - 32 * lane;
        v[l] = rem < 32 ? keep_bits(w, rem) : w;
      }
      __syncwarp();  // every lane's words are read: the buffer stages rows
#pragma unroll
      for (int c = 0; c < 8; c++)
        *reinterpret_cast<uint4*>(in + lane * 32 + swz(lane, c)) =
            make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
      __syncwarp();
      const int r0 = 32 * t, rows = W - r0 < 32 ? W - r0 : 32;
      for (int j = lane; j < rows * 8; j += 32) {
        const int r = j >> 3, c = j & 7;
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * k + 4 * c) =
            *reinterpret_cast<const uint4*>(in + r * 32 + swz(r, c));
      }
      __syncwarp();
    }
  }
  // the unit's rows past every stream of the group: zeros
  const int z0 = 32 * max(it.t_lo, t_pop), z1 = min(32 * it.t_hi, W);
  for (int j = lane; j < (z1 - z0) * 8; j += 32)
    *reinterpret_cast<uint4*>(dst + (size_t)(z0 + (j >> 3)) * k +
                              4 * (j & 7)) = make_uint4(0u, 0u, 0u, 0u);
}

// the repack's CTAs for units of C tiles
long long repack_ctas(int B, int k, int W, int C) {
  const int T = (W + 31) / 32;
  return ((long long)B * (k / 32) * ((T + C - 1) / C) + kWarps - 1) / kWarps;
}

// Tiles a warp takes: two (one in flight while the other is shifted), or
// more when that still leaves the card's warps busy a few times over (4 x
// 132 SMs x 32 warps); at most every tile of a group.
int tiles_per_unit(int B, int G, int T) {
  const long long tiles = (long long)B * G * T, target = 4LL * 132 * 32;
  const long long c = (tiles + target - 1) / target;
  return (int)(c < 2 ? (T < 2 ? 1 : 2) : c > T ? T : c);
}

// Sets `smem` bytes of dynamic shared memory on `kernel`, once a device.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

bool bad_shape(int B, int W, int k) {
  return B < 0 || W < 0 || k <= 0 || k % 128 || k / 32 > kMaxGroups;
}

cudaError_t launch_scan(const void* sizes, int B, int k, int pack, void* goff,
                        void* bytes, cudaStream_t stream) {
  const int grid = B < kMaxScanCtas ? B : kMaxScanCtas;
  lane_scan_kernel<<<grid, kScanThreads, 0, stream>>>(
      (const int32_t*)sizes, B, k, pack, (long long*)goff, (long long*)bytes);
  return cudaGetLastError();
}

}  // namespace

// words (B, W, k) u32 and sizes (B, k) i32, both 16-byte aligned -> out:
// n_out u32 words (at least the payloads' and at most 4 B W k bytes),
// every word up to the last payload byte written (the bits past it in its
// word zero, the words after it untouched); meta: (2 B + 1 + B k / 32) i64
// of which the first B + 1 become offs (each block's first byte, the total
// last) and the rest is scratch. pack != 0: sizes bits a lane, else whole
// bytes. k a multiple of 128 below 65536. Two launches on `stream`;
// returns the first CUDA error.
extern "C" int ect_lane_merge(const void* words, const void* sizes, void* out,
                              long long n_out, void* meta, int B, int W, int k,
                              int pack, void* stream) {
  if (bad_shape(B, W, k) || n_out < 0 || (uintptr_t)words % 16 ||
      (uintptr_t)sizes % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  long long* offs = (long long*)meta;
  long long* bytes = offs + B + 1;
  long long* goff = bytes + B;
  const cudaStream_t s = (cudaStream_t)stream;
  const int C = tiles_per_unit(B, k / 32, (W + 31) / 32);
  const size_t smem = kWarps * merge_warp_bytes(C > 1 ? 2 : 1);
  cudaError_t err = set_smem(lane_merge_kernel, kWarps * merge_warp_bytes(2));
  if (err == cudaSuccess) err = launch_scan(sizes, B, k, pack, goff, bytes, s);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = repack_ctas(B, k, W, C);
  if (ctas > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  lane_merge_kernel<<<(unsigned)ctas, kWarps * 32, smem, s>>>(
      (const uint32_t*)words, (const int32_t*)sizes, goff, bytes, offs,
      (uint32_t*)out, n_out, B, W, k, pack, C);
  return (int)cudaGetLastError();
}

// packed: n_packed u32 words of the flat buffer and sizes (B, k) i32, both
// 16-byte aligned; block_offs (B,) i64 (each block's first byte in
// `packed`); goff: B k / 32 i64 of scratch -> words (B, W, k) u32, every
// row written, the bits past a lane's length zero. Reads past n_packed
// give zeros. Two launches on `stream`; returns the first CUDA error.
extern "C" int ect_lane_split(const void* packed, long long n_packed,
                              const void* sizes, const void* block_offs,
                              void* goff, void* words, int B, int W, int k,
                              int pack, void* stream) {
  if (bad_shape(B, W, k) || n_packed < 0 || (uintptr_t)packed % 16 ||
      (uintptr_t)sizes % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int C = tiles_per_unit(B, k / 32, (W + 31) / 32);
  const size_t smem = kWarps * split_warp_bytes(C > 1 ? 2 : 1);
  cudaError_t err = set_smem(lane_split_kernel, kWarps * split_warp_bytes(2));
  if (err == cudaSuccess)
    err = launch_scan(sizes, B, k, pack, goff, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = repack_ctas(B, k, W, C);
  if (ctas > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  lane_split_kernel<<<(unsigned)ctas, kWarps * 32, smem, s>>>(
      (const uint32_t*)packed, n_packed, (const int32_t*)sizes,
      (const long long*)block_offs, (const long long*)goff, (uint32_t*)words,
      B, W, k, pack, C);
  return (int)cudaGetLastError();
}
