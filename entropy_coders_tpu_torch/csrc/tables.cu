// D3: tANS encode and decode tables from normalized counts, for Hopper
// (sm_90a).
//
// Replaces entropy_coders_tpu/ops/tables.py:44-146 (spread_symbols_dev,
// build_encode_table, build_decode_table: XLA code, a masked scatter, a
// searchsorted and a stable argsort per block) and, on the host_tables=False
// route, the C++ builds of native/fse_native.cpp (build_encode,
// build_decode). Same function, byte for byte: from (B, 256) int32
// normalized counts at one table log L (count -1 = a low-probability symbol
// with one slot at the table's top), block b gets
//   dec[b, i]        = sym << 24 | nb << 16 | base        (2^L u32)
//   next_state[b, j] = 2^L + slot                         (2^L u16)
//   tt_bits[b, s], tt_fs[b, s]                            (256 u32, 256 i32)
// with the transforms of symbols >= table_len (one past the last nonzero
// count) left 0, as the reference leaves them.
//
// What bounds it: bytes, barely. A block reads 1 KiB and writes 6 * 2^L + 2
// KiB (8 KiB at L=10, 194 KiB at L=15); 1,024 blocks at L=10 move 9 MiB,
// ~3 us at 3.35 TB/s. The time goes to the one step that is not a map: the
// rank of a slot among the slots of its symbol in slot order (the
// reference's cumul[x]++ and symbol_next[sym]++ loops, the JAX stable
// argsort). No product anywhere: tensor cores play no part.
//
// The design: one CTA of 512 threads per block, everything in shared memory
// (the 2^L slot symbols as bytes, 32 KiB at L=15; 43 KiB static in all).
//   1. One warp scans the 256 counts (8 a lane, shuffles): the low symbols'
//      slots, the inclusive sums of the spread counts, each symbol's first
//      rank in the next-state table.
//   2. The spread visits positions (j * step) & (2^L - 1), j = 0, 1, ...,
//      and skips those above high_threshold. Each thread takes a contiguous
//      run of j, counts its valid positions, a block scan gives the run's
//      first rank, one binary search over the 256 sums its first symbol,
//      and the run then walks the sums linearly.
//   3. The ranks: warp w owns the contiguous slots [w, w + 1) * 2^L / 16.
//      __match_any_sync groups a warp's 32 slots by symbol, so a pass over
//      the chunk counts its slots per symbol (16 x 256 u16 counts, 8 KiB: a
//      count per 32 slots would be 512 KiB at L=15); 256 threads scan the
//      counts along the warps; a second pass hands out the ranks, 32 slots
//      a step, and writes dec (coalesced) and next_state (scattered u16
//      stores, absorbed by L2).
//   4. 256 threads compute the symbol transforms.
// Steps 2 and 3 are serial over 2^L / 512 positions a thread and 2^L / 512
// steps a warp: 64 at L=15, 2 at L=10.
//
// The counts must be a valid normalization (every count in [-1, 2^L], the
// slots summing to 2^L): the wrapper checks them on the host. The kernel
// stays inside its arrays whatever it is given.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLog = 15;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += a;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
build_tables_kernel(const int32_t* __restrict__ norm,
                    uint32_t* __restrict__ dec,
                    uint16_t* __restrict__ next_state,
                    uint32_t* __restrict__ tt_bits,
                    int32_t* __restrict__ tt_fs, int L) {
  __shared__ __align__(16) uint8_t symbols[1 << kMaxLog];
  __shared__ uint16_t seen[kWarps][256];  // per (warp chunk, symbol)
  __shared__ int32_t counts[256];
  __shared__ int32_t cum[256];    // inclusive sums of the spread counts
  __shared__ int32_t start[256];  // slots of the symbols before this one
  __shared__ int32_t warp_total[kWarps];
  __shared__ int32_t n_low_s, table_len_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int size = 1 << L, mask = size - 1;
  const size_t b = blockIdx.x;

  if (tid < 256) counts[tid] = norm[b * 256 + tid];
  for (int i = tid; i < size / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(symbols)[i] = 0;
  __syncthreads();

  // 1. the scans over the 256 counts
  if (warp == 0) {
    int low[8], spread[8], n_low = 0, n_spread = 0, last = -1;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int c = counts[8 * lane + j];
      low[j] = c == -1;
      spread[j] = c > 0 ? c : 0;
      n_low += low[j];
      n_spread += spread[j];
      if (c != 0) last = 8 * lane + j;
    }
    const int low_incl = warp_inclusive_sum(n_low, lane);
    const int spread_incl = warp_inclusive_sum(n_spread, lane);
    int low_before = low_incl - n_low, spread_before = spread_incl - n_spread;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int s = 8 * lane + j;
      // low-probability symbols walk down from the table's top
      if (low[j] && low_before < size) symbols[size - 1 - low_before] = s;
      start[s] = spread_before + low_before;
      spread_before += spread[j];
      low_before += low[j];
      cum[s] = spread_before;
    }
#pragma unroll
    for (int d = 16; d; d >>= 1)
      last = max(last, __shfl_xor_sync(kFull, last, d));
    const int total_low = __shfl_sync(kFull, low_incl, 31);
    if (lane == 0) {
      n_low_s = total_low;
      table_len_s = last + 1;
    }
  }
  __syncthreads();

  // 2. the spread
  {
    const int high = size - 1 - n_low_s;
    const int step = (size >> 1) + (size >> 3) + 3;
    const int run = size >= kThreads ? size / kThreads : 1;
    const int j0 = tid * run;
    int n_valid = 0;
    if (j0 < size)
      for (int j = j0; j < j0 + run; j++)
        n_valid += ((j * step) & mask) <= high;
    const int incl = warp_inclusive_sum(n_valid, lane);
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int rank = incl - n_valid;
    for (int w = 0; w < warp; w++) rank += warp_total[w];
    if (j0 < size && n_valid) {
      int lo = 0, hi = 255;  // the first symbol whose sum exceeds rank
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cum[mid] > rank) hi = mid; else lo = mid + 1;
      }
      int s = lo;
      for (int j = j0; j < j0 + run; j++) {
        const int p = (j * step) & mask;
        if (p <= high) {
          while (s < 255 && cum[s] <= rank) s++;
          symbols[p] = (uint8_t)s;
          rank++;
        }
      }
    }
  }
  __syncthreads();

  // 3. the rank of each slot among its symbol's slots, in slot order
  const int chunk = size >= 32 * kWarps ? size / kWarps : 32;
  const int c0 = warp * chunk;
  const int c1 = c0 + chunk < size ? c0 + chunk : size;
  for (int s = lane; s < 256; s += 32) seen[warp][s] = 0;
  __syncwarp();
  for (int i = c0 + lane; i < c1; i += 32) {  // whole warps: 32 | chunk
    const unsigned sym = symbols[i];
    const unsigned peers = __match_any_sync(kFull, sym);
    if (lane == __ffs(peers) - 1) seen[warp][sym] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  if (tid < 256) {
    int before = 0;
    for (int w = 0; w < kWarps; w++) {
      const int c = seen[w][tid];
      seen[w][tid] = (uint16_t)before;
      before += c;
    }
  }
  __syncthreads();
  for (int i = c0 + lane; i < c1; i += 32) {
    const unsigned sym = symbols[i];
    const unsigned peers = __match_any_sync(kFull, sym);
    const int within = seen[warp][sym] + __popc(peers & ((1u << lane) - 1));
    __syncwarp();
    if (lane == __ffs(peers) - 1) seen[warp][sym] += __popc(peers);
    __syncwarp();
    const int c = counts[sym];
    const int ns = (c == -1 ? 1 : c) + within;  // in [1, 2^(L+1))
    int nb = L - (31 - __clz(ns | 1));
    nb = nb < 0 ? 0 : nb;
    dec[b * size + i] = (sym << 24) | ((unsigned)nb << 16)
                        | ((((unsigned)ns << nb) - (unsigned)size) & 0xFFFFu);
    const int at = start[sym] + within;
    if (at < size) next_state[b * size + at] = (uint16_t)(size + i);
  }

  // 4. the symbol transforms
  if (tid < 256) {
    const int c = counts[tid];
    uint32_t bits = 0;
    int32_t fs = 0;
    if (tid < table_len_s) {
      const int total = start[tid];
      if (c == 0) {
        bits = (uint32_t)(((L + 1) << 16) - (1 << L));
      } else if (c == -1 || c == 1) {
        bits = (uint32_t)((L << 16) - (1 << L));
        fs = total - 1;
      } else if (c > 1) {
        const int max_bits_out = L - (31 - __clz(c - 1));
        bits = ((uint32_t)max_bits_out << 16)
               - ((uint32_t)c << (max_bits_out & 31));
        fs = total - c;
      }
    }
    tt_bits[b * 256 + tid] = bits;
    tt_fs[b * 256 + tid] = fs;
  }
}

}  // namespace

// norm (B, 256) i32 -> dec (B, 2^L) u32, next_state (B, 2^L) u16, tt_bits
// (B, 256) u32, tt_fs (B, 256) i32, every element written. L in 5..15.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an L outside that range.
extern "C" int ect_build_tables(const void* norm, void* dec, void* next_state,
                                void* tt_bits, void* tt_fs, int B, int L,
                                void* stream) {
  if (L < 5 || L > kMaxLog || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  build_tables_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)norm, (uint32_t*)dec, (uint16_t*)next_state,
      (uint32_t*)tt_bits, (int32_t*)tt_fs, L);
  return (int)cudaGetLastError();
}
