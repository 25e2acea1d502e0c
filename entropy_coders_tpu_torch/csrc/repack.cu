// D1 / D2: the lane repack of the MODE_FSE_PL container on the card, for
// Hopper (sm_90a): lane words (B, W, k) <-> the wire's concatenated lane
// streams.
//
// Replaces entropy_coders_tpu/ops/device_repack.py:56 (merge_bits_device)
// and :79 (split_bits_device), XLA code (two scatter-adds / two gathers per
// word at prefix-sum offsets), and covers the byte-aligned wire form too,
// which the JAX package only has on the host (native lane_merge_batch /
// lane_split_batch; the port's copies are the oracle these kernels are held
// against, byte for byte).
//
// Both wire forms are one function. Lane i of block b is a run of len bits
// that starts at bit `bit_off[b, i]` of the flat buffer: len = sizes[b, i]
// when the lanes are bit-packed (FLAG_PACKED), and 8 * ceil(sizes / 8) when
// they are byte-aligned, so that, as the host code does, a byte-aligned
// merge copies a lane's last byte whole (B2 leaves its dead bits zero) and a
// byte-aligned split keeps it whole (the container checks the dead bits).
// Bit j of the run is bit j & 31 of words[b, j >> 5, i]. The offsets are a
// prefix sum of the lengths, taken outside the kernels (torch.cumsum in
// int64, as jnp.cumsum is outside any kernel in the JAX module); they are 64
// bit: a 512 MiB call passes 2^32 bits.
//
// What bounds them: bytes. A merge reads the populated word rows once and
// writes the payload once (at the throughput launch, 4 blocks of 16 MiB at
// k=16384 and L=8: ~31 MB each way, ~0.02 ms at 3.35 TB/s); a split the
// reverse, and it writes all W rows. No product: tensor cores play no part.
//
// The design. (W, k) is lane-minor, the wire is lane-major: the repack is a
// ragged transpose with a bit shift. A warp takes a tile of 32 lanes x 32
// word rows and turns it through shared memory (33-word rows, no bank
// conflict either way): the word rows move as 128-byte lines, and on the
// wire side the warp's 32 threads handle 32 consecutive words of ONE lane,
// so a lane's bytes move as 128-byte lines too (shifted by the lane's bit
// offset & 31, a funnel of two neighbouring words through one shuffle).
// Merge: a word of the flat buffer that lies wholly inside this tile's bit
// range is stored plainly; a word shared with the previous or next lane or
// tile (byte-aligned: up to 3 bytes; packed: any bit) is OR-ed in with
// atomicOr into the zeroed buffer. The bit ranges are disjoint, so no order
// matters and no bit is lost. Split: two loads and a funnel shift, masked to
// the lane's length; every row of the tile is written, rows past the lanes'
// streams as zeros (B1 reads them).
// Warps stride over the row tiles of their 32 lanes, up to 8 warps a lane
// group, and skip tiles past the group's longest stream (W is a bound: at
// the throughput launch half of the rows are populated).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps a CTA, each on its own tile
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Work {
  int b, g, slot;
};

// which (block, group of 32 lanes, first row tile) this warp takes
__device__ __forceinline__ bool work_item(int groups, int slots,
                                          long long total, Work* w) {
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= total) return false;
  w->slot = (int)(item % slots);
  w->g = (int)((item / slots) % groups);
  w->b = (int)(item / ((long long)slots * groups));
  return true;
}

__device__ __forceinline__ int lane_len(int size, int pack) {
  size = size < 0 ? 0 : size;
  return pack ? size : ((size + 7) >> 3) << 3;
}

__device__ __forceinline__ uint32_t keep_bits(uint32_t v, int rem) {
  return rem >= 32 ? v : rem > 0 ? v & ((1u << rem) - 1u) : 0u;
}

__global__ void __launch_bounds__(kWarps * 32)
lane_merge_kernel(const uint32_t* __restrict__ words,
                  const int32_t* __restrict__ sizes,
                  const long long* __restrict__ bit_off, uint32_t* out,
                  long long n_out, int W, int k, int pack, int slots,
                  long long total) {
  __shared__ uint32_t tiles[kWarps][32][33];
  Work w;
  if (!work_item(k / 32, slots, total, &w)) return;
  uint32_t (*tile)[33] = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const size_t col = (size_t)w.g * 32 + lane;
  const int my_len = lane_len(sizes[(size_t)w.b * k + col], pack);
  const long long my_off = bit_off[(size_t)w.b * k + col];
  int max_len = my_len;
#pragma unroll
  for (int d = 16; d; d >>= 1)
    max_len = max(max_len, __shfl_xor_sync(kFull, max_len, d));
  int n_rows = (max_len + 31) >> 5;
  n_rows = n_rows < W ? n_rows : W;
  const uint32_t* src = words + (size_t)w.b * W * k + col;

  for (int r0 = w.slot * 32; r0 < n_rows; r0 += slots * 32) {
#pragma unroll 8
    for (int j = 0; j < 32; j++)
      tile[j][lane] = r0 + j < n_rows ? src[(size_t)(r0 + j) * k] : 0u;
    __syncwarp();
    for (int l = 0; l < 32; l++) {
      const int len = __shfl_sync(kFull, my_len, l);
      if (len <= r0 * 32) continue;  // uniform: the lane ended before
      const long long tile_lo = __shfl_sync(kFull, my_off, l) + 32LL * r0;
      const long long tile_hi =
          tile_lo + (len - r0 * 32 < 1024 ? len - r0 * 32 : 1024);
      const uint32_t v = keep_bits(tile[lane][l], len - 32 * (r0 + lane));
      const int s = (int)(tile_lo & 31);
      const long long at = (tile_lo >> 5) + lane;
      uint32_t prev = __shfl_up_sync(kFull, v, 1);
      if (lane == 0) prev = 0;
      const uint32_t word = (v << s) | (s ? prev >> (32 - s) : 0u);
      if (at < n_out) {
        if (at * 32 >= tile_lo && at * 32 + 32 <= tile_hi)
          out[at] = word;
        else if (word)
          atomicOr(out + at, word);
      }
      if (lane == 31 && s && at + 1 < n_out) {
        const uint32_t spill = v >> (32 - s);
        if (spill) atomicOr(out + at + 1, spill);
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kWarps * 32)
lane_split_kernel(const uint32_t* __restrict__ packed, long long n_packed,
                  const int32_t* __restrict__ sizes,
                  const long long* __restrict__ bit_off,
                  uint32_t* __restrict__ words, int W, int k, int pack,
                  int slots, long long total) {
  __shared__ uint32_t tiles[kWarps][32][33];
  Work w;
  if (!work_item(k / 32, slots, total, &w)) return;
  uint32_t (*tile)[33] = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const size_t col = (size_t)w.g * 32 + lane;
  const int my_len = lane_len(sizes[(size_t)w.b * k + col], pack);
  const long long my_off = bit_off[(size_t)w.b * k + col];
  int max_len = my_len;
#pragma unroll
  for (int d = 16; d; d >>= 1)
    max_len = max(max_len, __shfl_xor_sync(kFull, max_len, d));
  const int n_rows = (max_len + 31) >> 5;
  uint32_t* dst = words + (size_t)w.b * W * k + col;

  for (int r0 = w.slot * 32; r0 < W; r0 += slots * 32) {
    if (r0 < n_rows) {
      for (int l = 0; l < 32; l++) {
        const int len = __shfl_sync(kFull, my_len, l);
        const long long tile_lo = __shfl_sync(kFull, my_off, l) + 32LL * r0;
        const int rem = len - 32 * (r0 + lane);
        const int s = (int)(tile_lo & 31);
        const long long at = (tile_lo >> 5) + lane;
        // this thread's word, or the high bits of the thread before
        uint32_t p = rem > -32 && at >= 0 && at < n_packed
                         ? __ldg(packed + at) : 0u;
        uint32_t next = __shfl_down_sync(kFull, p, 1);
        if (lane == 31)
          next = rem > 0 && s && at + 1 < n_packed ? __ldg(packed + at + 1)
                                                   : 0u;
        const uint32_t v = (p >> s) | (s ? next << (32 - s) : 0u);
        tile[lane][l] = keep_bits(v, rem);
      }
      __syncwarp();
#pragma unroll 8
      for (int j = 0; j < 32; j++)
        if (r0 + j < W) dst[(size_t)(r0 + j) * k] = tile[j][lane];
      __syncwarp();
    } else {
      for (int j = 0; j < 32 && r0 + j < W; j++)
        dst[(size_t)(r0 + j) * k] = 0u;
    }
  }
}

// warps a lane group: one per 32-row tile of the W rows, at most 8
inline int row_slots(int W) {
  const int tiles = (W + 31) / 32;
  return tiles < 8 ? (tiles < 1 ? 1 : tiles) : 8;
}

}  // namespace

// words (B, W, k) u32, sizes (B, k) i32, bit_off (B, k) i64 (each lane's
// first bit in `out`) -> out: n_out u32 words, zeroed by the caller, into
// which every lane's bits are written (pack != 0: sizes bits a lane, else
// whole bytes). k a multiple of 32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ect_lane_merge(const void* words, const void* sizes,
                              const void* bit_off, void* out,
                              long long n_out, int B, int W, int k, int pack,
                              void* stream) {
  if (B < 0 || W < 0 || k <= 0 || k % 32 || n_out < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  const int slots = row_slots(W);
  const long long total = (long long)B * (k / 32) * slots;
  const long long ctas = (total + kWarps - 1) / kWarps;
  if (ctas > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  lane_merge_kernel<<<(unsigned)ctas, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)sizes,
      (const long long*)bit_off, (uint32_t*)out, n_out, W, k, pack, slots,
      total);
  return (int)cudaGetLastError();
}

// packed: n_packed u32 words of the flat buffer; sizes (B, k) i32; bit_off
// (B, k) i64 (each lane's first bit in `packed`) -> words (B, W, k) u32,
// every row written, the bits past a lane's length zero. Reads past
// n_packed give zeros. Launches on `stream` and returns cudaGetLastError().
extern "C" int ect_lane_split(const void* packed, long long n_packed,
                              const void* sizes, const void* bit_off,
                              void* words, int B, int W, int k, int pack,
                              void* stream) {
  if (B < 0 || W < 0 || k <= 0 || k % 32 || n_packed < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  const int slots = row_slots(W);
  const long long total = (long long)B * (k / 32) * slots;
  const long long ctas = (total + kWarps - 1) / kWarps;
  if (ctas > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  lane_split_kernel<<<(unsigned)ctas, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, n_packed, (const int32_t*)sizes,
      (const long long*)bit_off, (uint32_t*)words, W, k, pack, slots, total);
  return (int)cudaGetLastError();
}
