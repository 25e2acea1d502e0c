// B4/B5: the per-lane tANS decode with a pluggable decode-table entry format,
// for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the decode-layout measurement tools:
// tools/l10_attack.py::make_kernel(...).kern (B4) and
// tools/l10_attack_harness.py::make_kernel(...).kern (B5). Both are B1's lane
// decode (entropy_coders_tpu/ops/pl_coder.py::_decode_kernel) with the table
// lookup made pluggable: an entry_fn(tbl, states) -> (nb, base, sym) decides
// how a decode entry is stored and unpacked. Their bodies are the same text,
// so one kernel templated on the entry format ports both. The formats:
//
//   flat   4 bytes: u32 sym << 24 | nb << 16 | base        (B1's own; control)
//   split  3 bytes: u16 nb << 12 | base plane, u8 sym plane (L <= 12)
//   upack  2 bytes: u16 sym << 9 | u, u the spread-source state (u < 512):
//          nb = L - ilog2(u), base = (u << nb) - 2^L
//   fused  4 bytes: u32 sym << (L + 4) | nb << L | base
//   nosym  2 bytes: the u16 nb << 12 | base plane alone; sym = half & 0xFF,
//          wrong bytes by design (the bound for any layout that still
//          fetches (nb, base))
//
// Everything else is B1 (csrc/pl_decode.cu): one thread per lane, the
// block's table in dynamic shared memory, a 64-bit bit buffer refilled one
// 32-bit word at a time from the lane's own word column, rows outside [0, W)
// read as zero, states masked to L bits. The TPU's octo-chunk refill,
// REFILL_QW windows, epochs and gather rows are left behind.
//
// What bounds it on the card: like B1, the latency of each lane's dependent
// chain (table lookup, bit read, next state) and how many chains are in
// flight. The table is copied into the shared memory of every 128-thread
// CTA, so its size per entry sets how many CTAs an SM can hold from L = 12
// up (4 KiB of flat table at L = 10, 32 KiB at L = 13, 128 KiB at L = 15).
// The formats trade that size against the instructions of the unpack step;
// this kernel exists to measure that trade on the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // k is a multiple of 128 (checked by the wrapper)
constexpr int kMaxGridY = 65535;

enum Layout : int { kFlat = 0, kSplit = 1, kUpack = 2, kFused = 3, kNosym = 4 };

// Shared-memory bytes of one block's table.
__host__ __device__ constexpr size_t table_bytes(int layout, int L) {
  return (layout == kSplit ? 3u : (layout == kFlat || layout == kFused) ? 4u : 2u)
         << L;
}

__device__ __forceinline__ uint32_t load_row(const uint32_t* __restrict__ col,
                                             int32_t row, int W, int k) {
  return (row >= 0 && row < W) ? col[(int64_t)row * k] : 0u;
}

// Copy `bytes` (a multiple of 4) of one block's plane into shared memory.
__device__ __forceinline__ void copy_plane(uint32_t* __restrict__ dst,
                                           const void* __restrict__ src,
                                           size_t bytes) {
  const uint32_t* s = (const uint32_t*)src;
  for (uint32_t j = threadIdx.x; j < bytes / 4; j += blockDim.x) dst[j] = s[j];
}

// (nb, base, sym) of `state` from the table in shared memory.
template <int LAYOUT>
__device__ __forceinline__ void entry(const uint32_t* __restrict__ s_tab,
                                      uint32_t state, int L, uint32_t& nb,
                                      uint32_t& base, uint32_t& sym) {
  if constexpr (LAYOUT == kFlat) {
    const uint32_t e = s_tab[state];
    nb = (e >> 16) & 0xFFu;
    base = e & 0xFFFFu;
    sym = e >> 24;
  } else if constexpr (LAYOUT == kSplit) {
    const uint32_t h = ((const uint16_t*)s_tab)[state];
    nb = h >> 12;
    base = h & 0xFFFu;
    sym = ((const uint8_t*)s_tab)[(2u << L) + state];
  } else if constexpr (LAYOUT == kUpack) {
    const uint32_t h = ((const uint16_t*)s_tab)[state];
    const uint32_t u = h & 0x1FFu;
    nb = (uint32_t)(L - (31 - __clz(u)));  // ilog2(u); exact for u < 512
    base = (u << nb) - (1u << L);
    sym = h >> 9;
  } else if constexpr (LAYOUT == kFused) {
    const uint32_t v = s_tab[state];
    base = v & ((1u << L) - 1u);
    nb = (v >> L) & 0xFu;
    sym = (v >> (L + 4)) & 0xFFu;
  } else {  // kNosym
    const uint32_t h = ((const uint16_t*)s_tab)[state];
    nb = h >> 12;
    base = h & 0xFFFu;
    sym = h & 0xFFu;
  }
}

template <int LAYOUT>
__global__ void __launch_bounds__(kThreads)
pl_decode_layout_kernel(const uint32_t* __restrict__ words,
                        const int32_t* __restrict__ sizes,
                        const void* __restrict__ plane0,
                        const void* __restrict__ plane1,
                        uint8_t* __restrict__ syms,
                        uint8_t* __restrict__ finals,
                        int32_t* __restrict__ cursors, int W, int k, int L,
                        int R, int b0) {
  extern __shared__ uint32_t s_tab[];
  const int64_t b = b0 + blockIdx.y;
  const uint32_t n_tab = 1u << L;
  const uint32_t mask_L = n_tab - 1u;
  if constexpr (LAYOUT == kFlat || LAYOUT == kFused) {
    copy_plane(s_tab, (const uint32_t*)plane0 + b * n_tab, 4u << L);
  } else {
    copy_plane(s_tab, (const uint16_t*)plane0 + b * n_tab, 2u << L);
    if constexpr (LAYOUT == kSplit)
      copy_plane(s_tab + (n_tab >> 1), (const uint8_t*)plane1 + b * n_tab,
                 n_tab);
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= k) return;
  const uint32_t* col = words + b * W * k + lane;

  // buf holds stream bits [pos, pos + 64); pos is a multiple of 32 and the
  // cursor c stays in [pos, pos + 32] between rounds, so a read of nb <= 16
  // bits at the new cursor needs at most one refill of one word.
  int32_t c = sizes[b * k + lane] - L;
  int32_t row = c >> 5;  // floor, also for a negative (corrupt) cursor
  int32_t pos = row * 32;
  uint64_t buf = (uint64_t)load_row(col, row, W, k) |
                 ((uint64_t)load_row(col, row + 1, W, k) << 32);
  uint32_t state = (uint32_t)(buf >> (c - pos)) & mask_L;

  uint8_t* out = syms + b * R * k + lane;
  uint32_t nb, base, sym;
  for (int r = 0; r < R; ++r) {
    entry<LAYOUT>(s_tab, state, L, nb, base, sym);
    c -= (int32_t)nb;
    if (c < pos) {
      pos -= 32;
      buf = (buf << 32) | load_row(col, pos >> 5, W, k);
    }
    const uint32_t low = (uint32_t)(buf >> (c - pos)) & ((1u << nb) - 1u);
    state = (base + low) & mask_L;
    out[(int64_t)r * k] = (uint8_t)sym;
  }
  entry<LAYOUT>(s_tab, state, L, nb, base, sym);
  finals[b * k + lane] = (uint8_t)sym;
  cursors[b * k + lane] = c;
}

template <int LAYOUT>
int set_smem(int L) {
  return (int)cudaFuncSetAttribute(pl_decode_layout_kernel<LAYOUT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)table_bytes(LAYOUT, L));
}

template <int LAYOUT>
int launch(const void* words, const void* sizes, const void* plane0,
           const void* plane1, void* syms, void* finals, void* cursors, int B,
           int W, int k, int L, int R, cudaStream_t stream) {
  cudaError_t err = (cudaError_t)set_smem<LAYOUT>(L);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = table_bytes(LAYOUT, L);
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const dim3 grid(k / kThreads, nb);
    pl_decode_layout_kernel<LAYOUT><<<grid, kThreads, smem, stream>>>(
        (const uint32_t*)words, (const int32_t*)sizes, plane0, plane1,
        (uint8_t*)syms, (uint8_t*)finals, (int32_t*)cursors, W, k, L, R, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <int LAYOUT>
int occupancy(int L) {
  const int err = set_smem<LAYOUT>(L);
  if (err != 0) return -err;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, pl_decode_layout_kernel<LAYOUT>, kThreads, table_bytes(LAYOUT, L));
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// words (B, W, k) u32, sizes (B, k) i32 bit counts, the layout's planes
// (B, 2^L) each (plane1 only for split, else null) -> syms (B, R, k) u8,
// finals (B, k) u8, cursors (B, k) i32. `layout` is 0 flat, 1 split,
// 2 upack, 3 fused, 4 nosym. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was taken).
extern "C" int ect_pl_decode_layout(const void* words, const void* sizes,
                                    const void* plane0, const void* plane1,
                                    void* syms, void* finals, void* cursors,
                                    int B, int W, int k, int L, int R,
                                    int layout, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (layout) {
    case kFlat:
      return launch<kFlat>(words, sizes, plane0, plane1, syms, finals, cursors,
                           B, W, k, L, R, s);
    case kSplit:
      return launch<kSplit>(words, sizes, plane0, plane1, syms, finals,
                            cursors, B, W, k, L, R, s);
    case kUpack:
      return launch<kUpack>(words, sizes, plane0, plane1, syms, finals,
                            cursors, B, W, k, L, R, s);
    case kFused:
      return launch<kFused>(words, sizes, plane0, plane1, syms, finals,
                            cursors, B, W, k, L, R, s);
    case kNosym:
      return launch<kNosym>(words, sizes, plane0, plane1, syms, finals,
                            cursors, B, W, k, L, R, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Co-resident 128-thread CTAs per SM of the `layout` instantiation at table
// log L on the current device (its shared memory and registers), or
// -(CUDA error).
extern "C" int ect_pl_decode_layout_occupancy(int layout, int L) {
  switch (layout) {
    case kFlat: return occupancy<kFlat>(L);
    case kSplit: return occupancy<kSplit>(L);
    case kUpack: return occupancy<kUpack>(L);
    case kFused: return occupancy<kFused>(L);
    case kNosym: return occupancy<kNosym>(L);
    default: return -(int)cudaErrorInvalidValue;
  }
}
