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
//   decode half   dec[b, i]        = sym << 24 | nb << 16 | base   (2^L u32)
//   encode half   next_state[b, j] = 2^L + slot                    (2^L u16)
//                 tt_bits[b, s], tt_fs[b, s]                  (256 u32, i32)
// with the transforms of symbols >= table_len (one past the last nonzero
// count) left 0, as the reference leaves them. A launch builds the half its
// caller reads (decode reads dec, encode the other three) or both, and
// writes nothing of the other half.
//
// What bounds it: neither bytes nor operations at the container's shapes. A
// block reads 1 KiB and writes 4 * 2^L (decode) or 2 * 2^L + 2 KiB
// (encode) bytes; 1,022 blocks at L=10 move 5-6 MiB, ~2 us at 3.35 TB/s,
// and 4 blocks of one 16 MiB launch move a few KiB: the launch itself binds
// there. At L=15 with few tables the work of a table (2^15 slots) is what
// one CTA would take long over.
//
// The design: a table is built by C CTAs of one thread-block cluster (C in
// 1, 2, 4, 8, picked by the wrapper from B, L and the SM count: ops/tables.py
// launch_config), CTA r owning the contiguous slots [r, r + 1) * 2^L / C.
// Everything stays in dynamic shared memory, sized to the CTA's slots.
//   1. One warp scans the 256 counts (8 a lane, shuffles): the low symbols'
//      slots, the inclusive sums of the spread counts, each symbol's first
//      rank in the next-state table, table_len.
//   2. The spread is a map, not a walk: visit j goes to position
//      (j * step) & (2^L - 1), step odd, so position p is visit
//      j = p * step^-1 mod 2^L. The visits to the n_low <= 256 positions
//      above high_threshold are skipped; their j are sorted once (each
//      thread ranks one among the others), so p's rank among the valid
//      visits is j minus a binary search over them, and its symbol a binary
//      search over the 256 sums. Each thread fills its own slots; no thread
//      waits on another.
//   3. The ranks of a slot among its symbol's slots, in slot order: warp w
//      owns a contiguous chunk of the CTA's slots; __match_any_sync groups
//      a warp's 32 slots by symbol, so a pass counts the chunk's slots per
//      symbol (u16 a (warp, symbol)), a scan along the warps gives each
//      chunk's start, and in a cluster each CTA adds the counts of the CTAs
//      before it, read from their shared memory (distributed shared memory,
//      after a cluster barrier). A second pass hands out the ranks, 32 slots
//      a step, and writes dec (coalesced) and next_state (scattered u16
//      stores, absorbed by L2).
//   4. The first CTA of a cluster computes the symbol transforms.
// Steps 2 and 3 take 2^L / (C * threads) slots a thread: 8 at L=15 in a
// cluster of 8, 4 at L=10 alone.
//
// The counts must be a valid normalization (every count in [-1, 2^L], the
// slots summing to 2^L): the wrapper checks them on the host. The kernel
// stays inside its arrays whatever it is given.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLog = 15;
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNever = 0x7FFFFFFF;  // pads the sorted visits past n_low

enum Half : int { kDecode = 1, kEncode = 2, kBoth = 3 };

// dynamic shared memory: int32 counts, cum, first, at, total, skipped
// [256] each | int32 misc[4] | u8 low_sym[256] | u16 seen[warps][256] |
// u8 symbols[slots]
inline size_t smem_bytes(int slots, int threads) {
  return 6 * 256 * 4 + 16 + 256 + (size_t)(threads / 32) * 256 * 2 + slots;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += a;
  }
  return v;
}

// #{i : a[i] <= x} of a sorted array of 256 ints, in 9 loads
__device__ __forceinline__ int count_at_most(const int32_t* a, int x) {
  int pos = 0;
#pragma unroll
  for (int s = 128; s; s >>= 1)
    if (a[pos + s - 1] <= x) pos += s;
  return pos + (a[pos] <= x);
}

// #{i : a[i] < x} of a sorted array whose entries from a[top - 1] on are
// all larger than x (top a power of two), in log2(top) + 1 loads
__device__ __forceinline__ int count_below(const int32_t* a, int top, int x) {
  int pos = 0;
  for (int s = top >> 1; s; s >>= 1)
    if (a[pos + s - 1] < x) pos += s;
  return pos + (a[pos] < x);
}

template <int HALF>
__global__ void __launch_bounds__(kMaxThreads)
build_tables_kernel(const int32_t* __restrict__ norm,
                    uint32_t* __restrict__ dec,
                    uint16_t* __restrict__ next_state,
                    uint32_t* __restrict__ tt_bits,
                    int32_t* __restrict__ tt_fs, int L, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* counts = reinterpret_cast<int32_t*>(smem);
  int32_t* cum = counts + 256;      // inclusive sums of the spread counts
  int32_t* first = cum + 256;       // ns of a symbol's first slot here
  int32_t* at = first + 256;        // its next_state index (slots before)
  int32_t* total = at + 256;        // this CTA's slots a symbol
  int32_t* skipped = total + 256;   // the skipped visits' j, sorted
  int32_t* misc = skipped + 256;    // n_low, table_len
  uint8_t* low_sym = reinterpret_cast<uint8_t*>(misc + 4);
  uint16_t* seen = reinterpret_cast<uint16_t*>(low_sym + 256);

  const int T = blockDim.x, warps = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint8_t* symbols = reinterpret_cast<uint8_t*>(seen + warps * 256);
  const int size = 1 << L, mask = size - 1;
  const int S = size / C;                 // this CTA's slots
  const int r = (int)(blockIdx.x % C);    // its rank in the cluster
  const int lo = r * S;
  const size_t b = blockIdx.x / C;

  const uint32_t step = (uint32_t)((size >> 1) + (size >> 3) + 3);
  uint32_t inv = step;  // step^-1 mod 2^32 by Newton: 3, 6, 12, 24, 48 bits
#pragma unroll
  for (int i = 0; i < 4; i++) inv *= 2u - step * inv;
  for (int s = tid; s < 256; s += T) {
    counts[s] = norm[b * 256 + s];
    // the visit to the s-th position from the top, skipped if s < n_low
    total[s] = (int)(((uint32_t)(size - 1 - s) * inv) & mask);
  }
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
      if (low[j]) low_sym[low_before] = (uint8_t)s;
      at[s] = spread_before + low_before;
      spread_before += spread[j];
      low_before += low[j];
      cum[s] = spread_before;
    }
#pragma unroll
    for (int d = 16; d; d >>= 1)
      last = max(last, __shfl_xor_sync(kFull, last, d));
    const int total_low = __shfl_sync(kFull, low_incl, 31);
    if (lane == 0) {
      misc[0] = total_low < size ? total_low : size;
      misc[1] = last + 1;
    }
  }
  __syncthreads();

  // 2. the spread, a map from each slot to its visit and its symbol
  const int n_low = misc[0];
  const int high = size - 1 - n_low;
  int top = 1;  // a power of two past n_low (or 256): the search's reach
  while (top <= n_low && top < 256) top <<= 1;
  for (int i = tid; i < 256; i += T) {  // rank each skipped visit: the sort
    if (i >= n_low) {
      skipped[i] = kNever;
      continue;
    }
    const int v = total[i];
    int rank = 0;
    for (int q = 0; q < (n_low & ~3); q += 4) {
      const int4 w = *reinterpret_cast<const int4*>(total + q);
      rank += (w.x < v) + (w.y < v) + (w.z < v) + (w.w < v);
    }
    for (int q = n_low & ~3; q < n_low; q++) rank += total[q] < v;
    skipped[rank] = v;
  }
  __syncthreads();
  for (int q = tid; q < S; q += T) {
    const int p = lo + q;
    int s;
    if (p > high) {
      s = low_sym[size - 1 - p];
    } else {
      const int j = (int)(((uint32_t)p * inv) & mask);
      const int rank = n_low ? j - count_below(skipped, top, j) : j;
      s = count_at_most(cum, rank);
      s = s < 255 ? s : 255;
    }
    symbols[q] = (uint8_t)s;
  }
  for (int i = lane; i < 256; i += 32) seen[warp * 256 + i] = 0;
  __syncthreads();

  // 3. the rank of each slot among its symbol's slots, in slot order
  const int chunk = S / warps >= 32 ? S / warps : 32;
  const int c0 = warp * chunk;
  const int c1 = c0 + chunk < S ? c0 + chunk : S;
  uint16_t* mine = seen + warp * 256;
  for (int i = c0 + lane; i < c1; i += 32) {  // whole warps: 32 | chunk
    const unsigned sym = symbols[i];
    const unsigned peers = __match_any_sync(kFull, sym);
    if (lane == __ffs(peers) - 1) mine[sym] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int s = tid; s < 256; s += T) {
    int before = 0;
    for (int w = 0; w < warps; w++) {
      const int c = seen[w * 256 + s];
      seen[w * 256 + s] = (uint16_t)before;
      before += c;
    }
    total[s] = before;
  }
  if (C > 1) {
    // the slots of each symbol in the cluster's CTAs before this one
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int s = tid; s < 256; s += T) {
      int base = 0;
      for (int q = 0; q < r; q++) base += *cluster.map_shared_rank(total + s, q);
      const int c = counts[s];
      first[s] = (c == -1 ? 1 : c) + base;
      at[s] += base;
    }
  } else {
    for (int s = tid; s < 256; s += T) {
      const int c = counts[s];
      first[s] = c == -1 ? 1 : c;
    }
  }
  __syncthreads();
  for (int i = c0 + lane; i < c1; i += 32) {
    const unsigned sym = symbols[i];
    const unsigned peers = __match_any_sync(kFull, sym);
    const int within = mine[sym] + __popc(peers & ((1u << lane) - 1));
    __syncwarp();
    if (lane == __ffs(peers) - 1) mine[sym] += __popc(peers);
    __syncwarp();
    const int slot = lo + i;
    if (HALF & kDecode) {
      const int ns = first[sym] + within;  // in [1, 2^(L+1))
      int nb = L - (31 - __clz(ns | 1));
      nb = nb < 0 ? 0 : nb;
      dec[b * size + slot] =
          (sym << 24) | ((unsigned)nb << 16) |
          ((((unsigned)ns << nb) - (unsigned)size) & 0xFFFFu);
    }
    if (HALF & kEncode) {
      const int a = at[sym] + within;
      if ((unsigned)a < (unsigned)size)
        next_state[b * size + a] = (uint16_t)(size + slot);
    }
  }

  // 4. the symbol transforms (at[] of the first CTA is the slots before)
  if ((HALF & kEncode) && r == 0) {
    const int table_len = misc[1];
    for (int s = tid; s < 256; s += T) {
      const int c = counts[s];
      uint32_t bits = 0;
      int32_t fs = 0;
      if (s < table_len) {
        const int before = at[s];
        if (c == 0) {
          bits = (uint32_t)(((L + 1) << 16) - (1 << L));
        } else if (c == -1 || c == 1) {
          bits = (uint32_t)((L << 16) - (1 << L));
          fs = before - 1;
        } else if (c > 1) {
          const int max_bits_out = L - (31 - __clz(c - 1));
          bits = ((uint32_t)max_bits_out << 16) -
                 ((uint32_t)c << (max_bits_out & 31));
          fs = before - c;
        }
      }
      tt_bits[b * 256 + s] = bits;
      tt_fs[b * 256 + s] = fs;
    }
  }
  // no CTA leaves while another may still read its counts
  if (C > 1) cg::this_cluster().sync();
}

// --- host launchers ---

// The launch shape of build_tables_kernel with no work: what a launch of
// that shape costs the card (the floor beside the byte bound).
template <int HALF>
__global__ void __launch_bounds__(kMaxThreads)
empty_kernel(const int32_t* __restrict__, uint32_t* __restrict__,
             uint16_t* __restrict__, uint32_t* __restrict__,
             int32_t* __restrict__, int, int) {}

template <class K>
int launch(K kernel, const void* norm, void* dec, void* next_state,
           void* tt_bits, void* tt_fs, int B, int L, int C, int T,
           cudaStream_t stream) {
  const size_t smem = smem_bytes((1 << L) / C, T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)C);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // a cluster of 1 is the ordinary kernel
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const int32_t*)norm, (uint32_t*)dec,
      (uint16_t*)next_state, (uint32_t*)tt_bits, (int32_t*)tt_fs, L, C);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

int checked(const void* norm, void* dec, void* next_state, void* tt_bits,
            void* tt_fs, int B, int L, int half, int C, int T) {
  if (L < 5 || L > kMaxLog || B < 0 || half < kDecode || half > kBoth)
    return (int)cudaErrorInvalidValue;
  if ((C != 1 && C != 2 && C != 4 && C != 8) || (1 << L) / C < 32)
    return (int)cudaErrorInvalidValue;
  if (T != 128 && T != 256 && T != 512) return (int)cudaErrorInvalidValue;
  if (!norm || ((half & kDecode) && !dec) ||
      ((half & kEncode) && (!next_state || !tt_bits || !tt_fs)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int HALF>
int launch_half(bool empty, const void* norm, void* dec, void* next_state,
                void* tt_bits, void* tt_fs, int B, int L, int C, int T,
                cudaStream_t s) {
  return empty ? launch(empty_kernel<HALF>, norm, dec, next_state, tt_bits,
                        tt_fs, B, L, C, T, s)
               : launch(build_tables_kernel<HALF>, norm, dec, next_state,
                        tt_bits, tt_fs, B, L, C, T, s);
}

int dispatch(bool empty, const void* norm, void* dec, void* next_state,
             void* tt_bits, void* tt_fs, int B, int L, int half, int C, int T,
             void* stream) {
  const int bad = checked(norm, dec, next_state, tt_bits, tt_fs, B, L, half,
                          C, T);
  if (bad || B == 0) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (half) {
    case kDecode:
      return launch_half<kDecode>(empty, norm, dec, next_state, tt_bits,
                                  tt_fs, B, L, C, T, s);
    case kEncode:
      return launch_half<kEncode>(empty, norm, dec, next_state, tt_bits,
                                  tt_fs, B, L, C, T, s);
    default:
      return launch_half<kBoth>(empty, norm, dec, next_state, tt_bits, tt_fs,
                                B, L, C, T, s);
  }
}

}  // namespace

// norm (B, 256) i32 -> the half `half` asks for (1: dec (B, 2^L) u32; 2:
// next_state (B, 2^L) u16, tt_bits (B, 256) u32, tt_fs (B, 256) i32; 3:
// both), every element of it written; the other half's pointers may be
// null and are not written. L in 5..15; each table built by a cluster of C
// CTAs (1, 2, 4 or 8, at least 32 slots a CTA) of T threads (128, 256 or
// 512). Launches on `stream` and returns the launch's CUDA error (0 when it
// was taken), or cudaErrorInvalidValue for an argument outside these.
extern "C" int ect_build_tables(const void* norm, void* dec, void* next_state,
                                void* tt_bits, void* tt_fs, int B, int L,
                                int half, int C, int T, void* stream) {
  return dispatch(false, norm, dec, next_state, tt_bits, tt_fs, B, L, half, C,
                  T, stream);
}

// The same launch (grid, cluster, threads, shared memory, arguments) of a
// kernel that does nothing: the floor of a D3 launch of that shape.
extern "C" int ect_build_tables_empty(const void* norm, void* dec,
                                      void* next_state, void* tt_bits,
                                      void* tt_fs, int B, int L, int half,
                                      int C, int T, void* stream) {
  return dispatch(true, norm, dec, next_state, tt_bits, tt_fs, B, L, half, C,
                  T, stream);
}
