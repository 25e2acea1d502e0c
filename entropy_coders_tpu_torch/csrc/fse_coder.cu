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
// D5, decode. One CTA a block; the block's decode table sits in dynamic
// shared memory (4 * 2^L bytes: 128 KiB at L = 15). T = round_up(ceil(k /
// J), 32) threads each hold J (a power of two, the smallest with T <= 1024)
// neighbouring lanes' states in registers. A round: look up every lane's
// (sym, nb, base); a CTA-wide inclusive scan of the bit counts (shuffles
// within a warp, a double-buffered array of warp sums and one
// __syncthreads across warps, nothing but shuffles when the lanes fit one
// warp); then every lane whose inclusive prefix fits below the cursor c
// reads its bits at c - prefix and moves on. The prefixes never decrease,
// so the lanes that fit are a prefix of the lanes: when the round's total
// fits (every round but the last) all lanes move and c falls by the total;
// otherwise the one lane where the prefix first passes c is the failed lane,
// the lanes before it move, and the block is done. A done block writes the
// frozen states' symbols for its remaining rounds, as the scan does.
// What bounds it: the chain of a round where k is small (65,535 rounds at
// 128 KiB blocks and k = 2, each a table lookup and a read in series; many
// blocks run at once, which is all the card can overlap), the bytes where
// k is large.
//
// D4, encode. The scan's three steps, split for the card:
//   (a) fse_encode_chain: a thread a (block, lane) runs its lane's state
//       chain over the R rounds with the next-state table and the symbol
//       transforms in shared memory (2 * 2^L + 2 KiB), writing each slot's
//       bit count (u8) and value (u16: a state's low bits, < 2^16) to
//       scratch, and its final state; each round's symbol is loaded a round
//       ahead of its use;
//   (b) fse_encode_pack, one CTA a block, walks the R * k + k + 1 slots
//       (the rounds', the k final states' L bits in finish_slots order, the
//       marker bit) a tile of 8 * T at a time: the tile's bit counts and
//       values are staged in shared memory with coalesced loads, each
//       thread takes 8 neighbouring slots, and one CTA-wide exclusive scan
//       gives each thread its bit offset;
//   (c) the threads OR their bits into a staging row of words in shared
//       memory (whole words a thread fills alone are stored, the first and
//       last, which it may share, go through atomicOr: exact as the JAX
//       scatter-add of disjoint bit ranges is), and the CTA stores the
//       tile's whole words to the output, coalesced, carrying the last
//       partial word into the next tile's row. No global atomics. The words
//       past the stream's last are stored as zeros, so every one of the W
//       words of a block is written once and the caller fills nothing.
// What bounds it: (a) is the same serial chain per lane as D5 (at k = 2,
// 65,535 dependent lookups a thread); (b)/(c) move 3 bytes of scratch a
// slot and the W words once.
//
// Indices into (B, R, k) and (B, W) arrays are 64-bit throughout.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void record(long long* err, long long seq) {
  atomicMin(reinterpret_cast<unsigned long long*>(err),
            (unsigned long long)seq);
}

// `width` (<= 16) bits from bit `start` of a block's little-endian u32
// words (Wd of them); as ops/coder.py _extract_bits: start clamped at 0, the
// word index at Wd - 1, and only the next word's low 16 bits read.
__device__ __forceinline__ uint32_t read_bits(const uint32_t* __restrict__ w,
                                              long long Wd, long long start,
                                              int width) {
  if (start < 0) start = 0;
  long long i = start >> 5;
  if (i > Wd - 1) i = Wd - 1;
  const long long i1 = i + 1 > Wd - 1 ? Wd - 1 : i + 1;
  const uint64_t v =
      ((uint64_t)(__ldg(w + i1) & 0xFFFFu) << 32) | __ldg(w + i);
  return (uint32_t)(v >> (start & 31)) & ((1u << width) - 1u);
}

__device__ __forceinline__ int clamp_index(int s, int size) {
  return s < 0 ? 0 : (s >= size ? size - 1 : s);
}

// --- D5 --------------------------------------------------------------------

// Check sequence numbers of the plain decode (ops/coder.py): 1 the
// initial bit offsets, 2 + 2r round r's table indices, 3 + 2r its bit
// offsets, 2 + 2R the final table indices.
template <int J>
__global__ void __launch_bounds__(kMaxThreads)
fse_decode_kernel(const uint32_t* __restrict__ words, long long Wd,
                  const long long* __restrict__ total_bits,
                  const uint32_t* __restrict__ packed, int size,
                  uint8_t* __restrict__ syms, long long* __restrict__ emit_out,
                  uint8_t* __restrict__ finals, uint8_t* __restrict__ done_out,
                  long long* __restrict__ cursor_out, long long* err,
                  int* __restrict__ fstate, int k, int L, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem_raw);
  __shared__ int warp_sums[2][32];
  __shared__ int s_fail, s_sum;

  const long long b = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const int lane_id = t & 31, warp = t >> 5, n_warps = T >> 5;
  const uint32_t* pk = packed + b * size;
  for (int i = t; i < size; i += T) tab[i] = pk[i];
  __syncthreads();

  const uint32_t* w = words + b * Wd;
  const long long tb = total_bits[b];
  const long long bits_max = 32 * (Wd - 1);
  long long first_err = LLONG_MAX;
  const int lane0 = t * J;
  // the shuffle steps a one-warp scan needs: the threads that hold lanes
  int width = 32;
  if (n_warps == 1) {
    const int used = (k + J - 1) / J;
    width = 1;
    while (width < used) width <<= 1;
  }

  // decoder init, lane 0 first: lane s reads L bits at [c - (s+1)L, c - sL)
  int st[J];
#pragma unroll
  for (int j = 0; j < J; j++) {
    st[j] = 0;
    const int lane = lane0 + j;
    if (lane < k) {
      const long long start = tb - (long long)(lane + 1) * L;
      if (start < 0 || start >= bits_max) first_err = min(first_err, 1LL);
      st[j] = (int)read_bits(w, Wd, start, L);
    }
  }
  long long c = tb - (long long)k * L;
  bool done = false;
  int fail_lane = -1;
  long long emit = 0;
  uint8_t* out = syms + b * R * k;

  for (int r = 0; r < R; r++) {
    uint32_t e[J];
    int local = 0;
#pragma unroll
    for (int j = 0; j < J; j++) {
      const int lane = lane0 + j;
      e[j] = 0;
      if (lane < k) {
        if (st[j] < 0 || st[j] >= size)
          first_err = min(first_err, 2 + 2LL * r);
        e[j] = tab[clamp_index(st[j], size)];
        out[(long long)r * k + lane] = (uint8_t)(e[j] >> 24);
        local += (e[j] >> 16) & 0xFF;
      }
    }
    if (done) continue;  // the same in every thread of the block

    // inclusive scan of the bit counts over the block's threads
    int incl = local;
    for (int d = 1; d < width; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane_id >= d) incl += y;
    }
    int total, before;  // the round's sum, the bits of the lanes before mine
    if (n_warps == 1) {
      total = __shfl_sync(kFull, incl, width - 1);
      before = incl - local;
    } else {
      int* sums = warp_sums[r & 1];
      if (lane_id == 31) sums[warp] = incl;
      __syncthreads();
      const int ws = lane_id < n_warps ? sums[lane_id] : 0;
      int wi = ws;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, wi, d);
        if (lane_id >= d) wi += y;
      }
      total = __shfl_sync(kFull, wi, 31);
      before = __shfl_sync(kFull, wi, warp) - __shfl_sync(kFull, ws, warp) +
               incl - local;
    }

    const bool all_alive = (long long)total <= c;
    int run = before;
#pragma unroll
    for (int j = 0; j < J; j++) {
      const int lane = lane0 + j;
      const int nb = (e[j] >> 16) & 0xFF;
      const int prev = run;
      run += nb;
      if (lane < k && (long long)run <= c) {
        const long long start = c - run;
        if (start >= bits_max) first_err = min(first_err, 3 + 2LL * r);
        st[j] = (int)(e[j] & 0xFFFF) + (int)read_bits(w, Wd, start, nb);
      } else if (!all_alive && lane < k && (lane == 0 || prev <= c)) {
        // the first lane whose prefix passes c: the lanes before it moved
        s_fail = lane;
        s_sum = prev;
      }
    }
    if (all_alive) {
      c -= total;
      emit += k;
    } else {  // once a block: the failed lane ends the stream
      __syncthreads();
      fail_lane = s_fail;
      emit += s_fail;
      c -= s_fail == 0 ? 0 : s_sum;
      done = true;
    }
  }

  // pending final-state symbols flush cyclically from the failed lane
  int* fs = fstate + b * k;
#pragma unroll
  for (int j = 0; j < J; j++) {
    const int lane = lane0 + j;
    if (lane < k) {
      if (st[j] < 0 || st[j] >= size)
        first_err = min(first_err, 2 + 2LL * R);
      fs[lane] = st[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < J; j++) {
    const int lane = lane0 + j;
    if (lane < k) {
      const int from = ((fail_lane + lane) % k + k) % k;
      finals[b * k + lane] =
          (uint8_t)(tab[clamp_index(fs[from], size)] >> 24);
    }
  }
  if (t == 0) {
    emit_out[b] = emit;
    done_out[b] = done ? 1 : 0;
    cursor_out[b] = c;
  }
  if (err && first_err != LLONG_MAX) record(err + b, first_err);
}

// J (lanes a thread) and T (threads) of D5 for k lanes
int decode_lanes_per_thread(int k) {
  int J = 1;
  while ((k + J - 1) / J > kMaxThreads) J <<= 1;
  return J;
}

int decode_threads(int k, int J) {
  return ((k + J - 1) / J + 31) / 32 * 32;
}

// --- D4 --------------------------------------------------------------------

// Check sequence numbers of the plain encode: 1 the initial next-state
// indices, 2 + r round r's (of valid slots), R + 2 the last bit's word.

// (a) lane chains: grid (B, lane chunks of blockDim.x)
__global__ void __launch_bounds__(kMaxThreads)
fse_encode_chain(const uint8_t* __restrict__ syms,
                 const uint8_t* __restrict__ valid,
                 const uint8_t* __restrict__ init_syms,
                 const uint16_t* __restrict__ table,
                 const uint32_t* __restrict__ tt_bits,
                 const int32_t* __restrict__ tt_fs, int size,
                 uint8_t* __restrict__ sbits, uint16_t* __restrict__ svals,
                 int* __restrict__ fstate, long long* err, int k, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* tb = reinterpret_cast<uint32_t*>(smem_raw);
  int32_t* fs = reinterpret_cast<int32_t*>(tb + 256);
  uint16_t* tab = reinterpret_cast<uint16_t*>(fs + 256);

  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < 256; i += blockDim.x) {
    tb[i] = tt_bits[b * 256 + i];
    fs[i] = tt_fs[b * 256 + i];
  }
  for (int i = t; i < size; i += blockDim.x) tab[i] = table[b * size + i];
  __syncthreads();
  const int lane = blockIdx.y * blockDim.x + t;
  if (lane >= k) return;

  long long first_err = LLONG_MAX;
  // new_first_symbol, floor+1 form (reference src/fse.rs:210-218)
  const int s0 = init_syms[b * k + lane];
  const long long b0 = tb[s0];
  const long long out0 = (b0 >> 16) + 1;
  const long long idx0 = ((((out0 << 16) - b0)) >> out0) + fs[s0];
  if (idx0 < 0 || idx0 >= size) first_err = 1;
  int state = tab[idx0 < 0 ? 0 : (idx0 >= size ? size - 1 : idx0)];

  const long long base = b * R * k + lane;
  const uint8_t* sy = syms + base;
  uint8_t* nbits = sbits + base;
  uint16_t* vals = svals + base;
  // each round's symbol and mask are loaded a round ahead of their use
  int s_next = R > 0 ? sy[0] : 0;
  bool v_next = R > 0 && valid[lane] != 0;
#pragma unroll 4
  for (int r = 0; r < R; r++) {
    const long long o = (long long)r * k;
    const int s = s_next;
    const bool v = v_next;
    if (r + 1 < R) {
      s_next = sy[o + k];
      v_next = valid[o + k + lane] != 0;
    }
    const int out = (int)(((long long)tb[s] + state) >> 16);
    nbits[o] = v ? (uint8_t)out : 0;
    vals[o] = v ? (uint16_t)(state & ((1u << out) - 1u)) : 0;
    const long long idx = (long long)(state >> out) + fs[s];
    if (v && (idx < 0 || idx >= size)) first_err = min(first_err, 2LL + r);
    const int nxt = tab[idx < 0 ? 0 : (idx >= size ? size - 1 : idx)];
    state = v ? nxt : state;
  }
  fstate[b * k + lane] = state;
  if (err && first_err != LLONG_MAX) record(err + b, first_err);
}

// (b) + (c): one CTA a block, a tile of kPackSlots * T slots at a time
constexpr int kPackSlots = 8;

__device__ __forceinline__ void put_staged(uint32_t* sw, long long i,
                                           int n_words, uint32_t v,
                                           bool shared) {
  if (i >= n_words) return;  // only a bit count past 16 (no valid table)
  if (shared)
    atomicOr(sw + i, v);
  else
    sw[i] = v;
}

size_t pack_smem_bytes(int T) {
  const size_t tile = (size_t)T * kPackSlots;
  return 4 * (tile / 2 + 2) + 2 * tile + tile;
}

__global__ void __launch_bounds__(kMaxThreads)
fse_encode_pack(const uint8_t* __restrict__ sbits,
                const uint16_t* __restrict__ svals,
                const int* __restrict__ fstate,
                const long long* __restrict__ finish_slots,
                uint32_t* __restrict__ words,
                long long* __restrict__ total_bits, long long* err, int k,
                int R, int L, long long W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long warp_sums[32];
  const long long b = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const int lane_id = t & 31, warp = t >> 5, n_warps = T >> 5;
  const int tile = T * kPackSlots, n_staged = tile / 2 + 2;
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem_raw);  // staged words
  uint16_t* sv = reinterpret_cast<uint16_t*>(sw + n_staged);
  uint8_t* sb = reinterpret_cast<uint8_t*>(sv + tile);
  const long long Rk = (long long)R * k, N = Rk + k + 1;
  const uint8_t* nb = sbits + b * Rk;
  const uint16_t* vs = svals + b * Rk;
  const int* fs = fstate + b * k;
  const uint32_t mask_L = (1u << L) - 1u;
  uint32_t* out = words + b * W;

  for (int i = t; i < n_staged; i += T) sw[i] = 0;
  long long carry = 0;  // the bits of the tiles before this one
  for (long long base = 0; base < N; base += tile) {
    for (int i = t; i < tile; i += T) {
      const long long s = base + i;
      if (s < Rk) {
        sb[i] = nb[s];
        sv[i] = vs[s];
      }
    }
    __syncthreads();
    int n[kPackSlots];
    uint32_t v[kPackSlots];
    long long mine = 0;
#pragma unroll
    for (int q = 0; q < kPackSlots; q++) {
      const int i = t * kPackSlots + q;
      const long long s = base + i;
      if (s < Rk) {
        n[q] = sb[i];
        v[q] = sv[i];
      } else if (s < Rk + k) {
        n[q] = L;
        v[q] = (uint32_t)fs[finish_slots[s - Rk]] & mask_L;
      } else if (s == Rk + k) {
        n[q] = 1;
        v[q] = 1;
      } else {
        n[q] = 0;
        v[q] = 0;
      }
      mine += n[q];
    }

    // exclusive scan of the threads' bit counts
    long long x = mine;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, d);
      if (lane_id >= d) x += y;
    }
    if (lane_id == 31) warp_sums[warp] = x;
    __syncthreads();
    const long long ws = lane_id < n_warps ? warp_sums[lane_id] : 0;
    long long wi = ws;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, wi, d);
      if (lane_id >= d) wi += y;
    }
    const long long tile_bits = __shfl_sync(kFull, wi, 31);
    const long long pos = (carry & 31) + __shfl_sync(kFull, wi, warp) -
                          __shfl_sync(kFull, ws, warp) + x - mine;

    uint64_t acc = 0;
    int n_acc = (int)(pos & 31);
    long long at = pos >> 5;
    bool first = true, any = false;
#pragma unroll
    for (int q = 0; q < kPackSlots; q++) {
      if (n[q] == 0) continue;
      acc |= (uint64_t)v[q] << n_acc;
      n_acc += n[q];
      any = true;
      while (n_acc >= 32) {
        put_staged(sw, at, n_staged, (uint32_t)acc, first);
        first = false;
        acc >>= 32;
        n_acc -= 32;
        at++;
      }
    }
    if (any && n_acc > 0) put_staged(sw, at, n_staged, (uint32_t)acc, true);
    __syncthreads();

    // the tile's whole words out; its last partial word carries over
    const long long end = (carry & 31) + tile_bits;
    const bool last = base + tile >= N;
    const long long n_out = last ? (end + 31) >> 5 : end >> 5;
    const uint32_t partial = sw[(end >> 5) < n_staged ? end >> 5 : 0];
    const long long w0 = carry >> 5;
    for (long long i = t; i < n_out && i < n_staged; i += T)
      if (w0 + i < W) out[w0 + i] = sw[i];  // past W: dropped, as in JAX
    __syncthreads();
    for (int i = t; i < n_staged; i += T) sw[i] = i == 0 ? partial : 0;
    carry += tile_bits;
  }
  for (long long i = ((carry + 31) >> 5) + t; i < W; i += T) out[i] = 0;
  if (t == 0) {
    total_bits[b] = carry;
    if (err && ((carry - 1) >> 5) + 1 >= W) record(err + b, (long long)R + 2);
  }
}

int encode_chain_threads(int k) {
  return k >= 256 ? 256 : (k + 31) / 32 * 32;
}

int encode_pack_threads(long long n_slots) {
  const long long T = ((n_slots + kPackSlots - 1) / kPackSlots + 31) / 32 * 32;
  return (int)(T > kMaxThreads ? kMaxThreads : T);
}

}  // namespace

// --- host launchers ---

namespace {

int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

template <class K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return e == cudaSuccess ? 0 : fail(e);
}

template <int J>
int launch_decode(const void* words, long long Wd, const void* total_bits,
                  const void* packed, int size, void* syms, void* emit,
                  void* finals, void* done, void* cursor, void* err,
                  void* fstate, int B, int k, int L, int R,
                  cudaStream_t stream) {
  const size_t smem = (size_t)size * 4;
  if (const int e = allow_smem(fse_decode_kernel<J>, smem)) return e;
  fse_decode_kernel<J><<<B, decode_threads(k, J), smem, stream>>>(
      (const uint32_t*)words, Wd, (const long long*)total_bits,
      (const uint32_t*)packed, size, (uint8_t*)syms, (long long*)emit,
      (uint8_t*)finals, (uint8_t*)done, (long long*)cursor, (long long*)err,
      (int*)fstate, k, L, R);
  return (int)cudaGetLastError();
}

}  // namespace

// D5 on B blocks: words (B, Wd) u32, total_bits (B,) i64, packed (B, size)
// u32 -> syms (B, R, k) u8, emit (B,) i64, finals (B, k) u8, done (B,) u8,
// cursor (B,) i64; err (B,) i64 set to -1 by the caller, or null (no
// checks); fstate (B, k) i32 scratch.
extern "C" int ect_fse_decode(const void* words, const void* total_bits,
                              const void* packed, void* syms, void* emit,
                              void* finals, void* done, void* cursor,
                              void* err, void* fstate, int B, long long Wd,
                              int k, int L, int size, int R,
                              cudaStream_t stream) {
  if (B < 0 || Wd < 1 || k < 1 || k > 0xFFFF || L < 1 || L > 16 ||
      size < 1 || R < 0 || !words || !total_bits || !packed || !syms ||
      !emit || !finals || !done || !cursor || !fstate)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int J = decode_lanes_per_thread(k);
  switch (J) {
#define ECT_CASE(n)                                                         \
  case n:                                                                   \
    return launch_decode<n>(words, Wd, total_bits, packed, size, syms, emit, \
                            finals, done, cursor, err, fstate, B, k, L, R,  \
                            stream);
    ECT_CASE(1) ECT_CASE(2) ECT_CASE(4) ECT_CASE(8) ECT_CASE(16) ECT_CASE(32)
    ECT_CASE(64)
#undef ECT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// D4 on B blocks: syms (B, R, k) u8, valid (R, k) u8, init_syms (B, k) u8,
// finish_slots (k,) i64 in [0, k), table (B, size) u16, tt_bits (B, 256)
// u32, tt_fs (B, 256) i32 -> words (B, W) u32 (every word written),
// total_bits (B,) i64; err as for D5; sbits (B, R, k) u8, svals (B, R, k)
// u16 and fstate (B, k) i32 scratch.
extern "C" int ect_fse_encode(const void* syms, const void* valid,
                              const void* init_syms, const void* finish_slots,
                              const void* table, const void* tt_bits,
                              const void* tt_fs, void* words, void* total_bits,
                              void* err, void* sbits, void* svals,
                              void* fstate, int B, int R, int k, int L,
                              int size, long long W, cudaStream_t stream) {
  if (B < 0 || R < 0 || k < 1 || k > 0xFFFF || L < 1 || L > 16 || size < 1 ||
      W < 1 || !syms || !valid || !init_syms || !finish_slots || !table ||
      !tt_bits || !tt_fs || !words || !total_bits || !sbits || !svals ||
      !fstate)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = 2 * 256 * 4 + (size_t)size * 2;
  if (const int e = allow_smem(fse_encode_chain, smem)) return e;
  const int T = encode_chain_threads(k);
  fse_encode_chain<<<dim3(B, (k + T - 1) / T), T, smem, stream>>>(
      (const uint8_t*)syms, (const uint8_t*)valid, (const uint8_t*)init_syms,
      (const uint16_t*)table, (const uint32_t*)tt_bits,
      (const int32_t*)tt_fs, size, (uint8_t*)sbits, (uint16_t*)svals,
      (int*)fstate, (long long*)err, k, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int T_pack = encode_pack_threads((long long)R * k + k + 1);
  fse_encode_pack<<<B, T_pack, pack_smem_bytes(T_pack), stream>>>(
      (const uint8_t*)sbits, (const uint16_t*)svals, (const int*)fstate,
      (const long long*)finish_slots, (uint32_t*)words,
      (long long*)total_bits, (long long*)err, k, R, L, W);
  return (int)cudaGetLastError();
}
