// B2: per-lane tANS encode for the MODE_FSE_PL container, for Hopper (sm_90a).
//
// Replaces entropy_coders_tpu/ops/pl_coder.py:1075 (_encode_kernel), the
// Pallas TPU kernel launched by _encode_call and _encode_call_packed. Same
// function: lane i of block b codes the bytes {i, i + k, ..., i + R*k} as a
// reference-format single-stream FSE payload. The lane's last byte (row R of
// the raw block) folds into the initial state (new_first_symbol in its
// floor + 1 form, identical to the reference through L = 14 and well defined
// at 15); rows R-1 ... 0 are then coded in that order, each emitting the
// state's low nb = (tt_bits[sym] + state) >> 16 bits and moving to
// next_state[(state >> nb) + tt_fs[sym]]; the final state's low L bits close
// the stream. Bit j of the lane's stream lands in bit j & 31 of
// words[b, j >> 5, i]; sizes[b, i] is the stream's length in bits. Every word
// row past a lane's stream, up to W, is written as zero by the kernel.
//
// What bounds it, at the main path's launch shapes (one launch per ~64 MiB
// chunk; tools/lane_shapes.py counts the bounds from this kernel's SASS and
// the card's measured latencies, PERF.md has the numbers):
//   throughput  B=4,   k=16384, R=1023, L=8   65,536 lanes, 16 warps an SM:
//               the integer ALU binds (~11 ALU instructions a warp a round,
//               at 2 a clock an SM), above the bytes (67 MB read, 69 MB of
//               words written) and the chain (~43 cycles a round: one
//               shared load and five integer steps);
//   parity      B=4,   k=8192,  R=2047, L=11  32,768 lanes, 8 warps an SM:
//               the ALU, the bytes and R rounds of the chain, within 15% of
//               each other;
//   default     B=512, k=1024,  R=127,  L=10  524,288 lanes: the bytes and
//               the ALU, about equal.
// No launch shape is bound by a product: there is none, so tensor cores and
// wgmma play no part.
//
// The design: one thread per lane, T lanes of one block a CTA (T picked by
// the wrapper, ops/pl_coder.py lane_config: 256, and 512 from L = 13, where
// the table leaves room for few CTAs an SM). No device-memory load is on the
// chain: the CTA's symbol rows are staged in shared memory ahead of use,
// double-buffered tiles of 32 rows x T bytes brought in by 16-byte cp.async
// and walked R-1 ... 0. The transform (tt_bits, tt_fs) is one 8-byte shared
// load per symbol, off the chain; what is left on it is add, shift, shift,
// add, mask and one shared load of next_state. The state is kept times 4,
// its byte offset into a u32 next_state table, so no scaling is on the
// chain. A 64-bit accumulator takes F rounds of bits (F = 4 while 4 rounds
// fit 32 bits, L <= 8, else 2) between flushes, and a flush stores one word
// as a predicated instruction: a divergent branch in the loop made every
// lane of a warp wait for its reconvergence. The wrapper allocates words
// without zeroing them: each lane zeroes its rows up to the CTA's longest
// stream, and the CTA zeroes the rows from there to W with 16-byte stores,
// so the words leave the kernel equal to the plain version's and to the JAX
// package's zero-filled W rows.
//
// Next-state indices are masked to L bits and word rows at or past W are
// dropped, so no input, however wrong, makes the kernel touch memory outside
// its arrays.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_launch.cuh"

namespace {

using namespace ect_lane;

constexpr int kRows = 32;  // symbol rows per staged tile

// dynamic shared memory: uint2 transform[256] | u8 tiles[2][kRows][T] |
// u32 next_state[2^L]. The kernel keeps the state times 4 (its byte offset
// into next_state), so the tables are stored scaled: transform (4 tb, 4 fs),
// next_state 4 x the state.
inline size_t smem_bytes(int T, int L) {
  return 256 * sizeof(uint2) + 2 * kRows * (size_t)T + (sizeof(uint32_t) << L);
}

template <int T, int F>
__global__ void __launch_bounds__(T)
pl_encode_kernel(const uint8_t* __restrict__ blocks,
                 const uint32_t* __restrict__ tt_bits,
                 const int32_t* __restrict__ tt_fs,
                 const uint16_t* __restrict__ next_state,
                 uint32_t* __restrict__ words, int32_t* __restrict__ sizes,
                 int k, int L, int R, int W, int b0) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint2* s_tr = reinterpret_cast<uint2*>(smem);
  uint8_t* s_in = smem + 256 * sizeof(uint2);
  uint32_t* s_next = reinterpret_cast<uint32_t*>(s_in + 2 * kRows * T);
  const char* s_next4 = reinterpret_cast<const char*>(s_next);
  __shared__ int s_top;  // the CTA's longest stream, in word rows

  const int tid = threadIdx.x;
  const int64_t b = b0 + blockIdx.y;
  const int lane0 = blockIdx.x * T;
  const uint32_t n_tab = 1u << L;
  const uint32_t mask_L = n_tab - 1u;
  const uint8_t* src = blocks + b * (int64_t)(R + 1) * k + lane0;

  // tile t holds rows [max(hi - kRows, 0), hi), hi = R - t * kRows, in
  // buffer t & 1; one commit group per tile, empty past the last
  auto stage = [&](int t) {
    const int hi = R - t * kRows;
    if (hi > 0) {
      const int lo = hi > kRows ? hi - kRows : 0;
      uint8_t* dst = s_in + (t & 1) * kRows * T;
      const int chunks = (hi - lo) * (T / 16);
      for (int c = tid; c < chunks; c += T) {
        const int r = c / (T / 16), col = (c % (T / 16)) * 16;
        cp_async16(dst + r * T + col, src + (lo + r) * k + col);
      }
    }
    cp_async_commit();
  };
  stage(0);
  stage(1);

  for (int j = tid; j < 256; j += T)
    s_tr[j] = make_uint2(tt_bits[b * 256 + j] << 2,
                         (uint32_t)tt_fs[b * 256 + j] << 2);
  const uint16_t* nxt_g = next_state + b * n_tab;
  for (uint32_t j = tid; j < n_tab; j += T) s_next[j] = (uint32_t)nxt_g[j] << 2;
  if (tid == 0) s_top = 0;
  __syncthreads();

  uint32_t* col = words + b * (int64_t)W * k + lane0 + tid;

  // initial state from the lane's last byte (new_first_symbol, floor + 1)
  uint32_t state4;  // 4 x the state
  {
    const uint32_t sym = src[R * k + tid];
    const uint32_t tb = tt_bits[b * 256 + sym];
    const uint32_t nb = (tb >> 16) + 1u;
    const uint32_t value0 = (nb << 16) - tb;
    state4 = s_next[((value0 >> nb) + (uint32_t)tt_fs[b * 256 + sym]) &
                    mask_L];
  }

  // pending bits, LSB first: nacc < 32 after a flush, and F rounds of at
  // most 32 / F bits each keep it below 64 until the next one
  uint64_t acc = 0;
  uint32_t nacc = 0;
  uint32_t woff = 0;  // byte offset of the lane's next word: 4 * row * k
  const uint32_t wend = 4u * W * k, wstep = 4u * k;
  char* col_b = reinterpret_cast<char*>(col);
  // the chain of a round: add, shift, shift, add, mask, one shared load;
  // 4 x the state is the next load's byte offset, so no scaling is on it
  // (the low 2 bits that (4 x state) >> nb drags in are masked off)
  const uint32_t mask4 = mask_L << 2;
  auto round = [&](uint32_t sym) {
    const uint2 tr = s_tr[sym];
    const uint32_t nb = (tr.x + state4) >> 18;
    acc |= (uint64_t)((state4 >> 2) & ((1u << nb) - 1u)) << nacc;
    nacc += nb;
    state4 = *reinterpret_cast<const uint32_t*>(
        s_next4 + (((state4 >> nb) + tr.y) & mask4));
  };
  auto flush = [&]() {  // one whole word out, without a branch
    const bool over = nacc >= 32;
    store_if(reinterpret_cast<uint32_t*>(col_b + woff), (uint32_t)acc,
             over && woff < wend);
    woff += over ? wstep : 0;
    acc = over ? acc >> 32 : acc;
    nacc &= 31;
  };

  const int n_tiles = (R + kRows - 1) / kRows;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();
    const int hi = R - t * kRows;
    const uint8_t* tile = s_in + (t & 1) * kRows * T + tid;
    if (hi >= kRows) {
#pragma unroll
      for (int i = kRows - 1; i >= 0; --i) {
        round(tile[i * T]);
        if (i % F == 0) flush();
      }
    } else {
      for (int i = hi - 1; i >= 0; --i) {
        round(tile[i * T]);
        flush();
      }
    }
    __syncthreads();  // every lane is done with buffer t & 1
    stage(t + 2);
  }

  // finish: the final state's low L bits (reference src/fse.rs:248-250)
  int row = (int)(woff / wstep);
  sizes[b * k + lane0 + tid] = row * 32 + (int)nacc + L;
  uint64_t fin = acc | ((uint64_t)((state4 >> 2) & mask_L) << nacc);
  for (int n = (int)nacc + L; n > 0; n -= 32) {
    if (row < W) col[row * k] = (uint32_t)fin;
    ++row;
    fin >>= 32;
  }

  // zero the rows past each stream: a lane's own up to the CTA's longest,
  // then the CTA's [top, W) x T with 16-byte stores
  const int end = row < W ? row : W;
  atomicMax(&s_top, end);
  __syncthreads();
  const int top = s_top;
  for (int r = end; r < top; ++r) col[r * k] = 0u;
  uint32_t* base = words + b * (int64_t)W * k + lane0;
  for (int c = tid; c < (W - top) * (T / 4); c += T) {
    const int r = top + c / (T / 4), q = (c % (T / 4)) * 4;
    *reinterpret_cast<uint4*>(base + r * k + q) = make_uint4(0, 0, 0, 0);
  }
}

template <int T, int F>
int launch(const void* blocks, const void* tt_bits, const void* tt_fs,
           const void* next_state, void* words, void* sizes, int B, int k,
           int L, int R, int W, cudaStream_t stream) {
  const size_t smem = smem_bytes(T, L);
  cudaError_t err = set_smem(pl_encode_kernel<T, F>, smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    pl_encode_kernel<T, F><<<dim3(k / T, nb), T, smem, stream>>>(
        (const uint8_t*)blocks, (const uint32_t*)tt_bits,
        (const int32_t*)tt_fs, (const uint16_t*)next_state, (uint32_t*)words,
        (int32_t*)sizes, k, L, R, W, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int F>
int launch_t(const void* blocks, const void* tt_bits, const void* tt_fs,
             const void* next_state, void* words, void* sizes, int B, int k,
             int L, int R, int W, int T, cudaStream_t s) {
  switch (T) {
    case 512: return launch<512, F>(blocks, tt_bits, tt_fs, next_state, words,
                                    sizes, B, k, L, R, W, s);
    case 256: return launch<256, F>(blocks, tt_bits, tt_fs, next_state, words,
                                    sizes, B, k, L, R, W, s);
    case 128: return launch<128, F>(blocks, tt_bits, tt_fs, next_state, words,
                                    sizes, B, k, L, R, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// blocks (B, (R+1)*k) u8, tt_bits (B, 256) u32, tt_fs (B, 256) i32,
// next_state (B, 2^L) u16 -> words (B, W, k) u32 (every row written),
// sizes (B, k) i32. T threads a CTA (128, 256 or 512, dividing k) and
// a flush every F rounds (4 or 2; F rounds of at most L bits must fit 32).
// Every pointer 16-byte aligned; (R+1)*k below 2^31 and W*k below 2^30 (the
// word offsets are 32-bit byte offsets). Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a pick outside these.
extern "C" int ect_pl_encode(const void* blocks, const void* tt_bits,
                             const void* tt_fs, const void* next_state,
                             void* words, void* sizes, int B, int k, int L,
                             int R, int W, int T, int F, void* stream) {
  if (T <= 0 || k % T || F * L > 32 || (long long)W * k >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 4: return launch_t<4>(blocks, tt_bits, tt_fs, next_state, words,
                               sizes, B, k, L, R, W, T, s);
    case 2: return launch_t<2>(blocks, tt_bits, tt_fs, next_state, words,
                               sizes, B, k, L, R, W, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
