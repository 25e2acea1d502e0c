// B1: per-lane tANS decode for the MODE_FSE_PL container, for Hopper (sm_90a).
//
// Replaces entropy_coders_tpu/ops/pl_coder.py::_decode_kernel, the Pallas
// TPU kernel launched by _decode_call. Same function, same layouts at the
// boundary: block b, lane i decodes the reference-format single-stream FSE
// payload held in column i of words[b] (bit j of the stream is bit j & 31 of
// word j >> 5). The cursor starts at size - L, the initial state is the top
// L bits; each of R rounds looks up (sym, nb, base) = table[state], moves the
// cursor down by nb, sets state = base + bits[c, c + nb) and writes sym. The
// lane's final symbol is table[state].sym, and its final cursor is written
// out: a lane that does not end at exactly 0 marks a corrupt stream.
//
// What bounds it on the card: each lane is a serial chain of dependent steps
// (a shared-memory table lookup, a variable-width bit read, the next state),
// and per round a lane moves one byte out and under two bytes of stream in.
// So the limit is the latency of that chain and how many chains are in
// flight, not HBM bytes. The design answers with one thread per lane (a
// 16 MiB block at k = 16384 puts 16384 independent chains on the card), the
// block's 2^L 32-bit entries (sym << 24 | nb << 16 | base) in dynamic shared
// memory, and a 64-bit bit buffer per thread that refills one 32-bit word at
// a time from the lane's own column. Neighbouring threads are neighbouring
// lanes, so every refill and every symbol store coalesces across the warp.
//
// Rows outside [0, W) read as zero, as the JAX kernel's _fetch_chunk makes
// them: on a corrupt stream the cursor goes negative and no load leaves the
// words array. States are masked to L bits, so no lookup leaves the table.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // k is a multiple of 128 (checked by the wrapper)
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ uint32_t load_row(const uint32_t* __restrict__ col,
                                             int32_t row, int W, int k) {
  return (row >= 0 && row < W) ? col[(int64_t)row * k] : 0u;
}

__global__ void __launch_bounds__(kThreads)
pl_decode_kernel(const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ sizes,
                 const uint32_t* __restrict__ dtab,
                 uint8_t* __restrict__ syms, uint8_t* __restrict__ finals,
                 int32_t* __restrict__ cursors, int W, int k, int L, int R,
                 int b0) {
  extern __shared__ uint32_t s_tab[];
  const int64_t b = b0 + blockIdx.y;
  const uint32_t n_tab = 1u << L;
  const uint32_t mask_L = n_tab - 1u;
  const uint32_t* tab = dtab + b * n_tab;
  for (uint32_t j = threadIdx.x; j < n_tab; j += blockDim.x) s_tab[j] = tab[j];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= k) return;
  const uint32_t* col = words + b * W * k + lane;

  // buf holds stream bits [pos, pos + 64); pos is a multiple of 32 and the
  // cursor c stays in [pos, pos + 32] between rounds, so a read of nb <= 15
  // bits at the new cursor needs at most one refill of one word.
  int32_t c = sizes[b * k + lane] - L;
  int32_t row = c >> 5;  // floor, also for a negative (corrupt) cursor
  int32_t pos = row * 32;
  uint64_t buf = (uint64_t)load_row(col, row, W, k) |
                 ((uint64_t)load_row(col, row + 1, W, k) << 32);
  uint32_t state = (uint32_t)(buf >> (c - pos)) & mask_L;

  uint8_t* out = syms + b * R * k + lane;
  for (int r = 0; r < R; ++r) {
    const uint32_t e = s_tab[state];
    const uint32_t nb = (e >> 16) & 0xFFu;
    c -= (int32_t)nb;
    if (c < pos) {
      pos -= 32;
      buf = (buf << 32) | load_row(col, pos >> 5, W, k);
    }
    const uint32_t low = (uint32_t)(buf >> (c - pos)) & ((1u << nb) - 1u);
    state = ((e & 0xFFFFu) + low) & mask_L;
    out[(int64_t)r * k] = (uint8_t)(e >> 24);
  }
  finals[b * k + lane] = (uint8_t)(s_tab[state] >> 24);
  cursors[b * k + lane] = c;
}

}  // namespace

// words (B, W, k) u32, sizes (B, k) i32 bit counts, dtab (B, 2^L) u32 ->
// syms (B, R, k) u8, finals (B, k) u8, cursors (B, k) i32. Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was taken).
extern "C" int ect_pl_decode(const void* words, const void* sizes,
                             const void* dtab, void* syms, void* finals,
                             void* cursors, int B, int W, int k, int L, int R,
                             void* stream) {
  const size_t smem = sizeof(uint32_t) << L;
  cudaError_t err = cudaFuncSetAttribute(
      pl_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const dim3 grid(k / kThreads, nb);
    pl_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int32_t*)sizes, (const uint32_t*)dtab,
        (uint8_t*)syms, (uint8_t*)finals, (int32_t*)cursors, W, k, L, R, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
