// B2: per-lane tANS encode for the MODE_FSE_PL container, for Hopper (sm_90a).
//
// Replaces entropy_coders_tpu/ops/pl_coder.py::_encode_kernel, the Pallas
// TPU kernel launched by _encode_call and _encode_call_packed. Same function:
// lane i of block b codes the bytes {i, i + k, ..., i + R*k} as a
// reference-format single-stream FSE payload. The lane's last byte (row R of
// the raw block) folds into the initial state (new_first_symbol in its
// floor + 1 form, identical to the reference through L = 14 and well defined
// at 15); rows R-1 ... 0 are then coded in that order, each emitting the
// state's low bits_out = (tt_bits[sym] + state) >> 16 bits and moving to
// next_state[(state >> bits_out) + tt_fs[sym]]; the final state's low L bits
// close the stream. Bit j of the lane's stream lands in bit j & 31 of
// words[b, j >> 5, i]; sizes[b, i] is the stream's length in bits.
//
// What bounds it on the card: as in the decoder, each lane is a serial chain
// of dependent shared-memory lookups (the symbol transform, then the next
// state), reading one byte and writing under two bytes per round, so latency
// and the number of chains in flight bound it, not HBM bytes. One thread per
// lane; tt_bits (256 u32), tt_fs (256 i32) and the 2^L u16 next-state table
// in dynamic shared memory; the symbols are read straight from the raw
// (B, (R+1)*k) block bytes, walking rows R-1 ... 0 with row R as the initial
// symbol (no flipped or padded copy); a 64-bit accumulator flushes whole
// 32-bit words into the lane's column. Neighbouring threads are neighbouring
// lanes, so the byte loads and word stores coalesce across the warp.
//
// The wrapper allocates words with zeros. Next-state indices are masked to L
// bits and word rows at or past W are dropped, so no input, however wrong,
// makes the kernel touch memory outside its arrays.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // k is a multiple of 128 (checked by the wrapper)
constexpr int kMaxGridY = 65535;
constexpr size_t kTransformBytes = 256 * sizeof(uint32_t) + 256 * sizeof(int32_t);

__global__ void __launch_bounds__(kThreads)
pl_encode_kernel(const uint8_t* __restrict__ blocks,
                 const uint32_t* __restrict__ tt_bits,
                 const int32_t* __restrict__ tt_fs,
                 const uint16_t* __restrict__ next_state,
                 uint32_t* __restrict__ words, int32_t* __restrict__ sizes,
                 int k, int L, int R, int W, int b0) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_tb = smem;
  int32_t* s_fs = reinterpret_cast<int32_t*>(smem + 256);
  uint16_t* s_next = reinterpret_cast<uint16_t*>(smem + 512);

  const int64_t b = b0 + blockIdx.y;
  const uint32_t n_tab = 1u << L;
  const uint32_t mask_L = n_tab - 1u;
  for (int j = threadIdx.x; j < 256; j += blockDim.x) {
    s_tb[j] = tt_bits[b * 256 + j];
    s_fs[j] = tt_fs[b * 256 + j];
  }
  for (uint32_t j = threadIdx.x; j < n_tab; j += blockDim.x)
    s_next[j] = next_state[b * n_tab + j];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= k) return;
  const uint8_t* src = blocks + b * (int64_t)(R + 1) * k + lane;
  uint32_t* col = words + b * W * k + lane;

  // initial state from the lane's last byte (new_first_symbol, floor + 1)
  uint32_t sym = src[(int64_t)R * k];
  uint32_t tb = s_tb[sym];
  uint32_t bits_out = (tb >> 16) + 1u;
  const uint32_t value0 = (bits_out << 16) - tb;
  uint32_t state = s_next[((value0 >> bits_out) + (uint32_t)s_fs[sym]) & mask_L];

  uint64_t acc = 0;    // pending bits, LSB first
  uint32_t nacc = 0;   // number of pending bits, < 32 between rounds
  int32_t row = 0;     // next word row of the lane's column
  int32_t total = 0;   // bits emitted so far
  for (int r = R - 1; r >= 0; --r) {
    sym = src[(int64_t)r * k];
    tb = s_tb[sym];
    bits_out = (tb + state) >> 16;
    acc |= (uint64_t)(state & ((1u << bits_out) - 1u)) << nacc;
    nacc += bits_out;
    total += (int32_t)bits_out;
    state = s_next[((state >> bits_out) + (uint32_t)s_fs[sym]) & mask_L];
    if (nacc >= 32) {
      if (row < W) col[(int64_t)row * k] = (uint32_t)acc;
      ++row;
      acc >>= 32;
      nacc -= 32;
    }
  }
  // finish: the final state's low L bits (reference src/fse.rs:248-250)
  acc |= (uint64_t)(state & mask_L) << nacc;
  nacc += L;
  while (nacc > 0) {
    if (row < W) col[(int64_t)row * k] = (uint32_t)acc;
    ++row;
    acc >>= 32;
    nacc = nacc > 32 ? nacc - 32 : 0;
  }
  sizes[b * k + lane] = total + L;
}

}  // namespace

// blocks (B, (R+1)*k) u8, tt_bits (B, 256) u32, tt_fs (B, 256) i32,
// next_state (B, 2^L) u16 -> words (B, W, k) u32 (zeroed by the caller),
// sizes (B, k) i32. Launches on `stream` and returns cudaGetLastError().
extern "C" int ect_pl_encode(const void* blocks, const void* tt_bits,
                             const void* tt_fs, const void* next_state,
                             void* words, void* sizes, int B, int k, int L,
                             int R, int W, void* stream) {
  const size_t smem = kTransformBytes + (sizeof(uint16_t) << L);
  cudaError_t err = cudaFuncSetAttribute(
      pl_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const dim3 grid(k / kThreads, nb);
    pl_encode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const uint32_t*)tt_bits,
        (const int32_t*)tt_fs, (const uint16_t*)next_state, (uint32_t*)words,
        (int32_t*)sizes, k, L, R, W, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
