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
// The design (csrc/lane_decode.cuh, shared with the layout kernel B4/B5):
// one thread per lane, T lanes of one block a CTA (T picked by the wrapper,
// ops/pl_coder.py lane_config, as for B2), the block's 2^L entries in
// dynamic shared memory, re-laid as the chain wants them (FlatFormat); a
// 64-bit bit buffer refilled, predicated, from a ring of word slots that
// cp.async tops up a tile of 32 rounds ahead; the symbols staged in shared
// tiles of 32 rounds and stored 16 bytes at a time. lane_decode.cuh says why
// each piece is there.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_decode.cuh"

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
  return ect_lane::decode_launch_pick<ect_lane::FlatFormat>(
      words, sizes, dtab, nullptr, syms, finals, cursors, B, W, k, L, R, T,
      RF, (cudaStream_t)stream);
}
