// B4/B5: the per-lane tANS decode with a pluggable decode-table entry format,
// for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the decode-layout measurement tools:
// tools/l10_attack.py::make_kernel(...).kern (B4) and
// tools/l10_attack_harness.py::make_kernel(...).kern (B5). Both are B1's lane
// decode (entropy_coders_tpu/ops/pl_coder.py::_decode_kernel) with the table
// lookup made pluggable: an entry_fn(tbl, states) -> (nb, base, sym) decides
// how a decode entry is stored and unpacked. Their bodies are the same text,
// so one kernel templated on the entry format ports both: B1's own kernel
// (csrc/lane_decode.cuh), so that a layout is measured on the kernel that
// ships. The formats (lane_decode.cuh has each one's unpack):
//
//   flat   4 bytes: u32 sym << 24 | nb << 16 | base, re-laid for the chain
//          (B1 itself; the control)
//   split  3 bytes: u16 nb << 12 | base plane, u8 sym plane (L <= 12)
//   upack  2 bytes: u16 sym << 9 | u, u the spread-source state (u < 512):
//          nb = L - ilog2(u), base = (u << nb) - 2^L
//   fused  4 bytes: u32 sym << (L + 4) | nb << L | base
//   nosym  2 bytes: the u16 nb << 12 | base plane alone; sym = half & 0xFF,
//          wrong bytes by design (the bound for any layout that still
//          fetches (nb, base))
//
// What bounds it on the card: B1's limits (the integer ALU, the bytes, the
// chain of a round; csrc/pl_decode.cu), plus what a format changes: the
// instructions of its unpack step on the chain, and the shared memory its
// table takes beside the ring and the tiles, which sets the CTAs an SM
// holds from L = 12 up (flat's table is 4 KiB at L = 10, 32 KiB at L = 13,
// 128 KiB at L = 15). This kernel exists to measure that trade on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_decode.cuh"

namespace {

using namespace ect_lane;

enum Layout : int { kFlat = 0, kSplit = 1, kUpack = 2, kFused = 3, kNosym = 4 };

}  // namespace

// words (B, W, k) u32, sizes (B, k) i32 bit counts, the layout's planes
// (B, 2^L) each (plane1 only for split, else null) -> syms (B, R, k) u8,
// finals (B, k) u8, cursors (B, k) i32. `layout` is 0 flat, 1 split,
// 2 upack, 3 fused, 4 nosym; T and RF as ect_pl_decode takes them (the
// wrapper's lane_config). Every pointer 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was taken), or
// cudaErrorInvalidValue for a layout, T or RF outside these.
extern "C" int ect_pl_decode_layout(const void* words, const void* sizes,
                                    const void* plane0, const void* plane1,
                                    void* syms, void* finals, void* cursors,
                                    int B, int W, int k, int L, int R,
                                    int layout, int T, int RF, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define ECT_LAYOUT(CODE, FORMAT)                                            \
  case CODE:                                                                \
    return decode_launch_pick<FORMAT>(words, sizes, plane0, plane1, syms,   \
                                      finals, cursors, B, W, k, L, R, T, RF,\
                                      s);
  switch (layout) {
    ECT_LAYOUT(kFlat, FlatFormat)
    ECT_LAYOUT(kSplit, SplitFormat)
    ECT_LAYOUT(kUpack, UpackFormat)
    ECT_LAYOUT(kFused, FusedFormat)
    ECT_LAYOUT(kNosym, NosymFormat)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ECT_LAYOUT
}

// Co-resident CTAs an SM of the `layout` instantiation with T threads and
// refill group RF at table log L on the current device (its table, the
// lanes' word ring and the symbol tiles in shared memory, and its
// registers), or -(CUDA error).
extern "C" int ect_pl_decode_layout_occupancy(int layout, int L, int T,
                                              int RF) {
  switch (layout) {
    case kFlat: return decode_occupancy<FlatFormat>(L, T, RF);
    case kSplit: return decode_occupancy<SplitFormat>(L, T, RF);
    case kUpack: return decode_occupancy<UpackFormat>(L, T, RF);
    case kFused: return decode_occupancy<FusedFormat>(L, T, RF);
    case kNosym: return decode_occupancy<NosymFormat>(L, T, RF);
    default: return -(int)cudaErrorInvalidValue;
  }
}
