// Runs csrc/fse_coder.cu's kernels (D4, D5) on the host (cuda_runtime.h in
// this folder): the test builds this file with g++ against a copy of
// fse_coder.cu cut at its host launchers, its dynamic shared memory taken
// from `emu_dyn_smem`. Blocks run one after the other, a std::thread per
// CUDA thread; the caller picks D5's lanes a thread and D4's CTA sizes, so
// that a case stays a few warps wide.
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local D3 threadIdx, blockIdx;
D3 gridDim, blockDim;
thread_local EmuWarp* emu_warp;
thread_local std::barrier<>* emu_block_bar;
unsigned char* emu_dyn_smem;

#include "fse_coder_kernels.cu"

namespace {

template <class F>
void run_grid(unsigned gx, unsigned gy, unsigned threads, size_t smem,
              F body) {
  gridDim.x = gx;
  gridDim.y = gy;
  blockDim.x = threads;
  std::vector<unsigned char> dyn(smem + 16, 0xAB);  // not zeros
  emu_dyn_smem =
      (unsigned char*)(((uintptr_t)dyn.data() + 15) & ~(uintptr_t)15);
  for (unsigned by = 0; by < gy; by++)
    for (unsigned bx = 0; bx < gx; bx++) {
      std::vector<std::unique_ptr<EmuWarp>> warps;
      for (unsigned w = 0; w < threads / 32; w++)
        warps.emplace_back(new EmuWarp);
      std::barrier<> block_bar(threads);
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < threads; t++)
        ts.emplace_back([&, t, bx, by] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          emu_block_bar = &block_bar;
          emu_warp = warps[t / 32].get();
          body();
        });
      for (auto& t : ts) t.join();
    }
}

template <int J>
void decode(const void* words, long long Wd, const void* total_bits,
            const void* packed, int size, void* syms, void* emit, void* finals,
            void* done, void* cursor, void* err, void* fstate, int B, int k,
            int L, int R) {
  run_grid(B, 1, decode_threads(k, J), (size_t)size * 4, [&] {
    fse_decode_kernel<J>((const uint32_t*)words, Wd,
                         (const long long*)total_bits,
                         (const uint32_t*)packed, size, (uint8_t*)syms,
                         (long long*)emit, (uint8_t*)finals, (uint8_t*)done,
                         (long long*)cursor, (long long*)err, (int*)fstate, k,
                         L, R);
  });
}

}  // namespace

// D5 (fse_decode_kernel) with J lanes a thread (1, 2, 4 or 8)
extern "C" int emu_fse_decode(const void* words, const void* total_bits,
                              const void* packed, void* syms, void* emit,
                              void* finals, void* done, void* cursor,
                              void* err, void* fstate, int B, long long Wd,
                              int k, int L, int size, int R, int J) {
#define EMU_CASE(n)                                                        \
  case n:                                                                  \
    decode<n>(words, Wd, total_bits, packed, size, syms, emit, finals, done, \
              cursor, err, fstate, B, k, L, R);                            \
    break;
  switch (J) {
    EMU_CASE(1) EMU_CASE(2) EMU_CASE(4) EMU_CASE(8)
    default: return 1;
  }
#undef EMU_CASE
  return 0;
}

// D4's two kernels, the chain on CTAs of chain_T threads, the pack on
// pack_T
extern "C" int emu_fse_encode(const void* syms, const void* valid,
                              const void* init_syms, const void* finish_slots,
                              const void* table, const void* tt_bits,
                              const void* tt_fs, void* words, void* total_bits,
                              void* err, void* sbits, void* svals,
                              void* fstate, int B, int R, int k, int L,
                              int size, long long W, int chain_T, int pack_T) {
  run_grid(B, (k + chain_T - 1) / chain_T, chain_T,
           2 * 256 * 4 + (size_t)size * 2, [&] {
             fse_encode_chain((const uint8_t*)syms, (const uint8_t*)valid,
                              (const uint8_t*)init_syms,
                              (const uint16_t*)table,
                              (const uint32_t*)tt_bits,
                              (const int32_t*)tt_fs, size, (uint8_t*)sbits,
                              (uint16_t*)svals, (int*)fstate,
                              (long long*)err, k, R);
           });
  run_grid(B, 1, pack_T, pack_smem_bytes(pack_T), [&] {
    fse_encode_pack((const uint8_t*)sbits, (const uint16_t*)svals,
                    (const int*)fstate, (const long long*)finish_slots,
                    (uint32_t*)words, (long long*)total_bits,
                    (long long*)err, k, R, L, W);
  });
  return 0;
}

// the launcher's pick of D5's lanes a thread for k lanes
extern "C" int emu_decode_lanes_per_thread(int k) {
  return decode_lanes_per_thread(k);
}
