// Runs csrc/lane_decode.cuh's kernel (B1 and the layout kernel B4/B5) on the
// host (cuda_runtime.h in this folder), one instantiation a table format:
// the test builds this file with g++ against a copy of lane_decode.cuh cut
// at its host launchers, its PTX replaced by its C meaning, and a
// lane_launch.cuh whose cp.async is a copy at once (the strictest order for
// the word ring: a row lands the moment it is asked for). T = 128 threads a
// CTA, one std::thread each, the blocks one after the other.
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local D3 threadIdx, blockIdx;
D3 gridDim, blockDim;
thread_local EmuWarp* emu_warp;
thread_local std::barrier<>* emu_block_bar;
unsigned char* emu_dyn_smem;

#include "lane_decode_kernels.cuh"

namespace {

using namespace ect_lane;
constexpr int T = 128;

template <class F, int RF>
void run(const void* words, const void* sizes, const void* plane0,
         const void* plane1, void* syms, void* finals, void* cursors, int B,
         int W, int k, int L, int R) {
  const size_t smem = sizeof(uint32_t) * F::table_words(1u << L) +
                      kRing * sizeof(uint32_t) * T + 2 * kRows * T;
  std::vector<unsigned char> dyn(smem + 16, 0xAB);  // not zeros
  emu_dyn_smem =
      (unsigned char*)(((uintptr_t)dyn.data() + 15) & ~(uintptr_t)15);
  gridDim.x = k / T;
  gridDim.y = B;
  blockDim.x = T;
  for (int by = 0; by < B; by++)
    for (int bx = 0; bx < k / T; bx++) {
      std::vector<std::unique_ptr<EmuWarp>> warps;
      for (int w = 0; w < T / 32; w++) warps.emplace_back(new EmuWarp);
      std::barrier<> block_bar(T);
      std::vector<std::thread> ts;
      for (int t = 0; t < T; t++)
        ts.emplace_back([&, t] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          emu_block_bar = &block_bar;
          emu_warp = warps[t / 32].get();
          lane_decode_kernel<F, T, RF>(
              (const uint32_t*)words, (const int32_t*)sizes,
              F::table(plane0, plane1), (uint8_t*)syms, (uint8_t*)finals,
              (int32_t*)cursors, W, k, L, R, 0);
        });
      for (auto& t : ts) t.join();
    }
}

template <class F>
int run_rf(int RF, const void* words, const void* sizes, const void* plane0,
           const void* plane1, void* syms, void* finals, void* cursors,
           int B, int W, int k, int L, int R) {
  if (RF == 2)
    run<F, 2>(words, sizes, plane0, plane1, syms, finals, cursors, B, W, k, L, R);
  else
    run<F, 1>(words, sizes, plane0, plane1, syms, finals, cursors, B, W, k, L, R);
  return 0;
}

}  // namespace

// the kernel of `layout` (0 flat, 1 split, 2 upack, 3 fused, 4 nosym), as
// ect_pl_decode_layout launches it with T = 128
extern "C" int emu_lane_decode(int layout, const void* words,
                               const void* sizes, const void* plane0,
                               const void* plane1, void* syms, void* finals,
                               void* cursors, int B, int W, int k, int L,
                               int R, int RF) {
  switch (layout) {
    case 0: return run_rf<FlatFormat>(RF, words, sizes, plane0, plane1, syms, finals, cursors, B, W, k, L, R);
    case 1: return run_rf<SplitFormat>(RF, words, sizes, plane0, plane1, syms, finals, cursors, B, W, k, L, R);
    case 2: return run_rf<UpackFormat>(RF, words, sizes, plane0, plane1, syms, finals, cursors, B, W, k, L, R);
    case 3: return run_rf<FusedFormat>(RF, words, sizes, plane0, plane1, syms, finals, cursors, B, W, k, L, R);
    case 4: return run_rf<NosymFormat>(RF, words, sizes, plane0, plane1, syms, finals, cursors, B, W, k, L, R);
    default: return 1;
  }
}
