// Runs csrc/repack.cu's kernels on the host (cuda_runtime.h in this folder),
// with a grid the caller picks: the test builds this file with g++ against a
// copy of repack.cu cut at its host launchers, its PTX helpers replaced by
// their C meaning (cp.async: a copy and a zero fill; commit and wait: no-ops).
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local D3 threadIdx, blockIdx;
D3 gridDim, blockDim;
thread_local EmuWarp* emu_warp;
thread_local std::barrier<>* emu_block_bar;
unsigned char* emu_dyn_smem;

#include "repack_kernels.cu"

template <class F>
void run_grid(unsigned grid, unsigned threads, size_t smem, F body) {
  gridDim.x = grid;
  blockDim.x = threads;
  std::vector<unsigned char> dyn(smem + 16, 0xAB);  // not zeros
  emu_dyn_smem =
      (unsigned char*)(((uintptr_t)dyn.data() + 15) & ~(uintptr_t)15);
  for (unsigned b = 0; b < grid; b++) {
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (unsigned w = 0; w < threads / 32; w++) warps.emplace_back(new EmuWarp);
    std::barrier<> block_bar(threads);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; t++)
      ts.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_block_bar = &block_bar;
        emu_warp = warps[t / 32].get();
        body();  // no kernel leaves a warp before a warp-wide operation
      });
    for (auto& t : ts) t.join();
  }
}

// ect_lane_merge's two launches, the scan on `scan_grid` CTAs and the
// repack's warps on units of C tiles
extern "C" int emu_lane_merge(const void* words, const void* sizes, void* out,
                              long long n_out, void* meta, int B, int W, int k,
                              int pack, int C, int scan_grid) {
  const unsigned grid = (unsigned)repack_ctas(B, k, W, C);
  long long* offs = (long long*)meta;
  long long* bytes = offs + B + 1;
  long long* goff = bytes + B;
  run_grid(scan_grid, kScanThreads, 0, [&] {
    lane_scan_kernel((const int32_t*)sizes, B, k, pack, goff, bytes);
  });
  run_grid(grid, kWarps * 32, kWarps * merge_warp_bytes(C > 1 ? 2 : 1), [&] {
    lane_merge_kernel((const uint32_t*)words, (const int32_t*)sizes, goff,
                      bytes, offs, (uint32_t*)out, n_out, B, W, k, pack, C);
  });
  return 0;
}

// ect_lane_split's two launches
extern "C" int emu_lane_split(const void* packed, long long n_packed,
                              const void* sizes, const void* block_offs,
                              void* goff, void* words, int B, int W, int k,
                              int pack, int C, int scan_grid) {
  const unsigned grid = (unsigned)repack_ctas(B, k, W, C);
  run_grid(scan_grid, kScanThreads, 0, [&] {
    lane_scan_kernel((const int32_t*)sizes, B, k, pack, (long long*)goff,
                     nullptr);
  });
  run_grid(grid, kWarps * 32, kWarps * split_warp_bytes(C > 1 ? 2 : 1), [&] {
    lane_split_kernel((const uint32_t*)packed, n_packed, (const int32_t*)sizes,
                      (const long long*)block_offs, (const long long*)goff,
                      (uint32_t*)words, B, W, k, pack, C);
  });
  return 0;
}
