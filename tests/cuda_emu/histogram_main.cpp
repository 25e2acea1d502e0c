// Runs csrc/histogram.cu's kernel (D6) on the host (cuda_runtime.h in this
// folder): the test builds this file with g++ against a copy of
// histogram.cu cut at its host launchers, its dynamic shared memory taken
// from `emu_cta_smem`.
//
// A cooperative launch: every CTA of the grid runs at once, a std::thread
// per CUDA thread, each CTA with its own shared memory (filled with 0xAB
// bytes, not zeros) and a barrier of its own for __syncthreads; the grid's
// barrier (cooperative_groups::this_grid().sync()) spans all of them. CTA c
// starts (grid - 1 - c) * stagger_us late, so the later CTAs count while the
// first ones are still zeroing: a count added before the grid's barrier is
// lost to a zero stored after it.
#include <chrono>
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local D3 threadIdx, blockIdx;
D3 gridDim, blockDim;
thread_local EmuWarp* emu_warp;
thread_local std::barrier<>* emu_block_bar;
unsigned char* emu_dyn_smem;
thread_local EmuCluster* emu_cluster;
thread_local unsigned emu_cluster_rank;
thread_local unsigned char* emu_cta_smem;
std::barrier<>* emu_grid_bar;

#include "histogram_kernels.cu"

// histogram_kernel on (B, n) bytes at `data` into out (B, 256) int64: S
// slices of `slice` bytes a block, `grid` CTAs of T threads
extern "C" int emu_histogram(const void* data, long long n, int B, int slice,
                             int S, int grid, int T, void* out,
                             int stagger_us) {
  if (T < 32 || T % 32 || grid < 1) return 1;
  gridDim.x = grid;
  blockDim.x = T;
  std::barrier<> grid_bar(grid * T);
  emu_grid_bar = &grid_bar;
  std::vector<std::vector<unsigned char>> mem;
  std::vector<std::unique_ptr<std::barrier<>>> block_bars;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  const size_t smem = smem_bytes(T);
  for (int c = 0; c < grid; c++) {
    mem.emplace_back(smem + 16, 0xAB);
    block_bars.emplace_back(new std::barrier<>(T));
    for (int w = 0; w < T / 32; w++) warps.emplace_back(new EmuWarp);
  }
  std::vector<std::thread> ts;
  for (int c = 0; c < grid; c++)
    for (int t = 0; t < T; t++)
      ts.emplace_back([&, c, t] {
        std::this_thread::sleep_for(
            std::chrono::microseconds((grid - 1 - c) * stagger_us));
        threadIdx.x = t;
        blockIdx.x = c;
        emu_block_bar = block_bars[c].get();
        emu_warp = warps[c * (T / 32) + t / 32].get();
        emu_cta_smem = (unsigned char*)(((uintptr_t)mem[c].data() + 15) &
                                        ~(uintptr_t)15);
        histogram_kernel((const uint8_t*)data, n, B, slice, S,
                         (unsigned long long*)out);
      });
  for (auto& t : ts) t.join();
  return 0;
}
