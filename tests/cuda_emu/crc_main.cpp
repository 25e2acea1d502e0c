// Runs csrc/crc32.cu's two kernels on the host (cuda_runtime.h in this
// folder): the test builds this file with g++ against a copy of crc32.cu
// cut at its host launchers, its dynamic shared memory taken from
// `emu_cta_smem`.
//
// crc32_chunks: every CTA of the grid runs at once, a std::thread per CUDA
// thread, each CTA with its own shared memory (filled with 0xAB bytes, not
// zeros) and a barrier of its own for __syncthreads. CTA c starts (grid - 1
// - c) * stagger_us late, so the later CTAs (the later chunks) finish first.
// Then crc32_join, a CTA of 32 threads a row, the rows at once. `partial`
// starts as garbage: a unit the chunk kernel does not store shows.
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

#include "crc32_kernels.cu"

// `grid` CTAs of T threads at once, each running body(c, t)
template <class F>
static void run_grid(int grid, int T, size_t smem, int stagger_us, F body) {
  gridDim.x = grid;
  blockDim.x = T;
  std::vector<std::vector<unsigned char>> mem;
  std::vector<std::unique_ptr<std::barrier<>>> block_bars;
  std::vector<std::unique_ptr<EmuWarp>> warps;
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
        body();
      });
  for (auto& t : ts) t.join();
}

// both kernels as ect_crc32 launches them: the rows of n1 bytes at p1
// (stride1 apart), each followed by n2 bytes at p2 (stride2 apart), U units
// a row over `grid` CTAs of T threads, into partial (B * U) and out (B)
extern "C" int emu_crc32(const void* p1, long long stride1, long long n1,
                         const void* p2, long long stride2, long long n2,
                         int B, int seg, int U, int grid, int T,
                         void* partial, void* out, int stagger_us) {
  if (T < 32 || T % 32 || B < 1 || seg < 16 || seg % 16) return 1;
  const long long C = (long long)T * seg;
  const long long U1 = (n1 + C - 1) / C, U2 = (n2 + C - 1) / C;
  if (U != U1 + U2) return 1;
  if (U) {
    if (grid < 1 || (long long)grid > (long long)B * U) return 1;
    run_grid(grid, T, smem_bytes(T), stagger_us, [&] {
      crc32_chunks((const uint8_t*)p1, stride1, n1, (const uint8_t*)p2,
                   stride2, n2, B, seg, (int)U1, (int)U2,
                   (uint32_t*)partial);
    });
  }
  run_grid(B, 32, 0, 0, [&] {
    crc32_join((const uint32_t*)partial, U, n1 + n2, (uint32_t*)out);
  });
  return 0;
}
