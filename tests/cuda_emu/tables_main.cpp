// Runs csrc/tables.cu's kernel on the host (cuda_runtime.h in this folder):
// the test builds this file with g++ against a copy of tables.cu cut at its
// host launchers, its dynamic shared memory taken from `emu_cta_smem`.
//
// The tables run one after the other; the C blocks of a table's cluster run
// at once, a std::thread per CUDA thread, each block with its own shared
// memory (filled with 0xAB bytes, not zeros) and the cluster's barrier over
// all of them. Block r of a cluster starts (C - 1 - r) * stagger_us late, so
// the last block runs ahead of the ones whose counts it reads: a read of
// another block's shared memory before the cluster's barrier sees 0xAB.
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

#include "tables_kernels.cu"

namespace {

template <int HALF>
void run(const void* norm, void* dec, void* next_state, void* tt_bits,
         void* tt_fs, int B, int L, int C, int T, int stagger_us) {
  const size_t smem = smem_bytes((1 << L) / C, T);
  gridDim.x = B * C;
  blockDim.x = T;
  for (int b = 0; b < B; b++) {
    std::vector<std::vector<unsigned char>> mem;
    EmuCluster cluster{};
    std::barrier<> cluster_bar(C * T);
    cluster.bar = &cluster_bar;
    std::vector<std::unique_ptr<std::barrier<>>> block_bars;
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int r = 0; r < C; r++) {
      mem.emplace_back(smem + 16, 0xAB);
      cluster.smem[r] =
          (unsigned char*)(((uintptr_t)mem[r].data() + 15) & ~(uintptr_t)15);
      block_bars.emplace_back(new std::barrier<>(T));
      for (int w = 0; w < T / 32; w++) warps.emplace_back(new EmuWarp);
    }
    std::vector<std::thread> ts;
    for (int r = 0; r < C; r++)
      for (int t = 0; t < T; t++)
        ts.emplace_back([&, r, t] {
          std::this_thread::sleep_for(
              std::chrono::microseconds((C - 1 - r) * stagger_us));
          threadIdx.x = t;
          blockIdx.x = b * C + r;
          emu_block_bar = block_bars[r].get();
          emu_warp = warps[r * (T / 32) + t / 32].get();
          emu_cluster = &cluster;
          emu_cluster_rank = r;
          emu_cta_smem = cluster.smem[r];
          build_tables_kernel<HALF>(
              (const int32_t*)norm, (uint32_t*)dec, (uint16_t*)next_state,
              (uint32_t*)tt_bits, (int32_t*)tt_fs, L, C);
        });
    for (auto& t : ts) t.join();
  }
}

}  // namespace

// ect_build_tables's kernel on B tables, half 1 (decode), 2 (encode) or 3
// (both), clusters of C blocks of T threads
extern "C" int emu_build_tables(const void* norm, void* dec, void* next_state,
                                void* tt_bits, void* tt_fs, int B, int L,
                                int half, int C, int T, int stagger_us) {
  switch (half) {
    case 1: run<1>(norm, dec, next_state, tt_bits, tt_fs, B, L, C, T, stagger_us); break;
    case 2: run<2>(norm, dec, next_state, tt_bits, tt_fs, B, L, C, T, stagger_us); break;
    case 3: run<3>(norm, dec, next_state, tt_bits, tt_fs, B, L, C, T, stagger_us); break;
    default: return 1;
  }
  return 0;
}
