// Runs csrc/ring.cu's kernel on the host (cuda_runtime.h and cuda/atomic in
// this folder) with every CTA of every rank at once: a CTA waits on CTAs of
// other ranks, so the blocks of a grid cannot run one after the other. One
// std::thread per CUDA thread, a std::barrier per block. The test builds this
// file with g++ against a copy of ring.cu cut at its host launchers, with its
// timer read from a steady clock and kThreads set small (-DRING_THREADS).
//
// Each rank's stream is a thread of its own (one for all ranks on virtual
// ranks). It waits `delay_us`, then fills its ranks' outputs and
// accumulators with 0xA5 bytes (the memory's earlier user, which the stream
// runs before the kernel), runs the grid, and copies the outputs and
// accumulators out at once (the stream's next user). So a rank that stores
// into a peer's output before the peer's kernel has started, or a kernel
// that ends before its output is whole, shows in the copies.
#include <chrono>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local D3 threadIdx, blockIdx;
D3 gridDim, blockDim;
thread_local EmuWarp* emu_warp;
thread_local std::barrier<>* emu_block_bar;
unsigned char* emu_dyn_smem;

#include "ring_kernels.cu"

namespace {

std::atomic<int> emu_traps{0};

// grid (gx, gy) of kThreads threads a block, every thread started at once;
// returns when all have ended. A thread that traps leaves its block's
// barrier, so the rest of the grid runs on and ends.
template <class F>
void run_grid(unsigned gx, unsigned gy, F body) {
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (unsigned b = 0; b < gx * gy; b++)
    bars.emplace_back(new std::barrier<>(kThreads));
  std::vector<std::thread> ts;
  for (unsigned b = 0; b < gx * gy; b++)
    for (unsigned t = 0; t < (unsigned)kThreads; t++)
      ts.emplace_back([&, b, t] {
        threadIdx.x = t;
        blockIdx.x = b % gx;
        blockIdx.y = b / gx;
        emu_block_bar = bars[b].get();
        try {
          body();
        } catch (const EmuTrap&) {
          emu_traps++;
          emu_block_bar->arrive_and_drop();
        }
      });
  for (auto& t : ts) t.join();
}

void run_kernel(int variant, const RingArgs& a) {
  if (variant)
    ring_kernel<uint4>(a);
  else
    ring_kernel<uint32_t>(a);
}

}  // namespace

// One call of ect_ring's kernels with the launcher's arguments (order: n*n
// bytes), each rank's stream started `delay_us[r]` late (virtual ranks:
// delay_us[0]); snap_outs/snap_accs receive what the streams copied out.
// Returns the number of threads that trapped.
extern "C" int emu_ring(const void* const* ins, void* const* outs,
                        void* const* accs, void* const* flags,
                        const signed char* order, void* const* snap_outs,
                        void* const* snap_accs, int n, long long chunk_vecs,
                        long long stripe_vecs, int m, int stride,
                        unsigned long long epoch, int variant, int peer,
                        const int* delay_us) {
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.in[r] = ins[r];
    a.out[r] = outs[r];
    a.acc[r] = (uint32_t*)accs[r];
    a.flags[r] = peer ? (u64*)flags[r] : nullptr;
    for (int i = 0; i < n; ++i) a.order[r][i] = order[r * n + i];
  }
  a.chunk_vecs = chunk_vecs;
  a.stripe_vecs = stripe_vecs;
  a.epoch = epoch;
  a.n = n;
  a.stride = stride;
  a.peer = peer;
  const size_t chunk = (size_t)chunk_vecs * (variant ? 16 : 4);
  gridDim.x = m;
  gridDim.y = peer ? 1 : n;
  blockDim.x = kThreads;
  auto stream = [&](int r0, int ranks) {
    std::this_thread::sleep_for(std::chrono::microseconds(delay_us[r0]));
    for (int r = r0; r < r0 + ranks; ++r) {
      std::memset(outs[r], 0xA5, n * chunk);
      if (accs[r]) std::memset(accs[r], 0xA5, chunk);
    }
    RingArgs own = a;
    own.rank_base = peer ? r0 : 0;
    run_grid(m, peer ? 1 : n, [&] { run_kernel(variant, own); });
    for (int r = r0; r < r0 + ranks; ++r) {
      std::memcpy(snap_outs[r], outs[r], n * chunk);
      if (accs[r]) std::memcpy(snap_accs[r], accs[r], chunk);
    }
  };
  if (peer) {
    std::vector<std::thread> streams;
    for (int r = 0; r < n; ++r) streams.emplace_back(stream, r, 1);
    for (auto& s : streams) s.join();
  } else {
    stream(0, n);
  }
  return emu_traps.exchange(0);
}
