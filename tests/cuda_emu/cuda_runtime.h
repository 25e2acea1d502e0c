// A CPU stand-in for the part of the CUDA runtime that the port's kernel
// sources use, so that a kernel body compiles with g++ (-std=c++20) and runs
// on the host: one std::thread per CUDA thread, a 32-thread std::barrier per
// warp for the shuffles and __syncwarp, a barrier per block for
// __syncthreads (each thread holds its block's), `__shared__` variables as
// statics (so blocks that use them run one after the other). Shuffles
// exchange through a 32-slot array per warp: write, wait, read, wait. Fences
// are sequentially consistent fences, __nanosleep a yield, and __trap throws
// EmuTrap, which the launcher catches. __match_any_sync, __any_sync and
// __ballot_sync exchange through the same array. A thread-block cluster is a set of blocks run at once:
// cooperative_groups::this_cluster() reads the cluster (EmuCluster: a
// barrier over all its threads, each block's shared memory) that the
// launcher put in `emu_cluster`. Used by
// tests/test_torch_repack_emulated.py (repack_main.cpp),
// tests/test_torch_ring_emulated.py (ring_main.cpp),
// tests/test_torch_tables_emulated.py (tables_main.cpp),
// tests/test_torch_lane_decode_emulated.py (lane_decode_main.cpp) and
// tests/test_torch_coder_emulated.py (fse_coder_main.cpp) and
// tests/test_torch_histogram_emulated.py (histogram_main.cpp) and
// tests/test_torch_crc_emulated.py (crc_main.cpp). atomicOr,
// atomicMin and atomicAdd (shared or global, 32 or 64 bit) are
// std::atomic_ref operations, __syncthreads_or a vote between barriers. A
// cooperative launch's grid is a set of blocks run at once:
// cooperative_groups::this_grid().sync() is a barrier over all their
// threads (`emu_grid_bar`, which the launcher sets).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __constant__
#define __align__(x) __attribute__((aligned(x)))
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct int4 { int x, y, z, w; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __threadfence_system() { __threadfence(); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
struct EmuTrap {};
[[noreturn]] inline void __trap() { throw EmuTrap{}; }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned shift) {
  const uint64_t v = (uint64_t)hi << 32 | lo;
  return (uint32_t)(v >> (shift & 31));
}
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
// bytes of (y:x) picked by the selector's low four nibbles (no sign mode)
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; i++)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
struct D3 { unsigned x = 0, y = 0, z = 0; };
extern thread_local D3 threadIdx, blockIdx;
extern D3 gridDim, blockDim;
using std::max;
using std::min;
struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t slot[32];
};
extern thread_local EmuWarp* emu_warp;
extern thread_local std::barrier<>* emu_block_bar;
extern unsigned char* emu_dyn_smem;  // the block's dynamic shared memory
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { emu_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
// the block's OR of `pred`: a vote between two barriers, reset after a third
// (blocks that use it run one after the other)
inline int __syncthreads_or(int pred) {
  static std::atomic<int> vote{0};
  emu_block_bar->arrive_and_wait();
  if (pred) vote.fetch_or(1);
  emu_block_bar->arrive_and_wait();
  const int r = vote.load();
  emu_block_bar->arrive_and_wait();
  if (threadIdx.x == 0) vote.store(0);
  return r;
}
template <class T> T emu_shfl(T v, int src) {
  uint64_t raw = 0;
  std::memcpy(&raw, &v, sizeof(T));
  emu_warp->slot[threadIdx.x & 31] = raw;
  emu_warp->bar.arrive_and_wait();
  const uint64_t got = emu_warp->slot[src & 31];
  emu_warp->bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &got, sizeof(T));
  return r;
}
template <class T> T __shfl_sync(unsigned, T v, int l) { return emu_shfl(v, l); }
template <class T> T __shfl_xor_sync(unsigned, T v, int d) {
  return emu_shfl(v, (int)(threadIdx.x & 31) ^ d);
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return emu_shfl(v, lane >= d ? lane - d : lane);
}
template <class T> T __shfl_down_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return emu_shfl(v, lane + d < 32 ? lane + d : lane);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int lane = threadIdx.x & 31;
  emu_warp->slot[lane] = pred != 0;
  emu_warp->bar.arrive_and_wait();
  unsigned bits = 0;
  for (int i = 0; i < 32; i++) bits |= (unsigned)emu_warp->slot[i] << i;
  emu_warp->bar.arrive_and_wait();
  return bits;
}
inline int __any_sync(unsigned, int pred) {
  const int lane = threadIdx.x & 31;
  emu_warp->slot[lane] = pred != 0;
  emu_warp->bar.arrive_and_wait();
  int any = 0;
  for (int i = 0; i < 32; i++) any |= (int)emu_warp->slot[i];
  emu_warp->bar.arrive_and_wait();
  return any;
}
inline unsigned __match_any_sync(unsigned, unsigned v) {
  const int lane = threadIdx.x & 31;
  emu_warp->slot[lane] = v;
  emu_warp->bar.arrive_and_wait();
  unsigned peers = 0;
  for (int i = 0; i < 32; i++)
    if ((unsigned)emu_warp->slot[i] == v) peers |= 1u << i;
  emu_warp->bar.arrive_and_wait();
  return peers;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_or(v);
}
inline unsigned long long atomicMin(unsigned long long* p,
                                    unsigned long long v) {
  std::atomic_ref<unsigned long long> a(*p);
  unsigned long long cur = a.load();
  while (v < cur && !a.compare_exchange_weak(cur, v)) {
  }
  return cur;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(int v) { return v ? __builtin_clz((unsigned)v) : 32; }
inline int __ffs(int v) { return __builtin_ffs(v); }

struct EmuCluster {
  std::barrier<>* bar;         // every thread of every block of the cluster
  unsigned char* smem[8];      // each block's dynamic shared memory
};
extern thread_local EmuCluster* emu_cluster;
extern thread_local unsigned emu_cluster_rank;
extern std::barrier<>* emu_grid_bar;  // every thread of a cooperative grid
namespace cooperative_groups {
struct grid_group {
  void sync() const {
    std::atomic_thread_fence(std::memory_order_seq_cst);
    emu_grid_bar->arrive_and_wait();
  }
};
inline grid_group this_grid() { return {}; }
struct cluster_group {
  void sync() const { emu_cluster->bar->arrive_and_wait(); }
  unsigned block_rank() const { return emu_cluster_rank; }
  template <class T> T* map_shared_rank(T* addr, int rank) const {
    const unsigned char* mine = emu_cluster->smem[emu_cluster_rank];
    return reinterpret_cast<T*>(emu_cluster->smem[rank] +
                                (reinterpret_cast<unsigned char*>(addr) - mine));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
