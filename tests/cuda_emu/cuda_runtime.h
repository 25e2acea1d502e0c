// A CPU stand-in for the part of the CUDA runtime that the port's kernel
// sources use, so that a kernel body compiles with g++ (-std=c++20) and runs
// on the host: one std::thread per CUDA thread, a 32-thread std::barrier per
// warp for the shuffles and __syncwarp, a barrier per block for
// __syncthreads, `__shared__` variables as statics (the blocks of a grid run
// one after the other). Shuffles exchange through a 32-slot array per warp:
// write, wait, read, wait. Used by tests/test_torch_repack_emulated.py.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
#define __align__(x) alignas(x)
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct int4 { int x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
template <class T> T __ldg(const T* p) { return *p; }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned shift) {
  const uint64_t v = (uint64_t)hi << 32 | lo;
  return (uint32_t)(v >> (shift & 31));
}
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
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
extern std::barrier<>* emu_block_bar;
extern unsigned char* emu_dyn_smem;  // the block's dynamic shared memory
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { emu_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
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
