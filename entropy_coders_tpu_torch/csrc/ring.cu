// B3: unidirectional ring all-gather (and int32 all-reduce) over n ranks,
// for Hopper (sm_90a).
//
// Replaces entropy_coders_tpu/parallel/rdma.py::_all_gather_kernel, the
// Pallas TPU kernel launched by _ring_call. Same function, same schedule:
// every rank d first copies its own chunk into slot d of its output
// (n, chunk); then at hop s = 0 .. n-2 it forwards slot (d - s) mod n of its
// output into the same slot of rank d+1's output. After n-1 hops every
// rank's output holds all n chunks in rank order. With `acc`, each rank
// also sums the chunks as 32-bit words (its own, then the one received on
// each hop) into its accumulator: uint32 arithmetic, so the sum wraps
// modulo 2^32 as the JAX int32 accumulate does, without the undefined
// behaviour of signed overflow in C++.
//
// The TPU kernel orders its remote DMAs with a barrier semaphore, DMA
// semaphores and VMEM staging. Here a rank pushes with plain stores through
// a pointer to its right neighbour's output and then raises that rank's flag
// for the hop; the neighbour waits on its own flag with an acquire load.
// One kernel body serves two launchers:
//   * virtual ranks (every rank on one device): one cooperative launch with
//     grid (m, n), rank = blockIdx.y;
//   * peer ranks (distinct GPUs of one process): one cooperative launch per
//     device with grid (m, 1) and that device's rank; the neighbour's
//     buffers are reached through unified addresses after
//     cudaDeviceEnablePeerAccess.
// Each of a rank's m CTAs owns one stripe of the chunk, on every rank the
// same stripe, so a flag per (hop, stripe) orders exactly the bytes its
// CTA waits for.
//
// What bounds it on this card: bytes. Per rank the seed reads and writes
// one chunk and every hop reads and writes one more, so a call moves
// 2 * n * n * chunk bytes. Virtual ranks are bound by device memory: at
// n = 8 on one (264, 16384) u32 lane-word block per rank (17.3 MB) that is
// about 2.2 GB, >= ~0.66 ms at 3.35 TB/s. Peer ranks are bound by NVLink
// (450 GB/s each way). The design copies 16-byte vectors when the chunk
// allows it, neighbouring threads on neighbouring addresses, and spreads
// every rank over as many CTAs as can be resident at once. It is simple
// first: no hop overlaps the next, which a later change can add.
//
// Places where trouble is likely:
//   * Stale or early flags. The wrapper zeroes fresh flags for every call,
//     and in peer mode every launching stream waits on events recorded after
//     all ranks' zeroing: a fast neighbour's flag write must not land before
//     a memset that would erase it (the TPU kernel's start barrier exists
//     for the same reason).
//   * Residency. Every CTA spin-waits on a CTA of another rank, so all of
//     them must be resident at once, or the ring hangs instead of failing.
//     The launches are cooperative (refused when the grid cannot be
//     resident), and the wrapper sizes m from ect_ring_max_ctas and raises
//     before launching when even m = 1 does not fit.
//   * Spinning. One thread per CTA spins on the flag (with __nanosleep),
//     then __syncthreads(); spinning in every thread would waste issue
//     slots. A wait that outlasts kTimeoutNs traps, so a broken ring ends
//     the kernel with an error instead of hanging the card.
//   * Chunk sizes. 16-byte vectors when the chunk is a multiple of 16
//     bytes, else 4-byte words; the wrapper raises ValueError for a chunk
//     that is not a multiple of 4 bytes.
//   * Visibility. Data written by another CTA or device is read with
//     __ldcg (L2, not a possibly stale L1 line), after the acquire.
//   * Launch errors. Every launcher returns cudaGetLastError() (or the
//     launch's own error), and the wrapper raises on a non-zero code.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 32;
constexpr unsigned long long kTimeoutNs = 10ull * 1000 * 1000 * 1000;

struct RingArgs {
  const void* in[kMaxRanks];  // each rank's own chunk
  void* out[kMaxRanks];       // each rank's (n, chunk) output
  uint32_t* acc[kMaxRanks];   // each rank's accumulator, or null
  uint32_t* flags[kMaxRanks]; // each rank's (n - 1, m) hop flags, zeroed
  long long chunk_vecs;       // chunk length in vectors of V
  int n;
  int rank_base;              // rank of blockIdx.y == 0
  int sys;                    // peer ranks: system-scope fences
};

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  return a + b;
}

__device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename V>
__global__ void __launch_bounds__(kThreads) ring_kernel(RingArgs a) {
  const int n = a.n;
  const int rank = a.rank_base + (int)blockIdx.y;
  const int right = (rank + 1) % n;
  const int m = (int)gridDim.x;
  const int stripe = (int)blockIdx.x;
  const long long C = a.chunk_vecs;
  const long long per = (C + m - 1) / m;
  const long long lo = stripe * per;
  const long long hi = lo + per < C ? lo + per : C;

  const V* in = (const V*)a.in[rank];
  V* out = (V*)a.out[rank];
  V* out_right = (V*)a.out[right];
  V* acc = (V*)a.acc[rank];

  // seed: own chunk into own slot; the accumulator starts from it
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    const V v = in[j];
    out[rank * C + j] = v;
    if (acc) acc[j] = v;
  }

  for (int s = 0; s < n - 1; ++s) {
    // forward the chunk received on hop s-1 (own chunk at s = 0); each
    // thread reads back only what it wrote itself or what the acquire
    // below made visible
    const long long slot = ((rank - s) % n + n) % n;
    for (long long j = lo + threadIdx.x; j < hi; j += kThreads)
      out_right[slot * C + j] = __ldcg(out + slot * C + j);
    if (a.sys) __threadfence_system(); else __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      cuda::atomic_ref<uint32_t, cuda::thread_scope_system> sent(
          a.flags[right][s * m + stripe]);
      sent.store(1u, cuda::memory_order_release);
      cuda::atomic_ref<uint32_t, cuda::thread_scope_system> got(
          a.flags[rank][s * m + stripe]);
      const unsigned long long t0 = now_ns();
      while (got.load(cuda::memory_order_acquire) == 0u) {
        if (now_ns() - t0 > kTimeoutNs) __trap();
        __nanosleep(64);
      }
    }
    __syncthreads();
    if (acc) {  // the chunk that just arrived: slot (rank - s - 1) mod n
      const long long recv = ((rank - s - 1) % n + n) % n;
      for (long long j = lo + threadIdx.x; j < hi; j += kThreads)
        acc[j] = add(acc[j], __ldcg(out + recv * C + j));
    }
  }
}

const void* kernel_for(int vec16) {
  return vec16 ? (const void*)ring_kernel<uint4>
               : (const void*)ring_kernel<uint32_t>;
}

}  // namespace

// How many ring CTAs can be resident at once on the current device (SMs x
// CTAs per SM), or minus the CUDA error code.
extern "C" int ect_ring_max_ctas(int vec16) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_for(vec16), kThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}

// Let `dev` store into `peer`'s memory. An access already enabled is not an
// error. The current device is restored.
extern "C" int ect_ring_enable_peer(int dev, int peer) {
  int prev = 0, can = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it: not an error here
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

// One launch of ranks [rank_lo, rank_lo + n_launch) of an n-rank ring on the
// current device and `stream`: ins/outs/accs/flags are host arrays of n
// device pointers (accs all null without accumulate), chunk_bytes a multiple
// of 16 when vec16, else of 4; m CTAs per rank. Returns the launch's error,
// else cudaGetLastError().
extern "C" int ect_ring(const void* const* ins, void* const* outs,
                        void* const* accs, void* const* flags, int n,
                        long long chunk_bytes, int m, int rank_lo,
                        int n_launch, int vec16, int sys, void* stream) {
  if (n < 2 || n > kMaxRanks || m < 1 || rank_lo < 0 || n_launch < 1 ||
      rank_lo + n_launch > n || chunk_bytes % (vec16 ? 16 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.in[r] = ins[r];
    a.out[r] = outs[r];
    a.acc[r] = (uint32_t*)accs[r];
    a.flags[r] = (uint32_t*)flags[r];
  }
  a.chunk_vecs = chunk_bytes / (vec16 ? 16 : 4);
  a.n = n;
  a.rank_base = rank_lo;
  a.sys = sys;
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_for(vec16), dim3(m, n_launch), dim3(kThreads), params, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
