// B3: all-gather (and uint32 all-reduce) of n equal chunks over n ranks, for
// Hopper (sm_90a).
//
// Replaces entropy_coders_tpu/parallel/rdma.py::_all_gather_kernel, the
// Pallas TPU kernel launched by _ring_call. Same function: every rank's
// output (n, chunk) holds the n chunks in rank order, and with `acc` every
// rank's accumulator holds their sum as 32-bit words modulo 2^32 (uint32
// arithmetic: the JAX int32 accumulate's wrap, without C++'s undefined
// signed overflow). Not the same schedule. The TPU kernel is a ring of n-1
// hops because its ICI is a torus. An H100 box has every card on NVSwitch,
// 450 GB/s out to all peers at once, so here each rank pushes its own chunk
// into slot `rank` of every output in one pass, and no copy waits on another.
//
// One kernel body serves two launches:
//   * virtual ranks (every rank on one device): one plain launch, grid
//     (m, n), rank = blockIdx.y. No flags: the CTAs never wait on one
//     another, so they need not be resident together, and the kernel's end
//     is the barrier. With `acc` a CTA sums its stripe
//     straight from the n inputs.
//   * peer ranks (n distinct GPUs of one process): one cooperative launch a
//     device, grid (m, 1), on that device's stream; the peers' outputs are
//     reached through unified addresses after cudaDeviceEnablePeerAccess.
//     A CTA (rank r, stripe s):
//       (a) raises "r started, epoch e" at every peer's arrival word for
//           (r, s), then waits until every peer has done the same at its
//           own. A peer's kernel has started, so its stream is done with
//           whatever used its fresh output's memory before (the TPU
//           kernel's start barrier);
//       (b) loads its stripe of the chunk once and stores it into slot r of
//           all n outputs, destinations in the wrapper's order: (r + i) % n
//           at step i, so that no two ranks store to one card at once and
//           every link fills;
//       (c) fences at system scope, raises "stripe s done, epoch e" at every
//           peer's completion word for (r, s) and waits for every peer's
//           completion word for (q, s) at its own;
//       (d) with `acc`, sums the n slots of its stripe in rank order.
// Each of a rank's m CTAs owns the same stripe on every rank, so a word per
// (source rank, stripe) orders exactly the bytes its CTA waits for.
//
// Flags: per-mesh state. The wrapper (parallel/rdma.py) makes each card's
// (2, n, stride) 64-bit words once, zeroed (the zeroing finished before any
// launch), beside peer access for every ordered pair and the CTA counts;
// they are never zeroed again. Every call carries the mesh's next epoch (1,
// 2, 3, ...) and a wait passes once a word holds at least that epoch: epochs
// only grow, so a word left by an earlier call, or by a call with more
// stripes, never lets a wait pass early.
//
// What bounds it on this card (bytes: the copy does no arithmetic):
//   * peer ranks: NVLink. Each rank sends (n-1) * chunk at 450 GB/s each
//     way: 0.1153 ms at n = 4 for the 17,301,504-byte (264, 16384) u32
//     lane-word chunk. Local traffic (one read, one write of the own slot)
//     runs beside it at 3.35 TB/s. The design keeps every link busy at once
//     (all destinations in one pass, as many CTAs as can be resident) and
//     pays the handshake's round trips once a CTA, overlapped across CTAs.
//   * virtual ranks: device memory. Each chunk is read once and written n
//     times: (n + n*n) * chunk = 1.246 GB at n = 8, 0.372 ms at 3.35 TB/s
//     (the ring moved 2*n*n*chunk, 2.21 GB). The design reads each vector
//     once into registers and stores it n times, 16 bytes a thread,
//     neighbouring threads on neighbouring addresses.
//
// The copy is vector stores by every thread. A TMA copy (one thread a CTA:
// a cp.async.bulk load of a 16 KiB tile into shared memory with an mbarrier,
// then n bulk stores of it, two tiles in turn) was timed against it in turns
// on H100s: as exact, 1-5% faster on virtual ranks, 8-14% slower on peer
// ranks, where B3 is measured against NCCL; it was dropped (PERF.md).
//
// Places where trouble is likely:
//   * Epochs reused across calls: a peer cannot raise a word to epoch e+1
//     before this CTA has passed its waits of epoch e (the peer's kernel
//     ends only after this CTA's completion), and calls on a mesh run in
//     order because each rank's kernels run on one stream (the wrapper
//     makes a new stream wait on the old one). Waiting for `>=` the epoch
//     rather than `==` keeps that from depending on the exact value.
//   * Another chunk size or stripe count right after a call: the words are
//     laid out by the state's fixed stride (the most CTAs a rank can have),
//     not by this call's m, so stripes never share a word across calls.
//   * The handshake order: every CTA raises before it waits, and raises and
//     waits per peer in separate threads; no wait depends on a raise that
//     comes after it. Completion is raised only after the CTA's stores and a
//     system-scope fence, so a peer that sees it may read the slot and end.
//   * Residency. Every peer CTA spin-waits on CTAs of other cards, so all of
//     them must be resident at once: a peer launch is cooperative (refused
//     when the grid cannot be resident) and the wrapper sizes m from
//     ect_ring_max_ctas and raises before launching when m = 1 does not fit.
//     Virtual CTAs never wait; m is sized to one wave only for speed.
//     A card whose stream is busy elsewhere for longer than kTimeoutNs makes
//     its peers trap.
//   * Spinning: the waiting threads spin with __nanosleep; the rest wait at
//     __syncthreads. A wait past kTimeoutNs traps, so a broken handshake ends
//     the kernel with an error instead of hanging the card.
//   * Chunk sizes: 16-byte vectors when the chunk is a multiple of 16 bytes,
//     else 4-byte words; the wrapper raises for a chunk that is not a
//     multiple of 4 bytes.
//   * Visibility: data another card wrote is read with __ldcg (L2, not a
//     possibly stale L1 line), after the acquire.
//   * Launch errors: the launcher returns the first launch's error, else
//     cudaGetLastError(); the wrapper raises on a non-zero code.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

#ifndef RING_THREADS
#define RING_THREADS 256
#endif
constexpr int kThreads = RING_THREADS;
constexpr int kUnroll = 4;          // vectors a thread loads before storing
constexpr int kMaxRanks = 32;
constexpr unsigned long long kTimeoutNs = 10ull * 1000 * 1000 * 1000;

typedef unsigned long long u64;

struct RingArgs {
  const void* in[kMaxRanks];  // each rank's own chunk
  void* out[kMaxRanks];       // each rank's (n, chunk) output
  uint32_t* acc[kMaxRanks];   // each rank's accumulator, or null
  u64* flags[kMaxRanks];      // peer ranks: each rank's (2, n, stride) words
  // order[r][i]: the i-th destination of rank r's stores; row r starts at r
  // and, at each i, no two ranks store to one destination
  signed char order[kMaxRanks][kMaxRanks];
  long long chunk_vecs;       // chunk length in vectors of V
  long long stripe_vecs;      // a CTA's share of it
  u64 epoch;                  // this call's epoch (peer ranks)
  int n;
  int rank_base;              // rank of blockIdx.y == 0
  int stride;                 // words between (kind, source) rows of flags
  int peer;
};

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  return a + b;
}

__device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// rank `owner`'s word of kind 0 (started) or 1 (done) for (src, stripe)
__device__ __forceinline__ u64* flag(const RingArgs& a, int owner, int kind,
                                     int src, int stripe) {
  return a.flags[owner] + ((long long)kind * a.n + src) * a.stride + stripe;
}

// Raise (kind, rank, stripe) at every peer, then wait until every peer has
// raised (kind, peer, stripe) here; one thread a peer, all threads leave
// together.
__device__ void exchange(const RingArgs& a, int rank, int stripe, int kind) {
  for (int i = 1 + (int)threadIdx.x; i < a.n; i += kThreads) {
    const int q = a.order[rank][i];
    cuda::atomic_ref<u64, cuda::thread_scope_system> f(
        *flag(a, q, kind, rank, stripe));
    f.store(a.epoch, cuda::memory_order_release);
  }
  for (int i = 1 + (int)threadIdx.x; i < a.n; i += kThreads) {
    const int q = a.order[rank][i];
    cuda::atomic_ref<u64, cuda::thread_scope_system> f(
        *flag(a, rank, kind, q, stripe));
    const u64 t0 = now_ns();
    while (f.load(cuda::memory_order_acquire) < a.epoch) {
      if (now_ns() - t0 > kTimeoutNs) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// (b): each thread loads kUnroll vectors, then stores them into slot `rank`
// of every output.
template <typename V>
__device__ void copy_vectors(const RingArgs& a, int rank, long long lo,
                             long long hi) {
  const V* in = (const V*)a.in[rank];
  const long long C = a.chunk_vecs;
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * kThreads < hi) v[u] = __ldcg(in + j + u * kThreads);
    for (int i = 0; i < a.n; ++i) {
      const int q = a.order[rank][i];
      V* dst = (V*)a.out[q] + rank * C + j;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + u * kThreads < hi) dst[u * kThreads] = v[u];
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) ring_kernel(RingArgs a) {
  const int n = a.n;
  const int rank = a.rank_base + (int)blockIdx.y;
  const int stripe = (int)blockIdx.x;
  const long long C = a.chunk_vecs;
  const long long lo = stripe * a.stripe_vecs;
  const long long hi = lo + a.stripe_vecs < C ? lo + a.stripe_vecs : C;

  if (a.peer) exchange(a, rank, stripe, 0);  // (a)
  copy_vectors<V>(a, rank, lo, hi);          // (b)
  V* acc = (V*)a.acc[rank];
  if (a.peer) {  // (c)
    __threadfence_system();
    __syncthreads();
    exchange(a, rank, stripe, 1);
    if (acc) {  // (d) the n slots of the stripe, in rank order
      const V* out = (const V*)a.out[rank];
      for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
        V s = __ldcg(out + j);
        for (int q = 1; q < n; ++q) s = add(s, __ldcg(out + q * C + j));
        acc[j] = s;
      }
    }
  } else if (acc) {  // (d) straight from the n inputs
    for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
      V s = __ldcg((const V*)a.in[0] + j);
      for (int q = 1; q < n; ++q) s = add(s, __ldcg((const V*)a.in[q] + j));
      acc[j] = s;
    }
  }
}

// --- host launchers ---

// variant 0: 4-byte words; 1: 16-byte vectors
const void* kernel_for(int variant) {
  return variant ? (const void*)ring_kernel<uint4>
                 : (const void*)ring_kernel<uint32_t>;
}

}  // namespace

// How many CTAs of `variant` can be resident at once on device `dev` (SMs x
// CTAs per SM), or minus the CUDA error code. The current device is
// restored.
extern "C" int ect_ring_max_ctas(int dev, int variant) {
  if (variant < 0 || variant > 1) return -(int)cudaErrorInvalidValue;
  int prev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_for(variant), kThreads, 0);
  const cudaError_t back = cudaSetDevice(prev);
  if (err == cudaSuccess) err = back;
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}

// Let `dev` store into `peer`'s memory. An access already enabled is not an
// error; a pair that cannot is cudaErrorPeerAccessUnsupported. The current
// device is restored.
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

// One call of B3 on n ranks. ins/outs/accs/flags/devs/streams are host arrays
// of n entries (accs all null without accumulate, flags all null on virtual
// ranks), `order` n*n destination ranks (row r: rank r's stores, a
// permutation that starts at r); chunk_vecs vectors of the variant's width a
// chunk, stripe_vecs of them a CTA, m CTAs a rank, `stride` the flags' row
// length (>= m), `epoch` this call's. Virtual ranks (peer = 0): one plain
// launch of grid (m, n) on devs[0] and streams[0]. Peer ranks: one cooperative
// launch of grid (m, 1) a rank, on devs[r] and streams[r]; a kernel launches
// only on the current device, so the launcher makes each rank's device
// current in turn and restores the caller's. Returns the first launch's
// error, else cudaGetLastError().
extern "C" int ect_ring(const void* const* ins, void* const* outs,
                        void* const* accs, void* const* flags,
                        const signed char* order, const int* devs,
                        void* const* streams, int n, long long chunk_vecs,
                        long long stripe_vecs, int m, int stride,
                        unsigned long long epoch, int variant, int peer) {
  if (n < 2 || n > kMaxRanks || m < 1 || stripe_vecs < 1 || variant < 0 ||
      variant > 1 || (long long)m * stripe_vecs < chunk_vecs ||
      (peer && stride < m))
    return (int)cudaErrorInvalidValue;
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.in[r] = ins[r];
    a.out[r] = outs[r];
    a.acc[r] = (uint32_t*)accs[r];
    a.flags[r] = peer ? (u64*)flags[r] : nullptr;
    for (int i = 0; i < n; ++i) {
      if (order[r * n + i] < 0 || order[r * n + i] >= n)
        return (int)cudaErrorInvalidValue;
      a.order[r][i] = order[r * n + i];
    }
  }
  a.chunk_vecs = chunk_vecs;
  a.stripe_vecs = stripe_vecs;
  a.epoch = epoch;
  a.n = n;
  a.stride = stride;
  a.peer = peer;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  int cur = prev;
  for (int r = 0; err == cudaSuccess && r < (peer ? n : 1); ++r) {
    if (devs[r] != cur) {
      err = cudaSetDevice(devs[r]);
      cur = devs[r];
      if (err != cudaSuccess) break;
    }
    a.rank_base = peer ? r : 0;
    void* params[] = {&a};
    // peer CTAs wait on other cards' CTAs: all of them must be resident
    err = peer ? cudaLaunchCooperativeKernel(kernel_for(variant), dim3(m, 1),
                                             dim3(kThreads), params, 0,
                                             (cudaStream_t)streams[r])
               : cudaLaunchKernel(kernel_for(variant), dim3(m, n),
                                  dim3(kThreads), params, 0,
                                  (cudaStream_t)streams[r]);
  }
  if (cur != prev) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
