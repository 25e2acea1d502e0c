// D6: the per-block byte histogram, for Hopper (sm_90a).
//
// Replaces entropy_coders_tpu/ops/histogram.py:36 (_hist_blocks_eqsum: XLA
// code on the TPU, a lax.scan of 256 masked reductions, one streaming pass
// over the data per symbol value; :26 _hist_blocks_scatter is its CPU form).
// Same function: (B, n) uint8 -> (B, 256) counts, each row exactly
// np.bincount of its block, as int64 (the JAX package's are uint32 and wrap
// at 4 GiB; these do not).
//
// What bounds it: bytes. Each input byte is read once and the output is 2 KiB
// a block: 8 blocks of 16 MiB are 134,217,728 bytes, 0.040 ms at 3.35 TB/s.
// The TPU's 256 passes exist because its vector unit has no fast scatter;
// Hopper has native shared-memory atomics, so one pass counts every byte.
//
// The design: one cooperative launch of a persistent grid (no more CTAs than
// fit on the card at once: ect_histogram_max_ctas), no other device work, no
// scratch in device memory.
//  0. The grid zeroes the output, then cg::this_grid().sync(): no memset
//     launch.
//  1. Work units: block b cut into S slices of `slice` bytes (a multiple of
//     16, at most 2^30; the wrapper picks S so that the B * S units fill the
//     grid evenly: ops/histogram.py launch_config). CTA c takes units c,
//     c + grid, ...
//  2. A unit: each warp counts into its own 256-bin u32 sub-histogram in
//     shared memory (shared atomics; warps do not contend with each other).
//     The body is read as 16-byte vectors, kUnroll loads in flight a thread
//     before any is counted. The row start need not be 16-byte aligned (n %
//     16 != 0, a view with a storage offset): the head up to the first
//     16-byte boundary and the tail after the last are counted a byte a
//     thread. A word of four equal bytes is one atomic of 4, a vector of
//     sixteen one of 16, so a constant block does not send 32 lanes to one
//     bin sixteen times a vector.
//  3. After a barrier, thread t sums bin t over the warps' sub-histograms
//     (u32: a slice is < 2^30 bytes), zeroes them for the next unit, and adds
//     a nonzero sum to out[b, t] with a 64-bit global atomic: the slices of
//     a block meet there.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread
constexpr long long kMaxSlice = 1LL << 30;

// dynamic shared memory: one u32 sub-histogram a warp
inline size_t smem_bytes(int threads) {
  return (size_t)(threads / 32) * kBins * sizeof(uint32_t);
}

__device__ __forceinline__ void count_word(uint32_t* h, uint32_t w) {
  const uint32_t b0 = w & 0xFF;
  if (w == b0 * 0x01010101u) {
    atomicAdd(&h[b0], 4u);
    return;
  }
  atomicAdd(&h[b0], 1u);
  atomicAdd(&h[(w >> 8) & 0xFF], 1u);
  atomicAdd(&h[(w >> 16) & 0xFF], 1u);
  atomicAdd(&h[w >> 24], 1u);
}

__device__ __forceinline__ void count_vec(uint32_t* h, uint4 v) {
  if (v.x == v.y && v.x == v.z && v.x == v.w &&
      v.x == (v.x & 0xFF) * 0x01010101u) {
    atomicAdd(&h[v.x & 0xFF], 16u);
    return;
  }
  count_word(h, v.x);
  count_word(h, v.y);
  count_word(h, v.z);
  count_word(h, v.w);
}

__global__ void __launch_bounds__(kMaxThreads, 2)
histogram_kernel(const uint8_t* __restrict__ data, long long n, int B,
                 int slice, int S, unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sub = reinterpret_cast<uint32_t*>(smem);
  const int T = blockDim.x, tid = threadIdx.x, warps = T / 32;
  uint32_t* h = sub + (tid / 32) * kBins;

  const long long n_out = (long long)B * kBins;
  for (long long i = (long long)blockIdx.x * T + tid; i < n_out;
       i += (long long)gridDim.x * T)
    out[i] = 0;
  for (int i = tid; i < warps * kBins; i += T) sub[i] = 0;
  cg::this_grid().sync();  // every zero stored before any count is added

  const long long units = (long long)B * S;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / S;
    const long long lo = (u % S) * slice;
    const int len = (int)(min(n, lo + slice) - lo);
    const uint8_t* p = data + b * n + lo;
    const int head = min(len, (int)((16 - ((uintptr_t)p & 15)) & 15));
    const int nvec = (len - head) >> 4;
    const int tail_at = head + nvec * 16;
    if (tid < head) atomicAdd(&h[p[tid]], 1u);
    if (tid < len - tail_at) atomicAdd(&h[p[tail_at + tid]], 1u);
    const uint4* v = reinterpret_cast<const uint4*>(p + head);
    int i = tid;
    for (; i + (kUnroll - 1) * T < nvec; i += kUnroll * T) {
      uint4 r[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; j++) r[j] = __ldg(v + i + j * T);
#pragma unroll
      for (int j = 0; j < kUnroll; j++) count_vec(h, r[j]);
    }
    for (; i < nvec; i += T) count_vec(h, __ldg(v + i));
    __syncthreads();
    for (int bin = tid; bin < kBins; bin += T) {
      uint32_t total = 0;
      for (int w = 0; w < warps; w++) {
        total += sub[w * kBins + bin];
        sub[w * kBins + bin] = 0;
      }
      if (total)
        atomicAdd(out + b * kBins + bin, (unsigned long long)total);
    }
    __syncthreads();
  }
}

}  // namespace

// --- host launchers ---

// CTAs of `threads` threads that D6 can keep resident on device `dev` at
// once (the cooperative launch's limit): SMs times CTAs an SM, or -error. The
// current device is restored.
extern "C" int ect_histogram_max_ctas(int dev, int threads) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return -(int)cudaErrorInvalidValue;
  int prev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, histogram_kernel, threads, smem_bytes(threads));
  const cudaError_t back = cudaSetDevice(prev);
  if (err == cudaSuccess) err = back;
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}

// D6 on (B, n) bytes at `data` (rows n bytes apart, any alignment) into
// out (B, 256) int64: S = ceil(n / slice) slices a block, `grid` CTAs of
// `threads` threads (grid <= ect_histogram_max_ctas and <= B * S), one
// cooperative launch on `stream` of the current device. Returns the launch's
// error, else cudaGetLastError().
extern "C" int ect_histogram(const void* data, long long n, int B, int slice,
                             int S, int grid, int threads, void* out,
                             void* stream) {
  if (!data || !out || B < 1 || n < 1 || slice < 16 || slice % 16 ||
      slice > kMaxSlice || S != (n + slice - 1) / slice || threads < 32 ||
      threads > kMaxThreads || threads % 32 || grid < 1 ||
      (long long)grid > (long long)B * S)
    return (int)cudaErrorInvalidValue;
  const uint8_t* d = static_cast<const uint8_t*>(data);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  void* args[] = {&d, &n, &B, &slice, &S, &o};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)histogram_kernel, dim3(grid), dim3(threads), args,
      smem_bytes(threads), (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
