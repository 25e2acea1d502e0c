// Helpers shared by the per-lane kernels B1 (pl_decode.cu) and B2
// (pl_encode.cu): cp.async for staging tiles and a predicated store.
//
// Both kernels run one thread per lane, each lane a serial chain of R rounds,
// with the block's table copied into every CTA's shared memory. The wrapper
// (ops/pl_coder.py, lane_config) picks the threads per CTA and the rounds
// between flushes (B2) or refill checks (B1); the launchers only check that
// the pick is one they were built for and that it keeps the kernel exact.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ect_lane {

constexpr int kMaxGridY = 65535;

// Sets `kernel`'s dynamic shared memory to `smem` bytes; on failure clears
// the error (it is not sticky, and a later cudaGetLastError must not see it)
// and returns it.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// 16-byte asynchronous copy global -> shared, completion tracked per thread
// by commit groups (sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 4-byte asynchronous copy global -> shared (one lane's word)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A store that only the lanes with `pred` make, as a predicated instruction
// and not a branch: a divergent branch in a serial loop costs every lane of
// the warp its reconvergence.
__device__ __forceinline__ void store_if(uint32_t* p, uint32_t v, bool pred) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q st.global.u32 [%0], %1;\n\t}\n" ::"l"(p),
      "r"(v), "r"((uint32_t)pred));
}

}  // namespace ect_lane
