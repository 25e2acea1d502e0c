// Instruction latencies on the card, for the chain bounds of B1 and B2
// (tools/lane_shapes.py). Not a port of a TPU kernel: a measurement. One
// thread runs a dependent chain of one operation, 32 steps an iteration, and
// reads the SM's cycle counter before and after. Each step takes the last
// one's result, and no two steps fold into one instruction:
//
//   op 0  SHF   x = rotl(x, a)           shf.l.wrap.b32, a runtime amount
//   op 1  LOP3  x = maj(x, a, b)         lop3.b32 0xE8, (a, b) new each step
//   op 2  IMAD  x = x * x + a            mad.lo.u32
//   op 3  ADD_SHF x = rotl(x + a, b)     add.u32 then shf, a pair a step
//   op 4  LDS   x = *x                   ld.shared.u32, a chase in place
//
// The SASS of latency_kernel<op> (cuobjdump -sass) shows what each became.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 32;

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t x, uint32_t a, uint32_t b) {
  uint32_t y;
  if (OP == 0) {
    asm volatile("shf.l.wrap.b32 %0, %1, %1, %2;" : "=r"(y) : "r"(x), "r"(a));
  } else if (OP == 1) {
    asm volatile("lop3.b32 %0, %1, %2, %3, 0xE8;"
                 : "=r"(y) : "r"(x), "r"(a), "r"(b));
  } else if (OP == 2) {
    asm volatile("mad.lo.u32 %0, %1, %1, %2;" : "=r"(y) : "r"(x), "r"(a));
  } else if (OP == 3) {
    uint32_t t;
    asm volatile("add.u32 %0, %1, %2;" : "=r"(t) : "r"(x), "r"(a));
    asm volatile("shf.l.wrap.b32 %0, %1, %1, %2;" : "=r"(y) : "r"(t), "r"(b));
  } else {
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(y) : "r"(x));
  }
  return y;
}

template <int OP>
__global__ void latency_kernel(const uint32_t* __restrict__ in,
                               long long* __restrict__ cycles,
                               uint32_t* __restrict__ sink, int iters) {
  __shared__ uint32_t s[32];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(s);
  for (int i = 0; i < 32; ++i) s[i] = base + 4u * i;  // each word: its address
  __syncthreads();
  uint32_t v[8];
  for (int j = 0; j < 8; ++j) v[j] = in[j];
  uint32_t x = OP == 4 ? base + 4u * (in[8] & 31u) : in[8];
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) x = step<OP>(x, v[j & 7], v[(j + 3) & 7]);
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = x;
}

template <int OP>
cudaError_t run(const uint32_t* in, long long* cyc, uint32_t* sink,
                int iters) {
  latency_kernel<OP><<<1, 1>>>(in, cyc, sink, 1);  // warm-up: module load
  latency_kernel<OP><<<1, 1>>>(in, cyc, sink, iters);
  return cudaGetLastError();
}

}  // namespace

// Cycles of `iters` iterations of 32 dependent steps of op `op` (above) on
// the current device, written to the host long long at `cycles`. Returns a
// CUDA error code (0 on success).
extern "C" int ect_latency(int op, int iters, void* cycles) {
  const uint32_t h_in[9] = {3, 5, 7, 11, 13, 17, 19, 23, 1};
  uint32_t *in = nullptr, *sink = nullptr;
  long long* cyc = nullptr;
  cudaError_t err = cudaMalloc(&in, sizeof(h_in));
  if (err == cudaSuccess) err = cudaMalloc(&cyc, sizeof(long long));
  if (err == cudaSuccess) err = cudaMalloc(&sink, sizeof(uint32_t));
  if (err == cudaSuccess)
    err = cudaMemcpy(in, h_in, sizeof(h_in), cudaMemcpyHostToDevice);
  if (err == cudaSuccess) {
    switch (op) {
      case 0: err = run<0>(in, cyc, sink, iters); break;
      case 1: err = run<1>(in, cyc, sink, iters); break;
      case 2: err = run<2>(in, cyc, sink, iters); break;
      case 3: err = run<3>(in, cyc, sink, iters); break;
      case 4: err = run<4>(in, cyc, sink, iters); break;
      default: err = cudaErrorInvalidValue;
    }
  }
  if (err == cudaSuccess)
    err = cudaMemcpy(cycles, cyc, sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(in);
  cudaFree(cyc);
  cudaFree(sink);
  return (int)err;
}
