// Runs csrc/fse_coder.cu's kernels (D4, D5) on the host (cuda_runtime.h in
// this folder): the test builds this file with g++ against a copy of
// fse_coder.cu cut at its host launchers, its dynamic shared memory taken
// from `emu_dyn_smem` and lane_launch.cuh's cp.async a copy at once. Blocks
// run one after the other, a std::thread per CUDA thread. The caller names
// the kernel (0 D5's one-thread kernel, 1 the wide one, 2 the one-warp
// one, -1 the launch rule's) and may shrink the wide kernels' rings and D4's sub-rounds, so
// that a small case reaches their wrap, their reads from device memory and
// their sub-rounds; the lanes a thread and the CTA are the launch rule's.
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#include "cuda_runtime.h"

thread_local D3 threadIdx, blockIdx;
D3 gridDim, blockDim;
thread_local EmuWarp* emu_warp;
thread_local std::barrier<>* emu_block_bar;
unsigned char* emu_dyn_smem;

#include "fse_coder_kernels.cu"

namespace {

template <class F>
void run_grid(unsigned grid, unsigned threads, size_t smem, F body) {
  gridDim.x = grid;
  blockDim.x = threads;
  std::vector<unsigned char> dyn(smem + 16, 0xAB);  // not zeros
  emu_dyn_smem =
      (unsigned char*)(((uintptr_t)dyn.data() + 15) & ~(uintptr_t)15);
  for (unsigned bx = 0; bx < grid; bx++) {
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (unsigned w = 0; w < threads / 32; w++)
      warps.emplace_back(new EmuWarp);
    std::barrier<> block_bar(threads);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; t++)
      ts.emplace_back([&, t, bx] {
        threadIdx.x = t;
        blockIdx.x = bx;
        emu_block_bar = &block_bar;
        emu_warp = warps[t / 32].get();
        body();
      });
    for (auto& t : ts) t.join();
    std::fill(dyn.begin(), dyn.end(), 0xAB);
  }
}

template <int N>
using IntC = std::integral_constant<int, N>;

template <class F>
int with_lanes(int n, F f) {
  switch (n) {
    case 1: f(IntC<1>{}); return 0;
    case 2: f(IntC<2>{}); return 0;
    case 4: f(IntC<4>{}); return 0;
    case 8: f(IntC<8>{}); return 0;
    case 16: f(IntC<16>{}); return 0;
    case 32: f(IntC<32>{}); return 0;
    case 64: f(IntC<64>{}); return 0;
    default: return 1;
  }
}

int path_of(int path, int dir, int k) { return path >= 0 ? path : rule(dir, k); }

}  // namespace

// D5; ring_words and group (D5 one-thread's blocks a CTA) 0: the
// launcher's
extern "C" int emu_fse_decode(const void* words, const void* total_bits,
                              const void* packed, void* syms, void* emit,
                              void* finals, void* done, void* cursor,
                              void* err, int B, long long Wd, int k, int L,
                              int size, int R, int path, int ring_words,
                              int group) {
  path = path_of(path, 0, k);
  auto go = [&](auto checked) {
    constexpr bool C = decltype(checked)::value;
    if (path == 2) {
      if (k > kOneWarp) return 1;
      run_grid(B, kOneCta,
               (size_t)(size + 4) / 4 * 16 + 4 * kOnePay + 2 * (kOneTile + 16),
               [&] {
                 fse_decode_warp<C>(
                     (const uint32_t*)words, Wd, (const long long*)total_bits,
                     (const uint32_t*)packed, size, (uint8_t*)syms,
                     (long long*)emit, (uint8_t*)finals, (uint8_t*)done,
                     (long long*)cursor, (long long*)err, k, L, R);
               });
      return 0;
    }
    if (path == 0)
      return with_lanes(k <= kDecodeOneThread ? k : 0, [&](auto kc) {
        constexpr int K = decltype(kc)::value;
        const int seg = one_thread_segment(size);
        const int G = group > 0 ? group : one_thread_group(size);
        if constexpr (K <= kDecodeOneThread)
          run_grid((B + G - 1) / G, kOneCta, (size_t)G * seg, [&] {
            fse_decode_one<K, C>(
                (const uint32_t*)words, Wd, (const long long*)total_bits,
                (const uint32_t*)packed, size, (uint8_t*)syms,
                (long long*)emit, (uint8_t*)finals, (uint8_t*)done,
                (long long*)cursor, (long long*)err, k, L, R, B, G, seg);
          });
      });
    const int ring = ring_words ? ring_words : decode_ring_words(k, L);
    return with_lanes(wide_lanes(k), [&](auto jc) {
      constexpr int J = decltype(jc)::value;
      run_grid(B, wide_threads(k, J),
               (size_t)(size + 4) / 4 * 16 + (size_t)ring * 4, [&] {
                 fse_decode_wide<J, C>(
                     (const uint32_t*)words, Wd, (const long long*)total_bits,
                     (const uint32_t*)packed, size, (uint8_t*)syms,
                     (long long*)emit, (uint8_t*)finals, (uint8_t*)done,
                     (long long*)cursor, (long long*)err, k, L, R, ring);
               });
    });
  };
  return err ? go(std::true_type{}) : go(std::false_type{});
}

// D4; ring_words and sub 0: the launcher's
extern "C" int emu_fse_encode(const void* syms, const void* valid,
                              const void* init_syms, const void* finish_slots,
                              const void* table, const void* tt_bits,
                              const void* tt_fs, void* words, void* total_bits,
                              void* err, int B, int R, int k, int L, int size,
                              long long W, int path, int ring_words, int sub) {
  path = path_of(path, 1, k);
  const int tsize = encode_table_slots(size);
  const size_t tables = 2 * 256 * 4 + (size_t)tsize * 2;
  auto go = [&](auto checked) {
    constexpr bool C = decltype(checked)::value;
    if (path == 0) return 1;  // no one-thread D4
    if (path == 2) {
      if (k > kOneWarp) return 1;
      run_grid(B, kOneCta, tables + 24 * (size_t)kOneTile + 4 * (kOneTile + 2),
               [&] {
                 fse_encode_warp<C>(
                     (const uint8_t*)syms, (const uint8_t*)valid,
                     (const uint8_t*)init_syms, (const long long*)finish_slots,
                     (const uint16_t*)table, (const uint32_t*)tt_bits,
                     (const int32_t*)tt_fs, size, tsize, (uint32_t*)words,
                     (long long*)total_bits, (long long*)err, k, L, R, W);
               });
      return 0;
    }
    return with_lanes(wide_lanes(k), [&](auto jc) {
      constexpr int J = decltype(jc)::value;
      const int T = wide_threads(k, J);
      const int s = sub ? sub : encode_sub_threads(T, J, L);
      const int ring = ring_words ? ring_words : encode_ring_words(s, J, L);
      run_grid(B, T, tables + (size_t)(k + 7) / 8 * 16 + (size_t)ring * 4,
               [&] {
                 fse_encode_wide<J, C>(
                     (const uint8_t*)syms, (const uint8_t*)valid,
                     (const uint8_t*)init_syms, (const long long*)finish_slots,
                     (const uint16_t*)table, (const uint32_t*)tt_bits,
                     (const int32_t*)tt_fs, size, tsize, (uint32_t*)words,
                     (long long*)total_bits, (long long*)err, k, L, R, W,
                     ring, s);
               });
    });
  };
  return err ? go(std::true_type{}) : go(std::false_type{});
}

// the launch rule: the kernel (0 one-thread, 1 wide, 2 one-warp) for k
// lanes in direction dir (0 decode, 1 encode)
extern "C" int emu_fse_path(int dir, int k) { return rule(dir, k); }

extern "C" int emu_fse_wide_lanes(int k) { return wide_lanes(k); }

// the smallest ring D4 wide may take for sub-rounds of `sub` threads
extern "C" int emu_fse_encode_ring(int sub, int J, int L) {
  return encode_ring_words(sub, J, L);
}
