// The per-block crc32 of FLAG_CRC frames, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs zlib.crc32 on the host, one
// block at a time (entropy_coders_tpu/frame.py:317 on compress, :772 on
// decompress), over bytes that the port already holds on the card: the full
// blocks after their h2d (compress) and each per-lane block as B1 decoded it
// (decompress). This kernel checksums them there, so the host only writes
// or compares 4 bytes a block. Same function: each row's crc32 exactly as
// zlib.crc32 gives it (reflected polynomial 0xEDB88320, register set to ~0
// first and inverted last).
//
// What bounds it: bytes. Each byte is read once and 4 bytes a row are
// written: 8 rows of 16 MiB are 134,217,728 bytes, 0.040 ms at 3.35 TB/s.
// Between the loads, a table crc costs one shared-memory lookup a byte.
//
// The design: two launches on the caller's stream, no scratch but the
// caller's (B, U) u32 `partial`.
//  1. crc32_chunks, a persistent grid of CTAs of T threads. A row is one
//     or two pieces (a decoded block is syms ‖ finals), each cut into
//     chunks of T * seg bytes, the last one shorter: U units a row. CTA c
//     takes units c, c + grid, ... Thread t takes the seg bytes of its
//     chunk that end (T - 1 - t) * seg bytes before the chunk's end (the
//     first segment of a short chunk is short, or empty), loads them 16
//     bytes at a time (a byte at a time up to the first 16-byte boundary
//     and after the last), and runs slicing-by-16 over 16 tables of 256
//     entries in shared memory, from register 0: its raw crc r_t.
//  2. The join is linear over GF(2): raw(A ‖ B) = shift(raw(A), |B|) ^
//     raw(B), where shift(c, m) = c * x^(8m) mod P. So a chunk's raw crc
//     is the XOR over its threads of shift(r_t, (T - 1 - t) * seg), and the
//     row's is the XOR over its chunks of shift(chunk, bytes after it in
//     the row). Each thread multiplies by its own power (made once a CTA
//     from kX8, the powers x^(8 * 2^i)), the CTA XORs the products, and
//     warp 0 multiplies by the chunk's power (a product of up to 32 of kX8,
//     one a lane, in a butterfly) and stores partial[row * U + chunk].
//  3. crc32_join, a warp a row: the XOR of the row's U partials, then
//     zlib's register set and final inversion once: crc = raw ^ ~shift(~0,
//     n) for a row of n bytes (n = 0 gives 0).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;
constexpr uint32_t kOne = 0x80000000u;  // the polynomial 1, reflected
constexpr int kMaxThreads = 256;
constexpr int kTables = 16;             // slicing-by-16: one a byte of a load
constexpr int kUnroll = 4;              // 16-byte loads in flight a thread

// x^(8 * 2^i) mod P, reflected: shift(c, 2^i) = mulmod(c, kX8[i])
__constant__ uint32_t kX8[32] = {
    0x00800000u, 0x00008000u, 0xedb88320u, 0xb1e6b092u,
    0xa06a2517u, 0xed627daeu, 0x88d14467u, 0xd7bbfe6au,
    0xec447f11u, 0x8e7ea170u, 0x6427800eu, 0x4d47bae0u,
    0x09fe548fu, 0x83852d0fu, 0x30362f1au, 0x7b5a9cc3u,
    0x31fec169u, 0x9fec022au, 0x6c8dedc4u, 0x15d6874du,
    0x5fde7a4eu, 0xbad90e37u, 0x2e4e5eefu, 0x4eaba214u,
    0xa8a472c0u, 0x429a969eu, 0x148d302au, 0xc40ba6d0u,
    0xc4e22c3cu, 0x40000000u, 0x20000000u, 0x08000000u};

// dynamic shared memory: the 16 tables, then one word a warp
inline size_t smem_bytes(int threads) {
  return (size_t)kTables * 256 * sizeof(uint32_t) +
         (size_t)(threads / 32) * sizeof(uint32_t);
}

// a * b mod P, both reflected (bit 31 the coefficient of x^0)
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 0; i < 32; i++) {
    p ^= (0u - ((a >> (31 - i)) & 1u)) & b;
    b = (b >> 1) ^ ((0u - (b & 1u)) & kPoly);
  }
  return p;
}

// x^(8m) mod P, one thread
__device__ uint32_t xpow8(unsigned long long m) {
  uint32_t r = kOne;
  for (int i = 0; m; i++, m >>= 1)
    if (m & 1) r = mulmod(r, kX8[i]);
  return r;
}

// x^(8m) mod P for m < 2^32, by a whole warp (every lane gets it)
__device__ __forceinline__ uint32_t xpow8_warp(unsigned long long m) {
  const int lane = threadIdx.x & 31;
  uint32_t f = (m >> lane) & 1 ? kX8[lane] : kOne;
  for (int d = 1; d < 32; d <<= 1)
    f = mulmod(f, __shfl_xor_sync(0xFFFFFFFFu, f, d));
  return f;
}

__device__ __forceinline__ uint32_t xor_warp(uint32_t v) {
  for (int d = 16; d; d >>= 1) v ^= __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

__device__ __forceinline__ uint32_t crc_byte(const uint32_t* tab, uint32_t c,
                                             uint32_t b) {
  return (c >> 8) ^ tab[(c ^ b) & 0xFF];
}

// 16 bytes (four little-endian words) into crc c: byte i by table 15 - i
__device__ __forceinline__ uint32_t crc_vec(const uint32_t* tab, uint32_t c,
                                            uint4 v) {
  const uint32_t a = c ^ v.x;
  return tab[15 * 256 + (a & 0xFF)] ^ tab[14 * 256 + ((a >> 8) & 0xFF)] ^
         tab[13 * 256 + ((a >> 16) & 0xFF)] ^ tab[12 * 256 + (a >> 24)] ^
         tab[11 * 256 + (v.y & 0xFF)] ^ tab[10 * 256 + ((v.y >> 8) & 0xFF)] ^
         tab[9 * 256 + ((v.y >> 16) & 0xFF)] ^ tab[8 * 256 + (v.y >> 24)] ^
         tab[7 * 256 + (v.z & 0xFF)] ^ tab[6 * 256 + ((v.z >> 8) & 0xFF)] ^
         tab[5 * 256 + ((v.z >> 16) & 0xFF)] ^ tab[4 * 256 + (v.z >> 24)] ^
         tab[3 * 256 + (v.w & 0xFF)] ^ tab[2 * 256 + ((v.w >> 8) & 0xFF)] ^
         tab[1 * 256 + ((v.w >> 16) & 0xFF)] ^ tab[v.w >> 24];
}

// the raw crc (register 0, no inversion) of len bytes at p, any alignment
__device__ uint32_t segment_crc(const uint32_t* tab, const uint8_t* p,
                                int len) {
  uint32_t c = 0;
  const int head = min(len, (int)((16 - ((uintptr_t)p & 15)) & 15));
  for (int i = 0; i < head; i++) c = crc_byte(tab, c, p[i]);
  const int nvec = (len - head) >> 4;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  int i = 0;
  for (; i + kUnroll <= nvec; i += kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; j++) r[j] = __ldg(v + i + j);
#pragma unroll
    for (int j = 0; j < kUnroll; j++) c = crc_vec(tab, c, r[j]);
  }
  for (; i < nvec; i++) c = crc_vec(tab, c, __ldg(v + i));
  for (int j = head + nvec * 16; j < len; j++) c = crc_byte(tab, c, p[j]);
  return c;
}

__global__ void __launch_bounds__(kMaxThreads)
crc32_chunks(const uint8_t* __restrict__ p1, long long stride1, long long n1,
             const uint8_t* __restrict__ p2, long long stride2, long long n2,
             int B, int seg, int U1, int U2, uint32_t* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* red = tab + kTables * 256;
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // table 0 by eight bit steps; table k is a byte then k zero bytes
  for (int b = tid; b < 256; b += T) {
    uint32_t c = b;
    for (int j = 0; j < 8; j++) c = (c >> 1) ^ ((0u - (c & 1u)) & kPoly);
    tab[b] = c;
  }
  // this thread's power: its segment ends (T - 1 - tid) * seg bytes before
  // its chunk's end
  const uint32_t own = xpow8((unsigned long long)(T - 1 - tid) * seg);
  __syncthreads();
  for (int b = tid; b < 256; b += T) {
    uint32_t c = tab[b];
    for (int k = 1; k < kTables; k++) {
      c = (c >> 8) ^ tab[c & 0xFF];
      tab[k * 256 + b] = c;
    }
  }
  __syncthreads();

  const long long C = (long long)T * seg;  // bytes a chunk
  const int U = U1 + U2;
  const long long units = (long long)B * U;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long row = u / U;
    const int c = (int)(u % U);
    const bool first = c < U1;
    const long long lo = (long long)(first ? c : c - U1) * C;
    const long long n = first ? n1 : n2;
    const long long len = min(C, n - lo);
    const uint8_t* chunk = (first ? p1 + row * stride1 : p2 + row * stride2)
                           + lo;
    const long long after = n - lo - len + (first ? n2 : 0);
    const long long end = len - (long long)(T - 1 - tid) * seg;
    const long long beg = max(0LL, end - seg);
    uint32_t v = 0;
    if (end > 0) v = mulmod(segment_crc(tab, chunk + beg, (int)(end - beg)),
                            own);
    v = xor_warp(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
      uint32_t w = lane < T / 32 ? red[lane] : 0;
      w = xor_warp(w);
      const uint32_t f = xpow8_warp((unsigned long long)after);
      if (lane == 0) partial[u] = mulmod(w, f);
    }
    __syncthreads();  // red is rewritten by the next unit
  }
}

__global__ void __launch_bounds__(32)
crc32_join(const uint32_t* __restrict__ partial, int U, long long n,
           uint32_t* __restrict__ out) {
  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  uint32_t x = 0;
  for (int c = lane; c < U; c += 32) x ^= partial[row * U + c];
  x = xor_warp(x);
  const uint32_t f = xpow8_warp((unsigned long long)n);
  if (lane == 0) out[row] = x ^ ~mulmod(0xFFFFFFFFu, f);
}

}  // namespace

// --- host launchers ---

// CTAs of crc32_chunks of `threads` threads that device `dev` keeps
// resident at once (SMs times CTAs an SM), or -error. The current device is
// restored.
extern "C" int ect_crc32_max_ctas(int dev, int threads) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return -(int)cudaErrorInvalidValue;
  int prev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, crc32_chunks, threads, smem_bytes(threads));
  const cudaError_t back = cudaSetDevice(prev);
  if (err == cudaSuccess) err = back;
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}

// The crc32 of each of B rows into out (B,) u32: row b is the n1 bytes at
// p1 + b * stride1, then the n2 bytes at p2 + b * stride2 (n2 = 0: one
// piece; any alignment). Each piece is cut into chunks of threads * seg
// bytes (seg a multiple of 16), U = ceil(n1 / chunk) + ceil(n2 / chunk)
// units a row, whose joined crcs crc32_chunks writes to partial (B * U
// u32) with `grid` CTAs (grid <= ect_crc32_max_ctas and <= B * U);
// crc32_join then writes out. Both launch on `stream` of the current
// device. Returns the first launch error, else cudaGetLastError().
extern "C" int ect_crc32(const void* p1, long long stride1, long long n1,
                         const void* p2, long long stride2, long long n2,
                         int B, int seg, int U, int grid, int threads,
                         void* partial, void* out, void* stream) {
  if (B < 1 || n1 < 0 || n2 < 0 || (n1 && !p1) || (n2 && !p2) ||
      n1 + n2 >= (1LL << 32) || seg < 16 || seg % 16 || threads < 32 ||
      threads > kMaxThreads || threads % 32 || !out || (U && !partial))
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)threads * seg;
  const long long U1 = (n1 + C - 1) / C, U2 = (n2 + C - 1) / C;
  if (U != U1 + U2 || (U && (grid < 1 || (long long)grid > (long long)B * U)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* a = static_cast<const uint8_t*>(p1);
  const uint8_t* b = static_cast<const uint8_t*>(p2);
  uint32_t* part = static_cast<uint32_t*>(partial);
  if (U) {
    crc32_chunks<<<grid, threads, smem_bytes(threads), s>>>(
        a, stride1, n1, b, stride2, n2, B, seg, (int)U1, (int)U2, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  crc32_join<<<B, 32, 0, s>>>(part, U, n1 + n2,
                              static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
