// Host codec of the PyTorch + CUDA port: serial k-way interleaved FSE
// (tANS) with the reference wire format, histogram normalization, header
// I/O, tANS table builds and the per-lane stream repack.
//
// A copy of the functions of entropy_coders_tpu/native/fse_native.cpp that
// entropy_coders_tpu_torch calls (ect_compress, ect_decompress,
// ect_read_header, ect_write_header, ect_normalize,
// ect_build_{encode,decode}_tables, ect_lane_{merge,split}_batch) with their
// helpers, so the port owns its host library. Bytes out are the same as the
// JAX package's library; tests/test_torch_host.py holds the two against each
// other. Two changes, neither visible on the wire: ect_normalize takes u64
// counts (a shared table over > 4 GiB of input has counts past u32, as
// spec.histogram.Histogram.from_counts allows), and normalize() refuses only
// size == 0, so a one-byte input normalizes as the spec does. The single
// lane repack functions are internal helpers of the batched ones.
//
// Exposed via a C ABI for ctypes (entropy_coders_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

constexpr int TABLE_LOG_MIN = 5;
constexpr int TABLE_LOG_MAX = 15;
constexpr int TABLE_LOG_DEFAULT = 11;

inline int ilog2_u64(uint64_t x) { return 63 - __builtin_clzll(x); }

// ---------------------------------------------------------------- bit I/O

// LIFO bit writer: LSB-first appends, little-endian byte flushes
// (semantics of reference src/bitstream/writer.rs, incremental form).
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int bits = 0;
  size_t total_bits = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  inline void write(uint32_t val, int nbits) {
    acc |= (uint64_t)(val & ((nbits == 32 ? 0xFFFFFFFFu : ((1u << nbits) - 1)))) << bits;
    bits += nbits;
    total_bits += nbits;
    while (bits >= 8) {
      out.push_back((uint8_t)(acc & 0xFF));
      acc >>= 8;
      bits -= 8;
    }
  }
  // flush the final partial byte; returns total bits written
  size_t finish() {
    if (bits > 0) {
      out.push_back((uint8_t)(acc & 0xFF));
      acc = 0;
      bits = 0;
    }
    return total_bits;
  }
};

// Fast LIFO bit writer for the payload hot loop: same byte semantics as
// BitWriter (LSB-first appends, little-endian byte order) but writes
// through a raw pointer with 32-bit bulk flushes instead of per-byte
// push_back. The caller pre-sizes the destination to the worst-case
// payload bound and truncates after finish(). Little-endian host
// assumed (as is the repo-wide uint32 word layout of the lane repack).
struct FastBitWriter {
  uint8_t* dst;
  size_t bytes = 0;
  uint64_t acc = 0;
  int bits = 0;
  size_t total_bits = 0;

  explicit FastBitWriter(uint8_t* d) : dst(d) {}

  inline void write(uint32_t val, int nbits) {  // nbits <= 16
    acc |= (uint64_t)(val & ((1u << nbits) - 1)) << bits;
    bits += nbits;
    total_bits += nbits;
    if (bits >= 32) {
      uint32_t lo = (uint32_t)acc;
      std::memcpy(dst + bytes, &lo, 4);
      bytes += 4;
      acc >>= 32;
      bits -= 32;
    }
  }
  // flush the partial tail; returns total bits written
  size_t finish() {
    while (bits > 0) {
      dst[bytes++] = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      bits -= 8;
    }
    return total_bits;
  }
};

// Backward (stack) reader over a byte buffer with a terminal marker bit
// (semantics of reference src/bitstream/stack_reader.rs).
struct BitStackReader {
  const uint8_t* data;
  size_t len;
  int64_t pos = -1;  // readable bits below the marker

  bool init(const uint8_t* d, size_t n) {
    data = d;
    len = n;
    if (n == 0) return false;
    size_t last = n;
    while (last > 0 && d[last - 1] == 0) last--;
    if (last == 0) return false;              // all zero: no marker
    if ((n - last) * 8 >= 8) return false;    // dead byte(s) after marker
    int hb = ilog2_u64(d[last - 1]);
    pos = (int64_t)(last - 1) * 8 + hb;
    return true;
  }

  // extract `nbits` at absolute bit offset `at` (little-endian, LSB-first)
  inline uint32_t extract(int64_t at, int nbits) const {
    if (nbits == 0) return 0;
    uint64_t w = 0;
    size_t byte = (size_t)(at >> 3);
    int shift = (int)(at & 7);
    size_t avail = len - byte;
    std::memcpy(&w, data + byte, avail < 8 ? avail : 8);
    return (uint32_t)((w >> shift) & ((1u << nbits) - 1));
  }

  // pop `nbits` from the top of the stack; returns false on underflow.
  inline bool read(int nbits, uint32_t* out) {
    if (nbits > pos) return false;
    pos -= nbits;
    *out = extract(pos, nbits);
    return true;
  }
};

// Buffered backward reader for the decode hot loop: identical pop
// semantics to BitStackReader (which still does init/framing), but
// steady-state reads hit a cached 64-bit window refilled with ONE
// unaligned load every ~3-4 reads instead of a bounds-checked memcpy
// per read. Reads are <= 16 bits and strictly descending, so once the
// window covers a read's top bit it covers every later read until the
// low-end check trips.
struct FastStackReader {
  const uint8_t* data;
  size_t len;
  int64_t pos;                  // readable bits remaining (as BitStackReader)
  uint64_t acc = 0;             // bits [win_lo, win_lo + 64)
  int64_t win_lo = INT64_MAX;   // forces a refill on the first read

  explicit FastStackReader(const BitStackReader& r)
      : data(r.data), len(r.len), pos(r.pos) {}

  inline void refill_for(int nbits) {
    // window base as low as possible while covering bit pos+nbits-1:
    // top = w*8 + 64 >= pos + nbits
    int64_t w = (pos + nbits - 64 + 7) >> 3;
    if (w < 0) w = 0;
    if ((size_t)w + 8 <= len) {
      std::memcpy(&acc, data + w, 8);
    } else {  // top of the buffer: masked partial load
      acc = 0;
      std::memcpy(&acc, data + w, len - (size_t)w);
    }
    win_lo = w * 8;
  }

  inline bool read(int nbits, uint32_t* out) {  // nbits <= 16
    if (nbits > pos) return false;
    pos -= nbits;
    if (pos < win_lo) refill_for(nbits);
    // shift == 64 only when nbits == 0 (mask 0): & 63 keeps the shift
    // defined and the masked result is 0 either way
    *out = (uint32_t)((acc >> ((pos - win_lo) & 63)) & ((1u << nbits) - 1));
    return true;
  }
};

// Forward (stream) reader (semantics of src/bitstream/stream_reader.rs).
struct BitStreamReader {
  const uint8_t* data;
  size_t len;
  size_t total_bits;
  size_t bits_read = 0;

  BitStreamReader(const uint8_t* d, size_t n)
      : data(d), len(n), total_bits(n * 8) {}

  inline bool peek(int nbits, uint32_t* out) const {
    if (bits_read + (size_t)nbits > total_bits) return false;
    uint64_t w = 0;
    size_t byte = bits_read >> 3;
    int shift = (int)(bits_read & 7);
    size_t avail = len - byte;
    std::memcpy(&w, data + byte, avail < 8 ? avail : 8);
    *out = (uint32_t)((w >> shift) & ((nbits >= 32) ? 0xFFFFFFFFu : ((1u << nbits) - 1)));
    return true;
  }
  inline bool advance(int nbits) {
    if (bits_read + (size_t)nbits > total_bits) return false;
    bits_read += nbits;
    return true;
  }
  inline bool read(int nbits, uint32_t* out) {
    if (!peek(nbits, out)) return false;
    bits_read += nbits;
    return true;
  }
  size_t byte_pos_rounded() const { return (bits_read + 7) / 8; }
};

// ------------------------------------------------------- histogram / norm

struct NormHist {
  int32_t table[256];
  int log2;
  int table_len;
};

// exact re-statement of reference src/histogram.rs:93-261
bool normalize(const uint64_t counts[256], uint64_t size, int log2,
               NormHist* out) {
  int table_len = 1;
  for (int i = 255; i >= 0; i--)
    if (counts[i] != 0) { table_len = i + 1; break; }
  // the reference panics on one symbol 0 (table_len 1); size 1 takes the
  // single-symbol early return below, as in spec.histogram
  if (table_len < 2 || size == 0) return false;

  int l2 = log2;
  if (l2 < TABLE_LOG_MIN) l2 = TABLE_LOG_MIN;
  if (l2 > TABLE_LOG_MAX) l2 = TABLE_LOG_MAX;
  int min_l2 = ilog2_u64((uint64_t)(table_len - 1)) + 2;
  if (l2 < min_l2) l2 = min_l2;

  static const uint32_t RTB[8] = {0,      473195, 504333, 520860,
                                  550000, 700000, 750000, 830000};
  uint64_t scale = 62 - (uint64_t)l2;
  uint64_t step = (1ULL << 62) / size;
  uint64_t v_step = 1ULL << (scale - 20);
  uint64_t low_threshold = size >> l2;
  int64_t to_distribute = 1LL << l2;
  int largest = 0;
  int64_t largest_prob = 0;

  std::memset(out->table, 0, sizeof(out->table));
  out->log2 = l2;
  out->table_len = table_len;

  for (int i = 0; i < table_len; i++) {
    uint64_t t = counts[i];
    if (t == size) {  // single-symbol early return
      out->table[i] = (int32_t)to_distribute;
      return true;
    }
    if (t == 0) continue;
    if (t <= low_threshold) {
      out->table[i] = -1;
      to_distribute -= 1;
      continue;
    }
    uint64_t prob = (t * step) >> scale;
    if (prob < 8) {
      uint64_t rest_to_beat = v_step * (uint64_t)RTB[prob];
      prob += (uint64_t)((t * step - (prob << scale)) > rest_to_beat);
    }
    if ((int64_t)prob > largest_prob) {
      largest_prob = (int64_t)prob;
      largest = i;
    }
    out->table[i] = (int32_t)prob;
    to_distribute -= (int64_t)prob;
  }

  if (to_distribute != 0 && -to_distribute >= (largest_prob >> 1)) {
    // slow path (src/histogram.rs:157-261)
    constexpr int32_t UNASSIGNED = -2;
    uint64_t low_one = (size * 3) >> (l2 + 1);
    std::memset(out->table, 0, sizeof(out->table));
    int64_t td = 1LL << l2;
    uint64_t total = size;

    for (int i = 0; i < table_len; i++) {
      uint64_t t = counts[i];
      if (t == 0) continue;
      if (t <= low_threshold) {
        out->table[i] = -1; td -= 1; total -= t;
      } else if (t <= low_one) {
        out->table[i] = 1; td -= 1; total -= t;
      } else {
        out->table[i] = UNASSIGNED;
      }
    }
    if (td == 0) goto done_slow;
    if (td > 0 && total / (uint64_t)td > low_one) {
      uint64_t low = (total * 3) / ((uint64_t)td * 2);
      for (int i = 0; i < table_len; i++) {
        uint64_t t = counts[i];
        if (out->table[i] == UNASSIGNED && t <= low) {
          out->table[i] = 1; td -= 1; total -= t;
        }
      }
    }
    if ((1LL << l2) - td == (int64_t)table_len) {
      uint64_t v_max = 0; int i_max = 0;
      for (int i = 0; i < 256; i++)
        if (counts[i] > v_max) { v_max = counts[i]; i_max = i; }
      out->table[i_max] += (int32_t)td;
      goto done_slow;
    } else if (total == 0) {
      while (td != 0) {
        for (int i = 0; i < table_len && td != 0; i++)
          if (out->table[i] > 0) { out->table[i] += 1; td -= 1; }
      }
    } else {
      uint64_t v_step_log = 62 - (uint64_t)l2;
      uint64_t mid = (1ULL << (v_step_log - 1)) - 1;
      uint64_t r_step = ((1ULL << v_step_log) * (uint64_t)td + mid) / total;
      uint64_t tmp_total = mid;
      for (int i = 0; i < table_len; i++) {
        if (out->table[i] == UNASSIGNED) {
          uint64_t end = tmp_total + (uint64_t)counts[i] * r_step;
          uint64_t weight = (end >> v_step_log) - (tmp_total >> v_step_log);
          if (weight < 1) return false;  // reference panics
          out->table[i] = (int32_t)weight;
          tmp_total = end;
        }
      }
    }
  done_slow:;
  } else {
    out->table[largest] += (int32_t)to_distribute;
  }
  return true;
}

int optimal_log2(const uint64_t counts[256], uint64_t size) {
  int table_len = 1;
  for (int i = 255; i >= 0; i--)
    if (counts[i] != 0) { table_len = i + 1; break; }
  if (table_len < 2 || size < 5) return -1;
  int min_bits_src = ilog2_u64(size) + 1;
  int min_bits_symbols = ilog2_u64((uint64_t)(table_len - 1)) + 2;
  int min_bits = min_bits_src < min_bits_symbols ? min_bits_src : min_bits_symbols;
  int max_bits = ilog2_u64(size - 1) - 2;
  int v = TABLE_LOG_DEFAULT < max_bits ? TABLE_LOG_DEFAULT : max_bits;
  if (v < min_bits) v = min_bits;
  if (v < TABLE_LOG_MIN) v = TABLE_LOG_MIN;
  if (v > TABLE_LOG_MAX) v = TABLE_LOG_MAX;
  return v;
}

// header write (src/histogram.rs:376-431)
size_t write_header(const NormHist& h, std::vector<uint8_t>& out) {
  BitWriter w(out);
  w.write((uint32_t)(h.log2 - TABLE_LOG_MIN), 4);
  int threshold = 1 << h.log2;
  int remaining = threshold + 1;
  int zero_count = 0;
  int num_bits = h.log2 + 1;
  for (int idx = 0; idx < h.table_len; idx++) {
    if (remaining <= 1) break;
    int s = h.table[idx];
    if (zero_count != 0) {
      if (s == 0) { zero_count += 1; continue; }
      zero_count -= 1;
      while (zero_count >= 24) { w.write(0xFFFF, 16); zero_count -= 24; }
      while (zero_count >= 3) { w.write(0x3, 2); zero_count -= 3; }
      w.write((uint32_t)zero_count, 2);
    }
    int maxv = (2 * threshold - 1) - remaining;
    remaining -= s < 0 ? -s : s;
    int count = s + 1;
    if (count >= threshold) count += maxv;
    int bits_to_write = num_bits - (count < maxv ? 1 : 0);
    w.write((uint32_t)count, bits_to_write);
    zero_count = (count == 1) ? 1 : 0;
    while (remaining < threshold) { num_bits -= 1; threshold >>= 1; }
  }
  return w.finish();
}

// header read (src/histogram.rs:436-505); returns header bytes or 0 on error
size_t read_header(const uint8_t* src, size_t n, NormHist* h) {
  if (n == 0) return 0;
  BitStreamReader r(src, n);
  uint32_t v;
  if (!r.read(4, &v)) return 0;
  int l2 = (int)v + TABLE_LOG_MIN;
  if (l2 > TABLE_LOG_MAX) return 0;
  std::memset(h->table, 0, sizeof(h->table));
  h->log2 = l2;
  int symbol = 0;
  int threshold = 1 << l2;
  int remaining = threshold + 1;
  int read_bit_count = l2 + 1;
  bool previous0 = false;

  while (remaining > 1 && symbol < 256) {
    if (previous0) {
      while (r.peek(16, &v) && v == 0xFFFF) { r.advance(16); symbol += 24; }
      while (r.peek(2, &v) && v == 3) { r.advance(2); symbol += 3; }
      if (!r.read(2, &v)) return 0;
      symbol += (int)v;
    }
    if (symbol >= 256) break;
    int maxv = (2 * threshold - 1) - remaining;
    uint32_t raw;
    int used = read_bit_count;
    if (!r.peek(read_bit_count, &raw)) {
      if (!r.peek(read_bit_count - 1, &raw)) return 0;
      used = read_bit_count - 1;
    }
    (void)used;
    int32_t value;
    if ((int)(raw & (uint32_t)(threshold - 1)) < maxv) {
      if (!r.advance(read_bit_count - 1)) return 0;
      value = (int32_t)(raw & (uint32_t)(threshold - 1));
    } else {
      if (!r.advance(read_bit_count)) return 0;
      value = (int32_t)(raw & (uint32_t)(2 * threshold - 1));
      if (value >= threshold) value -= maxv;
    }
    value -= 1;
    remaining -= value < 0 ? -value : value;
    h->table[symbol] = value;
    symbol += 1;
    previous0 = (value == 0);
    while (remaining < threshold) { read_bit_count -= 1; threshold >>= 1; }
  }
  if (remaining != 1) return 0;
  h->table_len = symbol;
  return r.byte_pos_rounded();
}

// ------------------------------------------------------------ tANS tables

struct EncTable {
  int table_log;
  std::vector<uint16_t> table;
  uint32_t tt_bits[256];
  int32_t tt_fs[256];
};

struct DecEntry { uint16_t new_state; uint8_t symbol; uint8_t num_bits; };
struct DecTable {
  int table_log;
  std::vector<DecEntry> table;
};

// spread (src/fse.rs:119-151)
static void spread(const NormHist& h, std::vector<uint8_t>& symbols,
                   int* high_threshold_out) {
  int size = 1 << h.log2;
  symbols.assign(size, 0);
  int high_threshold = size - 1;
  for (int i = 0; i < h.table_len; i++)
    if (h.table[i] == -1) symbols[high_threshold--] = (uint8_t)i;
  int position = 0;
  int mask = size - 1;
  int step = size * 5 / 8 + 3;
  for (int i = 0; i < h.table_len; i++) {
    for (int j = 0; j < h.table[i]; j++) {
      symbols[position] = (uint8_t)i;
      position = (position + step) & mask;
      while (position > high_threshold) position = (position + step) & mask;
    }
  }
  *high_threshold_out = high_threshold;
}

void build_encode(const NormHist& h, EncTable* et) {
  int size = 1 << h.log2;
  et->table_log = h.log2;
  std::vector<uint8_t> symbols;
  int ht;
  spread(h, symbols, &ht);

  uint32_t cumul[257] = {0};
  {
    uint32_t acc = 0;
    for (int i = 0; i < h.table_len; i++) {
      cumul[i] = acc;
      acc += (h.table[i] == -1) ? 1u : (uint32_t)h.table[i];
    }
  }
  et->table.assign(size, 0);
  for (int i = 0; i < size; i++) {
    int x = symbols[i];
    et->table[cumul[x]++] = (uint16_t)(size + i);
  }

  std::memset(et->tt_bits, 0, sizeof(et->tt_bits));
  std::memset(et->tt_fs, 0, sizeof(et->tt_fs));
  int32_t total = 0;
  int L = h.log2;
  for (int s = 0; s < h.table_len; s++) {
    int32_t x = h.table[s];
    if (x == 0) {
      et->tt_bits[s] = (uint32_t)(((L + 1) << 16) - (1 << L));
    } else if (x == -1 || x == 1) {
      et->tt_bits[s] = (uint32_t)((L << 16) - (1 << L));
      et->tt_fs[s] = total - 1;
      total += 1;
    } else {
      int max_bits_out = L - ilog2_u64((uint64_t)(x - 1));
      uint32_t min_state_plus = (uint32_t)x << max_bits_out;
      et->tt_bits[s] = ((uint32_t)max_bits_out << 16) - min_state_plus;
      et->tt_fs[s] = total - x;
      total += x;
    }
  }
}

void build_decode(const NormHist& h, DecTable* dt) {
  int size = 1 << h.log2;
  dt->table_log = h.log2;
  dt->table.assign(size, DecEntry{0, 0, 0});

  uint16_t symbol_next[256] = {0};
  int high_threshold = size - 1;
  for (int s = 0; s < h.table_len; s++) {
    if (h.table[s] <= -1) {
      dt->table[high_threshold--].symbol = (uint8_t)s;
      symbol_next[s] = 1;
    } else {
      symbol_next[s] = (uint16_t)h.table[s];
    }
  }
  int position = 0;
  int mask = size - 1;
  int step = size * 5 / 8 + 3;
  for (int s = 0; s < h.table_len; s++) {
    for (int j = 0; j < h.table[s]; j++) {
      dt->table[position].symbol = (uint8_t)s;
      position = (position + step) & mask;
      while (position > high_threshold) position = (position + step) & mask;
    }
  }
  for (int i = 0; i < size; i++) {
    uint8_t sym = dt->table[i].symbol;
    uint16_t next_state = symbol_next[sym]++;
    uint8_t nb = (uint8_t)(h.log2 - ilog2_u64(next_state));
    dt->table[i].num_bits = nb;
    dt->table[i].new_state =
        (uint16_t)(((uint32_t)next_state << nb) - (uint32_t)size);
  }
}

// --------------------------------------------------------------- encoders

struct Encoder {
  uint32_t value = 0;
  inline void init_first(const EncTable& t, uint8_t sym) {
    // floor+1 instead of the reference's (b + 2^15) >> 16
    // (src/fse.rs:213): identical for table_log <= 14, well-defined at
    // 15 where the reference's form underflows u32.
    uint32_t b = t.tt_bits[sym];
    uint32_t bits_out = (b >> 16) + 1;
    value = (bits_out << 16) - b;
    int32_t idx = (int32_t)(value >> bits_out) + t.tt_fs[sym];
    value = t.table[idx];
  }
  template <class Writer>
  inline void encode(const EncTable& t, Writer& w, uint8_t sym) {
    uint32_t b = t.tt_bits[sym];
    uint32_t bits_out = (b + value) >> 16;
    w.write(value, (int)bits_out);
    int32_t idx = (int32_t)(value >> bits_out) + t.tt_fs[sym];
    value = t.table[idx];
  }
};

}  // namespace

// ================================================================== C ABI

extern "C" {

// Compress with a k-way interleaved frame (header + payload), identical
// bytes to spec.codec.fse_compress. log2 < 0 picks optimal_log2 (the
// reference's fse_compress behavior, src/histogram.rs:299-303); an
// explicit log2 mirrors Histogram::normalize(log2). Returns 0 on success.
int ect_compress(const uint8_t* src, size_t n, int k, int log2, uint8_t* dst,
                 size_t dst_cap, size_t* out_len) {
  if (n < (size_t)(k > 2 ? k : 2) || k < 1 || k > 65535) return 1;
  uint64_t counts[256] = {0};
  for (size_t i = 0; i < n; i++) counts[src[i]]++;
  int l2 = log2 < 0 ? optimal_log2(counts, n) : log2;
  if (l2 < 0) return 2;
  NormHist h;
  if (!normalize(counts, n, l2, &h)) return 2;
  // single-symbol (full-table) normalization: the read-until-failure
  // decoder never terminates on such a frame (see spec.codec
  // fse_compress docstring; reference lib.rs:199-207) — refuse to emit
  for (int i = 0; i < 256; i++)
    if (h.table[i] == (int32_t)1 << h.log2) return 2;

  std::vector<uint8_t> out;
  write_header(h, out);

  EncTable et;
  build_encode(h, &et);
  // worst-case payload bound: every symbol emits <= table_log bits, the
  // k finals add table_log each, + marker bit + FastBitWriter's 4-byte
  // flush slack. The scratch is deliberately UNINITIALIZED (new[]
  // without ()) — a vector resize would memset the whole bound (up to
  // ~2x the input) just for the writer to overwrite it.
  size_t hdr = out.size();
  size_t bound = ((uint64_t)n * h.log2 + 1 + 7) / 8 + 8;
  std::unique_ptr<uint8_t[]> payload(new uint8_t[bound]);
  FastBitWriter w(payload.get());

  std::vector<Encoder> encs(k);
  for (int j = 0; j < k; j++)
    encs[(n - k + j) % k].init_first(et, src[n - k + j]);
  if (n > (size_t)k) {
    int s = (int)((n - k - 1) % (size_t)k);  // lane of the next symbol
    for (int64_t i = (int64_t)n - k - 1; i >= 0; i--) {
      encs[s].encode(et, w, src[i]);
      s = (s == 0) ? k - 1 : s - 1;
    }
  }
  for (int s = k - 1; s >= 0; s--)
    w.write(encs[s].value, et.table_log);
  w.write(1, 1);
  size_t pbytes = (w.finish() + 7) / 8;

  if (hdr + pbytes > dst_cap) return 3;
  std::memcpy(dst, out.data(), hdr);
  std::memcpy(dst + hdr, payload.get(), pbytes);
  *out_len = hdr + pbytes;
  return 0;
}

// Decompress a k-way frame. Returns 0 on success.
int ect_decompress(const uint8_t* src, size_t n, int k, uint8_t* dst,
                   size_t dst_cap, size_t* out_len) {
  if (k < 1) return 1;
  NormHist h;
  size_t hdr = read_header(src, n, &h);
  if (hdr == 0) return 1;
  // degenerate single-symbol table: every decode step reads 0 bits, the
  // loop below would never hit a failing read (reference bug, see
  // ect_compress) — treat as a framing error
  for (int i = 0; i < 256; i++)
    if (h.table[i] == (int32_t)1 << h.log2) return 1;

  DecTable dt;
  build_decode(h, &dt);

  BitStackReader r0;
  if (!r0.init(src + hdr, n - hdr)) return 1;
  FastStackReader r(r0);  // buffered steady-state reads, same semantics

  std::vector<uint16_t> states(k);
  for (int s = 0; s < k; s++) {
    uint32_t v;
    if (!r.read(dt.table_log, &v)) return 1;
    states[s] = (uint16_t)v;
  }

  size_t pos = 0;
  int s = 0;  // == pos % k, maintained incrementally (no per-symbol div)
  for (;;) {
    const DecEntry& e = dt.table[states[s]];
    uint32_t low;
    if (!r.read(e.num_bits, &low)) {
      // flush finals cyclically from the failed lane (src/lib.rs:233-243)
      for (int j = 0; j < k; j++) {
        if (pos >= dst_cap) return 3;
        dst[pos++] = dt.table[states[(s + j) % k]].symbol;
      }
      break;
    }
    if (pos >= dst_cap) return 3;
    dst[pos] = e.symbol;
    states[s] = (uint16_t)(e.new_state + low);
    pos++;
    if (++s == k) s = 0;
  }
  *out_len = pos;
  return 0;
}

// Batched tANS table builds from normalized histograms (the frame codec
// builds its tables on the host and ships them to the device).
// Semantics identical to spec.fse (tests pin equality).
// Returns 0 on success, nonzero if any histogram is malformed.

// Validate + complete a raw normalized table (the same invariant
// NormHistogram::try_from enforces, reference src/histogram.rs:508-536):
// counts in [-1, 2^log2], slot mass summing to exactly 2^log2, >= 2
// symbols. The spread/fill loops index by cumulative count, so a
// malformed table would write out of bounds — reject it instead.
static bool init_norm_hist(const int32_t* table, int32_t log2, NormHist* h) {
  std::memcpy(h->table, table, 256 * sizeof(int32_t));
  h->log2 = log2;
  h->table_len = 1;
  int64_t slots = 0;
  for (int i = 255; i >= 0; i--)
    if (h->table[i] != 0) { h->table_len = i + 1; break; }
  for (int i = 0; i < 256; i++) {
    int32_t c = h->table[i];
    if (c < -1 || c > (int32_t)1 << log2) return false;
    slots += (c == -1) ? 1 : c;
  }
  return slots == (int64_t)1 << log2 && h->table_len >= 2;
}

int ect_build_encode_tables(const int32_t* tables /*B x 256*/, int32_t B,
                            int32_t log2, uint16_t* table_out /*B x 2^log2*/,
                            uint32_t* tt_bits_out /*B x 256*/,
                            int32_t* tt_fs_out /*B x 256*/) {
  if (log2 < TABLE_LOG_MIN || log2 > TABLE_LOG_MAX || B < 0) return 1;
  size_t size = (size_t)1 << log2;
  for (int32_t b = 0; b < B; b++) {
    NormHist h;
    if (!init_norm_hist(tables + (size_t)b * 256, log2, &h)) return 2;
    EncTable et;
    build_encode(h, &et);
    std::memcpy(table_out + (size_t)b * size, et.table.data(),
                size * sizeof(uint16_t));
    std::memcpy(tt_bits_out + (size_t)b * 256, et.tt_bits,
                sizeof(et.tt_bits));
    std::memcpy(tt_fs_out + (size_t)b * 256, et.tt_fs, sizeof(et.tt_fs));
  }
  return 0;
}

int ect_build_decode_tables(const int32_t* tables /*B x 256*/, int32_t B,
                            int32_t log2,
                            uint32_t* packed_out /*B x 2^log2*/) {
  if (log2 < TABLE_LOG_MIN || log2 > TABLE_LOG_MAX || B < 0) return 1;
  size_t size = (size_t)1 << log2;
  for (int32_t b = 0; b < B; b++) {
    NormHist h;
    if (!init_norm_hist(tables + (size_t)b * 256, log2, &h)) return 2;
    DecTable dt;
    build_decode(h, &dt);
    uint32_t* out = packed_out + (size_t)b * size;
    for (size_t i = 0; i < size; i++) {
      const DecEntry& e = dt.table[i];
      out[i] = ((uint32_t)e.symbol << 24) | ((uint32_t)e.num_bits << 16)
               | e.new_state;
    }
  }
  return 0;
}

// Parse a histogram header. Returns header byte length, 0 on error.
size_t ect_read_header(const uint8_t* src, size_t n, int32_t* table_out,
                       int32_t* log2_out, int32_t* table_len_out) {
  NormHist h;
  size_t hdr = read_header(src, n, &h);
  if (hdr == 0) return 0;
  std::memcpy(table_out, h.table, sizeof(h.table));
  *log2_out = h.log2;
  *table_len_out = h.table_len;
  return hdr;
}

// Write a histogram header from a normalized table. Returns byte length,
// 0 on error.
size_t ect_write_header(const int32_t* table, int32_t log2,
                        int32_t table_len, uint8_t* dst, size_t cap) {
  NormHist h;
  std::memcpy(h.table, table, sizeof(h.table));
  h.log2 = log2;
  h.table_len = table_len;
  std::vector<uint8_t> out;
  write_header(h, out);
  if (out.size() > cap) return 0;
  std::memcpy(dst, out.data(), out.size());
  return out.size();
}

// Normalize raw counts (exact reference semantics). Returns effective
// log2, or -1 on error (degenerate input the reference cannot encode).
int ect_normalize(const uint64_t* counts, uint64_t size, int32_t log2,
                  int32_t* table_out) {
  NormHist h;
  int l2 = log2 >= 0 ? log2 : optimal_log2(counts, size);
  if (l2 < 0) return -1;
  if (!normalize(counts, size, l2, &h)) return -1;
  std::memcpy(table_out, h.table, sizeof(h.table));
  return h.log2;
}

}  // extern "C"

namespace {

// --- per-lane stream repack (MODE_FSE_PL wire <-> kernel layout) ---------
//
// Wire: k byte-aligned lane streams concatenated in lane order, lane i
// occupying ceil(sizes_bits[i]/8) bytes. Kernel layout: (W, k) u32,
// words[w*k + i] = word w of lane i. The repack is a lane-major copy then
// a cache-blocked u32 transpose (two linear passes, no per-byte strided
// traffic).

void transpose_u32(const uint32_t* src, uint32_t* dst, size_t rows,
                   size_t cols) {
  // src (rows, cols) -> dst (cols, rows)
  constexpr size_t BR = 64, BC = 16;
  for (size_t r0 = 0; r0 < rows; r0 += BR)
    for (size_t c0 = 0; c0 < cols; c0 += BC) {
      size_t r1 = r0 + BR < rows ? r0 + BR : rows;
      size_t c1 = c0 + BC < cols ? c0 + BC : cols;
      for (size_t r = r0; r < r1; r++)
        for (size_t c = c0; c < c1; c++)
          dst[c * rows + r] = src[r * cols + c];
    }
}

// Split the wire payload into the padded (W, k) u32 array. Returns bytes
// consumed, or -1 if the payload is too short.
int64_t lane_split(const uint8_t* payload, size_t plen,
                   const int32_t* sizes_bits, int32_t k, int32_t W,
                   uint32_t* out) {
  std::vector<uint32_t> tmp((size_t)k * W, 0);
  size_t off = 0;
  for (int32_t i = 0; i < k; i++) {
    size_t nbytes = ((size_t)sizes_bits[i] + 7) / 8;
    if (off + nbytes > plen || nbytes > (size_t)W * 4) return -1;
    std::memcpy(&tmp[(size_t)i * W], payload + off, nbytes);
    off += nbytes;
  }
  transpose_u32(tmp.data(), out, k, W);
  return (int64_t)off;
}

// Compact the padded (W, k) u32 array back into the wire payload (whose
// capacity must be >= sum ceil(sizes/8)). Returns bytes written.
int64_t lane_merge(const uint32_t* words, int32_t W, int32_t k,
                   const int32_t* sizes_bits, uint8_t* out) {
  std::vector<uint32_t> tmp((size_t)k * W);
  transpose_u32(words, tmp.data(), W, k);
  size_t off = 0;
  for (int32_t i = 0; i < k; i++) {
    size_t nbytes = ((size_t)sizes_bits[i] + 7) / 8;
    std::memcpy(out + off, &tmp[(size_t)i * W], nbytes);
    off += nbytes;
  }
  return (int64_t)off;
}

// ----------------------------------------------- bit-packed wire mode
// (frame FLAG_PACKED): lane streams concatenate at BIT granularity,
// recovering the <= 7 dead bits each byte-aligned lane stream carries
// (the reference's payloads are bit-packed end to end, reference:
// src/bitstream/writer.rs:177-222). Little-endian unaligned 64-bit
// read-modify-writes; callers provide 8 bytes of slack past the end.



// Pack the padded (W, k) u32 array into a bit-packed payload of
// sum(sizes) bits. `out` must be zeroed, with capacity
// ceil(total/8) + 8 slack bytes. Dead bits above each lane's top bit
// must already be zero in `words` (the kernels guarantee this).
// Returns payload bytes written (excluding slack).
int64_t lane_merge_bits(const uint32_t* words, int32_t W, int32_t k,
                        const int32_t* sizes_bits, uint8_t* out) {
  std::vector<uint32_t> tmp((size_t)k * W);
  transpose_u32(words, tmp.data(), W, k);
  // sequential accumulator (FastBitWriter) instead of per-word
  // overlapping 8-byte read-modify-writes: every output byte is stored
  // exactly once, no store-to-load forwarding stalls
  FastBitWriter wtr(out);
  for (int32_t i = 0; i < k; i++) {
    const uint32_t* src = &tmp[(size_t)i * W];
    int64_t nbits = sizes_bits[i];
    int64_t w = 0;
    for (; nbits >= 32; nbits -= 32, w++) {
      uint32_t v = src[w];  // 32 > FastBitWriter's 16-bit limit: halves
      wtr.write(v & 0xFFFF, 16);
      wtr.write(v >> 16, 16);
    }
    if (nbits > 0) {
      uint32_t v = src[w] & ((1u << nbits) - 1);
      if (nbits > 16) {
        wtr.write(v & 0xFFFF, 16);
        wtr.write(v >> 16, (int)nbits - 16);
      } else {
        wtr.write(v, (int)nbits);
      }
    }
  }
  return (int64_t)((wtr.finish() + 7) / 8);
}

// Inverse: extract each lane's sizes[i] bits from the packed payload
// into the (W, k) u32 layout. `payload` needs 8 slack bytes past plen.
// Returns total payload bytes consumed, or -1 if the sizes overrun it.
int64_t lane_split_bits(const uint8_t* payload, size_t plen,
                        const int32_t* sizes_bits, int32_t k,
                        int32_t W, uint32_t* out) {
  uint64_t total = 0;
  for (int32_t i = 0; i < k; i++) total += (uint64_t)sizes_bits[i];
  if ((total + 7) / 8 > plen) return -1;
  std::vector<uint32_t> tmp((size_t)k * W, 0);
  // sequential read accumulator (mirror of the merge's FastBitWriter):
  // one aligned-stride 4-byte load per 32 consumed bits instead of an
  // unaligned 8-byte load per word. Callers guarantee 8 readable slack
  // bytes past the payload (the ctypes wrappers pad).
  uint64_t acc = 0;
  int bits = 0;
  size_t pos = 0;
  uint64_t consumed = 0;
  for (int32_t i = 0; i < k; i++) {
    uint32_t* dst = &tmp[(size_t)i * W];
    int64_t nbits = sizes_bits[i];
    if ((nbits + 31) / 32 > W) return -1;
    consumed += (uint64_t)nbits;
    for (int64_t w = 0; nbits > 0; nbits -= 32, w++) {
      int nb = nbits >= 32 ? 32 : (int)nbits;
      if (bits < nb) {
        uint32_t v;
        std::memcpy(&v, payload + pos, 4);
        acc |= (uint64_t)v << bits;
        bits += 32;
        pos += 4;
      }
      dst[w] = (uint32_t)(acc & (((uint64_t)1 << nb) - 1));
      acc >>= nb;
      bits -= nb;
    }
  }
  transpose_u32(tmp.data(), out, k, W);
  return (int64_t)((consumed + 7) / 8);
}

}  // namespace

extern "C" {

// Batched merge over a whole block group: words (B, W, k) contiguous,
// sizes (B, k); block b writes its payload at out + offs[b] (the caller
// lays offs out so regions are disjoint, with >= 8 slack bytes per block
// when pack_bits, since the bit packer RMWs past the last byte).
// OpenMP-parallel over blocks (the repack is host work on the codec's
// end-to-end path).
// Returns 0, or -(b+1) if block b's merge overran its region.
int ect_lane_merge_batch(const uint32_t* words, int64_t B, int32_t W,
                         int32_t k, const int32_t* sizes_bits,
                         const int64_t* offs, uint8_t* out,
                         int32_t pack_bits) {
  int64_t bad = 0;
#pragma omp parallel for schedule(dynamic)
  for (int64_t b = 0; b < B; b++) {
    const uint32_t* w = words + (size_t)b * W * k;
    const int32_t* sz = sizes_bits + (size_t)b * k;
    uint8_t* dst = out + offs[b];
    int64_t n = pack_bits ? lane_merge_bits(w, W, k, sz, dst)
                          : lane_merge(w, W, k, sz, dst);
    if (n < 0) bad = b + 1;  // benign race: any failing block reports
  }
  return bad ? (int)-bad : 0;
}

// Batched split: per-block payload pointers (pack_bits payloads must be
// readable 8 bytes past plens[b] — the Python wrapper pads), fills the
// contiguous (B, W, k) out array. Returns 0, or -(b+1) if block b's
// payload is too short for its claimed sizes.
int ect_lane_split_batch(const uint8_t* const* payloads,
                         const int64_t* plens, int64_t B,
                         const int32_t* sizes_bits, int32_t k, int32_t W,
                         uint32_t* out, int32_t pack_bits) {
  int64_t bad = 0;
#pragma omp parallel for schedule(dynamic)
  for (int64_t b = 0; b < B; b++) {
    const int32_t* sz = sizes_bits + (size_t)b * k;
    uint32_t* dst = out + (size_t)b * W * k;
    int64_t n = pack_bits
        ? lane_split_bits(payloads[b], (size_t)plens[b], sz, k, W, dst)
        : lane_split(payloads[b], (size_t)plens[b], sz, k, W, dst);
    if (n < 0) bad = b + 1;
  }
  return bad ? (int)-bad : 0;
}

}  // extern "C"
