// Zstandard frame decoder (RFC 8878), written for the checkpoint reader.
//
// It decodes every frame of a buffer, one after another, into one output
// buffer: raw, RLE and compressed blocks; literals that are raw, RLE, or
// Huffman-coded in 1 or 4 streams (a new table, or the previous one for
// treeless literals); sequences whose codes are predefined, RLE, FSE coded
// or repeated from the previous block; repeat offsets; frames with and
// without a content size; skippable frames. A frame's content checksum,
// when present, is verified (XXH64, low 32 bits). Dictionaries are not
// supported: a frame that names one is an error.
//
// Every read is bounds-checked against its section and every write against
// the output's capacity; a corrupt or truncated input is reported with the
// byte offset into the input at which decoding failed.
//
// C interface (all functions return 0 on success, else 1 with a message):
//   dis_zstd_bound(src, n, &bound, &exact, err, errcap)
//       walks the frames' and blocks' headers and returns an upper bound of
//       the decoded size; exact = 1 when every frame states its size.
//   dis_zstd_decompress(src, n, dst, cap, &written, err, errcap)
//   dis_crc32c(data, n) -> the CRC-32C of the bytes (used by the OCDBT
//       reader to check its manifests and b-tree nodes).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
  size_t offset;
};

[[noreturn]] void fail(const std::string& msg, size_t offset) {
  throw DecodeError{msg, offset};
}

inline uint64_t load_le(const uint8_t* p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

constexpr size_t kBlockMax = 128 * 1024;

// ---------------------------------------------------------------- bits

// A forward little-endian bit reader (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t size;       // bytes available
  size_t base;       // offset of p in the input, for messages
  uint64_t bitpos = 0;

  uint32_t peek(int n) const {  // n <= 32; past the end reads zeros
    uint64_t byte = bitpos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i)
      if (byte + i < size) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (bitpos & 7)) & ((uint64_t(1) << n) - 1));
  }
  void skip(int n) {
    bitpos += n;
    if (bitpos > uint64_t(size) * 8)
      fail("truncated FSE table description", base + size);
  }
  size_t bytes_used() const { return size_t((bitpos + 7) >> 3); }
};

// A backward bit stream (Huffman and FSE payloads): its last byte holds a
// marker bit above the padding; bits are read from there down to bit 0.
struct BackBits {
  const uint8_t* p;
  size_t size;
  size_t base;
  int64_t bitpos;    // bits left; below 0 after reading past the start

  BackBits(const uint8_t* p_, size_t size_, size_t base_)
      : p(p_), size(size_), base(base_) {
    if (size == 0) fail("empty bit stream", base);
    uint8_t last = p[size - 1];
    if (last == 0) fail("bit stream without an end marker", base + size - 1);
    bitpos = int64_t(size) * 8 - (8 - highbit32(last));
  }
  // The n bits just below the read position (n <= 56), zeros below bit 0.
  inline uint64_t peek(int n) const {
    if (n == 0) return 0;
    int64_t lo = bitpos - n;
    uint64_t mask = (uint64_t(1) << n) - 1;
    if (lo >= 0) {
      size_t byte = size_t(lo >> 3);
      uint64_t v;
      if (byte + 8 <= size) {
        std::memcpy(&v, p + byte, 8);
      } else {
        v = load_le(p + byte, size - byte);
      }
      return (v >> (lo & 7)) & mask;
    }
    if (bitpos <= 0) return 0;
    uint64_t v = load_le(p, size < 8 ? size : 8);
    v &= (uint64_t(1) << bitpos) - 1;
    return (v << (-lo)) & mask;
  }
  inline uint64_t read(int n) {
    uint64_t v = peek(n);
    bitpos -= n;
    return v;
  }
  bool overflowed() const { return bitpos < 0; }
};

// ---------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;     // next state = base + read(nbits)
};

struct FseTable {
  int accuracy = 0;
  std::vector<FseEntry> e;
};

// Reads a normalized distribution (RFC 8878 4.1.1); returns bytes used.
size_t read_ncount(const uint8_t* p, size_t size, size_t base, int max_accuracy,
                   int max_symbol, std::vector<int16_t>& norm, int& accuracy) {
  if (size == 0) fail("missing FSE table description", base);
  ForwardBits br{p, size, base};
  accuracy = int(br.peek(4)) + 5;
  br.skip(4);
  if (accuracy > max_accuracy)
    fail("FSE accuracy log " + std::to_string(accuracy) + " too large", base);
  norm.assign(max_symbol + 1, 0);
  int remaining = (1 << accuracy) + 1;
  int threshold = 1 << accuracy;
  int nbits = accuracy + 1;
  int sym = 0;
  bool previous0 = false;
  while (remaining > 1) {
    if (sym > max_symbol) fail("FSE table with too many symbols", base);
    if (previous0) {
      int n0 = sym;
      for (;;) {
        int r = int(br.peek(2));
        br.skip(2);
        n0 += r;
        if (r != 3) break;
      }
      if (n0 > max_symbol) fail("FSE zero run past the last symbol", base);
      sym = n0;   // the skipped symbols keep their zeros
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1);
    if (int(low) < max) {
      count = int(low);
      br.skip(nbits - 1);
    } else {
      count = int(br.peek(nbits));
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    --count;   // -1: a "less than one" probability
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE distribution does not sum up", base);
  return br.bytes_used();
}

void build_fse(const std::vector<int16_t>& norm, int accuracy, FseTable& t,
               size_t base) {
  int size = 1 << accuracy;
  t.accuracy = accuracy;
  t.e.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("FSE table overfull", base);
      t.e[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  int pos = 0;
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].symbol = uint16_t(s);
      do { pos = (pos + step) & mask; } while (pos > high);
    }
  }
  if (pos != 0) fail("FSE distribution does not fill its table", base);
  for (int u = 0; u < size; ++u) {
    uint16_t s = t.e[u].symbol;
    uint32_t ns = next[s]++;
    int nb = accuracy - highbit32(ns);
    t.e[u].nbits = uint8_t(nb);
    t.e[u].base = uint16_t((ns << nb) - size);
  }
}

void rle_fse(uint8_t symbol, FseTable& t) {
  t.accuracy = 0;
  t.e.assign(1, FseEntry{symbol, 0, 0});
}

// ---------------------------------------------------------------- Huffman

struct HufTable {
  int max_bits = 0;
  std::vector<uint16_t> e;   // symbol << 8 | nbits, indexed by max_bits bits
};

// Reads a Huffman tree description; returns bytes used.
size_t read_huffman(const uint8_t* p, size_t size, size_t base, HufTable& h) {
  if (size == 0) fail("missing Huffman tree description", base);
  uint8_t hb = p[0];
  uint8_t weights[256];
  int nw = 0;
  size_t used;
  if (hb >= 128) {
    nw = hb - 127;
    size_t nbytes = (size_t(nw) + 1) / 2;
    if (1 + nbytes > size) fail("truncated Huffman weights", base + size);
    for (int i = 0; i < nw; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + nbytes;
  } else {
    size_t csize = hb;
    if (1 + csize > size) fail("truncated Huffman weights", base + size);
    std::vector<int16_t> norm;
    int acc;
    size_t d = read_ncount(p + 1, csize, base + 1, 6, 15, norm, acc);
    FseTable t;
    build_fse(norm, acc, t, base + 1);
    if (d >= csize) fail("Huffman weights without a bit stream", base + 1);
    BackBits bs(p + 1 + d, csize - d, base + 1 + d);
    uint32_t s1 = uint32_t(bs.read(acc)), s2 = uint32_t(bs.read(acc));
    if (bs.overflowed()) fail("truncated Huffman weights", base + 1 + d);
    for (;;) {
      if (nw > 253) fail("too many Huffman weights", base + 1 + d);
      const FseEntry& e1 = t.e[s1];
      weights[nw++] = uint8_t(e1.symbol);
      s1 = e1.base + uint32_t(bs.read(e1.nbits));
      if (bs.overflowed()) {
        weights[nw++] = uint8_t(t.e[s2].symbol);
        break;
      }
      const FseEntry& e2 = t.e[s2];
      weights[nw++] = uint8_t(e2.symbol);
      s2 = e2.base + uint32_t(bs.read(e2.nbits));
      if (bs.overflowed()) {
        weights[nw++] = uint8_t(t.e[s1].symbol);
        break;
      }
    }
    used = 1 + csize;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail("Huffman weight above 11", base);
    if (weights[i]) total += uint32_t(1) << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights all zero", base);
  int max_bits = highbit32(total) + 1;
  uint32_t rest = (uint32_t(1) << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not sum to a power of 2", base);
  if (max_bits > 11) fail("Huffman code longer than 11 bits", base);
  weights[nw++] = uint8_t(highbit32(rest) + 1);
  h.max_bits = max_bits;
  h.e.assign(size_t(1) << max_bits, 0);
  size_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < nw; ++s) {
      if (weights[s] != w) continue;
      size_t n = size_t(1) << (w - 1);
      uint16_t v = uint16_t((s << 8) | (max_bits + 1 - w));
      for (size_t i = 0; i < n; ++i) h.e[pos++] = v;
    }
  }
  return used;
}

// Decodes 5 codes of at most 11 bits from the 8 bytes that end at the
// read position (>= 57 bits: the caller has checked bitpos >= 64).
inline void huf_fast5(const uint16_t* e, int mb, BackBits& bs, uint8_t* out) {
  size_t byte_end = size_t((bs.bitpos + 7) >> 3);
  uint64_t v;
  std::memcpy(&v, bs.p + byte_end - 8, 8);
  int k = int(bs.bitpos - int64_t(byte_end - 8) * 8);
  uint64_t c = v << (64 - k);
  int used = 0;
  for (int j = 0; j < 5; ++j) {
    uint16_t x = e[c >> (64 - mb)];
    out[j] = uint8_t(x >> 8);
    c <<= (x & 255);
    used += x & 255;
  }
  bs.bitpos -= used;
}

// Decodes out[i, n) from the stream and checks that it ends exactly.
void huf_finish(const HufTable& h, BackBits& bs, uint8_t* out, size_t i,
                size_t n) {
  const int mb = h.max_bits;
  const uint16_t* e = h.e.data();
  for (; i + 5 <= n && bs.bitpos >= 64; i += 5) huf_fast5(e, mb, bs, out + i);
  for (; i < n; ++i) {
    uint16_t x = e[bs.peek(mb)];
    out[i] = uint8_t(x >> 8);
    bs.bitpos -= (x & 255);
  }
  if (bs.bitpos != 0) fail("Huffman stream not consumed exactly", bs.base);
}

void huf_stream(const HufTable& h, const uint8_t* p, size_t size, size_t base,
                uint8_t* out, size_t n) {
  BackBits bs(p, size, base);
  huf_finish(h, bs, out, 0, n);
}

// The 4 streams in lockstep while each has room, for instruction-level
// parallelism; then each to its end.
void huf_4streams(const HufTable& h, const uint8_t* src, const size_t* at,
                  const size_t* sizes, uint8_t* out, const size_t* off,
                  const size_t* cnt) {
  BackBits b[4] = {BackBits(src + at[0], sizes[0], at[0]),
                   BackBits(src + at[1], sizes[1], at[1]),
                   BackBits(src + at[2], sizes[2], at[2]),
                   BackBits(src + at[3], sizes[3], at[3])};
  const int mb = h.max_bits;
  const uint16_t* e = h.e.data();
  size_t i = 0;
  while (i + 5 <= cnt[3] && b[0].bitpos >= 64 && b[1].bitpos >= 64 &&
         b[2].bitpos >= 64 && b[3].bitpos >= 64) {
    for (int k = 0; k < 4; ++k) huf_fast5(e, mb, b[k], out + off[k] + i);
    i += 5;
  }
  for (int k = 0; k < 4; ++k) huf_finish(h, b[k], out + off[k], i, cnt[k]);
}

// ---------------------------------------------------------------- tables

const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      uint64_t a, b, c, d;
      std::memcpy(&a, p, 8); std::memcpy(&b, p + 8, 8);
      std::memcpy(&c, p + 16, 8); std::memcpy(&d, p + 24, 8);
      v1 = xround(v1, a); v2 = xround(v2, b); v3 = xround(v3, c); v4 = xround(v4, d);
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1); h = xmerge(h, v2); h = xmerge(h, v3); h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    uint64_t k;
    std::memcpy(&k, p, 8);
    h ^= xround(0, k);
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t k;
    std::memcpy(&k, p, 4);
    h ^= uint64_t(k) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- frames

constexpr uint32_t kMagic = 0xFD2FB528u;

struct FrameHeader {
  size_t header_size;
  bool has_size;
  uint64_t content_size;
  uint64_t window;
  bool checksum;
};

FrameHeader frame_header(const uint8_t* src, size_t n, size_t at) {
  // at: offset of the byte after the magic
  if (at >= n) fail("truncated frame header", n);
  uint8_t fhd = src[at];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  if (fhd & 8) fail("reserved bit set in frame header", at);
  static const int kDidSize[4] = {0, 1, 2, 4};
  static const int kFcsSize[4] = {0, 2, 4, 8};
  int did_size = kDidSize[fhd & 3];
  int fcs_size = fcs_flag == 0 && single ? 1 : kFcsSize[fcs_flag];
  size_t need = 1 + (single ? 0 : 1) + did_size + fcs_size;
  if (at + need > n) fail("truncated frame header", n);
  size_t q = at + 1;
  FrameHeader h{};
  h.checksum = (fhd >> 2) & 1;
  if (!single) {
    uint8_t wd = src[q++];
    int exponent = wd >> 3, mantissa = wd & 7;
    uint64_t wbase = uint64_t(1) << (10 + exponent);
    h.window = wbase + (wbase / 8) * mantissa;
  }
  if (did_size) {
    uint64_t did = load_le(src + q, did_size);
    if (did != 0)
      fail("frame needs dictionary " + std::to_string(did) +
               "; dictionaries are not supported", q);
    q += did_size;
  }
  h.has_size = fcs_size > 0;
  if (fcs_size) {
    h.content_size = load_le(src + q, fcs_size) + (fcs_size == 2 ? 256 : 0);
    q += fcs_size;
  }
  if (single) h.window = h.content_size;
  h.header_size = q - at;
  return h;
}

struct Repeat {
  bool have_huf = false;
  HufTable huf;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
};

void decode_table(const uint8_t* src, size_t& q, size_t end, int mode,
                  const int16_t* predef, int npredef, int predef_acc,
                  int max_acc, int max_sym, FseTable& t, bool& have,
                  const char* name) {
  if (mode == 0) {
    std::vector<int16_t> norm(predef, predef + npredef);
    build_fse(norm, predef_acc, t, q);
  } else if (mode == 1) {
    if (q >= end) fail(std::string("truncated RLE ") + name + " code", q);
    if (src[q] > max_sym) fail(std::string("bad RLE ") + name + " code", q);
    rle_fse(src[q], t);
    ++q;
  } else if (mode == 2) {
    std::vector<int16_t> norm;
    int acc;
    size_t used = read_ncount(src + q, end - q, q, max_acc, max_sym, norm, acc);
    build_fse(norm, acc, t, q);
    q += used;
  } else {
    if (!have) fail(std::string("repeat mode without a previous ") + name +
                        " table", q);
    return;
  }
  have = true;
}

// Decodes one compressed block src[q, end) to out[op, ...); returns new op.
size_t compressed_block(const uint8_t* src, size_t q, size_t end, uint8_t* out,
                        size_t op, size_t cap, size_t frame_start, Repeat& r,
                        std::vector<uint8_t>& litbuf) {
  const size_t block_start = q;
  // --- literals section
  if (q >= end) fail("empty compressed block", q);
  uint8_t b0 = src[q];
  int ltype = b0 & 3, sf = (b0 >> 2) & 3;
  size_t regen = 0, csize = 0, hsize;
  int streams = 1;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) { hsize = 1; }
    else if (sf == 1) { hsize = 2; }
    else { hsize = 3; }
    if (q + hsize > end) fail("truncated literals header", q);
    if (hsize == 1) regen = b0 >> 3;
    else if (hsize == 2) regen = (b0 >> 4) + (size_t(src[q + 1]) << 4);
    else regen = (b0 >> 4) + (size_t(src[q + 1]) << 4) + (size_t(src[q + 2]) << 12);
  } else {
    hsize = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (q + hsize > end) fail("truncated literals header", q);
    uint64_t h = load_le(src + q, hsize);
    streams = sf == 0 ? 1 : 4;
    if (sf < 2) { regen = (h >> 4) & 0x3FF; csize = (h >> 14) & 0x3FF; }
    else if (sf == 2) { regen = (h >> 4) & 0x3FFF; csize = (h >> 18) & 0x3FFF; }
    else { regen = (h >> 4) & 0x3FFFF; csize = (h >> 22) & 0x3FFFF; }
  }
  if (regen > kBlockMax) fail("literals larger than a block", q);
  q += hsize;
  const uint8_t* lit;
  if (ltype == 0) {
    if (q + regen > end) fail("truncated raw literals", q);
    lit = src + q;
    q += regen;
  } else if (ltype == 1) {
    if (q >= end) fail("truncated RLE literals", q);
    std::memset(litbuf.data(), src[q], regen);
    lit = litbuf.data();
    q += 1;
  } else {
    if (q + csize > end) fail("truncated Huffman literals", q);
    size_t lend = q + csize;
    if (ltype == 2) {
      q += read_huffman(src + q, lend - q, q, r.huf);
      r.have_huf = true;
    } else if (!r.have_huf) {
      fail("treeless literals without a previous Huffman table", q);
    }
    if (streams == 1) {
      huf_stream(r.huf, src + q, lend - q, q, litbuf.data(), regen);
    } else {
      if (q + 6 > lend) fail("truncated Huffman jump table", q);
      size_t s1 = load_le(src + q, 2), s2 = load_le(src + q + 2, 2),
             s3 = load_le(src + q + 4, 2);
      size_t total = lend - q - 6;
      if (s1 + s2 + s3 > total) fail("Huffman jump table past its literals", q);
      size_t s4 = total - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("too few literals for 4 streams", q);
      size_t sizes[4] = {s1, s2, s3, s4};
      size_t at[4] = {q + 6, q + 6 + s1, q + 6 + s1 + s2, q + 6 + s1 + s2 + s3};
      size_t off[4] = {0, seg, 2 * seg, 3 * seg};
      size_t cnt[4] = {seg, seg, seg, regen - 3 * seg};
      huf_4streams(r.huf, src, at, sizes, litbuf.data(), off, cnt);
    }
    lit = litbuf.data();
    q = lend;
  }
  // --- sequences section
  if (q >= end) fail("missing sequences section", q);
  size_t nseq = src[q];
  if (nseq < 128) {
    q += 1;
  } else if (nseq < 255) {
    if (q + 2 > end) fail("truncated sequence count", q);
    nseq = ((nseq - 128) << 8) + src[q + 1];
    q += 2;
  } else {
    if (q + 3 > end) fail("truncated sequence count", q);
    nseq = src[q + 1] + (size_t(src[q + 2]) << 8) + 0x7F00;
    q += 3;
  }
  size_t block_out_start = op;
  size_t lpos = 0;
  if (nseq > 0) {
    if (q >= end) fail("missing sequence modes", q);
    uint8_t modes = src[q];
    if (modes & 3) fail("reserved bits set in sequence modes", q);
    ++q;
    decode_table(src, q, end, modes >> 6, kLLNorm, 36, 6, 9, 35, r.ll, r.have_ll, "literal length");
    decode_table(src, q, end, (modes >> 4) & 3, kOFNorm, 29, 5, 8, 31, r.of, r.have_of, "offset");
    decode_table(src, q, end, (modes >> 2) & 3, kMLNorm, 53, 6, 9, 52, r.ml, r.have_ml, "match length");
    if (q >= end) fail("missing sequence bit stream", q);
    BackBits bs(src + q, end - q, q);
    uint32_t sll = uint32_t(bs.read(r.ll.accuracy));
    uint32_t sof = uint32_t(bs.read(r.of.accuracy));
    uint32_t sml = uint32_t(bs.read(r.ml.accuracy));
    const FseEntry* ll = r.ll.e.data();
    const FseEntry* of = r.of.e.data();
    const FseEntry* ml = r.ml.e.data();
    for (size_t i = 0; i < nseq; ++i) {
      int ofc = of[sof].symbol, mlc = ml[sml].symbol, llc = ll[sll].symbol;
      if (ofc > 31) fail("offset code above 31", q);
      uint64_t ofv = (uint64_t(1) << ofc) + bs.read(ofc);
      uint64_t mlen = kMLBase[mlc] + bs.read(kMLBits[mlc]);
      uint64_t llen = kLLBase[llc] + bs.read(kLLBits[llc]);
      if (i + 1 < nseq) {
        sll = ll[sll].base + uint32_t(bs.read(ll[sll].nbits));
        sml = ml[sml].base + uint32_t(bs.read(ml[sml].nbits));
        sof = of[sof].base + uint32_t(bs.read(of[sof].nbits));
      }
      if (bs.overflowed()) fail("truncated sequence bit stream", q);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        r.rep[2] = r.rep[1]; r.rep[1] = r.rep[0]; r.rep[0] = uint32_t(offset);
      } else {
        int idx = int(ofv) - 1 + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          offset = r.rep[0];
        } else {
          offset = idx == 3 ? uint64_t(r.rep[0]) - 1 : r.rep[idx];
          if (idx != 1) r.rep[2] = r.rep[1];
          r.rep[1] = r.rep[0];
          r.rep[0] = uint32_t(offset);
        }
      }
      if (offset == 0) fail("zero match offset", q);
      if (llen > regen - lpos) fail("sequence takes more literals than the block has", q);
      if (llen + mlen > cap - op) fail("output larger than its stated size", q);
      std::memcpy(out + op, lit + lpos, llen);
      op += llen;
      lpos += llen;
      if (offset > op - frame_start) fail("match offset before the frame start", q);
      uint8_t* d = out + op;
      const uint8_t* s = d - offset;
      if (offset >= mlen) {
        std::memcpy(d, s, mlen);
      } else {
        for (uint64_t k = 0; k < mlen; ++k) d[k] = s[k];
      }
      op += mlen;
    }
    if (bs.bitpos != 0) fail("sequence bit stream not consumed exactly", q);
  } else if (q != end) {
    fail("bytes after an empty sequences section", q);
  }
  size_t rest = regen - lpos;
  if (rest > cap - op) fail("output larger than its stated size", block_start);
  if (rest) std::memcpy(out + op, lit + lpos, rest);
  op += rest;
  if (op - block_out_start > kBlockMax) fail("block decodes to more than 128 KiB", block_start);
  return op;
}

// Decodes one frame starting at src[at] (after its magic); returns the
// offset after the frame and advances op.
size_t decode_frame(const uint8_t* src, size_t n, size_t at, uint8_t* out,
                    size_t cap, size_t& op, std::vector<uint8_t>& litbuf) {
  FrameHeader fh = frame_header(src, n, at);
  size_t q = at + fh.header_size;
  size_t frame_start = op;
  Repeat r;
  for (;;) {
    if (q + 3 > n) fail("truncated block header", q);
    uint32_t bh = uint32_t(load_le(src + q, 3));
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    size_t hq = q;
    q += 3;
    if (type == 0) {
      if (q + size > n) fail("truncated raw block", hq);
      if (size > cap - op) fail("output larger than its stated size", hq);
      if (size) std::memcpy(out + op, src + q, size);
      op += size;
      q += size;
    } else if (type == 1) {
      if (q + 1 > n) fail("truncated RLE block", hq);
      if (size > cap - op) fail("output larger than its stated size", hq);
      if (size) std::memset(out + op, src[q], size);
      op += size;
      q += 1;
    } else if (type == 2) {
      if (size > kBlockMax) fail("compressed block larger than 128 KiB", hq);
      if (q + size > n) fail("truncated compressed block", hq);
      op = compressed_block(src, q, q + size, out, op, cap, frame_start, r, litbuf);
      q += size;
    } else {
      fail("reserved block type", hq);
    }
    if (last) break;
  }
  if (fh.has_size && op - frame_start != fh.content_size)
    fail("frame decodes to " + std::to_string(op - frame_start) +
             " bytes, its header says " + std::to_string(fh.content_size), at);
  if (fh.checksum) {
    if (q + 4 > n) fail("truncated content checksum", q);
    uint32_t want = uint32_t(load_le(src + q, 4));
    uint32_t got = uint32_t(xxh64(out + frame_start, op - frame_start));
    if (want != got) fail("content checksum mismatch", q);
    q += 4;
  }
  return q;
}

// Walks the frames without decoding; returns an upper bound of the output.
uint64_t bound(const uint8_t* src, size_t n, bool& exact) {
  exact = true;
  uint64_t total = 0;
  size_t q = 0;
  while (q < n) {
    if (q + 4 > n) fail("truncated frame magic", q);
    uint32_t magic = uint32_t(load_le(src + q, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (q + 8 > n) fail("truncated skippable frame", q);
      uint64_t len = load_le(src + q + 4, 4);
      if (q + 8 + len > n) fail("truncated skippable frame", q);
      q += 8 + len;
      continue;
    }
    if (magic != kMagic) fail("not a zstd frame (bad magic)", q);
    FrameHeader fh = frame_header(src, n, q + 4);
    size_t b = q + 4 + fh.header_size;
    uint64_t blocks = 0;
    for (;;) {
      if (b + 3 > n) fail("truncated block header", b);
      uint32_t bh = uint32_t(load_le(src + b, 3));
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail("reserved block type", b);
      size_t stored = type == 1 ? 1 : size;
      if (b + 3 + stored > n) fail("truncated block", b);
      blocks += type == 2 ? kBlockMax : size;
      b += 3 + stored;
      if (bh & 1) break;
    }
    if (fh.checksum) b += 4;
    if (b > n) fail("truncated content checksum", n);
    if (fh.has_size) {
      total += fh.content_size;
    } else {
      exact = false;
      total += blocks;
    }
    q = b;
  }
  return total;
}

void set_err(char* err, size_t errcap, const std::string& msg) {
  if (errcap == 0) return;
  std::snprintf(err, errcap, "%s", msg.c_str());
}

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 255];
  }
};

const Crc32cTables kCrc32c;

}  // namespace

extern "C" {

int dis_zstd_bound(const uint8_t* src, size_t n, uint64_t* out_bound,
                   int* exact, char* err, size_t errcap) {
  try {
    bool ex;
    *out_bound = bound(src, n, ex);
    *exact = ex ? 1 : 0;
    return 0;
  } catch (const DecodeError& e) {
    set_err(err, errcap, e.msg + " at byte " + std::to_string(e.offset));
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
    return 1;
  }
}

int dis_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                        uint64_t* written, char* err, size_t errcap) {
  try {
    std::vector<uint8_t> litbuf(kBlockMax + 16);
    size_t op = 0, q = 0;
    while (q < n) {
      if (q + 4 > n) fail("truncated frame magic", q);
      uint32_t magic = uint32_t(load_le(src + q, 4));
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (q + 8 > n) fail("truncated skippable frame", q);
        uint64_t len = load_le(src + q + 4, 4);
        if (q + 8 + len > n) fail("truncated skippable frame", q);
        q += 8 + len;
        continue;
      }
      if (magic != kMagic) fail("not a zstd frame (bad magic)", q);
      q = decode_frame(src, n, q + 4, dst, cap, op, litbuf);
    }
    *written = op;
    return 0;
  } catch (const DecodeError& e) {
    set_err(err, errcap, e.msg + " at byte " + std::to_string(e.offset));
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
    return 1;
  }
}

uint32_t dis_crc32c(const uint8_t* p, size_t n) {
  const auto& crc32c_table = kCrc32c.t;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = crc32c_table[7][lo & 255] ^ crc32c_table[6][(lo >> 8) & 255] ^
        crc32c_table[5][(lo >> 16) & 255] ^ crc32c_table[4][lo >> 24] ^
        crc32c_table[3][hi & 255] ^ crc32c_table[2][(hi >> 8) & 255] ^
        crc32c_table[1][(hi >> 16) & 255] ^ crc32c_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ crc32c_table[0][(c ^ *p++) & 255];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
