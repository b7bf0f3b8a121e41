// LZW codec (LSB bit order, 8-bit literals) — the compression used by
// memberlist's compressMsg payloads (reference memberlist/util.go:221-275,
// Go compress/lzw with lzw.LSB, litWidth 8).
//
// Semantics mirrored from the Go implementation: codes 0..255 are
// literals, 256 is CLEAR, 257 is EOF, new table entries start at 258;
// code width starts at 9 bits and grows when the next assigned code
// reaches the current width's capacity; when the table reaches code
// 4095 the encoder emits CLEAR and resets (so streams of any length
// work). The decoder tracks the same schedule, including the KwKwK
// (code == next unassigned entry) case.
//
// C ABI: bytes in, bytes out; returns the output length, -1 on corrupt
// input, -2 when the output buffer is too small (caller retries with a
// bigger buffer).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kClear = 256;
constexpr uint32_t kEof = 257;
constexpr uint32_t kFirst = 258;
constexpr uint32_t kMaxCode = (1u << 12) - 1;  // 4095

struct BitWriter {
  uint8_t* out;
  long cap;
  long n = 0;
  uint64_t acc = 0;
  int bits = 0;
  bool overflow = false;

  void put(uint32_t code, int width) {
    acc |= static_cast<uint64_t>(code) << bits;
    bits += width;
    while (bits >= 8) {
      if (n >= cap) { overflow = true; return; }
      out[n++] = static_cast<uint8_t>(acc & 0xff);
      acc >>= 8;
      bits -= 8;
    }
  }
  void flush() {
    if (bits > 0) {
      if (n >= cap) { overflow = true; return; }
      out[n++] = static_cast<uint8_t>(acc & 0xff);
      acc = 0;
      bits = 0;
    }
  }
};

struct BitReader {
  const uint8_t* in;
  long len;
  long pos = 0;
  uint64_t acc = 0;
  int bits = 0;

  // Returns code or UINT32_MAX when the stream is exhausted.
  uint32_t get(int width) {
    while (bits < width) {
      if (pos >= len) return UINT32_MAX;
      acc |= static_cast<uint64_t>(in[pos++]) << bits;
      bits += 8;
    }
    uint32_t code = static_cast<uint32_t>(acc & ((1u << width) - 1));
    acc >>= width;
    bits -= width;
    return code;
  }
};

}  // namespace

extern "C" {

long lzw_compress(const uint8_t* in, long n, uint8_t* out, long cap) {
  BitWriter w{out, cap};
  std::unordered_map<uint32_t, uint32_t> table;
  table.reserve(1 << 12);
  uint32_t hi = kEof;           // last assigned code
  int width = 9;
  uint32_t overflow_at = 1u << 9;
  long i = 0;
  if (n > 0) {
    uint32_t saved = in[i++];
    for (; i < n; i++) {
      uint32_t key = (saved << 8) | in[i];
      auto it = table.find(key);
      if (it != table.end()) {
        saved = it->second;
        continue;
      }
      w.put(saved, width);
      saved = in[i];
      // incHi (Go writer.incHi): assign, grow width, or clear+reset.
      hi++;
      if (hi == overflow_at) { width++; overflow_at <<= 1; }
      if (hi == kMaxCode) {
        w.put(kClear, width);
        width = 9;
        hi = kEof;
        overflow_at = 1u << 9;
        table.clear();
      } else {
        table.emplace(key, hi);
      }
    }
    w.put(saved, width);
    // Final assignment may still grow the width before EOF is written
    // (Go increments hi for the pending code at Close).
    hi++;
    if (hi == overflow_at) { width++; overflow_at <<= 1; }
  }
  w.put(kEof, width);
  w.flush();
  if (w.overflow) return -2;
  return w.n;
}

long lzw_decompress(const uint8_t* in, long n, uint8_t* out, long cap) {
  BitReader r{in, n};
  // prefix/suffix chain per code; expansion walks to literals.
  std::vector<uint32_t> prefix(1 << 12, 0);
  std::vector<uint8_t> suffix(1 << 12, 0);
  std::vector<uint8_t> buf;  // reversed expansion scratch
  buf.reserve(1 << 12);

  // The Go reader's schedule (compress/lzw decode): entry `hi` is
  // completed while processing the NEXT code (its first byte becomes
  // known then); `hi` increments unconditionally per code, keeping the
  // width-growth boundaries aligned with the encoder's incHi.
  uint32_t hi = kEof;
  int width = 9;
  uint32_t overflow_at = 1u << 9;
  constexpr uint32_t kInvalid = UINT32_MAX;
  uint32_t last = kInvalid;
  long outn = 0;

  for (;;) {
    uint32_t code = r.get(width);
    if (code == UINT32_MAX) return -1;  // truncated (no EOF)
    if (code == kEof) return outn;
    if (code == kClear) {
      width = 9;
      hi = kEof;
      overflow_at = 1u << 9;
      last = kInvalid;
      continue;
    }

    uint32_t expand_code = code;
    bool kwkwk = false;
    if (code < kClear) {
      // literal
    } else if (code == hi && last != kInvalid) {
      kwkwk = true;          // entry being defined now: last + first(last)
      expand_code = last;
    } else if (code < hi && code >= kFirst) {
      // known composite entry
    } else {
      return -1;             // corrupt stream
    }

    // Expand to bytes (reversed), literals terminate the chain.
    buf.clear();
    uint32_t c = expand_code;
    while (c >= kFirst) {
      buf.push_back(suffix[c]);
      c = prefix[c];
    }
    buf.push_back(static_cast<uint8_t>(c));
    uint8_t first_byte = buf.back();
    if (kwkwk) buf.insert(buf.begin(), first_byte);

    if (outn + static_cast<long>(buf.size()) > cap) return -2;
    for (auto it = buf.rbegin(); it != buf.rend(); ++it) out[outn++] = *it;

    // Complete the pending entry `hi` = expand(last) + first byte of
    // this code's expansion, then advance (unconditionally, mirroring
    // the encoder's per-emit incHi).
    if (last != kInvalid && hi < kMaxCode) {
      prefix[hi] = last;
      suffix[hi] = first_byte;
    }
    last = code;
    hi++;
    if (hi >= overflow_at) {
      if (width < 12) {
        width++;
        overflow_at <<= 1;
      } else {
        // Encoder must send CLEAR before assigning past the table;
        // hold position until it arrives.
        hi--;
      }
    }
  }
}

}  // extern "C"
