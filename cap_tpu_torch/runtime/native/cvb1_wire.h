// cvb1_wire.h — the CVB1 wire contract, shared across native TUs.
//
// One parser, two chains: serve_native.cpp (the worker serve chain)
// and frontdoor_native.cpp (the relay front door) must reject EXACTLY
// the same malformed / oversize / corrupt frames as
// serve/protocol.py _parse_frame, with the same error classes. The
// parser used to live inside serve_native.cpp; hoisting it here keeps
// the two native readers check-for-check identical by construction —
// the same stance as sha2::sha256 being one implementation in
// jose_native.cpp that every TU links.
//
// Everything here is header-only (inline) and allocation-free; the
// PF_* status codes map 1:1 onto the Python exception classes
// (serve/native_serve.py NATIVE_STATUS_ERRORS).

#ifndef CAP_TPU_CVB1_WIRE_H_
#define CAP_TPU_CVB1_WIRE_H_

#include <array>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <errno.h>
#include <sys/socket.h>

namespace cvb1 {

static const uint32_t MAGIC = 0x31425643;  // "CVB1"
enum {
  T_VERIFY_REQ = 1,
  T_VERIFY_RESP = 2,
  T_PING = 3,
  T_PONG = 4,
  T_STATS_REQ = 5,
  T_STATS_RESP = 6,
  T_VERIFY_REQ_CRC = 7,
  T_VERIFY_RESP_CRC = 8,
  T_VERIFY_REQ_TRACE = 9,
  T_VERIFY_RESP_TRACE = 10,
  T_KEYS_PUSH = 11,
  T_KEYS_ACK = 12,
  T_PEER_FILL = 13,
  T_PEER_ACK = 14,
  T_SHM_ATTACH = 15,
  T_SHM_ACK = 16,
};
static const int64_t MAX_FRAME_ENTRIES = 1 << 20;
static const int64_t MAX_ENTRY_BYTES = 1 << 20;
static const int64_t MAX_FRAME_BYTES = 1 << 28;
static const int32_t MAX_TRACE_BYTES = 64;

// Parse status codes: the shared error-class contract with
// serve/protocol.py (serve/native_serve.py maps them back to the
// exact Python exception classes).
enum {
  PF_OK = 0,
  PF_MALFORMED = 1,   // MalformedFrameError
  PF_TOOLARGE = 2,    // FrameTooLargeError
  PF_CORRUPT = 3,     // FrameCorruptError
  PF_INCOMPLETE = 4,  // need more bytes (stream: keep reading)
  PF_UTF8 = 5,        // UnicodeDecodeError (token not valid UTF-8)
};

// ---------------------------------------------------------------------------
// zlib-compatible CRC-32 (IEEE reflected, poly 0xEDB88320).
// ---------------------------------------------------------------------------

inline uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
  static const std::array<uint32_t, 256> tbl = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
    return t;
  }();
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    crc = tbl[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// strict UTF-8 validation (CPython's decoder rules: no overlongs, no
// surrogates, max U+10FFFF) — tokens cross into Python as str.
// ---------------------------------------------------------------------------

inline bool utf8_valid(const uint8_t* s, int64_t n) {
  int64_t i = 0;
  while (i < n) {
    uint8_t c = s[i];
    if (c < 0x80) { i++; continue; }
    if (c < 0xC2) return false;
    if (c < 0xE0) {
      if (i + 1 >= n || (s[i + 1] & 0xC0) != 0x80) return false;
      i += 2; continue;
    }
    if (c < 0xF0) {
      if (i + 2 >= n) return false;
      uint8_t lo = (c == 0xE0) ? 0xA0 : 0x80;
      uint8_t hi = (c == 0xED) ? 0x9F : 0xBF;
      if (s[i + 1] < lo || s[i + 1] > hi || (s[i + 2] & 0xC0) != 0x80)
        return false;
      i += 3; continue;
    }
    if (c < 0xF5) {
      if (i + 3 >= n) return false;
      uint8_t lo = (c == 0xF0) ? 0x90 : 0x80;
      uint8_t hi = (c == 0xF4) ? 0x8F : 0xBF;
      if (s[i + 1] < lo || s[i + 1] > hi ||
          (s[i + 2] & 0xC0) != 0x80 || (s[i + 3] & 0xC0) != 0x80)
        return false;
      i += 4; continue;
    }
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// frame parse over a byte buffer — check-for-check identical to
// protocol._parse_frame: every length validated BEFORE the bytes are
// touched, CRC checked before deferred status/trace/UTF-8 validation.
// ---------------------------------------------------------------------------

struct EntryRef {
  int64_t off;
  int64_t len;
  uint8_t status;  // response-shaped entries only
};

struct Parsed {
  uint8_t ftype = 0;
  uint32_t count = 0;
  int64_t trace_off = 0;
  int32_t trace_len = 0;  // 0 = no trace field
  std::vector<EntryRef> entries;
  int64_t consumed = 0;
};

inline int parse_frame(const uint8_t* b, int64_t n, Parsed& out) {
  if (n < 9) return PF_INCOMPLETE;
  uint32_t magic, count;
  std::memcpy(&magic, b, 4);
  uint8_t ftype = b[4];
  std::memcpy(&count, b + 5, 4);
  if (magic != MAGIC) return PF_MALFORMED;
  if ((int64_t)count > MAX_FRAME_ENTRIES) return PF_TOOLARGE;
  bool checksummed =
      ftype == T_VERIFY_REQ_CRC || ftype == T_VERIFY_RESP_CRC ||
      ftype == T_VERIFY_REQ_TRACE || ftype == T_VERIFY_RESP_TRACE ||
      ftype == T_KEYS_PUSH || ftype == T_KEYS_ACK ||
      ftype == T_PEER_FILL || ftype == T_PEER_ACK ||
      ftype == T_SHM_ATTACH || ftype == T_SHM_ACK;
  if ((ftype == T_KEYS_PUSH || ftype == T_KEYS_ACK ||
       ftype == T_PEER_FILL || ftype == T_PEER_ACK ||
       ftype == T_SHM_ATTACH || ftype == T_SHM_ACK) &&
      count != 1)
    return PF_MALFORMED;
  int64_t pos = 9;
  out.trace_off = 0;
  out.trace_len = 0;
  if (ftype == T_VERIFY_REQ_TRACE || ftype == T_VERIFY_RESP_TRACE) {
    if (pos + 1 > n) return PF_INCOMPLETE;
    uint8_t ctx_len = b[pos];
    if (ctx_len == 0 || ctx_len > MAX_TRACE_BYTES) return PF_MALFORMED;
    if (pos + 1 + ctx_len > n) return PF_INCOMPLETE;
    out.trace_off = pos + 1;
    out.trace_len = ctx_len;
    pos += 1 + ctx_len;
  }
  out.ftype = ftype;
  out.count = count;
  out.entries.clear();
  bool req_shape = ftype == T_VERIFY_REQ || ftype == T_VERIFY_REQ_CRC ||
                   ftype == T_VERIFY_REQ_TRACE || ftype == T_KEYS_PUSH ||
                   ftype == T_PEER_FILL || ftype == T_SHM_ATTACH;
  bool resp_shape = ftype == T_VERIFY_RESP || ftype == T_VERIFY_RESP_CRC ||
                    ftype == T_VERIFY_RESP_TRACE || ftype == T_STATS_RESP ||
                    ftype == T_KEYS_ACK || ftype == T_PEER_ACK ||
                    ftype == T_SHM_ACK;
  int64_t total = 0;
  if (req_shape) {
    out.entries.reserve(count < 4096 ? count : 4096);
    for (uint32_t i = 0; i < count; i++) {
      if (pos + 4 > n) return PF_INCOMPLETE;
      uint32_t ln;
      std::memcpy(&ln, b + pos, 4);
      pos += 4;
      total += (int64_t)ln;
      if ((int64_t)ln > MAX_ENTRY_BYTES || total > MAX_FRAME_BYTES)
        return PF_TOOLARGE;
      if (pos + (int64_t)ln > n) return PF_INCOMPLETE;
      out.entries.push_back({pos, (int64_t)ln, 0});
      pos += ln;
    }
  } else if (resp_shape) {
    out.entries.reserve(count < 4096 ? count : 4096);
    for (uint32_t i = 0; i < count; i++) {
      if (pos + 5 > n) return PF_INCOMPLETE;
      uint8_t st = b[pos];
      uint32_t ln;
      std::memcpy(&ln, b + pos + 1, 4);
      pos += 5;
      if (!checksummed && st > 1) return PF_MALFORMED;
      total += (int64_t)ln;
      if ((int64_t)ln > MAX_ENTRY_BYTES || total > MAX_FRAME_BYTES)
        return PF_TOOLARGE;
      if (pos + (int64_t)ln > n) return PF_INCOMPLETE;
      out.entries.push_back({pos, (int64_t)ln, st});
      pos += ln;
    }
  } else if (ftype == T_PING || ftype == T_PONG || ftype == T_STATS_REQ) {
    if (count) return PF_MALFORMED;
  } else {
    return PF_MALFORMED;
  }
  if (checksummed) {
    if (pos + 4 > n) return PF_INCOMPLETE;
    uint32_t want;
    std::memcpy(&want, b + pos, 4);
    uint32_t got = crc32_update(0, b, (size_t)pos);
    pos += 4;
    if (want != got) return PF_CORRUPT;
    // deferred status validation, exactly like the Python parser
    if (resp_shape)
      for (const auto& e : out.entries)
        if (e.status > 1) return PF_MALFORMED;
  }
  if (out.trace_len) {
    for (int32_t i = 0; i < out.trace_len; i++) {
      uint8_t c = b[out.trace_off + i];
      if (!((c >= '0' && c <= '9') || (c >= 'a' && c <= 'f')))
        return PF_MALFORMED;
    }
  }
  if (ftype == T_VERIFY_REQ || ftype == T_VERIFY_REQ_CRC ||
      ftype == T_VERIFY_REQ_TRACE) {
    // token decode AFTER integrity (Python: entries decoded last)
    for (const auto& e : out.entries)
      if (!utf8_valid(b + e.off, e.len)) return PF_UTF8;
  }
  out.consumed = pos;
  return PF_OK;
}

// ---------------------------------------------------------------------------
// frame-encode + socket helpers shared by both chains
// ---------------------------------------------------------------------------

inline void put_u32(std::string& s, uint32_t v) {
  s.append((const char*)&v, 4);
}

inline void append_crc(std::string& s) {
  uint32_t crc = crc32_update(0, (const uint8_t*)s.data(), s.size());
  put_u32(s, crc);
}

inline bool send_all(int fd, const std::string& data) {
  const char* p = data.data();
  size_t left = data.size();
  while (left) {
    ssize_t w = ::send(fd, p, left, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += w;
    left -= (size_t)w;
  }
  return true;
}

}  // namespace cvb1

#endif  // CAP_TPU_CVB1_WIRE_H_
