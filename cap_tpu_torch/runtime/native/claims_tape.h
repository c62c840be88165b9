// claims_tape.h — the claims-JSON phase-1 parser, shared verbatim by
// the _capclaims extension (claims_ext.cpp: tape → Python objects) and
// the native claims-rule engine (claims_validate.cpp: tape → rule
// verdicts inside libcapruntime.so). ONE parser feeds both consumers:
// a bounds/validation fix here can never diverge between the path
// that builds dicts and the path that evaluates OIDC rules.
//
// Everything here is Python-free C++17 (claims_validate.cpp compiles
// without the CPython headers); all functions are inline/in-struct so
// the header can sit in several translation units.
//
// Contract (unchanged from the r5 claims_ext.cpp original): for any
// payload the parser accepts (ST_OK), the tape replays into exactly
// what json.loads(payload) would build; anything outside the
// supported envelope (depth > 64, NaN/Infinity, lone surrogates,
// ints > 2000 digits, ...) is flagged ST_FALLBACK and the consumer
// must re-parse with json.loads — never a silent behavioural
// difference. Malformed JSON is ST_MALFORMED.

#ifndef CAP_TPU_CLAIMS_TAPE_H_
#define CAP_TPU_CLAIMS_TAPE_H_

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace capclaims {

// ---------------------------------------------------------------------------
// Tape representation (phase-1 output)
// ---------------------------------------------------------------------------

enum Op : uint32_t {
  OP_OBJ_START = 1,
  OP_OBJ_END = 2,
  OP_ARR_START = 3,
  OP_ARR_END = 4,
  OP_KEY = 5,      // off, len, esc  (string span; esc => needs unescape)
  OP_STR = 6,      // off, len, esc
  OP_INT = 7,      // lo, hi         (int64 in two u32 slots)
  OP_BIGINT = 8,   // off, len       (digits span; PyLong_FromString)
  OP_FLOAT = 9,    // lo, hi         (double bits in two u32 slots)
  OP_TRUE = 10,
  OP_FALSE = 11,
  OP_NULL = 12,
};

enum Status : int32_t {
  ST_OK = 0,
  ST_MALFORMED = 1,   // invalid JSON → MalformedTokenError
  ST_NOT_OBJECT = 2,  // valid JSON, but not an object → MalformedTokenError
  ST_FALLBACK = 3,    // valid-looking but outside the envelope → json.loads
};

constexpr int kMaxDepth = 64;
// CPython refuses int() conversion beyond sys.int_info.default_max_str_digits
// (4300) — route anything close to that through json.loads.
constexpr int kMaxIntDigits = 2000;

struct TokenTape {
  std::vector<uint32_t> ops;  // triplets: op, a, b
  int32_t status = ST_MALFORMED;
};

struct Parser {
  const uint8_t* s;
  size_t n;
  size_t i = 0;
  TokenTape* out;

  explicit Parser(const uint8_t* data, size_t len, TokenTape* tape)
      : s(data), n(len), out(tape) {}

  void emit(uint32_t op, uint32_t a = 0, uint32_t b = 0) {
    out->ops.push_back(op);
    out->ops.push_back(a);
    out->ops.push_back(b);
  }

  void ws() {
    while (i < n && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n' ||
                     s[i] == '\r'))
      ++i;
  }

  // Scan a JSON string starting AFTER the opening quote; returns false on
  // malformed. Sets *esc when escapes are present, validates UTF-8 and
  // escape syntax (so phase 2 can decode without error paths).
  bool scan_string(uint32_t* off, uint32_t* len, uint32_t* esc, bool* fb) {
    size_t start = i;
    *esc = 0;
    while (i < n) {
      uint8_t c = s[i];
      if (c == '"') {
        *off = static_cast<uint32_t>(start);
        *len = static_cast<uint32_t>(i - start);
        ++i;
        return true;
      }
      if (c == '\\') {
        *esc = 1;
        if (i + 1 >= n) return false;
        uint8_t e = s[i + 1];
        if (e == 'u') {
          if (i + 5 >= n) return false;
          for (int k = 2; k <= 5; ++k) {
            uint8_t h = s[i + k];
            if (!((h >= '0' && h <= '9') || (h >= 'a' && h <= 'f') ||
                  (h >= 'A' && h <= 'F')))
              return false;
          }
          // Lone/paired surrogates: json.loads has precise pass-through
          // semantics for lone surrogates — route any surrogate escape
          // to the fallback rather than replicate them bug-for-bug.
          uint32_t v = 0;
          for (int k = 2; k <= 5; ++k) {
            uint8_t h = s[i + k];
            v = v * 16 + (h <= '9' ? h - '0' : (h | 32) - 'a' + 10);
          }
          if (v >= 0xD800 && v <= 0xDFFF) *fb = true;
          i += 6;
          continue;
        }
        if (e != '"' && e != '\\' && e != '/' && e != 'b' && e != 'f' &&
            e != 'n' && e != 'r' && e != 't')
          return false;
        i += 2;
        continue;
      }
      if (c < 0x20) return false;  // unescaped control char
      if (c < 0x80) {
        ++i;
        continue;
      }
      // UTF-8 validation (strict, no overlongs/surrogates) so phase 2's
      // PyUnicode_DecodeUTF8 cannot fail.
      int need;
      uint32_t cp;
      if ((c & 0xE0) == 0xC0) {
        need = 1;
        cp = c & 0x1F;
        if (cp < 2) return false;  // overlong
      } else if ((c & 0xF0) == 0xE0) {
        need = 2;
        cp = c & 0x0F;
      } else if ((c & 0xF8) == 0xF0) {
        need = 3;
        cp = c & 0x07;
      } else {
        return false;
      }
      if (i + need >= n) return false;
      for (int k = 1; k <= need; ++k) {
        uint8_t cc = s[i + k];
        if ((cc & 0xC0) != 0x80) return false;
        cp = (cp << 6) | (cc & 0x3F);
      }
      if (need == 2 && (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF)))
        return false;
      if (need == 3 && (cp < 0x10000 || cp > 0x10FFFF)) return false;
      i += need + 1;
    }
    return false;  // unterminated
  }

  bool parse_number(bool* fb) {
    size_t start = i;
    bool is_float = false;
    if (i < n && s[i] == '-') ++i;
    if (i >= n) return false;
    if (s[i] == '0') {
      ++i;
    } else if (s[i] >= '1' && s[i] <= '9') {
      while (i < n && s[i] >= '0' && s[i] <= '9') ++i;
    } else {
      return false;
    }
    if (i < n && s[i] == '.') {
      is_float = true;
      ++i;
      if (i >= n || s[i] < '0' || s[i] > '9') return false;
      while (i < n && s[i] >= '0' && s[i] <= '9') ++i;
    }
    if (i < n && (s[i] == 'e' || s[i] == 'E')) {
      is_float = true;
      ++i;
      if (i < n && (s[i] == '+' || s[i] == '-')) ++i;
      if (i >= n || s[i] < '0' || s[i] > '9') return false;
      while (i < n && s[i] >= '0' && s[i] <= '9') ++i;
    }
    size_t len = i - start;
    if (is_float) {
      // strtod matches json.loads (float(repr) semantics): both parse
      // the shortest round-trip; overflow → ±inf, same as json.loads.
      char buf[340];
      if (len >= sizeof(buf)) {
        *fb = true;
        return true;
      }
      std::memcpy(buf, s + start, len);
      buf[len] = 0;
      char* end = nullptr;
      double v = std::strtod(buf, &end);
      if (end != buf + len) return false;
      uint64_t bits;
      std::memcpy(&bits, &v, 8);
      emit(OP_FLOAT, static_cast<uint32_t>(bits),
           static_cast<uint32_t>(bits >> 32));
      return true;
    }
    // Integer: int64 fast path, digit-span for big ones.
    size_t digs = len - (s[start] == '-' ? 1 : 0);
    if (digs <= 18) {
      int64_t v = 0;
      size_t k = start + (s[start] == '-' ? 1 : 0);
      for (; k < i; ++k) v = v * 10 + (s[k] - '0');
      if (s[start] == '-') v = -v;
      uint64_t u = static_cast<uint64_t>(v);
      emit(OP_INT, static_cast<uint32_t>(u), static_cast<uint32_t>(u >> 32));
      return true;
    }
    if (digs > kMaxIntDigits) {
      *fb = true;
      return true;
    }
    emit(OP_BIGINT, static_cast<uint32_t>(start), static_cast<uint32_t>(len));
    return true;
  }

  // Full value parser. Returns false on malformed; sets *fb to route the
  // token to json.loads (valid JSON we choose not to replicate).
  bool parse_value(int depth, bool* fb) {
    if (depth > kMaxDepth) {
      *fb = true;
      return true;
    }
    ws();
    if (i >= n) return false;
    uint8_t c = s[i];
    switch (c) {
      case '{': {
        ++i;
        // Operand `a` of OP_OBJ_START is backpatched to the key count
        // so phase 2 can presize the dict (0 = empty or unknown).
        size_t hdr = out->ops.size();
        emit(OP_OBJ_START);
        ws();
        if (i < n && s[i] == '}') {
          ++i;
          emit(OP_OBJ_END);
          return true;
        }
        uint32_t nkeys = 0;
        while (true) {
          ws();
          if (i >= n || s[i] != '"') return false;
          ++i;
          uint32_t off, len, esc;
          if (!scan_string(&off, &len, &esc, fb)) return false;
          emit(OP_KEY, off, (len << 1) | esc);
          ++nkeys;
          ws();
          if (i >= n || s[i] != ':') return false;
          ++i;
          if (!parse_value(depth + 1, fb)) return false;
          if (*fb) return true;  // unwind: token goes to json.loads
          ws();
          if (i >= n) return false;
          if (s[i] == ',') {
            ++i;
            continue;
          }
          if (s[i] == '}') {
            ++i;
            out->ops[hdr + 1] = nkeys;
            emit(OP_OBJ_END);
            return true;
          }
          return false;
        }
      }
      case '[': {
        ++i;
        emit(OP_ARR_START);
        ws();
        if (i < n && s[i] == ']') {
          ++i;
          emit(OP_ARR_END);
          return true;
        }
        while (true) {
          if (!parse_value(depth + 1, fb)) return false;
          if (*fb) return true;  // unwind: token goes to json.loads
          ws();
          if (i >= n) return false;
          if (s[i] == ',') {
            ++i;
            continue;
          }
          if (s[i] == ']') {
            ++i;
            emit(OP_ARR_END);
            return true;
          }
          return false;
        }
      }
      case '"': {
        ++i;
        uint32_t off, len, esc;
        if (!scan_string(&off, &len, &esc, fb)) return false;
        emit(OP_STR, off, (len << 1) | esc);
        return true;
      }
      case 't':
        if (i + 4 <= n && std::memcmp(s + i, "true", 4) == 0) {
          i += 4;
          emit(OP_TRUE);
          return true;
        }
        return false;
      case 'f':
        if (i + 5 <= n && std::memcmp(s + i, "false", 5) == 0) {
          i += 5;
          emit(OP_FALSE);
          return true;
        }
        return false;
      case 'n':
        if (i + 4 <= n && std::memcmp(s + i, "null", 4) == 0) {
          i += 4;
          emit(OP_NULL);
          return true;
        }
        return false;
      case 'N':
      case 'I':
        // NaN / Infinity: json.loads accepts these by default. Rare in
        // real claims — fall back rather than replicate.
        *fb = true;
        return true;
      default:
        if (c == '-' && i + 1 < n && s[i + 1] == 'I') {
          *fb = true;  // -Infinity
          return true;
        }
        return parse_number(fb);
    }
  }

  void run() {
    bool fb = false;
    ws();
    bool is_obj = i < n && s[i] == '{';
    if (!parse_value(0, &fb)) {
      out->status = ST_MALFORMED;
      return;
    }
    if (fb) {
      out->status = ST_FALLBACK;
      return;
    }
    ws();
    if (i != n) {
      out->status = ST_MALFORMED;  // trailing garbage
      return;
    }
    out->status = is_obj ? ST_OK : ST_NOT_OBJECT;
  }
};

}  // namespace capclaims

#endif  // CAP_TPU_CLAIMS_TAPE_H_
