// _capclaims — native batch claims-JSON parsing for cap_tpu.
//
// The reference parses claims with encoding/json per token inside its
// verify path (jwt/validator.go UnmarshalClaims → map[string]interface{});
// the Python analog (json.loads per payload) costs 5-25 µs/token on the
// host and sits on the GIL, capping honest unique-token batch
// throughput. This extension splits the work:
//
//   phase 1 (GIL RELEASED, multithreaded): every payload is scanned by
//     a strict JSON parser into a flat numeric "tape" — string/number
//     spans, structural ops — with all validation done here;
//   phase 2 (GIL held, single pass): the tapes replay into Python
//     objects. Claim KEYS — and short string VALUES (issuer URLs,
//     audiences, scopes) — repeat massively across tokens, so
//     byte-exact hash intern tables reuse one PyUnicode per distinct
//     byte string, and dicts are presized from phase-1 key counts.
//
// Fidelity contract: for any payload this parser accepts, the result
// is indistinguishable from json.loads(payload); anything outside the
// supported envelope (depth > 64, NaN/Infinity literals, lone
// surrogates, ints > 4300 digits, ...) is flagged FALLBACK and the
// Python side re-parses that token with json.loads — never a silent
// behavioural difference. Malformed JSON is flagged with a parse error
// the Python side maps to MalformedTokenError (same taxonomy as the
// jose path).
//
// Build: make native (g++ -O3 -shared -fPIC -pthread, linked against
// the CPython headers; the module ships as source and is compiled on
// first use like the rest of the native runtime).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <dlfcn.h>

#include "claims_tape.h"

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Phase 1 lives in claims_tape.h (Parser/TokenTape/Op/Status), shared
// with the native claims-rule engine (claims_validate.cpp) so the two
// consumers of the tape can never drift on what they accept.
// ---------------------------------------------------------------------------

using capclaims::kMaxIntDigits;
using capclaims::Parser;
using capclaims::TokenTape;
using capclaims::OP_OBJ_START;
using capclaims::OP_OBJ_END;
using capclaims::OP_ARR_START;
using capclaims::OP_ARR_END;
using capclaims::OP_KEY;
using capclaims::OP_STR;
using capclaims::OP_INT;
using capclaims::OP_BIGINT;
using capclaims::OP_FLOAT;
using capclaims::OP_TRUE;
using capclaims::OP_FALSE;
using capclaims::OP_NULL;
using capclaims::ST_OK;
using capclaims::ST_MALFORMED;
using capclaims::ST_NOT_OBJECT;
using capclaims::ST_FALLBACK;

// ---------------------------------------------------------------------------
// Phase 2: tape → Python objects
// ---------------------------------------------------------------------------

// Byte-exact string intern table (open addressing, FNV-1a). Two uses:
//   keys   — claims keys ("iss", "sub", "exp", ...) repeat across every
//            token in a batch; one interned PyUnicode per distinct key
//            makes dict fills cheap (cached hash, pointer-equal keys);
//   values — short unescaped string VALUES (issuer URLs, audiences,
//            scopes) also repeat per-batch; sharing one PyUnicode turns
//            ~half the per-token decodes into INCREFs. Strings are
//            immutable, so sharing across result dicts is safe.
// Bounded: past max_entries, get() declines and the caller decodes
// directly (degenerate all-unique batches stay O(1) per miss because a
// miss probes an under-half-full table, not a growing list).
struct InternTable {
  struct Slot {
    uint64_t hash = 0;
    uint32_t off = 0;
    uint32_t len = 0;
    PyObject* obj = nullptr;  // owned; nullptr = empty slot
  };
  std::vector<Slot> slots;  // power-of-two size, load factor ≤ 1/2
  std::string arena;        // backing bytes for stored entries
  size_t count = 0;
  size_t max_entries;
  bool intern;  // keys get PyUnicode_InternInPlace; values do not

  InternTable(size_t n_slots_pow2, size_t cap, bool intern_keys)
      : slots(n_slots_pow2), max_entries(cap), intern(intern_keys) {}
  ~InternTable() {
    for (auto& s : slots) Py_XDECREF(s.obj);
  }

  static uint64_t fnv1a(const uint8_t* p, size_t n) {
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < n; ++i) {
      h ^= p[i];
      h *= 1099511628211ull;
    }
    return h;
  }

  // Borrowed reference, or nullptr when the caller should decode
  // directly (table full, or — impossible for phase-1-validated UTF-8 —
  // decode failure; the caller's own decode then raises properly).
  PyObject* get(const uint8_t* data, size_t len) {
    uint64_t h = fnv1a(data, len);
    size_t mask = slots.size() - 1;
    size_t j = static_cast<size_t>(h) & mask;
    while (slots[j].obj != nullptr) {
      if (slots[j].hash == h && slots[j].len == len &&
          std::memcmp(arena.data() + slots[j].off, data, len) == 0)
        return slots[j].obj;
      j = (j + 1) & mask;
    }
    if (count >= max_entries) return nullptr;
    PyObject* o = PyUnicode_DecodeUTF8(reinterpret_cast<const char*>(data),
                                       static_cast<Py_ssize_t>(len),
                                       nullptr);
    if (o == nullptr) return nullptr;
    if (intern) PyUnicode_InternInPlace(&o);
    slots[j].hash = h;
    slots[j].off = static_cast<uint32_t>(arena.size());
    slots[j].len = static_cast<uint32_t>(len);
    slots[j].obj = o;
    arena.append(reinterpret_cast<const char*>(data), len);
    ++count;
    return o;
  }
};

// Value strings longer than this decode directly: long strings amortize
// their own decode, and the arena stays small.
constexpr size_t kMaxCachedValueLen = 64;

// dlsym-resolved _PyDict_NewPresized (CPython private API, exported and
// stable in practice; pydantic-core relies on it the same way). One
// claims dict has ~8-12 keys — past 5, PyDict_New's initial table
// resizes mid-fill, so presizing saves an alloc + rehash per token.
// nullptr (symbol absent) falls back to PyDict_New.
using DictNewPresizedFn = PyObject* (*)(Py_ssize_t);
DictNewPresizedFn dict_new_presized = nullptr;

PyObject* decode_escaped(const uint8_t* data, size_t len) {
  // Unescape into a scratch, then UTF-8 decode. Validation already
  // happened in phase 1, so escapes are well-formed and non-surrogate.
  std::string buf;
  buf.reserve(len);
  size_t i = 0;
  while (i < len) {
    uint8_t c = data[i];
    if (c != '\\') {
      buf.push_back(static_cast<char>(c));
      ++i;
      continue;
    }
    uint8_t e = data[i + 1];
    switch (e) {
      case '"': buf.push_back('"'); i += 2; break;
      case '\\': buf.push_back('\\'); i += 2; break;
      case '/': buf.push_back('/'); i += 2; break;
      case 'b': buf.push_back('\b'); i += 2; break;
      case 'f': buf.push_back('\f'); i += 2; break;
      case 'n': buf.push_back('\n'); i += 2; break;
      case 'r': buf.push_back('\r'); i += 2; break;
      case 't': buf.push_back('\t'); i += 2; break;
      default: {  // \uXXXX (non-surrogate — surrogates went to fallback)
        uint32_t v = 0;
        for (int k = 2; k <= 5; ++k) {
          uint8_t h = data[i + k];
          v = v * 16 + (h <= '9' ? h - '0' : (h | 32) - 'a' + 10);
        }
        if (v < 0x80) {
          buf.push_back(static_cast<char>(v));
        } else if (v < 0x800) {
          buf.push_back(static_cast<char>(0xC0 | (v >> 6)));
          buf.push_back(static_cast<char>(0x80 | (v & 0x3F)));
        } else {
          buf.push_back(static_cast<char>(0xE0 | (v >> 12)));
          buf.push_back(static_cast<char>(0x80 | ((v >> 6) & 0x3F)));
          buf.push_back(static_cast<char>(0x80 | (v & 0x3F)));
        }
        i += 6;
      }
    }
  }
  return PyUnicode_DecodeUTF8(buf.data(),
                              static_cast<Py_ssize_t>(buf.size()), nullptr);
}

// Replay one token's tape. Returns a new reference, or nullptr with a
// Python exception set.
PyObject* build_from_tape(const TokenTape& tape, const uint8_t* payload,
                          InternTable* keys, InternTable* strs) {
  // Explicit container stack; values attach to the top container (dict
  // via pending key, list via append).
  struct Frame {
    PyObject* container;  // owned here until popped
    PyObject* key;        // owned; pending dict key
  };
  std::vector<Frame> stack;
  PyObject* root = nullptr;

  auto attach = [&](PyObject* v) -> bool {  // steals v
    if (stack.empty()) {
      root = v;
      return true;
    }
    Frame& f = stack.back();
    if (PyDict_CheckExact(f.container)) {
      int rc = PyDict_SetItem(f.container, f.key, v);
      Py_DECREF(v);
      Py_CLEAR(f.key);
      return rc == 0;
    }
    int rc = PyList_Append(f.container, v);
    Py_DECREF(v);
    return rc == 0;
  };
  auto fail = [&]() -> PyObject* {
    for (auto& f : stack) {
      Py_XDECREF(f.container);
      Py_XDECREF(f.key);
    }
    Py_XDECREF(root);
    return nullptr;
  };

  const uint32_t* ops = tape.ops.data();
  size_t nops = tape.ops.size();
  for (size_t t = 0; t < nops; t += 3) {
    uint32_t op = ops[t], a = ops[t + 1], b = ops[t + 2];
    switch (op) {
      case OP_OBJ_START: {
        // `a` = key count (backpatched by phase 1); CPython's fresh
        // dict already holds 5 entries, so presize only beyond that.
        PyObject* d = (a > 5 && dict_new_presized != nullptr)
                          ? dict_new_presized(static_cast<Py_ssize_t>(a))
                          : PyDict_New();
        if (d == nullptr) return fail();
        stack.push_back({d, nullptr});
        break;
      }
      case OP_ARR_START: {
        PyObject* l = PyList_New(0);
        if (l == nullptr) return fail();
        stack.push_back({l, nullptr});
        break;
      }
      case OP_OBJ_END:
      case OP_ARR_END: {
        PyObject* done = stack.back().container;
        Py_XDECREF(stack.back().key);
        stack.pop_back();
        if (!attach(done)) return fail();
        break;
      }
      case OP_KEY: {
        uint32_t len = b >> 1, esc = b & 1;
        const char* data = reinterpret_cast<const char*>(payload + a);
        PyObject* k;
        if (esc) {
          k = decode_escaped(payload + a, len);
        } else {
          PyObject* cached =
              keys->get(reinterpret_cast<const uint8_t*>(data), len);
          if (cached != nullptr) {
            Py_INCREF(cached);
            k = cached;
          } else {
            k = PyUnicode_DecodeUTF8(data, static_cast<Py_ssize_t>(len),
                                     nullptr);
          }
        }
        if (k == nullptr) return fail();
        Py_XDECREF(stack.back().key);
        stack.back().key = k;
        break;
      }
      case OP_STR: {
        uint32_t len = b >> 1, esc = b & 1;
        PyObject* v = nullptr;
        if (!esc && len <= kMaxCachedValueLen) {
          PyObject* cached = strs->get(payload + a, len);
          if (cached != nullptr) {
            Py_INCREF(cached);
            v = cached;
          }
        }
        if (v == nullptr) {
          v = esc ? decode_escaped(payload + a, len)
                  : PyUnicode_DecodeUTF8(
                        reinterpret_cast<const char*>(payload + a),
                        static_cast<Py_ssize_t>(len), nullptr);
        }
        if (v == nullptr || !attach(v)) return fail();
        break;
      }
      case OP_INT: {
        int64_t iv = static_cast<int64_t>(
            (static_cast<uint64_t>(b) << 32) | a);
        PyObject* v = PyLong_FromLongLong(iv);
        if (v == nullptr || !attach(v)) return fail();
        break;
      }
      case OP_BIGINT: {
        char buf[kMaxIntDigits + 2];
        std::memcpy(buf, payload + a, b);
        buf[b] = 0;
        PyObject* v = PyLong_FromString(buf, nullptr, 10);
        if (v == nullptr || !attach(v)) return fail();
        break;
      }
      case OP_FLOAT: {
        uint64_t bits = (static_cast<uint64_t>(b) << 32) | a;
        double d;
        std::memcpy(&d, &bits, 8);
        PyObject* v = PyFloat_FromDouble(d);
        if (v == nullptr || !attach(v)) return fail();
        break;
      }
      case OP_TRUE:
      case OP_FALSE: {
        PyObject* v = op == OP_TRUE ? Py_True : Py_False;
        Py_INCREF(v);
        if (!attach(v)) return fail();
        break;
      }
      case OP_NULL: {
        Py_INCREF(Py_None);
        if (!attach(Py_None)) return fail();
        break;
      }
      default:
        PyErr_SetString(PyExc_SystemError, "corrupt claims tape");
        return fail();
    }
  }
  return root;
}

// ---------------------------------------------------------------------------
// Module entry: parse_batch(scratch, offsets, lengths) → (list, n_bad)
// ---------------------------------------------------------------------------

// Shared phase-1 scaffolding: argument/bounds validation + the GIL-free
// multithreaded scan. per_token(i, tape) runs off the GIL and must not
// touch Python state; both parse_batch and validate_batch ride this so
// a bounds or thread-sizing fix can never diverge between them.
template <typename PerToken>
bool run_phase1(Py_buffer* scratch, Py_buffer* offv, Py_buffer* lenv,
                int n_threads, PerToken per_token) {
  const uint8_t* base = static_cast<const uint8_t*>(scratch->buf);
  const int64_t* offs = static_cast<const int64_t*>(offv->buf);
  const int64_t* lens = static_cast<const int64_t*>(lenv->buf);
  Py_ssize_t n = offv->len / static_cast<Py_ssize_t>(sizeof(int64_t));

  bool bounds_ok = lenv->len == offv->len;
  for (Py_ssize_t i = 0; bounds_ok && i < n; ++i) {
    if (offs[i] < 0 || lens[i] < 0 || offs[i] + lens[i] > scratch->len)
      bounds_ok = false;
  }
  if (!bounds_ok) {
    PyErr_SetString(PyExc_ValueError, "offsets/lengths out of bounds");
    return false;
  }

  Py_BEGIN_ALLOW_THREADS
  unsigned hw = std::thread::hardware_concurrency();
  size_t workers = n_threads > 0 ? static_cast<size_t>(n_threads)
                                 : (hw ? hw : 4);
  if (workers > static_cast<size_t>(n) && n > 0)
    workers = static_cast<size_t>(n);
  if (workers <= 1 || n < 256) {
    for (Py_ssize_t i = 0; i < n; ++i) {
      TokenTape tape;
      Parser p(base + offs[i], static_cast<size_t>(lens[i]), &tape);
      p.run();
      per_token(static_cast<size_t>(i), std::move(tape));
    }
  } else {
    std::vector<std::thread> pool;
    std::atomic<size_t> next{0};
    for (size_t w = 0; w < workers; ++w) {
      pool.emplace_back([&]() {
        constexpr size_t kGrain = 256;
        while (true) {
          size_t lo = next.fetch_add(kGrain);
          if (lo >= static_cast<size_t>(n)) return;
          size_t hi = lo + kGrain;
          if (hi > static_cast<size_t>(n)) hi = static_cast<size_t>(n);
          for (size_t i = lo; i < hi; ++i) {
            TokenTape tape;
            Parser p(base + offs[i], static_cast<size_t>(lens[i]),
                     &tape);
            p.run();
            per_token(i, std::move(tape));
          }
        }
      });
    }
    for (auto& t : pool) t.join();
  }
  Py_END_ALLOW_THREADS
  return true;
}

// Returns (results, n_bad): results is a list with one entry per token:
//   dict  — parsed claims
//   1     — malformed JSON        (int sentinel)
//   2     — valid JSON, not an object
//   3     — fallback: caller must json.loads this payload
// n_bad counts the non-dict entries, so the caller's common case
// (n_bad == 0) can bulk-insert the list without a per-token type scan.
PyObject* parse_batch(PyObject*, PyObject* args) {
  Py_buffer scratch, offv, lenv;
  int n_threads = 0;
  if (!PyArg_ParseTuple(args, "y*y*y*|i", &scratch, &offv, &lenv,
                        &n_threads))
    return nullptr;
  const uint8_t* base = static_cast<const uint8_t*>(scratch.buf);
  const int64_t* offs = static_cast<const int64_t*>(offv.buf);
  Py_ssize_t n = offv.len / static_cast<Py_ssize_t>(sizeof(int64_t));

  std::vector<TokenTape> tapes(static_cast<size_t>(n));
  bool ok = run_phase1(&scratch, &offv, &lenv, n_threads,
                       [&](size_t i, TokenTape&& tape) {
                         tapes[i] = std::move(tape);
                       });
  if (!ok) {
    PyBuffer_Release(&scratch);
    PyBuffer_Release(&offv);
    PyBuffer_Release(&lenv);
    return nullptr;
  }

  InternTable keys(/*n_slots_pow2=*/512, /*cap=*/256,
                   /*intern_keys=*/true);
  // Scale the value table with the batch so small batches (serve
  // batches of ~256, handfuls in tests) don't pay a fixed ~200 KB
  // zero-init before parsing the first token.
  size_t str_slots = 64;
  while (str_slots < static_cast<size_t>(n) * 8 && str_slots < 8192)
    str_slots <<= 1;
  InternTable strs(str_slots, str_slots / 2, /*intern_keys=*/false);
  Py_ssize_t n_bad = 0;
  PyObject* out = PyList_New(n);
  if (out == nullptr) {
    PyBuffer_Release(&scratch);
    PyBuffer_Release(&offv);
    PyBuffer_Release(&lenv);
    return nullptr;
  }
  bool err = false;
  for (Py_ssize_t i = 0; i < n && !err; ++i) {
    PyObject* item;
    if (tapes[i].status == ST_OK) {
      item = build_from_tape(tapes[static_cast<size_t>(i)], base + offs[i],
                             &keys, &strs);
      if (item == nullptr) err = true;
    } else {
      item = PyLong_FromLong(tapes[i].status);
      ++n_bad;
      if (item == nullptr) err = true;
    }
    if (!err) PyList_SET_ITEM(out, i, item);
  }
  PyBuffer_Release(&scratch);
  PyBuffer_Release(&offv);
  PyBuffer_Release(&lenv);
  if (err) {
    Py_DECREF(out);
    return nullptr;
  }
  PyObject* nb = PyLong_FromSsize_t(n_bad);
  if (nb == nullptr) {
    Py_DECREF(out);
    return nullptr;
  }
  PyObject* ret = PyTuple_Pack(2, out, nb);
  Py_DECREF(out);
  Py_DECREF(nb);
  return ret;
}

// Phase 1 ONLY: per-token payload status byte, no Python objects.
// The serve path's raw-claims mode needs "is this a valid JSON object"
// (the signed payload bytes then pass through verbatim) without paying
// for dict construction. Status values are the parser's own:
// 0 = valid object, 1 = malformed, 2 = valid JSON but not an object,
// 3 = outside the strict parser's envelope (caller decides via
// json.loads). Scan runs GIL-free across threads like parse_batch.
PyObject* validate_batch(PyObject*, PyObject* args) {
  Py_buffer scratch, offv, lenv;
  int n_threads = 0;
  if (!PyArg_ParseTuple(args, "y*y*y*|i", &scratch, &offv, &lenv,
                        &n_threads))
    return nullptr;
  Py_ssize_t n = offv.len / static_cast<Py_ssize_t>(sizeof(int64_t));

  PyObject* out = PyBytes_FromStringAndSize(nullptr, n);
  if (out == nullptr) {
    PyBuffer_Release(&scratch);
    PyBuffer_Release(&offv);
    PyBuffer_Release(&lenv);
    return nullptr;
  }
  uint8_t* st = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));

  bool ok = run_phase1(&scratch, &offv, &lenv, n_threads,
                       [&](size_t i, TokenTape&& tape) {
                         st[i] = static_cast<uint8_t>(tape.status);
                       });
  PyBuffer_Release(&scratch);
  PyBuffer_Release(&offv);
  PyBuffer_Release(&lenv);
  if (!ok) {
    Py_DECREF(out);
    return nullptr;
  }
  return out;
}

// ---------------------------------------------------------------------------
// registered_batch: ONLY the registered id_token claims, no full dicts
// ---------------------------------------------------------------------------
//
// The OIDC batch validator reads exactly these top-level claims:
// iss, sub, aud, exp, nbf, iat, nonce, azp, auth_time. Materializing a
// 9-key subset dict from the phase-1 tape skips the full claims dict
// (every key, every value, every nested container) for tokens whose
// payload is only being VALIDATED — the raw-claims OIDC mode, where
// accepted tokens return their signed payload bytes verbatim
// (provider.verify_id_token_batch(raw=True); the serve-path analog).
//
// Conservative fallbacks (status 3 → caller re-parses with json.loads
// and validates from the full dict, so semantics never diverge):
//   - any ESCAPED top-level key (an escape could spell a registered
//     name; the full parser would match it);
//   - a registered claim whose value is an object or a non-flat array
//     (the validator's type checks must see the exact parsed shape).

static const struct {
  const char* name;
  uint32_t len;
} kRegistered[] = {
    {"iss", 3}, {"sub", 3}, {"aud", 3},   {"exp", 3},       {"nbf", 3},
    {"iat", 3}, {"azp", 3}, {"nonce", 5}, {"auth_time", 9},
};
constexpr int kNumRegistered =
    static_cast<int>(sizeof(kRegistered) / sizeof(kRegistered[0]));

// Scalar tape entry → new ref; nullptr with *is_scalar=false for
// container ops (no Python error raised in that case).
PyObject* scalar_of(uint32_t op, uint32_t a, uint32_t b,
                    const uint8_t* payload, bool* is_scalar) {
  *is_scalar = true;
  switch (op) {
    case OP_STR: {
      uint32_t len = b >> 1, esc = b & 1;
      return esc ? decode_escaped(payload + a, len)
                 : PyUnicode_DecodeUTF8(
                       reinterpret_cast<const char*>(payload + a),
                       static_cast<Py_ssize_t>(len), nullptr);
    }
    case OP_INT:
      return PyLong_FromLongLong(static_cast<int64_t>(
          (static_cast<uint64_t>(b) << 32) | a));
    case OP_BIGINT: {
      char buf[kMaxIntDigits + 2];
      std::memcpy(buf, payload + a, b);
      buf[b] = 0;
      return PyLong_FromString(buf, nullptr, 10);
    }
    case OP_FLOAT: {
      uint64_t bits = (static_cast<uint64_t>(b) << 32) | a;
      double d;
      std::memcpy(&d, &bits, 8);
      return PyFloat_FromDouble(d);
    }
    case OP_TRUE:
      Py_RETURN_TRUE;
    case OP_FALSE:
      Py_RETURN_FALSE;
    case OP_NULL:
      Py_RETURN_NONE;
    default:
      *is_scalar = false;
      return nullptr;
  }
}

// Subset dict from one ST_OK tape; nullptr + *fallback for the
// conservative cases above; nullptr without *fallback on real errors.
PyObject* build_registered(const TokenTape& tape, const uint8_t* payload,
                           bool* fallback) {
  *fallback = false;
  const uint32_t* ops = tape.ops.data();
  size_t nops = tape.ops.size();
  PyObject* out = PyDict_New();
  if (out == nullptr) return nullptr;
  int depth = 0;
  int reg = -1;  // pending registered key index at depth 1

  auto bail = [&](bool fb) -> PyObject* {
    *fallback = fb;
    Py_DECREF(out);
    return nullptr;
  };
  auto set_reg = [&](PyObject* v) -> bool {  // steals v
    int rc = PyDict_SetItemString(out, kRegistered[reg].name, v);
    Py_DECREF(v);
    reg = -1;
    return rc == 0;
  };

  for (size_t t = 0; t < nops; t += 3) {
    uint32_t op = ops[t], a = ops[t + 1], b = ops[t + 2];
    switch (op) {
      case OP_OBJ_START:
        if (reg >= 0 && depth == 1) return bail(true);
        ++depth;
        break;
      case OP_ARR_START: {
        if (reg >= 0 && depth == 1) {
          // flat scalar array (the aud shape); anything nested → full
          PyObject* lst = PyList_New(0);
          if (lst == nullptr) return bail(false);
          size_t u = t + 3;
          for (; u < nops; u += 3) {
            if (ops[u] == OP_ARR_END) break;
            bool is_scalar;
            PyObject* v = scalar_of(ops[u], ops[u + 1], ops[u + 2],
                                    payload, &is_scalar);
            if (!is_scalar) {
              Py_DECREF(lst);
              return bail(true);
            }
            if (v == nullptr || PyList_Append(lst, v) != 0) {
              Py_XDECREF(v);
              Py_DECREF(lst);
              return bail(false);
            }
            Py_DECREF(v);
          }
          if (u >= nops) {
            Py_DECREF(lst);
            PyErr_SetString(PyExc_SystemError, "corrupt claims tape");
            return bail(false);
          }
          if (!set_reg(lst)) return bail(false);
          t = u;  // at OP_ARR_END; loop increment skips it
          break;
        }
        ++depth;
        break;
      }
      case OP_OBJ_END:
      case OP_ARR_END:
        --depth;
        break;
      case OP_KEY: {
        if (depth != 1) break;
        uint32_t len = b >> 1, esc = b & 1;
        if (esc) return bail(true);  // could spell a registered name
        reg = -1;
        for (int r = 0; r < kNumRegistered; ++r) {
          if (kRegistered[r].len == len &&
              std::memcmp(payload + a, kRegistered[r].name, len) == 0) {
            reg = r;
            break;
          }
        }
        break;
      }
      default: {
        if (reg >= 0 && depth == 1) {
          bool is_scalar;
          PyObject* v = scalar_of(op, a, b, payload, &is_scalar);
          if (v == nullptr) {
            if (!is_scalar)  // unknown future op: fail LOUDLY, like
                             // build_from_tape's corrupt-tape guard
              PyErr_SetString(PyExc_SystemError, "corrupt claims tape");
            return bail(false);
          }
          if (!set_reg(v)) return bail(false);
        }
        break;
      }
    }
  }
  return out;
}

// Same calling convention and status protocol as parse_batch, but list
// entries are SUBSET dicts (registered claims only). Status 3 also
// covers the conservative fallbacks documented above.
PyObject* registered_batch(PyObject*, PyObject* args) {
  Py_buffer scratch, offv, lenv;
  int n_threads = 0;
  if (!PyArg_ParseTuple(args, "y*y*y*|i", &scratch, &offv, &lenv,
                        &n_threads))
    return nullptr;
  const uint8_t* base = static_cast<const uint8_t*>(scratch.buf);
  const int64_t* offs = static_cast<const int64_t*>(offv.buf);
  Py_ssize_t n = offv.len / static_cast<Py_ssize_t>(sizeof(int64_t));

  std::vector<TokenTape> tapes(static_cast<size_t>(n));
  bool ok = run_phase1(&scratch, &offv, &lenv, n_threads,
                       [&](size_t i, TokenTape&& tape) {
                         tapes[i] = std::move(tape);
                       });
  if (!ok) {
    PyBuffer_Release(&scratch);
    PyBuffer_Release(&offv);
    PyBuffer_Release(&lenv);
    return nullptr;
  }
  Py_ssize_t n_bad = 0;
  PyObject* out = PyList_New(n);
  bool err = out == nullptr;
  for (Py_ssize_t i = 0; i < n && !err; ++i) {
    PyObject* item = nullptr;
    int32_t status = tapes[i].status;
    if (status == ST_OK) {
      bool fb = false;
      item = build_registered(tapes[static_cast<size_t>(i)],
                              base + offs[i], &fb);
      if (item == nullptr) {
        if (!fb) {
          err = true;
        } else {
          status = ST_FALLBACK;
        }
      }
    }
    if (!err && item == nullptr) {
      item = PyLong_FromLong(status);
      ++n_bad;
      if (item == nullptr) err = true;
    }
    if (!err) PyList_SET_ITEM(out, i, item);
  }
  PyBuffer_Release(&scratch);
  PyBuffer_Release(&offv);
  PyBuffer_Release(&lenv);
  if (err) {
    Py_XDECREF(out);
    return nullptr;
  }
  PyObject* nb = PyLong_FromSsize_t(n_bad);
  if (nb == nullptr) {
    Py_DECREF(out);
    return nullptr;
  }
  PyObject* ret = PyTuple_Pack(2, out, nb);
  Py_DECREF(out);
  Py_DECREF(nb);
  return ret;
}

PyMethodDef methods[] = {
    {"parse_batch", parse_batch, METH_VARARGS,
     "parse_batch(scratch, offsets_i64, lengths_i64, n_threads=0) -> "
     "(list[dict | int-status], n_bad)"},
    {"registered_batch", registered_batch, METH_VARARGS,
     "registered_batch(scratch, offsets_i64, lengths_i64, n_threads=0)"
     " -> (list[subset-dict | int-status], n_bad); registered id_token"
     " claims only (iss sub aud exp nbf iat nonce azp auth_time)"},
    {"validate_batch", validate_batch, METH_VARARGS,
     "validate_batch(scratch, offsets_i64, lengths_i64, n_threads=0) "
     "-> bytes (per-token status: 0 ok-object, 1 malformed, 2 "
     "non-object, 3 outside-envelope)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_capclaims",
    "Batch claims-JSON parsing (native runtime)", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__capclaims(void) {
#if PY_VERSION_HEX >= 0x03080000 && PY_VERSION_HEX < 0x030E0000
  // _PyDict_NewPresized is private API; its export and semantics are
  // verified against CPython 3.8-3.13 (the signature has been stable
  // since 3.4, and pydantic-core ships the same lookup). On CPython
  // versions outside that tested range the lookup is skipped entirely
  // so a changed symbol can't be trusted blindly: dict_new_presized
  // stays nullptr and every dict build takes the PyDict_New fallback.
  dict_new_presized = reinterpret_cast<DictNewPresizedFn>(
      dlsym(RTLD_DEFAULT, "_PyDict_NewPresized"));
#endif
  return PyModule_Create(&moduledef);
}
