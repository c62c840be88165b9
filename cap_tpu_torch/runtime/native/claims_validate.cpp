// claims_validate.cpp — the native OIDC claims-rule engine
// (fourth TU of libcapruntime.so).
//
// PERF.md §Round 5 left ~4 µs/token of per-token Python rule
// evaluation (`oidc/provider.py:_validate_id_claims`) on the batched
// id_token path even after registered-claims extraction went native:
// config ⑤ (full OIDC verify-and-validate) ran at 1.37× the cost of
// config ③ (raw signature verify). The FPGA ECDSA verification-engine
// paper (arXiv:2112.02229) makes the same point in hardware: a verify
// pipeline only hits rated throughput when the ENTIRE per-item
// decision happens inside the pipeline. This TU is the software
// analog: the pure-comparison subset of the registered-claims rules —
// iss equality, exp/nbf/iat windows with the verify leeway, nonce
// equality, aud membership + the multi-aud-contains-client_id rule,
// and the azp simple-equality arm — evaluated straight off the
// phase-1 tape (claims_tape.h, the SAME parser _capclaims uses), one
// GIL-free batched call per verify batch.
//
// Contract (mirrors registered_batch's conservative-fallback stance):
//
// - rule ORDER is exactly provider.py's (`_check_times` then
//   `_validate_id_claims`): exp-missing → expired → nbf → iss → alg →
//   nonce → iat → aud-non-string → aud-membership → multi-aud →
//   azp → (auth_time). The FIRST failing rule's status is returned,
//   so a native reject is always the same class Python would raise.
// - every parse corner falls back per token (VS_FALLBACK → the caller
//   re-validates with the Python rules): escaped top-level keys,
//   container/escaped/bigint-valued claims the rules read, bool-typed
//   time claims (Python's isinstance(True, (int, float)) is True —
//   not replicated here), and any payload outside the strict parser's
//   envelope. Rare-FLAG arms fall back too: the azp 3-rule interplay
//   (azp absent while the aud shape makes rules 2/3 reachable) and
//   any policy with max_age requested (auth_time stays Python).
// - status codes are a FIXED-ORDER registry (kNumStatus below); the
//   Python binding maps them by NAME onto cap_tpu/errors.py and the
//   cap_claims_layout handshake disables the engine on drift — a
//   stale .so can refuse, never misclassify.

#include "claims_tape.h"

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using capclaims::Parser;
using capclaims::TokenTape;
using namespace capclaims;  // Op/Status enums

// ---------------------------------------------------------------------------
// Status registry (ABI: append-only; mirrored by
// cap_tpu/oidc/claims_native.py STATUS_INDEX and handshaked via
// cap_claims_layout)
// ---------------------------------------------------------------------------

enum VStatus : uint8_t {
  VS_OK = 0,
  VS_FALLBACK = 1,            // Python rules decide this token
  VS_MISSING_EXP = 2,         // MissingClaimError
  VS_EXPIRED = 3,             // ExpiredTokenError
  VS_NOT_BEFORE = 4,          // InvalidNotBeforeError
  VS_WRONG_ISSUER = 5,        // InvalidIssuerError
  VS_UNSUPPORTED_ALG = 6,     // UnsupportedAlgError
  VS_WRONG_NONCE = 7,         // InvalidNonceError
  VS_FUTURE_IAT = 8,          // InvalidIssuedAtError
  VS_AUD_NON_STRING = 9,      // InvalidAudienceError
  VS_AUD_MISMATCH = 10,       // InvalidAudienceError
  VS_AUD_MISSING_CLIENT = 11, // InvalidAudienceError
  VS_AZP_MISMATCH = 12,       // InvalidAuthorizedPartyError
};

constexpr int32_t kLayoutVersion = 1;
constexpr int32_t kNumStatus = 13;

// ---------------------------------------------------------------------------
// Policy (compiled once per batch on the Python side; see
// claims_native.pack_policy). Little-endian blob:
//   u32 version(=1) | u32 flags | f64 leeway | u32 n_aud
//   u32 iss_len | u32 client_len | u32 nonce_len | u32 aud_len[n_aud]
//   bytes: issuer ‖ client_id ‖ nonce ‖ aud[0] ‖ aud[1] ...
// flags bit0: max_age requested (auth_time arm → whole-token fallback
//             AFTER the native rules pass).
// ---------------------------------------------------------------------------

struct Span {
  const uint8_t* p = nullptr;
  uint32_t len = 0;
};

struct Policy {
  Span issuer, client, nonce;
  std::vector<Span> audiences;
  double leeway = 0.0;
  bool max_age_requested = false;
};

inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

bool parse_policy(const uint8_t* blob, int64_t len, Policy* out) {
  if (len < 20) return false;
  const uint8_t* p = blob;
  uint32_t version = rd_u32(p);
  if (version != 1) return false;
  uint32_t flags = rd_u32(p + 4);
  double leeway;
  std::memcpy(&leeway, p + 8, 8);
  uint32_t n_aud = rd_u32(p + 16);
  if (n_aud > 4096) return false;
  int64_t hdr = 20 + 12 + 4 * static_cast<int64_t>(n_aud);
  if (len < hdr) return false;
  uint32_t iss_len = rd_u32(p + 20);
  uint32_t cli_len = rd_u32(p + 24);
  uint32_t non_len = rd_u32(p + 28);
  std::vector<uint32_t> aud_lens(n_aud);
  int64_t total = static_cast<int64_t>(iss_len) + cli_len + non_len;
  for (uint32_t k = 0; k < n_aud; ++k) {
    aud_lens[k] = rd_u32(p + 32 + 4 * k);
    total += aud_lens[k];
  }
  if (len != hdr + total) return false;
  const uint8_t* data = p + hdr;
  out->issuer = {data, iss_len};
  data += iss_len;
  out->client = {data, cli_len};
  data += cli_len;
  out->nonce = {data, non_len};
  data += non_len;
  out->audiences.clear();
  out->audiences.reserve(n_aud);
  for (uint32_t k = 0; k < n_aud; ++k) {
    out->audiences.push_back({data, aud_lens[k]});
    data += aud_lens[k];
  }
  out->leeway = leeway;
  out->max_age_requested = (flags & 1u) != 0;
  return true;
}

// ---------------------------------------------------------------------------
// Registered-claim collection off the tape (LAST occurrence wins, the
// json.loads duplicate-key rule; depth-1 only, exactly like
// claims_ext.cpp's build_registered walk)
// ---------------------------------------------------------------------------

enum CKind : uint8_t {
  K_ABSENT = 0,
  K_STR,       // unescaped string span
  K_ESC,       // escaped string (→ fallback when a rule reads it)
  K_NUM,       // int64/double as double
  K_BOOL,      // → fallback for time claims (isinstance quirk)
  K_NULL,
  K_BIGINT,    // > 18 digits (→ fallback when a rule reads it)
  K_ARR,       // flat-or-not array: tape op range recorded
  K_OBJ,       // object value (→ fallback when a rule reads it)
};

struct CVal {
  uint8_t kind = K_ABSENT;
  uint32_t off = 0, len = 0;    // K_STR span into the payload
  double num = 0.0;             // K_NUM / K_BOOL value
  size_t arr_start = 0, arr_end = 0;  // K_ARR tape op-index range
};

// Claim slots (index into CVal claims[8]).
enum CIdx { C_ISS = 0, C_AUD, C_EXP, C_NBF, C_IAT, C_NONCE, C_AZP,
            C_AUTH_TIME, C_COUNT };

struct RegName {
  const char* name;
  uint32_t len;
};
constexpr RegName kReg[C_COUNT] = {
    {"iss", 3},   {"aud", 3},   {"exp", 3},       {"nbf", 3},
    {"iat", 3},   {"nonce", 5}, {"azp", 3},       {"auth_time", 9},
};

// Walk one ST_OK tape into per-claim values; false → the token must
// fall back (escaped top-level key, or a corrupt tape).
bool collect(const TokenTape& tape, const uint8_t* payload,
             CVal claims[C_COUNT]) {
  const uint32_t* ops = tape.ops.data();
  size_t nops = tape.ops.size();
  int depth = 0;
  int reg = -1;

  auto skip_subtree = [&](size_t t, size_t* closing) -> bool {
    int d = 1;
    size_t u = t + 3;
    for (; u < nops && d > 0; u += 3) {
      if (ops[u] == OP_OBJ_START || ops[u] == OP_ARR_START) ++d;
      else if (ops[u] == OP_OBJ_END || ops[u] == OP_ARR_END) --d;
    }
    if (d != 0) return false;
    *closing = u - 3;
    return true;
  };

  for (size_t t = 0; t < nops; t += 3) {
    uint32_t op = ops[t], a = ops[t + 1], b = ops[t + 2];
    switch (op) {
      case OP_OBJ_START: {
        if (reg >= 0 && depth == 1) {
          claims[reg] = CVal{};
          claims[reg].kind = K_OBJ;
          reg = -1;
          size_t closing;
          if (!skip_subtree(t, &closing)) return false;
          t = closing;
          break;
        }
        ++depth;
        break;
      }
      case OP_ARR_START: {
        if (reg >= 0 && depth == 1) {
          claims[reg] = CVal{};
          claims[reg].kind = K_ARR;
          claims[reg].arr_start = t + 3;
          size_t closing;
          if (!skip_subtree(t, &closing)) return false;
          claims[reg].arr_end = closing;
          reg = -1;
          t = closing;
          break;
        }
        ++depth;
        break;
      }
      case OP_OBJ_END:
      case OP_ARR_END:
        --depth;
        reg = -1;
        break;
      case OP_KEY: {
        if (depth != 1) {
          break;
        }
        uint32_t len = b >> 1, esc = b & 1;
        if (esc) return false;  // escaped key could spell a registered name
        reg = -1;
        for (int r = 0; r < C_COUNT; ++r) {
          if (kReg[r].len == len &&
              std::memcmp(payload + a, kReg[r].name, len) == 0) {
            reg = r;
            break;
          }
        }
        break;
      }
      default: {
        if (reg >= 0 && depth == 1) {
          CVal v;
          switch (op) {
            case OP_STR: {
              uint32_t len = b >> 1, esc = b & 1;
              v.kind = esc ? K_ESC : K_STR;
              v.off = a;
              v.len = len;
              break;
            }
            case OP_INT: {
              v.kind = K_NUM;
              v.num = static_cast<double>(static_cast<int64_t>(
                  (static_cast<uint64_t>(b) << 32) | a));
              break;
            }
            case OP_FLOAT: {
              uint64_t bits = (static_cast<uint64_t>(b) << 32) | a;
              double d;
              std::memcpy(&d, &bits, 8);
              v.kind = K_NUM;
              v.num = d;
              break;
            }
            case OP_BIGINT:
              v.kind = K_BIGINT;
              break;
            case OP_TRUE:
              v.kind = K_BOOL;
              v.num = 1.0;
              break;
            case OP_FALSE:
              v.kind = K_BOOL;
              v.num = 0.0;
              break;
            case OP_NULL:
              v.kind = K_NULL;
              break;
            default:
              return false;  // unknown future op: refuse loudly
          }
          claims[reg] = v;
        }
        reg = -1;  // scalar consumed the pending key either way
        break;
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Rule evaluation (one token)
// ---------------------------------------------------------------------------

inline bool span_eq(const uint8_t* payload, const CVal& v, Span s) {
  return v.len == s.len &&
         (v.len == 0 || std::memcmp(payload + v.off, s.p, v.len) == 0);
}

// A parse corner on a claim a rule is about to READ → fallback.
inline bool corner(const CVal& v) {
  return v.kind == K_ESC || v.kind == K_BIGINT || v.kind == K_OBJ;
}

uint8_t evaluate_with_now(const TokenTape& tape, const uint8_t* payload,
                          const Policy& pol, double now, bool alg_ok) {
  if (tape.status != ST_OK) return VS_FALLBACK;
  CVal claims[C_COUNT];
  if (!collect(tape, payload, claims)) return VS_FALLBACK;

  const uint32_t* ops = tape.ops.data();

  // -- _check_times -------------------------------------------------------
  const CVal& exp = claims[C_EXP];
  if (corner(exp) || exp.kind == K_BOOL || exp.kind == K_ARR)
    return VS_FALLBACK;
  if (exp.kind != K_NUM) return VS_MISSING_EXP;
  if (now > exp.num) return VS_EXPIRED;

  const CVal& nbf = claims[C_NBF];
  if (corner(nbf) || nbf.kind == K_BOOL || nbf.kind == K_ARR)
    return VS_FALLBACK;
  if (nbf.kind == K_NUM && now + pol.leeway < nbf.num)
    return VS_NOT_BEFORE;

  // -- _validate_id_claims, in source order -------------------------------
  const CVal& iss = claims[C_ISS];
  if (corner(iss) || iss.kind == K_ARR) return VS_FALLBACK;
  if (!(iss.kind == K_STR && span_eq(payload, iss, pol.issuer)))
    return VS_WRONG_ISSUER;

  if (!alg_ok) return VS_UNSUPPORTED_ALG;

  const CVal& nonce = claims[C_NONCE];
  if (corner(nonce) || nonce.kind == K_ARR) return VS_FALLBACK;
  if (!(nonce.kind == K_STR && span_eq(payload, nonce, pol.nonce)))
    return VS_WRONG_NONCE;

  const CVal& iat = claims[C_IAT];
  if (corner(iat) || iat.kind == K_BOOL || iat.kind == K_ARR)
    return VS_FALLBACK;
  if (iat.kind == K_NUM && now + pol.leeway < iat.num)
    return VS_FUTURE_IAT;

  // aud → aud_list (string → [s]; array → elements; else empty).
  const CVal& aud = claims[C_AUD];
  if (aud.kind == K_ESC || aud.kind == K_OBJ || aud.kind == K_BIGINT)
    return VS_FALLBACK;
  // Element spans for the list form, with the go-jose-parity
  // non-string rule: a non-string SCALAR element rejects; a container
  // or escaped element falls back (Python decides; it rejects too,
  // with the exact message).
  Span single;
  std::vector<Span> aud_list;
  size_t aud_count = 0;
  const Span* auds = nullptr;
  if (aud.kind == K_STR) {
    single = {payload + aud.off, aud.len};
    auds = &single;
    aud_count = 1;
  } else if (aud.kind == K_ARR) {
    for (size_t u = aud.arr_start; u < aud.arr_end; u += 3) {
      uint32_t op = ops[u], a = ops[u + 1], b = ops[u + 2];
      if (op == OP_OBJ_START || op == OP_ARR_START)
        return VS_FALLBACK;  // nested container (build_registered parity)
      if (op != OP_STR) return VS_AUD_NON_STRING;
      if (b & 1) return VS_FALLBACK;  // escaped element: Python decides
      aud_list.push_back({payload + a, b >> 1});
    }
    auds = aud_list.data();
    aud_count = aud_list.size();
  }
  // (other scalar kinds — K_NUM/K_BOOL/K_NULL/K_ABSENT — yield the
  // empty aud_list, exactly like the Python shape normalization)

  auto contains = [&](Span needle) -> bool {
    for (size_t k = 0; k < aud_count; ++k) {
      if (auds[k].len == needle.len &&
          (needle.len == 0 ||
           std::memcmp(auds[k].p, needle.p, needle.len) == 0))
        return true;
    }
    return false;
  };

  if (!pol.audiences.empty()) {
    bool matched = false;
    for (const Span& want : pol.audiences) {
      if (contains(want)) {
        matched = true;
        break;
      }
    }
    if (!matched) return VS_AUD_MISMATCH;
  }
  bool has_client = contains(pol.client);
  if (aud_count > 1 && !has_client) return VS_AUD_MISSING_CLIENT;

  // azp: the simple-equality arm is native; the 3-rule interplay
  // (azp None while rules 2/3 are reachable) is the rare-flag Python
  // fallback — provider.py raises the exact interplay error there.
  const CVal& azp = claims[C_AZP];
  if (corner(azp) || azp.kind == K_ARR) return VS_FALLBACK;
  if (azp.kind != K_ABSENT && azp.kind != K_NULL) {
    // present: equal → all three azp rules pass; unequal (or a
    // non-string scalar, which can never equal a str) → rule 1.
    if (!(azp.kind == K_STR && span_eq(payload, azp, pol.client)))
      return VS_AZP_MISMATCH;
  } else {
    // absent/null: rule 2 fires iff multi-aud; rule 3 iff the single
    // audience is not the client — both Python's call.
    if (aud_count > 1) return VS_FALLBACK;
    if (aud_count == 1 && !has_client) return VS_FALLBACK;
  }

  // auth_time/max_age: rare-flag arm stays Python. Ordering holds:
  // it is the LAST rule, so only fully-passing tokens reach it.
  if (pol.max_age_requested) return VS_FALLBACK;
  return VS_OK;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Layout handshake: the binding refuses to enable the engine unless
// version and status-registry length match its own STATUS_INDEX (the
// REASON_INDEX pattern from the r13 telemetry plane).
void cap_claims_layout(int32_t* out) {
  out[0] = kLayoutVersion;
  out[1] = kNumStatus;
}

// Batched rule evaluation. scratch/offs/lens describe payload spans
// (the signed claims JSON of signature-ACCEPTED tokens); alg_ok[i] is
// the Python-side allowed-alg verdict from the header-segment cache;
// now/policy are captured once per batch. Writes one status byte per
// token into out_status. Returns 0, or nonzero when the policy blob
// or spans are unusable (caller falls back whole-batch).
int32_t cap_claims_validate_batch(
    const uint8_t* scratch, int64_t scratch_len, const int64_t* offs,
    const int64_t* lens, int64_t n, const uint8_t* policy_blob,
    int64_t policy_len, const uint8_t* alg_ok, double now,
    uint8_t* out_status, int32_t n_threads) {
  Policy pol;
  if (!parse_policy(policy_blob, policy_len, &pol)) return 1;
  for (int64_t i = 0; i < n; ++i) {
    if (offs[i] < 0 || lens[i] < 0 || offs[i] + lens[i] > scratch_len)
      return 2;
  }

  auto one = [&](int64_t i) {
    TokenTape tape;
    Parser p(scratch + offs[i], static_cast<size_t>(lens[i]), &tape);
    p.run();
    out_status[i] = evaluate_with_now(tape, scratch + offs[i], pol, now,
                                      alg_ok[i] != 0);
  };

  unsigned hw = std::thread::hardware_concurrency();
  size_t workers = n_threads > 0 ? static_cast<size_t>(n_threads)
                                 : (hw ? hw : 4);
  if (workers > static_cast<size_t>(n) && n > 0)
    workers = static_cast<size_t>(n);
  if (workers <= 1 || n < 256) {
    for (int64_t i = 0; i < n; ++i) one(i);
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
          for (size_t i = lo; i < hi; ++i) one(static_cast<int64_t>(i));
        }
      });
    }
    for (auto& t : pool) t.join();
  }
  return 0;
}

}  // extern "C"
