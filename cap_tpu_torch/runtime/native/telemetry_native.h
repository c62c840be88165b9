// telemetry_native — the native telemetry plane's internal interface,
// shared between telemetry_native.cpp (the plane itself) and
// serve_native.cpp (the serve chain that feeds it).
//
// The plane mirrors cap_tpu.obs.decision's registered vocabularies by
// INDEX: reason classes, families, and latency buckets are fixed-order
// tuples on the Python side (REASON_INDEX / FAMILIES /
// LAT_BUCKET_INDEX) and plain enums here; cap_tel_layout() lets the
// binding verify both sides agree before enabling the plane, so a
// stale .so degrades to the Python fold instead of miscounting.

#ifndef CAP_TPU_TELEMETRY_NATIVE_H
#define CAP_TPU_TELEMETRY_NATIVE_H

#include <cstdint>

namespace cap_tel {

// obs/decision.py REASON_INDEX order (12 registered reason classes;
// r20 inserted "throttled" — admission pushback — before "internal",
// which stays LAST: the fold uses the final index as its
// out-of-range bucket).
enum {
  N_REASON = 12,
  // obs/decision.py FAMILIES order; index 10 is "unknown" (r17 added
  // slhdsa128s/slhdsa128f before "other" — layout handshake bumped).
  N_FAM = 11,
  FAM_UNKNOWN = 10,
  // obs/decision.py LAT_BUCKET_INDEX order; index 5 is "na".
  N_LAT = 6,
  LAT_NA = 5,
  // counter block layout: accept, reject[11], family[9], then the
  // plane's own native counters (header-cache hits/misses, exemplar
  // ring drops).
  CTR_ACCEPT = 0,
  CTR_REJECT0 = 1,
  CTR_FAM0 = CTR_REJECT0 + N_REASON,
  CTR_CACHE_HITS = CTR_FAM0 + N_FAM,
  CTR_CACHE_MISSES = CTR_CACHE_HITS + 1,
  CTR_EX_DROPS = CTR_CACHE_MISSES + 1,
  N_CTR = CTR_EX_DROPS + 1,
  // native histogram series (telemetry.py bucket layout, bounds
  // passed in at create time so the edges are bit-identical).
  SERIES_REQUEST_S = 0,
  SERIES_CHUNK_TOKENS = 1,
  N_SERIES = 2,
  // obs/decision.py RING_SAMPLE_EVERY.
  SAMPLE_EVERY = 16,
  // bounded exemplar ring (matches telemetry.MAX_DECISION_ENTRIES).
  EX_RING = 256,
  // fixed exemplar record stride handed across the ctypes boundary:
  // key(1) fam(1) lat(1) kid_len(1) kid(12) trace_len(1) trace(64),
  // padded to 88.
  EX_STRIDE = 88,
  KID_LEN = 12,
  MAX_SEG_BYTES = 1024,  // decision._seg_family_kid's parse bound
  CACHE_CAP = 4096,      // decision._HDR_CACHE_CAP (clear at cap)
  // tenant attribution (r19): obs/decision.py's bounded tenant table
  // — TENANT_CAP real slots + "none" + "other". Like families, the
  // native side never derives a tenant itself: slots arrive from the
  // Python classifier through learn(), counters are per SLOT here and
  // mapped back to labels (issuer hashes) by the binding at scrape.
  TEN_SLOTS = 64,        // decision.TENANT_CAP
  TEN_NONE = 64,         // decision.TENANT_NONE_IDX
  TEN_OTHER = 65,        // decision.TENANT_OTHER_IDX
  N_TEN = 66,            // decision.N_TENANT
  // per-slot tenant counter stride: tokens, accept, reject_total,
  // reject[N_REASON] — then the whole block is prefixed by three
  // globals (lookups, attributed, overflow) so the exact equation
  // lookups == attributed + overflow folds natively too.
  TEN_STRIDE = 3 + N_REASON,
  TCTR_LOOKUPS = 0,
  TCTR_ATTRIBUTED = 1,
  TCTR_OVERFLOW = 2,
  TCTR_BASE = 3,
  N_TCTR = TCTR_BASE + N_TEN * TEN_STRIDE,
};

struct TelPlane;

TelPlane* create(const double* bounds, int32_t n_bounds);
void destroy(TelPlane* t);

// Classify one header SEGMENT against the native cache. Returns the
// family index on a hit (kid copied into kid_out, kid_len_out set,
// tenant slot into ten_out), -1 on a miss — the caller (Python, on
// the drain path) resolves the miss with obs/decision._seg_fkt and
// learn()s it back, which is what makes family AND tenant
// classification structurally bit-exact: the cache only ever holds
// values the Python classifier produced.
int32_t classify(TelPlane* t, const uint8_t* seg, int64_t len,
                 uint8_t* kid_out, int32_t* kid_len_out,
                 int16_t* ten_out);
void learn(TelPlane* t, const uint8_t* seg, int64_t len, int32_t fam,
           const uint8_t* kid, int32_t kid_len, int32_t ten);

// Fold one chunk of verdicts: the exact obs/decision.record_batch
// aggregation (one counter add per present key, sampling positions
// c == 1 or c % 16 == 0 over the post-increment sequence, exemplars
// attributed to the same token the Python fold would sample).
// tens: per-token tenant slot (nullptr / out-of-range → TEN_NONE);
// lat_s: the chunk latency in seconds (< 0 → no per-tenant latency
// observation, mirroring record_batch's latency_s=None).
void fold(TelPlane* t, int64_t n_tokens, const uint8_t* statuses,
          const uint8_t* reasons, const int8_t* fams,
          const int16_t* tens, const uint8_t* kids, int32_t lat_idx,
          double lat_s, const uint8_t* trace, int32_t trace_len);

void observe(TelPlane* t, int32_t series, double value);

}  // namespace cap_tel

#endif  // CAP_TPU_TELEMETRY_NATIVE_H
