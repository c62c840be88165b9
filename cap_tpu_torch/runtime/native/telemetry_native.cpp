// telemetry_native — wire-speed observability: the native telemetry
// plane of the GIL-free serve chain (ISSUE 8 / ROADMAP "native-side
// family counting" lever).
//
// Round 12 measured that with the serve hot path in C++, the Python
// decision/telemetry fold (obs/decision.record_batch) had become the
// dominant per-token serve cost on BOTH chains (~2 of ~2.65 us/token
// full-obs). This TU moves that fold into plain C structs the GIL
// never touches:
//
//   - per-token FAMILY classification happens in the per-connection
//     reader threads at frame-parse time, against a bounded native
//     header-segment cache. The cache is populated exclusively by
//     Python's own classifier (obs/decision._seg_family_kid) on a
//     miss — the native side never parses base64/JSON itself, so
//     family attribution is bit-exact by construction, not by a
//     reimplementation that could drift;
//   - accept / reject-by-reason / per-family COUNTERS fold at
//     response-encode time (cap_serve_post_results_tel) with ONE
//     atomic add per present key per chunk — the same per-batch (not
//     per-item) accounting the Dilithium GPU work (arXiv 2211.12265)
//     uses to keep batched verify at device rate — and the decision
//     ring's sampling positions (first-of-key + every 16th, derived
//     from the post-increment counter value exactly like
//     obs/decision.record_batch's bulk()) are computed here and
//     queued as EXEMPLARS in a bounded ring Python drains on the
//     drain call it already makes;
//   - HISTOGRAMS use the exact bucket edges telemetry.py computes
//     (passed in at create time; std::lower_bound == bisect_left), so
//     bucket counts merge exactly under telemetry.merge_snapshots and
//     fleet quantiles stay exact.
//
// The parity contract — counters, histogram bucket counts, and ring
// sample positions bit-identical to the Python fold — is pinned by
// tests/test_native_obs.py's fuzz sweep.

#include <algorithm>
#include <atomic>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "telemetry_native.h"

namespace cap_tel {

// ---------------------------------------------------------------------------
// header-segment cache: open-addressing, bounded, cleared at cap
// (the same stance as obs/decision._HDR_CACHE). Stores ONLY what the
// Python classifier computed: family index + hashed kid. Segment text
// lives in memory only, like the Python cache — never recorded.
// ---------------------------------------------------------------------------

struct CacheEnt {
  std::string seg;
  int8_t fam = 0;
  uint8_t kid_len = 0;
  int16_t ten = TEN_NONE;
  char kid[KID_LEN];
  bool used = false;
};

static inline uint64_t fnv1a(const uint8_t* p, int64_t n) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

// ---------------------------------------------------------------------------
// histograms: telemetry.Histogram's exact state (bucket counts via
// bisect_left over the SAME bounds + count/sum/min/max), guarded by a
// small per-series mutex — adds are per request / per chunk, never
// per token, so the lock is nowhere near the hot path.
// ---------------------------------------------------------------------------

struct Hist {
  std::mutex mu;
  std::vector<int64_t> counts;  // n_bounds + 1 (overflow)
  int64_t count = 0;
  double sum = 0.0;
  double vmin = 0.0;
  double vmax = 0.0;
};

struct Exemplar {
  uint8_t rec[EX_STRIDE];
};

struct TelPlane {
  std::vector<double> bounds;
  Hist series[N_SERIES];
  // counter block: single atomics, ONE fetch_add per key per chunk.
  // The post-increment value drives the sampling math, which is why
  // these are global rather than per-shard — the per-key sequence
  // must match the Python fold's count_many return values exactly.
  std::atomic<int64_t> ctr[N_CTR];
  // tenant attribution (r19): 3 globals + per-slot blocks (see
  // telemetry_native.h TEN_* layout) and one latency histogram per
  // slot — the binding maps slots back to issuer-hash labels.
  std::atomic<int64_t> tctr[N_TCTR];
  Hist ten_hist[N_TEN];
  // exemplar ring (FIFO, overwrites oldest — deque(maxlen) semantics)
  std::mutex ex_mu;
  Exemplar ex_ring[EX_RING];
  int64_t ex_head = 0;  // next write slot
  int64_t ex_len = 0;
  // header cache
  std::mutex cache_mu;
  std::vector<CacheEnt> slots;
  int64_t cache_used = 0;

  TelPlane() : slots(2 * CACHE_CAP) {
    for (auto& c : ctr) c.store(0);
    for (auto& c : tctr) c.store(0);
  }
};

TelPlane* create(const double* bounds, int32_t n_bounds) {
  if (!bounds || n_bounds <= 0) return nullptr;
  TelPlane* t = new TelPlane();
  t->bounds.assign(bounds, bounds + n_bounds);
  for (auto& h : t->series) h.counts.assign((size_t)n_bounds + 1, 0);
  for (auto& h : t->ten_hist) h.counts.assign((size_t)n_bounds + 1, 0);
  return t;
}

void destroy(TelPlane* t) { delete t; }

// -- cache ------------------------------------------------------------------

static CacheEnt* find_slot(TelPlane* t, const uint8_t* seg, int64_t len,
                           bool* found) {
  size_t mask = t->slots.size() - 1;
  size_t i = (size_t)fnv1a(seg, len) & mask;
  for (;;) {
    CacheEnt& e = t->slots[i];
    if (!e.used) {
      *found = false;
      return &e;
    }
    if ((int64_t)e.seg.size() == len &&
        std::memcmp(e.seg.data(), seg, (size_t)len) == 0) {
      *found = true;
      return &e;
    }
    i = (i + 1) & mask;
  }
}

int32_t classify(TelPlane* t, const uint8_t* seg, int64_t len,
                 uint8_t* kid_out, int32_t* kid_len_out,
                 int16_t* ten_out) {
  if (kid_len_out) *kid_len_out = 0;
  if (ten_out) *ten_out = TEN_NONE;
  // decision._seg_family_kid: empty or over-long segments are
  // "unknown" without touching the cache (bytes > chars never makes
  // a segment parseable: non-ASCII is invalid base64url anyway).
  // Tenant follows the same bound: "none" without a payload parse,
  // exactly like decision._seg_fkt.
  if (len <= 0 || len > MAX_SEG_BYTES) return FAM_UNKNOWN;
  std::lock_guard<std::mutex> lk(t->cache_mu);
  bool found;
  CacheEnt* e = find_slot(t, seg, len, &found);
  if (!found) {
    t->ctr[CTR_CACHE_MISSES].fetch_add(1, std::memory_order_relaxed);
    return -1;
  }
  t->ctr[CTR_CACHE_HITS].fetch_add(1, std::memory_order_relaxed);
  if (e->kid_len && kid_out) {
    std::memcpy(kid_out, e->kid, e->kid_len);
    if (kid_len_out) *kid_len_out = e->kid_len;
  }
  if (ten_out) *ten_out = e->ten;
  return e->fam;
}

void learn(TelPlane* t, const uint8_t* seg, int64_t len, int32_t fam,
           const uint8_t* kid, int32_t kid_len, int32_t ten) {
  if (len <= 0 || len > MAX_SEG_BYTES) return;
  if (fam < 0 || fam >= N_FAM) fam = FAM_UNKNOWN;
  if (kid_len != KID_LEN || !kid) kid_len = 0;
  if (ten < 0 || ten >= N_TEN) ten = TEN_NONE;
  std::lock_guard<std::mutex> lk(t->cache_mu);
  if (t->cache_used >= CACHE_CAP) {  // clear at cap, like _HDR_CACHE
    for (auto& e : t->slots) {
      e.used = false;
      e.seg.clear();
    }
    t->cache_used = 0;
  }
  bool found;
  CacheEnt* e = find_slot(t, seg, len, &found);
  if (!found) {
    e->seg.assign((const char*)seg, (size_t)len);
    e->used = true;
    t->cache_used++;
  }
  e->fam = (int8_t)fam;
  e->kid_len = (uint8_t)kid_len;
  e->ten = (int16_t)ten;
  if (kid_len) std::memcpy(e->kid, kid, (size_t)kid_len);
}

// -- histograms -------------------------------------------------------------

void observe(TelPlane* t, int32_t series, double value) {
  if (series < 0 || series >= N_SERIES) return;
  Hist& h = t->series[series];
  // bisect_left: first index whose bound is >= value (lower_bound's
  // contract is identical, which the parity test pins over fuzz).
  size_t idx = (size_t)(std::lower_bound(t->bounds.begin(),
                                         t->bounds.end(), value) -
                        t->bounds.begin());
  std::lock_guard<std::mutex> lk(h.mu);
  h.counts[idx]++;
  if (h.count == 0) {
    h.vmin = value;
    h.vmax = value;
  } else {
    if (value < h.vmin) h.vmin = value;
    if (value > h.vmax) h.vmax = value;
  }
  h.count++;
  h.sum += value;
}

// telemetry.Histogram.add_many: k observations of one value in one
// bucket add, sum += value * k — the per-(chunk, tenant) latency
// fold. The arithmetic ORDER matches the Python side exactly, so
// merged states stay bit-identical.
static void hist_add_many(TelPlane* t, Hist& h, double value,
                          int64_t k) {
  if (k <= 0) return;
  size_t idx = (size_t)(std::lower_bound(t->bounds.begin(),
                                         t->bounds.end(), value) -
                        t->bounds.begin());
  std::lock_guard<std::mutex> lk(h.mu);
  h.counts[idx] += k;
  if (h.count == 0) {
    h.vmin = value;
    h.vmax = value;
  } else {
    if (value < h.vmin) h.vmin = value;
    if (value > h.vmax) h.vmax = value;
  }
  h.count += k;
  // volatile: forbid the compiler from contracting the multiply-add
  // into one FMA (-O3 -march=native does) — Python rounds the product
  // BEFORE the add, and the parity pin is bit-exact sums
  volatile double add = value * (double)k;
  h.sum += add;
}

// -- the fold ---------------------------------------------------------------

static void build_exemplar(Exemplar& ex, int32_t key, int8_t fam,
                           int32_t lat_idx, const uint8_t* kid12,
                           const uint8_t* trace, int32_t trace_len) {
  uint8_t* r = ex.rec;
  std::memset(r, 0, EX_STRIDE);
  r[0] = (uint8_t)key;
  r[1] = (uint8_t)fam;
  r[2] = (uint8_t)lat_idx;
  bool has_kid = false;
  for (int i = 0; i < KID_LEN; i++)
    if (kid12[i]) has_kid = true;
  if (has_kid) {
    r[3] = KID_LEN;
    std::memcpy(r + 4, kid12, KID_LEN);
  }
  if (trace && trace_len > 0 && trace_len <= 64) {
    r[16] = (uint8_t)trace_len;
    std::memcpy(r + 17, trace, (size_t)trace_len);
  }
}

void fold(TelPlane* t, int64_t n_tokens, const uint8_t* statuses,
          const uint8_t* reasons, const int8_t* fams,
          const int16_t* tens, const uint8_t* kids, int32_t lat_idx,
          double lat_s, const uint8_t* trace, int32_t trace_len) {
  if (n_tokens <= 0) return;  // record_batch: empty chunk is a no-op
  if (lat_idx < 0 || lat_idx >= N_LAT) lat_idx = LAT_NA;
  // one pass: group token indices by decision key, count families
  // and tenants — the same grouping record_batch builds before its
  // count_many call. Tenant counts accumulate on the stack (~7 KB)
  // and apply as ONE atomic add per touched key per chunk.
  std::vector<int32_t> accept_idx;
  std::vector<int32_t> rej_idx[N_REASON];
  int reason_order[N_REASON];
  int n_reasons = 0;
  bool seen[N_REASON] = {};
  int64_t fam_counts[N_FAM] = {};
  int64_t tloc[N_TEN * TEN_STRIDE];
  std::memset(tloc, 0, sizeof(tloc));
  for (int64_t i = 0; i < n_tokens; i++) {
    int f = fams ? fams[i] : FAM_UNKNOWN;
    if (f < 0 || f >= N_FAM) f = FAM_UNKNOWN;
    fam_counts[f]++;
    int ten = tens ? tens[i] : TEN_NONE;
    if (ten < 0 || ten >= N_TEN) ten = TEN_NONE;
    int64_t* tb = tloc + ten * TEN_STRIDE;
    tb[0]++;  // tokens
    if (!statuses || statuses[i] == 0) {
      accept_idx.push_back((int32_t)i);
      tb[1]++;  // accept
    } else {
      int r = reasons ? reasons[i] : (N_REASON - 1);  // internal
      if (r < 0 || r >= N_REASON) r = N_REASON - 1;
      if (!seen[r]) {
        seen[r] = true;
        reason_order[n_reasons++] = r;  // first-occurrence order
      }
      rej_idx[r].push_back((int32_t)i);
      tb[2]++;        // reject total
      tb[3 + r]++;    // reject by reason
    }
  }
  for (int f = 0; f < N_FAM; f++)
    if (fam_counts[f])
      t->ctr[CTR_FAM0 + f].fetch_add(fam_counts[f],
                                     std::memory_order_relaxed);
  // tenant counters + the exact lookups == attributed + overflow
  // equation (record_batch emits the same three globals)
  int64_t ovf = tloc[TEN_OTHER * TEN_STRIDE + 0];
  t->tctr[TCTR_LOOKUPS].fetch_add(n_tokens, std::memory_order_relaxed);
  if (n_tokens - ovf)
    t->tctr[TCTR_ATTRIBUTED].fetch_add(n_tokens - ovf,
                                       std::memory_order_relaxed);
  if (ovf)
    t->tctr[TCTR_OVERFLOW].fetch_add(ovf, std::memory_order_relaxed);
  for (int s = 0; s < N_TEN; s++) {
    int64_t* tb = tloc + s * TEN_STRIDE;
    if (!tb[0]) continue;
    for (int j = 0; j < TEN_STRIDE; j++)
      if (tb[j])
        t->tctr[TCTR_BASE + s * TEN_STRIDE + j].fetch_add(
            tb[j], std::memory_order_relaxed);
    // per-tenant latency histogram: every token of the chunk
    // observes the chunk latency, as one bucket add of k
    // (record_batch's serve-surface observe_many)
    if (lat_s >= 0.0)
      hist_add_many(t, t->ten_hist[s], lat_s, tb[0]);
  }
  std::vector<Exemplar> exs;
  static const uint8_t no_kid[KID_LEN] = {};
  auto emit = [&](int key, std::atomic<int64_t>& c,
                  const std::vector<int32_t>& idxs) {
    int64_t k = (int64_t)idxs.size();
    if (!k) return;
    int64_t after = c.fetch_add(k, std::memory_order_relaxed) + k;
    int64_t start = after - k;
    // record_batch.bulk(): sampled counts are 1 (first ever) plus
    // every SAMPLE_EVERY-th, attributed to idxs[c - start - 1].
    auto sample = [&](int64_t cval) {
      int32_t i = idxs[(size_t)(cval - start - 1)];
      int f = fams ? fams[i] : FAM_UNKNOWN;
      if (f < 0 || f >= N_FAM) f = FAM_UNKNOWN;
      exs.emplace_back();
      build_exemplar(exs.back(), key, (int8_t)f, lat_idx,
                     kids ? kids + (size_t)i * KID_LEN : no_kid, trace,
                     trace_len);
    };
    if (start == 0) sample(1);
    for (int64_t m = (start / SAMPLE_EVERY + 1) * SAMPLE_EVERY;
         m <= after; m += SAMPLE_EVERY)
      sample(m);
  };
  emit(0, t->ctr[CTR_ACCEPT], accept_idx);  // accepts first, like bulk
  for (int j = 0; j < n_reasons; j++) {
    int r = reason_order[j];
    emit(1 + r, t->ctr[CTR_REJECT0 + r], rej_idx[r]);
  }
  if (!exs.empty()) {
    std::lock_guard<std::mutex> lk(t->ex_mu);
    for (auto& ex : exs) {
      if (t->ex_len == EX_RING)
        t->ctr[CTR_EX_DROPS].fetch_add(1, std::memory_order_relaxed);
      else
        t->ex_len++;
      t->ex_ring[t->ex_head % EX_RING] = ex;
      t->ex_head++;
    }
  }
}

}  // namespace cap_tel

// ---------------------------------------------------------------------------
// C ABI (ctypes binding in serve/native_serve.py; also driven
// standalone by the fuzz parity sweep in tests/test_native_obs.py)
// ---------------------------------------------------------------------------

using namespace cap_tel;

extern "C" {

// Layout handshake: the binding checks these against the Python-side
// registries before enabling the plane (index-vocabulary drift in a
// stale .so must disable the plane, never miscount).
void cap_tel_layout(int32_t* out) {
  out[0] = N_REASON;
  out[1] = N_FAM;
  out[2] = N_LAT;
  out[3] = N_CTR;
  out[4] = EX_STRIDE;
  out[5] = N_SERIES;
  out[6] = SAMPLE_EVERY;
  out[7] = EX_RING;
}

// Tenant-block handshake (r19, a separate symbol so its ABSENCE in a
// stale .so disables the plane cleanly — the binding requires it):
// slot count, per-slot stride, total tenant-counter block, overflow
// slot index. Any drift from obs/decision's registries → plane off.
void cap_tel_layout_ten(int32_t* out) {
  out[0] = N_TEN;
  out[1] = TEN_STRIDE;
  out[2] = N_TCTR;
  out[3] = TEN_OTHER;
}

void* cap_tel_create(const double* bounds, int32_t n_bounds) {
  return create(bounds, n_bounds);
}

void cap_tel_destroy(void* t) { destroy((TelPlane*)t); }

int32_t cap_tel_classify_seg(void* t, const uint8_t* seg, int64_t len,
                             uint8_t* kid_out, int32_t* kid_len_out,
                             int16_t* ten_out) {
  return classify((TelPlane*)t, seg, len, kid_out, kid_len_out,
                  ten_out);
}

void cap_tel_learn(void* t, const uint8_t* seg, int64_t len,
                   int32_t fam, const uint8_t* kid, int32_t kid_len,
                   int32_t ten) {
  learn((TelPlane*)t, seg, len, fam, kid, kid_len, ten);
}

void cap_tel_fold(void* t, int64_t n_tokens, const uint8_t* statuses,
                  const uint8_t* reasons, const int8_t* fams,
                  const int16_t* tens, const uint8_t* kids,
                  int32_t lat_idx, double lat_s, const uint8_t* trace,
                  int32_t trace_len) {
  fold((TelPlane*)t, n_tokens, statuses, reasons, fams, tens, kids,
       lat_idx, lat_s, trace, trace_len);
}

void cap_tel_hist_observe(void* t, int32_t series, double value) {
  observe((TelPlane*)t, series, value);
}

void cap_tel_counters(void* t, int64_t* out) {
  TelPlane* p = (TelPlane*)t;
  for (int i = 0; i < N_CTR; i++)
    out[i] = p->ctr[i].load(std::memory_order_relaxed);
}

// The whole tenant counter block (N_TCTR slots, telemetry_native.h
// layout); the binding maps nonzero slots back to labels.
void cap_tel_tenant_counters(void* t, int64_t* out) {
  TelPlane* p = (TelPlane*)t;
  for (int i = 0; i < N_TCTR; i++)
    out[i] = p->tctr[i].load(std::memory_order_relaxed);
}

// One tenant slot's latency-histogram state (same shape as
// cap_tel_hist_state).
void cap_tel_tenant_hist_state(void* t, int32_t slot,
                               int64_t* bucket_out, int64_t* count_out,
                               double* sum_out, double* min_out,
                               double* max_out) {
  TelPlane* p = (TelPlane*)t;
  if (slot < 0 || slot >= N_TEN) return;
  Hist& h = p->ten_hist[slot];
  std::lock_guard<std::mutex> lk(h.mu);
  std::memcpy(bucket_out, h.counts.data(),
              h.counts.size() * sizeof(int64_t));
  *count_out = h.count;
  *sum_out = h.sum;
  *min_out = h.vmin;
  *max_out = h.vmax;
}

// Histogram state for one series: bucket counts (n_bounds + 1 slots)
// + count/sum/min/max — telemetry.Histogram.state()'s fields, so the
// binding can emit a mergeable snapshot entry.
void cap_tel_hist_state(void* t, int32_t series, int64_t* bucket_out,
                        int64_t* count_out, double* sum_out,
                        double* min_out, double* max_out) {
  TelPlane* p = (TelPlane*)t;
  if (series < 0 || series >= N_SERIES) return;
  Hist& h = p->series[series];
  std::lock_guard<std::mutex> lk(h.mu);
  std::memcpy(bucket_out, h.counts.data(),
              h.counts.size() * sizeof(int64_t));
  *count_out = h.count;
  *sum_out = h.sum;
  *min_out = h.vmin;
  *max_out = h.vmax;
}

// Drain queued exemplars (FIFO, oldest first) into out (EX_STRIDE
// bytes per record); returns how many were written.
int32_t cap_tel_drain_exemplars(void* t, uint8_t* out, int32_t max_n) {
  TelPlane* p = (TelPlane*)t;
  std::lock_guard<std::mutex> lk(p->ex_mu);
  int32_t n = 0;
  while (p->ex_len > 0 && n < max_n) {
    int64_t slot = (p->ex_head - p->ex_len) % EX_RING;
    std::memcpy(out + (size_t)n * EX_STRIDE, p->ex_ring[slot].rec,
                EX_STRIDE);
    p->ex_len--;
    n++;
  }
  return n;
}

void cap_tel_reset(void* t) {
  TelPlane* p = (TelPlane*)t;
  for (auto& c : p->ctr) c.store(0);
  for (auto& c : p->tctr) c.store(0);
  {
    std::lock_guard<std::mutex> lk(p->ex_mu);
    p->ex_head = 0;
    p->ex_len = 0;
  }
  for (auto& h : p->series) {
    std::lock_guard<std::mutex> lk(h.mu);
    std::fill(h.counts.begin(), h.counts.end(), 0);
    h.count = 0;
    h.sum = h.vmin = h.vmax = 0.0;
  }
  for (auto& h : p->ten_hist) {
    std::lock_guard<std::mutex> lk(h.mu);
    std::fill(h.counts.begin(), h.counts.end(), 0);
    h.count = 0;
    h.sum = h.vmin = h.vmax = 0.0;
  }
  std::lock_guard<std::mutex> lk(p->cache_mu);
  for (auto& e : p->slots) {
    e.used = false;
    e.seg.clear();
  }
  p->cache_used = 0;
}

}  // extern "C"
