// serve_native — GIL-free CVB1 serve chain for cap_tpu.
//
// The per-token half of the serve hot path (ROADMAP open item #1):
// frame read/validate/decode and response encode/write run in
// dedicated C++ threads, feeding the Python batcher through a bounded
// lock-free MPSC ring (tokens in, verdicts out). Python touches only
// whole BATCHES — one drain call pulls every queued request's tokens
// into flat buffers, one post call hands a batch of verdicts back —
// so the interpreter's serial cost per token is a couple of memcpy'd
// slices instead of a frame parse, a queue hop, and a struct.pack.
//
// Contract: the frame parser here must reject EXACTLY the same
// malformed / oversize / corrupt frames as serve/protocol.py
// _parse_frame, with the same error classes (status codes below map
// 1:1 onto MalformedFrameError / FrameTooLargeError /
// FrameCorruptError / UnicodeDecodeError — the parity sweep in
// tests/test_serve_native.py pins this over the malformed corpus).
//
// Threading model (one handle per worker):
//   - one reader thread per connection: buffered recv → parse →
//     validate → Req records pushed into the MPSC ring (Vyukov
//     bounded queue; producers lock-free on the fast path, blocking
//     only when the ring or the token watermark is full, which is the
//     backpressure that ends up in the client's TCP window);
//   - one writer thread per connection: sends responses strictly in
//     request order (seq assigned at read time), holding out-of-order
//     completions in a map — CVB1 has no request ids, order IS the
//     correlation;
//   - pings are answered natively (pong enqueued at the ping's seq);
//     stats/keys frames ride the ring as control records so Python
//     handles them IN ORDER with the verifies around them.
//
// Built into libcapruntime.so alongside jose_native.cpp (one TU each,
// same .so — see Makefile `native` / cap_tpu/_build.py).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <arpa/inet.h>
#include <errno.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/types.h>
#include <sys/un.h>
#include <unistd.h>

#include "cvb1_wire.h"
#include "shm_ring.h"
#include "telemetry_native.h"

// SHA-256 from jose_native.cpp (same .so, SHA-NI dispatched): the
// verdict-cache token digest is sha256(token)[:16], computed here in
// the reader threads so the Python drain does zero hashing.
namespace sha2 {
void sha256(const uint8_t* data, size_t len, uint8_t out[32]);
}

namespace serve_native {

// The wire contract (frame types, limits, PF_* codes, parse_frame,
// crc32, UTF-8 validation, encode/send helpers) lives in
// cvb1_wire.h, shared with frontdoor_native.cpp — one parser, every
// native reader.
using namespace cvb1;

static const int DIG_LEN = 16;  // vcache.DIGEST_LEN

// ---------------------------------------------------------------------------
// bounded MPSC ring (Vyukov bounded queue; single consumer = the
// Python drain thread, producers = per-connection reader threads).
// ---------------------------------------------------------------------------

class MpscRing {
 public:
  explicit MpscRing(size_t cap_pow2) : mask_(cap_pow2 - 1),
                                       cells_(cap_pow2) {
    for (size_t i = 0; i < cap_pow2; i++)
      cells_[i].seq.store(i, std::memory_order_relaxed);
  }

  bool try_push(void* p) {
    size_t pos = head_.load(std::memory_order_relaxed);
    for (;;) {
      Cell& c = cells_[pos & mask_];
      size_t seq = c.seq.load(std::memory_order_acquire);
      intptr_t diff = (intptr_t)seq - (intptr_t)pos;
      if (diff == 0) {
        if (head_.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed)) {
          c.data = p;
          c.seq.store(pos + 1, std::memory_order_release);
          return true;
        }
      } else if (diff < 0) {
        return false;  // full
      } else {
        pos = head_.load(std::memory_order_relaxed);
      }
    }
  }

  // single-consumer pop: tail_ is plain, only the drain thread moves it
  void* try_pop() {
    Cell& c = cells_[tail_ & mask_];
    size_t seq = c.seq.load(std::memory_order_acquire);
    if ((intptr_t)seq - (intptr_t)(tail_ + 1) < 0) return nullptr;
    void* p = c.data;
    c.seq.store(tail_ + mask_ + 1, std::memory_order_release);
    tail_++;
    return p;
  }

 private:
  struct Cell {
    std::atomic<size_t> seq;
    void* data;
  };
  size_t mask_;
  std::vector<Cell> cells_;
  std::atomic<size_t> head_{0};
  size_t tail_ = 0;
};

// ---------------------------------------------------------------------------
// deficit-round-robin scheduler (r20 tenant fairness). One slot per
// real tenant (telemetry_native.h TEN_SLOTS) plus ONE shared
// best-effort slot for none/other/unclassified traffic. Costs are
// TOKENS (the unit the pipeline fills with); a queue whose head costs
// more than its deficit yields the cursor and earns another quantum
// on its next visit — the classic DRR result behind token-bucket-
// policed ingest (the FPGA ECDSA engine paper's scheduling frame).
//
// Single-consumer by construction: only the drain thread touches it.
// The algorithm is mirrored LINE FOR LINE by cap_tpu/serve/drr.py
// (the python chain's AdaptiveBatcher fair mode) and the dispatch-
// order parity is pinned by tests/test_admission.py through the
// cap_drr_* test ABI below — both chains must schedule identically.
// ---------------------------------------------------------------------------

static const int SCHED_SLOTS = 65;       // TEN_SLOTS real + 1 best-effort
static const int SCHED_BE = 64;          // the shared best-effort slot
static const int64_t SCHED_QUANTUM = 512;

struct DrrSched {
  std::deque<std::pair<void*, int64_t>> q[SCHED_SLOTS];
  int64_t deficit[SCHED_SLOTS] = {};
  int32_t weight[SCHED_SLOTS];
  int64_t quantum = SCHED_QUANTUM;
  int32_t cursor = 0;
  bool fresh = true;   // cursor just arrived at its slot (one charge)
  int64_t n = 0;

  DrrSched() {
    for (auto& w : weight) w = 1;
  }

  void push(int slot, void* item, int64_t cost) {
    if (slot < 0 || slot >= SCHED_SLOTS) slot = SCHED_BE;
    q[slot].emplace_back(item, cost < 1 ? 1 : cost);
    n++;
  }

  // Next item in DRR order (nullptr when empty). Deterministic given
  // the arrival sequence — the parity contract with serve/drr.py.
  void* pop() {
    if (n == 0) return nullptr;
    int empties = 0;
    for (;;) {
      int s = cursor;
      if (q[s].empty()) {
        deficit[s] = 0;              // leaving the active set resets
        cursor = (s + 1) % SCHED_SLOTS;
        fresh = true;
        if (++empties >= SCHED_SLOTS) return nullptr;  // defensive
        continue;
      }
      empties = 0;
      if (fresh) {
        deficit[s] += quantum * (int64_t)weight[s];
        fresh = false;
      }
      auto& head = q[s].front();
      if (head.second <= deficit[s]) {
        deficit[s] -= head.second;
        void* item = head.first;
        q[s].pop_front();
        n--;
        return item;
      }
      cursor = (s + 1) % SCHED_SLOTS;  // out of deficit: yield turn
      fresh = true;
    }
  }
};

// ---------------------------------------------------------------------------
// per-tenant token-bucket admission (r20). Checked by the READER
// threads at enqueue, per token: over-budget tokens are marked
// throttled and never reach the verify pipeline — the drain path
// answers them with a status-1 ThrottledError carrying a retry-after
// hint, and the reader's blocking push is what turns a sustained
// flood into TCP backpressure (wire pushback). One bucket per tenant
// slot INCLUDING none/other (N_TEN buckets), refilled lazily from a
// monotonic clock under one small mutex (one lock round per frame).
// ---------------------------------------------------------------------------

struct AdmBucket {
  double level = 0.0;
  double t_last = 0.0;
  double scale = 1.0;   // shed lever: effective rate = rate * scale
  bool init = false;
};

// ---------------------------------------------------------------------------
// handle / connection / request records
// ---------------------------------------------------------------------------

struct Handle;

struct Conn {
  Handle* h = nullptr;
  int32_t id = 0;
  int fd = -1;
  std::mutex mu;
  std::condition_variable cv;
  std::map<int64_t, std::string> outq;  // seq → encoded response frame
  int64_t next_send = 0;
  int64_t assigned = 0;      // seqs handed out by the reader (under mu)
  bool reader_done = false;
  bool dead = false;         // send failed: discard, never block
  std::atomic<int> finished{0};  // 2 = both threads exited
  // shm transport (negotiated per connection via T_SHM_ATTACH): once
  // attached, requests arrive through the region's request ring and
  // responses with seq >= shm_from_seq leave through its response
  // ring; the SOCKET stays open purely as the liveness channel (EOF =
  // client gone → detach + reclaim). The attach ack itself rides the
  // socket (seq < shm_from_seq), so the client can confirm the switch
  // before it starts producing.
  cap_shm::Region* shm_region = nullptr;
  int64_t shm_from_seq = INT64_MAX;  // under mu
  std::atomic<bool> peer_gone{false};
};

// Request kinds surfaced to the Python drain loop.
enum { K_VERIFY = 0, K_STATS = 2, K_KEYS = 3, K_PEER = 4 };

struct Req {
  std::shared_ptr<Conn> conn;
  int64_t seq = 0;
  uint8_t ftype = 0;
  uint8_t kind = K_VERIFY;
  uint8_t trace_len = 0;
  char trace[MAX_TRACE_BYTES];
  double t_recv = 0.0;
  // reader-side enqueue stamp (steady clock == CLOCK_MONOTONIC ==
  // Python time.monotonic() on Linux): the occupancy plane (r22)
  // measures queue.ring_wait_s as drain-side monotonic() - t_enq.
  double t_enq = 0.0;
  std::vector<int64_t> offs;  // entry boundaries into blob (n+1)
  std::string blob;           // concatenated entry bytes
  // telemetry plane (when attached): per-token family index (-1 =
  // header-cache miss, resolved by Python on the drain path), hashed
  // kid, and tenant slot (issuer hash → bounded table; misses resolve
  // with the family), classified by THIS reader thread at parse time.
  std::vector<int8_t> fams;
  std::string kids;  // 12 bytes per token, zero = none
  std::vector<int16_t> tens;
  // verdict cache (when enabled): sha256(token)[:16] per token,
  // computed by THIS reader thread at parse time
  std::string digests;
  // tenant-fair scheduling (r20): the DRR slot this request queues
  // under (first token's tenant; -1 / out-of-range → best-effort) and
  // the per-token admission verdicts — thr[i] != 0 means token i was
  // rejected by the token bucket and must NOT be verified; retry_ms
  // is the frame's retry-after hint (max over its throttled tokens).
  int16_t sched_slot = -1;
  std::vector<uint8_t> thr;
  int32_t retry_ms = 0;
};

// counter slots (cap_serve_counter)
enum {
  CTR_CONNS = 0,
  CTR_FRAMES = 1,
  CTR_TOKENS = 2,
  CTR_PROTO_ERR = 3,
  CTR_PONGS = 4,
  CTR_DROPPED_POSTS = 5,
  CTR_CONNS_CLOSED = 6,
  // shm transport (slots additive — a stale binding reading only 0-6
  // keeps its exact meanings)
  CTR_SHM_ATTACHES = 7,
  CTR_SHM_FALLBACKS = 8,
  CTR_SHM_FRAMES = 9,
  CTR_SHM_STALE_GEN = 10,
  CTR_SHM_DETACHES = 11,
  // admission control (r20; slots additive like the shm block — a
  // stale binding reading only 0-11 keeps its exact meanings). The
  // exact equation ADM_CHECKED == ADM_ADMITTED + ADM_THROTTLED is an
  // obs-smoke gate.
  CTR_ADM_CHECKED = 12,
  CTR_ADM_ADMITTED = 13,
  CTR_ADM_THROTTLED = 14,
  CTR_N = 15,
};

struct Handle {
  MpscRing ring;
  std::atomic<int64_t> queued_tokens{0};
  // burst visibility: the highest queued_tokens seen between scrapes
  // (drain-time sampling misses bursts; cap_serve_ring_hwm resets it)
  std::atomic<int64_t> ring_hwm{0};
  int64_t max_queued_tokens;
  // native telemetry plane (nullable; cap_serve_set_telemetry). Owned
  // by this handle once attached — freed together in destroy.
  cap_tel::TelPlane* tel = nullptr;
  // per-token (fam, kid, tenant) of the LAST drain call, in drain
  // order — cap_serve_drain_aux / cap_serve_drain_tens copy them out;
  // single-consumer like carry.
  std::vector<int8_t> last_fams;
  std::vector<uint8_t> last_kids;
  std::vector<int16_t> last_tens;
  // shm transport armed (cap_serve_set_shm): attach requests are
  // honored; off → acked status 1 + CTR_SHM_FALLBACKS (the socket
  // chain keeps serving, the r12 graceful-fallback contract)
  std::atomic<int32_t> shm_on{0};
  // verdict-cache digests (cap_serve_set_digests arms the readers;
  // cap_serve_drain_digests copies the last drain's out)
  std::atomic<int32_t> digests_on{0};
  std::vector<uint8_t> last_digests;
  // tenant-fair DRR scheduling (r20, cap_serve_set_fair). The sched
  // struct and barrier are CONSUMER-OWNED (only the drain thread
  // touches them); fair_on is sampled per pop so arming/disarming is
  // safe at any time. A control record becomes a BARRIER: everything
  // queued before it drains first (DRR only reorders verifies BETWEEN
  // control records — the keys-push ordering contract is unchanged),
  // and nothing behind it leaves the MPSC ring until it is delivered.
  std::atomic<int32_t> fair_on{0};
  DrrSched sched;
  Req* barrier = nullptr;
  // per-tenant token-bucket admission (r20, cap_serve_set_admission):
  // shared by every reader thread under adm_mu. rate is tokens/sec
  // PER TENANT; burst is the bucket depth in tokens.
  std::atomic<int32_t> adm_on{0};
  std::mutex adm_mu;
  double adm_rate = 0.0;
  double adm_burst = 0.0;
  AdmBucket adm[cap_tel::N_TEN];
  // per-token throttle mask of the LAST drain (cap_serve_drain_thr),
  // token-aligned like last_fams; single-consumer.
  std::vector<uint8_t> last_thr;
  // per-REQUEST ring-enqueue stamps of the LAST drain (r22 occupancy
  // plane, cap_serve_drain_enq): one double per drained request, in
  // drain order; single-consumer like last_thr.
  std::vector<double> last_enq;
  std::mutex mu;  // guards the two cvs' sleep/wake protocol
  std::condition_variable cv_data;   // drain thread sleeps here
  std::condition_variable cv_space;  // producers sleep here when full
  std::atomic<bool> stop{false};
  std::mutex conns_mu;
  std::unordered_map<int32_t, std::shared_ptr<Conn>> conns;
  int32_t next_id = 1;
  Req* carry = nullptr;  // drained but didn't fit the caller's buffers
  std::atomic<int64_t> ctr[CTR_N];
  int sweep_tick = 0;

  Handle(size_t cap, int64_t maxq) : ring(cap), max_queued_tokens(maxq) {
    for (auto& c : ctr) c.store(0);
  }
};

static double wall_now() {
  struct timeval tv;
  gettimeofday(&tv, nullptr);
  return (double)tv.tv_sec + (double)tv.tv_usec * 1e-6;
}

static double mono_now() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

static void enqueue_response(const std::shared_ptr<Conn>& c, int64_t seq,
                             std::string&& data) {
  std::lock_guard<std::mutex> lk(c->mu);
  c->outq.emplace(seq, std::move(data));
  c->cv.notify_all();
}

// blockingly push one request into the ring (token watermark +
// ring-capacity backpressure; false only on shutdown)
static bool push_req(Handle* h, Req* r, int64_t ntok) {
  for (;;) {
    if (h->stop.load(std::memory_order_relaxed)) return false;
    if (h->queued_tokens.load(std::memory_order_relaxed) <=
            h->max_queued_tokens &&
        h->ring.try_push(r)) {
      int64_t now =
          h->queued_tokens.fetch_add(ntok, std::memory_order_relaxed) +
          ntok;
      int64_t hwm = h->ring_hwm.load(std::memory_order_relaxed);
      while (now > hwm &&
             !h->ring_hwm.compare_exchange_weak(
                 hwm, now, std::memory_order_relaxed)) {
      }
      std::lock_guard<std::mutex> lk(h->mu);
      h->cv_data.notify_one();
      return true;
    }
    std::unique_lock<std::mutex> lk(h->mu);
    h->cv_space.wait_for(lk, std::chrono::milliseconds(20));
  }
}

// ---------------------------------------------------------------------------
// reader thread: buffered recv → parse → ring (or native pong); an
// attached shm region swaps the byte source from recv to the mapped
// request ring (zero syscalls, zero copy before the Req blob).
// ---------------------------------------------------------------------------

// Both-threads-done teardown: the LAST thread out closes the fd and
// reclaims the shm region (unmap + unlink — a client killed by -9
// left the file behind; the worker is the reliable janitor). Nothing
// here touches the Handle: cap_serve_destroy may free it as soon as
// every conn shows finished == 2.
static void finish_conn(const std::shared_ptr<Conn>& c) {
  if (c->finished.fetch_add(1) + 1 == 2) {
    if (c->shm_region) cap_shm::close_region(c->shm_region, true);
    ::close(c->fd);
  }
}

// Handle one PF_OK frame exactly as the socket reader always has:
// native pong, or a Req pushed into the MPSC ring (verify tokens and
// in-order control records alike). Returns false when the connection
// must drop (wrong-direction frame, shutdown during push).
static bool handle_frame(const std::shared_ptr<Conn>& c,
                         const uint8_t* base, const Parsed& p) {
  Handle* h = c->h;
  if (p.ftype == T_PING) {
    int64_t seq;
    {
      std::lock_guard<std::mutex> lk(c->mu);
      seq = c->assigned++;
    }
    std::string pong(9, '\0');
    uint32_t zero = 0;
    std::memcpy(&pong[0], &MAGIC, 4);
    pong[4] = (char)T_PONG;
    std::memcpy(&pong[5], &zero, 4);
    enqueue_response(c, seq, std::move(pong));
    h->ctr[CTR_PONGS].fetch_add(1);
    return true;
  }
  if (p.ftype == T_VERIFY_REQ || p.ftype == T_VERIFY_REQ_CRC ||
      p.ftype == T_VERIFY_REQ_TRACE || p.ftype == T_STATS_REQ ||
      p.ftype == T_KEYS_PUSH || p.ftype == T_PEER_FILL) {
    Req* r = new Req();
    r->conn = c;
    r->ftype = p.ftype;
    r->kind = p.ftype == T_STATS_REQ ? K_STATS
              : p.ftype == T_KEYS_PUSH ? K_KEYS
              : p.ftype == T_PEER_FILL ? K_PEER
                                       : K_VERIFY;
    {
      std::lock_guard<std::mutex> lk(c->mu);
      r->seq = c->assigned++;
    }
    r->t_recv = wall_now();
    r->t_enq = mono_now();
    r->trace_len = (uint8_t)p.trace_len;
    if (p.trace_len)
      std::memcpy(r->trace, base + p.trace_off, (size_t)p.trace_len);
    size_t nent = p.entries.size();
    r->offs.resize(nent + 1);
    r->offs[0] = 0;
    int64_t tot = 0;
    for (size_t i = 0; i < nent; i++) {
      tot += p.entries[i].len;
      r->offs[i + 1] = tot;
    }
    r->blob.resize((size_t)tot);
    for (size_t i = 0; i < nent; i++)
      std::memcpy(&r->blob[(size_t)r->offs[i]], base + p.entries[i].off,
                  (size_t)p.entries[i].len);
    if (r->kind == K_VERIFY &&
        h->digests_on.load(std::memory_order_relaxed)) {
      // verdict-cache digest per token, while the bytes are hot
      // (SHA-NI where the CPU has it — ~0.1 µs for a typical token)
      r->digests.resize(nent * DIG_LEN);
      uint8_t d32[32];
      for (size_t i = 0; i < nent; i++) {
        sha2::sha256(base + p.entries[i].off,
                     (size_t)p.entries[i].len, d32);
        std::memcpy(&r->digests[i * DIG_LEN], d32, DIG_LEN);
      }
    }
    if (h->tel && r->kind == K_VERIFY) {
      // classify each token's family AND tenant here, GIL-free, while
      // the frame bytes are cache-hot: header segment = bytes before
      // the first '.' (token.split(".", 1)[0], byte-for-byte); the
      // tenant slot rides the same cache entry (issuer parsing only
      // ever happens in Python, on a miss)
      r->fams.resize(nent);
      r->kids.assign(nent * cap_tel::KID_LEN, '\0');
      r->tens.assign(nent, (int16_t)-1);
      for (size_t i = 0; i < nent; i++) {
        const uint8_t* tok = base + p.entries[i].off;
        int64_t tlen = p.entries[i].len;
        const uint8_t* dot =
            (const uint8_t*)std::memchr(tok, '.', (size_t)tlen);
        int64_t slen = dot ? (int64_t)(dot - tok) : tlen;
        int32_t kid_len = 0;
        r->fams[i] = (int8_t)cap_tel::classify(
            h->tel, tok, slen,
            (uint8_t*)&r->kids[i * cap_tel::KID_LEN], &kid_len,
            &r->tens[i]);
        if (r->fams[i] < 0) r->tens[i] = -1;  // miss: Python resolves
      }
    }
    if (r->kind == K_VERIFY) {
      // DRR slot: the FIRST token's reader-classified tenant decides
      // (frames are per-connection and issuers per-client, so mixed-
      // tenant frames are rare; the python twin picks the same way).
      // Unclassified / none / other / header-cache miss → the shared
      // best-effort slot (sched_slot stays -1).
      if (!r->tens.empty() && r->tens[0] >= 0 &&
          r->tens[0] < cap_tel::TEN_SLOTS)
        r->sched_slot = r->tens[0];
      if (h->adm_on.load(std::memory_order_relaxed) && nent) {
        // token-bucket admission, per token, while the frame is hot:
        // a throttled token is marked (never verified) and answered
        // from the drain path with the retry-after pushback — the
        // whole point is that a flood costs the pipeline ~nothing.
        r->thr.assign(nent, 0);
        double now = mono_now();
        int64_t throttled = 0, judged = 0;
        double worst = 0.0;
        {
          std::lock_guard<std::mutex> lk(h->adm_mu);
          for (size_t i = 0; i < nent; i++) {
            if (i >= r->tens.size() || r->tens[i] < 0 ||
                r->tens[i] >= cap_tel::N_TEN) {
              // header-cache miss (or no telemetry plane): the tenant
              // is unknown HERE — judging it against a shared bucket
              // would let one tenant's cold frames starve another's.
              // Mark PENDING; the drain path judges it through
              // cap_serve_adm_take once Python resolved the issuer.
              r->thr[i] = 2;
              continue;
            }
            judged++;
            AdmBucket& b = h->adm[r->tens[i]];
            double rate = h->adm_rate * b.scale;
            if (!b.init) {
              b.init = true;
              b.level = h->adm_burst;   // buckets start full
              b.t_last = now;
            } else if (now > b.t_last) {
              b.level += (now - b.t_last) * rate;
              if (b.level > h->adm_burst) b.level = h->adm_burst;
              b.t_last = now;
            }
            if (b.level >= 1.0) {
              b.level -= 1.0;
            } else {
              r->thr[i] = 1;
              throttled++;
              double wait = rate > 1e-9 ? (1.0 - b.level) / rate
                                        : 60.0;
              if (wait > worst) worst = wait;
            }
          }
        }
        if (judged) h->ctr[CTR_ADM_CHECKED].fetch_add(judged);
        if (throttled) {
          h->ctr[CTR_ADM_THROTTLED].fetch_add(throttled);
          int64_t ms = (int64_t)(worst * 1000.0) + 1;
          if (ms < 1) ms = 1;
          if (ms > 60000) ms = 60000;
          r->retry_ms = (int32_t)ms;
        }
        if (judged - throttled)
          h->ctr[CTR_ADM_ADMITTED].fetch_add(judged - throttled);
      }
    }
    int64_t ntok = r->kind == K_VERIFY ? (int64_t)nent : 1;
    if (r->kind == K_VERIFY) h->ctr[CTR_TOKENS].fetch_add(nent);
    if (!push_req(h, r, ntok)) {
      delete r;
      return false;
    }
    return true;
  }
  // valid frame, wrong direction (a response type at the server — or
  // a second SHM attach): protocol violation → drop the connection.
  return false;
}

// extract the "path" string out of the attach payload JSON — the one
// field the native side needs; escaped paths are rejected (the
// clients never emit them, and un-escaping here would invite drift)
static std::string attach_path(const uint8_t* payload, int64_t len) {
  static const char key[] = "\"path\":\"";
  std::string s((const char*)payload, (size_t)len);
  size_t at = s.find(key);
  if (at == std::string::npos) return "";
  size_t start = at + sizeof(key) - 1;
  size_t end = s.find('"', start);
  if (end == std::string::npos) return "";
  std::string path = s.substr(start, end - start);
  if (path.find('\\') != std::string::npos) return "";
  return path;
}

// checksummed SHM ack (type 16, one entry) — byte-identical to
// protocol.encode_shm_ack
static std::string shm_ack_frame(const std::string& error) {
  std::string payload =
      error.empty() ? std::string("{\"transport\":\"shm\"}") : error;
  std::string f;
  put_u32(f, MAGIC);
  f.push_back((char)T_SHM_ACK);
  put_u32(f, 1);
  f.push_back(error.empty() ? '\0' : '\x01');
  put_u32(f, (uint32_t)payload.size());
  f += payload;
  append_crc(f);
  return f;
}

// Serve one attached connection from its mapped request ring. The
// socket is polled (non-blocking) as the liveness channel: EOF means
// the client is gone — including kill -9 mid-write, whose partial
// record was never published and is simply reclaimed with the ring.
static void shm_reader_loop(const std::shared_ptr<Conn>& c) {
  Handle* h = c->h;
  cap_shm::Region* r = c->shm_region;
  int idle = 0;
  for (;;) {
    if (h->stop.load(std::memory_order_relaxed)) break;
    const uint8_t* rec;
    uint64_t len;
    int st = cap_shm::poll_record(r, cap_shm::RING_REQ, &rec, &len);
    if (st == cap_shm::SHM_EMPTY) {
      if (++idle >= 32) {
        idle = 0;
        char probe[64];
        ssize_t n = ::recv(c->fd, probe, sizeof(probe), MSG_DONTWAIT);
        if (n == 0) break;  // EOF: client gone → detach + reclaim
        if (n > 0) {
          // bytes on the socket after the attach: protocol violation
          h->ctr[CTR_PROTO_ERR].fetch_add(1);
          break;
        }
        if (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK) break;
      }
      ::usleep(100);
      continue;
    }
    if (st != cap_shm::SHM_RECORD) {
      // poisoned ring: overrun cursor / impossible length / foreign
      // generation — the shm analog of a malformed socket frame
      if (st == cap_shm::SHM_STALE_GEN)
        h->ctr[CTR_SHM_STALE_GEN].fetch_add(1);
      h->ctr[CTR_PROTO_ERR].fetch_add(1);
      break;
    }
    idle = 0;
    Parsed p;
    int pst = parse_frame(rec, (int64_t)len, p);
    if (pst != PF_OK || (uint64_t)p.consumed != len ||
        p.ftype == T_SHM_ATTACH) {
      h->ctr[CTR_PROTO_ERR].fetch_add(1);
      break;
    }
    h->ctr[CTR_FRAMES].fetch_add(1);
    h->ctr[CTR_SHM_FRAMES].fetch_add(1);
    bool ok = handle_frame(c, rec, p);
    // consume AFTER handle_frame copied the entry bytes out — the
    // producer may reuse the space the moment the tail moves
    cap_shm::consume_record(r, cap_shm::RING_REQ);
    if (!ok) break;
  }
  c->peer_gone.store(true);
  h->ctr[CTR_SHM_DETACHES].fetch_add(1);
}

static void reader_main(std::shared_ptr<Conn> c) {
  Handle* h = c->h;
  std::vector<uint8_t> buf;
  size_t start = 0;
  for (;;) {
    Parsed p;
    int st = PF_INCOMPLETE;
    if (buf.size() > start)
      st = parse_frame(buf.data() + start, (int64_t)(buf.size() - start),
                       p);
    if (st == PF_INCOMPLETE) {
      if (h->stop.load(std::memory_order_relaxed)) break;
      if (start > 0) {  // compact the consumed prefix
        buf.erase(buf.begin(), buf.begin() + start);
        start = 0;
      }
      size_t old = buf.size();
      buf.resize(old + (1 << 16));
      ssize_t r = ::recv(c->fd, buf.data() + old, 1 << 16, 0);
      if (r <= 0) {  // EOF / error / shutdown
        buf.resize(old);
        break;
      }
      buf.resize(old + (size_t)r);
      continue;
    }
    if (st != PF_OK) {
      // Malformed / oversize / corrupt / bad-UTF-8: same stance as
      // the Python worker — count it, drop the connection quietly.
      h->ctr[CTR_PROTO_ERR].fetch_add(1);
      break;
    }
    h->ctr[CTR_FRAMES].fetch_add(1);
    const uint8_t* base = buf.data() + start;
    if (p.ftype == T_SHM_ATTACH) {
      // transport negotiation: map the client's region and switch
      // this connection's frame source to its request ring; anything
      // unsupported acks status 1 and the socket chain keeps serving
      // (serve.shm_fallbacks — the graceful-fallback contract)
      int64_t seq;
      {
        std::lock_guard<std::mutex> lk(c->mu);
        seq = c->assigned++;
      }
      std::string path = attach_path(base + p.entries[0].off,
                                     p.entries[0].len);
      if (!h->shm_on.load(std::memory_order_relaxed) || path.empty() ||
          c->shm_region) {
        h->ctr[CTR_SHM_FALLBACKS].fetch_add(1);
        enqueue_response(
            c, seq,
            shm_ack_frame("TypeError: worker has no shm transport "
                          "(transport=socket)"));
      } else {
        char err[128];
        cap_shm::Region* region =
            cap_shm::map_region(path.c_str(), err, sizeof(err));
        if (!region) {
          h->ctr[CTR_SHM_FALLBACKS].fetch_add(1);
          enqueue_response(
              c, seq,
              shm_ack_frame(std::string("ValueError: shm region "
                                        "unusable: ") + err));
        } else {
          {
            std::lock_guard<std::mutex> lk(c->mu);
            c->shm_region = region;
            c->shm_from_seq = seq + 1;  // the ack rides the socket
          }
          h->ctr[CTR_SHM_ATTACHES].fetch_add(1);
          enqueue_response(c, seq, shm_ack_frame(""));
          start += (size_t)p.consumed;
          shm_reader_loop(c);
          break;
        }
      }
    } else if (!handle_frame(c, base, p)) {
      break;
    }
    start += (size_t)p.consumed;
    if (start == buf.size()) {
      buf.clear();
      start = 0;
    }
  }
  {
    std::lock_guard<std::mutex> lk(c->mu);
    c->reader_done = true;
    c->cv.notify_all();
  }
  finish_conn(c);
}

// ---------------------------------------------------------------------------
// writer thread: strict seq-order sends, discards once the peer broke
// ---------------------------------------------------------------------------

// write_record abort hook: give up when the worker is shutting down
// or the client is gone (a dead client stops consuming the response
// ring — blocking forever would wedge the writer thread).
static bool shm_write_abort(void* ctx) {
  Conn* c = (Conn*)ctx;
  return c->h->stop.load(std::memory_order_relaxed) ||
         c->peer_gone.load(std::memory_order_relaxed);
}

static void writer_main(std::shared_ptr<Conn> c) {
  Handle* h = c->h;
  std::unique_lock<std::mutex> lk(c->mu);
  for (;;) {
    auto it = c->outq.find(c->next_send);
    if (it != c->outq.end()) {
      int64_t seq = c->next_send;
      std::string data = std::move(it->second);
      c->outq.erase(it);
      c->next_send++;
      bool dead = c->dead;
      bool to_shm = c->shm_region != nullptr && seq >= c->shm_from_seq;
      lk.unlock();
      bool sent;
      if (dead) {
        sent = true;  // discarding
      } else if (to_shm) {
        sent = cap_shm::write_record(
                   c->shm_region, cap_shm::RING_RESP,
                   (const uint8_t*)data.data(), data.size(),
                   shm_write_abort, c.get()) == 0;
      } else {
        sent = send_all(c->fd, data);
      }
      if (!sent) {
        // Broken mid-response: wake the reader out of recv, then keep
        // DRAINING queued entries so in-flight posts never pile up.
        ::shutdown(c->fd, SHUT_RDWR);
        lk.lock();
        c->dead = true;
      } else {
        lk.lock();
      }
      continue;
    }
    if (h->stop.load(std::memory_order_relaxed)) break;
    if (c->reader_done && c->next_send >= c->assigned)
      break;  // every response this connection will ever owe is sent
    c->cv.wait_for(lk, std::chrono::milliseconds(100));
  }
  lk.unlock();
  (void)h;
  finish_conn(c);
}

// Single-consumer pop honoring fair mode (drain thread only). FIFO
// mode with an empty scheduler is the plain ring pop — zero added
// work on the classic path. In fair mode everything currently queued
// in the MPSC ring first transfers into the per-tenant subqueues,
// stopping at the first CONTROL record, which becomes a barrier:
// every request read before it drains first (over however many drain
// calls that takes), and nothing read after it leaves the ring until
// it is delivered — DRR reorders verifies only BETWEEN controls, so
// the keys-push / stats ordering contract is exactly the FIFO one.
static Req* sched_pop(Handle* h) {
  bool fair = h->fair_on.load(std::memory_order_relaxed) != 0;
  if (!fair && h->sched.n == 0 && !h->barrier)
    return (Req*)h->ring.try_pop();
  if (fair && !h->barrier) {
    for (;;) {
      Req* r = (Req*)h->ring.try_pop();
      if (!r) break;
      if (r->kind != K_VERIFY) {
        h->barrier = r;
        break;
      }
      h->sched.push(r->sched_slot >= 0 ? r->sched_slot : SCHED_BE, r,
                    (int64_t)r->offs.size() - 1);
    }
  }
  if (h->sched.n) {
    Req* r = (Req*)h->sched.pop();
    if (r) return r;
  }
  if (h->barrier) {
    Req* c = h->barrier;
    h->barrier = nullptr;
    return c;
  }
  return (Req*)h->ring.try_pop();
}

// remove fully-finished connections (both threads exited → every
// owed response was sent or discarded; any later post is dropped)
static void sweep_conns(Handle* h) {
  std::lock_guard<std::mutex> lk(h->conns_mu);
  for (auto it = h->conns.begin(); it != h->conns.end();) {
    if (it->second->finished.load() >= 2) {
      h->ctr[CTR_CONNS_CLOSED].fetch_add(1);
      it = h->conns.erase(it);
    } else {
      ++it;
    }
  }
}

}  // namespace serve_native

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

using namespace serve_native;

extern "C" {

void* cap_serve_create(int32_t ring_capacity, int64_t max_queued_tokens) {
  size_t cap = 1;
  while ((int32_t)cap < (ring_capacity > 0 ? ring_capacity : 4096))
    cap <<= 1;
  return new Handle(cap, max_queued_tokens > 0 ? max_queued_tokens
                                               : (int64_t)4 * 32768);
}

int32_t cap_serve_add_conn(void* hv, int32_t fd) {
  Handle* h = (Handle*)hv;
  if (h->stop.load()) return -1;
  auto c = std::make_shared<Conn>();
  c->h = h;
  c->fd = fd;
  {
    std::lock_guard<std::mutex> lk(h->conns_mu);
    c->id = h->next_id++;
    h->conns[c->id] = c;
  }
  h->ctr[CTR_CONNS].fetch_add(1);
  std::thread(reader_main, c).detach();
  std::thread(writer_main, c).detach();
  if (++h->sweep_tick % 64 == 0) sweep_conns(h);
  return c->id;
}

int64_t cap_serve_ring_depth(void* hv) {
  if (!hv) return 0;
  return ((Handle*)hv)->queued_tokens.load(std::memory_order_relaxed);
}

int64_t cap_serve_counter(void* hv, int32_t which) {
  if (!hv || which < 0 || which >= CTR_N) return -1;
  return ((Handle*)hv)->ctr[which].load(std::memory_order_relaxed);
}

// Drain queued requests into flat caller-owned buffers. Returns the
// number of requests drained (0 on timeout), or -2 when the FIRST
// request alone exceeds the caller's buffers — out_counts then holds
// the required sizes and the request is carried for the retry.
//
// req_meta stride is 6 int32s per request:
//   [kind, conn_id, ftype, n_entries, trace_len, reserved]
// tok_off holds n_tokens+1 cumulative byte offsets into tok_blob.
// Returns early (before min_tokens / max_wait) when a control record
// (stats / keys push) is drained — Python must handle it in order.
int64_t cap_serve_drain(void* hv, int64_t min_tokens, int64_t max_tokens,
                        double max_wait_s, double idle_wait_s,
                        uint8_t* tok_blob, int64_t blob_cap,
                        int64_t* tok_off, int32_t* req_meta,
                        int64_t* req_seq, double* req_t0,
                        uint8_t* trace_buf, int32_t max_reqs,
                        int64_t* out_counts) {
  Handle* h = (Handle*)hv;
  using clock = std::chrono::steady_clock;
  auto t_start = clock::now();
  auto t_first = t_start;
  bool have = false;
  int64_t n_reqs = 0, n_toks = 0, blob_used = 0;
  tok_off[0] = 0;
  if (h->tel) {
    h->last_fams.clear();
    h->last_kids.clear();
    h->last_tens.clear();
  }
  bool want_digests = h->digests_on.load(std::memory_order_relaxed);
  if (want_digests) h->last_digests.clear();
  h->last_thr.clear();
  h->last_enq.clear();
  bool stop_drain = false;
  while (!stop_drain) {
    Req* r = h->carry;
    h->carry = nullptr;
    if (!r) r = sched_pop(h);
    if (!r) {
      std::unique_lock<std::mutex> lk(h->mu);
      r = sched_pop(h);
      if (!r) {
        if (h->stop.load(std::memory_order_relaxed)) break;
        auto now = clock::now();
        auto until =
            have ? t_first + std::chrono::duration_cast<clock::duration>(
                                 std::chrono::duration<double>(max_wait_s))
                 : t_start + std::chrono::duration_cast<clock::duration>(
                                 std::chrono::duration<double>(idle_wait_s));
        if (now >= until) break;
        h->cv_data.wait_until(lk, until);
        continue;
      }
    }
    int64_t nent = (int64_t)r->offs.size() - 1;
    int64_t bl = (int64_t)r->blob.size();
    if (n_reqs + 1 > (int64_t)max_reqs || n_toks + nent > max_tokens ||
        blob_used + bl > blob_cap) {
      h->carry = r;  // keep for the next drain call
      if (n_reqs == 0) {
        out_counts[0] = 1;
        out_counts[1] = nent;
        out_counts[2] = bl;
        return -2;  // caller must grow its buffers and retry
      }
      break;
    }
    if (!have) {
      have = true;
      t_first = clock::now();
    }
    std::memcpy(tok_blob + blob_used, r->blob.data(), (size_t)bl);
    for (int64_t j = 0; j < nent; j++)
      tok_off[n_toks + 1 + j] = blob_used + r->offs[j + 1];
    int32_t* m = req_meta + n_reqs * 6;
    m[0] = r->kind;
    m[1] = r->conn->id;
    m[2] = r->ftype;
    m[3] = (int32_t)nent;
    m[4] = r->trace_len;
    m[5] = r->retry_ms;  // admission retry-after hint (0 = none)
    req_seq[n_reqs] = r->seq;
    req_t0[n_reqs] = r->t_recv;
    h->last_enq.push_back(r->t_enq);
    if (r->trace_len)
      std::memcpy(trace_buf + (size_t)n_reqs * MAX_TRACE_BYTES, r->trace,
                  r->trace_len);
    if (h->tel) {
      // keep token-aligned (fam, kid, tenant) for cap_serve_drain_aux
      // / cap_serve_drain_tens — control entries get filler slots so
      // offsets line up
      if (r->kind == K_VERIFY && (int64_t)r->fams.size() == nent) {
        h->last_fams.insert(h->last_fams.end(), r->fams.begin(),
                            r->fams.end());
        h->last_kids.insert(h->last_kids.end(), r->kids.begin(),
                            r->kids.end());
        h->last_tens.insert(h->last_tens.end(), r->tens.begin(),
                            r->tens.end());
      } else {
        h->last_fams.insert(h->last_fams.end(), (size_t)nent, -1);
        h->last_kids.insert(h->last_kids.end(),
                            (size_t)nent * cap_tel::KID_LEN, 0);
        h->last_tens.insert(h->last_tens.end(), (size_t)nent,
                            (int16_t)-1);
      }
    }
    if (want_digests) {
      // token-aligned digests; zero filler (= "rehash in Python")
      // for control records and requests read before arming
      if (r->kind == K_VERIFY &&
          (int64_t)r->digests.size() == nent * DIG_LEN) {
        h->last_digests.insert(h->last_digests.end(),
                               r->digests.begin(), r->digests.end());
      } else {
        h->last_digests.insert(h->last_digests.end(),
                               (size_t)nent * DIG_LEN, 0);
      }
    }
    // token-aligned admission verdicts (cap_serve_drain_thr): zero
    // filler for control records / pre-arming requests
    if (r->kind == K_VERIFY && (int64_t)r->thr.size() == nent) {
      h->last_thr.insert(h->last_thr.end(), r->thr.begin(),
                         r->thr.end());
    } else {
      h->last_thr.insert(h->last_thr.end(), (size_t)nent, 0);
    }
    int64_t consumed = r->kind == K_VERIFY ? nent : 1;
    h->queued_tokens.fetch_sub(consumed, std::memory_order_relaxed);
    n_reqs++;
    n_toks += nent;
    blob_used += bl;
    bool control = r->kind != K_VERIFY;
    delete r;
    {
      std::lock_guard<std::mutex> lk(h->mu);
      h->cv_space.notify_all();
    }
    if (control) break;  // flush now: Python handles it in order
    if (n_toks >= min_tokens) stop_drain = true;
  }
  out_counts[0] = n_reqs;
  out_counts[1] = n_toks;
  out_counts[2] = blob_used;
  return n_reqs;
}

// Post one drained span's verdicts: per request, encode the response
// frame (plain / checksummed / traced mirrors the request type) and
// hand it to the connection's writer at the request's seq. When the
// telemetry plane is attached and fold args are provided, the SAME
// walk folds the chunk's decisions (cap_tel::fold) and observes
// per-request latency — accounting rides the encode, not a Python
// side trip.
static int32_t post_results_impl(Handle* h, const int32_t* req_meta,
                                 const int64_t* req_seq,
                                 const uint8_t* trace_buf,
                                 const double* req_t0, int32_t n_reqs,
                                 const uint8_t* statuses,
                                 const uint8_t* payload_blob,
                                 const int64_t* payload_off,
                                 const uint8_t* reasons,
                                 const int8_t* fams,
                                 const int16_t* tens,
                                 const uint8_t* kids,
                                 int32_t lat_idx, double lat_s,
                                 bool do_fold) {
  int64_t t = 0;
  int32_t dropped = 0;
  double now = (do_fold && req_t0) ? wall_now() : 0.0;
  // the chunk's trace id: the first traced request's, exactly like
  // the drain loop's traces[0] on the Python side
  const uint8_t* fold_trace = nullptr;
  int32_t fold_trace_len = 0;
  for (int32_t i = 0; i < n_reqs; i++) {
    const int32_t* m = req_meta + i * 6;
    int32_t conn_id = m[1];
    uint8_t ftype = (uint8_t)m[2];
    int64_t ntok = m[3];
    uint8_t rtype = ftype == T_VERIFY_REQ_CRC ? T_VERIFY_RESP_CRC
                    : ftype == T_VERIFY_REQ_TRACE ? T_VERIFY_RESP_TRACE
                                                  : T_VERIFY_RESP;
    bool crc = rtype != T_VERIFY_RESP;
    std::string frame;
    int64_t body = payload_off[t + ntok] - payload_off[t];
    frame.reserve((size_t)(9 + 70 + ntok * 5 + body + 4));
    put_u32(frame, MAGIC);
    frame.push_back((char)rtype);
    put_u32(frame, (uint32_t)ntok);
    if (rtype == T_VERIFY_RESP_TRACE) {
      uint8_t tl = (uint8_t)m[4];
      frame.push_back((char)tl);
      frame.append((const char*)(trace_buf + (size_t)i * MAX_TRACE_BYTES),
                   tl);
    }
    for (int64_t j = 0; j < ntok; j++) {
      int64_t off = payload_off[t + j];
      int64_t len = payload_off[t + j + 1] - off;
      frame.push_back((char)statuses[t + j]);
      put_u32(frame, (uint32_t)len);
      frame.append((const char*)(payload_blob + off), (size_t)len);
    }
    if (crc) append_crc(frame);
    t += ntok;
    if (do_fold) {
      if (!fold_trace && m[4] > 0) {
        fold_trace = trace_buf + (size_t)i * MAX_TRACE_BYTES;
        fold_trace_len = m[4];
      }
      if (req_t0 && h->tel)
        cap_tel::observe(h->tel, cap_tel::SERIES_REQUEST_S,
                         now - req_t0[i]);
    }
    std::shared_ptr<Conn> c;
    {
      std::lock_guard<std::mutex> lk(h->conns_mu);
      auto it = h->conns.find(conn_id);
      if (it != h->conns.end()) c = it->second;
    }
    if (c) {
      enqueue_response(c, req_seq[i], std::move(frame));
    } else {
      dropped++;
      h->ctr[CTR_DROPPED_POSTS].fetch_add(1);
    }
  }
  if (do_fold && h->tel && t > 0) {
    cap_tel::observe(h->tel, cap_tel::SERIES_CHUNK_TOKENS, (double)t);
    cap_tel::fold(h->tel, t, statuses, reasons, fams, tens, kids,
                  lat_idx, lat_s, fold_trace, fold_trace_len);
  }
  return dropped;
}

int32_t cap_serve_post_results(void* hv, const int32_t* req_meta,
                               const int64_t* req_seq,
                               const uint8_t* trace_buf, int32_t n_reqs,
                               const uint8_t* statuses,
                               const uint8_t* payload_blob,
                               const int64_t* payload_off) {
  return post_results_impl((Handle*)hv, req_meta, req_seq, trace_buf,
                           nullptr, n_reqs, statuses, payload_blob,
                           payload_off, nullptr, nullptr, nullptr,
                           nullptr, 0, -1.0, false);
}

// The telemetry-folding variant (a separate symbol so a stale .so
// degrades the plane gracefully — the binding probes for it and falls
// back to the Python fold when absent; the r19 tenant extension rides
// the cap_tel_layout_ten handshake, which also gates this signature).
// reasons may be NULL when every status is 0 (the all-accept fast
// path); tens NULL folds every token as tenant "none"; lat_s < 0
// skips the per-tenant latency observation (latency_s=None).
int32_t cap_serve_post_results_tel(
    void* hv, const int32_t* req_meta, const int64_t* req_seq,
    const uint8_t* trace_buf, const double* req_t0, int32_t n_reqs,
    const uint8_t* statuses, const uint8_t* payload_blob,
    const int64_t* payload_off, const uint8_t* reasons,
    const int8_t* fams, const int16_t* tens, const uint8_t* kids,
    int32_t lat_idx, double lat_s) {
  return post_results_impl((Handle*)hv, req_meta, req_seq, trace_buf,
                           req_t0, n_reqs, statuses, payload_blob,
                           payload_off, reasons, fams, tens, kids,
                           lat_idx, lat_s, true);
}

// Attach a telemetry plane (before any connection is added). The
// handle takes ownership: the plane is freed with the handle in
// cap_serve_destroy (or deliberately leaked with it when a wedged
// thread prevents a safe free).
void cap_serve_set_telemetry(void* hv, void* tel) {
  ((Handle*)hv)->tel = (cap_tel::TelPlane*)tel;
}

// Per-token (fam, kid-hash) of the LAST cap_serve_drain call, token-
// aligned with its tok_off ordering. Single-consumer: must be called
// from the drain thread, between drains. Returns tokens copied.
int64_t cap_serve_drain_aux(void* hv, int8_t* fams_out,
                            uint8_t* kids_out, int64_t max_tokens) {
  Handle* h = (Handle*)hv;
  int64_t n = (int64_t)h->last_fams.size();
  if (n > max_tokens) n = max_tokens;
  if (n > 0) {
    std::memcpy(fams_out, h->last_fams.data(), (size_t)n);
    std::memcpy(kids_out, h->last_kids.data(),
                (size_t)n * cap_tel::KID_LEN);
  }
  return n;
}

// Per-token tenant slots of the LAST cap_serve_drain call (-1 = the
// header-cache miss Python's fix_misses resolves), token-aligned with
// cap_serve_drain_aux. Single-consumer, like the others.
int64_t cap_serve_drain_tens(void* hv, int16_t* tens_out,
                             int64_t max_tokens) {
  Handle* h = (Handle*)hv;
  int64_t n = (int64_t)h->last_tens.size();
  if (n > max_tokens) n = max_tokens;
  if (n > 0)
    std::memcpy(tens_out, h->last_tens.data(),
                (size_t)n * sizeof(int16_t));
  return n;
}

// Arm (or disarm) reader-side verdict-cache digests. Call before the
// first connection is added — readers sample the flag per frame.
void cap_serve_set_digests(void* hv, int32_t on) {
  ((Handle*)hv)->digests_on.store(on, std::memory_order_relaxed);
}

// Arm (or disarm) the shm transport: attach requests (CVB1 type 15)
// are honored when on; off acks them status 1 (socket keeps serving)
// and counts CTR_SHM_FALLBACKS.
void cap_serve_set_shm(void* hv, int32_t on) {
  ((Handle*)hv)->shm_on.store(on, std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// r20 tenant-fair scheduling + admission ABI. ALL of these symbols
// are probed as one group by the binding (_SCHED_SYMBOLS): a stale
// .so missing any of them degrades to FIFO + python-side admission
// with a counted fallback — never wrong scheduling, just slower.
// ---------------------------------------------------------------------------

// Layout handshake: slot counts and the counter-block length the
// binding must agree on before arming fair/admission natively.
void cap_serve_layout_sched(int32_t* out) {
  out[0] = SCHED_SLOTS;
  out[1] = SCHED_BE;
  out[2] = cap_tel::N_TEN;
  out[3] = CTR_N;
}

// Arm (or disarm) DRR fair scheduling on the drain path. quantum is
// the per-visit token credit (<= 0 keeps the current value). Safe at
// any time; a disarm flushes the parked subqueues in DRR order first.
void cap_serve_set_fair(void* hv, int32_t on, int64_t quantum) {
  Handle* h = (Handle*)hv;
  if (quantum > 0) h->sched.quantum = quantum;
  h->fair_on.store(on, std::memory_order_relaxed);
}

// Per-slot DRR weight (slot = tenant slot 0..63, or SCHED_BE for the
// shared best-effort slot). Weights < 1 are ignored.
void cap_serve_set_weight(void* hv, int32_t slot, int32_t w) {
  Handle* h = (Handle*)hv;
  if (slot < 0 || slot >= SCHED_SLOTS || w < 1) return;
  h->sched.weight[slot] = w;
}

// Arm (or disarm) per-tenant token-bucket admission in the readers:
// rate tokens/sec per tenant, burst tokens of depth. Reconfiguring
// resets every bucket (full) and every shed scale (1.0).
void cap_serve_set_admission(void* hv, int32_t on, double rate,
                             double burst) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> lk(h->adm_mu);
  h->adm_rate = rate < 0 ? 0 : rate;
  h->adm_burst = burst < 0 ? 0 : burst;
  for (auto& b : h->adm) b = AdmBucket();
  h->adm_on.store(on, std::memory_order_relaxed);
}

// Shed lever: scale one tenant slot's effective rate (slot indexes
// the FULL tenant table, none/other included). 1.0 restores.
void cap_serve_set_tenant_scale(void* hv, int32_t slot, double scale) {
  Handle* h = (Handle*)hv;
  if (slot < 0 || slot >= cap_tel::N_TEN) return;
  std::lock_guard<std::mutex> lk(h->adm_mu);
  h->adm[slot].scale = scale < 0 ? 0 : scale;
}

// Late admission: one bucket take for a token whose tenant was a
// header-cache MISS at read time (the drain path calls this after
// Python resolved the issuer — same arithmetic, same counters, so
// the exact checked == admitted + throttled equation still holds).
// Returns 1 = throttled (*retry_ms_out set), 0 = admitted.
int32_t cap_serve_adm_take(void* hv, int32_t slot,
                           int32_t* retry_ms_out) {
  Handle* h = (Handle*)hv;
  if (slot < 0 || slot >= cap_tel::N_TEN) slot = cap_tel::TEN_NONE;
  double now = mono_now();
  bool throttled = false;
  double wait = 0.0;
  {
    std::lock_guard<std::mutex> lk(h->adm_mu);
    AdmBucket& b = h->adm[slot];
    double rate = h->adm_rate * b.scale;
    if (!b.init) {
      b.init = true;
      b.level = h->adm_burst;
      b.t_last = now;
    } else if (now > b.t_last) {
      b.level += (now - b.t_last) * rate;
      if (b.level > h->adm_burst) b.level = h->adm_burst;
      b.t_last = now;
    }
    if (b.level >= 1.0) {
      b.level -= 1.0;
    } else {
      throttled = true;
      wait = rate > 1e-9 ? (1.0 - b.level) / rate : 60.0;
    }
  }
  h->ctr[CTR_ADM_CHECKED].fetch_add(1);
  if (throttled) {
    h->ctr[CTR_ADM_THROTTLED].fetch_add(1);
    if (retry_ms_out) {
      int64_t ms = (int64_t)(wait * 1000.0) + 1;
      if (ms < 1) ms = 1;
      if (ms > 60000) ms = 60000;
      *retry_ms_out = (int32_t)ms;
    }
    return 1;
  }
  h->ctr[CTR_ADM_ADMITTED].fetch_add(1);
  return 0;
}

// One tenant bucket's current fill level in tokens (no refill — the
// capstat admission column's point-in-time view).
double cap_serve_bucket_fill(void* hv, int32_t slot) {
  Handle* h = (Handle*)hv;
  if (slot < 0 || slot >= cap_tel::N_TEN) return 0.0;
  std::lock_guard<std::mutex> lk(h->adm_mu);
  return h->adm[slot].init ? h->adm[slot].level : h->adm_burst;
}

// Per-token admission verdicts of the LAST cap_serve_drain call
// (1 = throttled: answer with pushback, never verify), token-aligned
// with cap_serve_drain_aux. Single-consumer, like the others.
int64_t cap_serve_drain_thr(void* hv, uint8_t* out,
                            int64_t max_tokens) {
  Handle* h = (Handle*)hv;
  int64_t n = (int64_t)h->last_thr.size();
  if (n > max_tokens) n = max_tokens;
  if (n > 0) std::memcpy(out, h->last_thr.data(), (size_t)n);
  return n;
}

// ---------------------------------------------------------------------------
// r22 occupancy-plane ABI. Probed as one group by the binding
// (_OCC_SYMBOLS); a stale .so missing either symbol degrades to
// inferred ring-wait with a counted fallback
// (serve.native.occ_fallbacks) — never wrong numbers, just coarser.
// ---------------------------------------------------------------------------

// Layout handshake: [abi version, doubles per drained request]. The
// binding disarms the plane on any mismatch.
void cap_serve_layout_occ(int32_t* out) {
  out[0] = 1;  // version
  out[1] = 1;  // one t_enq double per request
}

// Per-REQUEST reader-side enqueue stamps (steady-clock seconds) of the
// LAST cap_serve_drain call, in drain order — request-aligned with
// req_seq/req_t0. Single-consumer, like the others.
int64_t cap_serve_drain_enq(void* hv, double* out, int64_t max_reqs) {
  Handle* h = (Handle*)hv;
  int64_t n = (int64_t)h->last_enq.size();
  if (n > max_reqs) n = max_reqs;
  if (n > 0)
    std::memcpy(out, h->last_enq.data(), (size_t)n * sizeof(double));
  return n;
}

// ---------------------------------------------------------------------------
// DRR test probe: drives the EXACT scheduler struct the drain path
// uses, item identity = arrival order — tests/test_admission.py pins
// the dispatch order bit-for-bit against the python twin
// (cap_tpu/serve/drr.py), which is what makes both chains schedule
// identically by construction.
// ---------------------------------------------------------------------------

namespace serve_native {
struct DrrProbe {
  DrrSched s;
  int64_t next_id = 0;
};
}  // namespace serve_native

void* cap_drr_create(int64_t quantum) {
  DrrProbe* p = new DrrProbe();
  if (quantum > 0) p->s.quantum = quantum;
  return p;
}

void cap_drr_set_weight(void* pv, int32_t slot, int32_t w) {
  DrrProbe* p = (DrrProbe*)pv;
  if (slot >= 0 && slot < SCHED_SLOTS && w >= 1)
    p->s.weight[slot] = w;
}

void cap_drr_push(void* pv, int32_t slot, int64_t cost) {
  DrrProbe* p = (DrrProbe*)pv;
  p->next_id++;
  p->s.push(slot, (void*)(uintptr_t)p->next_id, cost);
}

int64_t cap_drr_pop(void* pv) {
  DrrProbe* p = (DrrProbe*)pv;
  void* item = p->s.pop();
  return item ? (int64_t)(uintptr_t)item - 1 : -1;
}

void cap_drr_destroy(void* pv) { delete (DrrProbe*)pv; }

// Per-token sha256[:16] digests of the LAST cap_serve_drain call,
// token-aligned with its tok_off ordering (zero rows = compute in
// Python). Single-consumer, like cap_serve_drain_aux.
int64_t cap_serve_drain_digests(void* hv, uint8_t* digests_out,
                                int64_t max_tokens) {
  Handle* h = (Handle*)hv;
  int64_t n = (int64_t)(h->last_digests.size() / DIG_LEN);
  if (n > max_tokens) n = max_tokens;
  if (n > 0)
    std::memcpy(digests_out, h->last_digests.data(),
                (size_t)n * DIG_LEN);
  return n;
}

// Ring high-water mark since the last reset (gauge-reset-on-scrape:
// pass reset=1 to rearm at the CURRENT depth, so the next interval's
// mark starts from live occupancy, not zero).
int64_t cap_serve_ring_hwm(void* hv, int32_t reset) {
  if (!hv) return 0;
  Handle* h = (Handle*)hv;
  int64_t hwm = h->ring_hwm.load(std::memory_order_relaxed);
  if (reset)
    h->ring_hwm.store(h->queued_tokens.load(std::memory_order_relaxed),
                      std::memory_order_relaxed);
  return hwm;
}

// Post one pre-encoded frame (stats response / keys ack built in
// Python) at the given request's seq slot.
int32_t cap_serve_post_raw(void* hv, int32_t conn_id, int64_t seq,
                           const uint8_t* data, int64_t len) {
  Handle* h = (Handle*)hv;
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> lk(h->conns_mu);
    auto it = h->conns.find(conn_id);
    if (it != h->conns.end()) c = it->second;
  }
  if (!c) {
    h->ctr[CTR_DROPPED_POSTS].fetch_add(1);
    return 1;
  }
  enqueue_response(c, seq, std::string((const char*)data, (size_t)len));
  return 0;
}

// Shutdown: wake everything, sever every connection, join (bounded).
// The handle is freed only when every thread confirmed exit —
// otherwise it is deliberately leaked (a wedged kernel call must not
// become a use-after-free).
void cap_serve_destroy(void* hv) {
  Handle* h = (Handle*)hv;
  h->stop.store(true);
  {
    std::lock_guard<std::mutex> lk(h->mu);
    h->cv_data.notify_all();
    h->cv_space.notify_all();
  }
  std::vector<std::shared_ptr<Conn>> cs;
  {
    std::lock_guard<std::mutex> lk(h->conns_mu);
    for (auto& kv : h->conns) cs.push_back(kv.second);
  }
  for (auto& c : cs) {
    ::shutdown(c->fd, SHUT_RDWR);
    std::lock_guard<std::mutex> lk(c->mu);
    c->cv.notify_all();
  }
  bool all = false;
  for (int i = 0; i < 500 && !all; i++) {
    all = true;
    for (auto& c : cs)
      if (c->finished.load() < 2) all = false;
    if (!all) ::usleep(10000);
  }
  for (;;) {
    Req* r = (Req*)h->ring.try_pop();
    if (!r) break;
    delete r;
  }
  for (int s = 0; s < SCHED_SLOTS; s++) {
    for (auto& it : h->sched.q[s]) delete (Req*)it.first;
    h->sched.q[s].clear();
  }
  h->sched.n = 0;
  if (h->barrier) {
    delete h->barrier;
    h->barrier = nullptr;
  }
  if (h->carry) {
    delete h->carry;
    h->carry = nullptr;
  }
  if (all) {
    if (h->tel) cap_tel::destroy(h->tel);
    delete h;
  }  // else: leak handle AND plane — reader threads may still touch both
}

// Test/parity hook: classify one frame held fully in a byte buffer,
// with the exact reader semantics (PF_* status codes above).
int32_t cap_serve_probe_frame(const uint8_t* data, int64_t len,
                              int64_t* consumed) {
  Parsed p;
  int st = parse_frame(data, len, p);
  if (consumed) *consumed = (st == PF_OK) ? p.consumed : 0;
  return st;
}

// ---------------------------------------------------------------------------
// native closed-loop load driver (tools/bench_stages.py): streams
// pipelined plain verify requests and parses responses entirely in C,
// so a bench against a stub engine isolates the WORKER's Python-side
// serial cost per token — no Python client chain in the measurement.
// ---------------------------------------------------------------------------

namespace serve_native {

struct DriveShared {
  std::atomic<int64_t> tokens{0};
  std::atomic<int64_t> reqs{0};
  std::atomic<int32_t> errors{0};
};

// port >= 0 → TCP host:port; port < 0 → host is a UDS path (the
// bench_stages transport column's uds arm).
static void drive_one(const char* host, int32_t port, const uint8_t* blob,
                      const int64_t* offs, int32_t n_tokens,
                      int32_t req_tokens, int32_t depth, double seconds,
                      uint32_t seed, DriveShared* sh) {
  int fd;
  if (port >= 0) {
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) { sh->errors.fetch_add(1); return; }
    struct sockaddr_in addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
        ::connect(fd, (struct sockaddr*)&addr, sizeof(addr)) != 0) {
      ::close(fd);
      sh->errors.fetch_add(1);
      return;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  } else {
    fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) { sh->errors.fetch_add(1); return; }
    struct sockaddr_un addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    std::strncpy(addr.sun_path, host, sizeof(addr.sun_path) - 1);
    if (::connect(fd, (struct sockaddr*)&addr, sizeof(addr)) != 0) {
      ::close(fd);
      sh->errors.fetch_add(1);
      return;
    }
  }
  // pre-encode a handful of distinct request frames, reused round-robin
  std::vector<std::string> frames;
  uint32_t rng = seed * 2654435761u + 12345u;
  for (int v = 0; v < 16; v++) {
    rng = rng * 1103515245u + 12345u;
    int32_t lo = (int32_t)(rng % (uint32_t)(n_tokens > req_tokens
                                                ? n_tokens - req_tokens
                                                : 1));
    std::string f;
    put_u32(f, MAGIC);
    f.push_back((char)T_VERIFY_REQ);
    put_u32(f, (uint32_t)req_tokens);
    for (int32_t j = 0; j < req_tokens; j++) {
      int64_t o = offs[lo + j], e = offs[lo + j + 1];
      put_u32(f, (uint32_t)(e - o));
      f.append((const char*)(blob + o), (size_t)(e - o));
    }
    frames.push_back(std::move(f));
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration_cast<
                      std::chrono::steady_clock::duration>(
                      std::chrono::duration<double>(seconds));
  std::vector<uint8_t> buf;
  size_t start = 0;
  int inflight = 0;
  size_t next = 0;
  bool ok = true;
  for (;;) {
    bool in_window = std::chrono::steady_clock::now() < deadline;
    while (ok && in_window && inflight < depth) {
      ok = send_all(fd, frames[next++ % frames.size()]);
      if (ok) inflight++;
    }
    if (!inflight || !ok) break;
    // read one response frame
    for (;;) {
      Parsed p;
      int st = PF_INCOMPLETE;
      if (buf.size() > start)
        st = parse_frame(buf.data() + start,
                         (int64_t)(buf.size() - start), p);
      if (st == PF_OK) {
        start += (size_t)p.consumed;
        if (start == buf.size()) { buf.clear(); start = 0; }
        inflight--;
        if (in_window) {
          sh->tokens.fetch_add((int64_t)p.entries.size());
          sh->reqs.fetch_add(1);
        }
        break;
      }
      if (st != PF_INCOMPLETE) { ok = false; break; }
      if (start > 0) {
        buf.erase(buf.begin(), buf.begin() + start);
        start = 0;
      }
      size_t old = buf.size();
      buf.resize(old + (1 << 16));
      ssize_t r = ::recv(fd, buf.data() + old, 1 << 16, 0);
      if (r <= 0) { buf.resize(old); ok = false; break; }
      buf.resize(old + (size_t)r);
    }
    if (!in_window && inflight == 0) break;
  }
  ::close(fd);
  if (!ok) sh->errors.fetch_add(1);
}

}  // namespace serve_native

int32_t cap_bench_drive(const char* host, int32_t port,
                        const uint8_t* blob, const int64_t* offs,
                        int32_t n_tokens, int32_t req_tokens,
                        int32_t depth, double seconds, int32_t n_conns,
                        int64_t* out_tokens, int64_t* out_reqs) {
  DriveShared sh;
  std::vector<std::thread> threads;
  for (int32_t i = 0; i < (n_conns > 0 ? n_conns : 1); i++)
    threads.emplace_back(drive_one, host, port, blob, offs, n_tokens,
                         req_tokens, depth, seconds, (uint32_t)(i + 1),
                         &sh);
  for (auto& t : threads) t.join();
  if (out_tokens) *out_tokens = sh.tokens.load();
  if (out_reqs) *out_reqs = sh.reqs.load();
  return sh.errors.load() ? -1 : 0;
}

}  // extern "C"
