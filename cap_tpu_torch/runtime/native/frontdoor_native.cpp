// frontdoor_native.cpp — the native zero-copy relay front door
// (SIXTH translation unit of libcapruntime.so).
//
// The fleet is native-speed everywhere except its own entrance: each
// worker's serve chain moves 1.4M tok/s, but the Python router in
// fleet/frontdoor.py caps every multi-pool number near 15k vps —
// the feeder starves the pipeline (the 2112.02229 shape). This TU
// moves the front door's HOT PATH to the edge:
//
//   per-connection C++ reader ──parse once (cvb1_wire.h, the exact
//   serve-chain parser)──► sha256 digest per token ──consistent-hash
//   lookup against a ring SNAPSHOT (vnode points pushed down from
//   Python on membership change)──► relay the payload bytes to the
//   owning worker's socket WITHOUT re-encoding — a single-owner plain
//   frame is spliced through verbatim; a multi-owner frame is split
//   into per-owner plain sub-frames (memcpy of the original token
//   bytes, never a re-serialize). Responses pair back FIFO per
//   upstream connection (workers answer per-conn in seq order) and
//   merge into one client response, sent in strict client-seq order
//   by the same writer-thread discipline as serve_native.cpp.
//
// Everything that needs POLICY stays in Python on the slow path,
// handed off through cap_frontdoor_drain with a reason code:
//   R_CONTROL       stats / keys push / peer fill / shm attach
//   R_DEAD_POOL     a token's hash owner tripped the breaker
//   R_OVERLOAD      owner's in-flight load exceeds spill_factor×avg
//                   (bounded-load spill decision belongs to Python)
//   R_UPSTREAM_FAIL relay connect/send/recv failed mid-frame — the
//                   WHOLE original frame re-dispatches through the
//                   Python FrontDoor (verification is idempotent;
//                   the failed.CAS guarantees exactly one response
//                   per client seq)
//   R_UNROUTED      no committed ring yet
//
// Parity contract: cap_frontdoor_probe_route exposes the EXACT
// routing decision (owner pid, or -1 when the owner is dead) for a
// batch of digests, and tests/test_frontdoor_native.py pins it
// bit-for-bit against the Python ConsistentHashRing twin — same
// stance as the DRR probe (cap_drr_*) that keeps both serve chains
// scheduling identically.
//
// Counting contract: the native fast path only ever routes a token
// to its PRIMARY live owner, so it contributes equal increments to
// lookups and affinity_hits; every spill / re-route / fallback goes
// through the Python FrontDoor which counts them itself — the exact
// fleet-wide equation lookups == affinity_hits + affinity_misses
// survives the split by construction (obs-smoke gates it).

#include <algorithm>
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
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include "cvb1_wire.h"

// one sha256 per TU family: jose_native.cpp owns the implementation
namespace sha2 {
void sha256(const uint8_t* data, size_t len, uint8_t out[32]);
}

namespace frontdoor_native {

using namespace cvb1;

static const int DIG_LEN = 16;   // vcache.DIGEST_LEN
static const int MAX_POOLS = 64;
static const int FD_LAYOUT_VERSION = 1;

// counter slots (cap_frontdoor_counter)
enum {
  FDC_CONNS = 0,
  FDC_FRAMES = 1,
  FDC_TOKENS = 2,
  FDC_PROTO_ERR = 3,
  FDC_PONGS = 4,
  FDC_LOOKUPS = 5,
  FDC_HITS = 6,
  FDC_RELAYS = 7,        // per-owner sub-frame sends (re-framed)
  FDC_RELAY_TOKENS = 8,
  FDC_SPLICES = 9,       // whole frames forwarded verbatim
  FDC_SLOW_FRAMES = 10,
  FDC_SLOW_TOKENS = 11,
  FDC_UPSTREAM_FAILS = 12,
  FDC_SEQ_HELD_MAX = 13,  // deepest per-conn reorder queue seen
  FDC_DROPPED_POSTS = 14,
  FDC_CONNS_CLOSED = 15,
  FDC_N = 16,
};

// slow-path handoff reasons (meta[1] of cap_frontdoor_drain)
enum {
  R_CONTROL = 1,
  R_DEAD_POOL = 2,
  R_OVERLOAD = 3,
  R_UPSTREAM_FAIL = 4,
  R_UNROUTED = 5,
};

struct Endpoint {
  std::string host;  // IPv4 dotted quad, or a UDS path when port < 0
  int32_t port = 0;
};

// Immutable routing snapshot, swapped atomically on commit. Readers
// copy the shared_ptr under cfg_mu (one brief lock per frame) and
// then route lock-free against frozen vectors — a membership change
// never mutates a snapshot a reader is walking.
struct FdConfig {
  std::vector<uint64_t> pts;    // sorted ring points
  std::vector<int32_t> owners;  // owner pid per point
  std::vector<int32_t> pool_ids;
  int32_t n_pools = 0;
  double spill = 1.25;
  std::vector<Endpoint> eps[MAX_POOLS];
};

struct FdHandle;
struct FdConn;

// One in-flight client frame being relayed. Parts (per-owner
// sub-frames) resolve from different upstream-reader threads at
// DISJOINT token indices; `remaining` hits zero only when every part
// succeeded, and `failed` CAS-elects exactly one failure handler —
// between them every client seq gets exactly one response, native or
// slow-path, never both and never zero.
struct FdPending {
  std::shared_ptr<FdConn> conn;
  int64_t seq = 0;
  uint8_t ftype = 0;
  uint8_t trace_len = 0;
  char trace[MAX_TRACE_BYTES];
  int32_t n_tokens = 0;
  bool splice = false;      // single-owner plain frame: forward verbatim
  std::string orig;         // original frame bytes (slow re-dispatch)
  std::vector<uint8_t> statuses;
  std::vector<std::string> payloads;
  std::atomic<int32_t> remaining{0};
  std::atomic<int32_t> failed{0};
};

struct Part {
  std::shared_ptr<FdPending> pending;
  std::vector<int32_t> idxs;  // client-frame token indices this part covers
};

// Per-(client conn, pool) upstream connection. Sub-frames go out in
// client-frame order from the one client reader thread; the worker
// answers per-connection in seq order, so responses pair FIFO.
struct UpConn {
  int fd = -1;
  int32_t pool = -1;
  std::mutex mu;  // guards fifo
  std::deque<Part> fifo;
  std::atomic<bool> dead{false};
};

struct FdConn {
  FdHandle* h = nullptr;
  int32_t id = 0;
  int fd = -1;
  std::mutex mu;
  std::condition_variable cv;
  std::map<int64_t, std::string> outq;  // seq → encoded response frame
  int64_t next_send = 0;
  int64_t assigned = 0;  // seqs handed out by the reader (under mu)
  bool reader_done = false;
  bool dead = false;  // send failed: discard, never block
  std::atomic<int> finished{0};  // 2 = reader + writer both exited
  // lazily-created upstream connections; touched ONLY by this conn's
  // reader thread (creation/replacement) — upstream readers hold
  // their own shared_ptr
  std::shared_ptr<UpConn> ups[MAX_POOLS];
};

// Slow-path handoff record (drained by the Python FrontDoor).
struct SlowReq {
  std::shared_ptr<FdConn> conn;
  int64_t seq = 0;
  int32_t reason = 0;
  uint8_t ftype = 0;
  int32_t n_tokens = 0;
  std::string frame;  // original frame bytes, verbatim
};

struct FdHandle {
  std::mutex cfg_mu;
  std::shared_ptr<FdConfig> cfg;
  // staging area (cap_frontdoor_stage_* under cfg_mu; commit swaps)
  std::vector<uint64_t> st_pts;
  std::vector<int32_t> st_owners;
  std::vector<Endpoint> st_eps[MAX_POOLS];
  // breaker state and load: PERSISTENT across commits, so a ring
  // re-push never un-trips a breaker or forgets in-flight work
  std::atomic<int32_t> live[MAX_POOLS];
  std::atomic<int64_t> inflight[MAX_POOLS];
  std::atomic<bool> stop{false};
  std::atomic<int64_t> live_threads{0};
  std::mutex conns_mu;
  std::unordered_map<int32_t, std::shared_ptr<FdConn>> conns;
  int32_t next_id = 1;
  int sweep_tick = 0;
  // slow-path queue (consumer: the Python drain thread)
  std::mutex slow_mu;
  std::condition_variable slow_cv;
  std::deque<SlowReq*> slow;
  SlowReq* carry = nullptr;  // drained but didn't fit the caller's blob
  std::atomic<int64_t> ctr[FDC_N];

  FdHandle() {
    for (auto& c : ctr) c.store(0);
    for (auto& l : live) l.store(1);
    for (auto& f : inflight) f.store(0);
  }
};

static void enqueue_response(const std::shared_ptr<FdConn>& c, int64_t seq,
                             std::string&& data) {
  size_t depth;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    c->outq.emplace(seq, std::move(data));
    depth = c->outq.size();
    c->cv.notify_all();
  }
  // seq-reorder depth high-water mark (capstat --frontdoor)
  int64_t cur = c->h->ctr[FDC_SEQ_HELD_MAX].load(std::memory_order_relaxed);
  while ((int64_t)depth > cur &&
         !c->h->ctr[FDC_SEQ_HELD_MAX].compare_exchange_weak(
             cur, (int64_t)depth, std::memory_order_relaxed)) {
  }
}

static void to_slow(FdHandle* h, const std::shared_ptr<FdConn>& c,
                    int64_t seq, int32_t reason, uint8_t ftype,
                    int32_t n_tokens, const uint8_t* frame, int64_t len) {
  SlowReq* r = new SlowReq();
  r->conn = c;
  r->seq = seq;
  r->reason = reason;
  r->ftype = ftype;
  r->n_tokens = n_tokens;
  r->frame.assign((const char*)frame, (size_t)len);
  h->ctr[FDC_SLOW_FRAMES].fetch_add(1);
  h->ctr[FDC_SLOW_TOKENS].fetch_add(n_tokens);
  {
    std::lock_guard<std::mutex> lk(h->slow_mu);
    h->slow.push_back(r);
  }
  h->slow_cv.notify_one();
}

// Exactly-one-failure-handler: the CAS winner re-dispatches the WHOLE
// original frame through the Python slow path. Verification is
// idempotent, so a part that already verified upstream is merely
// re-verified — never answered twice (completion requires failed==0).
static void fail_part(FdHandle* h, Part& part) {
  FdPending* pd = part.pending.get();
  int32_t exp = 0;
  if (pd->failed.compare_exchange_strong(exp, 1)) {
    h->ctr[FDC_UPSTREAM_FAILS].fetch_add(1);
    to_slow(h, pd->conn, pd->seq, R_UPSTREAM_FAIL, pd->ftype,
            pd->n_tokens, (const uint8_t*)pd->orig.data(),
            (int64_t)pd->orig.size());
  }
}

// Client-shaped response from merged per-part verdicts: mirrors the
// request frame family (plain / CRC / traced, trace id echoed) —
// exactly what protocol.read_response expects from a worker.
static std::string build_resp(FdPending* pd) {
  uint8_t rt = pd->ftype == T_VERIFY_REQ ? T_VERIFY_RESP
               : pd->ftype == T_VERIFY_REQ_CRC ? T_VERIFY_RESP_CRC
                                               : T_VERIFY_RESP_TRACE;
  std::string s;
  size_t est = 9 + (size_t)pd->n_tokens * 5 + 8;
  for (const auto& pl : pd->payloads) est += pl.size();
  s.reserve(est);
  put_u32(s, MAGIC);
  s.push_back((char)rt);
  put_u32(s, (uint32_t)pd->n_tokens);
  if (rt == T_VERIFY_RESP_TRACE) {
    s.push_back((char)pd->trace_len);
    s.append(pd->trace, pd->trace_len);
  }
  for (int32_t i = 0; i < pd->n_tokens; i++) {
    s.push_back((char)pd->statuses[i]);
    put_u32(s, (uint32_t)pd->payloads[i].size());
    s += pd->payloads[i];
  }
  if (rt != T_VERIFY_RESP) append_crc(s);
  return s;
}

// ---------------------------------------------------------------------------
// upstream reader thread: one per live (client conn, pool) pair.
// Pairs worker responses FIFO with the parts this conn relayed to
// that pool, resolves them into the shared pendings, and fails every
// queued part if the upstream breaks — which is what turns a worker
// kill -9 into a slow-path re-dispatch instead of a lost submission.
// ---------------------------------------------------------------------------

static bool resolve_resp(FdHandle* h, UpConn* up, const uint8_t* base,
                         const Parsed& p) {
  Part part;
  {
    std::lock_guard<std::mutex> lk(up->mu);
    if (up->fifo.empty()) return false;  // unsolicited frame: confused peer
    part = std::move(up->fifo.front());
    up->fifo.pop_front();
  }
  h->inflight[up->pool].fetch_sub((int64_t)part.idxs.size());
  FdPending* pd = part.pending.get();
  if (p.ftype != T_VERIFY_RESP ||
      (int32_t)p.entries.size() != (int32_t)part.idxs.size()) {
    fail_part(h, part);
    return false;
  }
  if (pd->splice) {
    // single-owner plain frame: the worker's response IS the client's
    // response — forward the bytes verbatim
    if (pd->failed.load(std::memory_order_relaxed) == 0)
      enqueue_response(pd->conn, pd->seq,
                       std::string((const char*)base, (size_t)p.consumed));
    return true;
  }
  for (size_t k = 0; k < part.idxs.size(); k++) {
    const EntryRef& e = p.entries[k];
    int32_t i = part.idxs[k];
    pd->statuses[i] = e.status;
    pd->payloads[i].assign((const char*)base + e.off, (size_t)e.len);
  }
  if (pd->remaining.fetch_sub(1) == 1 &&
      pd->failed.load(std::memory_order_relaxed) == 0)
    enqueue_response(pd->conn, pd->seq, build_resp(pd));
  return true;
}

static void upstream_main(std::shared_ptr<FdConn> c,
                          std::shared_ptr<UpConn> up) {
  FdHandle* h = c->h;
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
      if (start > 0) {
        buf.erase(buf.begin(), buf.begin() + start);
        start = 0;
      }
      size_t old = buf.size();
      buf.resize(old + (1 << 16));
      ssize_t r = ::recv(up->fd, buf.data() + old, 1 << 16, 0);
      if (r <= 0) {
        buf.resize(old);
        break;
      }
      buf.resize(old + (size_t)r);
      continue;
    }
    if (st != PF_OK) break;  // corrupt upstream: sever, fail the queue
    if (!resolve_resp(h, up.get(), buf.data() + start, p)) break;
    start += (size_t)p.consumed;
    if (start == buf.size()) {
      buf.clear();
      start = 0;
    }
  }
  up->dead.store(true);
  ::close(up->fd);
  // every part still queued re-dispatches through the slow path
  for (;;) {
    Part part;
    {
      std::lock_guard<std::mutex> lk(up->mu);
      if (up->fifo.empty()) break;
      part = std::move(up->fifo.front());
      up->fifo.pop_front();
    }
    h->inflight[up->pool].fetch_sub((int64_t)part.idxs.size());
    fail_part(h, part);
  }
  h->live_threads.fetch_sub(1);
}

// Get (or re-establish) this conn's relay socket to a pool. The
// endpoint resolves from the CURRENT snapshot every time — after a
// membership change, a dead upstream reconnects to wherever the pool
// lives now. Returns null on connect failure (caller slow-paths).
static std::shared_ptr<UpConn> get_up(const std::shared_ptr<FdConn>& c,
                                      const FdConfig* cfg, int32_t pool) {
  std::shared_ptr<UpConn> up = c->ups[pool];
  if (up && !up->dead.load(std::memory_order_relaxed)) return up;
  const auto& eps = cfg->eps[pool];
  if (eps.empty()) return nullptr;
  const Endpoint& ep = eps[(size_t)c->id % eps.size()];
  int fd;
  if (ep.port >= 0) {
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    struct sockaddr_in addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)ep.port);
    if (::inet_pton(AF_INET, ep.host.c_str(), &addr.sin_addr) != 1 ||
        ::connect(fd, (struct sockaddr*)&addr, sizeof(addr)) != 0) {
      ::close(fd);
      return nullptr;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  } else {
    fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    struct sockaddr_un addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    std::strncpy(addr.sun_path, ep.host.c_str(),
                 sizeof(addr.sun_path) - 1);
    if (::connect(fd, (struct sockaddr*)&addr, sizeof(addr)) != 0) {
      ::close(fd);
      return nullptr;
    }
  }
  up = std::make_shared<UpConn>();
  up->fd = fd;
  up->pool = pool;
  c->ups[pool] = up;
  c->h->live_threads.fetch_add(1);
  std::thread(upstream_main, c, up).detach();
  return up;
}

// ---------------------------------------------------------------------------
// the hot path: route one verify frame
// ---------------------------------------------------------------------------

static void relay_frame(const std::shared_ptr<FdConn>& c,
                        const uint8_t* base, const Parsed& p) {
  FdHandle* h = c->h;
  int32_t n = (int32_t)p.entries.size();
  h->ctr[FDC_TOKENS].fetch_add(n);
  int64_t seq;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    seq = c->assigned++;
  }
  std::shared_ptr<FdConfig> cfg;
  {
    std::lock_guard<std::mutex> lk(h->cfg_mu);
    cfg = h->cfg;
  }
  if (!cfg || cfg->pts.empty() || cfg->n_pools <= 0) {
    to_slow(h, c, seq, R_UNROUTED, p.ftype, n, base, p.consumed);
    return;
  }
  // route every token to its primary ring owner (= Python
  // ConsistentHashRing.primary: bisect_right over the same sha256
  // points — the parity pin's subject)
  std::vector<int32_t> owner_of((size_t)n);
  for (int32_t i = 0; i < n; i++) {
    uint8_t d[32];
    sha2::sha256(base + p.entries[i].off, (size_t)p.entries[i].len, d);
    uint64_t pt = 0;
    for (int k = 0; k < 8; k++) pt = (pt << 8) | d[k];
    size_t j = (size_t)(std::upper_bound(cfg->pts.begin(), cfg->pts.end(),
                                         pt) -
                        cfg->pts.begin());
    int32_t owner = cfg->owners[j % cfg->owners.size()];
    if (!h->live[owner].load(std::memory_order_relaxed)) {
      // breaker re-route is POLICY — Python decides
      to_slow(h, c, seq, R_DEAD_POOL, p.ftype, n, base, p.consumed);
      return;
    }
    owner_of[(size_t)i] = owner;
  }
  // group by owner, preserving token order within each group
  std::vector<int32_t> group_owner;
  std::vector<std::vector<int32_t>> group_idx;
  for (int32_t i = 0; i < n; i++) {
    int32_t o = owner_of[(size_t)i];
    size_t g = 0;
    for (; g < group_owner.size(); g++)
      if (group_owner[g] == o) break;
    if (g == group_owner.size()) {
      group_owner.push_back(o);
      group_idx.emplace_back();
    }
    group_idx[g].push_back(i);
  }
  // bounded-load gate: a hot owner means the SPILL decision is due,
  // and spill arithmetic (and its counters) live in Python
  int64_t sum = 0;
  for (int32_t pid : cfg->pool_ids)
    sum += h->inflight[pid].load(std::memory_order_relaxed);
  double avg = (double)(sum + n) / (double)cfg->n_pools;
  for (int32_t o : group_owner) {
    if ((double)h->inflight[o].load(std::memory_order_relaxed) >
        cfg->spill * avg) {
      to_slow(h, c, seq, R_OVERLOAD, p.ftype, n, base, p.consumed);
      return;
    }
  }
  // fast path committed: primary-owner routing for every token
  h->ctr[FDC_LOOKUPS].fetch_add(n);
  h->ctr[FDC_HITS].fetch_add(n);
  auto pd = std::make_shared<FdPending>();
  pd->conn = c;
  pd->seq = seq;
  pd->ftype = p.ftype;
  pd->n_tokens = n;
  pd->trace_len = (uint8_t)p.trace_len;
  if (p.trace_len)
    std::memcpy(pd->trace, base + p.trace_off, (size_t)p.trace_len);
  pd->orig.assign((const char*)base, (size_t)p.consumed);
  pd->splice = group_owner.size() == 1 && p.ftype == T_VERIFY_REQ;
  if (!pd->splice) {
    pd->statuses.assign((size_t)n, 1);
    pd->payloads.resize((size_t)n);
  }
  pd->remaining.store((int32_t)group_owner.size());
  for (size_t g = 0; g < group_owner.size(); g++) {
    int32_t o = group_owner[g];
    std::shared_ptr<UpConn> up = get_up(c, cfg.get(), o);
    if (!up) {
      h->ctr[FDC_UPSTREAM_FAILS].fetch_add(1);
      int32_t exp = 0;
      if (pd->failed.compare_exchange_strong(exp, 1))
        to_slow(h, c, seq, R_UPSTREAM_FAIL, p.ftype, n, base, p.consumed);
      return;  // unsent groups never resolve; failed gates the response
    }
    std::string sub;
    if (pd->splice) {
      sub.assign((const char*)base, (size_t)p.consumed);
    } else {
      put_u32(sub, MAGIC);
      sub.push_back((char)T_VERIFY_REQ);
      put_u32(sub, (uint32_t)group_idx[g].size());
      for (int32_t i : group_idx[g]) {
        put_u32(sub, (uint32_t)p.entries[i].len);
        sub.append((const char*)base + p.entries[i].off,
                   (size_t)p.entries[i].len);
      }
    }
    h->inflight[o].fetch_add((int64_t)group_idx[g].size());
    {
      std::lock_guard<std::mutex> lk(up->mu);
      up->fifo.push_back(Part{pd, group_idx[g]});
    }
    if (!send_all(up->fd, sub)) {
      // the upstream reader drains the fifo (this part included) and
      // fail_part re-dispatches the frame through the slow path
      up->dead.store(true);
      ::shutdown(up->fd, SHUT_RDWR);
      return;
    }
    if (pd->splice)
      h->ctr[FDC_SPLICES].fetch_add(1);
    else
      h->ctr[FDC_RELAYS].fetch_add(1);
    h->ctr[FDC_RELAY_TOKENS].fetch_add((int64_t)group_idx[g].size());
  }
}

// ---------------------------------------------------------------------------
// client reader / writer threads (serve_native.cpp discipline)
// ---------------------------------------------------------------------------

static void finish_conn(const std::shared_ptr<FdConn>& c) {
  if (c->finished.fetch_add(1) + 1 == 2) ::close(c->fd);
}

// One PF_OK client frame. Returns false when the connection must
// drop (wrong-direction frame).
static bool handle_frame(const std::shared_ptr<FdConn>& c,
                         const uint8_t* base, const Parsed& p) {
  FdHandle* h = c->h;
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
    h->ctr[FDC_PONGS].fetch_add(1);
    return true;
  }
  if (p.ftype == T_VERIFY_REQ || p.ftype == T_VERIFY_REQ_CRC ||
      p.ftype == T_VERIFY_REQ_TRACE) {
    relay_frame(c, base, p);
    return true;
  }
  if (p.ftype == T_STATS_REQ || p.ftype == T_KEYS_PUSH ||
      p.ftype == T_PEER_FILL || p.ftype == T_SHM_ATTACH) {
    // control plane is POLICY: keys fan-out, peer fill, stats merge
    // and the shm refusal all belong to the Python FrontDoor
    int64_t seq;
    {
      std::lock_guard<std::mutex> lk(c->mu);
      seq = c->assigned++;
    }
    to_slow(h, c, seq, R_CONTROL, p.ftype, (int32_t)p.entries.size(),
            base, p.consumed);
    return true;
  }
  // a response frame from a client: confused peer, drop it
  h->ctr[FDC_PROTO_ERR].fetch_add(1);
  return false;
}

static void reader_main(std::shared_ptr<FdConn> c) {
  FdHandle* h = c->h;
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
      if (r <= 0) {
        buf.resize(old);
        break;
      }
      buf.resize(old + (size_t)r);
      continue;
    }
    if (st != PF_OK) {
      h->ctr[FDC_PROTO_ERR].fetch_add(1);
      break;
    }
    h->ctr[FDC_FRAMES].fetch_add(1);
    if (!handle_frame(c, buf.data() + start, p)) break;
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
  // sever the relay legs so their reader threads unwind (each fails
  // its still-queued parts into the slow path on the way out)
  for (auto& up : c->ups) {
    if (up) {
      up->dead.store(true);
      ::shutdown(up->fd, SHUT_RDWR);
    }
  }
  finish_conn(c);
  h->live_threads.fetch_sub(1);
}

static void writer_main(std::shared_ptr<FdConn> c) {
  FdHandle* h = c->h;
  std::unique_lock<std::mutex> lk(c->mu);
  for (;;) {
    auto it = c->outq.find(c->next_send);
    if (it != c->outq.end()) {
      std::string data = std::move(it->second);
      c->outq.erase(it);
      c->next_send++;
      bool dead = c->dead;
      lk.unlock();
      bool sent = dead ? true : send_all(c->fd, data);
      if (!sent) {
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
  finish_conn(c);
  h->live_threads.fetch_sub(1);
}

static void sweep_conns(FdHandle* h) {
  std::lock_guard<std::mutex> lk(h->conns_mu);
  for (auto it = h->conns.begin(); it != h->conns.end();) {
    if (it->second->finished.load() >= 2) {
      h->ctr[FDC_CONNS_CLOSED].fetch_add(1);
      it = h->conns.erase(it);
    } else {
      ++it;
    }
  }
}

}  // namespace frontdoor_native

// ---------------------------------------------------------------------------
// C ABI — probed as one optional symbol group (_FD_SYMBOLS) by
// serve/native_serve.py; a stale .so missing any of them degrades to
// the Python front door with a counted fallback.
// ---------------------------------------------------------------------------

using namespace frontdoor_native;

extern "C" {

void* cap_frontdoor_create(void) { return new FdHandle(); }

// Layout handshake: the binding refuses to arm against a .so whose
// constants drifted from the Python side's expectations.
void cap_frontdoor_layout(int32_t* out) {
  out[0] = MAX_POOLS;
  out[1] = FDC_N;
  out[2] = FD_LAYOUT_VERSION;
  out[3] = DIG_LEN;
}

// Stage a full ring snapshot (sorted points + owner pids). Resets
// the whole staging area — endpoints must be re-staged too.
int32_t cap_frontdoor_stage_ring(void* hv, const uint64_t* pts,
                                 const int32_t* owners, int64_t n) {
  FdHandle* h = (FdHandle*)hv;
  std::lock_guard<std::mutex> lk(h->cfg_mu);
  h->st_pts.assign(pts, pts + n);
  h->st_owners.assign(owners, owners + n);
  for (auto& v : h->st_eps) v.clear();
  for (int64_t i = 0; i < n; i++)
    if (owners[i] < 0 || owners[i] >= MAX_POOLS) return 1;
  return 0;
}

// Append one worker endpoint for a pool (port < 0: host is UDS path).
int32_t cap_frontdoor_stage_pool(void* hv, int32_t pool_id,
                                 const char* host, int32_t port) {
  FdHandle* h = (FdHandle*)hv;
  if (pool_id < 0 || pool_id >= MAX_POOLS) return 1;
  std::lock_guard<std::mutex> lk(h->cfg_mu);
  h->st_eps[pool_id].push_back(Endpoint{std::string(host), port});
  return 0;
}

// Publish the staged snapshot. Readers pick it up on their next
// frame; in-flight relays finish against the old one.
int32_t cap_frontdoor_commit(void* hv, int32_t n_pools, double spill) {
  FdHandle* h = (FdHandle*)hv;
  auto cfg = std::make_shared<FdConfig>();
  std::lock_guard<std::mutex> lk(h->cfg_mu);
  cfg->pts = h->st_pts;
  cfg->owners = h->st_owners;
  cfg->n_pools = n_pools;
  cfg->spill = spill > 0 ? spill : 1.25;
  for (int i = 0; i < MAX_POOLS; i++) cfg->eps[i] = h->st_eps[i];
  for (int32_t o : cfg->owners) {
    bool seen = false;
    for (int32_t pid : cfg->pool_ids) seen = seen || pid == o;
    if (!seen) cfg->pool_ids.push_back(o);
  }
  h->cfg = cfg;
  return 0;
}

// Breaker push-down: Python's _PoolArm.live() projected into the
// native fast path. Persistent across commits.
void cap_frontdoor_set_live(void* hv, int32_t pool_id, int32_t live) {
  FdHandle* h = (FdHandle*)hv;
  if (pool_id < 0 || pool_id >= MAX_POOLS) return;
  h->live[pool_id].store(live ? 1 : 0, std::memory_order_relaxed);
}

int32_t cap_frontdoor_add_conn(void* hv, int32_t fd) {
  FdHandle* h = (FdHandle*)hv;
  if (h->stop.load()) return -1;
  auto c = std::make_shared<FdConn>();
  c->h = h;
  c->fd = fd;
  {
    std::lock_guard<std::mutex> lk(h->conns_mu);
    c->id = h->next_id++;
    h->conns[c->id] = c;
  }
  h->ctr[FDC_CONNS].fetch_add(1);
  h->live_threads.fetch_add(2);
  std::thread(reader_main, c).detach();
  std::thread(writer_main, c).detach();
  if (++h->sweep_tick % 64 == 0) sweep_conns(h);
  return c->id;
}

// Drain slow-path frames for the Python FrontDoor. Returns the frame
// count (0 on timeout, -1 once stopped), or -2 when the FIRST frame
// exceeds blob_cap — out_need[0] then holds the required size and the
// frame carries to the next call (grow-and-retry, like serve drain).
// Layout: blob holds the frames back to back, frame_off[0..n] their
// boundaries, meta stride 4 = (conn_id, reason, ftype, n_tokens),
// seqs the per-conn response slots for cap_frontdoor_post_raw.
int32_t cap_frontdoor_drain(void* hv, double wait_s, uint8_t* blob,
                            int64_t blob_cap, int64_t* frame_off,
                            int32_t* meta, int64_t* seqs,
                            int32_t max_frames, int64_t* out_need) {
  FdHandle* h = (FdHandle*)hv;
  std::unique_lock<std::mutex> lk(h->slow_mu);
  if (!h->carry && h->slow.empty()) {
    if (h->stop.load()) return -1;
    h->slow_cv.wait_for(lk, std::chrono::duration<double>(wait_s));
    if (!h->carry && h->slow.empty()) return h->stop.load() ? -1 : 0;
  }
  int32_t nf = 0;
  int64_t used = 0;
  frame_off[0] = 0;
  while (nf < max_frames) {
    SlowReq* r = h->carry ? h->carry
                 : h->slow.empty() ? nullptr
                                   : h->slow.front();
    if (!r) break;
    if (used + (int64_t)r->frame.size() > blob_cap) {
      if (nf == 0) {
        if (!h->carry) {
          h->carry = r;
          h->slow.pop_front();
        }
        if (out_need) out_need[0] = (int64_t)r->frame.size();
        return -2;
      }
      break;
    }
    if (h->carry)
      h->carry = nullptr;
    else
      h->slow.pop_front();
    std::memcpy(blob + used, r->frame.data(), r->frame.size());
    used += (int64_t)r->frame.size();
    frame_off[nf + 1] = used;
    meta[nf * 4 + 0] = r->conn->id;
    meta[nf * 4 + 1] = r->reason;
    meta[nf * 4 + 2] = (int32_t)r->ftype;
    meta[nf * 4 + 3] = r->n_tokens;
    seqs[nf] = r->seq;
    delete r;
    nf++;
  }
  return nf;
}

// Post one pre-encoded response frame (built by the Python slow path)
// at a drained request's (conn, seq) slot.
int32_t cap_frontdoor_post_raw(void* hv, int32_t conn_id, int64_t seq,
                               const uint8_t* data, int64_t len) {
  FdHandle* h = (FdHandle*)hv;
  std::shared_ptr<FdConn> c;
  {
    std::lock_guard<std::mutex> lk(h->conns_mu);
    auto it = h->conns.find(conn_id);
    if (it != h->conns.end()) c = it->second;
  }
  if (!c) {
    h->ctr[FDC_DROPPED_POSTS].fetch_add(1);
    return 1;
  }
  enqueue_response(c, seq, std::string((const char*)data, (size_t)len));
  return 0;
}

int64_t cap_frontdoor_counter(void* hv, int32_t which) {
  FdHandle* h = (FdHandle*)hv;
  if (which < 0 || which >= FDC_N) return 0;
  return h->ctr[which].load(std::memory_order_relaxed);
}

int64_t cap_frontdoor_inflight(void* hv, int32_t pool_id) {
  FdHandle* h = (FdHandle*)hv;
  if (pool_id < 0 || pool_id >= MAX_POOLS) return 0;
  return h->inflight[pool_id].load(std::memory_order_relaxed);
}

// The parity pin: the exact owner decision the relay fast path makes
// for each 16-byte token digest — owner pid, or -1 when the owner's
// breaker is open (the frame would slow-path to Python). Pinned
// bit-for-bit against the Python ConsistentHashRing twin.
int32_t cap_frontdoor_probe_route(void* hv, const uint8_t* digests,
                                  int32_t n, int32_t* out) {
  FdHandle* h = (FdHandle*)hv;
  std::shared_ptr<FdConfig> cfg;
  {
    std::lock_guard<std::mutex> lk(h->cfg_mu);
    cfg = h->cfg;
  }
  if (!cfg || cfg->pts.empty()) {
    for (int32_t i = 0; i < n; i++) out[i] = -1;
    return 0;
  }
  for (int32_t i = 0; i < n; i++) {
    const uint8_t* d = digests + (int64_t)i * DIG_LEN;
    uint64_t pt = 0;
    for (int k = 0; k < 8; k++) pt = (pt << 8) | d[k];
    size_t j = (size_t)(std::upper_bound(cfg->pts.begin(), cfg->pts.end(),
                                         pt) -
                        cfg->pts.begin());
    int32_t owner = cfg->owners[j % cfg->owners.size()];
    out[i] =
        h->live[owner].load(std::memory_order_relaxed) ? owner : -1;
  }
  return n;
}

// Shutdown: wake everything, sever every client connection (upstream
// legs cascade from their readers), bounded-join, then free — or
// deliberately leak when a wedged thread makes a free unsafe.
void cap_frontdoor_destroy(void* hv) {
  FdHandle* h = (FdHandle*)hv;
  h->stop.store(true);
  {
    std::lock_guard<std::mutex> lk(h->slow_mu);
    h->slow_cv.notify_all();
  }
  std::vector<std::shared_ptr<FdConn>> cs;
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
    all = h->live_threads.load() == 0;
    if (!all) ::usleep(10000);
  }
  {
    std::lock_guard<std::mutex> lk(h->slow_mu);
    for (SlowReq* r : h->slow) delete r;
    h->slow.clear();
    if (h->carry) {
      delete h->carry;
      h->carry = nullptr;
    }
  }
  if (all) delete h;
  // else: leak — a reader thread may still touch the handle
}

}  // extern "C"
