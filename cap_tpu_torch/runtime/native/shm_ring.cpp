// shm_ring — mmap'd SPSC byte-ring pair for the zero-copy CVB1
// transport (see shm_ring.h for the layout contract).
//
// Safety stance, mirrored from the socket chain's parser hardening:
// every cursor and length is validated BEFORE any byte of the record
// is touched, a producer killed mid-write can never publish a torn
// record (payload first, release-store of head last), and anything a
// hostile or corrupt client CAN make visible — an overrun cursor, an
// impossible length, a foreign generation stamp — maps onto the same
// malformed classes the socket parser raises, so the worker drops the
// transport instead of serving a wrong byte.
//
// The extern "C" surface at the bottom exists for three callers: the
// Python binding's tests (create/open/probe/read/write), the
// native-build symbol gate, and cap_shm_drive — the shm analog of
// cap_bench_drive, a closed-loop load driver that attaches over a
// socket and then drives the rings entirely from C threads so
// tools/bench_stages.py's transport column measures the WORKER, not a
// Python client.

#include "shm_ring.h"

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

namespace cap_shm {

static inline std::atomic<uint64_t>* cursor(Region* r, uint64_t off) {
  return reinterpret_cast<std::atomic<uint64_t>*>(r->base + off);
}

static inline uint64_t head_off(int ring) {
  return ring == RING_REQ ? OFF_REQ_HEAD : OFF_RESP_HEAD;
}

static inline uint64_t tail_off(int ring) {
  return ring == RING_REQ ? OFF_REQ_TAIL : OFF_RESP_TAIL;
}

static bool pow2_in_bounds(uint64_t v) {
  return v >= MIN_RING && v <= MAX_RING && (v & (v - 1)) == 0;
}

static void put_u64(uint8_t* b, uint64_t off, uint64_t v) {
  std::memcpy(b + off, &v, 8);
}

static void put_u32f(uint8_t* b, uint64_t off, uint32_t v) {
  std::memcpy(b + off, &v, 4);
}

static uint64_t get_u64(const uint8_t* b, uint64_t off) {
  uint64_t v;
  std::memcpy(&v, b + off, 8);
  return v;
}

static uint32_t get_u32f(const uint8_t* b, uint64_t off) {
  uint32_t v;
  std::memcpy(&v, b + off, 4);
  return v;
}

Region* create_region(const char* path, uint64_t req_size,
                      uint64_t resp_size, uint32_t gen) {
  if (!pow2_in_bounds(req_size) || !pow2_in_bounds(resp_size) ||
      gen == 0 || std::strlen(path) >= sizeof(Region::path))
    return nullptr;
  int fd = ::open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = HDR_SIZE + req_size + resp_size;
  if (::ftruncate(fd, (off_t)total) != 0) {
    ::close(fd);
    ::unlink(path);
    return nullptr;
  }
  void* m = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) {
    ::unlink(path);
    return nullptr;
  }
  Region* r = new Region();
  r->base = (uint8_t*)m;
  r->map_len = total;
  r->ring_off[RING_REQ] = HDR_SIZE;
  r->ring_size[RING_REQ] = req_size;
  r->ring_off[RING_RESP] = HDR_SIZE + req_size;
  r->ring_size[RING_RESP] = resp_size;
  r->gen = gen;
  std::strncpy(r->path, path, sizeof(r->path) - 1);
  uint8_t* b = r->base;
  put_u32f(b, OFF_VERSION, VERSION);
  put_u32f(b, OFF_GEN, gen);
  put_u64(b, OFF_REQ_OFF, HDR_SIZE);
  put_u64(b, OFF_REQ_SIZE, req_size);
  put_u64(b, OFF_RESP_OFF, HDR_SIZE + req_size);
  put_u64(b, OFF_RESP_SIZE, resp_size);
  // magic LAST: a reader that races the create never sees a
  // half-initialized header behind a valid magic
  std::atomic_thread_fence(std::memory_order_release);
  put_u64(b, OFF_MAGIC, MAGIC);
  return r;
}

static int validate_header(const uint8_t* b, uint64_t file_len,
                           char* err, size_t err_len) {
  if (get_u64(b, OFF_MAGIC) != MAGIC) {
    if (err) std::snprintf(err, err_len, "bad shm magic");
    return 1;
  }
  if (get_u32f(b, OFF_VERSION) != VERSION) {
    if (err) std::snprintf(err, err_len, "unsupported shm version");
    return 1;
  }
  if (get_u32f(b, OFF_GEN) == 0) {
    if (err) std::snprintf(err, err_len, "zero generation");
    return 1;
  }
  uint64_t req_off = get_u64(b, OFF_REQ_OFF);
  uint64_t req_size = get_u64(b, OFF_REQ_SIZE);
  uint64_t resp_off = get_u64(b, OFF_RESP_OFF);
  uint64_t resp_size = get_u64(b, OFF_RESP_SIZE);
  if (!pow2_in_bounds(req_size) || !pow2_in_bounds(resp_size)) {
    if (err) std::snprintf(err, err_len, "ring size out of bounds");
    return 2;
  }
  if (req_off != HDR_SIZE || resp_off != HDR_SIZE + req_size ||
      file_len < HDR_SIZE + req_size + resp_size) {
    if (err) std::snprintf(err, err_len, "ring offsets inconsistent");
    return 1;
  }
  return 0;
}

Region* map_region(const char* path, char* err, size_t err_len) {
  if (err && err_len) err[0] = '\0';
  if (std::strlen(path) >= sizeof(Region::path)) {
    if (err) std::snprintf(err, err_len, "path too long");
    return nullptr;
  }
  int fd = ::open(path, O_RDWR);
  if (fd < 0) {
    if (err) std::snprintf(err, err_len, "open failed: %d", errno);
    return nullptr;
  }
  struct stat st;
  if (::fstat(fd, &st) != 0 || (uint64_t)st.st_size < HDR_SIZE ||
      (uint64_t)st.st_size > HDR_SIZE + 2 * MAX_RING) {
    ::close(fd);
    if (err) std::snprintf(err, err_len, "bad region file size");
    return nullptr;
  }
  void* m = ::mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) {
    if (err) std::snprintf(err, err_len, "mmap failed: %d", errno);
    return nullptr;
  }
  const uint8_t* b = (const uint8_t*)m;
  if (validate_header(b, (uint64_t)st.st_size, err, err_len) != 0) {
    ::munmap(m, (size_t)st.st_size);
    return nullptr;
  }
  Region* r = new Region();
  r->base = (uint8_t*)m;
  r->map_len = (uint64_t)st.st_size;
  r->ring_off[RING_REQ] = get_u64(b, OFF_REQ_OFF);
  r->ring_size[RING_REQ] = get_u64(b, OFF_REQ_SIZE);
  r->ring_off[RING_RESP] = get_u64(b, OFF_RESP_OFF);
  r->ring_size[RING_RESP] = get_u64(b, OFF_RESP_SIZE);
  r->gen = get_u32f(b, OFF_GEN);
  std::strncpy(r->path, path, sizeof(r->path) - 1);
  return r;
}

void close_region(Region* r, bool unlink_file) {
  if (!r) return;
  if (r->base) ::munmap(r->base, (size_t)r->map_len);
  if (unlink_file) ::unlink(r->path);
  delete r;
}

int32_t probe_region(const char* path) {
  char err[128];
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return 1;
  struct stat st;
  if (::fstat(fd, &st) != 0 || (uint64_t)st.st_size < HDR_SIZE) {
    ::close(fd);
    return 1;
  }
  uint8_t hdr[HDR_SIZE];
  ssize_t n = ::read(fd, hdr, sizeof(hdr));
  ::close(fd);
  if (n != (ssize_t)sizeof(hdr)) return 1;
  return validate_header(hdr, (uint64_t)st.st_size, err, sizeof(err));
}

uint64_t max_record(const Region* r, int ring) {
  // a record must fit the ring with headroom for one wrap marker
  return r->ring_size[ring] / 2;
}

int poll_record(Region* r, int ring, const uint8_t** data,
                uint64_t* len) {
  uint64_t size = r->ring_size[ring];
  uint8_t* buf = r->base + r->ring_off[ring];
  for (;;) {
    uint64_t head = cursor(r, head_off(ring))
                        ->load(std::memory_order_acquire);
    uint64_t tail = cursor(r, tail_off(ring))
                        ->load(std::memory_order_relaxed);
    if (head == tail) return SHM_EMPTY;
    if (head - tail > size || (tail & 7) != 0)
      return SHM_MALFORMED;  // cursor overran the ring (or torn state)
    uint64_t off = tail & (size - 1);
    if (head - tail < 8) return SHM_MALFORMED;
    uint32_t rec_len = get_u32f(buf, off);
    uint32_t rec_gen = get_u32f(buf, off + 4);
    if (rec_len == WRAP) {
      if (rec_gen != get_u32f(r->base, OFF_GEN))
        return SHM_STALE_GEN;
      uint64_t skip = size - off;  // jump to the ring start
      if (head - tail < skip) return SHM_MALFORMED;
      cursor(r, tail_off(ring))
          ->store(tail + skip, std::memory_order_release);
      continue;
    }
    if ((uint64_t)rec_len > size / 2) return SHM_TOOLARGE;
    uint64_t adv = 8 + (((uint64_t)rec_len + 7) & ~7ull);
    if (adv > size - off || head - tail < adv)
      return SHM_MALFORMED;  // record claims bytes not published
    if (rec_gen != get_u32f(r->base, OFF_GEN)) return SHM_STALE_GEN;
    *data = buf + off + 8;
    *len = rec_len;
    return SHM_RECORD;
  }
}

void consume_record(Region* r, int ring) {
  uint64_t size = r->ring_size[ring];
  uint8_t* buf = r->base + r->ring_off[ring];
  uint64_t tail = cursor(r, tail_off(ring))
                      ->load(std::memory_order_relaxed);
  uint64_t off = tail & (size - 1);
  uint32_t rec_len = get_u32f(buf, off);
  uint64_t adv = 8 + (((uint64_t)rec_len + 7) & ~7ull);
  cursor(r, tail_off(ring))
      ->store(tail + adv, std::memory_order_release);
}

int write_record(Region* r, int ring, const uint8_t* data,
                 uint64_t len, AbortFn abort, void* ctx) {
  uint64_t size = r->ring_size[ring];
  uint8_t* buf = r->base + r->ring_off[ring];
  if (len > size / 2) return SHM_TOOLARGE;
  uint64_t adv = 8 + ((len + 7) & ~7ull);
  int spins = 0;
  for (;;) {
    uint64_t head = cursor(r, head_off(ring))
                        ->load(std::memory_order_relaxed);
    uint64_t tail = cursor(r, tail_off(ring))
                        ->load(std::memory_order_acquire);
    uint64_t off = head & (size - 1);
    uint64_t wrap_skip = (size - off < adv) ? size - off : 0;
    if (size - (head - tail) >= wrap_skip + adv) {
      if (wrap_skip) {
        put_u32f(buf, off, WRAP);
        put_u32f(buf, off + 4, r->gen);
        head += wrap_skip;
        off = 0;
        // publish the marker so a consumer mid-ring can progress
        cursor(r, head_off(ring))
            ->store(head, std::memory_order_release);
      }
      put_u32f(buf, off, (uint32_t)len);
      put_u32f(buf, off + 4, r->gen);
      if (len) std::memcpy(buf + off + 8, data, (size_t)len);
      cursor(r, head_off(ring))
          ->store(head + adv, std::memory_order_release);
      return 0;
    }
    if (abort && abort(ctx)) return SHM_ABORTED;
    if (++spins < 64)
      std::this_thread::yield();
    else
      ::usleep(spins < 256 ? 50 : 500);
  }
}

// ---------------------------------------------------------------------------
// native closed-loop shm load driver (tools/bench_stages.py transport
// column): attach over the socket, then drive pipelined plain verify
// frames through the rings entirely in C threads.
// ---------------------------------------------------------------------------

static uint32_t drv_crc_table[256];
static bool drv_crc_init = []() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
    drv_crc_table[i] = c;
  }
  return true;
}();

static uint32_t drv_crc32(uint32_t crc, const uint8_t* p, size_t n) {
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    crc = drv_crc_table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

static const uint32_t CVB1_MAGIC = 0x31425643;
static const uint8_t T_VERIFY_REQ = 1;
static const uint8_t T_VERIFY_RESP = 2;
static const uint8_t T_SHM_ATTACH = 15;
static const uint8_t T_SHM_ACK = 16;

static void put_u32s(std::string& s, uint32_t v) {
  s.append((const char*)&v, 4);
}

static std::string attach_frame(const std::string& path) {
  // canonical payload: sorted keys + compact separators, exactly what
  // protocol.shm_attach_payload emits
  std::string payload =
      "{\"op\":\"attach\",\"path\":\"" + path + "\",\"version\":1}";
  std::string f;
  put_u32s(f, CVB1_MAGIC);
  f.push_back((char)T_SHM_ATTACH);
  put_u32s(f, 1);
  put_u32s(f, (uint32_t)payload.size());
  f += payload;
  put_u32s(f, drv_crc32(0, (const uint8_t*)f.data(), f.size()));
  return f;
}

static bool send_all_fd(int fd, const std::string& data) {
  const char* p = data.data();
  size_t left = data.size();
  while (left) {
    ssize_t w = ::send(fd, p, left, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;
    }
    p += w;
    left -= (size_t)w;
  }
  return true;
}

static bool recv_exact(int fd, uint8_t* out, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::recv(fd, out + got, n - got, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    got += (size_t)r;
  }
  return true;
}

// read one SHM ack (type 16, one entry) off the socket; returns the
// status byte or -1 on transport/parse failure
static int read_shm_ack(int fd) {
  uint8_t hdr[9];
  if (!recv_exact(fd, hdr, 9)) return -1;
  uint32_t magic, count;
  std::memcpy(&magic, hdr, 4);
  std::memcpy(&count, hdr + 5, 4);
  if (magic != CVB1_MAGIC || hdr[4] != T_SHM_ACK || count != 1)
    return -1;
  uint8_t ehdr[5];
  if (!recv_exact(fd, ehdr, 5)) return -1;
  uint32_t ln;
  std::memcpy(&ln, ehdr + 1, 4);
  if (ln > (1u << 20)) return -1;
  std::vector<uint8_t> payload(ln ? ln : 1);
  if (ln && !recv_exact(fd, payload.data(), ln)) return -1;
  uint8_t crc[4];
  if (!recv_exact(fd, crc, 4)) return -1;
  return ehdr[0];
}

struct ShmDriveShared {
  std::atomic<int64_t> tokens{0};
  std::atomic<int64_t> reqs{0};
  std::atomic<int32_t> errors{0};
  std::atomic<bool> stop{false};
};

struct DriveAbort {
  ShmDriveShared* sh;
  std::chrono::steady_clock::time_point until;  // dead-worker bound
};

static bool drive_abort(void* ctx) {
  DriveAbort* a = (DriveAbort*)ctx;
  return a->sh->stop.load(std::memory_order_relaxed) ||
         std::chrono::steady_clock::now() > a->until;
}

static void shm_drive_one(const char* host, int32_t port,
                          const char* shm_dir, const uint8_t* blob,
                          const int64_t* offs, int32_t n_tokens,
                          int32_t req_tokens, int32_t depth,
                          double seconds, int64_t ring_bytes,
                          uint32_t seed, ShmDriveShared* sh) {
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
  // unique per ATTEMPT, not just per connection slot: the worker
  // unlinks a detached region asynchronously, so reusing a path
  // across back-to-back drives (warmup → measured run) would race
  // the janitor and lose the fresh file
  static std::atomic<uint32_t> attempt{0};
  char path[400];
  std::snprintf(path, sizeof(path), "%s/cap-shm-drive-%d-%u-%u",
                shm_dir, (int)::getpid(), seed,
                attempt.fetch_add(1));
  uint64_t rb = ring_bytes > 0 ? (uint64_t)ring_bytes : (1ull << 20);
  uint64_t sz = MIN_RING;
  while (sz < rb && sz < MAX_RING) sz <<= 1;
  Region* r = create_region(path, sz, sz, 0x1000u + seed);
  if (!r) {
    ::close(fd);
    sh->errors.fetch_add(1);
    return;
  }
  if (!send_all_fd(fd, attach_frame(path)) || read_shm_ack(fd) != 0) {
    close_region(r, true);
    ::close(fd);
    sh->errors.fetch_add(1);
    return;
  }
  // pre-encode distinct plain request frames, reused round-robin —
  // exactly cap_bench_drive's shape, so the transport A/B compares
  // rings vs sockets on identical frames
  std::vector<std::string> frames;
  uint32_t rng = seed * 2654435761u + 12345u;
  for (int v = 0; v < 16; v++) {
    rng = rng * 1103515245u + 12345u;
    int32_t lo = (int32_t)(rng % (uint32_t)(n_tokens > req_tokens
                                                ? n_tokens - req_tokens
                                                : 1));
    std::string f;
    put_u32s(f, CVB1_MAGIC);
    f.push_back((char)T_VERIFY_REQ);
    put_u32s(f, (uint32_t)req_tokens);
    for (int32_t j = 0; j < req_tokens; j++) {
      int64_t o = offs[lo + j], e = offs[lo + j + 1];
      put_u32s(f, (uint32_t)(e - o));
      f.append((const char*)(blob + o), (size_t)(e - o));
    }
    frames.push_back(std::move(f));
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration_cast<
                      std::chrono::steady_clock::duration>(
                      std::chrono::duration<double>(seconds));
  DriveAbort ab{sh, deadline + std::chrono::seconds(10)};
  int inflight = 0;
  size_t next = 0;
  bool ok = true;
  for (;;) {
    bool in_window = std::chrono::steady_clock::now() < deadline;
    while (ok && in_window && inflight < depth) {
      const std::string& f = frames[next++ % frames.size()];
      int wr = write_record(r, RING_REQ, (const uint8_t*)f.data(),
                            f.size(), drive_abort, &ab);
      if (wr != 0) { ok = false; break; }
      inflight++;
    }
    if (!inflight || !ok) break;
    // consume one response record
    const uint8_t* rec;
    uint64_t len;
    int spins = 0;
    for (;;) {
      int st = poll_record(r, RING_RESP, &rec, &len);
      if (st == SHM_RECORD) break;
      if (st != SHM_EMPTY || sh->stop.load() ||
          std::chrono::steady_clock::now() > ab.until) {
        if (::getenv("CAP_SHM_DRIVE_DEBUG")) {
          // post-mortem cursor dump (the probe that caught CPython's
          // pack_into zero-fill transit — see shm_ring.py set_cursor)
          std::fprintf(
              stderr,
              "cap_shm_drive[%u]: resp poll st=%d req=%llu/%llu "
              "resp=%llu/%llu\n", seed, st,
              (unsigned long long)cursor(r, OFF_REQ_HEAD)->load(),
              (unsigned long long)cursor(r, OFF_REQ_TAIL)->load(),
              (unsigned long long)cursor(r, OFF_RESP_HEAD)->load(),
              (unsigned long long)cursor(r, OFF_RESP_TAIL)->load());
        }
        ok = false;
        break;
      }
      if (++spins < 64)
        std::this_thread::yield();
      else
        ::usleep(50);
    }
    if (!ok) break;
    if (len >= 9 && rec[4] == T_VERIFY_RESP) {
      uint32_t count;
      std::memcpy(&count, rec + 5, 4);
      if (in_window) {
        sh->tokens.fetch_add((int64_t)count);
        sh->reqs.fetch_add(1);
      }
    } else {
      if (::getenv("CAP_SHM_DRIVE_DEBUG"))
        std::fprintf(stderr, "cap_shm_drive[%u]: bad resp record "
                     "len=%llu type=%d\n", seed,
                     (unsigned long long)len, len ? rec[4] : -1);
      ok = false;
    }
    consume_record(r, RING_RESP);
    inflight--;
    if (!in_window && inflight == 0) break;
  }
  ::close(fd);
  close_region(r, true);
  if (!ok) sh->errors.fetch_add(1);
}

}  // namespace cap_shm

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

using namespace cap_shm;

extern "C" {

void* cap_shm_create(const char* path, int64_t req_size,
                     int64_t resp_size, int32_t gen) {
  return create_region(path, (uint64_t)req_size, (uint64_t)resp_size,
                       (uint32_t)gen);
}

void* cap_shm_open(const char* path) {
  char err[128];
  return map_region(path, err, sizeof(err));
}

void cap_shm_close(void* r, int32_t unlink_file) {
  close_region((Region*)r, unlink_file != 0);
}

int32_t cap_shm_probe(const char* path) { return probe_region(path); }

// Test hook: blocking-with-timeout write of one record.
// 0 ok, SHM_TOOLARGE, SHM_ABORTED (timeout).
struct _Deadline {
  std::chrono::steady_clock::time_point until;
};

static bool _deadline_abort(void* ctx) {
  return std::chrono::steady_clock::now() > ((_Deadline*)ctx)->until;
}

int64_t cap_shm_write(void* rv, int32_t ring, const uint8_t* data,
                      int64_t len, double timeout_s) {
  _Deadline d{std::chrono::steady_clock::now() +
              std::chrono::duration_cast<
                  std::chrono::steady_clock::duration>(
                  std::chrono::duration<double>(timeout_s))};
  return write_record((Region*)rv, ring, data, (uint64_t)len,
                      _deadline_abort, &d);
}

// Test hook: copy the next record of `ring` into out (cap bytes).
// >0 = record length, SHM_EMPTY on timeout, <0 = poisoned ring.
int64_t cap_shm_read(void* rv, int32_t ring, uint8_t* out,
                     int64_t cap, double timeout_s) {
  Region* r = (Region*)rv;
  auto until = std::chrono::steady_clock::now() +
               std::chrono::duration_cast<
                   std::chrono::steady_clock::duration>(
                   std::chrono::duration<double>(timeout_s));
  for (;;) {
    const uint8_t* data;
    uint64_t len;
    int st = poll_record(r, ring, &data, &len);
    if (st == SHM_RECORD) {
      if ((int64_t)len > cap) return SHM_TOOLARGE;
      std::memcpy(out, data, (size_t)len);
      consume_record(r, ring);
      return (int64_t)len;
    }
    if (st != SHM_EMPTY) return st;
    if (std::chrono::steady_clock::now() > until) return SHM_EMPTY;
    ::usleep(100);
  }
}

// Closed-loop shm load driver (the cap_bench_drive analog): each conn
// attaches its own region under shm_dir and pipelines plain verify
// frames through it. port >= 0 → TCP host:port; port < 0 → host is a
// UDS path. Returns 0 when every connection finished cleanly.
int32_t cap_shm_drive(const char* host, int32_t port,
                      const char* shm_dir, const uint8_t* blob,
                      const int64_t* offs, int32_t n_tokens,
                      int32_t req_tokens, int32_t depth,
                      double seconds, int32_t n_conns,
                      int64_t ring_bytes, int64_t* out_tokens,
                      int64_t* out_reqs) {
  ShmDriveShared sh;
  std::vector<std::thread> threads;
  for (int32_t i = 0; i < (n_conns > 0 ? n_conns : 1); i++)
    threads.emplace_back(shm_drive_one, host, port, shm_dir, blob,
                         offs, n_tokens, req_tokens, depth, seconds,
                         ring_bytes, (uint32_t)(i + 1), &sh);
  for (auto& t : threads) t.join();
  if (out_tokens) *out_tokens = sh.tokens.load();
  if (out_reqs) *out_reqs = sh.reqs.load();
  return sh.errors.load() ? -1 : 0;
}

}  // extern "C"
