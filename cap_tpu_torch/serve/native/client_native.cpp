// capclient — native client for the cap_tpu verify worker (CVB1).
//
// The reference is a pure in-process Go library; this framework runs
// its verify engine in a worker process that owns the accelerator, so
// host applications in ANY language need a client. This is the C ABI
// one (usable from C/C++/Go-cgo/ctypes): blocking connect + batched
// verify over the length-prefixed CVB1 protocol (see
// cap_tpu/serve/protocol.py for the frame layout).
//
// Redaction stance: no logging; error strings from the worker never
// contain token material.
//
// Build: make native   (g++ -O3 -shared -fPIC)

#include <arpa/inet.h>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x31425643;  // "CVB1"
constexpr uint8_t kVerifyReq = 1;
constexpr uint8_t kVerifyResp = 2;
constexpr uint8_t kPing = 3;
constexpr uint8_t kPong = 4;
// Mirror protocol.py's limits: reject hostile/corrupt lengths instead
// of allocating them (a bad_alloc escaping extern "C" would terminate
// the embedding process).
constexpr uint32_t kMaxEntryBytes = 1u << 20;
constexpr uint64_t kMaxFrameBytes = 1ull << 28;

struct Client {
  int fd = -1;
  // Set on any transport/parse error: the socket may hold unread
  // response bytes, so a retry on the same handle would misparse
  // subsequent frames. Poisoned handles fail fast instead.
  bool dead = false;
};

int poison(Client* c) {
  c->dead = true;
  if (c->fd >= 0) {
    ::close(c->fd);
    c->fd = -1;
  }
  return -1;
}

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t w = ::send(fd, p, n, 0);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void put_u32(std::string& out, uint32_t v) {
  char b[4];
  std::memcpy(b, &v, 4);  // little-endian hosts only (x86/ARM LE)
  out.append(b, 4);
}

}  // namespace

extern "C" {

// Connect over TCP. Returns an opaque handle or null.
void* cap_client_connect(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Client;
  c->fd = fd;
  return c;
}

// Connect over a Unix socket. Returns an opaque handle or null.
void* cap_client_connect_uds(const char* path) {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, path, sizeof(addr.sun_path) - 1);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* c = new Client;
  c->fd = fd;
  return c;
}

// Liveness probe. 1 on pong, 0 on failure.
int cap_client_ping(void* handle) {
  auto* c = static_cast<Client*>(handle);
  if (c->dead) return 0;
  std::string frame;
  put_u32(frame, kMagic);
  frame.push_back(static_cast<char>(kPing));
  put_u32(frame, 0);
  if (!send_all(c->fd, frame.data(), frame.size())) return poison(c), 0;
  uint8_t hdr[9];
  if (!recv_all(c->fd, hdr, 9)) return poison(c), 0;
  if (hdr[4] != kPong) return poison(c), 0;
  return 1;
}

// Verify a batch.
//   tokens/token_lens/count: the batch (UTF-8 compact JWS each).
//   statuses[count]: out, 0 = verified, 1 = rejected.
//   payload_buf/payload_cap: out, concatenated payloads
//     (claims JSON / error string per token).
//   payload_off[count + 1]: out, token i's payload is
//     payload_buf[payload_off[i] .. payload_off[i+1]).
// Returns 0 ok; -1 transport error; -2 payload_buf too small
// (payload_off[count] then holds the required size).
int cap_client_verify(void* handle, const char** tokens,
                      const uint32_t* token_lens, uint32_t count,
                      uint8_t* statuses, char* payload_buf,
                      uint64_t payload_cap, uint64_t* payload_off) {
  auto* c = static_cast<Client*>(handle);
  if (c->dead) return -1;
  std::string frame;
  frame.reserve(9 + 512 * count);
  put_u32(frame, kMagic);
  frame.push_back(static_cast<char>(kVerifyReq));
  put_u32(frame, count);
  for (uint32_t i = 0; i < count; i++) {
    put_u32(frame, token_lens[i]);
    frame.append(tokens[i], token_lens[i]);
  }
  if (!send_all(c->fd, frame.data(), frame.size())) return poison(c);

  uint8_t hdr[9];
  if (!recv_all(c->fd, hdr, 9)) return poison(c);
  uint32_t magic, n;
  std::memcpy(&magic, hdr, 4);
  std::memcpy(&n, hdr + 5, 4);
  if (magic != kMagic || hdr[4] != kVerifyResp || n != count) return poison(c);

  uint64_t off = 0;
  char sink[65536];
  for (uint32_t i = 0; i < count; i++) {
    uint8_t entry[5];
    if (!recv_all(c->fd, entry, 5)) return poison(c);
    uint32_t ln;
    std::memcpy(&ln, entry + 1, 4);
    if (ln > kMaxEntryBytes || off + ln > kMaxFrameBytes) return poison(c);
    statuses[i] = entry[0];
    payload_off[i] = off;
    if (off + ln <= payload_cap) {
      if (!recv_all(c->fd, payload_buf + off, ln)) return poison(c);
    } else {
      // drain in bounded chunks so the connection stays usable, then
      // report the required size via payload_off[count]
      for (uint32_t left = ln; left;) {
        uint32_t take = left < sizeof(sink) ? left : sizeof(sink);
        if (!recv_all(c->fd, sink, take)) return poison(c);
        left -= take;
      }
    }
    off += ln;
  }
  payload_off[count] = off;
  return off <= payload_cap ? 0 : -2;
}

void cap_client_close(void* handle) {
  auto* c = static_cast<Client*>(handle);
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

}  // extern "C"
