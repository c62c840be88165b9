// shm_ring — shared-memory CVB1 transport region (fifth TU of
// libcapruntime.so). Declarations shared with serve_native.cpp, which
// consumes request frames straight from the mapped region (zero recv,
// zero copy before the Req blob) and posts responses into the paired
// response ring.
//
// REGION LAYOUT (one file per connection, created by the CLIENT; all
// integers little-endian; the header is one page so the rings start
// page-aligned). cap_tpu/serve/shm_ring.py mirrors these constants —
// the Python client/server and the Go client speak the same bytes.
//
//   off 0    magic     u64   "CAPSHMR1" (0x31524D4853504143)
//   off 8    version   u32   1
//   off 12   gen       u32   client generation stamp (nonzero);
//                            every record carries it — a record from
//                            another generation is STALE and rejected
//   off 16   req_off   u64   = HDR_SIZE
//   off 24   req_size  u64   power of two, [MIN_RING, MAX_RING]
//   off 32   resp_off  u64   = HDR_SIZE + req_size
//   off 40   resp_size u64   power of two, [MIN_RING, MAX_RING]
//   off 64   req_head  u64   request-ring producer cursor (client)
//   off 128  req_tail  u64   request-ring consumer cursor (worker)
//   off 192  resp_head u64   response-ring producer cursor (worker)
//   off 256  resp_tail u64   response-ring consumer cursor (client)
//
// Head/tail are monotonically increasing BYTE counters (offset =
// cursor & (size-1)); each lives alone on its own cache line. Records
// are 8-byte aligned: [len u32][gen u32][payload…pad]. len=0xFFFFFFFF
// is a WRAP marker: the producer could not fit the record before the
// ring's end and skipped to offset 0 — the consumer advances its
// cursor by the same amount. The producer writes payload bytes FIRST
// and publishes with a release store of head, so a producer killed
// mid-write (kill -9) leaves the record invisible: the consumer can
// never observe a torn frame. What it CAN observe — a cursor pushed
// past the ring size, an impossible length, a foreign generation — is
// classified exactly like the socket parser's malformed classes.
#ifndef CAP_SHM_RING_H
#define CAP_SHM_RING_H

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace cap_shm {

static const uint64_t MAGIC = 0x31524D4853504143ull;  // "CAPSHMR1"
static const uint32_t VERSION = 1;
static const uint64_t HDR_SIZE = 4096;
static const uint64_t MIN_RING = 4096;
static const uint64_t MAX_RING = 1ull << 30;
static const uint32_t WRAP = 0xFFFFFFFFu;

// header field offsets (bytes)
enum {
  OFF_MAGIC = 0,
  OFF_VERSION = 8,
  OFF_GEN = 12,
  OFF_REQ_OFF = 16,
  OFF_REQ_SIZE = 24,
  OFF_RESP_OFF = 32,
  OFF_RESP_SIZE = 40,
  OFF_REQ_HEAD = 64,
  OFF_REQ_TAIL = 128,
  OFF_RESP_HEAD = 192,
  OFF_RESP_TAIL = 256,
};

enum { RING_REQ = 0, RING_RESP = 1 };

// poll_record outcomes (<0 mirror serve_native's PF_* classes so the
// caller can count/classify without a translation table)
enum {
  SHM_EMPTY = 0,
  SHM_RECORD = 1,
  SHM_MALFORMED = -1,   // overrun cursor / impossible length
  SHM_TOOLARGE = -2,    // record larger than the ring allows
  SHM_STALE_GEN = -3,   // record stamped by another generation
  SHM_ABORTED = -4,     // write gave up (peer gone / shutdown)
};

struct Region {
  uint8_t* base = nullptr;
  uint64_t map_len = 0;
  uint64_t ring_off[2] = {0, 0};
  uint64_t ring_size[2] = {0, 0};
  uint32_t gen = 0;
  char path[512];
};

// Map an existing region file and validate its header; returns null
// with a short reason in err (when given). The worker side.
Region* map_region(const char* path, char* err, size_t err_len);

// Create + initialize a region file (the client side; also what the
// native bench driver and the chaos tests use).
Region* create_region(const char* path, uint64_t req_size,
                      uint64_t resp_size, uint32_t gen);

void close_region(Region* r, bool unlink_file);

// Validate a region file's header without keeping a mapping:
// 0 = ok, else a PF-style status (1 malformed / 2 too large).
int32_t probe_region(const char* path);

// Consumer: peek the next record of `ring`. SHM_RECORD → *data/*len
// point INTO the mapped region (valid until consume_record); SHM_EMPTY
// → nothing published; <0 → the ring is poisoned (see enum above).
// Wrap markers are skipped internally.
int poll_record(Region* r, int ring, const uint8_t** data,
                uint64_t* len);

// Advance the consumer cursor past the record poll_record returned.
void consume_record(Region* r, int ring);

// Producer: append one record (blocking while the ring is full).
// abort(ctx) is polled while waiting; returns 0 on success,
// SHM_TOOLARGE when the record can never fit, SHM_ABORTED when the
// abort callback fired.
typedef bool (*AbortFn)(void* ctx);
int write_record(Region* r, int ring, const uint8_t* data,
                 uint64_t len, AbortFn abort, void* ctx);

// Largest payload write_record accepts for this ring.
uint64_t max_record(const Region* r, int ring);

}  // namespace cap_shm

#endif  // CAP_SHM_RING_H
