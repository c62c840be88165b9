"""Wire protocol for the verify service: length-prefixed binary frames.

The port of ``cap_tpu.serve.protocol``: the same frames, byte for
byte, so a client of either package talks to a worker of the other.
Deliberately trivial to implement from any language: fixed
little-endian framing, no schema compiler.

Frame layout (all integers little-endian):

    magic   u32   0x31425643 ("CVB1")
    type    u8    1 = verify request, 2 = verify response, 3 = ping,
                  4 = pong, 5 = stats request, 6 = stats response,
                  7 = checksummed verify request,
                  8 = checksummed verify response,
                  9 = traced verify request,
                  10 = traced verify response,
                  11 = keys push (keyplane),
                  12 = keys ack (keyplane),
                  13 = peer fill (verdict-cache warming),
                  14 = peer fill ack,
                  15 = shm attach (shared-memory transport),
                  16 = shm attach ack
    count   u32   number of entries
    trace-context (types 9/10 only, between header and entries):
      ctx_len u8   length of the trace-context field (1..64)
      ctx     …    ctx_len bytes: the trace id, lowercase hex ASCII
                   (16 chars as emitted by telemetry.new_trace_id)
    entries:
      request entry:   len u32, token bytes (UTF-8 compact JWS)
      response entry:  status u8 (0 = verified, 1 = rejected),
                       len u32, payload bytes
                       (claims JSON when verified; error string when
                       rejected — the error CLASS name plus message,
                       never the token itself)
      stats response:  exactly one response-shaped entry whose payload
                       is the worker's stats JSON (counts and timings
                       only — redaction discipline applies)
    trailer (types 7/8 only):
      crc32   u32   zlib.crc32 over every frame byte from the magic
                    through the last entry byte

Types 7/8 are the fleet router's integrity envelope: a worker answers
a checksummed request with a checksummed response, so a flipped byte
anywhere in either direction (status, lengths, payload) surfaces as
:class:`FrameCorruptError` instead of a silently wrong verdict. Plain
clients (Go, native, VerifyClient default) keep the exact CVB1 bytes
of types 1-4 — the golden vectors are unchanged.

Types 11/12 are the keyplane's distribution pair, ADDITIVE like 9/10
(types 1-10 keep their exact bytes — the golden vectors pin them):

- **KEYS push (11)**: checksummed, exactly ONE request-shaped entry
  whose payload is the key-distribution JSON
  ``{"epoch": <int>, "jwks": {"keys": [...]}}`` — canonical form
  (sorted keys, compact separators) so identical snapshots serialize
  identically. Public key material only (a JWKS by definition);
  redaction discipline for tokens/claims is untouched.
- **KEYS ack (12)**: checksummed, exactly ONE response-shaped entry:
  status 0 + ``{"epoch": <int>}`` when the worker swapped its tables
  onto the pushed epoch, status 1 + an error string (class name +
  message, never key material) when it could not.

A corrupt push must never install half a key set — the CRC check runs
before the payload is even decoded, same stance as types 7-10.

Types 13/14 are the verdict-cache PEER-FILL pair, ADDITIVE exactly
like the KEYS pair (types 1-12 keep their bytes — the golden vectors
pin them):

- **peer fill (13)**: checksummed, exactly ONE request-shaped entry
  whose payload is the peer-fill JSON in canonical form. Two ops:
  ``{"max": <int>, "op": "export"}`` asks a worker to dump (a bounded
  slice of) its verdict cache; ``{"entries": [...], "epoch": <int>,
  "op": "import"}`` hands a dump to a freshly (re)spawned worker.
  Each entry is ``[digest_hex, payload_b64, valid_from, valid_until,
  exp_or_null]`` — ACCEPTS only, and the receiver re-clamps every
  entry (epoch equality, exp/nbf, its own TTL) so an import can only
  ever SHORTEN a verdict's validity, never extend it
  (:meth:`cap_tpu_torch.serve.vcache.VerdictCache.import_entries`).
- **peer fill ack (14)**: checksummed, exactly ONE response-shaped
  entry: status 0 + the op's result JSON (``{"entries": ..,
  "epoch": ..}`` for export, ``{"imported": N}`` for import), status
  1 + an error string when the worker has no cache tier or the
  payload is unusable.

Secrets stance for 13/14: digests are one-way hashes and payloads are
the claims JSON a verify response would carry anyway — no token ever
crosses in either direction, and error strings stay class+message.

Types 15/16 negotiate the ZERO-COPY shared-memory transport (docs/
SERVE.md §Transports), ADDITIVE exactly like the KEYS pair (types
1-14 keep their bytes — the golden vectors pin them):

- **shm attach (15)**: checksummed, exactly ONE request-shaped entry
  whose payload is the canonical JSON ``{"op": "attach", "path":
  <region file>, "version": 1}``. The CLIENT creates and maps the
  region file (header + request ring + response ring — layout in
  cap_tpu/serve/shm_ring.py, mirrored by runtime/native/shm_ring.h);
  the worker maps the same file and, from the next frame on, consumes
  requests from the request ring and posts responses into the
  response ring. The socket stays open as the LIVENESS channel only.
- **shm attach ack (16)**: checksummed, exactly ONE response-shaped
  entry, sent over the SOCKET (the client confirms the switch before
  producing): status 0 + ``{"transport":"shm"}`` when the worker
  mapped the region, status 1 + an error string when the transport is
  off or the region is unusable — the connection then keeps serving
  over the socket unchanged (``serve.shm_fallbacks``), which is the
  whole fallback contract: a client NEVER loses a connection to a
  refused attach. Workers whose library predates the pair drop the
  connection on the unknown type instead; clients treat that exactly
  like a refusal and redial socket-only.

Types 9/10 are the TRACED variant of 7/8: same checksummed envelope
plus one additive trace-context field between the header and the
entries, so a request's 16-hex trace id crosses the process boundary
and the worker's span records (batcher fill, device dispatch — see
:mod:`cap_tpu_torch.telemetry`) can be joined with the router's client-side
spans into one cross-process timeline. A worker answers a traced
request with a traced response echoing the same trace id. The field
is validated AFTER the CRC matches (like status bytes) and must be
lowercase-hex ASCII — it can never carry payload material. Frame
types 1-8 are byte-identical to before this field existed
(tests/test_conformance.py pins all of them against the committed
golden vectors).

Hardening stance: every length prefix is bound-checked BEFORE any
allocation or read of entry bytes (a hostile or corrupt frame cannot
make the parser allocate unbounded memory), and malformed values
(unknown type, bad magic, nonzero ping/pong count, status byte
outside {0, 1}) raise typed subclasses of :class:`ProtocolError`.
Liveness against a peer that claims N entries and then stalls is the
CALLER's job (socket timeouts / fleet router deadlines) — a blocking
read cannot be both exact and self-timing.

Secrets stance: tokens cross this boundary by necessity (the worker
must verify them); nothing here logs, copies, or echoes them beyond
the response payload, and error strings never embed token material.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

MAGIC = 0x31425643
T_VERIFY_REQ = 1
T_VERIFY_RESP = 2
T_PING = 3
T_PONG = 4
T_STATS_REQ = 5
T_STATS_RESP = 6
T_VERIFY_REQ_CRC = 7
T_VERIFY_RESP_CRC = 8
T_VERIFY_REQ_TRACE = 9
T_VERIFY_RESP_TRACE = 10
T_KEYS_PUSH = 11
T_KEYS_ACK = 12
T_PEER_FILL = 13
T_PEER_ACK = 14
T_SHM_ATTACH = 15
T_SHM_ACK = 16

_HDR = struct.Struct("<IBI")

MAX_FRAME_ENTRIES = 1 << 20
MAX_ENTRY_BYTES = 1 << 20
MAX_FRAME_BYTES = 1 << 28        # aggregate cap: one frame ≤ 256 MiB
MAX_TRACE_BYTES = 64             # trace-context field length bound
_TRACE_HEX = frozenset(b"0123456789abcdef")


class ProtocolError(Exception):
    """Base class for CVB1 wire-format violations."""


# ---------------------------------------------------------------------------
# admission pushback: the wire encoding is ADDITIVE on the
# existing status-1 response entry — a throttled token's payload is
# the ordinary "<ErrorClass>: <message>" error string whose class head
# is ``ThrottledError`` and whose message carries a machine-parseable
# ``retry_after_ms=<int>`` hint. Frames stay byte-identical when
# admission is off (no throttled entries then), so every committed
# golden vector is untouched and stale clients simply see one more
# rejected-token error class.
# ---------------------------------------------------------------------------

_RETRY_AFTER_RE = None


def is_throttled_payload(payload: str) -> bool:
    """Whether a status-1 entry's error string is an admission
    pushback (class head ``ThrottledError``) rather than a verify
    verdict."""
    return payload.startswith("ThrottledError")


def retry_after_hint(payload: str) -> Optional[float]:
    """Parse the additive ``retry_after_ms=<int>`` hint out of a
    pushback payload → seconds, or None when absent/unparseable.
    Never raises: a garbled hint degrades to "no hint", the same
    stance as every other additive field."""
    global _RETRY_AFTER_RE
    if _RETRY_AFTER_RE is None:
        import re

        _RETRY_AFTER_RE = re.compile(r"retry_after_ms=(\d{1,9})")
    m = _RETRY_AFTER_RE.search(payload)
    if not m:
        return None
    return int(m.group(1)) / 1000.0


class MalformedFrameError(ProtocolError):
    """Structurally invalid frame: bad magic, unknown type, nonzero
    ping/pong count, or a response status byte outside {0, 1}."""


class FrameTooLargeError(ProtocolError):
    """A length prefix or entry count exceeds the protocol bounds.

    Raised BEFORE any allocation for the oversized region — a hostile
    length (e.g. 0xFFFFFFFF, a "negative" i32) costs nothing."""


class FrameCorruptError(ProtocolError):
    """A checksummed frame's CRC32 trailer does not match its bytes."""


_LEN_U32 = struct.Struct("<I")
_LEN_BU32 = struct.Struct("<BI")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return bytes(buf)


def _with_crc(parts: List[bytes]) -> List[bytes]:
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    parts.append(_LEN_U32.pack(crc & 0xFFFFFFFF))
    return parts


def _trace_field(trace: str) -> bytes:
    raw = trace.encode("ascii")
    if not (0 < len(raw) <= MAX_TRACE_BYTES
            and all(b in _TRACE_HEX for b in raw)):
        raise MalformedFrameError(
            f"invalid trace id ({len(raw)} bytes; must be 1..:"
            f"{MAX_TRACE_BYTES} lowercase-hex chars)")
    return bytes([len(raw)]) + raw


def send_request(sock: socket.socket, tokens: Sequence[str],
                 crc: bool = False, trace: Optional[str] = None) -> None:
    """trace: a telemetry trace id; selects the traced checksummed
    frame (type 9) carrying the trace-context field."""
    ftype = (T_VERIFY_REQ_TRACE if trace is not None
             else T_VERIFY_REQ_CRC if crc else T_VERIFY_REQ)
    parts = [_HDR.pack(MAGIC, ftype, len(tokens))]
    if trace is not None:
        parts.append(_trace_field(trace))
    for t in tokens:
        raw = t.encode()
        parts.append(struct.pack("<I", len(raw)))
        parts.append(raw)
    if trace is not None or crc:
        _with_crc(parts)
    sock.sendall(b"".join(parts))


def _response_parts(ftype: int, results: Sequence[Any]) -> List[bytes]:
    parts = [_HDR.pack(MAGIC, ftype, len(results))]
    for r in results:
        if isinstance(r, Exception):
            payload = f"{type(r).__name__}: {r}".encode()
            parts.append(struct.pack("<BI", 1, len(payload)))
        elif isinstance(r, (bytes, bytearray, memoryview)):
            payload = bytes(r)
            parts.append(struct.pack("<BI", 0, len(payload)))
        else:
            payload = json.dumps(r, separators=(",", ":")).encode()
            parts.append(struct.pack("<BI", 0, len(payload)))
        parts.append(payload)
    return parts


def send_response(sock: socket.socket, results: Sequence[Any],
                  crc: bool = False, trace: Optional[str] = None) -> None:
    """results: claims (dict, or the raw payload-JSON bytes the worker
    verified — sent verbatim, zero re-serialization) or Exception.
    trace: echo of the request's trace id (traced frame, type 10)."""
    if trace is not None:
        parts = _response_parts(T_VERIFY_RESP_TRACE, results)
        parts.insert(1, _trace_field(trace))
        _with_crc(parts)
    elif crc:
        parts = _with_crc(_response_parts(T_VERIFY_RESP_CRC, results))
    else:
        parts = _response_parts(T_VERIFY_RESP, results)
    sock.sendall(b"".join(parts))


def encode_response(results: Sequence[Any], crc: bool = False,
                    trace: Optional[str] = None) -> bytes:
    """Encoded verify-response frame bytes (same family selection as
    :func:`send_response`). The native front-door gate posts these
    verbatim through ``cap_frontdoor_post_raw`` for slow-path frames,
    so the socket writer and the relay writer share one encoder."""
    if trace is not None:
        parts = _response_parts(T_VERIFY_RESP_TRACE, results)
        parts.insert(1, _trace_field(trace))
        _with_crc(parts)
    elif crc:
        parts = _with_crc(_response_parts(T_VERIFY_RESP_CRC, results))
    else:
        parts = _response_parts(T_VERIFY_RESP, results)
    return b"".join(parts)


def send_ping(sock: socket.socket) -> None:
    sock.sendall(_HDR.pack(MAGIC, T_PING, 0))


def send_pong(sock: socket.socket) -> None:
    sock.sendall(_HDR.pack(MAGIC, T_PONG, 0))


def send_stats_request(sock: socket.socket) -> None:
    sock.sendall(_HDR.pack(MAGIC, T_STATS_REQ, 0))


def encode_stats_response(stats: Any) -> bytes:
    """Encoded stats-response frame bytes (one response-shaped entry
    carrying the stats JSON object). The native serve chain posts
    these verbatim, so both chains share one encoder."""
    payload = json.dumps(stats, separators=(",", ":")).encode()
    return (_HDR.pack(MAGIC, T_STATS_RESP, 1)
            + struct.pack("<BI", 0, len(payload)) + payload)


def send_stats_response(sock: socket.socket, stats: Any) -> None:
    """One response-shaped entry carrying the stats JSON object."""
    sock.sendall(encode_stats_response(stats))


def keys_payload(jwks_doc: Dict[str, Any], epoch: int) -> bytes:
    """Canonical KEYS-push payload bytes: sorted keys + compact
    separators, so one snapshot has one wire encoding (golden vectors
    and dedup both rely on it)."""
    return json.dumps({"epoch": int(epoch), "jwks": jwks_doc},
                      separators=(",", ":"), sort_keys=True).encode()


def send_keys_push(sock: socket.socket, jwks_doc: Dict[str, Any],
                   epoch: int) -> None:
    """Checksummed KEYS push (type 11): one entry, the epoch+JWKS JSON."""
    payload = keys_payload(jwks_doc, epoch)
    if len(payload) > MAX_ENTRY_BYTES:
        raise FrameTooLargeError(
            f"keys payload {len(payload)} bytes exceeds entry bound")
    parts = [_HDR.pack(MAGIC, T_KEYS_PUSH, 1),
             _LEN_U32.pack(len(payload)), payload]
    sock.sendall(b"".join(_with_crc(parts)))


def encode_keys_ack(epoch: Optional[int] = None,
                    error: Optional[str] = None) -> bytes:
    """Encoded checksummed KEYS-ack frame bytes (type 12): status 0 +
    {"epoch": N} on a successful swap, status 1 + error string
    otherwise. Shared by the socket sender and the native chain."""
    if error is None:
        status, payload = 0, json.dumps(
            {"epoch": int(epoch or 0)}, separators=(",", ":")).encode()
    else:
        status, payload = 1, error.encode()
    parts = [_HDR.pack(MAGIC, T_KEYS_ACK, 1),
             _LEN_BU32.pack(status, len(payload)), payload]
    return b"".join(_with_crc(parts))


def send_keys_ack(sock: socket.socket, epoch: Optional[int] = None,
                  error: Optional[str] = None) -> None:
    """Checksummed KEYS ack (type 12): status 0 + {"epoch": N} on a
    successful swap, status 1 + error string otherwise."""
    sock.sendall(encode_keys_ack(epoch=epoch, error=error))


def peer_fill_payload(doc: Dict[str, Any]) -> bytes:
    """Canonical peer-fill payload bytes (sorted keys + compact
    separators — one document, one wire encoding, exactly like
    :func:`keys_payload`)."""
    return json.dumps(doc, separators=(",", ":"),
                      sort_keys=True).encode()


def send_peer_fill(sock: socket.socket, doc: Dict[str, Any]) -> None:
    """Checksummed peer-fill frame (type 13): one entry, the op JSON
    (``op=export`` request or ``op=import`` push)."""
    payload = peer_fill_payload(doc)
    if len(payload) > MAX_ENTRY_BYTES:
        raise FrameTooLargeError(
            f"peer-fill payload {len(payload)} bytes exceeds entry "
            "bound")
    parts = [_HDR.pack(MAGIC, T_PEER_FILL, 1),
             _LEN_U32.pack(len(payload)), payload]
    sock.sendall(b"".join(_with_crc(parts)))


def encode_peer_ack(doc: Optional[Dict[str, Any]] = None,
                    error: Optional[str] = None) -> bytes:
    """Encoded checksummed peer-fill ack (type 14): status 0 + the
    op's result JSON, status 1 + error string. Shared by the socket
    sender and the native chain's control path."""
    if error is None:
        status = 0
        payload = json.dumps(doc if doc is not None else {},
                             separators=(",", ":"),
                             sort_keys=True).encode()
    else:
        status, payload = 1, error.encode()
    if len(payload) > MAX_ENTRY_BYTES:
        raise FrameTooLargeError(
            f"peer-fill ack payload {len(payload)} bytes exceeds "
            "entry bound")
    parts = [_HDR.pack(MAGIC, T_PEER_ACK, 1),
             _LEN_BU32.pack(status, len(payload)), payload]
    return b"".join(_with_crc(parts))


def send_peer_ack(sock: socket.socket,
                  doc: Optional[Dict[str, Any]] = None,
                  error: Optional[str] = None) -> None:
    sock.sendall(encode_peer_ack(doc=doc, error=error))


def shm_attach_payload(path: str) -> bytes:
    """Canonical shm-attach payload bytes (sorted keys + compact
    separators — one request, one wire encoding, exactly like
    :func:`keys_payload`). The JAX package's native client and the Go
    client build the same string by hand; this function is the
    reference."""
    return json.dumps({"op": "attach", "path": path, "version": 1},
                      separators=(",", ":"), sort_keys=True).encode()


def send_shm_attach(sock: socket.socket, path: str) -> None:
    """Checksummed shm-attach frame (type 15): one entry, the region
    path JSON. The region file must already exist and carry a valid
    header — the worker maps it before acking."""
    payload = shm_attach_payload(path)
    if len(payload) > MAX_ENTRY_BYTES:
        raise FrameTooLargeError(
            f"shm-attach payload {len(payload)} bytes exceeds entry "
            "bound")
    parts = [_HDR.pack(MAGIC, T_SHM_ATTACH, 1),
             _LEN_U32.pack(len(payload)), payload]
    sock.sendall(b"".join(_with_crc(parts)))


def encode_shm_ack(error: Optional[str] = None) -> bytes:
    """Encoded checksummed shm ack (type 16): status 0 +
    {"transport":"shm"} when the worker mapped the region, status 1 +
    error string otherwise. Shared by the socket sender and the native
    chain (serve_native.cpp shm_ack_frame mirrors it byte-for-byte)."""
    if error is None:
        status, payload = 0, b'{"transport":"shm"}'
    else:
        status, payload = 1, error.encode()
    parts = [_HDR.pack(MAGIC, T_SHM_ACK, 1),
             _LEN_BU32.pack(status, len(payload)), payload]
    return b"".join(_with_crc(parts))


def send_shm_ack(sock: socket.socket,
                 error: Optional[str] = None) -> None:
    sock.sendall(encode_shm_ack(error=error))


def recv_frame(sock: socket.socket) -> Tuple[int, List[Any]]:
    """Read one frame → (type, entries), exact reads (no buffering).

    Request entries are token strings; response entries are
    (status, payload-bytes) pairs. Hot loops should use
    :class:`FrameReader` instead — this per-entry exact-read form
    costs two syscalls and two allocations per entry and measured
    374k tokens/s on one core vs FrameReader's buffered parse in the
    JAX package's measurement; it stays for one-shot uses
    and as the simplest reference of the wire format.
    """
    ftype, entries, _ = _parse_frame(lambda n: _recv_exact(sock, n))
    return ftype, entries


def recv_frame_ex(sock: socket.socket) -> Tuple[int, List[Any],
                                                Optional[str]]:
    """Like :func:`recv_frame`, also returning the trace id carried by
    a traced frame (types 9/10; None for every other type)."""
    return _parse_frame(lambda n: _recv_exact(sock, n))


def _parse_frame(take) -> Tuple[int, List[Any], Optional[str]]:
    """Shared CVB1 frame parse over a ``take(n) -> bytes`` source →
    (type, entries, trace-id-or-None).

    Every length is validated BEFORE the corresponding ``take`` — the
    parser never allocates for an out-of-bounds prefix. Checksummed
    frame types defer UTF-8 decoding, status validation, and
    trace-context validation until the CRC trailer has matched, so a
    flipped byte anywhere in the frame surfaces as
    :class:`FrameCorruptError`.
    """
    raw_take = take
    hdr = raw_take(_HDR.size)
    magic, ftype, count = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise MalformedFrameError(f"bad magic 0x{magic:08x}")
    if count > MAX_FRAME_ENTRIES:
        raise FrameTooLargeError(f"frame too large: {count} entries")
    checksummed = ftype in (T_VERIFY_REQ_CRC, T_VERIFY_RESP_CRC,
                            T_VERIFY_REQ_TRACE, T_VERIFY_RESP_TRACE,
                            T_KEYS_PUSH, T_KEYS_ACK, T_PEER_FILL,
                            T_PEER_ACK, T_SHM_ATTACH, T_SHM_ACK)
    if ftype in (T_KEYS_PUSH, T_KEYS_ACK, T_PEER_FILL, T_PEER_ACK,
                 T_SHM_ATTACH, T_SHM_ACK) and count != 1:
        raise MalformedFrameError(
            f"type-{ftype} control frame must carry exactly one "
            f"entry, got {count}")
    if checksummed:
        crc_state = [zlib.crc32(hdr)]

        def take(n: int, _t: Callable[[int], bytes] = raw_take) -> bytes:
            b = _t(n)
            crc_state[0] = zlib.crc32(b, crc_state[0])
            return b

    trace_raw: Optional[bytes] = None
    if ftype in (T_VERIFY_REQ_TRACE, T_VERIFY_RESP_TRACE):
        (ctx_len,) = take(1)
        if not 0 < ctx_len <= MAX_TRACE_BYTES:
            raise MalformedFrameError(
                f"trace-context length {ctx_len} outside 1..:"
                f"{MAX_TRACE_BYTES}")
        trace_raw = take(ctx_len)

    entries: List[Any] = []
    total = 0
    u32 = _LEN_U32.unpack
    bu32 = _LEN_BU32.unpack
    if ftype in (T_VERIFY_REQ, T_VERIFY_REQ_CRC, T_VERIFY_REQ_TRACE,
                 T_KEYS_PUSH, T_PEER_FILL, T_SHM_ATTACH):
        for _ in range(count):
            (ln,) = u32(take(4))
            total += ln
            if ln > MAX_ENTRY_BYTES or total > MAX_FRAME_BYTES:
                raise FrameTooLargeError(f"frame too large ({total} bytes)")
            entries.append(take(ln))
    elif ftype in (T_VERIFY_RESP, T_VERIFY_RESP_CRC,
                   T_VERIFY_RESP_TRACE, T_STATS_RESP, T_KEYS_ACK,
                   T_PEER_ACK, T_SHM_ACK):
        for _ in range(count):
            status, ln = bu32(take(5))
            if not checksummed and status not in (0, 1):
                raise MalformedFrameError(f"bad status byte {status}")
            total += ln
            if ln > MAX_ENTRY_BYTES or total > MAX_FRAME_BYTES:
                raise FrameTooLargeError(f"frame too large ({total} bytes)")
            entries.append((status, take(ln)))
    elif ftype in (T_PING, T_PONG, T_STATS_REQ):
        if count:
            raise MalformedFrameError(
                f"type-{ftype} frame with nonzero count {count}")
    else:
        raise MalformedFrameError(f"unknown frame type {ftype}")

    if checksummed:
        (want,) = u32(raw_take(4))          # trailer: outside the CRC
        if want != (crc_state[0] & 0xFFFFFFFF):
            raise FrameCorruptError(
                f"crc mismatch (frame type {ftype}): wire says "
                f"0x{want:08x}")
        for e in entries:                   # deferred status validation
            if isinstance(e, tuple) and e[0] not in (0, 1):
                raise MalformedFrameError(f"bad status byte {e[0]}")
    trace: Optional[str] = None
    if trace_raw is not None:
        # Validated AFTER integrity, like status bytes: the field is a
        # registered-charset identifier, never payload material.
        if not all(b in _TRACE_HEX for b in trace_raw):
            raise MalformedFrameError("trace-context not lowercase hex")
        trace = trace_raw.decode("ascii")
    if ftype in (T_VERIFY_REQ, T_VERIFY_REQ_CRC, T_VERIFY_REQ_TRACE):
        # Token decode AFTER integrity: corruption inside a checksummed
        # frame can never masquerade as a different (valid) token.
        entries = [e.decode() for e in entries]
    return ftype, entries, trace


def parse_frame_bytes(data: bytes) -> Tuple[int, List[Any],
                                            Optional[str], int]:
    """Parse ONE complete frame held in a byte buffer →
    (type, entries, trace-id-or-None, bytes consumed).

    Same validation (and the same typed error classes) as the socket
    readers — this is the REFERENCE the native reader's frame parser
    is pinned against: the malformed-frame parity sweep feeds the
    corpus through this function and through
    ``cap_serve_probe_frame`` and asserts identical error classes.
    A buffer that ends mid-frame raises :class:`ConnectionError`,
    matching a peer that closed mid-frame on the stream paths.
    """
    pos = 0

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(data):
            raise ConnectionError("peer closed mid-frame")
        b = data[pos: pos + n]
        pos += n
        return b

    ftype, entries, trace = _parse_frame(take)
    return ftype, entries, trace, pos


# Native parse-status → Python error class: the shared frame-rejection
# contract (serve_native.cpp PF_* codes). Status 0 is success, 4 means
# "incomplete frame" (the stream readers just keep reading; the probe
# maps it onto the same ConnectionError parse_frame_bytes raises).
NATIVE_STATUS_ERRORS = {
    1: MalformedFrameError,
    2: FrameTooLargeError,
    3: FrameCorruptError,
    4: ConnectionError,
    5: UnicodeDecodeError,
}


class FrameReader:
    """Buffered CVB1 frame reader: one ~64 KiB recv instead of two
    syscalls per entry.

    The wire has no frame-length prefix, so buffered reads can consume
    the start of the NEXT frame — leftover bytes are retained across
    calls, which means a socket must be read EXCLUSIVELY through one
    FrameReader once attached (the worker's reader thread and the
    client already own their sockets' read sides exclusively).
    """

    __slots__ = ("_sock", "_buf", "_off", "hwm")

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""
        self._off = 0
        # buffered-bytes high-water mark: the most bytes this reader
        # ever held at once (the per-connection memory figure)
        self.hwm = 0

    def _take(self, n: int) -> bytes:
        buf, off = self._buf, self._off
        if len(buf) - off < n:
            parts = [buf[off:]] if off < len(buf) else []
            got = len(buf) - off
            while got < n:
                chunk = self._sock.recv(max(n - got, 1 << 16))
                if not chunk:
                    raise ConnectionError("peer closed mid-frame")
                parts.append(chunk)
                got += len(chunk)
            buf = b"".join(parts)
            off = 0
            self._buf = buf
            if len(buf) > self.hwm:
                self.hwm = len(buf)
        self._off = off + n
        return buf[off:off + n]

    def recv_frame(self) -> Tuple[int, List[Any]]:
        ftype, entries, _ = self.recv_frame_ex()
        return ftype, entries

    def recv_frame_ex(self) -> Tuple[int, List[Any], Optional[str]]:
        """(type, entries, trace-id-or-None) — the trace id is non-None
        only for traced frames (types 9/10)."""
        out = _parse_frame(self._take)
        # Drop the consumed prefix so an idle connection never pins a
        # whole parsed frame (frames may be up to MAX_FRAME_BYTES).
        if self._off:
            self._buf = self._buf[self._off:]
            self._off = 0
        return out
