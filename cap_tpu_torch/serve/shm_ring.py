"""Pure-Python side of the shared-memory CVB1 transport region.

The port of ``cap_tpu.serve.shm_ring``, byte for byte the same layout,
so a region one package writes the other reads. One region file per
connection, created by the CLIENT, mapped by the worker. Layout (all
little-endian; mirrored by ``runtime/native/shm_ring.h`` — the native
readers and the Go client speak the same bytes):

.. code-block:: text

    off 0     magic      u64   "CAPSHMR1"
    off 8     version    u32   1
    off 12    gen        u32   client generation stamp (nonzero)
    off 16    req_off    u64   = 4096 (one page of header)
    off 24    req_size   u64   power of two
    off 32    resp_off   u64   = 4096 + req_size
    off 40    resp_size  u64   power of two
    off 64    req_head   u64   request-ring producer cursor (client)
    off 128   req_tail   u64   request-ring consumer cursor (worker)
    off 192   resp_head  u64   response-ring producer cursor (worker)
    off 256   resp_tail  u64   response-ring consumer cursor (client)

Head/tail are monotonically increasing byte counters; ``offset =
cursor & (size - 1)``. Records are 8-byte aligned: ``[len u32]
[gen u32][payload … pad]``; ``len == 0xFFFFFFFF`` is a WRAP marker
(the producer skipped the ring's tail end). The producer writes the
payload FIRST and publishes by storing head LAST, so a producer
killed mid-write never publishes a torn record. What a consumer CAN
observe — an overrun cursor, an impossible length, a record stamped
by a foreign generation — raises the SAME typed classes as the socket
parser's malformed frames, so both transports share one rejection
taxonomy (:class:`StaleGenerationError` is a
:class:`~cap_tpu_torch.serve.protocol.MalformedFrameError`).

This module is deliberately dependency-free (mmap + struct): it is
the implementation the Python shm client and the python-serve-chain
worker share. The native chain's side lives in ``shm_ring.cpp`` with
real atomics; CPython's 8-byte aligned writes into an mmap are a
single memcpy on x86-64, atomic enough for the cursor protocol at
Python speeds. ``default_dir`` takes the directory as an argument
where the JAX package reads ``CAP_SHM_DIR``.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
from typing import Optional

from . import protocol

MAGIC = 0x31524D4853504143          # "CAPSHMR1"
VERSION = 1
HDR_SIZE = 4096
MIN_RING = 4096
MAX_RING = 1 << 30
WRAP = 0xFFFFFFFF

OFF_MAGIC = 0
OFF_VERSION = 8
OFF_GEN = 12
OFF_REQ_OFF = 16
OFF_REQ_SIZE = 24
OFF_RESP_OFF = 32
OFF_RESP_SIZE = 40
_CURSORS = {
    ("req", "head"): 64,
    ("req", "tail"): 128,
    ("resp", "head"): 192,
    ("resp", "tail"): 256,
}

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_REC = struct.Struct("<II")


class ShmFormatError(protocol.MalformedFrameError):
    """The region file's header is not a valid CAPSHMR1 layout."""


class StaleGenerationError(protocol.MalformedFrameError):
    """A ring record stamped by a foreign generation — a recycled or
    corrupted region. Counted (``serve.shm.stale_gen``) and fatal for
    the transport, exactly like a malformed socket frame."""


def _pow2_ok(v: int) -> bool:
    return MIN_RING <= v <= MAX_RING and (v & (v - 1)) == 0


def default_dir(shm_dir: Optional[str] = None) -> str:
    """Where region files live: ``shm_dir``, else ``/dev/shm`` when
    present (a real shared-memory tmpfs), else the tmp dir."""
    if shm_dir:
        return shm_dir
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    import tempfile

    return tempfile.gettempdir()


class ShmRegion:
    """One mapped region (create = client side, open = worker side)."""

    def __init__(self, path: str, mm: mmap.mmap, created: bool):
        self.path = path
        self._mm = mm
        self.created = created
        self.gen = _U32.unpack_from(mm, OFF_GEN)[0]
        self.ring_off = {
            "req": _U64.unpack_from(mm, OFF_REQ_OFF)[0],
            "resp": _U64.unpack_from(mm, OFF_RESP_OFF)[0],
        }
        self.ring_size = {
            "req": _U64.unpack_from(mm, OFF_REQ_SIZE)[0],
            "resp": _U64.unpack_from(mm, OFF_RESP_SIZE)[0],
        }
        self._closed = False

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, path: str, req_size: int = 1 << 20,
               resp_size: int = 1 << 20,
               gen: Optional[int] = None) -> "ShmRegion":
        if not _pow2_ok(req_size) or not _pow2_ok(resp_size):
            raise ValueError("ring sizes must be powers of two in "
                             f"[{MIN_RING}, {MAX_RING}]")
        if gen is None:
            gen = (int.from_bytes(os.urandom(4), "little") | 1) \
                & 0xFFFFFFFF
        if not 0 < gen <= 0xFFFFFFFF:
            raise ValueError("generation must be a nonzero u32")
        total = HDR_SIZE + req_size + resp_size
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        _U32.pack_into(mm, OFF_VERSION, VERSION)
        _U32.pack_into(mm, OFF_GEN, gen)
        _U64.pack_into(mm, OFF_REQ_OFF, HDR_SIZE)
        _U64.pack_into(mm, OFF_REQ_SIZE, req_size)
        _U64.pack_into(mm, OFF_RESP_OFF, HDR_SIZE + req_size)
        _U64.pack_into(mm, OFF_RESP_SIZE, resp_size)
        # magic LAST: a racing reader never sees a half-written header
        _U64.pack_into(mm, OFF_MAGIC, MAGIC)
        return cls(path, mm, created=True)

    @classmethod
    def open(cls, path: str) -> "ShmRegion":
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            if size < HDR_SIZE or size > HDR_SIZE + 2 * MAX_RING:
                raise ShmFormatError(
                    f"bad region file size {size}")
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        try:
            if _U64.unpack_from(mm, OFF_MAGIC)[0] != MAGIC:
                raise ShmFormatError("bad shm magic")
            if _U32.unpack_from(mm, OFF_VERSION)[0] != VERSION:
                raise ShmFormatError("unsupported shm version")
            if _U32.unpack_from(mm, OFF_GEN)[0] == 0:
                raise ShmFormatError("zero generation")
            req_off = _U64.unpack_from(mm, OFF_REQ_OFF)[0]
            req_size = _U64.unpack_from(mm, OFF_REQ_SIZE)[0]
            resp_off = _U64.unpack_from(mm, OFF_RESP_OFF)[0]
            resp_size = _U64.unpack_from(mm, OFF_RESP_SIZE)[0]
            if not _pow2_ok(req_size) or not _pow2_ok(resp_size):
                raise ShmFormatError("ring size out of bounds")
            if (req_off != HDR_SIZE
                    or resp_off != HDR_SIZE + req_size
                    or size < HDR_SIZE + req_size + resp_size):
                raise ShmFormatError("ring offsets inconsistent")
        except ShmFormatError:
            mm.close()
            raise
        return cls(path, mm, created=False)

    # -- cursors -----------------------------------------------------------

    def cursor(self, ring: str, side: str) -> int:
        return _U64.unpack_from(self._mm, _CURSORS[(ring, side)])[0]

    def set_cursor(self, ring: str, side: str, value: int) -> None:
        # NEVER struct.pack_into here: it ZERO-FILLS the destination
        # before writing the bytes, so a concurrent reader in the
        # OTHER process can observe the cursor transit through 0 — a
        # torn publish the native consumer rightly classifies as an
        # overrun (measured: ~16 zero-sightings per 2×10⁹ reads).
        # Slice assignment is one 8-byte memcpy: no intermediate state
        # was ever observed under the same probe.
        off = _CURSORS[(ring, side)]
        self._mm[off:off + 8] = (value & 0xFFFFFFFFFFFFFFFF).to_bytes(
            8, "little")

    def close(self, unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass  # exported views die with the process
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def max_record(self, ring: str) -> int:
        return self.ring_size[ring] // 2


class RingProducer:
    """SPSC producer over one of a region's rings.

    ``sendall`` aliases ``write`` so a producer duck-types as the
    ``sock`` argument of every ``protocol.send_*`` helper (each sends
    exactly one complete frame in one ``sendall`` call) — the worker's
    responder loop and the shm client swap a socket for a ring without
    touching the encoders.
    """

    def __init__(self, region: ShmRegion, ring: str,
                 timeout: float = 30.0):
        self._r = region
        self._ring = ring
        self._size = region.ring_size[ring]
        self._off = region.ring_off[ring]
        self.timeout = timeout

    def write(self, data: bytes, timeout: Optional[float] = None,
              abort=None) -> None:
        r, size = self._r, self._size
        n = len(data)
        if n > size // 2:
            raise protocol.FrameTooLargeError(
                f"frame of {n} bytes exceeds shm ring capacity "
                f"({size // 2})")
        adv = 8 + ((n + 7) & ~7)
        mm = r._mm
        if timeout is None:
            timeout = self.timeout
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while True:
            head = r.cursor(self._ring, "head")
            tail = r.cursor(self._ring, "tail")
            off = head & (size - 1)
            wrap_skip = size - off if size - off < adv else 0
            if size - (head - tail) >= wrap_skip + adv:
                break
            if abort is not None and abort():
                raise ConnectionError("shm peer gone (write aborted)")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm ring full (peer not reading)")
            time.sleep(0.0002)
        base = self._off
        if wrap_skip:
            _REC.pack_into(mm, base + off, WRAP, r.gen)
            head += wrap_skip
            off = 0
            r.set_cursor(self._ring, "head", head)
        _REC.pack_into(mm, base + off, n, r.gen)
        mm[base + off + 8: base + off + 8 + n] = data
        r.set_cursor(self._ring, "head", head + adv)

    # protocol.send_* compatibility
    sendall = write


class RingConsumer:
    """SPSC consumer over one of a region's rings; raises the socket
    parser's typed classes on anything a hostile producer can make
    visible."""

    def __init__(self, region: ShmRegion, ring: str):
        self._r = region
        self._ring = ring
        self._size = region.ring_size[ring]
        self._off = region.ring_off[ring]

    def read(self, timeout: float = 0.05) -> Optional[bytes]:
        """Next record's payload bytes (a complete CVB1 frame), or
        None when nothing was published within ``timeout``."""
        r, size = self._r, self._size
        mm = r._mm
        deadline = time.monotonic() + timeout
        while True:
            head = r.cursor(self._ring, "head")
            tail = r.cursor(self._ring, "tail")
            if head != tail:
                if head - tail > size or tail & 7 or head - tail < 8:
                    raise protocol.MalformedFrameError(
                        "shm ring cursor overran the ring")
                off = tail & (size - 1)
                base = self._off
                rec_len, rec_gen = _REC.unpack_from(mm, base + off)
                if rec_len == WRAP:
                    if rec_gen != r.gen:
                        raise StaleGenerationError(
                            f"wrap marker from generation {rec_gen}")
                    skip = size - off
                    if head - tail < skip:
                        raise protocol.MalformedFrameError(
                            "shm wrap marker overruns published bytes")
                    r.set_cursor(self._ring, "tail", tail + skip)
                    continue
                if rec_len > size // 2:
                    raise protocol.FrameTooLargeError(
                        f"shm record of {rec_len} bytes exceeds ring "
                        "bound")
                adv = 8 + ((rec_len + 7) & ~7)
                if adv > size - off or head - tail < adv:
                    raise protocol.MalformedFrameError(
                        "shm record claims unpublished bytes")
                if rec_gen != r.gen:
                    raise StaleGenerationError(
                        f"record from generation {rec_gen}")
                data = bytes(mm[base + off + 8:
                                base + off + 8 + rec_len])
                r.set_cursor(self._ring, "tail", tail + adv)
                return data
            if time.monotonic() > deadline:
                return None
            time.sleep(0.0002)
