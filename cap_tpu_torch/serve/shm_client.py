"""Python client for the zero-copy shared-memory transport.

The port of ``cap_tpu.serve.shm_client``. Mirrors
:class:`~cap_tpu_torch.serve.client.VerifyClient`'s surface
(``verify_batch`` / ``verify_stream`` / ``ping`` / ``stats`` /
``close``, and its ``raw`` flag) but moves every
frame through the mmap'd ring pair once the worker acks the attach —
the socket stays open purely as the liveness channel. The frames
themselves are byte-identical to the socket transport's (the SAME
``protocol.send_*`` encoders write into the ring), so everything
above the transport — checksums, traced requests, verdict parsing —
is untouched.

The attach contract is the wire's: a worker that refuses the attach
(transport off, region unusable) acks status 1 and this client keeps
the SOCKET transport on the same connection; a worker whose parser
predates frame type 15 drops the connection instead, and this client
redials socket-only. Either way the caller gets a working client —
``transport`` says which one, ``attach_error`` why — and the refusal
is counted (``shm.client_fallbacks``).
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, List, Optional, Sequence

from .. import telemetry
from . import protocol
from .client import RemoteVerifyError
from .shm_ring import RingConsumer, RingProducer, ShmRegion, default_dir


class ShmVerifyClient:
    """Blocking client over the shm ring transport (socket fallback).

    host/port or uds_path address the worker's serve socket exactly
    like VerifyClient; ``ring_bytes`` sizes each ring (one request +
    one response ring per connection; a frame may take half a ring);
    ``shm_dir`` is where the region file lives (default: /dev/shm,
    else the tmp dir). ``raw=True`` yields an accepted token's payload
    bytes in place of the parsed dict, as ``VerifyClient(raw=True)``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 uds_path: Optional[str] = None, timeout: float = 30.0,
                 crc: bool = False, ring_bytes: int = 1 << 20,
                 shm_dir: Optional[str] = None, raw: bool = False):
        self._crc = crc
        self._raw = raw
        self._timeout = timeout
        self._addr = (host, port, uds_path)
        self._sock = self._connect()
        self._reader = protocol.FrameReader(self._sock)
        self._region: Optional[ShmRegion] = None
        self._producer: Optional[RingProducer] = None
        self._consumer: Optional[RingConsumer] = None
        self._closed = False
        self.transport = "socket"
        self.attach_error: Optional[str] = None
        self._attach(ring_bytes, shm_dir)

    def _connect(self) -> socket.socket:
        host, port, uds_path = self._addr
        if uds_path is not None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self._timeout)
            s.connect(uds_path)
            return s
        s = socket.create_connection((host, port),
                                     timeout=self._timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _attach(self, ring_bytes: int, shm_dir: Optional[str]) -> None:
        size = 1 << max(12, (ring_bytes - 1).bit_length())
        path = os.path.join(
            default_dir(shm_dir),
            f"cap-shm-{os.getpid()}-{os.urandom(4).hex()}")
        region = None
        try:
            region = ShmRegion.create(path, req_size=size,
                                      resp_size=size)
            protocol.send_shm_attach(self._sock, path)
            ftype, entries, _ = self._reader.recv_frame_ex()
            if ftype != protocol.T_SHM_ACK:
                raise protocol.MalformedFrameError(
                    f"expected shm ack, got type {ftype}")
            status, payload = entries[0]
            if status != 0:
                # negotiated refusal: the worker serves this very
                # connection over the socket — keep it
                self.attach_error = payload.decode(errors="replace")
                telemetry.count("shm.client_fallbacks")
                region.close(unlink=True)
                return
            self._region = region
            self._producer = RingProducer(region, "req")
            self._consumer = RingConsumer(region, "resp")
            self.transport = "shm"
        except (ConnectionError, OSError, protocol.ProtocolError) as e:
            # stale worker dropped the unknown frame type (or died):
            # redial socket-only — attach must never cost the caller
            # a working client
            self.attach_error = f"{type(e).__name__}: {e}"
            telemetry.count("shm.client_fallbacks")
            if region is not None:
                region.close(unlink=True)
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = self._connect()
            self._reader = protocol.FrameReader(self._sock)

    # -- frame transport ---------------------------------------------------

    def _send(self, send_fn, *args, **kw) -> None:
        """Run one protocol.send_* encoder against the active
        transport (the ring producer duck-types sendall)."""
        if self.transport == "shm":
            send_fn(self._producer, *args, **kw)
        else:
            send_fn(self._sock, *args, **kw)

    def _recv_frame(self):
        if self.transport != "shm":
            return self._reader.recv_frame_ex()
        deadline = (None if self._timeout is None
                    else self._timeout)
        t0 = time.monotonic()
        while True:
            rec = self._consumer.read(timeout=0.05)
            if rec is not None:
                ftype, entries, trace, used = \
                    protocol.parse_frame_bytes(rec)
                if used != len(rec):
                    raise protocol.MalformedFrameError(
                        "shm record carries trailing bytes")
                return ftype, entries, trace
            # liveness: a dead worker means the response never comes
            if self._worker_gone():
                raise ConnectionError("worker closed the shm "
                                      "liveness socket")
            if deadline is not None \
                    and time.monotonic() - t0 > deadline:
                raise TimeoutError("no shm response within timeout")

    def _worker_gone(self) -> bool:
        import select

        try:
            r, _, _ = select.select([self._sock], [], [], 0)
            if not r:
                return False
            return self._sock.recv(4096) == b""
        except OSError:
            return True

    # -- VerifyClient surface ----------------------------------------------

    def ping(self) -> bool:
        self._send(protocol.send_ping)
        ftype, _, _ = self._recv_frame()
        return ftype == protocol.T_PONG

    def stats(self) -> dict:
        self._send(protocol.send_stats_request)
        ftype, entries, _ = self._recv_frame()
        if ftype != protocol.T_STATS_RESP or len(entries) != 1:
            raise protocol.ProtocolError(
                f"expected stats response, got type {ftype}")
        return json.loads(entries[0][1].decode())

    def verify_batch(self, tokens: Sequence[str],
                     trace: Optional[str] = None) -> List[Any]:
        """Claims dict per verified token; RemoteVerifyError per
        reject — byte-identical verdicts to the socket transport."""
        if not tokens:
            return []
        self._send(protocol.send_request, tokens, crc=self._crc,
                   trace=trace)
        return self._read_response(len(tokens), trace)

    def verify_stream(self, batches, depth: int = 4,
                      sent_at: Optional[list] = None):
        """Pipelined requests, up to ``depth`` frames in flight, as
        ``VerifyClient.verify_stream``: a sender thread writes the
        frames (the request ring's one producer) while this thread
        reads the responses in request order. Leaving the stream early
        closes the client."""
        import queue
        import threading

        sent: "queue.Queue" = queue.Queue()
        slots = threading.Semaphore(depth)
        stop = threading.Event()
        send_err: List[BaseException] = []

        def sender() -> None:
            try:
                for toks in batches:
                    toks = list(toks)
                    while not slots.acquire(timeout=0.25):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    if sent_at is not None:
                        sent_at.append(time.perf_counter())
                    if toks:
                        self._send(protocol.send_request, toks,
                                   crc=self._crc)
                    sent.put(len(toks))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                send_err.append(e)
            finally:
                sent.put(None)

        t = threading.Thread(target=sender, daemon=True,
                             name="cap-gpu-shm-client-send")
        t.start()
        clean = False
        try:
            while True:
                n = sent.get()
                if n is None:
                    if send_err:
                        raise send_err[0]
                    clean = True
                    return
                out = self._read_response(n, None) if n else []
                slots.release()
                yield out
        finally:
            stop.set()
            if not clean:
                self.close()

    def _read_response(self, n_tokens: int,
                       trace: Optional[str]) -> List[Any]:
        want = (protocol.T_VERIFY_RESP_TRACE if trace is not None
                else protocol.T_VERIFY_RESP_CRC if self._crc
                else protocol.T_VERIFY_RESP)
        ftype, entries, _ = self._recv_frame()
        if ftype != want:
            raise protocol.ProtocolError(
                f"expected response type {want}, got {ftype}")
        if len(entries) != n_tokens:
            raise protocol.ProtocolError(
                f"response count {len(entries)} != request "
                f"{n_tokens}")
        out: List[Any] = []
        for status, payload in entries:
            if status == 0:
                out.append(payload if self._raw
                           else json.loads(payload.decode()))
            else:
                out.append(RemoteVerifyError(payload.decode()))
        return out

    def verify_signature(self, token: str) -> Any:
        res = self.verify_batch([token])[0]
        if isinstance(res, Exception):
            raise res
        return res

    def push_keys(self, jwks_doc: dict, epoch: int) -> int:
        """KEYS push over the active transport; returns the acked
        epoch (raises RemoteVerifyError on a status-1 ack)."""
        self._send(protocol.send_keys_push, jwks_doc, epoch)
        ftype, entries, _ = self._recv_frame()
        if ftype != protocol.T_KEYS_ACK or not entries:
            raise protocol.ProtocolError(
                f"expected keys ack, got type {ftype}")
        status, payload = entries[0]
        if status != 0:
            raise RemoteVerifyError(payload.decode())
        return int(json.loads(payload).get("epoch"))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        if self._region is not None:
            self._region.close(unlink=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
