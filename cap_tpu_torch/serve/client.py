"""Python client for the verify worker (CVB1 protocol).

The port of ``cap_tpu.serve.client``. It mirrors the KeySet surface so
a host app can swap a local GPUBatchKeySet for a remote worker without
code changes: ``verify_batch`` returns the same per-token
claims-dict-or-Exception list, with rejected tokens surfaced as
RemoteVerifyError (the worker sends only the error class + message —
never token material). Two additions: ``raw=True`` yields an accepted
token's payload bytes as the worker sent them, in place of the parsed
dict, and ``verify_stream(..., sent_at=list)`` appends each request's
send instant (``time.perf_counter()``), for request latencies.
"""

from __future__ import annotations

import json
import socket
import time
from typing import Any, List, Optional, Sequence

from ..errors import CapError
from . import protocol


class RemoteVerifyError(CapError):
    """A token the worker rejected; message is the worker's error."""


class VerifyClient:
    """Blocking client; one socket, pipelined request/response frames."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 uds_path: Optional[str] = None, timeout: float = 30.0,
                 crc: bool = False, raw: bool = False):
        # crc=True: speak the checksummed frame pair (REQ_CRC/RESP_CRC)
        # so byte corruption anywhere on the path raises
        # FrameCorruptError instead of returning a wrong verdict — the
        # fleet router always sets this.
        self._crc = crc
        self._raw = raw
        if uds_path is not None:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(timeout)
            self._sock.connect(uds_path)
        else:
            self._sock = socket.create_connection((host, port),
                                                  timeout=timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # The client owns this socket's read side: buffered reader.
        self._reader = protocol.FrameReader(self._sock)

    def ping(self) -> bool:
        protocol.send_ping(self._sock)
        ftype, _ = self._reader.recv_frame()
        return ftype == protocol.T_PONG

    def stats(self) -> dict:
        """The worker's STATS snapshot (queue depth, inflight,
        counters, per-series p50/p95/p99)."""
        protocol.send_stats_request(self._sock)
        ftype, entries = self._reader.recv_frame()
        if ftype != protocol.T_STATS_RESP or len(entries) != 1:
            raise protocol.ProtocolError(
                f"expected stats response, got type {ftype}")
        return json.loads(entries[0][1].decode())

    def verify_batch(self, tokens: Sequence[str]) -> List[Any]:
        """Claims dict per verified token; RemoteVerifyError per reject."""
        if not tokens:
            return []
        protocol.send_request(self._sock, tokens, crc=self._crc)
        return self._read_response(len(tokens))

    def verify_stream(self, batches, depth: int = 4,
                      sent_at: Optional[list] = None):
        """Pipelined requests: up to ``depth`` frames in flight.

        Yields each batch's results in request order (CVB1 correlates
        by order). The worker reads eagerly, so while batch k verifies
        on the device, batches k+1.. are already crossing the wire and
        queueing in its batcher — the serve-path analog of
        ``GPUBatchKeySet.verify_stream``. A sender
        thread writes frames so a full send buffer can never deadlock
        against the unread responses.

        Leaving the stream early (break / exception) POISONS the
        client: in-flight responses would otherwise be misattributed
        to later requests (order is the only correlation), so the
        socket is closed and any further call raises.
        """
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
                        protocol.send_request(self._sock, toks,
                                              crc=self._crc)
                    sent.put(len(toks))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                send_err.append(e)
            finally:
                sent.put(None)

        t = threading.Thread(target=sender, daemon=True,
                             name="cap-gpu-client-send")
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
                out = self._read_response(n) if n else []
                slots.release()
                yield out
        finally:
            stop.set()
            if not clean:
                # abandoned or failed mid-stream: unread responses are
                # on the wire — the connection cannot be reused
                self.close()

    def _read_response(self, n_tokens: int) -> List[Any]:
        ftype, entries = self._reader.recv_frame()
        # In crc mode a plain (unchecksummed) response is a protocol
        # violation — integrity must not be silently downgradable.
        want = (protocol.T_VERIFY_RESP_CRC if self._crc
                else protocol.T_VERIFY_RESP)
        if ftype != want:
            raise protocol.ProtocolError(f"expected response type "
                                         f"{want}, got {ftype}")
        if len(entries) != n_tokens:
            raise protocol.ProtocolError(
                f"response count {len(entries)} != request {n_tokens}")
        out: List[Any] = []
        for status, payload in entries:
            if status == 0:
                out.append(payload if self._raw
                           else json.loads(payload.decode()))
            else:
                out.append(RemoteVerifyError(payload.decode()))
        return out

    def verify_signature(self, token: str) -> Any:
        """Single-token convenience; raises on rejection (KeySet shape)."""
        res = self.verify_batch([token])[0]
        if isinstance(res, Exception):
            raise res
        return res

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
