"""Fault-injection harness for the serve fleet.

The port of ``cap_tpu.fleet.chaos``. Two levers, composable from tests:

- **process faults**: :func:`kill9` sends SIGKILL to a live worker —
  the hardest crash there is, mid-batch by construction when the
  worker is sleeping in its (stub) device or draining a real one;
- **network faults**: :class:`ChaosProxy`, a TCP forwarder that sits
  between the router and one worker and can, at any moment:

  - ``delay_accept(s)`` — hold every new connection for ``s`` before
    the upstream connect (slow-accept worker);
  - ``stall()`` — stop moving bytes (both directions) while keeping
    the connections open: the client sees a socket that accepts writes
    and never answers;
  - ``blackhole()`` — keep reading and DROP everything (the worker
    never sees requests; the client never sees responses);
  - ``corrupt(direction, offset, xor)`` — flip byte(s) of the next
    forwarded chunk: the corrupt-response-frame mode that the
    checksummed CVB1 frames (types 7/8) must catch;
  - ``clear()`` — lift every fault (in-flight connections resume).

The proxy's target is a CALLABLE so a respawned worker (new port) is
picked up by the next connection — tests route the router through
proxies and the pool around them.

The harness moves bytes and signals only: it never parses, logs, or
stores token material (redaction discipline).
"""

from __future__ import annotations

import os
import signal
import socket
import threading
import time
from typing import Callable, Optional, Tuple, Union

Target = Union[Tuple[str, int], Callable[[], Optional[Tuple[str, int]]]]


def kill9(pid: int) -> None:
    """SIGKILL a worker process (the crash the pool must recover)."""
    os.kill(pid, signal.SIGKILL)


class _Faults:
    """Shared, lock-guarded fault state for one proxy."""

    def __init__(self):
        self.lock = threading.Lock()
        self.accept_delay = 0.0
        self.stalled = False
        self.blackholed = False
        # direction -> remaining corruptions [(offset, xor)]
        self.corrupt_c2s: list = []
        self.corrupt_s2c: list = []


class ChaosProxy:
    """A byte-level TCP forwarder with switchable faults.

    target: (host, port) or a callable returning the CURRENT address
    (None → connection refused), e.g. ``lambda: pool.address(0)``.
    """

    def __init__(self, target: Target, host: str = "127.0.0.1",
                 port: int = 0):
        self._target = target
        self._faults = _Faults()
        self._closed = threading.Event()
        self._conns: list = []
        self._conns_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self._addr = self._sock.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="cap-gpu-chaos-accept").start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._addr

    # -- fault switchboard ------------------------------------------------

    def delay_accept(self, seconds: float) -> None:
        with self._faults.lock:
            self._faults.accept_delay = seconds

    def stall(self) -> None:
        with self._faults.lock:
            self._faults.stalled = True

    def blackhole(self) -> None:
        with self._faults.lock:
            self._faults.blackholed = True

    def corrupt(self, direction: str = "s2c", offset: int = 9,
                xor: int = 0x01, times: int = 1) -> None:
        """Flip ``xor`` into byte ``offset`` of the next ``times``
        forwarded chunks in ``direction`` ("s2c" = response path).
        The default (offset 9, xor 0x01) hits the first response
        entry's STATUS byte — the exact bit whose silent flip would
        turn a verified token into a rejection."""
        with self._faults.lock:
            lst = (self._faults.corrupt_s2c if direction == "s2c"
                   else self._faults.corrupt_c2s)
            lst.extend([(offset, xor)] * times)

    def clear(self) -> None:
        with self._faults.lock:
            self._faults.accept_delay = 0.0
            self._faults.stalled = False
            self._faults.blackholed = False
            self._faults.corrupt_c2s.clear()
            self._faults.corrupt_s2c.clear()

    def drop_connections(self) -> None:
        """Hard-close every proxied connection (both sides see RST)."""
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self.drop_connections()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals --------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                client, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._bridge, args=(client,),
                             daemon=True, name="cap-gpu-chaos-conn").start()

    def _bridge(self, client: socket.socket) -> None:
        with self._faults.lock:
            delay = self._faults.accept_delay
        if delay:
            time.sleep(delay)
        if self._closed.is_set():
            client.close()
            return
        target = self._target() if callable(self._target) else self._target
        try:
            if target is None:
                raise OSError("no live target")
            upstream = socket.create_connection(target, timeout=10.0)
        except OSError:
            client.close()
            return
        with self._conns_lock:
            self._conns.extend([client, upstream])
        threading.Thread(
            target=self._pump, args=(client, upstream, "c2s"),
            daemon=True, name="cap-gpu-chaos-c2s").start()
        self._pump(upstream, client, "s2c")

    def _pump(self, src: socket.socket, dst: socket.socket,
              direction: str) -> None:
        try:
            while not self._closed.is_set():
                # A stalled proxy stops READING too: backpressure
                # propagates to the sender, like a wedged worker.
                while True:
                    with self._faults.lock:
                        stalled = self._faults.stalled
                    if not stalled or self._closed.is_set():
                        break
                    time.sleep(0.02)
                chunk = src.recv(1 << 16)
                if not chunk:
                    break
                with self._faults.lock:
                    if self._faults.blackholed:
                        continue        # read and drop
                    lst = (self._faults.corrupt_s2c if direction == "s2c"
                           else self._faults.corrupt_c2s)
                    if lst:
                        offset, xor = lst.pop(0)
                        b = bytearray(chunk)
                        b[min(offset, len(b) - 1)] ^= xor
                        chunk = bytes(b)
                dst.sendall(chunk)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass
