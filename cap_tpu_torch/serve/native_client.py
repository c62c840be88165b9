"""ctypes wrapper over the native (C++) verify-worker client.

The port of ``cap_tpu.serve.native_client``. ``NativeVerifyClient``
mirrors ``VerifyClient`` but rides ``serve/native/client_native.cpp``
(the ``client`` target of :mod:`cap_tpu_torch._build`) — the same shim
a C/C++/cgo host application links. A failed build raises
``RuntimeError``; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import json
from typing import Any, List, Optional, Sequence

from .. import _build
from .client import RemoteVerifyError


def _load():
    lib = _build.load("client")
    lib.cap_client_connect.restype = ctypes.c_void_p
    lib.cap_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.cap_client_connect_uds.restype = ctypes.c_void_p
    lib.cap_client_connect_uds.argtypes = [ctypes.c_char_p]
    lib.cap_client_ping.restype = ctypes.c_int
    lib.cap_client_ping.argtypes = [ctypes.c_void_p]
    lib.cap_client_verify.restype = ctypes.c_int
    lib.cap_client_verify.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.cap_client_close.restype = None
    lib.cap_client_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeVerifyClient:
    """KeySet-shaped client backed by the C ABI shim."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 uds_path: Optional[str] = None):
        self._lib = _load()
        if uds_path is not None:
            self._h = self._lib.cap_client_connect_uds(uds_path.encode())
        else:
            self._h = self._lib.cap_client_connect(host.encode(), port)
        if not self._h:
            raise ConnectionError("native client failed to connect")

    def ping(self) -> bool:
        return bool(self._lib.cap_client_ping(self._h))

    def verify_batch(self, tokens: Sequence[str]) -> List[Any]:
        if not tokens:
            return []
        n = len(tokens)
        raw = [t.encode() for t in tokens]
        arr = (ctypes.c_char_p * n)(*raw)
        lens = (ctypes.c_uint32 * n)(*[len(r) for r in raw])
        statuses = (ctypes.c_uint8 * n)()
        offs = (ctypes.c_uint64 * (n + 1))()
        cap = max(4096, 1024 * n)
        buf = ctypes.create_string_buffer(cap)
        rc = self._lib.cap_client_verify(
            self._h, arr, lens, n, statuses, buf, cap, offs)
        if rc == -2:  # grow and retry once with the reported size
            cap = int(offs[n])
            buf = ctypes.create_string_buffer(cap)
            rc = self._lib.cap_client_verify(
                self._h, arr, lens, n, statuses, buf, cap, offs)
        if rc != 0:
            raise ConnectionError(f"native verify failed (rc={rc})")
        out: List[Any] = []
        for i in range(n):
            payload = buf.raw[offs[i]: offs[i + 1]]
            if statuses[i] == 0:
                out.append(json.loads(payload.decode()))
            else:
                out.append(RemoteVerifyError(payload.decode()))
        return out

    def close(self) -> None:
        if self._h:
            self._lib.cap_client_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
