"""Binding of the native OIDC claims-rule engine
(``runtime/native/claims_validate.cpp``, the ``claims_rules`` g++
target of :mod:`cap_tpu_torch._build`).

The engine evaluates the pure-comparison subset of the registered-
claims rules (iss equality, the exp/nbf/iat windows with the verify
leeway, nonce equality, aud membership and the multi-aud-contains-
client_id rule, the azp simple-equality arm) in one batched call a
verify batch, off the same claims tape the ``_capclaims`` extension
parses with. This module is its Python edge:

- :data:`STATUS_INDEX` is the fixed-order status registry; its index
  is the native ABI. The ``cap_claims_layout`` handshake compares the
  library's layout version and registry length with this table's,
  and a library that differs raises ``RuntimeError``: it can never
  misclassify, and it never hands the batch to the Python rules in
  silence. A library that fails to build or load raises too.
- :data:`STATUS_ERROR_NAMES` maps each reject status by name onto the
  :mod:`cap_tpu_torch.errors` class the Python rules raise for it, so
  a native reject has the class ``Provider._validate_id_claims`` would
  raise (static messages are the same text; dynamic ones keep the
  template without the payload's value).
- Status ``fallback`` is part of the rules' semantics: the token is
  decided by the Python rules (escaped keys, container or bigint
  claims, bool time claims, a request with ``max_age``). Tokens the
  engine decides add to :data:`native_validated`, tokens the Python
  rules decide to :data:`native_fallbacks`.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional, Sequence

import numpy as np

from .. import _build
from .. import errors as _errors

# ---------------------------------------------------------------------------
# status registry (native ABI, append-only; claims_validate.cpp's
# VStatus enum and kNumStatus are the C side of this table)
# ---------------------------------------------------------------------------

LAYOUT_VERSION = 1

STATUS_OK = 0
STATUS_FALLBACK = 1

STATUS_INDEX = (
    "ok",                        # 0  accepted natively
    "fallback",                  # 1  Python rules decide this token
    "missing_exp",               # 2
    "expired",                   # 3
    "not_before",                # 4
    "wrong_issuer",              # 5
    "unsupported_alg",           # 6
    "wrong_nonce",               # 7
    "future_iat",                # 8
    "aud_non_string",            # 9
    "aud_mismatch",              # 10
    "multi_aud_missing_client",  # 11
    "azp_mismatch",              # 12
)

# status name → errors class name
STATUS_ERROR_NAMES = {
    "missing_exp": "MissingClaimError",
    "expired": "ExpiredTokenError",
    "not_before": "InvalidNotBeforeError",
    "wrong_issuer": "InvalidIssuerError",
    "unsupported_alg": "UnsupportedAlgError",
    "wrong_nonce": "InvalidNonceError",
    "future_iat": "InvalidIssuedAtError",
    "aud_non_string": "InvalidAudienceError",
    "aud_mismatch": "InvalidAudienceError",
    "multi_aud_missing_client": "InvalidAudienceError",
    "azp_mismatch": "InvalidAuthorizedPartyError",
}

# the policy blob's audience count limit (parse_policy's n_aud bound)
MAX_POLICY_AUDIENCES = 4096

# tokens decided by the engine / by the Python rules, since the last reset
native_validated = 0
native_fallbacks = 0

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def status_error(status: int, alg: Optional[str] = None,
                 client_id: str = "", now: Optional[float] = None
                 ) -> Exception:
    """The errors-class exception for one native reject status.

    Messages follow the Python rules' wording: static messages are the
    same text; dynamic ones keep the template with the parts the
    binding knows (alg from the header-segment cache, client_id from
    the policy, ``now``).
    """
    name = STATUS_INDEX[status]
    cls = getattr(_errors, STATUS_ERROR_NAMES[name])
    if name == "missing_exp":
        return cls("id_token missing exp claim")
    if name == "expired":
        return cls("token is expired")
    if name == "not_before":
        return cls("current time before the nbf (not before) time")
    if name == "wrong_issuer":
        return cls("id token issued by a different provider")
    if name == "unsupported_alg":
        return cls(f"id_token signed with unsupported algorithm {alg!r}")
    if name == "wrong_nonce":
        return cls("invalid id_token nonce")
    if name == "future_iat":
        return cls(f"current time {now} before the iat (issued at) time")
    if name == "aud_non_string":
        return cls("aud claim contains a non-string value")
    if name == "aud_mismatch":
        return cls("invalid id_token audiences")
    if name == "multi_aud_missing_client":
        return cls("multiple audiences and one of them is not equal "
                   f"client_id ({client_id})")
    if name == "azp_mismatch":
        return cls(f"authorized party is not equal client_id ({client_id})")
    raise ValueError(f"not a reject status: {status}")


def _utf8(s) -> Optional[bytes]:
    if not isinstance(s, str):
        return None
    try:
        return s.encode("utf-8")
    except UnicodeEncodeError:
        return None


def policy_expressible(issuer, client_id, nonce,
                       audiences: Sequence) -> bool:
    """True when :func:`pack_policy` can encode this policy into a blob
    the engine accepts: every field a string with a UTF-8 encoding, at
    most :data:`MAX_POLICY_AUDIENCES` audiences. Otherwise the Python
    rules decide the batch."""
    return (len(audiences) <= MAX_POLICY_AUDIENCES
            and all(_utf8(s) is not None
                    for s in (issuer, client_id, nonce, *audiences)))


def pack_policy(issuer: str, client_id: str, nonce: str,
                audiences: Sequence[str], leeway: float,
                max_age_requested: bool) -> bytes:
    """One batch's rule policy as the engine's blob (the format of
    ``parse_policy`` in claims_validate.cpp)."""
    iss = issuer.encode("utf-8")
    cli = client_id.encode("utf-8")
    non = nonce.encode("utf-8")
    auds = [a.encode("utf-8") for a in audiences]
    head = struct.pack("<IIdI", 1, 1 if max_age_requested else 0,
                       float(leeway), len(auds))
    lens = struct.pack("<III", len(iss), len(cli), len(non))
    lens += struct.pack(f"<{len(auds)}I", *[len(a) for a in auds]) \
        if auds else b""
    return head + lens + iss + cli + non + b"".join(auds)


class _Engine:
    """The loaded library, its layout handshake passed."""

    def __init__(self, lib: ctypes.CDLL):
        lib.cap_claims_layout.argtypes = [_i32p]
        lib.cap_claims_layout.restype = None
        layout = np.zeros(2, np.int32)
        lib.cap_claims_layout(layout.ctypes.data_as(_i32p))
        if (int(layout[0]), int(layout[1])) != (LAYOUT_VERSION,
                                                len(STATUS_INDEX)):
            raise RuntimeError(
                f"claims engine layout drift: the library reports "
                f"{layout.tolist()}, the binding expects "
                f"[{LAYOUT_VERSION}, {len(STATUS_INDEX)}]")
        lib.cap_claims_validate_batch.restype = ctypes.c_int32
        lib.cap_claims_validate_batch.argtypes = [
            _u8p, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,
            _u8p, ctypes.c_int64, _u8p, ctypes.c_double, _u8p,
            ctypes.c_int32,
        ]
        self._lib = lib

    def validate(self, payloads: Sequence[bytes], alg_ok: np.ndarray,
                 now: float, policy: bytes) -> np.ndarray:
        n = len(payloads)
        if n == 0:
            return np.zeros(0, np.uint8)
        scratch = np.frombuffer(b"".join(payloads), np.uint8)
        if len(scratch) == 0:
            scratch = np.zeros(1, np.uint8)
        lens = np.fromiter((len(p) for p in payloads), np.int64, count=n)
        offs = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        pol = np.frombuffer(policy, np.uint8)
        out = np.zeros(n, np.uint8)
        rc = self._lib.cap_claims_validate_batch(
            scratch.ctypes.data_as(_u8p), len(scratch),
            offs.ctypes.data_as(_i64p), lens.ctypes.data_as(_i64p), n,
            pol.ctypes.data_as(_u8p), len(pol),
            np.ascontiguousarray(alg_ok, np.uint8).ctypes.data_as(_u8p),
            float(now), out.ctypes.data_as(_u8p), 0)
        if rc != 0:
            raise RuntimeError(
                f"claims engine refused the batch (rc {rc}): a policy "
                f"blob pack_policy did not make, or payload spans out "
                f"of range")
        return out


_LOCK = threading.Lock()
_engine: Optional[_Engine] = None


def engine() -> _Engine:
    """The engine, built and loaded at first use, its handshake
    checked; raises when the build, the load or the handshake fails."""
    global _engine
    with _LOCK:
        if _engine is None:
            _engine = _Engine(_build.load("claims_rules"))
        return _engine


def validate_payloads(payloads: Sequence[bytes], alg_ok: np.ndarray,
                      now: float, policy: bytes) -> np.ndarray:
    """[status u8] per payload from one native batched rules call.
    ``alg_ok[i]`` is 1 when payload i's token is signed with an allowed
    alg; ``policy`` a :func:`pack_policy` blob."""
    return engine().validate(payloads, alg_ok, now, policy)


def count_validated(n: int) -> None:
    global native_validated
    native_validated += n


def count_fallbacks(n: int) -> None:
    global native_fallbacks
    native_fallbacks += n


def reset_counts() -> None:
    """Set both counters to 0."""
    global native_validated, native_fallbacks
    native_validated = native_fallbacks = 0
