"""ctypes binding of the native batch prep (``native/jose_native.cpp``)
and the claims extension (``native/claims_ext.cpp``).

``prepare_batch_arrays(tokens)`` parses a whole batch of compact JWS
in one multithreaded call (split, strict base64url, header scan for
``alg``/``kid``/``crit``, SHA-2 of the signing input by alg family)
into a :class:`PreparedBatch`: structure-of-arrays numpy views, so the
keyset buckets, resolves key rows and packs device records without a
per-token Python parse. Rejections carry the strict parser's classes
and messages (``PreparedBatch.error``). ``sha_batch`` hashes byte
strings in one call; ``PreparedBatch.prefetch_claims`` parses claim
payloads with the GIL released, falling back to ``json.loads`` for
anything outside the extension's envelope, so results are those of
``json.loads``. For the OIDC raw mode, ``PreparedBatch.payload_object_ok``
checks that payloads are JSON objects without building a dict, and
``registered_claims_from_payloads`` parses only the registered claims.

Both libraries build with g++ at first use (``_build``); a build that
fails raises. ``prepare_calls`` counts calls of ``cap_prepare_batch``.
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import _build
from ..errors import MalformedTokenError, TokenNotSignedError

ALG_NAMES = ["RS256", "RS384", "RS512", "ES256", "ES384", "ES512",
             "PS256", "PS384", "PS512", "EdDSA"]

(_OK, _ERR_SEGMENTS, _ERR_B64, _ERR_HEADER_JSON, _ERR_NO_ALG, _ERR_UNSIGNED,
 _ERR_CRIT) = range(7)

prepare_calls = 0


class _TokOut(ctypes.Structure):
    _fields_ = [
        ("status", ctypes.c_int32),
        ("alg_id", ctypes.c_int32),
        ("sig_off", ctypes.c_int64),
        ("sig_len", ctypes.c_int64),
        ("payload_off", ctypes.c_int64),
        ("payload_len", ctypes.c_int64),
        ("signing_input_len", ctypes.c_int64),
        ("kid", ctypes.c_uint8 * 160),
        ("alg_raw", ctypes.c_uint8 * 32),
        ("digest", ctypes.c_uint8 * 64),
        ("digest_len", ctypes.c_int32),
        ("kid_len", ctypes.c_int32),
        ("alg_len", ctypes.c_int32),
        ("pad", ctypes.c_int32),
    ]


_TOKOUT_DTYPE = np.dtype([
    ("status", np.int32), ("alg_id", np.int32),
    ("sig_off", np.int64), ("sig_len", np.int64),
    ("payload_off", np.int64), ("payload_len", np.int64),
    ("signing_input_len", np.int64),
    ("kid", np.uint8, 160), ("alg_raw", np.uint8, 32),
    ("digest", np.uint8, 64), ("digest_len", np.int32),
    ("kid_len", np.int32), ("alg_len", np.int32), ("pad", np.int32),
])
assert _TOKOUT_DTYPE.itemsize == ctypes.sizeof(_TokOut)

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The prep library, built at first use, its ABI checked."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _build.load("jose")
            lib.cap_tokout_size.argtypes = []
            lib.cap_tokout_size.restype = ctypes.c_int64
            if lib.cap_tokout_size() != ctypes.sizeof(_TokOut):
                raise RuntimeError("TokOut ABI mismatch between the binding "
                                   "and jose_native.cpp")
            lib.cap_prepare_batch.argtypes = [
                ctypes.c_char_p, _I64P, ctypes.c_int64,
                ctypes.POINTER(_TokOut), _U8P, _I64P, ctypes.c_int32]
            lib.cap_prepare_batch.restype = None
            lib.cap_sha_batch.argtypes = [
                _U8P, _I64P, ctypes.c_int64, ctypes.c_int32, _U8P,
                ctypes.c_int32]
            lib.cap_sha_batch.restype = None
            lib.cap_pack_sig_records.argtypes = [
                _U8P, ctypes.c_int64, _I64P, _I64P, _U8P, ctypes.c_int64,
                _I64P, _I64P, _U8P, _U8P, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, _U8P, ctypes.c_int32]
            lib.cap_pack_sig_records.restype = None
            _LIB = lib
        return _LIB


class NativeParsed:
    """Parsed JWS view over native-decoded buffers (unverified): what
    the trial path reads of a ``jose.ParsedJWS``."""

    __slots__ = ("alg", "kid", "signature", "payload", "signing_input",
                 "_digest")

    def __init__(self, alg: str, kid: Optional[str], signature: bytes,
                 payload: bytes, signing_input: bytes, digest: bytes):
        self.alg = alg
        self.kid = kid
        self.signature = signature
        self.payload = payload
        self.signing_input = signing_input
        self._digest = digest

    def claims(self) -> Dict[str, Any]:
        c = _loads_claims(self.payload)
        if isinstance(c, MalformedTokenError):
            raise c
        return c

    def digest(self) -> bytes:
        """SHA-2 of the signing input by alg family (empty for EdDSA
        and algs outside ``ALG_NAMES``)."""
        return self._digest


def _loads_claims(raw: bytes):
    """json.loads of a payload → the claims dict, or the
    MalformedTokenError every parse path of the batch shares."""
    try:
        c = json.loads(raw)
        return c if isinstance(c, dict) else \
            MalformedTokenError("payload is not a JSON object")
    except (ValueError, UnicodeDecodeError) as e:
        return MalformedTokenError(f"payload is not valid JSON: {e}")


def registered_claims_from_payloads(payloads: Sequence[bytes]) -> List[Any]:
    """[payload bytes] → per payload the claims for validation only: the
    extension's registered-claims subset (iss, sub, aud, exp, nbf, iat,
    nonce, azp, auth_time) as a dict, or, where it flags the payload,
    the ``json.loads`` dict or its MalformedTokenError. The OIDC raw
    mode reads only registered claims, so the subset decides as the
    full parse would."""
    scratch = np.frombuffer(b"".join(payloads) + b"\0", np.uint8)
    lens = np.asarray([len(p) for p in payloads], np.int64)
    offs = np.zeros(len(payloads), np.int64)
    if len(payloads):
        np.cumsum(lens[:-1], out=offs[1:])
    parsed, n_bad = _build.load_claims().registered_batch(scratch, offs,
                                                          lens)
    if n_bad == 0:
        return parsed
    return [v if type(v) is dict else _loads_claims(payloads[i])
            for i, v in enumerate(parsed)]


class PreparedBatch:
    """Structure-of-arrays view of a prepared token batch.

    Statuses, alg ids, kid bytes, signatures and digests stay numpy
    arrays, so bucketing, key-row lookup and record packing are
    vectorized; per-token Python objects are made only where needed
    (claims of verified tokens, errors of rejected ones, the trial
    path).
    """

    __slots__ = ("n", "status", "alg_id", "kid_mat", "kid_len", "sig_off",
                 "sig_len", "payload_off", "payload_len", "si_len", "digest",
                 "digest_len", "scratch", "blob", "tok_off", "alg_raw",
                 "alg_len", "_claims_cache", "raw_ok")

    def __init__(self, n, status, alg_id, kid_mat, kid_len, sig_off, sig_len,
                 payload_off, payload_len, si_len, digest, digest_len,
                 scratch, blob, tok_off, alg_raw, alg_len):
        self.n = n
        self.status = status
        self.alg_id = alg_id            # index into ALG_NAMES, or -1
        self.kid_mat = kid_mat
        self.kid_len = kid_len          # -1 absent, -2 overlong
        self.sig_off = sig_off          # absolute into scratch
        self.sig_len = sig_len
        self.payload_off = payload_off  # absolute into scratch
        self.payload_len = payload_len
        self.si_len = si_len
        self.digest = digest            # [n, 64] uint8
        self.digest_len = digest_len
        self.scratch = scratch          # uint8 array (decoded payload+sig)
        self.blob = blob                # bytes (raw concatenated tokens)
        self.tok_off = tok_off
        self.alg_raw = alg_raw          # [n, 32] uint8 (for unknown algs)
        self.alg_len = alg_len
        self._claims_cache: Dict[int, Any] = {}
        # raw mode: [n] bool, the payload is a JSON object (set by the
        # keyset's collect from payload_object_ok); None in dict mode
        self.raw_ok: Optional[np.ndarray] = None

    # -- vectorized helpers -----------------------------------------------

    def kid_rows(self, idx: np.ndarray, kid_to_row: dict) -> np.ndarray:
        """Key row per token of ``idx``: -1 no kid, -2 a kid that names
        no row (or one longer than 160 bytes, which the native layer
        does not capture: the trial path resolves it).

        One np.unique over (kid bytes ‖ kid length), then one dict
        lookup per distinct kid.
        """
        m = len(idx)
        lens = self.kid_len[idx]
        rows = np.full(m, -2, np.int32)
        rows[lens == -1] = -1
        present = lens >= 0
        if not present.any():
            return rows
        keyed = np.zeros((m, 164), np.uint8)
        keyed[present, :160] = self.kid_mat[idx[present]]
        keyed[present, 160:] = lens[present, None].astype(np.int32).view(
            np.uint8).reshape(-1, 4)
        view = np.ascontiguousarray(keyed).view(
            np.dtype((np.void, 164))).ravel()
        uniq, inverse = np.unique(view, return_inverse=True)
        uniq_rows = np.full(len(uniq), -2, np.int32)
        for u in range(len(uniq)):
            raw = uniq[u].tobytes()
            klen = int(np.frombuffer(raw[160:], np.int32)[0])
            if klen < 0:
                continue
            kid = raw[:klen].decode("utf-8", "surrogateescape")
            uniq_rows[u] = kid_to_row.get(kid, -2)
        rows[present] = uniq_rows[inverse.reshape(-1)][present]
        return rows

    def pack_sig_records(self, idx: np.ndarray, expect_size: np.ndarray,
                         extra_valid: np.ndarray, key_rows: np.ndarray,
                         width: int, h_len: int, pad: int) -> np.ndarray:
        """One multithreaded native pass: the packed [pad, width + h_len
        + 2] u8 records of the tokens ``idx``, row r = right-aligned
        signature (width) ‖ digest (h_len) ‖ flag ‖ key row; rows from
        len(idx) on are zero.

        The flag is 1 iff ``extra_valid[r]`` and the signature is
        ``expect_size[r]`` bytes long (the oracle's length rejections);
        a row flagged 0 carries a zero signature.
        """
        m = len(idx)
        idx = np.ascontiguousarray(idx, np.int64)
        expect = np.ascontiguousarray(expect_size, np.int64)
        valid = np.ascontiguousarray(extra_valid, np.uint8)
        rows = np.ascontiguousarray(key_rows, np.uint8)
        if not (len(expect) == len(valid) == len(rows) == m <= pad):
            raise ValueError("pack_sig_records: idx, expect_size, "
                             "extra_valid and key_rows must have one entry "
                             "per token, at most pad")
        if m and (idx.min() < 0 or idx.max() >= self.n):
            raise ValueError("pack_sig_records: token index out of range")
        if not 0 <= h_len <= self.digest.shape[1]:
            raise ValueError(f"pack_sig_records: h_len {h_len} out of range")
        out = np.empty((pad, width + h_len + 2), np.uint8)
        _lib().cap_pack_sig_records(
            self.scratch.ctypes.data_as(_U8P), len(self.scratch),
            self.sig_off.ctypes.data_as(_I64P),
            self.sig_len.ctypes.data_as(_I64P),
            self.digest.ctypes.data_as(_U8P), self.digest.shape[1],
            idx.ctypes.data_as(_I64P), expect.ctypes.data_as(_I64P),
            valid.ctypes.data_as(_U8P), rows.ctypes.data_as(_U8P),
            m, pad, width, h_len, out.ctypes.data_as(_U8P), 0)
        return out

    def sig_matrix(self, idx: np.ndarray, width: int) -> np.ndarray:
        """[len(idx), width] uint8: left-aligned raw signature bytes,
        zero-padded at the tail (pair with sig_len)."""
        cols = np.arange(width)[None, :]
        offs = self.sig_off[idx][:, None] + cols
        lens = self.sig_len[idx][:, None]
        safe = np.minimum(offs, len(self.scratch) - 1)
        mat = self.scratch[safe]
        return np.where(cols < lens, mat, 0).astype(np.uint8)

    # -- per-token materialization ----------------------------------------

    def payload_bytes(self, i: int) -> bytes:
        o, ln = int(self.payload_off[i]), int(self.payload_len[i])
        return self.scratch[o: o + ln].tobytes()

    def payload_object_ok(self, indices) -> np.ndarray:
        """[len(indices)] bool: the payload parses as a JSON object.

        No dict is built: the extension's strict scan decides, and a
        payload outside its envelope (status 3) is decided by
        ``json.loads``, so the answer is the one the claims path
        gives."""
        idx = np.ascontiguousarray(indices, np.int64)
        offs = np.ascontiguousarray(self.payload_off[idx], np.int64)
        lens = np.ascontiguousarray(self.payload_len[idx], np.int64)
        st = np.frombuffer(_build.load_claims().validate_batch(
            self.scratch, offs, lens), np.uint8)
        out = st == 0
        for k in np.nonzero(st == 3)[0].tolist():
            out[k] = not isinstance(_loads_claims(
                self.payload_bytes(int(idx[k]))), MalformedTokenError)
        return out

    def claims(self, i: int) -> Dict[str, Any]:
        """The claims dict of token ``i`` (from the prefetch cache when
        there), or raises its MalformedTokenError."""
        hit = self._claims_cache.get(i)
        if hit is None:
            hit = self._parse_one(int(self.payload_off[i]),
                                  int(self.payload_len[i]))
        if isinstance(hit, MalformedTokenError):
            raise hit
        return hit

    def prefetch_claims(self, indices) -> None:
        """Parse the claim payloads of ``indices`` into the cache.

        Called after the device work is queued and before the first
        sync, so the parse overlaps the device. The extension scans
        with the GIL released, across threads; a payload it flags
        (malformed, not an object, outside its envelope) is parsed
        again with json.loads, so every entry equals the json.loads
        result, errors and their messages included.
        """
        cache = self._claims_cache
        idx = np.asarray(indices, np.int64).reshape(-1)
        if cache:
            idx = idx[[i not in cache for i in idx.tolist()]]
        if len(idx) == 0:
            return
        off, ln = self.payload_off, self.payload_len
        parsed, n_bad = _build.load_claims().parse_batch(
            self.scratch, np.ascontiguousarray(off[idx], np.int64),
            np.ascontiguousarray(ln[idx], np.int64))
        idx_list = idx.tolist()
        if n_bad == 0:
            cache.update(zip(idx_list, parsed))
            return
        for j, v in zip(idx_list, parsed):
            cache[j] = v if type(v) is dict else \
                self._parse_one(int(off[j]), int(ln[j]))

    def _parse_one(self, off: int, ln: int) -> Any:
        """json.loads one payload → dict or MalformedTokenError."""
        return _loads_claims(self.scratch[off: off + ln].tobytes())

    def signature(self, i: int) -> bytes:
        o, ln = int(self.sig_off[i]), int(self.sig_len[i])
        return self.scratch[o: o + ln].tobytes()

    def signing_input(self, i: int) -> bytes:
        o = int(self.tok_off[i])
        return self.blob[o: o + int(self.si_len[i])]

    def token(self, i: int) -> str:
        o, e = int(self.tok_off[i]), int(self.tok_off[i + 1])
        return self.blob[o:e].decode("ascii")

    def alg(self, i: int) -> str:
        aid = int(self.alg_id[i])
        if aid >= 0:
            return ALG_NAMES[aid]
        n = int(self.alg_len[i])
        return self.alg_raw[i, :n].tobytes().decode("utf-8", "surrogateescape")

    def kid(self, i: int) -> Optional[str]:
        n = int(self.kid_len[i])
        if n == -1:
            return None
        if n == -2:
            # longer than 160 bytes: not captured natively; the strict
            # parser reads it from the token
            from ..jwt.jose import parse_compact

            try:
                return parse_compact(self.token(i)).kid
            except (MalformedTokenError, TokenNotSignedError):
                return None
        return self.kid_mat[i, :n].tobytes().decode("utf-8", "surrogateescape")

    def error(self, i: int) -> Exception:
        """The rejection of a token whose status is not 0."""
        s = int(self.status[i])
        if s == _ERR_UNSIGNED:
            return TokenNotSignedError("token must be signed")
        if s == _ERR_SEGMENTS:
            return MalformedTokenError("compact JWS must have 3 segments")
        if s == _ERR_NO_ALG:
            return MalformedTokenError(
                "protected header missing alg parameter")
        if s == _ERR_HEADER_JSON:
            return MalformedTokenError(
                "protected header is not a JSON object")
        if s == _ERR_CRIT:
            return MalformedTokenError("unsupported crit header")
        return MalformedTokenError("invalid base64url segment")

    def parsed(self, i: int) -> NativeParsed:
        """Token ``i`` as a NativeParsed (the trial path)."""
        return NativeParsed(
            self.alg(i), self.kid(i), self.signature(i),
            self.payload_bytes(i), self.signing_input(i),
            bytes(self.digest[i, : self.digest_len[i]]))


def prepare_batch_arrays(tokens: Sequence[str]) -> PreparedBatch:
    """Prepare a batch of compact tokens, one thread a core. A
    non-ASCII character parses as a byte that no segment accepts, so
    its token is rejected."""
    global prepare_calls
    n = len(tokens)
    blob = "".join(tokens).encode("ascii", "replace")
    lengths = np.fromiter((len(t) for t in tokens), np.int64, count=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    # per-token scratch: decoded payload + signature fit in length + 8
    scratch_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths + 8, out=scratch_offsets[1:])
    scratch = np.empty(int(scratch_offsets[-1]) + 1, np.uint8)
    outs = np.zeros(n, dtype=_TOKOUT_DTYPE)
    lib = _lib()
    prepare_calls += 1
    lib.cap_prepare_batch(
        blob, offsets.ctypes.data_as(_I64P), n,
        outs.ctypes.data_as(ctypes.POINTER(_TokOut)),
        scratch.ctypes.data_as(_U8P), scratch_offsets.ctypes.data_as(_I64P),
        0)
    base = scratch_offsets[:n]
    return PreparedBatch(
        n=n,
        status=outs["status"],
        alg_id=outs["alg_id"],
        kid_mat=outs["kid"],
        kid_len=outs["kid_len"],
        sig_off=base + outs["sig_off"],
        # contiguous copies: the record packer reads these through raw
        # pointers (a structured array's field view strides by the
        # whole record)
        sig_len=np.ascontiguousarray(outs["sig_len"]),
        payload_off=base + outs["payload_off"],
        payload_len=outs["payload_len"],
        si_len=outs["signing_input_len"],
        digest=np.ascontiguousarray(outs["digest"]),
        digest_len=outs["digest_len"],
        scratch=scratch,
        blob=blob,
        tok_off=offsets,
        alg_raw=outs["alg_raw"],
        alg_len=outs["alg_len"],
    )


def sha_batch(chunks: Sequence[bytes], bits: int) -> List[bytes]:
    """SHA-256/384/512 (``bits``) of every chunk, in one native call,
    one thread a core."""
    if bits not in (256, 384, 512):
        raise ValueError(f"sha_batch: no SHA-2 of {bits} bits")
    n = len(chunks)
    if n == 0:
        return []
    data = np.frombuffer(b"".join(chunks) + b"\0", np.uint8)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    out_len = bits // 8
    out = np.empty(n * out_len, np.uint8)
    _lib().cap_sha_batch(data.ctypes.data_as(_U8P),
                         offsets.ctypes.data_as(_I64P), n, bits,
                         out.ctypes.data_as(_U8P), 0)
    raw = out.tobytes()
    return [raw[i * out_len:(i + 1) * out_len] for i in range(n)]
