"""Batched Ed25519 (EdDSA) verification: host side, packed records, and
the limb-domain finish around the RNS ladder.

The port of the JAX package's ``tpu/ed25519.py``, RNS branch (its
4-bit limb ladder ``_ed25519_core`` is not ported). The verify is the
device ladder's, everywhere in the port (the batch path, the host
oracle, the tests):

- the 32 key bytes decode by RFC 8032 §5.1.3 (:func:`decode_point`,
  which rejects y ≥ p and x = 0 with the sign bit set); a key that
  does not decode verifies False;
- S < L (rejects the malleable S + L forms);
- k = SHA-512(R ‖ A ‖ M) mod L, on the host (variable-length input);
- R' = [S]B + [k](−A), no cofactor;
- the 32-byte encoding of R' is compared with the R bytes, which also
  rejects every non-canonical R.

Host point arithmetic runs in extended coordinates (complete a = −1
formulas, one inversion per normalization): a Python modular inverse
costs as much as ~50 multiplies.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import limbs as L

# edwards25519 domain parameters (RFC 8032 §5.1).
P = (1 << 255) - 19
L_ORDER = (1 << 252) + 27742317777372353535851937790883648493
D_CONST = (-121665 * pow(121666, -1, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
K = 16                       # 256 bits of 16-bit limbs
NBITS = 253                  # max bit length of S and k (both < 2^253)

_BY = 4 * pow(5, -1, P) % P
_D2 = 2 * D_CONST % P


def decode_point(data: bytes) -> Optional[Tuple[int, int]]:
    """RFC 8032 §5.1.3 point decompression; None if not on the curve."""
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        return None
    y2 = y * y % P
    u = (y2 - 1) % P
    v = (D_CONST * y2 + 1) % P
    # candidate root x = (u/v)^((p+3)/8) = u·v³·(u·v⁷)^((p-5)/8)
    v3 = v * v % P * v % P
    x = u * v3 % P * pow(u * v3 % P * v3 % P * v % P, (P - 5) // 8, P) % P
    vx2 = v * x % P * x % P
    if vx2 == u:
        pass
    elif vx2 == (-u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return x, y


def encode_point(pt: Tuple[int, int]) -> bytes:
    """Affine point → its 32-byte encoding (y, x's parity in bit 255)."""
    x, y = pt
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


_B_POINT = decode_point(_BY.to_bytes(32, "little"))  # sign bit 0 → even x
assert _B_POINT is not None

_IDENTITY = (0, 1)


# ---------------------------------------------------------------------------
# Host arithmetic in extended coordinates (X:Y:Z:T), x = X/Z, y = Y/Z
# ---------------------------------------------------------------------------

def to_ext(pt: Tuple[int, int]) -> tuple:
    x, y = pt
    return (x, y, 1, x * y % P)


def ext_add(p1: tuple, p2: tuple) -> tuple:
    """Complete addition, a = −1 (add-2008-hwcd-3); doubles too."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * _D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def normalize(pts: Sequence[tuple]) -> List[Tuple[int, int]]:
    """Extended points → affine, with one inversion for all of them
    (Montgomery's trick; Z ≠ 0 always: the formulas are complete)."""
    pref = [1]
    for q in pts:
        pref.append(pref[-1] * q[2] % P)
    inv = pow(pref[-1], -1, P)
    out: List[Tuple[int, int]] = [(0, 0)] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        zi = pref[i] * inv % P
        inv = inv * pts[i][2] % P
        out[i] = (pts[i][0] * zi % P, pts[i][1] * zi % P)
    return out


def scalar_mult(k: int, pt: Tuple[int, int]) -> Tuple[int, int]:
    """Host [k]·pt, double-and-add (fixtures and the oracle only)."""
    acc = to_ext(_IDENTITY)
    add = to_ext(pt)
    while k:
        if k & 1:
            acc = ext_add(acc, add)
        add = ext_add(add, add)
        k >>= 1
    return normalize([acc])[0]


def py_ed25519_verify(key_bytes: bytes, sig: bytes, msg: bytes) -> bool:
    """Pure-integer Ed25519 verify with the device ladder's semantics
    (module docstring): the host oracle of the port."""
    a = decode_point(key_bytes)
    if a is None or len(sig) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L_ORDER:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + key_bytes + msg)
                       .digest(), "little") % L_ORDER
    sb = scalar_mult(s, _B_POINT)
    ka = scalar_mult(k, ((P - a[0]) % P, a[1]))
    r = normalize([ext_add(to_ext(sb), to_ext(ka))])[0]
    return encode_point(r) == sig[:32]


class HostEd25519PublicKey:
    """Dependency-free Ed25519 public key: its 32 raw bytes.

    Any 32 bytes are accepted, as OpenSSL's raw-key import accepts them;
    bytes that do not decode to a curve point make a key whose tokens
    always verify False.
    """

    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("An Ed25519 public key is 32 bytes long")
        self.raw = bytes(raw)

    @classmethod
    def from_seed(cls, seed: bytes) -> "HostEd25519PublicKey":
        """The public key of an RFC 8032 32-byte private seed."""
        return cls(encode_point(scalar_mult(_secret_scalar(seed),
                                            _B_POINT)))


def _secret_scalar(seed: bytes) -> int:
    h = hashlib.sha512(seed).digest()
    a = bytearray(h[:32])
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(a, "little")


def ed25519_sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 §5.1.6 signature of ``msg`` under a 32-byte seed
    (fixtures only: nothing here is constant-time)."""
    h = hashlib.sha512(seed).digest()
    a = _secret_scalar(seed)
    pub = encode_point(scalar_mult(a, _B_POINT))
    r = int.from_bytes(hashlib.sha512(h[32:] + msg).digest(),
                       "little") % L_ORDER
    rb = encode_point(scalar_mult(r, _B_POINT))
    k = int.from_bytes(hashlib.sha512(rb + pub + msg).digest(),
                       "little") % L_ORDER
    return rb + ((r + k * a) % L_ORDER).to_bytes(32, "little")


# ---------------------------------------------------------------------------
# Field constants and the key table
# ---------------------------------------------------------------------------

class _FieldConsts:
    """[K, 1] int64 limb columns of the field constants, per device:
    p, p' (Montgomery), R² mod p and L. (The JAX package also carries
    R mod p and p − 2 for its device Fermat ladder; the port inverts
    the batch's root with a host ``pow``.)"""

    def __init__(self):
        from .bignum import mont_params

        pprime, pr2, _ = mont_params(P, K)
        self.host = [L.int_to_limbs(v, K).astype(np.int64) for v in
                     (P, pprime, pr2, L_ORDER)]
        self._dev: Dict[torch.device, tuple] = {}

    def device(self, device) -> tuple:
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = tuple(
                torch.as_tensor(v, device=device)[:, None]
                for v in self.host)
        return self._dev[device]


_CONSTS: Optional[_FieldConsts] = None


def consts() -> _FieldConsts:
    global _CONSTS
    if _CONSTS is None:
        _CONSTS = _FieldConsts()
    return _CONSTS


class Ed25519KeyTable:
    """The Ed25519 public keys of a keyset on a device.

    ``keys``: :class:`HostEd25519PublicKey` (``.raw``) or raw 32-byte
    strings. Keys that do not decode are kept (their row is the
    identity table) and flagged in ``invalid``: their tokens verify
    False. The RNS window table (``ed25519_rns.Ed25519RNSKeyTable``) is
    built at first use, or installed from the JAX package's arrays by
    ``convert``.
    """

    def __init__(self, keys: Sequence, device="cuda"):
        self.key_bytes: List[bytes] = [getattr(k, "raw", k) for k in keys]
        self.keys = list(keys)
        self.decoded = [decode_point(raw) for raw in self.key_bytes]
        self.invalid = np.asarray([a is None for a in self.decoded], bool)
        self.device = torch.device(device)
        self._rns = None

    def rns(self):
        if self._rns is None:
            from . import ed25519_rns

            self._rns = ed25519_rns.Ed25519RNSKeyTable(self.decoded)
        return self._rns


# ---------------------------------------------------------------------------
# Packed single-transfer dispatch: one u8 record matrix per chunk
# ---------------------------------------------------------------------------

ED_REC_EXTRA = 2          # trailing bytes per record: flags, key row


def _ed_records(table: Ed25519KeyTable, sigs: Sequence[bytes],
                msgs: Sequence[bytes], key_idx: np.ndarray,
                width: int) -> np.ndarray:
    """Host: [N, width ≥ 97] u8 rows, zero past byte 96: R‖S (64) ‖
    k = SHA-512(R‖A‖M) mod L as 32 little-endian bytes ‖ validity flag
    u8 (length ok AND key decodes). The k hash is host work (variable-length input), one
    native ``sha_batch`` call a chunk; everything after it runs on the
    device."""
    from ..runtime.native_binding import sha_batch

    rec = np.zeros((len(sigs), width), np.uint8)
    chunks: List[bytes] = []
    live: List[int] = []
    for j, sg in enumerate(sigs):
        row = int(key_idx[j])
        if len(sg) == 64:
            rec[j, :64] = np.frombuffer(sg, np.uint8)
            rec[j, 96] = not table.invalid[row]
            chunks.append(sg[:32] + table.key_bytes[row] + msgs[j])
            live.append(j)
    for j, h in zip(live, sha_batch(chunks, 512)):
        kk = int.from_bytes(h, "little") % L_ORDER
        rec[j, 64:96] = np.frombuffer(kk.to_bytes(32, "little"), np.uint8)
    return rec


def ed_packed_records(table: Ed25519KeyTable, sigs: Sequence[bytes],
                      msgs: Sequence[bytes],
                      key_idx: np.ndarray) -> np.ndarray:
    """Host: packed [N, 64 + 32 + 2] u8 records for one EdDSA chunk:
    the rows of :func:`_ed_records` ‖ key row u8."""
    rec = _ed_records(table, sigs, msgs, key_idx, 96 + ED_REC_EXTRA)
    rec[:, 97] = np.asarray(key_idx).astype(np.uint8)
    return rec


def _le_bytes_to_limbs(mat: torch.Tensor) -> torch.Tensor:
    """[N, 2K] u8 little-endian → [K, N] int64 limbs."""
    m = mat.to(torch.int64)
    return (m[:, 0::2] | (m[:, 1::2] << 8)).T


def _ed_packed_unpack(packed: torch.Tensor):
    """Record matrix → (s, kk, yr [K, N] limbs, sign_r [N], idx, flags)."""
    sig = packed[:, :64]
    flags = packed[:, 96] != 0
    idx = packed[:, 97].to(torch.int64)
    sign_r = (sig[:, 31] >> 7).to(torch.int64)
    r_clr = sig[:, :32].clone()
    r_clr[:, 31] &= 0x7F
    yr = _le_bytes_to_limbs(r_clr)
    s = _le_bytes_to_limbs(sig[:, 32:64])
    kk = _le_bytes_to_limbs(packed[:, 64:96])
    return s, kk, yr, sign_r, idx, flags


def _ed_verify(packed: torch.Tensor, idx: torch.Tensor,
               table: Ed25519KeyTable) -> torch.Tensor:
    """Records (the key row byte unread) and their [N] key rows → [N]
    bool."""
    from . import ed25519_rns

    s, kk, yr, sign_r, _, flags = _ed_packed_unpack(packed)
    ok = ed25519_rns._ed25519_rns_core(s, kk, yr, sign_r, idx, table.rns())
    return ok & flags


def verify_ed_packed_pending(table: Ed25519KeyTable,
                             rec: np.ndarray) -> torch.Tensor:
    """Queue one packed EdDSA chunk on the table's device; returns the
    device [N] bool. N must be a power of two ≥ 128 (the batch
    inverse's tree); padding rows compute on key row 0."""
    # the keyset hands over the card's chunks already on the device
    dev = (rec if torch.is_tensor(rec)
           else torch.from_numpy(np.ascontiguousarray(rec))).to(
        table.device)
    return _ed_verify(dev, dev[:, 97].to(torch.int64), table)


def verify_ed25519_batch_pending(table: Ed25519KeyTable,
                                 sigs: Sequence[bytes],
                                 msgs: Sequence[bytes],
                                 key_idx: np.ndarray) -> torch.Tensor:
    """Queue one EdDSA chunk given as lists (key classes of more than
    255 keys); returns the device [P] bool, P the token count padded to
    a power of two ≥ 128 (padding rows on key row 0, False).

    sigs: raw JOSE signatures (R ‖ S); msgs: signing inputs; key_idx:
    [N] table rows of any size. The same engine as the packed path (32
    edw launches, then redc); the rows go as an int64 tensor beside the
    records of :func:`_ed_records` (their key row byte left 0).
    """
    n_tok = len(sigs)
    pad = 128
    while pad < n_tok:
        pad *= 2
    rows = np.zeros(pad, np.int64)
    rows[:n_tok] = key_idx
    rec = np.zeros((pad, 96 + ED_REC_EXTRA), np.uint8)
    rec[:n_tok] = _ed_records(table, sigs, msgs, rows, 96 + ED_REC_EXTRA)
    dev = table.device
    return _ed_verify(torch.from_numpy(rec).to(dev),
                      torch.from_numpy(rows).to(dev), table)
