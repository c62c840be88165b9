"""Batched Ed25519 (EdDSA) verification: host side, packed records, the
limb-domain finish around the RNS ladder, and the limb ladder.

The port of the JAX package's ``tpu/ed25519.py``. Two engines, the
caller's choice (``rns=``): the RNS ladder (``ed25519_rns``, 8-bit
windows, the ``edw`` kernel on the card; the default) and the limb
ladder (``rns=False``: 4-bit windows over 16-bit Montgomery limbs,
complete mixed adds, digit 0 the identity row, plain PyTorch as in the
JAX package, which runs it outside any Pallas kernel). The verify is
the device ladder's, everywhere in the port (the batch path, the host
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

from . import bignum as B
from . import limbs as L

# edwards25519 domain parameters (RFC 8032 §5.1).
P = (1 << 255) - 19
L_ORDER = (1 << 252) + 27742317777372353535851937790883648493
D_CONST = (-121665 * pow(121666, -1, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
K = 16                       # 256 bits of 16-bit limbs
NBITS = 253                  # max bit length of S and k (both < 2^253)
N_WINDOWS = (NBITS + 3) // 4  # 4-bit windows of the limb ladder

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
    p, p' (Montgomery), R² mod p and L, and R mod p (Montgomery 1, the
    limb ladder's). (The JAX package also carries p − 2 for its device
    Fermat ladder; the port inverts the batch's root with a host
    ``pow``.)"""

    def __init__(self):
        from .bignum import mont_params

        pprime, pr2, self.pone_int = mont_params(P, K)
        self.host = [L.int_to_limbs(v, K).astype(np.int64) for v in
                     (P, pprime, pr2, L_ORDER, self.pone_int)]
        self._dev: Dict[torch.device, tuple] = {}

    def device(self, device) -> tuple:
        """(p, p', R² mod p, L) columns on ``device``."""
        return self._columns(device)[:4]

    def one_m(self, device) -> torch.Tensor:
        """R mod p as a [K, 1] column on ``device``."""
        return self._columns(device)[4]

    def _columns(self, device) -> tuple:
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


def _window_triple_rows(pts: Sequence[Tuple[int, int]]) -> np.ndarray:
    """The limb ladder's 4-bit window tables of ``pts``: [3, len(pts)·
    N_WINDOWS·16, K] uint32, point j's row j·N_WINDOWS·16 + i·16 + d
    holding the Montgomery-form triple (y − x, y + x, 2dxy) of
    d·2^{4i}·pt (d = 0: the identity, which the complete formulas
    absorb, so the ladder needs no skip mask). The multiples run in
    extended coordinates and normalize with one inversion."""
    ext = []
    for pt in pts:
        base = to_ext(pt)
        for _ in range(N_WINDOWS):
            acc = to_ext(_IDENTITY)
            ext.append(acc)
            for _ in range(15):
                acc = ext_add(acc, base)
                ext.append(acc)
            base = ext_add(acc, base)                 # 2^4 · base
    r = consts().pone_int
    aff = normalize(ext)
    return np.stack([L.ints_to_limbs(vals, K).T for vals in (
        [(y - x) * r % P for x, y in aff],
        [(y + x) * r % P for x, y in aff],
        [_D2 * x % P * y % P * r % P for x, y in aff])])


_B_TABLE: Dict[torch.device, tuple] = {}


def b_table(device) -> tuple:
    """The basepoint's limb window table on ``device`` (cached): 3 ×
    [N_WINDOWS·16, K] int64."""
    device = torch.device(device)
    if device not in _B_TABLE:
        rows = _window_triple_rows([_B_POINT]).astype(np.int64)
        _B_TABLE[device] = tuple(torch.as_tensor(t, device=device)
                                 for t in rows)
    return _B_TABLE[device]


class Ed25519KeyTable:
    """The Ed25519 public keys of a keyset on a device.

    ``keys``: :class:`HostEd25519PublicKey` (``.raw``) or raw 32-byte
    strings. Keys that do not decode are kept (their row is the
    identity table) and flagged in ``invalid``: their tokens verify
    False. Both window tables are built at first use: the RNS table
    (``ed25519_rns.Ed25519RNSKeyTable``, which ``convert`` may install
    from the JAX package's arrays instead) by the RNS engine, the limb
    table of −A (:meth:`tna`) only by a call that runs the limb
    engine.
    """

    def __init__(self, keys: Sequence, device="cuda"):
        self.key_bytes: List[bytes] = [getattr(k, "raw", k) for k in keys]
        self.keys = list(keys)
        self.decoded = [decode_point(raw) for raw in self.key_bytes]
        self.invalid = np.asarray([a is None for a in self.decoded], bool)
        self.device = torch.device(device)
        self._rns = None
        self._tna = None

    def rns(self):
        if self._rns is None:
            from . import ed25519_rns

            self._rns = ed25519_rns.Ed25519RNSKeyTable(self.decoded)
        return self._rns

    def tna(self) -> tuple:
        """The limb ladder's window tables of each key's −A (the
        identity for a key that does not decode), 3 × [nk·N_WINDOWS·16,
        K] int64 on the table's device, one chain a distinct point."""
        if self._tna is None:
            pts = [_IDENTITY if a is None else ((P - a[0]) % P, a[1])
                   for a in self.decoded]
            uniq = list(dict.fromkeys(pts))
            rows = _window_triple_rows(uniq).reshape(
                3, len(uniq), N_WINDOWS * 16, K)
            pick = [uniq.index(pt) for pt in pts]
            self._tna = tuple(torch.as_tensor(
                t[pick].reshape(-1, K).astype(np.int64), device=self.device)
                for t in rows)
        return self._tna


# ---------------------------------------------------------------------------
# The limb ladder (field values in Montgomery form unless noted)
# ---------------------------------------------------------------------------

def _edw_madd(X, Y, Z, T, ym, yp, t2, p, pp):
    """Mixed extended + affine-triple addition, a = −1
    (madd-2008-hwcd-3), 7M; complete on edwards25519 (doubling,
    inverses and the identity on either side included)."""
    a = B.mont_mul(B.sub_mod(Y, X, p), ym, p, pp)
    b = B.mont_mul(B.add_mod(Y, X, p), yp, p, pp)
    c = B.mont_mul(T, t2, p, pp)
    d = B.add_mod(Z, Z, p)
    e = B.sub_mod(b, a, p)
    f = B.sub_mod(d, c, p)
    g = B.add_mod(d, c, p)
    h = B.add_mod(b, a, p)
    return (B.mont_mul(e, f, p, pp), B.mont_mul(g, h, p, pp),
            B.mont_mul(f, g, p, pp), B.mont_mul(e, h, p, pp))


def _ed25519_core(s, kk, yr, sign_r, bad_key, key_idx, tna,
                  tb) -> torch.Tensor:
    """Batched Ed25519 verify on the limb engine.

    s, kk: [K, N] plain scalar limbs (S; k = H(R‖A‖M) mod L), N a power
    of two ≥ 128 (the batch inverse's tree); yr: [K, N] limbs of R's y
    (sign bit cleared); sign_r: [N] its sign bit; bad_key: [N] bool;
    key_idx: [N] int64 rows; tna, tb: the −A and B tables. R' = [S]B +
    [k](−A) by 2·N_WINDOWS mixed adds from the identity, normalized
    with one batched inversion of Z, its encoding compared with R's.
    Returns ok [N].
    """
    k, n_tok = s.shape
    dev = s.device
    p1, pp1, _, l1 = consts().device(dev)
    p, pp, pone, l_ = (c.expand(k, n_tok)
                       for c in (p1, pp1, consts().one_m(dev), l1))
    s_ok = ~B.compare_ge(s, l_)            # S < L (canonical S)

    dig1, dig2 = L.nibbles(s, N_WINDOWS), L.nibbles(kk, N_WINDOWS)
    key_base = key_idx.to(torch.int64) * (N_WINDOWS * 16)
    X, Y, Z, T = torch.zeros_like(s), pone, pone, torch.zeros_like(s)
    for i in range(N_WINDOWS):
        for tab, idx in ((tb, i * 16 + dig1[i]),
                         (tna, key_base + i * 16 + dig2[i])):
            ym, yp, t2 = (t.index_select(0, idx).T for t in tab)
            X, Y, Z, T = _edw_madd(X, Y, Z, T, ym, yp, t2, p, pp)

    # affine normalize (Z ≠ 0: the formulas are complete), leave the
    # Montgomery domain, compare the encoding with R's (which rejects
    # every non-canonical R: y < p always)
    zinv = B.batch_mont_inverse(Z, p1, pp1, P)
    one = torch.zeros_like(s)
    one[0] = 1
    x = B.mont_mul(B.mont_mul(X, zinv, p, pp), one, p, pp)
    y = B.mont_mul(B.mont_mul(Y, zinv, p, pp), one, p, pp)
    enc_ok = (y == yr).all(dim=0) & ((x[0] & 1) == sign_r)
    return s_ok & enc_ok & ~bad_key


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
               table: Ed25519KeyTable, rns: bool) -> torch.Tensor:
    """Records (the key row byte unread) and their [N] key rows → [N]
    bool, on the RNS engine or (``rns=False``) the limb engine."""
    return B.run_steps(_ed_steps(packed, idx, table, rns))


def _ed_steps(packed: torch.Tensor, idx: torch.Tensor,
              table: Ed25519KeyTable, rns: bool):
    """:func:`_ed_verify` as a generator: on the RNS engine it yields
    before the batch inverse reads its root (``bignum.run_steps``)."""
    s, kk, yr, sign_r, _, flags = _ed_packed_unpack(packed)
    if rns:
        from . import ed25519_rns

        ok = yield from ed25519_rns._ed25519_rns_core_steps(
            s, kk, yr, sign_r, idx, table.rns())
    else:
        # a key that does not decode has its flag cleared already
        ok = _ed25519_core(s, kk, yr, sign_r, torch.zeros_like(flags), idx,
                           table.tna(), b_table(packed.device))
    return ok & flags


def verify_ed_packed_pending(table: Ed25519KeyTable, rec: np.ndarray,
                             mesh=None):
    """Queue one packed EdDSA chunk on the table's device (the RNS
    engine); returns the device [N] bool. Padding rows compute on key
    row 0. The batch inverse's tree pairs lanes down to a 128-lane root
    from a power of two above 128; a batch of 128 lanes or fewer is its
    own root, each lane inverted by the host ``pow``. With a ``mesh``
    the record shards along the batch axis (a 128-row chunk over 8
    shards: 16 lanes a shard, each shard its own root) and the verdicts
    come back as :class:`..parallel.place.Sharded` in batch order,
    every shard's 32 windows queued before any shard's inverse root is
    read."""
    def steps(dev):
        return _ed_steps(dev, dev[:, 97].to(torch.int64), table, True)

    if mesh is not None:
        from ..parallel.place import on_shards, shard_batch

        # the RNS engine reads its tables where the shard's tensors live
        return on_shards(mesh, lambda i, r: steps(r), shard_batch(mesh, rec))
    # the keyset hands over the card's chunks already on the device
    return B.run_steps(steps((rec if torch.is_tensor(rec) else
                              torch.from_numpy(np.ascontiguousarray(rec))).to(
        table.device)))


def verify_ed25519_batch_pending(table: Ed25519KeyTable,
                                 sigs: Sequence[bytes],
                                 msgs: Sequence[bytes],
                                 key_idx: np.ndarray,
                                 rns: bool = True) -> torch.Tensor:
    """Queue one EdDSA chunk given as lists (key classes of more than
    255 keys); returns the device [P] bool, P the token count padded to
    a power of two ≥ 128 (padding rows on key row 0, False).

    sigs: raw JOSE signatures (R ‖ S); msgs: signing inputs; key_idx:
    [N] table rows of any size. The same engines as the packed path (on
    the RNS engine 32 edw launches, then redc); the rows go as an int64
    tensor beside the records of :func:`_ed_records` (their key row byte
    left 0).
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
                      torch.from_numpy(rows).to(dev), table, rns)


def verify_ed25519_batch(table: Ed25519KeyTable, sigs: Sequence[bytes],
                         msgs: Sequence[bytes], key_idx: np.ndarray,
                         rns: bool = True) -> np.ndarray:
    """[N] bool verdicts for one EdDSA bucket (the synchronous form of
    :func:`verify_ed25519_batch_pending`)."""
    return verify_ed25519_batch_pending(
        table, sigs, msgs, key_idx, rns=rns).cpu().numpy()[:len(sigs)]
