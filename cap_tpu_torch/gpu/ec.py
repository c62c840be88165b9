"""Batched ECDSA verification (P-256/P-384/P-521) in PyTorch.

The port of the JAX package's ES* engine. The scalar work (range
checks, s⁻¹ by a batched product tree, u1/u2) runs in 16-bit limbs
(``bignum``); the point work runs on one of two engines, the caller's
choice (``rns=``), each with one of two window-add laws (``ladder=``):

- RNS (the default): a two-chain ladder of w-bit windows (``w_bits=``,
  8 by default, the JAX package's ``CAP_TPU_EC_WBITS``) over
  precomputed tables in residue form (``ec_rns``), on the card the
  whole-ladder kernel (``jacobian``) or per-window affine adds whose
  divisions share one batched inversion, every multiply a REDC launch
  (``affine``);
- limbs (``rns=False``): 4-bit windows over Montgomery limb tables
  (:meth:`ECKeyTable.limb_tables`), plain PyTorch as in the JAX
  package, which runs this engine outside any Pallas kernel: mixed
  Jacobian + affine adds interleaving the G and Q chains
  (:func:`_jac_madd`), or two lane-concatenated affine chains with one
  batched inversion mod p a window (:func:`_affine_madd`).

The final check is projective on the Jacobian ladders: accept iff
X ≡ r·Z² or, when r + n < p, X ≡ (r+n)·Z² (mod p); the limb affine
ladder compares x with r (or r + n) directly.

Same-x exceptional cases in the ladder are flagged ``deg`` per token;
the caller re-verifies those on the pure-integer oracle
(:func:`py_ecdsa_verify`), the JAX package's own contract.

Host pieces that need no device — curve constants, affine arithmetic,
window-table precompute, the pure-integer key and oracle — keep no
``cryptography`` dependency, so the whole module runs where OpenSSL is
absent.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bignum as B
from . import limbs as L

LADDERS = ("jacobian", "affine")


def resolve_ladder(ladder: str) -> str:
    """The window-add law ``ladder`` if it is one (``jacobian`` or
    ``affine``); raises ``ValueError`` otherwise, in the JAX package's
    words."""
    if ladder not in LADDERS:
        raise ValueError(f"unknown EC ladder mode {ladder!r}")
    return ladder

# NIST curve domain parameters (FIPS 186-4 / SEC 2).
_CURVE_INTS = {
    "P-256": dict(
        p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
        n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
        gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
        coord_bytes=32,
    ),
    "P-384": dict(
        p=(1 << 384) - (1 << 128) - (1 << 96) + (1 << 32) - 1,
        n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFC7634D81F4372DDF581A0DB248B0A77AECEC196ACCC52973,  # noqa: E501
        gx=0xAA87CA22BE8B05378EB1C71EF320AD746E1D3B628BA79B9859F741E082542A385502F25DBF55296C3A545E3872760AB7,  # noqa: E501
        gy=0x3617DE4A96262C6F5D9E98BF9292DC29F8F41DBD289A147CE9DA3113B5F0B8C00A60B1CE1D7E819D7A431D7C90EA0E5F,  # noqa: E501
        coord_bytes=48,
    ),
    "P-521": dict(
        p=(1 << 521) - 1,
        n=int("01fffffffffffffffffffffffffffffffffffffffffffffffffffffff"
              "ffffffffffa51868783bf2f966b7fcc0148f709a5d03bb5c9b8899c47"
              "aebb6fb71e91386409", 16),
        gx=0x00C6858E06B70404E9CD9E3ECB662395B4429C648139053FB521F828AF606B4D3DBAA14B5E77EFE75928FE1DC127A2FFA8DE3348B3C1856A429BF97E7E31C2E5BD66,  # noqa: E501
        gy=0x011839296A789A3BC0045C8A5FB42C7D1BD998F54449579B446817AFBD17273E662C97EE72995EF42640C550B9013FAD0761353C7086A272C24088BE94769FD16650,  # noqa: E501
        coord_bytes=66,
    ),
}


class CurveParams:
    """Host-side per-curve constants (ints + packed limb arrays)."""

    def __init__(self, name: str):
        from .bignum import mont_params

        c = _CURVE_INTS[name]
        self.name = name
        self.p: int = c["p"]
        self.n: int = c["n"]
        self.gx: int = c["gx"]
        self.gy: int = c["gy"]
        self.coord_bytes: int = c["coord_bytes"]
        self.nbits: int = self.n.bit_length()
        self.k: int = L.nlimbs_for_bits(self.p.bit_length())

        k = self.k
        self.p_limbs = L.int_to_limbs(self.p, k)
        self.n_limbs = L.int_to_limbs(self.n, k)
        nprime, nr2, _ = mont_params(self.n, k)
        self.nprime_limbs = L.int_to_limbs(nprime, k)
        self.nr2_limbs = L.int_to_limbs(nr2, k)
        # the limb ladder's field constants: p' and R² mod p, and R mod
        # p (Montgomery 1; the limb tables hold x·R, y·R)
        pprime, pr2, self.pone = mont_params(self.p, k)
        self.field_limbs = [L.int_to_limbs(v, k)
                            for v in (pprime, pr2, self.pone)]
        self.pbits: int = self.p.bit_length()
        # 4-bit interleaved windows of the limb ladder
        self.n_windows = (self.nbits + 3) // 4
        self._dev: Dict[torch.device, tuple] = {}
        self._field_dev: Dict[torch.device, tuple] = {}
        self._g_tabs: Dict[torch.device, tuple] = {}

    def device_consts(self, device) -> tuple:
        """[K, 1] int64 columns of the scalar-field constants on
        ``device``: (n, N', R² mod n, p)."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = tuple(
                torch.as_tensor(v.astype(np.int64)[:, None], device=device)
                for v in (self.n_limbs, self.nprime_limbs, self.nr2_limbs,
                          self.p_limbs))
        return self._dev[device]

    def field_consts(self, device) -> tuple:
        """[K, 1] int64 columns of the limb ladder's field constants on
        ``device``: (p', R² mod p, R mod p)."""
        device = torch.device(device)
        if device not in self._field_dev:
            self._field_dev[device] = tuple(
                torch.as_tensor(v.astype(np.int64)[:, None], device=device)
                for v in self.field_limbs)
        return self._field_dev[device]

    def g_tables(self, device) -> tuple:
        """G's 4-bit window table on ``device`` (cached): (x, y) rows
        [n_windows·15, K] int64 as :func:`limb_window_rows` lays them
        out."""
        device = torch.device(device)
        if device not in self._g_tabs:
            self._g_tabs[device] = limb_window_rows(
                self, [(self.gx, self.gy)], device)
        return self._g_tabs[device]

    # -- host affine arithmetic (table precompute, oracle) ---------------

    def affine_add(self, P: Optional[Tuple[int, int]],
                   Q: Optional[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
        p = self.p
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1 - 3) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return x3, y3

    def window_multiples_many(self, points: Sequence[Tuple[int, int]],
                              w_bits: int, n_windows: int) -> list:
        """All d·2^{w·i}·point (d ∈ [1, 2^w−1], i ∈ [0, n_windows)) of
        every point, as [(X, Y)] affine int lists in row order
        i·(2^w−1) + (d−1).

        Affine throughout, every point's windows side by side: the
        window bases by w doublings each, then the chains d·B = (d−1)·B
        + B, each step's divisions over all points and windows sharing
        one inversion (Montgomery's trick). Never hits infinity or a
        same-x pair: d·2^{w·i} < 2^{w·n_windows} is never ≡ 0 or ±1 mod
        n apart from d = 1, for the prime-order points used here.
        """
        p = self.p
        per = (1 << w_bits) - 1
        m = len(points)
        # lane j·n_windows + i: window i of point j
        bx = [0] * (m * n_windows)
        by = [0] * (m * n_windows)
        bx[::n_windows] = [pt[0] for pt in points]
        by[::n_windows] = [pt[1] for pt in points]
        cx, cy = bx[::n_windows], by[::n_windows]
        for i in range(1, n_windows):
            for _ in range(w_bits):
                inv = batch_inverse([2 * y for y in cy], p)
                for j in range(m):
                    x, y = cx[j], cy[j]
                    lam = (3 * x * x - 3) * inv[j] % p
                    cx[j] = (lam * lam - 2 * x) % p
                    cy[j] = (lam * (x - cx[j]) - y) % p
            bx[i::n_windows], by[i::n_windows] = cx, cy
        out_x = [[0] * (n_windows * per) for _ in range(m)]
        out_y = [[0] * (n_windows * per) for _ in range(m)]
        lanes = m * n_windows
        cx, cy = bx[:], by[:]
        for d in range(1, per + 1):
            if d == 2:                       # 2·B: the tangent
                num = [(3 * x * x - 3) % p for x in cx]
                inv = batch_inverse([2 * y for y in cy], p)
            elif d > 2:                      # (d−1)·B + B: the chord
                num = [b - c for b, c in zip(by, cy)]
                inv = batch_inverse([b - c for b, c in zip(bx, cx)], p)
            if d > 1:
                for k in range(lanes):
                    lam = num[k] * inv[k] % p
                    x3 = (lam * lam - cx[k] - bx[k]) % p
                    cy[k] = (lam * (cx[k] - x3) - cy[k]) % p
                    cx[k] = x3
            for j in range(m):
                lo = j * n_windows
                out_x[j][d - 1::per] = cx[lo:lo + n_windows]
                out_y[j][d - 1::per] = cy[lo:lo + n_windows]
        return list(zip(out_x, out_y))


def batch_inverse(vals: Sequence[int], p: int) -> List[int]:
    """Every v⁻¹ mod p (no v ≡ 0) by one inversion and 3 products a value
    (Montgomery's trick)."""
    pref = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % p
    inv = pow(pref[-1], -1, p)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pref[i] * inv % p
        inv = inv * vals[i] % p
    return out


_CURVES_CACHE: Dict[str, CurveParams] = {}


def curve(name: str) -> CurveParams:
    if name not in _CURVES_CACHE:
        _CURVES_CACHE[name] = CurveParams(name)
    return _CURVES_CACHE[name]


_TABLE_GROUP = 32     # keys whose window chains share their inversions


def limb_window_rows(cp: CurveParams, points: Sequence[Tuple[int, int]],
                     device) -> tuple:
    """The limb ladder's 4-bit window tables of ``points`` on ``device``:
    (x, y) [len(points)·n_windows·15, K] int64 field-Montgomery rows,
    point j's row j·n_windows·15 + i·15 + (d − 1) holding d·2^{4i}·point
    (the JAX package's ``ECKeyTable.tqx``/``tqy`` layout). One chain a
    distinct point, 32 points sharing each inversion."""
    uniq = list(dict.fromkeys(points))
    mult = {}
    for g in range(0, len(uniq), _TABLE_GROUP):
        group = uniq[g:g + _TABLE_GROUP]
        mult.update(zip(group, cp.window_multiples_many(group, 4,
                                                        cp.n_windows)))
    p, r = cp.p, cp.pone
    return tuple(
        torch.as_tensor(L.ints_to_limbs(
            [v * r % p for pt in points for v in mult[pt][c]],
            cp.k).T.astype(np.int64), device=torch.device(device))
        for c in (0, 1))


class ECKeyTable:
    """The keys of one curve and their window tables on a device.

    ``keys``: :class:`HostECPublicKey` (or anything with
    ``public_numbers().x/.y``). Every table is built at first use: the
    RNS table of a window width (:meth:`rns`, ``ec_rns.ECRNSKeyTable``,
    which ``convert`` may install from the JAX package's arrays
    instead) by the RNS engine at that width, the limb tables
    (:meth:`limb_tables`) only by a call that runs the limb engine.
    """

    def __init__(self, crv: str, keys: Sequence, device="cuda"):
        self.curve = curve(crv)
        self.keys = list(keys)
        self.coord_bytes = self.curve.coord_bytes
        self.device = torch.device(device)
        self._rns: Dict[int, object] = {}     # window width → RNS table
        self._limb = None

    def rns(self, w_bits: int = 8):
        """The RNS window table at ``w_bits``-bit windows, one a width
        (P-256 with 8 keys: 13.5 MB at 8 bits, 149 MB at 12)."""
        if w_bits not in self._rns:
            from . import ec_rns

            self._rns[w_bits] = ec_rns.ECRNSKeyTable(
                self.curve.name, self.keys, w_bits=w_bits)
        return self._rns[w_bits]

    def limb_tables(self) -> tuple:
        """The limb engine's (tqx, tqy) window rows of every key on the
        table's device (:func:`limb_window_rows`)."""
        if self._limb is None:
            self._limb = limb_window_rows(
                self.curve, [(k.public_numbers().x, k.public_numbers().y)
                             for k in self.keys], self.device)
        return self._limb


def scalar_mult(cp: CurveParams, k: int,
                P: Optional[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
    """Host double-and-add k·P over the curve's affine arithmetic."""
    acc = None
    add = P
    while k:
        if k & 1:
            acc = cp.affine_add(acc, add)
        add = cp.affine_add(add, add)
        k >>= 1
    return acc


class HostECPublicKey:
    """Dependency-free EC public key: ``public_numbers().x/.y`` from
    host integers, the surface the tables and the oracle read."""

    class _Numbers:
        def __init__(self, x: int, y: int):
            self.x, self.y = x, y

    def __init__(self, crv: str, x: int, y: int):
        self.curve_name = crv
        self._nums = self._Numbers(x, y)

    def public_numbers(self):
        return self._nums

    @classmethod
    def from_private(cls, crv: str, d: int) -> "HostECPublicKey":
        cp = curve(crv)
        qx, qy = scalar_mult(cp, d, (cp.gx, cp.gy))
        return cls(crv, qx, qy)


def host_ecdsa_sign(crv: str, d: int, e: int, k: int) -> Tuple[int, int]:
    """Textbook ECDSA signing over host ints (fixtures only — k must be
    unique per signature; nothing here is constant-time). Returns
    (r, s); raises if the chosen k yields r == 0 or s == 0."""
    cp = curve(crv)
    # k·G by the oracle's Jacobian double-and-add (one inversion)
    R = _shamir(cp, k, 0, (cp.gx, cp.gy))
    r = R[0] % cp.n
    s = pow(k, -1, cp.n) * (e + r * d) % cp.n
    if r == 0 or s == 0:
        raise ValueError("degenerate nonce; pick another k")
    return r, s


def py_ecdsa_verify(cp: CurveParams, qx: int, qy: int, sig_raw: bytes,
                    digest: bytes) -> bool:
    """Pure-integer ECDSA verify (SEC1 §4.1.4), dependency-free.

    Same acceptance rule as Go crypto/ecdsa and OpenSSL: range checks
    1 <= r, s < n, left-bits hash truncation, accept iff
    (u1·G + u2·Q).x ≡ r (mod n).
    """
    cb = cp.coord_bytes
    r = int.from_bytes(sig_raw[:cb], "big")
    s = int.from_bytes(sig_raw[cb:], "big")
    if not (1 <= r < cp.n and 1 <= s < cp.n):
        return False
    e = int.from_bytes(digest, "big")
    excess = 8 * len(digest) - cp.nbits
    if excess > 0:
        e >>= excess
    w = pow(s, -1, cp.n)
    u1 = (e * w) % cp.n
    u2 = (r * w) % cp.n
    R = _shamir(cp, u1, u2, (qx, qy))
    if R is None:
        return False
    return R[0] % cp.n == r


def _shamir(cp: CurveParams, u1: int, u2: int,
            Q: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    """u1·G + u2·Q (affine, None for infinity) by one joint
    double-and-add over Jacobian coordinates (a = -3), adding the affine
    G, Q or G + Q each step: the oracle's one modular inversion is the
    final one."""
    p = cp.p
    G = (cp.gx, cp.gy)
    table = {1: G, 2: Q, 3: cp.affine_add(G, Q)}
    X = Y = Z = 0                      # Z == 0: the point at infinity
    for i in range(max(u1.bit_length(), u2.bit_length()) - 1, -1, -1):
        if Z:                          # dbl-2001-b
            delta = Z * Z % p
            gamma = Y * Y % p
            beta = X * gamma % p
            alpha = 3 * (X - delta) * (X + delta) % p
            X, Z = (alpha * alpha - 8 * beta) % p, ((Y + Z) ** 2 - gamma
                                                  - delta) % p
            Y = (alpha * (4 * beta - X) - 8 * gamma * gamma) % p
        pt = table[(u1 >> i & 1) | (u2 >> i & 1) << 1] \
            if (u1 >> i | u2 >> i) & 1 else None
        if pt is None:
            continue
        x2, y2 = pt
        if not Z:
            X, Y, Z = x2, y2, 1
            continue
        zz = Z * Z % p                 # mixed add, Jacobian + affine
        h = (x2 * zz - X) % p
        rr = (y2 * zz * Z - Y) % p
        if h == 0:
            if rr:
                X = Y = Z = 0          # P + (-P)
                continue
            X, Y = x2, y2              # P + P: double the affine point
            lam = (3 * X * X - 3) * pow(2 * Y, -1, p) % p
            x3 = (lam * lam - 2 * X) % p
            X, Y, Z = x3, (lam * (X - x3) - Y) % p, 1
            continue
        hh = h * h % p
        hhh = h * hh % p
        v = X * hh % p
        X3 = (rr * rr - hhh - 2 * v) % p
        Y = (rr * (v - X3) - Y * hhh) % p
        X, Z = X3, Z * h % p
    if not Z:
        return None
    zi = pow(Z, -1, p)
    return X * zi * zi % p, Y * zi * zi * zi % p


def _py_verify_one(table: ECKeyTable, row: int, sig_raw: bytes,
                   digest: bytes) -> bool:
    """Table-row wrapper over :func:`py_ecdsa_verify` (the oracle for
    lanes the device flags degenerate): the JAX package's
    ``_cpu_verify_one`` for a table without OpenSSL keys behind its
    rows, the only kind this port builds."""
    nums = table.keys[row].public_numbers()
    return py_ecdsa_verify(table.curve, nums.x, nums.y, sig_raw, digest)


# ---------------------------------------------------------------------------
# Packed single-transfer dispatch: one u8 record matrix per chunk
# ---------------------------------------------------------------------------

ES_REC_EXTRA = 2          # trailing bytes per record: flags, key row


def es_packed_records(table: ECKeyTable, sig_mat: np.ndarray,
                      sig_lens: np.ndarray, hash_mat: np.ndarray,
                      hash_len: int, key_idx: np.ndarray) -> np.ndarray:
    """Host: packed [N, 2·cb + hash_len + 2] u8 records for one ES* chunk.

    Row layout: signature r‖s bytes (2·cb) ‖ digest (hash_len) ‖
    validity flag u8 ‖ key row u8.
    """
    cb = table.curve.coord_bytes
    len_ok = (sig_lens == 2 * cb).astype(np.uint8)
    safe = np.where(len_ok[:, None] != 0, sig_mat[:, :2 * cb], 0)
    rec = np.empty((sig_mat.shape[0], 2 * cb + hash_len + ES_REC_EXTRA),
                   np.uint8)
    rec[:, :2 * cb] = safe
    rec[:, 2 * cb:2 * cb + hash_len] = hash_mat[:, :hash_len]
    rec[:, 2 * cb + hash_len] = len_ok
    rec[:, 2 * cb + hash_len + 1] = key_idx.astype(np.uint8)
    return rec


def _ec_prep(sig_bytes: torch.Tensor, dig: torch.Tensor, k: int):
    """Raw signature/digest bytes → (r, s, e) [K, N] int64 limbs.

    sig_bytes: [N, 2·cb] u8 (r ‖ s, each cb = 2k bytes wide); dig:
    [N, hlen] u8. e is the hash as an integer, left-zero-padded.
    """
    cb = sig_bytes.shape[1] // 2
    r = L.bytes_to_limbs_device(sig_bytes[:, :cb])
    s = L.bytes_to_limbs_device(sig_bytes[:, cb:])
    hlen = dig.shape[1]
    e_mat = torch.zeros((dig.shape[0], 2 * k), dtype=torch.uint8,
                        device=dig.device)
    e_mat[:, 2 * k - hlen:] = dig
    return r, s, L.bytes_to_limbs_device(e_mat)


# ---------------------------------------------------------------------------
# The limb engine (field values in Montgomery form unless noted)
# ---------------------------------------------------------------------------

def _jac_madd(X1, Y1, Z1, x2, y2, p, pp, one_m):
    """Mixed Jacobian + affine addition, 11 field products.

    Returns (X3, Y3, Z3, degenerate): the same-x cases (P = ±(x2, y2))
    are not computed but flagged, for the oracle; P at infinity (Z1 = 0)
    returns the affine addend.
    """
    z1z1 = B.mont_mul(Z1, Z1, p, pp)
    u2 = B.mont_mul(x2, z1z1, p, pp)
    s2 = B.mont_mul(y2, B.mont_mul(Z1, z1z1, p, pp), p, pp)
    h = B.sub_mod(u2, X1, p)
    hh = B.mont_mul(h, h, p, pp)
    i4 = B.add_mod(B.add_mod(hh, hh, p), B.add_mod(hh, hh, p), p)
    j = B.mont_mul(h, i4, p, pp)
    s2y1 = B.sub_mod(s2, Y1, p)
    rr = B.add_mod(s2y1, s2y1, p)
    v = B.mont_mul(X1, i4, p, pp)
    X3 = B.sub_mod(B.sub_mod(B.mont_mul(rr, rr, p, pp), j, p),
                   B.add_mod(v, v, p), p)
    y1j = B.mont_mul(Y1, j, p, pp)
    Y3 = B.sub_mod(B.mont_mul(rr, B.sub_mod(v, X3, p), p, pp),
                   B.add_mod(y1j, y1j, p), p)
    zh = B.add_mod(Z1, h, p)
    Z3 = B.sub_mod(B.sub_mod(B.mont_mul(zh, zh, p, pp), z1z1, p), hh, p)

    p_inf = B.is_zero(Z1)
    degenerate = ~p_inf & B.is_zero(h)       # doubling and ±inverse alike
    sel = p_inf[None, :]
    return (torch.where(sel, x2, X3), torch.where(sel, y2, Y3),
            torch.where(sel, one_m, Z3), degenerate)


def _affine_madd(x, y, inf, ax, ay, has, p, pp, one_m, p1, pp1, p_int):
    """Batched affine + affine addition, 2M + 1S and one batched
    inversion mod p over every lane (``bignum.batch_mont_inverse`` with
    the field's [K, 1] columns p1, pp1).

    x, y: [K, M] accumulator (canonical Montgomery form); inf: [M] lanes
    at infinity; ax, ay: table points (never infinity); has: [M] lanes
    that add this step. An accumulator at infinity takes the addend; a
    live lane with x == ax (doubling or inverse) is flagged
    ``degenerate`` for the oracle, its denominator replaced by 1 so the
    inversion stays defined. Returns (x3, y3, inf3, degenerate).
    """
    dx = B.sub_mod(ax, x, p)
    eqx = B.is_zero(dx)
    live = has & ~inf
    degenerate = live & eqx
    den = torch.where((live & ~eqx)[None, :], dx, one_m)
    inv = B.batch_mont_inverse(den, p1, pp1, p_int)
    lam = B.mont_mul(B.sub_mod(ay, y, p), inv, p, pp)
    sq = B.mont_mul(lam, lam, p, pp)
    x3 = B.sub_mod(B.sub_mod(sq, x, p), ax, p)
    y3 = B.sub_mod(B.mont_mul(lam, B.sub_mod(x, x3, p), p, pp), y, p)
    lift = (inf & has)[None, :]
    x3 = torch.where(lift, ax, x3)
    y3 = torch.where(lift, ay, y3)
    sel = has[None, :]
    return (torch.where(sel, x3, x), torch.where(sel, y3, y), inf & ~has,
            degenerate)


def _gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a [rows, K] table as [K, len(idx)] limbs."""
    return tab.index_select(0, idx).T


def _ecdsa_core(r, s, e, key_idx, tqx, tqy, cp: CurveParams,
                ladder: str = "jacobian"):
    """Batched ECDSA verify on the limb engine.

    r, s, e: [K, N] plain limbs (signature halves, hash integer); N a
    power of two (the batch inversions pair the lanes down); key_idx:
    [N] int64 rows into tqx/tqy [nk·n_windows·15, K]. ``jacobian``
    interleaves the G and Q chains in one mixed Jacobian + affine
    accumulator; ``affine`` runs :func:`_ecdsa_affine_tail`. Returns
    (ok [N], deg [N]).
    """
    k, n_tok = r.shape
    dev = r.device
    n_col, npp_col, nr2_col, p_col = cp.device_consts(dev)
    pp_col, pr2_col, pone_col = cp.field_consts(dev)
    p, pp, pr2, pone, n, npp = (c.expand(k, n_tok) for c in (
        p_col, pp_col, pr2_col, pone_col, n_col, npp_col))

    # 1. range checks 1 ≤ r, s < n
    r_ok = ~B.is_zero(r) & ~B.compare_ge(r, n)
    s_ok = ~B.is_zero(s) & ~B.compare_ge(s, n)

    # 2. w = s⁻¹ mod n (Montgomery domain) by the batched product tree;
    #    invalid s is replaced by 1 (rejected by s_ok anyway)
    one_plain = torch.zeros_like(r)
    one_plain[0] = 1
    s_safe = torch.where(s_ok[None, :], s, one_plain)
    s_m = B.mont_mul(s_safe, nr2_col.expand(k, n_tok), n, npp)
    w_m = B.batch_mont_inverse(s_m, n_col, npp_col, cp.n)

    # 3. u1 = e·w, u2 = r·w mod n (plain: the R factors cancel)
    u1 = B.mont_mul(e, w_m, n, npp)
    u2 = B.mont_mul(r, w_m, n, npp)

    # 4. R = Σ d1_i·(2^{4i}G) + d2_i·(2^{4i}Q) over precomputed rows
    dig1 = L.nibbles(u1, cp.n_windows)
    dig2 = L.nibbles(u2, cp.n_windows)
    key_base = key_idx.to(torch.int64) * (cp.n_windows * 15)
    tgx, tgy = cp.g_tables(dev)

    if ladder == "affine":
        return _ecdsa_affine_tail(r, r_ok, s_ok, dig1, dig2, key_base,
                                  tqx, tqy, tgx, tgy, cp)

    X, Y, Z = pone, pone, torch.zeros_like(r)    # infinity (Z = 0)
    deg = torch.zeros(n_tok, dtype=torch.bool, device=dev)
    for i in range(cp.n_windows):
        for tab_x, tab_y, d, row0 in ((tgx, tgy, dig1[i], i * 15),
                                      (tqx, tqy, dig2[i],
                                       key_base + i * 15)):
            has = d > 0
            idx = row0 + torch.where(has, d - 1, 0)
            Xa, Ya, Za, dd = _jac_madd(X, Y, Z, _gather(tab_x, idx),
                                       _gather(tab_y, idx), p, pp, pone)
            sel = has[None, :]
            X = torch.where(sel, Xa, X)
            Y = torch.where(sel, Ya, Y)
            Z = torch.where(sel, Za, Z)
            deg = deg | (dd & has)

    # 5. projective check: X ≡ r·Z² or X ≡ (r + n)·Z² (mod p)
    z2 = B.mont_mul(Z, Z, p, pp)
    ok1 = (X == B.mont_mul(B.mont_mul(r, pr2, p, pp), z2, p, pp)).all(dim=0)
    rpn_k, rpn_lt_p = _r_plus_n(r, n, p)
    rhs2 = B.mont_mul(B.mont_mul(rpn_k, pr2, p, pp), z2, p, pp)
    ok2 = (X == rhs2).all(dim=0) & rpn_lt_p
    ok = r_ok & s_ok & ~B.is_zero(Z) & (ok1 | ok2)
    return ok, deg & r_ok & s_ok


def _r_plus_n(r, n, p):
    """(r + n as [K, N] limbs, [N] bool r + n < p)."""
    k = r.shape[0]
    zero_row = torch.zeros_like(r[:1])
    rpn = B.carry_normalize(torch.cat([r + n, zero_row], dim=0))
    p_pad = torch.cat([p, zero_row], dim=0)
    return rpn[:k], ~B.compare_ge(rpn, p_pad)


def _ecdsa_affine_tail(r, r_ok, s_ok, dig1, dig2, key_base, tqx, tqy,
                       tgx, tgy, cp: CurveParams):
    """The affine ladder of :func:`_ecdsa_core`: the G and Q chains as
    two lane-concatenated affine accumulators ([K, 2N]), each window one
    :func:`_affine_madd` whose divisions share one inversion over the
    2N lanes; then one more affine add merges the chains (an inversion
    over N lanes) and x is compared with r·R (or (r + n)·R) directly.

    A chain of one scalar never meets its own window multiple, so only
    the merge can be degenerate (u1·G = ±u2·Q): flagged for the oracle
    as on the Jacobian ladder.
    """
    k, n_tok = r.shape
    dev = r.device
    n_col, _, _, p_col = cp.device_consts(dev)
    pp_col, pr2_col, pone_col = cp.field_consts(dev)
    p, pp, pr2, pone, n = (c.expand(k, n_tok) for c in (
        p_col, pp_col, pr2_col, pone_col, n_col))
    p2, pp2, pone2 = (c.expand(k, 2 * n_tok)
                      for c in (p_col, pp_col, pone_col))

    x, y = pone2, pone2
    inf = torch.ones(2 * n_tok, dtype=torch.bool, device=dev)
    deg = torch.zeros(2 * n_tok, dtype=torch.bool, device=dev)
    for i in range(cp.n_windows):
        d1, d2 = dig1[i], dig2[i]
        i1 = i * 15 + torch.where(d1 > 0, d1 - 1, 0)
        i2 = key_base + i * 15 + torch.where(d2 > 0, d2 - 1, 0)
        ax = torch.cat([_gather(tgx, i1), _gather(tqx, i2)], dim=1)
        ay = torch.cat([_gather(tgy, i1), _gather(tqy, i2)], dim=1)
        x, y, inf, dd = _affine_madd(x, y, inf, ax, ay,
                                     torch.cat([d1, d2]) > 0, p2, pp2,
                                     pone2, p_col, pp_col, cp.p)
        deg = deg | dd

    # merge: the Q accumulator as the addend; where it is at infinity,
    # the G accumulator passes through
    xm, _, inf_m, ddm = _affine_madd(
        x[:, :n_tok], y[:, :n_tok], inf[:n_tok], x[:, n_tok:],
        y[:, n_tok:], ~inf[n_tok:], p, pp, pone, p_col, pp_col, cp.p)
    deg = deg[:n_tok] | deg[n_tok:] | ddm

    # affine check: x == r·R or (r + n)·R (mod p), both canonical
    ok1 = (xm == B.mont_mul(r, pr2, p, pp)).all(dim=0)
    rpn_k, rpn_lt_p = _r_plus_n(r, n, p)
    ok2 = (xm == B.mont_mul(rpn_k, pr2, p, pp)).all(dim=0) & rpn_lt_p
    ok = r_ok & s_ok & ~inf_m & (ok1 | ok2)
    return ok, deg & r_ok & s_ok


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _es_verify(sig: torch.Tensor, dig: torch.Tensor, flags: torch.Tensor,
               idx: torch.Tensor, table: ECKeyTable, ladder: str,
               rns: bool, w_bits: int = 8):
    """[N] (ok, deg) of one chunk: :func:`_es_steps` run to its end."""
    return B.run_steps(_es_steps(sig, dig, flags, idx, table, ladder, rns,
                                 w_bits))


def _es_steps(sig, dig, flags, idx, table: ECKeyTable, ladder: str,
              rns: bool, w_bits: int = 8):
    """:func:`_es_verify` as a generator: on the RNS engine it yields
    before the batch inverse reads its root (``bignum.run_steps``)."""
    cp = table.curve
    r, s, e = _ec_prep(sig, dig, k=cp.k)
    if rns:
        from . import ec_rns

        ok, deg = yield from ec_rns._ecdsa_rns_core_steps(
            r, s, e, idx, table.rns(w_bits), cp, ladder=ladder)
    else:
        tqx, tqy = table.limb_tables()
        ok, deg = _ecdsa_core(r, s, e, idx, tqx, tqy, cp, ladder=ladder)
    return ok & flags, deg & flags


def verify_es_packed_pending(table: ECKeyTable, rec: np.ndarray,
                             hash_len: int, mesh=None):
    """Queue one packed ES* chunk on the table's device; returns the
    device ([N] ok, [N] deg) bool tensors (the RNS engine, the
    whole-ladder kernel).

    Degenerate-flagged tokens (deg True) must be re-verified on the
    pure-integer oracle by the caller after the sync. With a ``mesh``
    the record shards along the batch axis: each shard's core runs on
    its device over the window table there
    (``ECRNSKeyTable.device_tab``, built once a device), with its own
    batch inverse (one host ``pow`` of its root a shard, every shard's
    work queued up to its root before any root is read), and returns
    :class:`..parallel.place.Sharded` (ok, deg) in batch order.
    """
    cb = table.curve.coord_bytes

    def steps(dev):
        return _es_steps(dev[:, :2 * cb], dev[:, 2 * cb:2 * cb + hash_len],
                         dev[:, 2 * cb + hash_len] != 0,
                         dev[:, 2 * cb + hash_len + 1].to(torch.int64),
                         table, "jacobian", True)

    if mesh is not None:
        from ..parallel.place import on_shards, shard_batch

        # the RNS engine reads its tables where the shard's tensors live
        return on_shards(mesh, lambda i, r: steps(r), shard_batch(mesh, rec))
    # the keyset hands over the card's chunks already on the device
    return B.run_steps(steps((rec if torch.is_tensor(rec) else
                              torch.from_numpy(np.ascontiguousarray(rec))).to(
        table.device)))


def verify_ecdsa_arrays_pending(table: ECKeyTable, sig_mat: np.ndarray,
                                sig_lens: np.ndarray, hash_mat: np.ndarray,
                                hash_len: int, key_idx: np.ndarray,
                                ladder: str = "jacobian", rns: bool = True,
                                w_bits: int = 8):
    """Queue one ES* chunk given as arrays (key classes of more than 255
    keys); returns the device ([P] ok, [P] deg) bool tensors, P the
    token count padded to a power of two ≥ 128 (padding rows False).
    ``w_bits``: the RNS ladder's window width (the limb engine keeps
    its 4-bit windows).

    sig_mat: [N, ≥ 2·cb] left-aligned JOSE r ‖ s; sig_lens: [N];
    hash_mat: [N, ≥ hash_len] digests; key_idx: [N] table rows of any
    size. The same engines as the packed path; lanes flagged deg must
    be re-verified on :func:`_py_verify_one` by the caller after the
    sync.
    """
    resolve_ladder(ladder)
    cb = table.curve.coord_bytes
    n_tok = sig_mat.shape[0]
    n_pad = 128
    while n_pad < n_tok:
        n_pad *= 2
    len_ok = np.zeros(n_pad, bool)
    len_ok[:n_tok] = sig_lens == 2 * cb
    sig = np.zeros((n_pad, 2 * cb), np.uint8)
    sig[:n_tok] = np.where(len_ok[:n_tok, None], sig_mat[:, :2 * cb], 0)
    dig = np.zeros((n_pad, hash_len), np.uint8)
    dig[:n_tok] = hash_mat[:, :hash_len]
    idx = np.zeros(n_pad, np.int64)
    idx[:n_tok] = key_idx
    dev = table.device
    return _es_verify(torch.from_numpy(sig).to(dev),
                      torch.from_numpy(dig).to(dev),
                      torch.from_numpy(len_ok).to(dev),
                      torch.from_numpy(idx).to(dev), table, ladder, rns,
                      w_bits)


def verify_ecdsa_arrays(table: ECKeyTable, sig_mat: np.ndarray,
                        sig_lens: np.ndarray, hash_mat: np.ndarray,
                        hash_len: int, key_idx: np.ndarray,
                        ladder: str = "jacobian", rns: bool = True,
                        w_bits: int = 8) -> np.ndarray:
    """[N] bool verdicts of :func:`verify_ecdsa_arrays_pending`'s chunk,
    its flagged lanes re-verified on the oracle."""
    n_tok = sig_mat.shape[0]
    ok_dev, deg_dev = verify_ecdsa_arrays_pending(
        table, sig_mat, sig_lens, hash_mat, hash_len, key_idx,
        ladder=ladder, rns=rns, w_bits=w_bits)
    ok = ok_dev.cpu().numpy()[:n_tok].copy()
    cb = table.curve.coord_bytes
    for j in np.nonzero(deg_dev.cpu().numpy()[:n_tok])[0]:
        ok[j] = _py_verify_one(table, int(key_idx[j]),
                               sig_mat[j, :2 * cb].tobytes(),
                               hash_mat[j, :hash_len].tobytes())
    return ok


def verify_ecdsa_batch(table: ECKeyTable, sigs: Sequence[bytes],
                       msg_hashes: Sequence[bytes], key_idx: np.ndarray,
                       ladder: str = "jacobian", rns: bool = True,
                       w_bits: int = 8) -> np.ndarray:
    """[N] bool verdicts for one ES* bucket given as lists of raw JOSE
    signatures and digests (all of one length); ``ladder``, ``rns`` and
    ``w_bits`` (the RNS ladder's window width, 8 or 12 bits where the
    JAX package reads ``CAP_TPU_EC_WBITS``) pick the engine."""
    w = 2 * table.curve.coord_bytes
    n_tok = len(sigs)
    sig_mat = np.zeros((n_tok, w), np.uint8)
    sig_lens = np.fromiter((len(sg) for sg in sigs), np.int64, n_tok)
    for j, sg in enumerate(sigs):
        if len(sg) == w:
            sig_mat[j] = np.frombuffer(sg, np.uint8)
    hash_len = len(msg_hashes[0]) if msg_hashes else 32
    hash_mat = np.zeros((n_tok, hash_len), np.uint8)
    for j, h in enumerate(msg_hashes):
        hash_mat[j] = np.frombuffer(h[:hash_len], np.uint8)
    return verify_ecdsa_arrays(table, sig_mat, sig_lens, hash_mat,
                               hash_len, key_idx, ladder=ladder, rns=rns,
                               w_bits=w_bits)
