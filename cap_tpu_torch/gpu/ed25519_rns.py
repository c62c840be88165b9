"""Ed25519 point arithmetic in residue-number-system form.

The port of the JAX package's ``ed25519_rns``, the same design as
``ec_rns``: the extended-Edwards ladder runs on carry-free residue
pairs (23 + 23 channels; the P-256 context's primes), with complete
a = −1 mixed additions of 7 RNS multiplies each and window tables of
A-domain residue triples (y−x, y+x, 2dxy) that hold the identity at
digit 0 — no masks, no infinity lane, no degenerate cases. The finish
converts X, Y, Z back to 16-bit limbs by CRT (``rns.RNSToLimbs``) and
runs the limb engine's batch inverse and the encoding compare (x's
parity is not a residue-domain property).

On the card every window (its table gather and mixed add) is one
launch of the hand-written kernel ``cuda_edw.edw_window``, over the
packed row-major table of ``Ed25519RNSKeyTable.device_tab`` and the
row index that :func:`window_rows` builds once a chunk; the
accumulator merge's three multiply layers are ``cuda_redc.redc``
launches. The field ops take the REDC as a parameter so the plain
version (``cuda_edw.edw_ref``) runs the same arithmetic with the plain
REDC.

Value bounds (the JAX package's): every rmul output < 3p; sums grow to
≤ 10p between multiplies; A ≥ 2^14·p keeps λ₁λ₂p²/A ≪ p.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_edw, cuda_redc
from .ec_rns import _pack_residue_rows, radd, rmul, rmul_many, rsub
from .ed25519 import (
    _B_POINT,
    _IDENTITY,
    D_CONST,
    K,
    NBITS,
    P,
    consts,
    ext_add,
    normalize,
    to_ext,
)
from .rns import FieldRNSContext, I32

W_BITS = 8                              # byte-aligned window digits
NW8 = (NBITS + W_BITS - 1) // W_BITS    # 32 windows
PER = 1 << W_BITS                       # 256 entries incl. identity at d=0


class Ed25519RNSContext(FieldRNSContext):
    """Field context for p = 2^255 − 19 (shared FieldRNSContext build;
    ``to_limbs`` reconstructs K + 1 limbs: values < 3p < 2^257)."""

    def __init__(self):
        super().__init__(P, K)


_CTX: Optional[Ed25519RNSContext] = None


def ctx() -> Ed25519RNSContext:
    global _CTX
    if _CTX is None:
        _CTX = Ed25519RNSContext()
    return _CTX


def _edw_madd_rns(c, X, Y, Z, T, ym, yp, t2, redc=cuda_redc.redc):
    """Complete mixed addition (madd-2008-hwcd-3, a = −1), RNS pairs.

    State digit-canonical with values < 3p in and out; table triples
    < p. 7 field multiplies in 2 REDC layers.
    """
    # lazy digit bounds (units of m): state ≤ m in; products ≤ 12m²
    a, b, cc = rmul_many(
        c, [(rsub(c, Y, X, 4, guard=1), ym),
            (radd(c, Y, X), yp), (T, t2)], redc)
    d = radd(c, Z, Z)                        # ≤ 2m
    e = rsub(c, b, a, 4, guard=1)            # ≤ 3m
    f = rsub(c, d, cc, 4, guard=1)           # ≤ 4m
    g = radd(c, d, cc)                       # ≤ 3m
    h = radd(c, b, a)                        # ≤ 2m
    return tuple(rmul_many(c, [(e, f), (g, h), (f, g), (e, h)], redc))


def _twod_dom(c: Ed25519RNSContext, device):
    """A-domain residue columns of the curve constant 2d."""
    v = 2 * D_CONST % P * c.a_mod_p % P
    return tuple(torch.as_tensor([[v % int(m)] for m in base.m], dtype=I32,
                                 device=device) for base in (c.A, c.B))


def _edw_add_rns(c, P1, P2, twod, redc=cuda_redc.redc):
    """Complete extended + extended addition (add-2008-hwcd-3, a = −1),
    RNS pairs: merges the two ladder accumulators, once per chunk, in
    three REDC layers. Inputs < 3p with canonical digits; outputs
    likewise."""
    X1, Y1, Z1, T1 = P1
    X2, Y2, Z2, T2 = P2
    a, b, t12, z12 = rmul_many(
        c, [(rsub(c, Y1, X1, 4, guard=1), rsub(c, Y2, X2, 4, guard=1)),
            (radd(c, Y1, X1), radd(c, Y2, X2)),
            (T1, T2), (Z1, Z2)], redc)       # λ ≤ 49, ≤ 9m² → < 3p, ≤ m
    cc = rmul(c, t12, twod, redc)            # < 3p, ≤ m
    d = radd(c, z12, z12)                    # < 6p, ≤ 2m
    e = rsub(c, b, a, 4, guard=1)            # < 7p, ≤ 3m
    f = rsub(c, d, cc, 4, guard=1)           # < 10p, ≤ 4m
    g = radd(c, d, cc)                       # < 9p, ≤ 3m
    h = radd(c, b, a)                        # < 6p, ≤ 2m
    return tuple(rmul_many(c, [(e, f), (g, h), (f, g), (e, h)], redc))


# ---------------------------------------------------------------------------
# Window tables
# ---------------------------------------------------------------------------

def _residue_matrix(c: Ed25519RNSContext, vals: Sequence[int]) -> np.ndarray:
    """[I_A + I_B, len(vals)] int32 residues of host ints < 2^256.

    Bytes-of-value × (256^j mod mᵢ) as one float64 matmul — exact,
    every term < 255·2^13 and 32 terms sum < 2^53 — then one int64 %.
    """
    ms = np.concatenate([np.asarray(c.A.m, np.int64),
                         np.asarray(c.B.m, np.int64)])
    blob = b"".join(v.to_bytes(32, "little") for v in vals)
    mat = np.frombuffer(blob, np.uint8).reshape(len(vals), 32)
    powm = np.asarray([[pow(256, j, int(m)) for m in ms]
                       for j in range(32)], np.float64)
    acc = (mat.astype(np.float64) @ powm).astype(np.int64) % ms[None, :]
    return np.ascontiguousarray(acc.T).astype(np.int32)


def _window_triple_residue_rows(c: Ed25519RNSContext,
                                pt: Tuple[int, int]) -> np.ndarray:
    """[3, I_A + I_B, NW8·PER] int32: column i·PER + d holds the A-domain
    triple (y−x, y+x, 2dxy) of d·2^{8i}·pt (d = 0: the identity) — the
    JAX package's [3, rows, I_A + I_B] rows, transposed."""
    pts = []
    base = to_ext(pt)
    for _ in range(NW8):
        acc = to_ext(_IDENTITY)
        pts.append(acc)
        for _ in range(PER - 1):
            acc = ext_add(acc, base)
            pts.append(acc)
        base = ext_add(acc, base)                 # 2^8 · base
    am = c.a_mod_p
    d2 = 2 * D_CONST % P
    xs, xa, ya = [], [], []
    for x, y in normalize(pts):
        xs.append(x)
        xa.append(x * am % P)
        ya.append(y * am % P)
    return np.stack([
        _residue_matrix(c, [(v - u) % P for u, v in zip(xa, ya)]),
        _residue_matrix(c, [(v + u) % P for u, v in zip(xa, ya)]),
        _residue_matrix(c, [x * v % P * d2 % P for x, v in zip(xs, ya)])])


_B_TABLE_RNS: Optional[tuple] = None


def b_table_rns() -> tuple:
    """The basepoint's window table: 3 × [I_A + I_B, NW8·PER] int32."""
    global _B_TABLE_RNS
    if _B_TABLE_RNS is None:
        _B_TABLE_RNS = tuple(_window_triple_residue_rows(ctx(), _B_POINT))
    return _B_TABLE_RNS


class Ed25519RNSKeyTable:
    """Per-key window tables of −A as A-domain residue triples.

    ``tna``: 3 × [I_A + I_B, nk·NW8·PER] int32, key k's windows in
    columns k·NW8·PER onward (the JAX package's ``tna`` transposed).
    The device keeps ONE row-major table for both ladder chains
    (:meth:`device_tab`), the basepoint's rows first, in the row order
    of the JAX package's gather.
    """

    def __init__(self, keys_decoded: Sequence[Optional[Tuple[int, int]]],
                 tna: Optional[tuple] = None, tb: Optional[tuple] = None,
                 ctx_: Optional[Ed25519RNSContext] = None):
        """keys_decoded: affine points, or None for a key that does not
        decode (its table is the identity's)."""
        self.ctx = ctx_ if ctx_ is not None else ctx()
        self.nk = len(keys_decoded)
        self.tb = tb if tb is not None else b_table_rns()
        if tna is None:
            # −A of each key (the identity for one that does not decode),
            # one table a distinct point
            pts = [_IDENTITY if a is None else ((P - a[0]) % P, a[1])
                   for a in keys_decoded]
            rows = {pt: _window_triple_residue_rows(self.ctx, pt)
                    for pt in dict.fromkeys(pts)}
            tna = tuple(np.concatenate([rows[pt][t] for pt in pts], axis=1)
                        for t in range(3))
        self.tna = tna
        self._dev: Dict[torch.device, torch.Tensor] = {}

    def device_tab(self, device) -> torch.Tensor:
        """[(1 + nk)·NW8·PER, 3·max(I_A, I_B)] int32 on ``device``: row r
        holds the triple (y−x, y+x, 2dxy) of the basepoint's (r <
        NW8·PER) or key (r − NW8·PER) // (NW8·PER)'s table entry, each
        as packed A|B<<16 words (``ec_rns._pack_residue_rows``)."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = torch.as_tensor(np.concatenate(
                [_pack_residue_rows(self.ctx, np.concatenate([b, a], axis=1).T)
                 for b, a in zip(self.tb, self.tna)], axis=1), device=device)
        return self._dev[device]


def window_rows(dig1: torch.Tensor, dig2: torch.Tensor,
                key_idx: torch.Tensor) -> torch.Tensor:
    """[NW8, 2N] int32 table rows of every window: window i's B chain
    (lanes 0..N−1) at row i·PER + dig1[i], its A chain at row
    NW8·PER + key·NW8·PER + i·PER + dig2[i] (the JAX ladder's per-window
    ``idx``). dig1, dig2: [≥ NW8, N] window digits; key_idx: [N]."""
    win = torch.arange(NW8, dtype=torch.int64,
                       device=dig1.device)[:, None] * PER
    key_base = (key_idx.to(torch.int64) + 1)[None, :] * (NW8 * PER)
    return torch.cat([win + dig1[:NW8], key_base + win + dig2[:NW8]],
                     dim=1).to(I32)


# ---------------------------------------------------------------------------
# The batched verify core
# ---------------------------------------------------------------------------

def _ed25519_rns_core(s, kk, yr, sign_r, key_idx,
                      rtab: Ed25519RNSKeyTable) -> torch.Tensor:
    """Ed25519 verify: RNS ladder, limb-domain finish (see
    :func:`_ed25519_rns_core_steps`). Returns ok [N] bool."""
    from . import bignum as B

    return B.run_steps(_ed25519_rns_core_steps(s, kk, yr, sign_r, key_idx,
                                               rtab))


def _ed25519_rns_core_steps(s, kk, yr, sign_r, key_idx,
                            rtab: Ed25519RNSKeyTable):
    """Ed25519 verify: RNS ladder, limb-domain finish, as a generator
    (``bignum.run_steps``) that yields before the batch inverse reads
    its root on the host, after the 32 ladder windows are queued.

    s, kk, yr: [K, N] int64 limbs (S; k = H(R‖A‖M) mod L; R's y with
    the sign bit cleared); sign_r: [N] R's sign bit; key_idx: [N] key
    rows. N any lane count (a power of two ≥ 128 pairs down to a
    128-lane root in the batch inverse's tree; fewer lanes are their
    own root). Returns
    ok [N] bool (S < L and the encoding of [S]B + [k](−A) equals R).
    """
    from . import bignum as B

    c = rtab.ctx
    dev = s.device
    k, n_tok = s.shape
    p, pp, pr2, l_ = consts().device(dev)
    pb, ppb = p.expand(k, n_tok), pp.expand(k, n_tok)

    s_ok = ~B.compare_ge(s, l_.expand(k, n_tok))

    def bytes_of(u):
        return torch.stack([u & 255, (u >> 8) & 255], dim=1).reshape(
            2 * k, n_tok)

    dig1, dig2 = bytes_of(s), bytes_of(kk)
    rows = window_rows(dig1, dig2, key_idx)     # [NW8, 2N]

    # two-accumulator ladder: the B chain ([S]B) and the A chain
    # ([k](−A)) run as ONE mixed add over [I, 2N] lanes per window
    ia, ib = c.A.count, c.B.count
    one = c.device_consts(dev).one
    zero = (torch.zeros((ia, 2 * n_tok), dtype=I32, device=dev),
            torch.zeros((ib, 2 * n_tok), dtype=I32, device=dev))
    one_b = (one[0].expand(ia, 2 * n_tok).contiguous(),
             one[1].expand(ib, 2 * n_tok).contiguous())
    X, Y, Z, T = zero, one_b, one_b, zero
    tab = rtab.device_tab(dev)
    for i in range(NW8):
        X, Y, Z, T = cuda_edw.edw_window(c, X, Y, Z, T, tab, rows[i])

    def halves(pair):
        return ((pair[0][:, :n_tok], pair[1][:, :n_tok]),
                (pair[0][:, n_tok:], pair[1][:, n_tok:]))

    (Xb, Xa), (Yb, Ya), (Zb, Za), (Tb, Ta) = [halves(v)
                                              for v in (X, Y, Z, T)]
    X, Y, Z, _ = _edw_add_rns(c, (Xb, Yb, Zb, Tb), (Xa, Ya, Za, Ta),
                              _twod_dom(c, dev))

    # RNS → limbs, canonical mod p, then the limb-domain finish
    p_pad = torch.cat([pb, torch.zeros_like(pb[:1])])

    def to_canonical(v_pair):
        v = c.to_limbs(v_pair[0])                # [K + 1, N], value < 3p
        for _ in range(2):
            v = B.sub_where(v, p_pad, B.compare_ge(v, p_pad))
        return v[:k]

    Xl, Yl, Zl = to_canonical(X), to_canonical(Y), to_canonical(Z)
    z_m = B.mont_mul(Zl, pr2.expand(k, n_tok), pb, ppb)
    zinv = yield from B.batch_mont_inverse_steps(z_m, p, pp, P)
    # x = X·(Z⁻¹·R)·R⁻¹: one Montgomery product cancels the R factor
    x = B.mont_mul(Xl, zinv, pb, ppb)
    y = B.mont_mul(Yl, zinv, pb, ppb)

    enc_ok = (y == yr).all(dim=0) & ((x[0] & 1) == sign_r)
    return s_ok & enc_ok
