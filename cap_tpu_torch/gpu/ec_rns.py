"""ECDSA point arithmetic in residue-number-system form.

The port of the JAX package's ``ec_rns``: field values are "A-domain"
residue pairs x̃ = x·A mod p held as (xA [I_A, N], xB [I_B, N]) int32;
a field multiply is per-channel products plus one REDC; adds and subs
are lazy per-channel sums whose value and digit bounds are tracked
statically (every rmul output < 3p, sums ≤ ~16p between multiplies);
the point at infinity is an explicit boolean lane; equality tests use
the multiple-of-p trick (d ≡ 0 iff d equals one of a few c·p rows).

Hand-written CUDA kernels carry the ladder on the card:
``cuda_ladder.ladder`` runs every window in one launch, and
``cuda_redc.redc`` runs every other REDC (the accumulator merge and
the projective check). ``ladder_per_window`` runs the same ladder as
one ``cuda_madd.madd`` launch a window; it is on no path and serves
as the whole-ladder kernel's comparison. The affine ladder
(``ladder="affine"`` of ``ec``'s entry points) keeps its accumulator
affine: each window one 2M + 1S add whose divisions share one batched
inversion (:func:`rns_batch_inverse`, its root inverted by a Fermat
ladder over the bits of p − 2 on the device), every multiply one
``cuda_redc.redc`` launch. The field ops below take the REDC as a
parameter so the plain version of the mixed add
(``cuda_madd.madd_ref``) can run the same arithmetic with the plain
REDC.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_ladder, cuda_madd, cuda_redc
from .ec import CurveParams, curve
from .rns import FieldRNSContext, I32, _limbs_to_rns, _mod_fix

W_BITS = 8          # default window width of the ladder (the JAX default)


class ECRNSContext(FieldRNSContext):
    """Per-curve field context (shared construction in FieldRNSContext)
    at a window width of ``w_bits``: ⌈nbits / w⌉ ladder windows, each
    2^w − 1 table rows a key slot (P-256: 32 windows of 255 rows at 8
    bits, 22 of 4,095 at 12)."""

    def __init__(self, cp: CurveParams, w_bits: int = W_BITS):
        # a digit spans at most two 16-bit limbs (``_digits_of``)
        if not 1 <= w_bits <= 16:
            raise ValueError(f"window width {w_bits} outside 1..16 bits")
        super().__init__(cp.p, cp.k)
        self.cp = cp
        self.w_bits = w_bits
        self.n_windows = (cp.nbits + w_bits - 1) // w_bits


_CTX: Dict[Tuple[str, int], ECRNSContext] = {}


def ctx_for(crv: str, w_bits: int = W_BITS) -> ECRNSContext:
    """The curve's context at ``w_bits``, built once a (curve, width)."""
    key = (crv, w_bits)
    if key not in _CTX:
        _CTX[key] = ECRNSContext(curve(crv), w_bits)
    return _CTX[key]


# ---------------------------------------------------------------------------
# Field ops on (xA, xB) residue pairs
# ---------------------------------------------------------------------------

def _fixA(c, x):
    cc = c.device_consts(x.device)
    return _mod_fix(x, cc.mA, cc.invA_f)


def _fixB(c, x):
    cc = c.device_consts(x.device)
    return _mod_fix(x, cc.mB, cc.invB_f)


def rmul(c: ECRNSContext, a, b, redc=cuda_redc.redc):
    """(a·b)·A⁻¹ mod p — output value < 3p for λ₁λ₂ ≤ 2^14."""
    return redc(c, _fixA(c, a[0] * b[0]), _fixB(c, a[1] * b[1]))


def rmul_many(c: ECRNSContext, pairs, redc=cuda_redc.redc):
    """Independent rmuls through ONE REDC (concatenated along lanes)."""
    n = pairs[0][0][0].shape[1]
    pA = _fixA(c, torch.cat([a[0] * b[0] for a, b in pairs], dim=1))
    pB = _fixB(c, torch.cat([a[1] * b[1] for a, b in pairs], dim=1))
    tA, tB = redc(c, pA, pB)
    return [(tA[:, i * n:(i + 1) * n], tB[:, i * n:(i + 1) * n])
            for i in range(len(pairs))]


def radd(c: ECRNSContext, a, b):
    """a + b — LAZY: digits grow (c₁+c₂)·m, no Barrett fix."""
    return (a[0] + b[0], a[1] + b[1])


def rsub(c: ECRNSContext, a, b, cmul: int, guard: int = 4):
    """a + cmul·p − b — LAZY (no fix). cmul·p must dominate b's VALUE
    bound; ``guard``·m must dominate b's DIGIT bound."""
    cc = c.device_consts(a[0].device)
    return (a[0] + cc.cp_A[cmul][:, None] - b[0] + guard * cc.mA,
            a[1] + cc.cp_B[cmul][:, None] - b[1] + guard * cc.mB)


def rfix(c: ECRNSContext, x):
    """Canonicalize digits (< m) of a lazily-grown pair."""
    return (_fixA(c, x[0]), _fixB(c, x[1]))


def rsel(mask, a, b):
    """where(mask) per pair."""
    m = mask[None, :]
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]))


def congruent_zero(c: ECRNSContext, x, max_c: int):
    """[N] bool: value(x) ≡ 0 (mod p), for values < max_c·p.

    Base A alone decides: every value in play is ≪ prod(A).
    """
    cc = c.device_consts(x[0].device)
    xa = _fixA(c, x[0])
    ok = torch.zeros(xa.shape[1], dtype=torch.bool, device=xa.device)
    for k in range(max_c):
        ok = ok | (xa == cc.cp_A[k][:, None]).all(dim=0)
    return ok


def congruent_zero_probe(c: ECRNSContext, x, max_c: int, nch: int = 2):
    """[N] bool: SUFFICIENT test for value(x) ≡ 0 (mod p) on ``nch``
    probe channels — every true congruence is caught, with
    ~max_c/(m₀·m₁) false positives (those lanes only cost a re-verify
    on the oracle)."""
    cc = c.device_consts(x[0].device)
    xa = _mod_fix(x[0][:nch], cc.mA[:nch], cc.invA_f[:nch])
    ok = torch.zeros(xa.shape[1], dtype=torch.bool, device=xa.device)
    for k in range(max_c):
        ok = ok | (xa == cc.cp_A[k][:nch, None]).all(dim=0)
    return ok


def req(c: ECRNSContext, x, y, slack: int):
    """[N] bool: value(x) ≡ value(y) (mod p); x < slack·p bound."""
    return congruent_zero(c, rsub(c, x, y, slack), 2 * slack)


# ---------------------------------------------------------------------------
# Point additions
# ---------------------------------------------------------------------------

def _madd_rns(c: ECRNSContext, X1, Y1, Z1, inf1, x2, y2,
              redc=cuda_redc.redc):
    """(X1:Y1:Z1) + (x2, y2) with explicit infinity lane.

    State in/out is digit-canonical (< m) with values < 15p (X, Y) /
    11p (Z); x2, y2 < p (tables). Bounds per line as in the JAX
    package; every rmul product stays < 32·m² < 2^31. Same-x cases
    (addend == ±accumulator) are flagged for the oracle.
    """
    z1z1 = rmul(c, Z1, Z1, redc)                     # < 3p, digits ≤ m
    u2, z1_3 = rmul_many(c, [(x2, z1z1), (Z1, z1z1)], redc)
    h = rsub(c, u2, X1, 16, guard=1)                 # < 19p, ≤ 3m
    zh = radd(c, Z1, h)                              # < 30p, ≤ 4m
    s2, hh, zh2 = rmul_many(
        c, [(y2, z1_3), (h, h), (zh, zh)], redc)     # 9m², 16m² → ≤ m
    i4 = radd(c, radd(c, hh, hh), radd(c, hh, hh))   # < 12p, ≤ 4m
    s2y1 = rsub(c, s2, Y1, 16, guard=1)              # < 19p, ≤ 3m
    rr = rfix(c, radd(c, s2y1, s2y1))                # < 38p, ≤ m
    j, v, r2_ = rmul_many(
        c, [(h, i4), (X1, i4), (rr, rr)], redc)      # 12m² → ≤ m
    vv = radd(c, v, v)                               # < 6p, ≤ 2m
    X3 = rfix(c, rsub(c, rsub(c, r2_, j, 4, guard=1), vv, 8,
                      guard=2))                      # < 15p, ≤ m
    y1j, t5 = rmul_many(
        c, [(Y1, j), (rr, rsub(c, v, X3, 16, guard=1))], redc)
    Y3 = rfix(c, rsub(c, t5, radd(c, y1j, y1j), 8,
                      guard=2))                      # < 11p, ≤ m
    Z3 = rfix(c, rsub(c, rsub(c, zh2, z1z1, 4, guard=1), hh, 4,
                      guard=1))                      # < 11p, ≤ m
    deg = ~inf1 & congruent_zero_probe(c, h, 20)     # same-x (incl. −)
    return X3, Y3, Z3, deg


def _jadd_rns(c: ECRNSContext, X1, Y1, Z1, inf1, X2, Y2, Z2, inf2,
              redc=cuda_redc.redc):
    """Full Jacobian + Jacobian addition (2007-bl), RNS form.

    Runs once per batch (merging the two ladder accumulators) with
    eager rfixes. Inputs and outputs keep the ladder's invariants
    (< 15p X, < 11p Y, Z). Same-x pairs are flagged for the oracle.
    """
    z1z1, z2z2, z1z2 = rmul_many(
        c, [(Z1, Z1), (Z2, Z2), (Z1, Z2)], redc)
    u1, u2, z1c, z2c = rmul_many(
        c, [(X1, z2z2), (X2, z1z1), (Z1, z1z1), (Z2, z2z2)], redc)
    s1, s2 = rmul_many(c, [(Y1, z2c), (Y2, z1c)], redc)
    h = rsub(c, u2, u1, 4, guard=1)                  # < 7p, ≤ 3m
    t = rsub(c, s2, s1, 4, guard=1)                  # < 7p, ≤ 3m
    rr = rfix(c, radd(c, t, t))                      # < 14p, ≤ m
    hh, r2_ = rmul_many(c, [(h, h), (rr, rr)], redc)
    i4 = radd(c, radd(c, hh, hh), radd(c, hh, hh))   # < 12p, ≤ 4m
    zz2 = radd(c, z1z2, z1z2)                        # < 6p, ≤ 2m
    j, v, z3 = rmul_many(
        c, [(h, i4), (u1, i4), (zz2, h)], redc)
    v2 = radd(c, v, v)                               # < 6p, ≤ 2m
    X3 = rfix(c, rsub(c, rsub(c, r2_, j, 4, guard=1), v2, 8,
                      guard=2))                      # < 15p, ≤ m
    vx = rsub(c, v, X3, 16, guard=1)                 # < 19p, ≤ 3m
    t5, s1j = rmul_many(c, [(rr, vx), (s1, j)], redc)
    sj2 = radd(c, s1j, s1j)                          # < 6p, ≤ 2m
    Y3 = rfix(c, rsub(c, t5, sj2, 8, guard=2))       # < 11p, ≤ m
    Z3 = z3                                          # < 3p, ≤ m

    both = ~inf1 & ~inf2
    deg = both & congruent_zero_probe(c, h, 8)       # P = ±Q
    # infinity lanes: inf1 → P2, inf2 → P1
    X3 = rsel(inf1, X2, rsel(inf2, X1, X3))
    Y3 = rsel(inf1, Y2, rsel(inf2, Y1, Y3))
    Z3 = rsel(inf1, Z2, rsel(inf2, Z1, Z3))
    return X3, Y3, Z3, inf1 & inf2, deg


# ---------------------------------------------------------------------------
# Affine window addition: batched RNS inversion + 2M+1S law
# ---------------------------------------------------------------------------

def _one_dom(c: ECRNSContext, device):
    """The A-domain 1 (A mod p) as [I, 1] residue columns (A, B)."""
    return c.device_consts(device).one


_PM2_BITS: Dict[str, np.ndarray] = {}


def _pm2_bits_np(crv: str) -> np.ndarray:
    """MSB-first bits of p − 2, the Fermat exponent that inverts the
    product tree's root."""
    if crv not in _PM2_BITS:
        e = curve(crv).p - 2
        nb = curve(crv).p.bit_length()
        _PM2_BITS[crv] = np.asarray(
            [(e >> (nb - 1 - i)) & 1 for i in range(nb)], np.int32)
    return _PM2_BITS[crv]


def rns_batch_inverse(c: ECRNSContext, den, min_width: int = 128,
                      redc=cuda_redc.redc):
    """Simultaneous inversion of an A-domain residue batch mod p.

    den: (A, B) pair [I, M], digits ≤ 3m, values < 8p, no lane ≡ 0
    (mod p), M a power of two. Montgomery's product tree in rmul form
    (closed over the A-domain): pair-multiply down to a ``min_width``
    root (log2(M/min_width) REDCs), raise the root to p − 2 on the
    device, left to right from its leading 1 bit: a square each later
    bit and a multiply each later 1 bit (pbits − 1 + popcount(p − 2) −
    1 REDCs; the JAX package computes both products at every bit and
    selects, the same value), walk back up (log2(M/min_width) REDCs,
    two products each). Returns the per-lane inverses den⁻¹·A,
    digit-canonical, values < 3p.
    """
    levels = [den]
    cur = den
    while cur[0].shape[1] > min_width and cur[0].shape[1] % 2 == 0:
        cur = rmul(c, (cur[0][:, 0::2], cur[1][:, 0::2]),
                   (cur[0][:, 1::2], cur[1][:, 1::2]), redc)
        levels.append(cur)
    root = inv = cur
    for bit in _pm2_bits_np(c.cp.name)[1:].tolist():
        inv = rmul(c, inv, inv, redc)
        if bit:
            inv = rmul(c, inv, root, redc)
    for lvl in levels[-2::-1]:
        left = (lvl[0][:, 0::2], lvl[1][:, 0::2])
        right = (lvl[0][:, 1::2], lvl[1][:, 1::2])
        il, ir = rmul_many(c, [(inv, right), (inv, left)], redc)
        inv = (torch.stack([il[0], ir[0]], dim=2).reshape(lvl[0].shape),
               torch.stack([il[1], ir[1]], dim=2).reshape(lvl[1].shape))
    return inv


def _affine_madd_rns(c: ECRNSContext, x, y, inf, x2, y2, has, one_b,
                     redc=cuda_redc.redc):
    """Affine + affine window addition with an explicit infinity lane.

    State x, y digit-canonical, values < 3p; x2, y2 < p (table points,
    never infinity); has: lanes adding this step; one_b: the A-domain 1
    (:func:`_one_dom`). λ = (y2 − y)/(x2 − x) takes its inverse from
    ONE :func:`rns_batch_inverse` over all lanes; then 4 REDCs: λ, λ²,
    λ·(x − x3) with x3's re-reduction, and y3's re-reduction (an affine
    state is used additively, so it re-enters the < 3p bound by a
    product with 1). An accumulator at infinity lifts the addend; a
    same-x lane (doubling or inverse) is flagged by the 2-channel probe
    (false positives only cost an oracle re-verify), its denominator
    replaced by 1. Returns (x, y, inf, deg).
    """
    dxl = rsub(c, x2, x, 4, guard=1)                 # < 5p, ≤ 3m
    dd = has & ~inf & congruent_zero_probe(c, dxl, 5)
    good = has & ~inf & ~dd
    inv = rns_batch_inverse(c, rsel(good, dxl, one_b), redc=redc)
    dyl = rsub(c, y2, y, 4, guard=1)                 # < 5p, ≤ 3m
    lam = rmul(c, dyl, inv, redc)                    # < 3p, ≤ m
    sq = rmul(c, lam, lam, redc)                     # < 3p, ≤ m
    x3l = rsub(c, rsub(c, sq, x, 4, guard=1), x2, 2,
               guard=1)                              # < 9p, ≤ 5m
    xdiff = rsub(c, x, x3l, 16, guard=5)             # < 19p, ≤ 7m
    y3t, x3 = rmul_many(c, [(xdiff, lam), (x3l, one_b)], redc)
    y3 = rmul(c, rsub(c, y3t, y, 4, guard=1), one_b, redc)   # < 3p
    lift = inf & has
    x3 = rsel(lift, x2, x3)
    y3 = rsel(lift, y2, y3)
    return rsel(has, x3, x), rsel(has, y3, y), inf & ~has, dd


def affine_ladder(c: ECRNSContext, tab, d_all, base, win_stride: int,
                  redc=cuda_redc.redc):
    """The affine ladder on ``cuda_ladder.ladder``'s inputs: from the
    point at infinity, window i adds row ``i·win_stride + base + d − 1``
    of the packed table on each lane whose digit d > 0, by
    :func:`_affine_madd_rns`. Returns (x, y, inf, deg): the affine
    accumulator as (A, B) pairs and [M] bools.

    REDC launches: W·(2·log2(M/128) + pbits + popcount(p − 2) + 2)
    for W windows over M lanes (M a power of two ≥ 256): the inversion
    (:func:`rns_batch_inverse`) and 4 more a window.
    """
    ia, ib = c.A.count, c.B.count
    iap = max(ia, ib)
    m = d_all.shape[1]
    dev = d_all.device
    one_b = _one_dom(c, dev)
    x = y = (one_b[0].expand(ia, m), one_b[1].expand(ib, m))
    inf = torch.ones(m, dtype=torch.bool, device=dev)
    deg = torch.zeros(m, dtype=torch.bool, device=dev)
    base = base.to(torch.int64)
    for i in range(d_all.shape[0]):
        d = d_all[i].to(torch.int64)
        has = d > 0
        g = tab.index_select(0, i * win_stride + base
                             + torch.where(has, d - 1, 0)).T.contiguous()
        x, y, inf, dd = _affine_madd_rns(
            c, x, y, inf, unpack_pt(g[:iap], ia, ib),
            unpack_pt(g[iap:], ia, ib), has, one_b, redc)
        deg = deg | dd
    return x, y, inf, deg


def affine_redc_launches(crv: str, n_pad: int,
                         w_bits: int = W_BITS) -> int:
    """``cuda_redc.redc`` launches of one ES* verify over ``n_pad``
    lanes (a power of two ≥ 128) on the affine ladder at ``w_bits``-bit
    windows: W windows over
    M = 2·n_pad lanes (the G and Q chains side by side), each the
    batched inversion (log2(M/128) tree products down, pbits − 1
    squares and popcount(p − 2) − 1 multiplies of the root's Fermat
    ladder, log2(M/128) products back up) and 4 more (λ, λ², λ·(x − x3)
    with x3's re-reduction, y3's re-reduction); then 11, the merge (6)
    and the projective check (5)."""
    c = ctx_for(crv, w_bits)
    p = c.cp.p
    levels = (2 * n_pad // 128).bit_length() - 1
    return c.n_windows * (2 * levels + p.bit_length()
                          + bin(p - 2).count("1") + 2) + 11


# ---------------------------------------------------------------------------
# The batched verify core
# ---------------------------------------------------------------------------

def _digits_of(u: torch.Tensor, w_bits: int, n_windows: int):
    """[K, N] 16-bit limbs → [n_windows, N] int32 w-bit digits.

    Digits may straddle limb boundaries for w ∤ 16; an appended zero
    limb covers the top window's spill.
    """
    up = torch.cat([u, torch.zeros_like(u[:1])], dim=0)
    mask = (1 << w_bits) - 1
    outs = []
    for j in range(n_windows):
        b = w_bits * j
        limb, off = b >> 4, b & 15
        d = up[limb] >> off
        if off + w_bits > 16:
            d = d | (up[limb + 1] << (16 - off))
        outs.append(d & mask)
    return torch.stack(outs).to(I32)


def ladder_per_window(c: ECRNSContext, tab, d_all, base,
                      win_stride: int):
    """The ladder one mixed add a window (``cuda_madd.madd``), on
    ``cuda_ladder.ladder``'s inputs: from the point at infinity, window
    i adds row ``i·win_stride + base + d − 1`` of the table tab
    [rows, 2·iap] (gathered with one ``index_select`` and transposed
    into the madd kernel's [iap, M] operands) on each lane whose digit
    d > 0. d_all [W, M] and base [M] int32. Returns what
    ``cuda_ladder.ladder`` returns: (X, Y, Z, inf, deg)."""
    ia, ib = c.A.count, c.B.count
    iap = max(ia, ib)
    m = d_all.shape[1]
    dev = d_all.device
    zA = torch.zeros((ia, m), dtype=I32, device=dev)
    zB = torch.zeros((ib, m), dtype=I32, device=dev)
    X, Y, Z = (zA, zB), (zA, zB), (zA, zB)
    inf = torch.ones(m, dtype=torch.bool, device=dev)
    deg = torch.zeros(m, dtype=torch.bool, device=dev)
    base = base.to(torch.int64)
    for i in range(d_all.shape[0]):
        d = d_all[i].to(torch.int64)
        has = d > 0
        idx = i * win_stride + base + torch.where(has, d - 1,
                                                  torch.zeros_like(d))
        g = tab.index_select(0, idx).T.contiguous()   # [2·iap, M] packed
        X, Y, Z, dd = cuda_madd.madd(c, X, Y, Z, inf, has, g[:iap],
                                     g[iap:])
        inf = inf & ~has
        deg = deg | dd
    return X, Y, Z, inf, deg


def _ecdsa_rns_core_steps(r, s, e, key_idx, rtab: "ECRNSKeyTable",
                          cp: CurveParams, ladder: str = "jacobian"):
    """ECDSA verify: scalar math in limbs, point math in RNS, as a
    generator (``bignum.run_steps``) that yields before the batch
    inverse reads its root on the host.

    r, s, e: [K, N] int64 limbs (N a power of two ≥ 128 on the keyset's
    chunks; a mesh shard's N may be fewer, its own inverse root);
    key_idx: [N];
    ``rtab``: the packed window table. ``jacobian``: the ladder runs as
    one whole-ladder launch (``cuda_ladder``); ``affine``:
    :func:`affine_ladder`, whose chains enter the merge with Z = 1.
    Returns (ok, deg) [N] bools.
    """
    from . import bignum as B

    c = rtab.ctx
    dev = r.device
    n_col, npp, nr2, p_col = cp.device_consts(dev)
    k, n_tok = r.shape
    nb = n_col.expand(k, n_tok)
    nppb = npp.expand(k, n_tok)

    # 1. range checks + s⁻¹ (limb domain, batch inverse tree)
    r_ok = ~B.is_zero(r) & ~B.compare_ge(r, nb)
    s_ok = ~B.is_zero(s) & ~B.compare_ge(s, nb)
    one_plain = torch.zeros_like(r)
    one_plain[0] = 1
    s_safe = torch.where(s_ok[None, :], s, one_plain)
    s_m = B.mont_mul(s_safe, nr2.expand(k, n_tok), nb, nppb)
    w_m = yield from B.batch_mont_inverse_steps(s_m, n_col, npp, cp.n)
    u1 = B.mont_mul(e, w_m, nb, nppb)
    u2 = B.mont_mul(r, w_m, nb, nppb)

    # 2. window digits, both chains side by side: [W, 2N]
    d_all = torch.cat([_digits_of(u1, c.w_bits, c.n_windows),
                       _digits_of(u2, c.w_bits, c.n_windows)], dim=1)

    # 3. two-accumulator ladder: the G-digit and Q-digit chains run as
    # ONE mixed add over [I, 2N] concatenated state. Window-major
    # table, G at slot 0: row i·(nk+1)·per + s·per + (d−1).
    per = (1 << c.w_bits) - 1
    win_stride = (rtab.nk + 1) * per
    base = torch.cat([torch.zeros(n_tok, dtype=I32, device=dev),
                      ((key_idx.to(torch.int64) + 1) * per).to(I32)])
    if ladder == "affine":
        X, Y, inf, deg = affine_ladder(c, rtab.device_tab(dev), d_all, base,
                                       win_stride)
        one = _one_dom(c, dev)
        Z = (one[0].expand_as(X[0]), one[1].expand_as(X[1]))
    else:
        X, Y, Z, inf, deg = cuda_ladder.ladder(c, rtab.device_tab(dev),
                                               d_all, base, win_stride)

    def half(pair, lo):
        return (pair[0][:, lo:lo + n_tok], pair[1][:, lo:lo + n_tok])

    Xg, Yg, Zg = half(X, 0), half(Y, 0), half(Z, 0)
    Xq, Yq, Zq = half(X, n_tok), half(Y, n_tok), half(Z, n_tok)
    deg = deg[:n_tok] | deg[n_tok:]
    X, Y, Z, inf, deg_j = _jadd_rns(c, Xg, Yg, Zg, inf[:n_tok],
                                    Xq, Yq, Zq, inf[n_tok:])
    deg = deg | deg_j

    # 4. projective check in RNS: X ≡ r·Z² (or (r+n)·Z² when r+n < p)
    a2 = c.device_consts(dev).A2
    r_dom = rmul(c, _limb_pair_to_rns(c, r), a2)     # r·A, < 3p
    z2 = rmul(c, Z, Z)
    ok1 = req(c, X, rmul(c, r_dom, z2), 16)

    zero_row = torch.zeros_like(r[:1])
    rpn = B.carry_normalize(torch.cat([r + nb, zero_row], dim=0))
    p_pad = torch.cat([p_col.expand(k, n_tok), zero_row], dim=0)
    rpn_lt_p = ~B.compare_ge(rpn, p_pad)
    rpn_dom = rmul(c, _limb_pair_to_rns(c, rpn[:k]), a2)
    ok2 = req(c, X, rmul(c, rpn_dom, z2), 16) & rpn_lt_p

    ok = r_ok & s_ok & ~inf & (ok1 | ok2)
    return ok, deg & r_ok & s_ok


def _limb_pair_to_rns(c: ECRNSContext, limbs):
    """[K, N] int64 limbs → plain residue pair via the conversion mats."""
    cc = c.device_consts(limbs.device)
    return (_limbs_to_rns(limbs, cc.T_A, cc.mA, cc.invA_f),
            _limbs_to_rns(limbs, cc.T_B, cc.mB, cc.invB_f))


# ---------------------------------------------------------------------------
# Key tables in RNS form
# ---------------------------------------------------------------------------

def packed_cols(c) -> int:
    """Packed-word columns per coordinate: max(I_A, I_B)."""
    return max(c.A.count, c.B.count)


def _pack_residue_rows(c, r: np.ndarray) -> np.ndarray:
    """[rows, I_A + I_B] residues → [rows, max(I_A, I_B)] int32 words.

    Word j holds A-channel j in its low 16 bits and B-channel j in its
    high 16 (residues < 2^13): half the gather bytes.
    """
    ia, ib = c.A.count, c.B.count
    out = np.zeros((r.shape[0], packed_cols(c)), np.int32)
    out[:, :ia] = r[:, :ia]
    out[:, :ib] |= r[:, ia:].astype(np.int32) << 16
    return out


def unpack_pt(g: torch.Tensor, ia: int, ib: int):
    """[iap, M] packed words → ((A [ia, M], B [ib, M])) int32 planes —
    the decode of :func:`_pack_residue_rows` (the madd and ladder
    kernels decode the same words in ``madd_math.cuh`` and
    ``ladder.cu``)."""
    return ((g & 0xFFFF)[:ia], (g >> 16)[:ib])


class ECRNSKeyTable:
    """THE device window table for one curve + key set.

    ``tab``: host [n_windows·(nk+1)·per, 2·iap] int32, window-major
    with G as slot 0 and key k as slot k+1; each row is the packed x
    residues followed by the packed y residues (the JAX package's
    layout, byte for byte), the whole-ladder kernel's table; ``device_tab``
    puts it on a device.
    """

    def __init__(self, crv: str, keys: Sequence,
                 tab: Optional[np.ndarray] = None,
                 ctx: Optional[ECRNSContext] = None,
                 w_bits: int = W_BITS):
        self.ctx = ctx if ctx is not None else ctx_for(crv, w_bits)
        self.cp = self.ctx.cp
        c = self.ctx
        self.nk = nk = len(keys)
        self._dev: Dict[torch.device, torch.Tensor] = {}
        if tab is not None:
            self.tab = np.ascontiguousarray(tab, np.int32)
            return
        per = (1 << c.w_bits) - 1
        nw = c.n_windows
        iap = packed_cols(c)
        # one window table a distinct key (a JWKS may list a key under
        # several kids), all built together
        pts = [(k.public_numbers().x, k.public_numbers().y) for k in keys]
        uniq = list(dict.fromkeys(pts))
        packed = {}
        for g in range(0, len(uniq), _TABLE_GROUP):
            group = uniq[g:g + _TABLE_GROUP]
            for pt, (rx, ry) in zip(group,
                                    _window_residue_rows_many(c, group)):
                packed[pt] = (_pack_residue_rows(c, rx),
                              _pack_residue_rows(c, ry))
        parts = [_g_packed_np(crv, c.w_bits)] + [packed[pt] for pt in pts]
        # [slots, W, per, iap] → window-major [W, slots, per, iap]
        tx = np.stack([px.reshape(nw, per, iap) for px, _ in parts])
        ty = np.stack([py.reshape(nw, per, iap) for _, py in parts])
        tx = tx.transpose(1, 0, 2, 3).reshape(nw * (nk + 1) * per, iap)
        ty = ty.transpose(1, 0, 2, 3).reshape(nw * (nk + 1) * per, iap)
        self.tab = np.concatenate([tx, ty], axis=1)

    def device_tab(self, device) -> torch.Tensor:
        """The table on ``device``, [rows, 2·iap], a lane's row
        contiguous."""
        key = torch.device(device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.tab, device=key)
        return self._dev[key]


def _residue_matrix(c: ECRNSContext, vals: List[int]) -> np.ndarray:
    """[len(vals), I_A + I_B] int32 residues of host ints < p.

    Bytes-of-value × (256^j mod mᵢ) as one float64 matmul — exact,
    every term < 255·2^13 and ≤ 67 terms sum < 2^53 — then one int64 %.
    """
    cp = c.cp
    nb = (cp.p.bit_length() + 7) // 8 + 1
    blob = b"".join(v.to_bytes(nb, "little") for v in vals)
    mat = np.frombuffer(blob, np.uint8).reshape(len(vals), nb)
    ms = np.concatenate([np.asarray(c.A.m, np.int64),
                         np.asarray(c.B.m, np.int64)])
    powm = np.empty((nb, len(ms)), np.int64)
    for i, m in enumerate(ms):
        mi = int(m)
        powm[:, i] = [pow(256, j, mi) for j in range(nb)]
    acc = mat.astype(np.float64) @ powm.astype(np.float64)
    return (acc.astype(np.int64) % ms[None, :]).astype(np.int32)


_TABLE_GROUP = 32     # keys whose window chains share their inversions


def _window_residue_rows_many(c: ECRNSContext, points) -> list:
    """Host: the w-bit window table of each point as A-domain residues,
    [(rx, ry)] (row i·(2^w−1) + (d−1) holds d·2^{w·i}·point)."""
    p = c.cp.p
    a_mod = c.A.prod % p
    return [(_residue_matrix(c, [x * a_mod % p for x in X]),
             _residue_matrix(c, [y * a_mod % p for y in Y]))
            for X, Y in c.cp.window_multiples_many(points, c.w_bits,
                                                   c.n_windows)]


def _window_residue_rows(c: ECRNSContext, point) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Host: w-bit window table of d·2^{w·i}·point as A-domain residues
    (row i·(2^w−1) + (d−1) holds d·2^{w·i}·point)."""
    return _window_residue_rows_many(c, [point])[0]


_G_PACKED_NP: Dict[Tuple[str, int], tuple] = {}


def _g_packed_np(crv: str, w_bits: int = W_BITS):
    """Host-cached packed G window rows (x, y), each [W·per, iap], at
    the window width ``w_bits``."""
    key = (crv, w_bits)
    if key not in _G_PACKED_NP:
        c = ctx_for(crv, w_bits)
        rx, ry = _window_residue_rows(c, (c.cp.gx, c.cp.gy))
        _G_PACKED_NP[key] = (_pack_residue_rows(c, rx),
                             _pack_residue_rows(c, ry))
    return _G_PACKED_NP[key]
