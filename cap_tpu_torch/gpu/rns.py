"""Residue number system (RNS) Montgomery arithmetic in PyTorch.

The port of the JAX package's RNS engine. Numbers live as residues
modulo two bases of 13-bit primes (A, B); a multiply is a per-channel
product and one Bajard/Kawamura REDC, whose two base extensions are
products against FIXED matrices of residues.

Exactness, as in the JAX package:

- every extension product splits its 13-bit operands into 7-bit halves
  (the ``hh``/``mid``/``ll`` terms). The halves go through
  ``torch.matmul`` in float32 — every entry ≤ 127, every sum
  ≤ 2I·127² < 2^24, so float32 (and TF32) sums are exact integers.
  A bf16 product would round those sums and is never used;
- channel reductions are Barrett guess-then-fix (``_mod_fix``): a
  float32 quotient guess within ±1 of floor(x/m), an exact int32
  remainder, one correction each way. Every int32 product stays below
  2^31 by the JAX package's bounds (torch int32 wraps silently);
- the α of each extension is a float32 sum, so another summation order
  can shift a representative by a multiple of the modulus. Values
  agree mod p; compare them by CRT value, not by residues.

Host constants are numpy arrays named as in the JAX package;
``device_consts`` turns them into tensors on a device once.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

I32 = torch.int32
F32 = torch.float32

# Extension offsets (the JAX package's, as float32 after rounding).
OFFSET_AB = -1e-4          # A→B: α error ∈ {-1, 0}, absorbed by bounds
OFFSET_BA = 0.5 - 1e-4     # B→A: exact α (t ≪ B/2)


# ---------------------------------------------------------------------------
# Host-side base construction
# ---------------------------------------------------------------------------

def _sieve_primes(lo: int, hi: int):
    mask = np.ones(hi, bool)
    mask[:2] = False
    for i in range(2, int(hi ** 0.5) + 1):
        if mask[i]:
            mask[i * i:: i] = False
    return [p for p in range(lo, hi) if mask[p]]


class _Base:
    """One RNS base: moduli + CRT reconstruction constants."""

    def __init__(self, ms):
        self.m = np.asarray(ms, np.int64)
        self.count = len(ms)
        self.prod = 1
        for p in ms:
            self.prod *= int(p)
        self.Mi = [self.prod // int(p) for p in ms]
        self.inv_Mi = np.asarray(
            [pow(M % int(p), -1, int(p)) for M, p in zip(self.Mi, self.m)],
            np.int64)


def _ext_matrix(src: _Base, dst: _Base) -> np.ndarray:
    w = np.empty((dst.count, src.count), np.int64)
    for i, mi in enumerate(src.Mi):
        w[:, i] = np.asarray([mi % int(m) for m in dst.m], np.int64)
    return w


def _split_mat(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """13-bit int matrix → (hi, lo) int32 7-bit halves."""
    return ((w >> 7).astype(np.int32), (w & 127).astype(np.int32))


def _host_base(base: _Base) -> dict:
    return dict(
        m=np.asarray(base.m, np.int32),
        m_f=np.asarray(base.m, np.float32),
        inv_f=np.asarray(1.0 / base.m, np.float32),
        inv_Mi=np.asarray(base.inv_Mi, np.int32),
    )


def _conv_mat(base: _Base, k_limbs: int):
    """T[c, l] = 2^(16l) mod m_c, split into 7-bit halves."""
    t = np.empty((base.count, k_limbs), np.int64)
    for ll in range(k_limbs):
        t[:, ll] = np.asarray([pow(2, 16 * ll, int(m)) for m in base.m],
                              np.int64)
    return _split_mat(t)


def _two_bases(primes, need: int):
    msA, bits, i = [], 0.0, 0
    while bits < need:
        msA.append(primes[i])
        bits += np.log2(primes[i])
        i += 1
    msB, bits = [], 0.0
    while bits < need:
        msB.append(primes[i])
        bits += np.log2(primes[i])
        i += 1
    return _Base(msA), _Base(msB)


class _ContextBase:
    """Shared host constants of both context kinds, and their device
    tensors (built once per device)."""

    def _init_common(self, k_limbs: int):
        self.k_limbs = k_limbs
        self.dA = _host_base(self.A)
        self.dB = _host_base(self.B)
        self.W_AB = _split_mat(_ext_matrix(self.A, self.B))
        self.W_BA = _split_mat(_ext_matrix(self.B, self.A))
        self.Amod_B = np.asarray(
            [self.A.prod % int(m) for m in self.B.m], np.int32)
        self.Bmod_A = np.asarray(
            [self.B.prod % int(m) for m in self.A.m], np.int32)
        self.invA_B = np.asarray(
            [pow(self.A.prod % int(m), -1, int(m)) for m in self.B.m],
            np.int32)
        self.T_A = _conv_mat(self.A, k_limbs)
        self.T_B = _conv_mat(self.B, k_limbs)
        self._dev: Dict[torch.device, SimpleNamespace] = {}

    def device_consts(self, device) -> SimpleNamespace:
        """Every constant the device code reads, as tensors on ``device``
        (int32 columns [I, 1], float32 split matrices)."""
        device = torch.device(device)
        hit = self._dev.get(device)
        if hit is not None:
            return hit

        def col(v, dtype=I32):
            return torch.as_tensor(np.asarray(v).reshape(-1, 1),
                                   dtype=dtype, device=device)

        def mat(pair):
            return tuple(torch.as_tensor(np.asarray(w, np.float32),
                                         device=device) for w in pair)

        mA = np.asarray(self.dA["m"], np.int64)
        mB = np.asarray(self.dB["m"], np.int64)
        ns = SimpleNamespace(
            mA=col(mA), mB=col(mB),
            invA_f=col(self.dA["inv_f"], F32),
            invB_f=col(self.dB["inv_f"], F32),
            inv_Mi_B=col(self.dB["inv_Mi"]),
            W_AB=mat(self.W_AB), W_BA=mat(self.W_BA),
            Amod_B=col(self.Amod_B), Bmod_A=col(self.Bmod_A),
            invA_B=col(self.invA_B),
            c14A=col((1 << 14) % mA), c14B=col((1 << 14) % mB),
            T_A=mat(self.T_A), T_B=mat(self.T_B),
        )
        self._extra_device_consts(ns, col, device)
        self._dev[device] = ns
        return ns

    def _extra_device_consts(self, ns, col, device) -> None:
        pass


class RNSContext(_ContextBase):
    """Per-bit-width RSA context: bases, extension + conversion mats.

    Key-independent; ``nbits`` is the max modulus bit length the
    context must support (prod(A) ≥ 2^(nbits+4) ≥ 16n). Primes come
    from [2^12, 2^14), in the JAX package's deterministic order.
    """

    def __init__(self, nbits: int, k_limbs: int):
        primes = _sieve_primes(1 << 12, 1 << 14)
        try:
            self.A, self.B = _two_bases(primes, nbits + 8)
        except IndexError:
            raise RNSUnsupportedKey(
                f"modulus width {nbits} exceeds the RNS prime pool")
        self.nbits = nbits
        self._init_common(k_limbs)


_CTX_CACHE: Dict[Tuple[int, int], RNSContext] = {}


def context(nbits: int, k_limbs: int) -> RNSContext:
    key = (nbits, k_limbs)
    if key not in _CTX_CACHE:
        _CTX_CACHE[key] = RNSContext(nbits, k_limbs)
    return _CTX_CACHE[key]


class RNSUnsupportedKey(ValueError):
    """A modulus shares a factor with an RNS base prime (or is even).

    Impossible for well-formed RSA keys (and raised too for a modulus
    wider than the prime pool's bases); ``rsa.RSAKeyTable`` sends such
    a class to the limb engine, as the JAX package does.
    """


class RNSKeyTable:
    """Per-key RNS constants, gathered per token (the key-gather axis).

    For each key: n in base B, the merged σ constant
    (-n⁻¹·(A/a_i)⁻¹ mod a_i), and A² mod n in both bases (domain
    entry). Host int32 arrays [nk, I]; ``device_tables`` moves them.
    """

    def __init__(self, ctx: RNSContext, n_ints: Sequence[int]):
        self.ctx = ctx
        nk = len(n_ints)
        a, b = ctx.A, ctx.B
        n_B = np.empty((nk, b.count), np.int64)
        sig_c = np.empty((nk, a.count), np.int64)
        a2_A = np.empty((nk, a.count), np.int64)
        a2_B = np.empty((nk, b.count), np.int64)
        for j, n in enumerate(n_ints):
            if n <= 0 or n % 2 == 0:
                raise RNSUnsupportedKey(f"modulus of key {j} is not odd")
            a2n = (a.prod * a.prod) % n
            for i, m in enumerate(a.m):
                m = int(m)
                try:
                    npr = (-pow(n, -1, m)) % m
                except ValueError as e:
                    raise RNSUnsupportedKey(
                        f"modulus of key {j} shares a factor with an RNS "
                        f"base prime") from e
                sig_c[j, i] = (npr * int(a.inv_Mi[i])) % m
                a2_A[j, i] = a2n % m
            for i, m in enumerate(b.m):
                m = int(m)
                n_B[j, i] = n % m
                a2_B[j, i] = a2n % m
        self.set_arrays(sig_c, n_B, a2_A, a2_B)

    def set_arrays(self, sig_c, n_B, a2_A, a2_B) -> None:
        self.sig_c = np.asarray(sig_c, np.int32)
        self.n_B = np.asarray(n_B, np.int32)
        self.a2_A = np.asarray(a2_A, np.int32)
        self.a2_B = np.asarray(a2_B, np.int32)
        self._dev: Dict[torch.device, tuple] = {}

    def device_tables(self, device) -> tuple:
        """(sig_c, n_B, a2_A, a2_B) int32 tensors [nk, I] on ``device``."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.sig_c, self.n_B, self.a2_A, self.a2_B))
        return self._dev[device]


# ---------------------------------------------------------------------------
# Device arithmetic (plain PyTorch)
# ---------------------------------------------------------------------------

def _mod_fix(x: torch.Tensor, m: torch.Tensor,
             inv_f: torch.Tensor) -> torch.Tensor:
    """Exact x mod m for 0 ≤ x < 2^31: float32 Barrett guess, int32 fix.

    The guess is within ±1 of floor(x/m) (the JAX package's bound: the
    three float32 roundings add ≤ 0.094), so r = x − q·m ∈ (−m, 2m).
    """
    q = torch.floor(x.to(F32) * inv_f).to(I32)
    r = x - q * m
    r = torch.where(r < 0, r + m, r)
    return torch.where(r >= m, r - m, r)


def _split_matmul(w_pair, x: torch.Tensor):
    """Σ W·x as (hh, mid, ll) int32 via ONE float32 matmul.

    w_pair: float32 (Wh, Wl) [J, I] 7-bit halves; x: [I, N] int32
    < 2^14. The [2J, I] @ [I, 2N] quadrant layout of the JAX package:
    hh (weight 2^14), mid (2^7), ll (1).
    """
    wh, wl = w_pair
    j = wh.shape[0]
    n = x.shape[1]
    assert x.shape[0] <= 1040, "mid accumulation would overflow float32"
    x_cat = torch.cat([(x >> 7).to(F32), (x & 127).to(F32)], dim=1)
    c = torch.matmul(torch.cat([wh, wl], dim=0), x_cat).to(I32)
    return c[:j, :n], c[:j, n:] + c[j:, :n], c[j:, n:]


def _extend(sig: torch.Tensor, inv_src_f: torch.Tensor, w_pair,
            m_dst: torch.Tensor, inv_dst_f: torch.Tensor,
            src_prod_mod_dst: torch.Tensor, c14: torch.Tensor,
            offset: float) -> torch.Tensor:
    """Base extension of σ rows: [I_src, N] → [I_dst, N]."""
    hh, mid, ll = _split_matmul(w_pair, sig)
    alpha = torch.floor((sig.to(F32) * inv_src_f).sum(dim=0)
                        + offset).to(I32)[None, :]          # [1, N]

    def fix(v):
        return _mod_fix(v, m_dst, inv_dst_f)

    if sig.shape[0] <= 448:
        # 2^7 mod m = 128 exactly (m ≥ 2^12): mid/ll skip their fixes,
        # and the sum stays < 2^31 for I ≤ 448.
        comb = fix(fix(hh) * c14 + mid * 128 + ll)
    else:
        comb = fix(fix(hh) * c14 + fix(mid) * 128 + fix(ll))
    # α ∈ [-1, I_src]: only the -1 case needs the modular wrap.
    alpha_adj = torch.where(alpha < 0, alpha + m_dst, alpha)
    corr = fix(alpha_adj * src_prod_mod_dst)
    r = comb - corr + m_dst
    return torch.where(r >= m_dst, r - m_dst, r)


def _redc(x_A, x_B, sig_c, n_B, cc: SimpleNamespace):
    """One RNS Montgomery reduction: x → x·A⁻¹ mod n (value < 3n).

    sig_c/n_B: [I, 1] per-context or [I, N] per-token constants; cc:
    the context's ``device_consts``.
    """
    sig = _mod_fix(x_A * sig_c, cc.mA, cc.invA_f)
    q_B = _extend(sig, cc.invA_f, cc.W_AB, cc.mB, cc.invB_f, cc.Amod_B,
                  cc.c14B, OFFSET_AB)
    # q·n + x < 2^28: one fix covers the merged product-and-add
    t_B = _mod_fix(x_B + q_B * n_B, cc.mB, cc.invB_f)
    t_B = _mod_fix(t_B * cc.invA_B, cc.mB, cc.invB_f)
    sig2 = _mod_fix(t_B * cc.inv_Mi_B, cc.mB, cc.invB_f)
    t_A = _extend(sig2, cc.invB_f, cc.W_BA, cc.mA, cc.invA_f, cc.Bmod_A,
                  cc.c14A, OFFSET_BA)
    return t_A, t_B


def _mul_redc(aA, aB, bA, bB, sig_c, n_B, cc):
    pA = _mod_fix(aA * bA, cc.mA, cc.invA_f)
    pB = _mod_fix(aB * bB, cc.mB, cc.invB_f)
    return _redc(pA, pB, sig_c, n_B, cc)


def _limbs_to_rns(limbs: torch.Tensor, t_pair, m: torch.Tensor,
                  inv_f: torch.Tensor) -> torch.Tensor:
    """[K, N] int64 16-bit limbs → [I, N] int32 residues.

    Residues = Σ_l (2^(16l) mod m)·limb_l as one fixed matmul over
    7-bit halves of the table and 8-bit halves of the limbs (float32
    sums < K·127·255 < 2^24, exact).
    """
    th, tl = t_pair
    lh = (limbs >> 8).to(F32)
    ll = (limbs & 0xFF).to(F32)

    def mm(a, b):
        return torch.matmul(a, b).to(I32)

    def fix(v):
        return _mod_fix(v, m, inv_f)

    hh = mm(th, lh)      # weight 2^15
    hl = mm(th, ll)      # weight 2^7
    lh2 = mm(tl, lh)     # weight 2^8
    ll2 = mm(tl, ll)     # weight 2^0
    c15 = (1 << 15) % m
    c8 = (1 << 8) % m
    c7 = (1 << 7) % m
    return fix(fix(hh) * c15 + fix(fix(hl) * c7 + fix(lh2) * c8)
               + fix(ll2))


class FieldRNSContext(_ContextBase):
    """Shared RNS context for a fixed prime field (the EC engine).

    Two bases of 13-bit primes (the lazy adds/subs of the point ladder
    need m < 2^13 so digit-growth products stay below 2^31), the
    merged σ constant for REDC, c·p residue rows for congruence tests
    and positive subtracts, and the A-domain entry constant A² mod p.
    """

    def __init__(self, p: int, k_limbs: int, slack_bits: int = 16,
                 maxc: int = 32):
        self.p_int = p
        primes = _sieve_primes(1 << 12, 1 << 13)
        self.A, self.B = _two_bases(primes, p.bit_length() + slack_bits)
        self._init_common(k_limbs)
        ppr = [(-pow(p, -1, int(m))) % int(m) for m in self.A.m]
        self.sig_c = np.asarray(
            [(v * int(inv)) % int(m) for v, inv, m in
             zip(ppr, self.A.inv_Mi, self.A.m)], np.int32)[:, None]
        self.p_B = np.asarray([p % int(m) for m in self.B.m],
                              np.int32)[:, None]
        self.cp_A = np.asarray(
            [[(c * p) % int(m) for m in self.A.m] for c in range(maxc)],
            np.int32)
        self.cp_B = np.asarray(
            [[(c * p) % int(m) for m in self.B.m] for c in range(maxc)],
            np.int32)
        self.a_mod_p = self.A.prod % p
        a2 = (self.A.prod * self.A.prod) % p
        self.A2 = (np.asarray([a2 % int(m) for m in self.A.m],
                              np.int32)[:, None],
                   np.asarray([a2 % int(m) for m in self.B.m],
                              np.int32)[:, None])
        self.to_limbs = RNSToLimbs(self.A, k_limbs + 1)

    def residues_of(self, x: int) -> np.ndarray:
        """Plain host int → concatenated [I_A + I_B] residue row."""
        return np.asarray([x % int(m) for m in self.A.m]
                          + [x % int(m) for m in self.B.m], np.int64)

    def _extra_device_consts(self, ns, col, device) -> None:
        ns.sig_c = col(self.sig_c)
        ns.p_B = col(self.p_B)
        ns.cp_A = torch.as_tensor(self.cp_A, device=device)
        ns.cp_B = torch.as_tensor(self.cp_B, device=device)
        ns.A2 = (col(self.A2[0]), col(self.A2[1]))
        one = self.a_mod_p
        ns.one = (col([one % int(m) for m in self.A.m]),
                  col([one % int(m) for m in self.B.m]))

    def value_of(self, res_a: np.ndarray) -> int:
        """CRT value of one base-A residue column (values ≪ prod(A))."""
        a = self.A
        return sum(int(r) * int(inv) % int(m) * mi for r, inv, m, mi in
                   zip(res_a, a.inv_Mi, a.m, a.Mi)) % a.prod


class RNSToLimbs:
    """CRT reconstruction: base-A residues → 16-bit limbs (``rns.RNSToLimbs``
    of the JAX package).

    value = Σ_i σ_i·(A/a_i) − α·A with σ_i = x_i·(A/a_i)⁻¹ mod a_i and
    α = ⌊Σ σ_i/a_i⌉ (exact through the +0.5 offset: values are ≪ A).
    The Σ is a fixed float32 matmul against the limb rows of A/a_i,
    split 8+8 bits (table) by 7+7 bits (σ < 2^14): every sum is below
    I·255·127 < 2^24 for I ≤ 169 channels, so float32 (and TF32, whose
    inputs here fit 8 bits) is exact. Each weighted part spreads over
    two adjacent limbs, so the int64 sums stay below 2^32 for the carry
    pass. Valid for values < max_c·p ≪ A (the engines' bounds).
    """

    def __init__(self, base: _Base, k_out: int):
        self.base = base
        self.k_out = k_out
        bits = int(np.ceil(np.log2(float(base.count)))) + \
            sum(int(m).bit_length() for m in base.m)
        self.k2 = (bits + 15) // 16 + 1
        t16 = np.empty((self.k2, base.count), np.int64)
        for i, mi in enumerate(base.Mi):
            v = mi
            for ll in range(self.k2):
                t16[ll, i] = v & 0xFFFF
                v >>= 16
        self.t_hi = (t16 >> 8).astype(np.float32)
        self.t_lo = (t16 & 0xFF).astype(np.float32)
        a_limbs = np.zeros(self.k2 + 1, np.int64)
        v = base.prod
        for ll in range(self.k2):
            a_limbs[ll] = v & 0xFFFF
            v >>= 16
        self.a_limbs = a_limbs
        self._dev: Dict[torch.device, SimpleNamespace] = {}

    def _consts(self, device) -> SimpleNamespace:
        device = torch.device(device)
        hit = self._dev.get(device)
        if hit is None:
            b = self.base

            def col(v, dtype):
                return torch.as_tensor(np.asarray(v).reshape(-1, 1),
                                       dtype=dtype, device=device)

            hit = SimpleNamespace(
                t_hi=torch.as_tensor(self.t_hi, device=device),
                t_lo=torch.as_tensor(self.t_lo, device=device),
                a_limbs=col(self.a_limbs, torch.int64),
                m=col(b.m, I32), inv_f=col(1.0 / b.m, F32),
                inv_Mi=col(b.inv_Mi, I32))
            self._dev[device] = hit
        return hit

    def __call__(self, x_a: torch.Tensor) -> torch.Tensor:
        """[I, N] int32 digit-canonical base-A residues → [k_out, N]
        int64 limbs of the value."""
        from .bignum import carry_normalize, sub_where

        cc = self._consts(x_a.device)
        sig = _mod_fix(x_a * cc.inv_Mi, cc.m, cc.inv_f)
        alpha = torch.floor((sig.to(F32) * cc.inv_f).sum(dim=0)
                            + 0.5).to(torch.int64)          # [N]
        sh = (sig >> 7).to(F32)
        sl = (sig & 127).to(F32)

        def mm(a, b):
            return torch.matmul(a, b).to(torch.int64)

        def spread(v, shift):
            # v·2^shift at limb l → low bits at l, high bits at l+1
            lo = (v << shift) & 0xFFFF
            hi = v >> (16 - shift)
            return lo + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]])

        acc = (spread(mm(cc.t_hi, sh), 15) + spread(mm(cc.t_hi, sl), 8)
               + spread(mm(cc.t_lo, sh), 7) + mm(cc.t_lo, sl))
        acc = carry_normalize(torch.cat([acc, torch.zeros_like(acc[:1])]))
        corr = carry_normalize(alpha[None, :] * cc.a_limbs)
        ones = torch.ones(acc.shape[1], dtype=torch.bool, device=acc.device)
        return sub_where(acc, corr, ones)[: self.k_out]


def _to_limbs_for(ctx: RNSContext, k_out: int) -> RNSToLimbs:
    """The context's cached base-A reconstructor to ``k_out`` limbs."""
    cache = ctx.__dict__.setdefault("_to_limbs", {})
    if k_out not in cache:
        cache[k_out] = RNSToLimbs(ctx.A, k_out)
    return cache[k_out]


def _rns_pow65537(ctx: RNSContext, s_limbs, sig_c, n_B, a2_A, a2_B):
    """s^65537 mod n as a plain residue pair (value < 3n), all in RNS.

    s_limbs: [K, N] int64 limbs; the rest: [I, N] gathered per-token
    key constants.
    """
    cc = ctx.device_consts(s_limbs.device)
    sA = _limbs_to_rns(s_limbs, cc.T_A, cc.mA, cc.invA_f)
    sB = _limbs_to_rns(s_limbs, cc.T_B, cc.mB, cc.invB_f)
    xA, xB = _mul_redc(sA, sB, a2_A, a2_B, sig_c, n_B, cc)
    x0A, x0B = xA, xB
    for _ in range(16):
        xA, xB = _mul_redc(xA, xB, xA, xB, sig_c, n_B, cc)
    xA, xB = _mul_redc(xA, xB, x0A, x0B, sig_c, n_B, cc)
    # exit the Montgomery domain: multiply by 1 and reduce
    return _redc(xA, xB, sig_c, n_B, cc)


def _rns_modexp_em_core(ctx: RNSContext, k_out: int, s_limbs, sig_c, n_B,
                        a2_A, a2_B, n_limbs):
    """s^65537 mod n as canonical limbs [K, N] (the PSS path's EM).

    The verify core's RNS chain, then CRT reconstruction to ``k_out``
    limbs and two conditional subtracts of the per-token modulus
    ``n_limbs`` [K, N].
    """
    from .bignum import compare_ge, sub_where

    xA, _ = _rns_pow65537(ctx, s_limbs, sig_c, n_B, a2_A, a2_B)
    v = _to_limbs_for(ctx, k_out)(xA)
    n_pad = torch.cat([n_limbs, torch.zeros_like(n_limbs[:1])])
    for _ in range(2):
        v = sub_where(v, n_pad, compare_ge(v, n_pad))
    return v[: n_limbs.shape[0]]


def _rns_verify_core(ctx: RNSContext, s_limbs, expected_limbs,
                     sig_c, n_B, a2_A, a2_B):
    """Batched s^65537 mod n == expected (+c·n) check, all in RNS.

    s_limbs/expected_limbs: [K, N] int64 limbs; the rest: [I, N]
    gathered per-token key constants. Returns ok [N] bool.
    """
    cc = ctx.device_consts(s_limbs.device)
    xA, xB = _rns_pow65537(ctx, s_limbs, sig_c, n_B, a2_A, a2_B)

    eB = _limbs_to_rns(expected_limbs, cc.T_B, cc.mB, cc.invB_f)
    ok = torch.zeros(s_limbs.shape[1], dtype=torch.bool,
                     device=s_limbs.device)
    shifted = eB
    for _ in range(3):                      # c = 0, 1, 2 (result < 3n)
        ok = ok | (xB == shifted).all(dim=0)
        shifted = _mod_fix(shifted + n_B, cc.mB, cc.invB_f)
    return ok


def modexp_em_device(ctx: RNSContext, table: RNSKeyTable,
                     s_limbs: torch.Tensor, idx: torch.Tensor,
                     n_limbs: torch.Tensor) -> torch.Tensor:
    """[K, N] canonical limbs of s^65537 mod n (the PSS EM) for the
    tokens' key rows ``idx``; ``n_limbs`` the gathered moduli [K, N]."""
    sig_c, n_B, a2_A, a2_B = table.device_tables(s_limbs.device)
    return _rns_modexp_em_core(ctx, s_limbs.shape[0] + 1, s_limbs,
                               sig_c[idx].T, n_B[idx].T, a2_A[idx].T,
                               a2_B[idx].T, n_limbs)


def verify_em_equals_device(ctx: RNSContext, table: RNSKeyTable,
                            s_limbs: torch.Tensor,
                            expected_limbs: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """[N] bool: s^65537 mod n == expected, for the key rows ``idx``."""
    sig_c, n_B, a2_A, a2_B = table.device_tables(s_limbs.device)
    return _rns_verify_core(ctx, s_limbs, expected_limbs, sig_c[idx].T,
                            n_B[idx].T, a2_A[idx].T, a2_B[idx].T)
