"""Number-theoretic transform over Z_q, q = 8380417 (FIPS 204 §7.5).

The port of the JAX package's ``tpu/ntt.py``: the 256-point forward
and inverse NTT of ML-DSA verification, the Montgomery products of the
ring arithmetic around them, and UseHint.

Coefficients are int32 tensors holding canonical values in [0, q)
(< 2^23, so int32 holds them exactly; the CUDA kernels read them as
uint32). Twiddles and key tables are in Montgomery form (ζ·R mod q,
R = 2^32), so ``mont_mul(zeta_mont, x)`` is the plain product ζ·x mod
q and per-token data never changes domain. The inverse folds 256⁻¹
into one final Montgomery product.

- :func:`ntt` / :func:`intt` are what the engine calls: the kernel
  wrappers of ``gpu/cuda_ntt.py`` (the CUDA kernels on a CUDA tensor,
  :func:`ntt_plain` / :func:`intt_plain` on a CPU tensor).
- :func:`ntt_plain` / :func:`intt_plain` are the stagewise plain
  PyTorch versions, butterfly for butterfly the JAX package's jnp
  graph. Montgomery products are exact int64 products reduced mod q:
  a Montgomery result in [0, q) is unique, so the values equal the
  JAX package's uint32 limb arithmetic.
- ``ntt_ref`` / ``intt_ref`` / ``use_hint_ref`` are numpy int64 host
  references (exact, no Montgomery): the host oracle's transform.
"""

from __future__ import annotations

import numpy as np
import torch

Q = 8380417                       # 2^23 - 2^13 + 1
N = 256
ZETA = 1753                       # primitive 512th root of unity mod q
MONT_BITS = 32
# -q^{-1} mod 2^32 for unsigned REDC (csrc/ntt.cu's kNQInv):
# p + (p·NQINV mod 2^32)·q ≡ 0 (mod 2^32)
NQINV = (-pow(Q, -1, 1 << MONT_BITS)) % (1 << MONT_BITS)
R_INV = pow(1 << MONT_BITS, -1, Q)
INV256 = pow(N, -1, Q)


def _bitrev8(x: int) -> int:
    r = 0
    for _ in range(8):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


# zetas[k] = ζ^bitrev8(k) mod q, consumed in index order by the
# standard Cooley-Tukey schedule (zetas[0] is never referenced).
ZETAS = np.array([pow(ZETA, _bitrev8(k), Q) for k in range(N)], np.int64)
ZETAS_MONT = ((ZETAS << MONT_BITS) % Q).astype(np.uint32)
NEG_ZETAS_MONT = (((Q - ZETAS) << MONT_BITS) % Q).astype(np.uint32)
INV256_MONT = np.uint32((INV256 << MONT_BITS) % Q)


# ---------------------------------------------------------------------------
# Montgomery arithmetic on tensors of canonical values
# ---------------------------------------------------------------------------

def mont_mul(a, b) -> torch.Tensor:
    """a·b·R⁻¹ mod q for tensors (or ints) of values in [0, q), as
    int64. With one operand pre-multiplied by R (twiddles, key tables)
    this is the plain modular product of the other."""
    return (torch.as_tensor(a, dtype=torch.int64) * b) % Q * R_INV % Q


def add_q(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = a + b
    return torch.where(t >= Q, t - Q, t)


def sub_q(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(a >= b, a - b, a + Q - b)


# ---------------------------------------------------------------------------
# batched NTT / inverse NTT (last axis = 256 coefficients)
# ---------------------------------------------------------------------------

def ntt_plain(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT, plain domain in and out (CRYSTALS bit-reversed
    frequency order), eight stagewise PyTorch sweeps. x: int32
    [..., 256] in [0, q); returns int32 of the same shape."""
    shape = x.shape
    lead = shape[:-1]
    zm = torch.from_numpy(ZETAS_MONT.astype(np.int64)).to(x.device)
    y = x.to(torch.int64)
    for s in range(8):                # len = 128 >> s
        ln = 128 >> s
        nblk = N // (2 * ln)
        v = y.reshape(lead + (nblk, 2, ln))
        lo_, hi_ = v[..., 0, :], v[..., 1, :]
        t = mont_mul(zm[nblk: 2 * nblk, None], hi_)
        y = torch.stack([add_q(lo_, t), sub_q(lo_, t)],
                        dim=-2).reshape(shape)
    return y.to(torch.int32)


def intt_plain(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT (Gentleman-Sande) with the 256⁻¹ scale folded in;
    the exact inverse of :func:`ntt_plain`. int32 [..., 256] in and
    out."""
    shape = x.shape
    lead = shape[:-1]
    nz = torch.from_numpy(NEG_ZETAS_MONT.astype(np.int64)).to(x.device)
    y = x.to(torch.int64)
    for s in range(8):                # len = 1 << s
        ln = 1 << s
        nblk = N // (2 * ln)
        # k decrements from 2·nblk-1 down to nblk as blocks advance.
        z = nz[nblk: 2 * nblk].flip(0)[:, None]
        v = y.reshape(lead + (nblk, 2, ln))
        lo_, hi_ = v[..., 0, :], v[..., 1, :]
        y = torch.stack([add_q(lo_, hi_), mont_mul(z, sub_q(lo_, hi_))],
                        dim=-2).reshape(shape)
    return mont_mul(int(INV256_MONT), y).to(torch.int32)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT through the kernel wrapper (``cuda_ntt.ntt``)."""
    from . import cuda_ntt

    return cuda_ntt.ntt(x)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT through the kernel wrapper (``cuda_ntt.intt``)."""
    from . import cuda_ntt

    return cuda_ntt.intt(x)


# ---------------------------------------------------------------------------
# UseHint lanes (FIPS 204 §7.4) — per-parameter-set γ2
# ---------------------------------------------------------------------------

def use_hint(h: torch.Tensor, r: torch.Tensor, gamma2: int) -> torch.Tensor:
    """Vectorized UseHint: w1 values in [0, m), m = (q-1)/(2γ2), as
    int64, from hint bits h (any integer or bool dtype, {0, 1}) and
    raw w values r in [0, q). gamma2: 95232 (ML-DSA-44) or 261888
    (65/87)."""
    two_g2 = 2 * gamma2
    m = (Q - 1) // two_g2
    r = r.to(torch.int64)
    rm = r % two_g2
    is_neg = rm > gamma2              # centered r0 < 0
    r_sub_r0 = r - rm + torch.where(is_neg, two_g2, 0)
    special = r_sub_r0 == Q - 1       # r1 wraps to 0, r0 -= 1
    r1 = torch.where(special, 0, r_sub_r0 // two_g2)
    r0_pos = (~special) & (~is_neg) & (rm > 0)
    bumped = torch.where(r0_pos, r1 + 1, r1 + m - 1) % m
    return torch.where(h != 0, bumped, r1)


# ---------------------------------------------------------------------------
# numpy int64 host reference (exact arithmetic; the oracle's transform)
# ---------------------------------------------------------------------------

def ntt_ref(x: np.ndarray) -> np.ndarray:
    """Forward NTT on int64 numpy lanes [..., 256], values [0, q)."""
    a = np.asarray(x, np.int64).copy()
    k = 0
    ln = 128
    while ln >= 1:
        for start in range(0, N, 2 * ln):
            k += 1
            z = int(ZETAS[k])
            t = (z * a[..., start + ln: start + 2 * ln]) % Q
            a[..., start + ln: start + 2 * ln] = \
                (a[..., start: start + ln] - t) % Q
            a[..., start: start + ln] = \
                (a[..., start: start + ln] + t) % Q
        ln //= 2
    return a


def intt_ref(x: np.ndarray) -> np.ndarray:
    """Inverse NTT on int64 numpy lanes; exact inverse of ntt_ref."""
    a = np.asarray(x, np.int64).copy()
    k = N
    ln = 1
    while ln < N:
        for start in range(0, N, 2 * ln):
            k -= 1
            z = Q - int(ZETAS[k])
            t = a[..., start: start + ln].copy()
            a[..., start: start + ln] = \
                (t + a[..., start + ln: start + 2 * ln]) % Q
            a[..., start + ln: start + 2 * ln] = \
                (z * (t - a[..., start + ln: start + 2 * ln])) % Q
        ln *= 2
    return (a * INV256) % Q


def use_hint_ref(h: np.ndarray, r: np.ndarray, gamma2: int) -> np.ndarray:
    """numpy reference of :func:`use_hint` (same special-case rules)."""
    r = np.asarray(r, np.int64)
    two_g2 = 2 * gamma2
    m = (Q - 1) // two_g2
    rm = r % two_g2
    is_neg = rm > gamma2
    r_sub_r0 = r - rm + np.where(is_neg, two_g2, 0)
    special = r_sub_r0 == Q - 1
    r1 = np.where(special, 0, r_sub_r0 // two_g2)
    r0_pos = (~special) & (~is_neg) & (rm > 0)
    bumped = np.where(r0_pos, r1 + 1, r1 + m - 1) % m
    return np.where(np.asarray(h) != 0, bumped, r1)
