"""Batched big-number arithmetic on int64 limb tensors.

The port of the JAX package's limb engine: the ES* scalar work (range
checks, s⁻¹, u1/u2), the RSA modexps of keys the RNS engine does
not take (``modexp_65537``, ``modexp_vare``) or of every key under an
entry point's ``rns=False``, and the field arithmetic of the limb
ECDSA and Ed25519 ladders (``add_mod``, ``sub_mod``). Little-endian
base-2^16 limbs, limb-first [K, N], every limb a 16-bit value held in
int64 so limb products and column sums never wrap. Carries and borrows resolve
in fixed depth — one ripple pass, then a Kogge-Stone carry-lookahead
over the limb axis — so no step depends on the data.
"""

from __future__ import annotations

import torch

from .limbs import LIMB_BITS, LIMB_MASK, int_to_limbs, limbs_to_int

I64 = torch.int64


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """Shift one limb toward the most-significant end (row 0 ← zero)."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def _carry_lookahead(digits: torch.Tensor, carry_in: torch.Tensor,
                     propagate_at: int) -> torch.Tensor:
    """Exact resolution of unit carries/borrows in log₂K steps.

    u_i = carry_in_i | (prop_{i-1} & u_{i-1}), as an inclusive
    Hillis-Steele scan over the limb axis with the combine
    (gl, ql) ∘ (gr, qr) = (gr | (qr & gl), ql & qr).
    """
    g = carry_in.bool()
    q = _shift_up(digits == propagate_at)
    k = g.shape[0]
    d = 1
    while d < k:
        g = g | (q & torch.cat([torch.zeros_like(g[:d]), g[:-d]], dim=0))
        q = q & torch.cat([torch.ones_like(q[:d]), q[:-d]], dim=0)
        d *= 2
    return g.to(I64)


def carry_normalize(v: torch.Tensor) -> torch.Tensor:
    """Propagate carries until every limb is < 2^16 (exact, fixed depth).

    v: [K, N] with limbs below 2^32; the top limb must have headroom
    for the final carry (callers allocate a spare limb).
    """
    v1 = (v & LIMB_MASK) + _shift_up(v >> LIMB_BITS)
    l2 = v1 & LIMB_MASK
    c2 = _shift_up(v1 >> LIMB_BITS)          # unit carries
    u = _carry_lookahead(l2, c2, LIMB_MASK)
    return (l2 + u) & LIMB_MASK


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of two [K, N] limb tensors → [2K+1, N] normalized.

    The [K, K, N] partial products split into 16-bit halves; each half
    lands on its anti-diagonal column by one index_add, so column sums
    stay below 2K·2^16 and one ripple pass leaves unit carries.
    """
    k, n = a.shape
    p = b[:, None, :] * a[None, :, :]                 # [K(j), K(i), N]
    pos = (torch.arange(k, device=a.device)[:, None]
           + torch.arange(k, device=a.device)[None, :]).reshape(-1)
    out = torch.zeros((2 * k + 1, n), dtype=I64, device=a.device)
    out.index_add_(0, pos, (p & LIMB_MASK).reshape(k * k, n))
    out.index_add_(0, pos + 1, (p >> LIMB_BITS).reshape(k * k, n))
    return carry_normalize(out)


def compare_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a >= b over normalized [K, N] limbs → [N] bool."""
    eq = (a == b).to(I64)
    # higher_eq[i]: every limb above i is equal
    higher_eq = torch.cumprod(eq.flip(0), dim=0).flip(0)
    higher_eq = torch.cat([higher_eq[1:], torch.ones_like(higher_eq[:1])],
                          dim=0).bool()
    decides_gt = ((a > b) & higher_eq).any(dim=0)
    decides_lt = ((a < b) & higher_eq).any(dim=0)
    return decides_gt | ~(decides_gt | decides_lt)


def sub_where(a: torch.Tensor, b: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Where mask: a - b (requires a >= b there); else a."""
    d = a - torch.where(mask[None, :], b, torch.zeros_like(b))
    lo = d & LIMB_MASK                    # d mod 2^16, two's complement
    borrow = _shift_up((d < 0).to(I64))   # unit borrows arriving AT i
    u = _carry_lookahead(lo, borrow, 0)
    return (lo - u) & LIMB_MASK


def mont_mul(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor,
             nprime: torch.Tensor) -> torch.Tensor:
    """Montgomery product a·b·R⁻¹ mod n, R = 2^(16K); a·b < R·n."""
    k = a.shape[0]
    t_full = mul(a, b)                        # [2K+1, N]
    m = mul(t_full[:k], nprime)[:k]           # low K limbs ≡ mod R
    s = carry_normalize(t_full + mul(m, n))   # low K limbs are exactly 0
    t = s[k:]                                 # [K+1, N]; value < 2n
    n_pad = torch.cat([n, torch.zeros_like(n[:1])], dim=0)
    return sub_where(t, n_pad, compare_ge(t, n_pad))[:k]


def mont_sqr(a: torch.Tensor, n: torch.Tensor,
             nprime: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a, n, nprime)


def mont_mul_lazy(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor,
                  nprime: torch.Tensor) -> torch.Tensor:
    """Montgomery product WITHOUT the conditional subtract.

    Requires R = 2^(16K) ≥ 4n (one spare limb beyond the modulus). For
    inputs < 2n the output (ab + mn)/R stays < 2n, so a whole modexp
    chain runs with no compare and one final reduction canonicalizes.
    """
    k = a.shape[0]
    t_full = mul(a, b)                        # [2K+1, N]
    m = mul(t_full[:k], nprime)[:k]
    s = carry_normalize(t_full + mul(m, n))   # low K limbs exactly 0
    return s[k: 2 * k]


def _one_limbs(s: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(s)
    one[0] = 1
    return one


def modexp_65537(s: torch.Tensor, n: torch.Tensor, nprime: torch.Tensor,
                 r2: torch.Tensor) -> torch.Tensor:
    """s^65537 mod n for the whole batch, [K, N] canonical limbs.

    s, n, nprime, r2: [K, N]; r2 = R² mod n per token; R ≥ 4n (the key
    table's spare limb). 19 subtraction-free Montgomery products
    (domain entry, 16 squarings, ·s, domain exit), then one
    canonicalizing conditional subtract.
    """
    s_m = mont_mul_lazy(s, r2, n, nprime)
    x = s_m
    for _ in range(16):
        x = mont_mul_lazy(x, x, n, nprime)
    x = mont_mul_lazy(x, s_m, n, nprime)
    x = mont_mul_lazy(x, _one_limbs(s), n, nprime)   # leave domain; ≤ n
    return sub_where(x, n, compare_ge(x, n))


def modexp_vare(s: torch.Tensor, e: torch.Tensor, n: torch.Tensor,
                nprime: torch.Tensor, r2: torch.Tensor,
                one_mont: torch.Tensor, ebits: int) -> torch.Tensor:
    """s^e mod n with per-token exponents below 2^32, [K, N] limbs.

    e: [N] int64; ``ebits`` the widest exponent's bit length. A
    left-to-right ladder over ``ebits`` bits from ``one_mont`` (R mod
    n), every step a square and a multiply with a per-token select.
    """
    s_m = mont_mul(s, r2, n, nprime)
    x = one_mont
    for i in range(ebits):
        x = mont_sqr(x, n, nprime)
        mult = mont_mul(x, s_m, n, nprime)
        bit = ((e >> (ebits - 1 - i)) & 1).bool()
        x = torch.where(bit[None, :], mult, x)
    return mont_mul(x, _one_limbs(s), n, nprime)


def batch_mont_inverse(x_m: torch.Tensor, n1: torch.Tensor,
                       npp1: torch.Tensor, n_int: int,
                       min_width: int = 128) -> torch.Tensor:
    """Simultaneous inversion of a whole batch (Montgomery domain): see
    :func:`batch_mont_inverse_steps`."""
    return run_steps(batch_mont_inverse_steps(x_m, n1, npp1, n_int,
                                              min_width))


def run_steps(steps):
    """Run a core written as a generator to its end and return its
    value. Such a core yields just before each read of the device
    (:func:`batch_mont_inverse_steps`), so that a meshed caller
    (``parallel.place.on_shards``) can queue every shard's work up to
    that read before any shard reads."""
    while True:
        try:
            next(steps)
        except StopIteration as stop:
            return stop.value


def batch_mont_inverse_steps(x_m: torch.Tensor, n1: torch.Tensor,
                             npp1: torch.Tensor, n_int: int,
                             min_width: int = 128):
    """Simultaneous inversion of a whole batch (Montgomery domain), as
    a generator that yields once, with the root queued on the device
    and not yet read, and returns the inverses (:func:`run_steps`).

    Montgomery's product tree: pair-multiply down to a ``min_width``
    root, invert the root, walk back down — ~3 multiplies per element.
    x_m: [K, N] Montgomery values, N a power of two; n1/npp1: [K, 1]
    modulus and N' columns. The root's Fermat power (x_m)^(n−2) in the
    Montgomery domain runs as one host ``pow`` over its ``min_width``
    lanes: the same canonical values the device ladder of the JAX
    package computes, without 2·nbits dependent multiplies on the card.
    Copying the root to the host waits for the device work queued so
    far: the one point where an ES chunk blocks the host before its
    results are read.
    """
    k, n_batch = x_m.shape

    def bc(c, width):
        return c.expand(k, width)

    levels = [x_m]
    cur = x_m
    while cur.shape[1] > min_width and cur.shape[1] % 2 == 0:
        half = cur.shape[1] // 2
        cur = mont_mul(cur[:, 0::2], cur[:, 1::2], bc(n1, half),
                       bc(npp1, half))
        levels.append(cur)

    r = 1 << (LIMB_BITS * k)
    r_inv = pow(r, -1, n_int)
    yield
    root = cur.cpu().numpy()
    inv_np = root.copy()
    for j in range(root.shape[1]):
        plain = limbs_to_int(root[:, j]) * r_inv % n_int
        inv_np[:, j] = int_to_limbs(pow(plain, n_int - 2, n_int) * r % n_int,
                                    k)
    inv = torch.from_numpy(inv_np).to(x_m.device)

    for lvl in levels[-2::-1]:
        width = lvl.shape[1]
        half = width // 2
        nh, nph = bc(n1, half), bc(npp1, half)
        inv_left = mont_mul(inv, lvl[:, 1::2], nh, nph)
        inv_right = mont_mul(inv, lvl[:, 0::2], nh, nph)
        inv = torch.stack([inv_left, inv_right], dim=2).reshape(k, width)
    return inv


def add_mod(a: torch.Tensor, b: torch.Tensor,
            m: torch.Tensor) -> torch.Tensor:
    """(a + b) mod m over [K, N] normalized limbs, a, b < m; m [K, N] or
    a [K, 1] column."""
    k = a.shape[0]
    zero_row = torch.zeros_like(a[:1])
    t = carry_normalize(torch.cat([a + b, zero_row], dim=0))
    m_pad = torch.cat([m.expand_as(a), zero_row], dim=0)
    return sub_where(t, m_pad, compare_ge(t, m_pad))[:k]


def sub_mod(a: torch.Tensor, b: torch.Tensor,
            m: torch.Tensor) -> torch.Tensor:
    """(a − b) mod m over [K, N] normalized limbs, a, b < m: a + m − b,
    then one conditional subtract."""
    k = a.shape[0]
    zero_row = torch.zeros_like(a[:1])
    m = m.expand_as(a)
    t = carry_normalize(torch.cat([a + m, zero_row], dim=0))
    b_pad = torch.cat([b.expand_as(a), zero_row], dim=0)
    t = sub_where(t, b_pad, torch.ones(a.shape[1], dtype=torch.bool,
                                       device=a.device))
    m_pad = torch.cat([m, zero_row], dim=0)
    return sub_where(t, m_pad, compare_ge(t, m_pad))[:k]


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """[K, N] normalized limbs → [N] bool: value == 0."""
    return (a == 0).all(dim=0)


def mont_params(n_int: int, k: int):
    """Montgomery constants for modulus n with R = 2^(16k).

    Returns (nprime_int, r2_int, one_mont_int):
    N' = -n⁻¹ mod R;  R² mod n;  R mod n.
    """
    if n_int % 2 == 0:
        raise ValueError("modulus must be odd")
    r = 1 << (LIMB_BITS * k)
    if n_int >= r:
        raise ValueError("modulus does not fit in k limbs")
    nprime = (-pow(n_int, -1, r)) % r
    return nprime, (r * r) % n_int, r % n_int
