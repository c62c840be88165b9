"""Batched Keccak-f[1600] and SHAKE-128/256 lanes (FIPS 202).

The port of the JAX package's ``tpu/pallas_keccak.py``: the hash plane
of fused ML-DSA verification (μ, SampleInBall and the c̃ recompute).

- **State layout**: each 64-bit Keccak lane rides as a bit-interleaved
  pair of 32-bit words (word 0 the even-indexed bits, word 1 the odd),
  so a 64-bit rotation is two 32-bit rotations. A batch of states is an
  int32 tensor ``[..., 25, 2]`` holding the words' bit patterns (view it
  as uint32 to compare with the JAX package); XOR, AND and NOT do not
  care about the interleaving.
- :func:`permute` is what the drivers call: the kernel wrapper
  ``cuda_keccak.f1600`` (the CUDA kernel on a CUDA tensor,
  :func:`f1600_plain` on a CPU tensor). :func:`f1600_plain` is the
  plain PyTorch permutation, the JAX package's vectorized ``_round_il``
  round for round, on words held in int64 below 2^32.
- The host does byte-level padding only (:func:`pad_message`,
  :func:`pack_blocks`); the device drivers (:func:`absorb`,
  :func:`absorb_fixed`, :func:`squeeze_lanes`) run the masked per-state
  block loop, so messages of different lengths share one shape.
- ``f1600_ref`` is the numpy uint64 host reference of the permutation.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

DOMAIN_SHAKE = 0x1F               # FIPS 202 SHAKE domain + pad10*1 head
M32 = 0xFFFFFFFF


def _gen_round_constants() -> np.ndarray:
    """The 24 ι round constants from the rc(t) LFSR (FIPS 202 §3.2.5)."""
    def rc_bits():
        r = 1
        while True:
            yield r & 1
            r <<= 1
            if r & 0x100:
                r ^= 0x171
    bits = rc_bits()
    out = []
    for _ in range(24):
        rc = 0
        for j in range(7):
            if next(bits):
                rc |= 1 << ((1 << j) - 1)
        out.append(rc)
    return np.array(out, np.uint64)


def _gen_rho_offsets() -> np.ndarray:
    """ρ rotation offsets per flat lane x+5y (FIPS 202 §3.2.2)."""
    r = np.zeros(25, np.int64)
    x, y = 1, 0
    for t in range(24):
        r[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return r


def _gen_pi() -> np.ndarray:
    # π: input lane x+5y lands at output flat lane y + 5*((2x+3y)%5).
    dest = np.zeros(25, np.int64)
    for x in range(5):
        for y in range(5):
            dest[x + 5 * y] = y + 5 * ((2 * x + 3 * y) % 5)
    return dest


RC64 = _gen_round_constants()
RHO = _gen_rho_offsets()
PI_DEST = _gen_pi()
# PI_SRC[l'] = the input lane that lands at output lane l'.
PI_SRC = np.zeros(25, np.int64)
PI_SRC[PI_DEST] = np.arange(25)


# ---------------------------------------------------------------------------
# numpy uint64 reference (exact; the oracle-side transform)
# ---------------------------------------------------------------------------

def _rotl64(v: np.ndarray, r: int) -> np.ndarray:
    if r == 0:
        return v
    return (v << np.uint64(r)) | (v >> np.uint64(64 - r))


def f1600_ref(state: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] on uint64 lanes ``[..., 25]`` (flat index x+5y)."""
    a = np.asarray(state, np.uint64).copy()
    for rc in RC64:
        c = a[..., 0:5].copy()
        for y in range(1, 5):
            c ^= a[..., 5 * y: 5 * y + 5]
        d = np.empty_like(c)
        for x in range(5):
            d[..., x] = c[..., (x - 1) % 5] ^ _rotl64(c[..., (x + 1) % 5], 1)
        for y in range(5):
            a[..., 5 * y: 5 * y + 5] ^= d
        b = np.empty_like(a)
        for lane in range(25):
            b[..., PI_DEST[lane]] = _rotl64(a[..., lane], int(RHO[lane]))
        for y in range(5):
            row = b[..., 5 * y: 5 * y + 5]
            a[..., 5 * y: 5 * y + 5] = row ^ (
                ~np.roll(row, -1, axis=-1) & np.roll(row, -2, axis=-1))
        a[..., 0] ^= rc
    return a


# ---------------------------------------------------------------------------
# bit interleaving (host numpy; uint64 <-> uint32 even/odd pairs)
# ---------------------------------------------------------------------------

def _compress_even_u64(x: np.ndarray) -> np.ndarray:
    """Gather the even-indexed bits of uint64 lanes into the low 32."""
    m = np.uint64
    x = x & m(0x5555555555555555)
    x = (x | (x >> m(1))) & m(0x3333333333333333)
    x = (x | (x >> m(2))) & m(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> m(4))) & m(0x00FF00FF00FF00FF)
    x = (x | (x >> m(8))) & m(0x0000FFFF0000FFFF)
    x = (x | (x >> m(16))) & m(0x00000000FFFFFFFF)
    return x.astype(np.uint32)


def _spread_u32_to_even_u64(x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_compress_even_u64`: u32 -> even bits of u64."""
    m = np.uint64
    x = x.astype(np.uint64)
    x = (x | (x << m(16))) & m(0x0000FFFF0000FFFF)
    x = (x | (x << m(8))) & m(0x00FF00FF00FF00FF)
    x = (x | (x << m(4))) & m(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << m(2))) & m(0x3333333333333333)
    x = (x | (x << m(1))) & m(0x5555555555555555)
    return x


def interleave(lanes64: np.ndarray) -> np.ndarray:
    """uint64 lanes ``[...]`` -> interleaved uint32 pairs ``[..., 2]``
    (``[..., 0]`` = even bits, ``[..., 1]`` = odd bits)."""
    lanes64 = np.asarray(lanes64, np.uint64)
    e = _compress_even_u64(lanes64)
    o = _compress_even_u64(lanes64 >> np.uint64(1))
    return np.stack([e, o], axis=-1)


def deinterleave(il: np.ndarray) -> np.ndarray:
    """Interleaved uint32 pairs ``[..., 2]`` -> uint64 lanes ``[...]``."""
    il = np.asarray(il, np.uint32)
    e = _spread_u32_to_even_u64(il[..., 0])
    o = _spread_u32_to_even_u64(il[..., 1])
    return e | (o << np.uint64(1))


RC_IL = interleave(RC64)                                  # [24, 2]

# 64-bit rotation in the interleaved domain: even r -> both words
# rotate by r/2; odd r -> the words swap roles, the (new) even word
# rotates one extra step. ρ and π fused: output lane lp takes input
# lane PI_SRC[lp] rotated by RHO[PI_SRC[lp]].
_RHO_SWAP = (RHO % 2).astype(bool)
_RHO_RE = np.where(_RHO_SWAP, (RHO + 1) // 2, RHO // 2)   # rot for E'
_RHO_RO = RHO // 2                                        # rot for O'


# ---------------------------------------------------------------------------
# the per-thread constants of csrc/keccak.cu (25 threads a state)
# ---------------------------------------------------------------------------

# Rows of LANE_TAB, in the kernel's order. Thread l < 25 of a warp holds
# flat lane l = x + 5y; each *source* row names the thread a shuffle
# reads from:
# - up1, up2, up4: lanes (x, y+1), (x, y+2), (x, y+4) (θ's parity);
# - xm1, xp1: lanes (x-1, y), (x+1, y) (θ's D);
# - re, ro, swap: ρ on the thread's own lane (its word rotations, and
#   -1 where the odd amount swaps the words);
# - pi0, pi1, pi2: the π sources of output lane l and of its row
#   neighbours x+1 and x+2 (χ);
# - iota: -1 on lane 0 (ι's mask).
# Threads 25..31 hold no lane: they read from themselves and rotate by 0.
LANE_TAB_ROWS = ("up1", "up2", "up4", "xm1", "xp1", "re", "ro", "swap",
                 "pi0", "pi1", "pi2", "iota")


def lane_tables() -> np.ndarray:
    """The kernel's per-thread constants, int32 [len(LANE_TAB_ROWS), 32]
    (row k holds constant k of each thread of a warp)."""
    def lane(x, y):
        return x % 5 + 5 * (y % 5)

    tab = np.zeros((len(LANE_TAB_ROWS), 32), np.int64)
    for r in ("up1", "up2", "up4", "xm1", "xp1", "pi0", "pi1", "pi2"):
        tab[LANE_TAB_ROWS.index(r)] = np.arange(32)
    for t in range(25):
        x, y = t % 5, t // 5
        row = 5 * y
        tab[:, t] = (lane(x, y + 1), lane(x, y + 2), lane(x, y + 4),
                     lane(x - 1, y), lane(x + 1, y), _RHO_RE[t],
                     _RHO_RO[t], -int(_RHO_SWAP[t]), PI_SRC[t],
                     PI_SRC[row + (x + 1) % 5], PI_SRC[row + (x + 2) % 5],
                     -int(t == 0))
    return tab.astype(np.int32)


LANE_TAB = lane_tables()


# ---------------------------------------------------------------------------
# the plain PyTorch permutation (words in int64, below 2^32)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _round_consts(device: torch.device):
    rc = np.zeros((24, 25, 2), np.int64)
    rc[:, 0, :] = RC_IL
    t = functools.partial(torch.as_tensor, device=device)
    return (t(rc), t(PI_SRC), t(_RHO_RE[PI_SRC]), t(_RHO_RO[PI_SRC]),
            t(_RHO_SWAP[PI_SRC]))


def _rotl32(w: torch.Tensor, s) -> torch.Tensor:
    """Rotate-left of int64-held 32-bit words by s in [0, 32) (an int
    or a tensor; s = 0 gives w, as w >> 32 is 0)."""
    return ((w << s) & M32) | (w >> (32 - s))


def _round_il(a: torch.Tensor, rc: torch.Tensor, consts) -> torch.Tensor:
    """One round on [..., 25, 2] int64 words, every lane at once."""
    _, pi_src, re, ro, swap = consts
    lead = a.shape[:-2]
    a5 = a.reshape(lead + (5, 5, 2))                      # [..., y, x, 2]
    c = a5[..., 0, :, :] ^ a5[..., 1, :, :] ^ a5[..., 2, :, :] \
        ^ a5[..., 3, :, :] ^ a5[..., 4, :, :]             # [..., x, 2]
    cm1 = torch.roll(c, 1, dims=-2)
    cp1 = torch.roll(c, -1, dims=-2)
    # rot64 by 1 (odd): E' = rotl32(O, 1), O' = E
    cp1r = torch.stack([_rotl32(cp1[..., 1], 1), cp1[..., 0]], dim=-1)
    d = cm1 ^ cp1r
    a = (a5 ^ d[..., None, :, :]).reshape(lead + (25, 2))
    g = a.index_select(a.dim() - 2, pi_src)               # ρ + π
    ge, go = g[..., 0], g[..., 1]
    be = torch.where(swap, _rotl32(go, re), _rotl32(ge, re))
    bo = torch.where(swap, _rotl32(ge, ro), _rotl32(go, ro))
    b5 = torch.stack([be, bo], dim=-1).reshape(lead + (5, 5, 2))
    a = (b5 ^ (~torch.roll(b5, -1, dims=-2) & torch.roll(b5, -2, dims=-2))) \
        .reshape(lead + (25, 2))
    return a ^ rc


def _to_words(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2^32)."""
    return x.to(torch.int64) & M32


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, uint32 lanes as their int32 bit
    patterns (the layout of every state here)."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a).to(device)


def f1600_plain(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on int32 [..., 25, 2] interleaved states."""
    consts = _round_consts(state.device)
    a = _to_words(state)
    for i in range(24):
        a = _round_il(a, consts[0][i], consts)
    return _to_int32(a)


def permute(state: torch.Tensor) -> torch.Tensor:
    """The permutation the drivers call: the kernel wrapper."""
    from . import cuda_keccak

    return cuda_keccak.f1600(state.contiguous())


# ---------------------------------------------------------------------------
# host packing + device absorb/squeeze drivers
# ---------------------------------------------------------------------------

def pad_message(data: bytes, rate: int) -> bytes:
    """SHAKE pad10*1 with the 0x1F domain: whole rate-blocks out."""
    msg = bytearray(data)
    msg.append(DOMAIN_SHAKE)
    while len(msg) % rate:
        msg.append(0)
    msg[-1] ^= 0x80
    return bytes(msg)


def pack_blocks(msgs: Sequence[bytes], rate: int,
                min_blocks: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Pad + interleave a batch of variable-length messages.

    Returns ``(blocks [B, NB, 25, 2] uint32, nblk [B] int32)`` where
    NB = max(ceil((len+1)/rate)) over the batch (at least
    ``min_blocks``); capacity lanes and blocks past a message's count
    are zero. The host does byte shuffling only, all messages at once.
    """
    nl = rate // 8
    padded = [pad_message(m, rate) for m in msgs]
    nblk = np.array([len(p) // rate for p in padded], np.int32)
    nb = max(int(nblk.max()) if len(padded) else 1, min_blocks)
    buf = np.zeros((len(padded), nb * rate), np.uint8)
    for i, p in enumerate(padded):
        buf[i, :len(p)] = np.frombuffer(p, np.uint8)
    out = np.zeros((len(padded), nb, 25, 2), np.uint32)
    out[:, :, :nl] = interleave(
        buf.view("<u8").reshape(len(padded), nb, nl))
    return out, nblk


def absorb(blocks: torch.Tensor, nblk: torch.Tensor) -> torch.Tensor:
    """Masked batched absorb: ``blocks`` int32 [..., NB, 25, 2] (from
    :func:`pack_blocks`), ``nblk`` [...] block counts. Every block is
    permuted for every state; a state past its own count keeps its
    value. Returns the final states [..., 25, 2]."""
    state = torch.zeros(blocks.shape[:-3] + (25, 2), dtype=torch.int32,
                        device=blocks.device)
    for blk in range(blocks.shape[-3]):
        nxt = permute(state ^ blocks[..., blk, :, :])
        live = (nblk > blk)[..., None, None]
        state = torch.where(live, nxt, state)
    return state


def absorb_fixed(blocks: torch.Tensor) -> torch.Tensor:
    """Absorb where every state uses all NB blocks (no mask)."""
    state = torch.zeros(blocks.shape[:-3] + (25, 2), dtype=torch.int32,
                        device=blocks.device)
    for blk in range(blocks.shape[-3]):
        state = permute(state ^ blocks[..., blk, :, :])
    return state


def squeeze_lanes(state: torch.Tensor, rate: int,
                  n_blocks: int) -> torch.Tensor:
    """``n_blocks`` squeeze blocks of interleaved lanes from absorbed
    states [B, 25, 2] -> [B, n_blocks * rate//8, 2]."""
    nl = rate // 8
    outs = [state[..., :nl, :]]
    for _ in range(n_blocks - 1):
        state = permute(state)
        outs.append(state[..., :nl, :])
    return torch.cat(outs, dim=-2)


def _spread16(x: torch.Tensor) -> torch.Tensor:
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def lanes_to_bytes(lanes: torch.Tensor) -> torch.Tensor:
    """Interleaved lanes [..., L, 2] -> bytes [..., L*8] as int32 values
    in [0, 256), little-endian per lane."""
    w = _to_words(lanes)
    e, o = w[..., 0], w[..., 1]
    lo = _spread16(e) | (_spread16(o) << 1)
    hi = _spread16(e >> 16) | (_spread16(o >> 16) << 1)
    w64 = torch.stack([lo, hi], dim=-1)                   # [..., L, 2]
    shifts = torch.arange(0, 32, 8, device=lanes.device)
    by = (w64[..., None] >> shifts) & 0xFF
    return by.reshape(by.shape[:-3] + (-1,)).to(torch.int32)


def bits_to_lanes(bits: torch.Tensor) -> torch.Tensor:
    """Little-endian bits [..., L*64] (values 0/1) -> interleaved lanes
    int32 [..., L, 2]: even and odd bits fold straight into the two
    words."""
    lead = bits.shape[:-1]
    nl = bits.shape[-1] // 64
    v = bits.reshape(lead + (nl, 32, 2)).to(torch.int64)
    shifts = torch.arange(32, device=bits.device)
    e = (v[..., 0] << shifts).sum(dim=-1)
    o = (v[..., 1] << shifts).sum(dim=-1)
    return _to_int32(torch.stack([e, o], dim=-1))
