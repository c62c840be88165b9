"""Limb packing: Python ints / big-endian bytes ↔ limb arrays.

Numbers are little-endian base-2^16 limb vectors, limb-first [K, N] —
the JAX package's layout, so intermediate values compare directly.
Host helpers work on numpy (uint32); device limbs are int64 torch
tensors, because 16×16-bit products overflow int32 and torch's uint32
lacks most operations.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1


def nlimbs_for_bits(bits: int) -> int:
    return (bits + LIMB_BITS - 1) // LIMB_BITS


def int_to_limbs(value: int, k: int) -> np.ndarray:
    """One int → [k] uint32 little-endian limb vector."""
    if value < 0:
        raise ValueError("negative values are not representable")
    if value >> (k * LIMB_BITS):
        raise ValueError(f"value does not fit in {k} limbs")
    out = np.empty(k, dtype=np.uint32)
    for i in range(k):
        out[i] = value & LIMB_MASK
        value >>= LIMB_BITS
    return out


def ints_to_limbs(values: Sequence[int], k: int) -> np.ndarray:
    """N ints → [k, N] uint32 limb-first array."""
    for v in values:
        if v < 0 or v >> (k * LIMB_BITS):
            raise ValueError(f"value does not fit in {k} limbs")
    blob = b"".join(v.to_bytes(2 * k, "little") for v in values)
    return np.frombuffer(blob, "<u2").reshape(len(values), k).T.astype(
        np.uint32)


def limbs_to_int(limbs) -> int:
    """[k] limb vector → int (limbs need not be normalized)."""
    value = 0
    for i in range(len(limbs) - 1, -1, -1):
        value = (value << LIMB_BITS) + int(limbs[i])
    return value


def right_align_bytes(mat: np.ndarray, lens: np.ndarray,
                      width: int) -> np.ndarray:
    """Left-aligned [N, W] byte rows → right-aligned [N, width].

    Row i's value occupies its first lens[i] bytes; output rows are
    zero-padded on the left (big-endian integer layout).
    """
    n, w = mat.shape
    if int(lens.max(initial=0)) > width:
        raise ValueError("value exceeds capacity")
    cols = np.arange(width)[None, :]
    src = cols - (width - lens[:, None])
    valid = src >= 0
    return np.where(valid, mat[np.arange(n)[:, None],
                               np.clip(src, 0, w - 1)], 0).astype(np.uint8)


def bytes_to_limbs_device(mat: torch.Tensor) -> torch.Tensor:
    """[N, 2K] uint8 right-aligned big-endian → [K, N] int64 limbs.

    The host ships raw bytes; the big-endian-bytes → little-endian
    limbs transform runs where the tensor lives.
    """
    m = mat.to(torch.int64)
    limbs_be = (m[:, 0::2] << 8) | m[:, 1::2]
    return limbs_be.flip(1).T.contiguous()


def nibbles(u: torch.Tensor, n: int) -> torch.Tensor:
    """[K, N] 16-bit limbs → the first n of their [4K, N] 4-bit digits,
    least significant first (the limb ladders' window digits)."""
    k, m = u.shape
    return torch.stack([(u >> (4 * j)) & 15 for j in range(4)],
                       dim=1).reshape(4 * k, m)[:n]
