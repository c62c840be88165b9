"""Unbiased random base62 strings from the CSPRNG (the port's copy of
the JAX package's ``utils/base62.py``; ``secrets.choice`` rejection-
samples, so every character is uniform)."""

from __future__ import annotations

import secrets

CHARSET = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


def random_base62(length: int) -> str:
    """Return a cryptographically random base62 string of ``length`` chars."""
    if length < 0:
        raise ValueError("length must be non-negative")
    return "".join(secrets.choice(CHARSET) for _ in range(length))
