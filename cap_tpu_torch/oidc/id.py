"""Opaque ids for state and nonce values: 20 base62 characters (~119
bits of entropy), with an optional prefix joined by ``_``."""

from __future__ import annotations

from ..errors import IDGeneratorFailedError
from ..utils.base62 import random_base62

DEFAULT_ID_LENGTH = 20


def new_id(prefix: str = "", length: int = DEFAULT_ID_LENGTH) -> str:
    """Generate a random base62 ID, optionally prefixed (``prefix_xxxx``)."""
    if length <= 0:
        raise IDGeneratorFailedError("length must be positive")
    try:
        ident = random_base62(length)
    except Exception as e:  # noqa: BLE001 - CSPRNG failure surface
        raise IDGeneratorFailedError(f"unable to generate id: {e}") from e
    return f"{prefix}_{ident}" if prefix else ident
