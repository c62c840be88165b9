"""String-list helpers (the port's copy of the JAX package's
``utils/strutils.py``)."""

from __future__ import annotations

from typing import Iterable, List


def str_list_contains(haystack: Iterable[str], needle: str) -> bool:
    return needle in haystack


def remove_duplicates_stable(items: Iterable[str], case_sensitive: bool) -> List[str]:
    """De-duplicate, trim whitespace, and drop empties, preserving order."""
    seen = set()
    out: List[str] = []
    for item in items:
        key = item.strip()
        if not case_sensitive:
            key = key.lower()
        if not key or key in seen:
            continue
        seen.add(key)
        out.append(item.strip())
    return out
