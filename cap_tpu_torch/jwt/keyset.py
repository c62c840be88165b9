"""The ``KeySet`` seam: verify one token, or a batch of them."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence


class KeySet:
    """Verifies JWT signatures; returns the verified (still unvalidated)
    claims.

    Subclasses implement :meth:`verify_signature`. Implementations that
    can batch (the GPU backend) additionally implement
    :meth:`verify_batch`; the default loops over tokens.
    """

    def verify_signature(self, token: str) -> Dict[str, Any]:
        raise NotImplementedError

    def verify_batch(self, tokens: Sequence[str]) -> List[Any]:
        """Verify many tokens; returns one entry per token: either the
        claims dict or the exception that token failed with. Never raises
        for per-token failures."""
        out: List[Any] = []
        for t in tokens:
            try:
                out.append(self.verify_signature(t))
            except Exception as e:  # noqa: BLE001 - per-token error channel
                out.append(e)
        return out
