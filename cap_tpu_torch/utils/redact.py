"""Redact-by-default secret string types (the port's copy of the JAX
package's ``utils/redact.py``).

ClientSecret, IDToken, AccessToken and RefreshToken render as
``[REDACTED: …]`` from ``repr``, ``str``, ``format`` and ``to_json``;
the raw value is reachable only through ``.reveal()``. Equality,
hashing, truthiness and concatenation operate on the real value.
"""

from __future__ import annotations


class RedactedString(str):
    """A string that redacts itself in every rendering channel."""

    redact_label = "secret"

    def reveal(self) -> str:
        """The actual secret value (a deliberate unwrap)."""
        return str.__str__(self)

    def _redacted(self) -> str:
        return f"[REDACTED: {self.redact_label}]"

    def __repr__(self) -> str:  # noqa: D105
        return self._redacted()

    def __str__(self) -> str:  # noqa: D105
        return self._redacted()

    def __format__(self, spec: str) -> str:  # noqa: D105
        return self._redacted().__format__(spec)

    # json.dumps(default=...) cannot intercept str subclasses: our own
    # serializers call this, and stdlib json callers reveal() on purpose.
    def to_json(self) -> str:
        return self._redacted()

    def __eq__(self, other) -> bool:  # noqa: D105
        if isinstance(other, RedactedString):
            return self.reveal() == other.reveal()
        if isinstance(other, str):
            return self.reveal() == other
        return NotImplemented

    def __hash__(self) -> int:  # noqa: D105
        return str.__hash__(self)

    def __bool__(self) -> bool:  # noqa: D105
        return len(self.reveal()) > 0
