"""PKCE (RFC 7636) code verifier and challenge.

A 43-character base62 verifier and its S256 challenge (SHA-256, then
unpadded base64url). Only the S256 method exists; "plain" is absent on
purpose.
"""

from __future__ import annotations

import hashlib

from ..errors import InvalidParameterError, UnsupportedChallengeMethodError
from ..jwt.jose import b64url_encode
from ..utils.base62 import random_base62

MIN_VERIFIER_LEN = 43
MAX_VERIFIER_LEN = 128


class CodeVerifier:
    """Interface: a PKCE code verifier with its challenge."""

    def verifier(self) -> str:
        raise NotImplementedError

    def challenge(self) -> str:
        raise NotImplementedError

    def method(self) -> str:
        raise NotImplementedError

    def copy(self) -> "CodeVerifier":
        raise NotImplementedError


class S256Verifier(CodeVerifier):
    """SHA-256 PKCE verifier."""

    def __init__(self, verifier: str | None = None):
        v = verifier if verifier is not None else random_base62(MIN_VERIFIER_LEN)
        if not (MIN_VERIFIER_LEN <= len(v) <= MAX_VERIFIER_LEN):
            raise InvalidParameterError(
                f"verifier length must be in [{MIN_VERIFIER_LEN}, "
                f"{MAX_VERIFIER_LEN}], got {len(v)}"
            )
        self._verifier = v
        self._challenge = create_code_challenge(self)

    def verifier(self) -> str:
        return self._verifier

    def challenge(self) -> str:
        return self._challenge

    def method(self) -> str:
        return "S256"

    def copy(self) -> "S256Verifier":
        return S256Verifier(self._verifier)

    def __repr__(self) -> str:
        return "S256Verifier([REDACTED: verifier])"


def create_code_challenge(verifier: CodeVerifier) -> str:
    """Compute the challenge for a verifier (S256 only)."""
    if isinstance(verifier, S256Verifier) or verifier.method() == "S256":
        raw = (verifier._verifier if isinstance(verifier, S256Verifier)
               else verifier.verifier())
        return b64url_encode(hashlib.sha256(raw.encode("ascii")).digest())
    raise UnsupportedChallengeMethodError(
        f"unsupported challenge method {verifier.method()!r}"
    )
