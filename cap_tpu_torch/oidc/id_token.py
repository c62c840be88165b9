"""IDToken: a redacting string with unverified claims access and
at_hash / c_hash verification.

``claims()`` decodes the payload without verifying it (signatures are
the Provider's job). ``verify_access_token`` and
``verify_authorization_code`` check the OIDC left-half hashes, picking
SHA-256/384/512 by the last three characters of the signing alg. An
EdDSA token cannot be checked this way and returns False without
error. An ML-DSA or SLH-DSA alg has no such suffix: the lookup raises
a bare ``KeyError`` (for example ``KeyError: '-44'``), as the JAX
package's IDToken does; the two keep the same verdicts.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict

from ..errors import (
    InvalidAtHashError,
    InvalidCodeHashError,
    InvalidParameterError,
    MalformedTokenError,
    UnsupportedAlgError,
)
from ..jwt import algs as _algs
from ..jwt.jose import b64url_decode, b64url_encode, parse_jws
from ..utils.redact import RedactedString

_HASH_BY_SUFFIX = {"256": "sha256", "384": "sha384", "512": "sha512"}


class IDToken(RedactedString):
    redact_label = "id_token"

    def claims(self) -> Dict[str, Any]:
        """Unverified claims decode. The token's signature is NOT
        checked here; use Provider.verify_id_token for verified
        claims."""
        if not self.reveal():
            raise InvalidParameterError("id_token is empty")
        parts = self.reveal().split(".")
        if len(parts) != 3:
            raise MalformedTokenError(
                f"id_token must have 3 segments, found {len(parts)}"
            )
        try:
            claims = json.loads(b64url_decode(parts[1]))
        except ValueError as e:
            raise MalformedTokenError(f"claims are not valid JSON: {e}") from e
        if not isinstance(claims, dict):
            raise MalformedTokenError("claims are not a JSON object")
        return claims

    def signing_alg(self) -> str:
        return parse_jws(self.reveal()).alg

    def _verify_hash_claim(self, claim_name: str, value: str,
                           mismatch_exc) -> bool:
        """Left-half-hash verification shared by at_hash/c_hash.

        Returns False (without error) when the token's alg cannot be
        mapped to a hash (EdDSA); raises on absent claim or mismatch.
        """
        if not value:
            raise InvalidParameterError(f"{claim_name} value is empty")
        alg = self.signing_alg()
        if alg not in _algs.SUPPORTED_ALGORITHMS:
            raise UnsupportedAlgError(f"unsupported signing algorithm {alg!r}")
        if alg == _algs.EdDSA:
            return False  # unverifiable: Ed25519 does not pin a hash alg
        hash_name = _HASH_BY_SUFFIX[alg[-3:]]
        claims = self.claims()
        claim = claims.get(claim_name)
        if not isinstance(claim, str) or not claim:
            # The claim is OPTIONAL (OIDC Core 3.1.3.6): absent means
            # "not verifiable", not a failure, so exchange still
            # succeeds.
            return False
        digest = hashlib.new(hash_name, value.encode("utf-8")).digest()
        expected = b64url_encode(digest[: len(digest) // 2])
        if claim != expected:
            raise mismatch_exc()
        return True

    def verify_access_token(self, access_token: str) -> bool:
        """Verify the at_hash claim against an access_token."""
        from .token import AccessToken

        raw = access_token.reveal() if isinstance(access_token, AccessToken) \
            else str(access_token)
        return self._verify_hash_claim("at_hash", raw, InvalidAtHashError)

    def verify_authorization_code(self, code: str) -> bool:
        """Verify the c_hash claim against an authorization code."""
        return self._verify_hash_claim("c_hash", code, InvalidCodeHashError)
