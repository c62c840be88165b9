"""JWT claims validation engine (the port's copy of the JAX package's
``jwt/validator.py``).

Parity with the reference's ``Validator.Validate`` (jwt/jwt.go:95-202):
signature verification through the KeySet seam, then alg-header
validation, then registered-claims validation with the same defaulting
and leeway rules:

- at least one of iat/exp/nbf must be present;
- missing exp defaults to max(iat, nbf) + expiration leeway;
- missing nbf defaults to iat, else exp − not-before leeway;
- leeways: 0/None → default (150s; clock-skew 60s), negative → none;
- expected alg list defaults to [RS256].
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..errors import (
    CapError,
    ExpiredTokenError,
    InvalidAudienceError,
    InvalidIssuedAtError,
    InvalidIssuerError,
    InvalidNotBeforeError,
    InvalidParameterError,
    InvalidSignatureError,
    MalformedTokenError,
    MissingClaimError,
    NilParameterError,
    UnsupportedAlgError,
)
from . import algs
from .jose import peek_alg
from .keyset import KeySet

# Leeway used by default for "nbf" and "exp" (reference: jwt/jwt.go:16).
DEFAULT_LEEWAY_SECONDS = 150
# Default clock-skew leeway (go-jose jwt.DefaultLeeway = 1 minute).
DEFAULT_CLOCK_SKEW_SECONDS = 60


@dataclass
class Expected:
    """Expected claim values to assert when validating a JWT.

    Leeway fields are seconds: None or 0 → default, negative → no leeway
    (same encoding as the reference's time.Duration fields,
    jwt/jwt.go:60-83).
    """

    issuer: str = ""
    subject: str = ""
    id: str = ""
    audiences: List[str] = field(default_factory=list)
    signing_algorithms: List[str] = field(default_factory=list)
    not_before_leeway: Optional[float] = None
    expiration_leeway: Optional[float] = None
    clock_skew_leeway: Optional[float] = None
    now: Optional[Callable[[], float]] = None  # returns Unix seconds


def _effective_leeway(value: Optional[float], default: float) -> float:
    if value is None or value == 0:
        return default
    if value < 0:
        return 0.0
    return value


def _numeric_claim(claims: Dict[str, Any], name: str) -> Optional[float]:
    v = claims.get(name)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise MalformedTokenError(f"claim {name!r} is not a number")
    return float(v)


def _string_claim(claims: Dict[str, Any], name: str) -> str:
    v = claims.get(name)
    if v is None:
        return ""
    if not isinstance(v, str):
        raise MalformedTokenError(f"claim {name!r} is not a string")
    return v


def audience_claim(claims: Dict[str, Any]) -> List[str]:
    """Normalize the aud claim to a list of strings (RFC 7519 §4.1.3)."""
    v = claims.get("aud")
    if v is None:
        return []
    if isinstance(v, str):
        return [v]
    if isinstance(v, list) and all(isinstance(x, str) for x in v):
        return list(v)
    raise MalformedTokenError("claim 'aud' is not a string or string array")


def validate_audience(expected_audiences: Sequence[str],
                      aud_claim: Sequence[str]) -> None:
    """Error unless aud_claim intersects expected (empty expected → skip)."""
    if not expected_audiences:
        return
    if any(a in aud_claim for a in expected_audiences):
        return
    raise InvalidAudienceError(
        "audience claim does not match any expected audience"
    )


def validate_signing_algorithm(token: str,
                               expected_algorithms: Sequence[str]) -> None:
    """Check the JWS alg header against the expected list (default RS256).

    Decodes only the header and signature segments — the payload (the
    bulk of the token) was already decoded by the KeySet verify step, so
    re-decoding it here would double the hot-path parse work.
    """
    algs.supported_signing_algorithm(*expected_algorithms)
    alg = peek_alg(token)  # raises on malformed/unsigned
    expected = list(expected_algorithms) or [algs.RS256]
    if alg not in expected:
        raise UnsupportedAlgError("token signed with unexpected algorithm")


def validate_claims(all_claims: Dict[str, Any], expected: Expected) -> None:
    """Registered-claims validation (time windows, iss/sub/jti/aud)."""
    iat = _numeric_claim(all_claims, "iat") or 0.0
    exp = _numeric_claim(all_claims, "exp") or 0.0
    nbf = _numeric_claim(all_claims, "nbf") or 0.0

    if iat == 0 and exp == 0 and nbf == 0:
        raise MissingClaimError(
            "no issued at (iat), not before (nbf), or expiration time (exp) "
            "claims in token"
        )

    if exp == 0:
        latest_start = max(iat, nbf)
        exp = latest_start + _effective_leeway(
            expected.expiration_leeway, DEFAULT_LEEWAY_SECONDS
        )
    if nbf == 0:
        if iat != 0:
            nbf = iat
        else:
            nbf = exp - _effective_leeway(
                expected.not_before_leeway, DEFAULT_LEEWAY_SECONDS
            )

    cks = _effective_leeway(expected.clock_skew_leeway, DEFAULT_CLOCK_SKEW_SECONDS)

    if expected.issuer and expected.issuer != _string_claim(all_claims, "iss"):
        raise InvalidIssuerError("invalid issuer (iss) claim")
    if expected.subject and expected.subject != _string_claim(all_claims, "sub"):
        raise InvalidParameterError("invalid subject (sub) claim")
    if expected.id and expected.id != _string_claim(all_claims, "jti"):
        raise InvalidParameterError("invalid ID (jti) claim")
    validate_audience(expected.audiences, audience_claim(all_claims))

    now = expected.now() if expected.now is not None else _time.time()
    if now + cks < nbf:
        raise InvalidNotBeforeError(
            "invalid not before (nbf) claim: token not yet valid"
        )
    if now - cks > exp:
        raise ExpiredTokenError(
            "invalid expiration time (exp) claim: token is expired"
        )
    if now + cks < iat:
        raise InvalidIssuedAtError(
            "invalid issued at (iat) claim: token issued in the future"
        )


class Validator:
    """Validates JWTs: signature via the KeySet, then claims vs Expected."""

    def __init__(self, keyset: KeySet):
        if keyset is None:
            raise NilParameterError("keySet must not be None")
        self.keyset = keyset

    def validate(self, token: str, expected: Expected | None = None) -> Dict[str, Any]:
        """Verify-then-validate one JWT; returns all claims on success."""
        expected = expected or Expected()
        try:
            all_claims = self.keyset.verify_signature(token)
        except CapError:
            # Preserve the taxonomy (MalformedTokenError, UnsupportedAlgError,
            # InvalidSignatureError, ...) so isinstance-based handling — the
            # analog of the reference's errors.Is over %w wraps — works.
            raise
        except Exception as e:
            raise InvalidSignatureError(
                f"error verifying token signature: {e}"
            ) from e
        validate_signing_algorithm(token, expected.signing_algorithms)
        validate_claims(all_claims, expected)
        return all_claims

    def validate_batch(self, tokens: Sequence[str],
                       expected: Expected | None = None) -> List[Any]:
        """Batched verify-then-validate.

        Signature verification goes through the KeySet's batch path (the
        GPU engine when the keyset is a GPUBatchKeySet); claims are then
        validated per token. Returns one entry per token: the claims dict
        or the exception that token failed with.
        """
        expected = expected or Expected()
        results = self.keyset.verify_batch(tokens)
        out: List[Any] = []
        for token, res in zip(tokens, results):
            if isinstance(res, CapError):
                out.append(res)
                continue
            if isinstance(res, Exception):
                out.append(InvalidSignatureError(
                    f"error verifying token signature: {res}"
                ))
                continue
            try:
                validate_signing_algorithm(token, expected.signing_algorithms)
                validate_claims(res, expected)
                out.append(res)
            except Exception as e:  # noqa: BLE001 - per-token error channel
                out.append(e)
        return out
