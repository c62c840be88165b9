"""Sentinel error taxonomy (the port's own copy of the JAX package's).

Mirrors the reference's 32 sentinel errors (oidc/error.go:7-40) as an
exception hierarchy. The reference wraps sentinels with an ``op`` prefix
(e.g. ``oidc.NewProvider: invalid issuer``); here the same convention is
an optional ``op`` argument. ``errors.Is`` becomes ``isinstance``.
"""

from __future__ import annotations


class CapError(Exception):
    """Base class for all cap_tpu_torch errors."""

    default_message = "error"

    def __init__(self, message: str | None = None, *, op: str | None = None):
        msg = message if message is not None else self.default_message
        if op:
            msg = f"{op}: {msg}"
        super().__init__(msg)
        self.op = op


class InvalidParameterError(CapError):
    default_message = "invalid parameter"


class NilParameterError(InvalidParameterError):
    # In Python a "nil parameter" is a missing/None parameter; it is a
    # subclass of InvalidParameterError for ergonomic catching.
    default_message = "missing (None) parameter"


class InvalidCACertError(CapError):
    default_message = "invalid CA certificate"


class InvalidIssuerError(CapError):
    default_message = "invalid issuer"


class ExpiredRequestError(CapError):
    default_message = "request is expired"


class InvalidResponseStateError(CapError):
    default_message = "invalid response state"


class InvalidSignatureError(CapError):
    default_message = "invalid signature"


class UnknownKeyIDError(InvalidSignatureError):
    # Subclass of InvalidSignatureError so existing catch sites are
    # unaffected; raised where a token's kid provably matches NO key in
    # the set (key-rotation misses, stale caches) — a distinct
    # rejection-reason class in telemetry,
    # because "unknown kid" pages differently than "forged signature".
    default_message = "no key matches the token kid"


class InvalidSubjectError(CapError):
    default_message = "invalid subject"


class InvalidAudienceError(CapError):
    default_message = "invalid audience"


class InvalidNonceError(CapError):
    default_message = "invalid nonce"


class InvalidNotBeforeError(CapError):
    default_message = "invalid not before"


class ExpiredTokenError(CapError):
    default_message = "token is expired"


class InvalidJWKSError(CapError):
    default_message = "invalid jwks"


class InvalidIssuedAtError(CapError):
    default_message = "invalid issued at (iat)"


class InvalidAuthorizedPartyError(CapError):
    default_message = "invalid authorized party (azp)"


class InvalidAtHashError(CapError):
    default_message = "access_token hash does not match value in id_token"


class InvalidCodeHashError(CapError):
    default_message = "authorization code hash does not match value in id_token"


class TokenNotSignedError(CapError):
    default_message = "token is not signed"


class MalformedTokenError(CapError):
    default_message = "token malformed"


class UnsupportedAlgError(CapError):
    default_message = "unsupported signing algorithm"


class IDGeneratorFailedError(CapError):
    default_message = "id generation failed"


class MissingIDTokenError(CapError):
    default_message = "id_token is missing"


class MissingAccessTokenError(CapError):
    default_message = "access_token is missing"


class IDTokenVerificationFailedError(CapError):
    default_message = "id_token verification failed"


class NotFoundError(CapError):
    default_message = "not found"


class LoginFailedError(CapError):
    default_message = "login failed"


class UserInfoFailedError(CapError):
    default_message = "user info failed"


class UnauthorizedRedirectURIError(CapError):
    default_message = "unauthorized redirect_uri"


class InvalidFlowError(CapError):
    default_message = "invalid OIDC flow"


class UnsupportedChallengeMethodError(CapError):
    default_message = "unsupported PKCE challenge method"


class ExpiredAuthTimeError(CapError):
    default_message = "expired auth_time"


class MissingClaimError(CapError):
    default_message = "missing required claim"


class ThrottledError(CapError):
    """Admission control rejected the token BEFORE verification: the
    tenant (issuer) is over its token-bucket budget. A terminal,
    non-verdict rejection — the signature was never checked, so no
    caller may treat it as "invalid", only as "retry later"."""

    default_message = "tenant over admission budget"

    def __init__(self, message: str | None = None, *,
                 retry_after_ms: int | None = None,
                 op: str | None = None):
        if message is None and retry_after_ms is not None:
            message = (f"{self.default_message} "
                       f"(retry_after_ms={int(retry_after_ms)})")
        super().__init__(message, op=op)
        self.retry_after_ms = retry_after_ms
