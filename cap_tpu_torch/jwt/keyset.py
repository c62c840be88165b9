"""KeySet implementations (the port's copy of the JAX package's
``jwt/keyset.py``).

``KeySet`` is the seam the GPU backend plugs into. Three CPU
implementations verify on the port's pure-integer oracle
(:func:`~cap_tpu_torch.jwt.verify.verify_parsed`), as the JAX package's
verify on OpenSSL:

- :class:`StaticKeySet` — local public keys, trial-verified in order
  (no kid routing).
- :class:`JSONWebKeySet` — remote JWKS URL with a kid-matched key cache
  and one refetch on a kid miss, rate-limited by a cooldown.
- :func:`new_oidc_discovery_keyset` — OIDC discovery → JWKS, with the
  returned-issuer equality check.

The batched implementation, ``GPUBatchKeySet``, lives in
``jwt/gpu_keyset.py`` and overrides ``verify_batch``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..errors import (
    InvalidJWKSError,
    InvalidParameterError,
    InvalidSignatureError,
    NilParameterError,
    UnknownKeyIDError,
)
from ..utils import http as _http
from .jose import ParsedJWS, parse_jws
from .jwk import JWK, parse_jwks
from .verify import key_matches_alg, verify_parsed


class KeySet:
    """Verifies JWT signatures; returns the verified (still unvalidated) claims.

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


class StaticKeySet(KeySet):
    """KeySet backed by a local list of public keys.

    Matches the reference's trial-verification semantics: every key is
    tried in order until one verifies (O(keys) signature checks worst
    case, no kid routing).
    """

    def __init__(self, public_keys: Sequence[object]):
        if not public_keys:
            raise NilParameterError("public keys are required")
        self._keys = list(public_keys)

    def verify_signature(self, token: str) -> Dict[str, Any]:
        parsed = parse_jws(token)
        last_err: Optional[Exception] = None
        for key in self._keys:
            try:
                verify_parsed(parsed, key)
                return parsed.claims()
            except InvalidSignatureError as e:
                last_err = e
        raise InvalidSignatureError(
            "no known key successfully validated the token signature"
        ) from last_err


class JSONWebKeySet(KeySet):
    """KeySet backed by a remote JWKS endpoint.

    Keys are cached; a verification that finds no usable cached key for
    the token's kid triggers one refetch (key-rotation handling), the
    same observable behavior as the coreos RemoteKeySet the reference
    wraps. Thread-safe.

    ``refresh_cooldown_s``: minimum interval between MISS-triggered
    refetches. Repeated unknown-kid lookups inside the window raise
    without touching the network — attacker tokens carrying random
    kids must not amplify 1:1 into IdP fetches (DoS guard). The
    initial cache fill and explicit ``keys(refresh=True)`` calls are
    not throttled.
    """

    def __init__(self, jwks_url: str, jwks_ca_pem: Optional[str] = None,
                 refresh_cooldown_s: float = 10.0):
        if not jwks_url:
            raise NilParameterError("jwks_url is required")
        self._url = jwks_url
        self._ssl_ctx = _http.ssl_context_for_ca(jwks_ca_pem)
        self._lock = threading.Lock()
        self._keys: Optional[List[JWK]] = None
        self._refresh_cooldown = refresh_cooldown_s
        self._last_miss_refresh = float("-inf")

    # -- key cache ---------------------------------------------------------

    def _fetch(self) -> List[JWK]:
        status, body, _ = _http.get(self._url, self._ssl_ctx)
        if status != 200:
            raise InvalidJWKSError(f"jwks fetch failed: status {status}")
        try:
            doc = json.loads(body)
        except ValueError as e:
            raise InvalidJWKSError(f"jwks is not valid JSON: {e}") from e
        if not isinstance(doc, dict):
            raise InvalidJWKSError("jwks is not a JSON object")
        keys = parse_jwks(doc)
        with self._lock:
            self._keys = keys
        return keys

    def keys(self, refresh: bool = False) -> List[JWK]:
        with self._lock:
            cached = self._keys
        if cached is None or refresh:
            return self._fetch()
        return cached

    # -- verification ------------------------------------------------------

    @staticmethod
    def _candidates(keys: List[JWK], parsed: ParsedJWS) -> List[JWK]:
        out = []
        for jwk in keys:
            if jwk.use not in (None, "", "sig"):
                continue
            if parsed.kid is not None and jwk.kid is not None and jwk.kid != parsed.kid:
                continue
            if not key_matches_alg(jwk.key, parsed.alg):
                continue
            out.append(jwk)
        return out

    def verify_signature(self, token: str) -> Dict[str, Any]:
        parsed = parse_jws(token)
        keys = self.keys()
        candidates = self._candidates(keys, parsed)
        last_err: Optional[Exception] = None
        for jwk in candidates:
            try:
                verify_parsed(parsed, jwk.key)
                return parsed.claims()
            except InvalidSignatureError as e:
                last_err = e
        if not candidates:
            # kid cache miss only → one refetch (key rotation). A failed
            # verification against cached candidates must NOT hit the
            # network — forged tokens would amplify into IdP fetches.
            now = time.monotonic()
            with self._lock:
                cooled = (now - self._last_miss_refresh
                          < self._refresh_cooldown)
                if not cooled:
                    # Stamp BEFORE the fetch: a slow or failing IdP
                    # must also respect the cooldown, or every
                    # unknown-kid token blocks on a doomed fetch.
                    self._last_miss_refresh = now
            if cooled:
                if parsed.kid is not None:
                    raise UnknownKeyIDError(
                        "no key matches kid (refresh cooldown active)"
                    ) from last_err
                raise InvalidSignatureError(
                    "failed to verify id token signature") from last_err
            keys = self.keys(refresh=True)
            refreshed = self._candidates(keys, parsed)
            for jwk in refreshed:
                try:
                    verify_parsed(parsed, jwk.key)
                    return parsed.claims()
                except InvalidSignatureError as e:
                    last_err = e
            if not refreshed and parsed.kid is not None:
                # Even the freshly fetched set has no key for this kid:
                # provably unknown (a rotation gap, not a forgery).
                raise UnknownKeyIDError(
                    "no key matches kid after refresh"
                ) from last_err
        raise InvalidSignatureError(
            "failed to verify id token signature"
        ) from last_err


def new_oidc_discovery_keyset(issuer: str,
                              issuer_ca_pem: Optional[str] = None) -> JSONWebKeySet:
    """Build a JWKS keyset from an issuer's OIDC discovery document.

    Fetches ``{issuer}/.well-known/openid-configuration``, requires the
    document's ``issuer`` to equal the requested issuer, and returns a
    :class:`JSONWebKeySet` on the advertised ``jwks_uri``.

    Discovery failures (bad status, non-JSON document, issuer mismatch)
    raise :class:`InvalidIssuerError` — the same taxonomy the oidc
    Provider uses for its discovery step.
    """
    if not issuer:
        raise NilParameterError("issuer is required")
    ctx = _http.ssl_context_for_ca(issuer_ca_pem)
    doc = _http.fetch_discovery(issuer, ctx)
    jwks_uri = doc.get("jwks_uri")
    if not isinstance(jwks_uri, str) or not jwks_uri:
        raise InvalidParameterError("discovery document missing jwks_uri")
    return JSONWebKeySet(jwks_uri, jwks_ca_pem=issuer_ca_pem)
