"""Key sources: where a JWKS document comes from.

The port of ``cap_tpu.keyplane.source``. A :class:`KeySource` produces
``(doc, digest)`` pairs — the parsed JWKS JSON object plus a content
digest over its canonical encoding — so the refresher can detect
"nothing changed" without diffing key material. Three concrete sources
mirror the ways the reference loads keys (jwt/keyset.go: static keys,
remote JWKS URL, OIDC discovery):

- :class:`StaticFileSource` — a JWKS JSON file on disk (the existing
  ``worker_main --keyset jwks:<path>`` input, now re-readable);
- :class:`RemoteJWKSSource` — a JWKS endpoint over
  :mod:`cap_tpu_torch.utils.http`, using conditional ETag fetches so a
  periodic refresh of an unchanged document is a header-only round
  trip;
- :class:`OIDCDiscoverySource` — issuer → discovery document →
  ``jwks_uri`` (reusing :func:`cap_tpu_torch.utils.http.fetch_discovery`,
  including its issuer-equality check), then a remote fetch.

Sources hold PUBLIC key material only (a JWKS by definition); the
digest/doc never contain tokens or claims, so nothing here interacts
with the telemetry redaction rules.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional, Tuple

from ..errors import InvalidJWKSError, InvalidParameterError
from ..utils import http as _http


def canonical_digest(doc: Dict[str, Any]) -> str:
    """Content digest over the canonical (sorted, compact) encoding —
    whitespace or key-order churn at the IdP is not a key rotation."""
    raw = json.dumps(doc, separators=(",", ":"), sort_keys=True).encode()
    return hashlib.sha256(raw).hexdigest()


def _check_jwks(doc: Any, origin: str) -> Dict[str, Any]:
    if not isinstance(doc, dict):
        raise InvalidJWKSError(f"{origin}: jwks is not a JSON object")
    keys = doc.get("keys")
    if not isinstance(keys, list):
        raise InvalidJWKSError(f"{origin}: jwks has no 'keys' array")
    return doc


class KeySource:
    """Produces JWKS snapshots for the refresher."""

    #: short human-readable origin ("file:...", "url:...", "oidc:...")
    description: str = "?"

    def fetch(self) -> Tuple[Dict[str, Any], str]:
        """One fetch → (jwks document, canonical content digest).

        Raises :class:`InvalidJWKSError` (bad payload) or transport
        errors (OSError subclasses) — the refresher counts and keeps
        serving the previous snapshot either way.
        """
        raise NotImplementedError


class StaticFileSource(KeySource):
    """JWKS JSON file on disk, re-read on every fetch (so an operator
    can rotate keys by rewriting the file, atomically via rename)."""

    def __init__(self, path: str):
        if not path:
            raise InvalidParameterError("jwks file path is required")
        self._path = path
        self.description = f"file:{path}"

    def fetch(self) -> Tuple[Dict[str, Any], str]:
        with open(self._path, "rb") as f:
            body = f.read()
        try:
            doc = json.loads(body)
        except ValueError as e:
            raise InvalidJWKSError(
                f"{self.description}: not valid JSON: {e}") from e
        doc = _check_jwks(doc, self.description)
        return doc, canonical_digest(doc)


class RemoteJWKSSource(KeySource):
    """JWKS endpoint over the pooled HTTP helpers, ETag-conditional."""

    def __init__(self, url: str, ca_pem: Optional[str] = None,
                 timeout: float = 10.0):
        if not url:
            raise InvalidParameterError("jwks url is required")
        self._url = url
        self._ctx = _http.ssl_context_for_ca(ca_pem)
        self._timeout = timeout
        self.description = f"url:{url}"

    def fetch(self) -> Tuple[Dict[str, Any], str]:
        status, body, _ = _http.get(self._url, self._ctx,
                                    timeout=self._timeout,
                                    conditional=True)
        if status != 200:
            raise InvalidJWKSError(
                f"{self.description}: fetch failed: status {status}")
        try:
            doc = json.loads(body)
        except ValueError as e:
            raise InvalidJWKSError(
                f"{self.description}: not valid JSON: {e}") from e
        doc = _check_jwks(doc, self.description)
        return doc, canonical_digest(doc)


class OIDCDiscoverySource(RemoteJWKSSource):
    """Issuer → discovery document → jwks_uri → remote JWKS.

    Discovery runs lazily on the first fetch (and again after a fetch
    against a stale ``jwks_uri`` fails), so constructing the source is
    network-free — a worker can build its keyplane before the IdP is
    reachable and converge once it is.
    """

    def __init__(self, issuer: str, ca_pem: Optional[str] = None,
                 timeout: float = 10.0):
        if not issuer:
            raise InvalidParameterError("issuer is required")
        self._issuer = issuer
        self._ca_pem = ca_pem
        self._ctx = _http.ssl_context_for_ca(ca_pem)
        self._timeout = timeout
        self._url: Optional[str] = None
        self.description = f"oidc:{issuer}"

    def _discover(self) -> str:
        doc = _http.fetch_discovery(self._issuer, self._ctx)
        jwks_uri = doc.get("jwks_uri")
        if not isinstance(jwks_uri, str) or not jwks_uri:
            raise InvalidParameterError(
                f"{self.description}: discovery document missing jwks_uri")
        return jwks_uri

    def fetch(self) -> Tuple[Dict[str, Any], str]:
        if self._url is None:
            self._url = self._discover()
        try:
            return super().fetch()
        except (InvalidJWKSError, OSError):
            # jwks_uri may itself have rotated: re-discover once.
            self._url = self._discover()
            return super().fetch()


def source_for_spec(spec: str,
                    ca_pem: Optional[str] = None) -> KeySource:
    """Parse a ``--keyset``-style source spec into a KeySource.

    ``jwks:<path>`` → file, ``jwks-url:<url>`` → remote endpoint,
    ``oidc:<issuer>`` → discovery. Raises ValueError on anything else
    (matching worker_main.make_keyset's contract).
    """
    if spec.startswith("jwks-url:"):
        return RemoteJWKSSource(spec[len("jwks-url:"):], ca_pem=ca_pem)
    if spec.startswith("jwks:"):
        return StaticFileSource(spec[len("jwks:"):])
    if spec.startswith("oidc:"):
        return OIDCDiscoverySource(spec[len("oidc:"):], ca_pem=ca_pem)
    raise ValueError(f"unknown key source spec {spec!r}")
