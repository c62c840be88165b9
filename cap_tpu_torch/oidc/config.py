"""Relying-party configuration.

``Config`` holds the required client_id and issuer (http or https), the
supported signing algs (checked against the registry), and the optional
allowed redirect URLs, scopes ("openid" is added where they are used),
audiences, provider CA and clock. ``ClientSecret`` redacts itself
everywhere.
"""

from __future__ import annotations

import base64
import time as _time
from typing import Callable, Optional, Sequence
from urllib.parse import urlparse

from ..errors import (
    InvalidCACertError,
    InvalidIssuerError,
    InvalidParameterError,
)
from ..jwt import algs as _algs
from ..utils.redact import RedactedString

SCOPE_OPENID = "openid"


class ClientSecret(RedactedString):
    redact_label = "ClientSecret"


class Config:
    """Provider (relying party) configuration."""

    def __init__(
        self,
        issuer: str,
        client_id: str,
        client_secret: str | ClientSecret = "",
        supported_signing_algs: Sequence[str] = (),
        allowed_redirect_urls: Sequence[str] = (),
        *,
        scopes: Optional[Sequence[str]] = None,
        audiences: Optional[Sequence[str]] = None,
        provider_ca: Optional[str] = None,
        now_func: Optional[Callable[[], float]] = None,
    ):
        self.issuer = issuer
        self.client_id = client_id
        self.client_secret = (
            client_secret if isinstance(client_secret, ClientSecret)
            else ClientSecret(client_secret)
        )
        self.supported_signing_algs = list(supported_signing_algs)
        self.allowed_redirect_urls = list(allowed_redirect_urls)
        self.scopes = list(scopes) if scopes else []
        self.audiences = list(audiences) if audiences else []
        self.provider_ca = provider_ca or ""
        self.now_func = now_func
        self.validate()

    def now(self) -> float:
        """Current Unix time, honoring now_func."""
        return self.now_func() if self.now_func is not None else _time.time()

    def validate(self) -> None:
        if not self.client_id:
            raise InvalidParameterError("client ID is empty")
        if not self.issuer:
            raise InvalidParameterError("discovery URL is empty")
        for u in self.allowed_redirect_urls:
            try:
                urlparse(u)
            except ValueError as e:
                raise InvalidParameterError(
                    f"invalid AllowedRedirectURLs provided {u}: {e}"
                ) from e
        try:
            parsed = urlparse(self.issuer)
        except ValueError as e:
            raise InvalidIssuerError(f"issuer {self.issuer} is invalid: {e}") from e
        if parsed.scheme not in ("http", "https"):
            raise InvalidIssuerError(
                f"issuer {self.issuer} schema is not http or https"
            )
        if not self.supported_signing_algs:
            raise InvalidParameterError("supported algorithms is empty")
        for a in self.supported_signing_algs:
            if a not in _algs.SUPPORTED_ALGORITHMS:
                raise InvalidParameterError(f"unsupported algorithm {a}")
        if self.provider_ca:
            from ..utils.http import ssl_context_for_ca

            try:
                ssl_context_for_ca(self.provider_ca)
            except InvalidCACertError:
                raise
            except Exception as e:  # noqa: BLE001
                raise InvalidCACertError(str(e)) from e


def encode_certificates(*certs) -> str:
    """PEM-encode X.509 certificates, concatenated.

    Each certificate is its DER bytes or a certificate object of
    :mod:`cap_tpu_torch.jwt.x509` (anything with a ``der`` attribute);
    the text is the ``CERTIFICATE`` block that ``cryptography``'s
    ``public_bytes(Encoding.PEM)`` writes for the same certificate
    (base64 in lines of 64, each line ending in a newline).
    """
    if not certs or any(c is None for c in certs):
        raise InvalidParameterError("no certificates provided")
    out = []
    for c in certs:
        der = bytes(c) if isinstance(c, (bytes, bytearray)) else c.der
        b64 = base64.b64encode(der).decode("ascii")
        out.append("-----BEGIN CERTIFICATE-----\n"
                   + "".join(b64[i:i + 64] + "\n"
                             for i in range(0, len(b64), 64))
                   + "-----END CERTIFICATE-----\n")
    return "".join(out)
