"""PEM public-key parsing (parity with the JAX package's ``jwt/pem.py``).

Accepts a PKIX ``PUBLIC KEY`` block, a PKCS#1 ``RSA PUBLIC KEY`` block
or an x509 ``CERTIFICATE`` block, with any text around it, and returns
the contained RSA / ECDSA / Ed25519 public key, read by the port's own
DER reader (:mod:`.x509`). Where the JAX package lets an exception of
``cryptography``'s own escape, the port raises
``InvalidParameterError``; a builtin ``ValueError`` from a
certificate's key escapes in both (ROADMAP §C).
"""

from __future__ import annotations

from ..errors import InvalidParameterError
from . import x509

_UNSUPPORTED = "unsupported public key type (want RSA, ECDSA, or Ed25519)"


def parse_public_key_pem(pem: str | bytes):
    """Parse a PEM-encoded public key or certificate into a public key."""
    if isinstance(pem, str):
        pem = pem.encode("utf-8")
    try:
        if b"CERTIFICATE" in pem:
            try:
                cert = x509.load_pem_x509_certificate(pem)
            except (ValueError, x509.InvalidVersion) as e:
                raise InvalidParameterError(
                    f"failed to parse certificate: {e}") from e
            key = cert.public_key()
        else:
            try:
                key = x509.load_pem_public_key(pem)
            except (ValueError, TypeError) as e:
                raise InvalidParameterError(
                    f"failed to parse public key PEM: {e}") from e
    except x509.UnsupportedAlgorithm as e:
        raise InvalidParameterError(f"{_UNSUPPORTED}: {e}") from e
    if isinstance(key, x509.OtherPublicKey) and key.kind != "EC":
        raise InvalidParameterError(_UNSUPPORTED)
    return key
