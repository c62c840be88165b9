"""JWK (RFC 7517/7518) parse and serialize, as pure-integer keys.

The port needs no OpenSSL: RSA keys (kty=RSA: n, e) become
:class:`RSAPublicKey` after the reference's checks on n and e, EC keys
(kty=EC: crv, x, y on P-256/P-384/P-521) become
:class:`HostECPublicKey` after an explicit on-curve check, Ed25519 keys
(kty=OKP, crv=Ed25519) become :class:`HostEd25519PublicKey`, ML-DSA
keys (kty=AKP with an ``ML-DSA-*`` alg) become :class:`MLDSAPublicKey`
and SLH-DSA keys (kty=AKP with an ``SLH-DSA-SHAKE-128s``/``-128f``
alg) :class:`SLHDSAPublicKey`, with the JAX parser's checks and
messages.

``x5c`` certificate chains (RFC 7517 §4.7) are read as the JAX parser
reads them, branch for branch, over the port's own DER reader
(:mod:`.x509`): every entry must decode and parse as a certificate,
the leaf's key is the only key used, a JWK without parameters takes
that key, and a JWK with both must have them agree. An AKP key ignores
``x5c``. Where the JAX parser lets ``cryptography``'s own exceptions
escape unwrapped, the port raises ``InvalidJWKSError``; where it lets
a builtin ``ValueError`` from the leaf's key escape, so does the port
(ROADMAP §C).
"""

from __future__ import annotations

import base64
import binascii
from typing import Any, Dict, List, Optional

from ..errors import InvalidJWKSError
from ..gpu.ec import _CURVE_INTS, HostECPublicKey
from ..gpu.ed25519 import HostEd25519PublicKey
from ..gpu.mldsa import MLDSA_ALGS, MLDSAPublicKey
from ..gpu.slhdsa import SLHDSA_ALGS, SLHDSAPublicKey
from .jose import b64url_decode, b64url_encode

_COORD_BYTES = {"P-256": 32, "P-384": 48, "P-521": 66}

# SEC 2 curve b constants for the on-curve check (a = -3 on every NIST
# curve).
_CURVE_B = {
    "P-256": 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,  # noqa: E501
    "P-384": 0xB3312FA7E23EE7E4988E056BE3F82D19181D9C6EFE8141120314088F5013875AC656398D8A2ED19D2A85C8EDD3EC2AEF,  # noqa: E501
    "P-521": 0x0051953EB9618E1C9A1F929A21A0B68540EEA2DA725B99B315F3B8B489918EF109E156193951EC7E937B1652C0BD3BB1BF073573DF883D2C34F1EF451FD46B503F00,  # noqa: E501
}


class RSAPublicKey:
    """Dependency-free RSA public key: the integers (n, e)."""

    def __init__(self, n: int, e: int):
        self.n, self.e = n, e


class JWK:
    """One JSON Web Key: the parsed public key plus JOSE metadata."""

    def __init__(self, key, kid: Optional[str] = None,
                 alg: Optional[str] = None, use: Optional[str] = None):
        self.key = key
        self.kid = kid
        self.alg = alg
        self.use = use

    def __repr__(self) -> str:
        return (f"JWK(kid={self.kid!r}, alg={self.alg!r}, "
                f"type={type(self.key).__name__})")


def _b64_uint(data: Dict[str, Any], field: str) -> int:
    v = data.get(field)
    if not isinstance(v, str):
        raise InvalidJWKSError(f"jwk missing field {field!r}")
    return int.from_bytes(b64url_decode(v), "big")


def _parse_ec_host(data: Dict[str, Any], crv: str) -> HostECPublicKey:
    """Pure-integer EC key with an explicit on-curve check."""
    x = _b64_uint(data, "x")
    y = _b64_uint(data, "y")
    p = _CURVE_INTS[crv]["p"]
    if not (0 <= x < p and 0 <= y < p) or \
            (y * y - (x * x * x - 3 * x + _CURVE_B[crv])) % p != 0:
        raise InvalidJWKSError(
            f"invalid EC jwk: point is not on curve {crv}")
    return HostECPublicKey(crv, x, y)


def _parse_rsa(data: Dict[str, Any]) -> RSAPublicKey:
    """RSA key from n and e, with the checks of ``cryptography``'s
    ``RSAPublicNumbers.public_key()`` in its order and words."""
    n = _b64_uint(data, "n")
    e = _b64_uint(data, "e")
    if n < 3:
        msg = "n must be >= 3."
    elif e < 3 or e >= n:
        msg = "e must be >= 3 and < n."
    elif e & 1 == 0:
        msg = "e must be odd."
    else:
        return RSAPublicKey(n, e)
    raise InvalidJWKSError(f"invalid RSA jwk: {msg}")


def _parse_okp(data: Dict[str, Any]) -> HostEd25519PublicKey:
    """Ed25519 key from its raw 32 bytes. Bytes that do not decode to a
    curve point are accepted, as OpenSSL's raw import accepts them; the
    key's tokens then never verify."""
    raw = data.get("x")
    if not isinstance(raw, str):
        raise InvalidJWKSError("jwk missing field 'x'")
    try:
        return HostEd25519PublicKey(b64url_decode(raw))
    except ValueError as err:
        raise InvalidJWKSError(f"invalid Ed25519 jwk: {err}") from err


def _parse_akp(data: Dict[str, Any]):
    """kty=AKP (ML-DSA / SLH-DSA): the parameter set rides the required
    alg member and the public key is the FIPS 204/205 pk encoding in
    ``pub`` (draft-ietf-cose-dilithium / draft-ietf-cose-sphincs-plus
    JOSE serialization)."""
    alg = data.get("alg")
    if alg in MLDSA_ALGS:
        key_cls = MLDSAPublicKey
    elif alg in SLHDSA_ALGS:
        key_cls = SLHDSAPublicKey
    else:
        raise InvalidJWKSError(
            f"AKP jwk requires alg in "
            f"{sorted(MLDSA_ALGS) + sorted(SLHDSA_ALGS)}, got {alg!r}")
    raw = data.get("pub")
    if not isinstance(raw, str):
        raise InvalidJWKSError("AKP jwk missing field 'pub'")
    try:
        return key_cls(alg, b64url_decode(raw))
    except ValueError as err:
        raise InvalidJWKSError(f"invalid AKP jwk: {err}") from err


def _meta(data: Dict[str, Any], field: str) -> Optional[str]:
    v = data.get(field)
    return v if isinstance(v, str) else None


def _x5c_public_key(data: Dict[str, Any]):
    """The leaf certificate's key, or None when the JWK has no x5c.

    Each entry is standard base64 (not base64url) of a DER certificate,
    and every entry must parse, though only the first one's key is
    used: a present but invalid chain is an error, never truncated.
    """
    from . import x509

    x5c = data.get("x5c")
    if x5c is None:
        return None
    if not isinstance(x5c, list) or not x5c or not all(
            isinstance(c, str) for c in x5c):
        raise InvalidJWKSError("jwk x5c must be a non-empty string array")
    certs = []
    for i, entry in enumerate(x5c):
        try:
            der = base64.b64decode(entry, validate=True)
            certs.append(x509.load_der_x509_certificate(der))
        except (binascii.Error, ValueError, x509.InvalidVersion) as err:
            raise InvalidJWKSError(
                f"invalid x5c certificate at index {i}: {err}") from err
    try:
        # a builtin ValueError escapes, as in the JAX parser
        key = certs[0].public_key()
    except x509.UnsupportedAlgorithm as err:
        raise InvalidJWKSError(
            f"x5c certificate carries an unsupported key type: {err}") from err
    if _kind(key) is None:
        raise InvalidJWKSError(
            "x5c certificate carries an unsupported key type")
    return key


def _kind(key) -> Optional[str]:
    """The JWK kty a key belongs to, or None for one no kty holds."""
    from .x509 import OtherPublicKey

    if isinstance(key, RSAPublicKey):
        return "RSA"
    if isinstance(key, HostECPublicKey) or (
            isinstance(key, OtherPublicKey) and key.kind == "EC"):
        return "EC"
    if isinstance(key, HostEd25519PublicKey):
        return "OKP"
    return None


def _keys_equal(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, RSAPublicKey):
        return (a.n, a.e) == (b.n, b.e)
    if isinstance(a, HostEd25519PublicKey):
        return a.raw == b.raw
    na, nb = a.public_numbers(), b.public_numbers()
    return (a.curve_name, na.x, na.y) == (b.curve_name, nb.x, nb.y)


def parse_jwk(data: Dict[str, Any]) -> JWK:
    """Parse one JWK dict into a JWK with a pure-integer public key."""
    kty = data.get("kty")
    if kty == "AKP":
        return JWK(_parse_akp(data), kid=_meta(data, "kid"),
                   alg=_meta(data, "alg"), use=_meta(data, "use"))
    cert_key = _x5c_public_key(data)
    key = None
    # parameters are gated on presence, not type: malformed ones reject,
    # never defer to the chain
    if kty == "RSA":
        if "n" in data or "e" in data or cert_key is None:
            key = _parse_rsa(data)
    elif kty == "EC":
        crv = data.get("crv")
        if "x" in data or "y" in data or cert_key is None:
            if crv not in _COORD_BYTES:
                raise InvalidJWKSError(f"unsupported EC curve {crv!r}")
            key = _parse_ec_host(data, crv)
        elif crv is not None and crv not in _COORD_BYTES:
            raise InvalidJWKSError(f"unsupported EC curve {crv!r}")
    elif kty == "OKP":
        if data.get("crv") != "Ed25519":
            raise InvalidJWKSError(
                f"unsupported OKP curve {data.get('crv')!r}")
        if "x" in data or cert_key is None:
            key = _parse_okp(data)
    else:
        raise InvalidJWKSError(f"unsupported jwk kty {kty!r}")

    if cert_key is not None:
        if _kind(cert_key) != kty:
            raise InvalidJWKSError(
                "x5c certificate key type does not match jwk kty")
        if kty == "EC":
            if cert_key.curve_name not in _COORD_BYTES:
                raise InvalidJWKSError(
                    f"unsupported EC curve {cert_key.curve_name!r} in x5c")
            declared = data.get("crv")
            if declared is not None and declared != cert_key.curve_name:
                raise InvalidJWKSError(
                    "jwk crv does not match x5c certificate curve")
        if key is None:
            key = cert_key          # material arrived only via x5c
        elif not _keys_equal(key, cert_key):
            raise InvalidJWKSError(
                "jwk parameters do not match x5c certificate key")
    return JWK(key, kid=_meta(data, "kid"), alg=_meta(data, "alg"),
               use=_meta(data, "use"))


def parse_jwks(document: Dict[str, Any]) -> List[JWK]:
    """Parse a JWKS document ``{"keys": [...]}``."""
    keys = document.get("keys")
    if not isinstance(keys, list):
        raise InvalidJWKSError("jwks document missing 'keys' array")
    out: List[JWK] = []
    for entry in keys:
        if not isinstance(entry, dict):
            raise InvalidJWKSError("jwks entry is not an object")
        out.append(parse_jwk(entry))
    return out


def _uint_b64(v: int, length: Optional[int] = None) -> str:
    n = length if length is not None else max(1, (v.bit_length() + 7) // 8)
    return b64url_encode(v.to_bytes(n, "big"))


def serialize_public_key(key, kid: Optional[str] = None,
                         alg: Optional[str] = None) -> Dict[str, Any]:
    """Serialize a pure-integer public key into a JWK dict."""
    out: Dict[str, Any] = {"use": "sig"}
    if kid:
        out["kid"] = kid
    if alg:
        out["alg"] = alg
    if isinstance(key, RSAPublicKey):
        out.update({"kty": "RSA", "n": _uint_b64(key.n),
                    "e": _uint_b64(key.e)})
    elif isinstance(key, HostECPublicKey):
        nums = key.public_numbers()
        size = _COORD_BYTES[key.curve_name]
        out.update({"kty": "EC", "crv": key.curve_name,
                    "x": _uint_b64(nums.x, size),
                    "y": _uint_b64(nums.y, size)})
    elif isinstance(key, HostEd25519PublicKey):
        out.update({"kty": "OKP", "crv": "Ed25519",
                    "x": b64url_encode(key.raw)})
    elif isinstance(key, (MLDSAPublicKey, SLHDSAPublicKey)):
        out.update({"kty": "AKP", "alg": key.parameter_set,
                    "pub": b64url_encode(key.pk)})
    else:
        raise InvalidJWKSError(
            f"cannot serialize key type {type(key).__name__}")
    return out
