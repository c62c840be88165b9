"""JWK (RFC 7517/7518) parse and serialize, as pure-integer keys.

The port needs no OpenSSL: RSA keys (kty=RSA: n, e) become
:class:`RSAPublicKey`, EC keys (kty=EC: crv, x, y on P-256/P-384/
P-521) become :class:`HostECPublicKey` after an explicit on-curve
check, Ed25519 keys (kty=OKP, crv=Ed25519) become
:class:`HostEd25519PublicKey`, ML-DSA keys (kty=AKP with an
``ML-DSA-*`` alg) become :class:`MLDSAPublicKey` and SLH-DSA keys
(kty=AKP with an ``SLH-DSA-SHAKE-128s``/``-128f`` alg)
:class:`SLHDSAPublicKey`, with the JAX parser's checks and messages.
JWKs that carry x5c raise ``UnsupportedAlgError``: certificate chains
are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..errors import InvalidJWKSError, UnsupportedAlgError
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


def _parse_okp(data: Dict[str, Any]) -> HostEd25519PublicKey:
    """Ed25519 key from its raw 32 bytes. Bytes that do not decode to a
    curve point are accepted, as OpenSSL's raw import accepts them; the
    key's tokens then never verify."""
    if data.get("crv") != "Ed25519":
        raise InvalidJWKSError(f"unsupported OKP curve {data.get('crv')!r}")
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


def parse_jwk(data: Dict[str, Any]) -> JWK:
    """Parse one JWK dict into a JWK with a pure-integer public key."""
    if data.get("x5c") is not None:
        raise UnsupportedAlgError(
            "x5c certificate chains are not supported by cap_tpu_torch yet")
    kty = data.get("kty")
    if kty == "RSA":
        n = _b64_uint(data, "n")
        e = _b64_uint(data, "e")
        if n < 3 or n % 2 == 0 or e < 3 or e % 2 == 0:
            raise InvalidJWKSError("invalid RSA jwk: bad modulus or exponent")
        key = RSAPublicKey(n, e)
    elif kty == "EC":
        crv = data.get("crv")
        if crv not in _COORD_BYTES:
            raise InvalidJWKSError(f"unsupported EC curve {crv!r}")
        key = _parse_ec_host(data, crv)
    elif kty == "OKP":
        key = _parse_okp(data)
    elif kty == "AKP":
        key = _parse_akp(data)
    else:
        raise InvalidJWKSError(f"unsupported jwk kty {kty!r}")
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
