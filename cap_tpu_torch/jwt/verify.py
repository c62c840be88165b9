"""Single-token RS*/ES* signature verification over host integers.

The oracle of the GPU keyset's trial path: tokens without a unique key
candidate (no kid with several keys, an ambiguous or unknown kid) are
verified here against each candidate key, as the JAX keyset sends them
to its CPU oracle. RS* is ``pow(s, e, n)`` and the PKCS#1 v1.5 EM
compare; ES* is :func:`~cap_tpu_torch.gpu.ec.py_ecdsa_verify`.
"""

from __future__ import annotations

import hashlib

from ..errors import InvalidSignatureError, UnsupportedAlgError
from ..gpu.ec import HostECPublicKey, curve, py_ecdsa_verify
from ..gpu.rsa import DIGEST_INFO_PREFIX
from . import algs
from .jose import ParsedJWS
from .jwk import RSAPublicKey

_RS = (algs.RS256, algs.RS384, algs.RS512)
_RSA_ALGS = _RS + (algs.PS256, algs.PS384, algs.PS512)
# ES* pins both the curve and the raw signature coordinate size
# (RFC 7518 §3.4).
_EC_FOR_ALG = {
    algs.ES256: ("P-256", 32),
    algs.ES384: ("P-384", 48),
    algs.ES512: ("P-521", 66),
}


def key_matches_alg(key, alg: str) -> bool:
    """Whether the key type is usable with the given JOSE alg."""
    if alg in _RSA_ALGS:
        return isinstance(key, RSAPublicKey)
    if alg in _EC_FOR_ALG:
        return (isinstance(key, HostECPublicKey)
                and key.curve_name == _EC_FOR_ALG[alg][0])
    return False


def pkcs1v15_em(digest: bytes, hash_name: str, em_len: int) -> bytes:
    """EMSA-PKCS1-v1_5 encoding of a digest (RFC 8017 §9.2)."""
    t = DIGEST_INFO_PREFIX[hash_name] + digest
    if em_len < len(t) + 11:
        raise ValueError("intended encoded message length too short")
    return b"\x00\x01" + b"\xff" * (em_len - len(t) - 3) + b"\x00" + t


def _verify_rs(parsed: ParsedJWS, key: RSAPublicKey) -> None:
    k = (key.n.bit_length() + 7) // 8
    sig = parsed.signature
    if len(sig) != k:
        raise InvalidSignatureError("signature verification failed")
    s = int.from_bytes(sig, "big")
    if s >= key.n:
        raise InvalidSignatureError("signature verification failed")
    hash_name = algs.HASH_FOR_ALG[parsed.alg]
    digest = hashlib.new(hash_name, parsed.signing_input).digest()
    try:
        em = pkcs1v15_em(digest, hash_name, k)
    except ValueError as e:
        raise InvalidSignatureError(
            f"signature verification failed: {e}") from e
    if pow(s, key.e, key.n).to_bytes(k, "big") != em:
        raise InvalidSignatureError("signature verification failed")


def _verify_es(parsed: ParsedJWS, key: HostECPublicKey) -> None:
    _, coord = _EC_FOR_ALG[parsed.alg]
    sig = parsed.signature
    if len(sig) != 2 * coord:
        raise InvalidSignatureError(
            f"bad ECDSA signature length {len(sig)} for {parsed.alg}")
    digest = hashlib.new(algs.HASH_FOR_ALG[parsed.alg],
                         parsed.signing_input).digest()
    nums = key.public_numbers()
    if not py_ecdsa_verify(curve(key.curve_name), nums.x, nums.y, sig,
                           digest):
        raise InvalidSignatureError("signature verification failed")


def verify_parsed(parsed: ParsedJWS, key) -> None:
    """Verify ``parsed.signature`` over ``parsed.signing_input`` with ``key``.

    Raises InvalidSignatureError on any mismatch (wrong key, tampered
    content, malformed signature encoding, wrong curve/key type), and
    UnsupportedAlgError for algs this port cannot verify (PS*, EdDSA,
    the post-quantum families).
    """
    alg = parsed.alg
    if alg not in algs.SUPPORTED_ALGORITHMS:
        raise UnsupportedAlgError(f"unsupported signing algorithm {alg!r}")
    if not key_matches_alg(key, alg):
        raise InvalidSignatureError(f"key type does not match alg {alg}")
    if alg in _RS:
        return _verify_rs(parsed, key)
    if alg in _EC_FOR_ALG:
        return _verify_es(parsed, key)
    raise UnsupportedAlgError(f"{alg} is not ported to cap_tpu_torch yet")
