"""Single-token RS*/PS*/ES*/EdDSA/ML-DSA/SLH-DSA signature verification
over host integers.

The oracle of the GPU keyset's trial path: tokens without a unique key
candidate (no kid with several keys, an ambiguous or unknown kid) are
verified here against each candidate key, as the JAX keyset sends them
to its CPU oracle. RS* is ``pow(s, e, n)`` and the PKCS#1 v1.5 EM
compare; PS* is ``pow`` and EMSA-PSS-VERIFY with salt auto-recovery
(:func:`pss_check_em`); ES* is
:func:`~cap_tpu_torch.gpu.ec.py_ecdsa_verify`; EdDSA is
:func:`~cap_tpu_torch.gpu.ed25519.py_ed25519_verify`, with the device
ladder's semantics (the JAX keyset's trial path asks OpenSSL, which
differs on two kinds of non-canonical key, ROADMAP §C); ML-DSA-* is
:func:`~cap_tpu_torch.gpu.mldsa.py_verify` and SLH-DSA-SHAKE-* is
:func:`~cap_tpu_torch.gpu.slhdsa.py_verify`.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from ..errors import InvalidSignatureError, UnsupportedAlgError
from ..gpu.ec import HostECPublicKey, curve, py_ecdsa_verify
from ..gpu.ed25519 import HostEd25519PublicKey, py_ed25519_verify
from ..gpu.mldsa import py_verify as mldsa_py_verify
from ..gpu.slhdsa import py_verify as slhdsa_py_verify
from ..gpu.rsa import DIGEST_INFO_PREFIX, HASH_LEN
from . import algs
from .jose import ParsedJWS
from .jwk import RSAPublicKey

_RS = (algs.RS256, algs.RS384, algs.RS512)
_PS = (algs.PS256, algs.PS384, algs.PS512)
_RSA_ALGS = _RS + _PS
# ES* pins both the curve and the raw signature coordinate size
# (RFC 7518 §3.4).
_EC_FOR_ALG = {
    algs.ES256: ("P-256", 32),
    algs.ES384: ("P-384", 48),
    algs.ES512: ("P-521", 66),
}


def key_matches_alg(key, alg: str) -> bool:
    """Whether the key type is usable with the given JOSE alg."""
    if alg in algs.PQ_ALGORITHMS:
        # AKP families: the alg name IS the key's parameter-set name.
        return getattr(key, "parameter_set", None) == alg
    if alg in _RSA_ALGS:
        return isinstance(key, RSAPublicKey)
    if alg in _EC_FOR_ALG:
        return (isinstance(key, HostECPublicKey)
                and key.curve_name == _EC_FOR_ALG[alg][0])
    if alg == algs.EdDSA:
        return isinstance(key, HostEd25519PublicKey)
    return False


def pkcs1v15_em(digest: bytes, hash_name: str, em_len: int) -> bytes:
    """EMSA-PKCS1-v1_5 encoding of a digest (RFC 8017 §9.2)."""
    t = DIGEST_INFO_PREFIX[hash_name] + digest
    if em_len < len(t) + 11:
        raise ValueError("intended encoded message length too short")
    return b"\x00\x01" + b"\xff" * (em_len - len(t) - 3) + b"\x00" + t


def _mgf1(seed: bytes, mask_len: int, hash_name: str) -> bytes:
    h_len = HASH_LEN[hash_name]
    out = bytearray()
    for counter in range((mask_len + h_len - 1) // h_len):
        out += hashlib.new(hash_name,
                           seed + counter.to_bytes(4, "big")).digest()
    return bytes(out[:mask_len])


def pss_check_em(em: bytes, m_hash: bytes, em_bits: int,
                 hash_name: str, salt_len: Optional[int] = None) -> bool:
    """EMSA-PSS-VERIFY (RFC 8017 §9.1.2) for one token, on the host.

    salt_len None → auto-recover (any salt length), as the JAX keyset's
    oracle verifies with PSS.AUTO.
    """
    h_len = HASH_LEN[hash_name]
    em_len = (em_bits + 7) // 8
    if len(em) > em_len:
        # EM must be < 2^emBits: any dropped high bytes must be zero.
        if any(em[: len(em) - em_len]):
            return False
        em = em[-em_len:]
    if em_len < h_len + 2:
        return False
    if em[-1] != 0xBC:
        return False
    masked_db = em[: em_len - h_len - 1]
    h = em[em_len - h_len - 1: em_len - 1]
    db_len = em_len - h_len - 1
    unused_bits = 8 * em_len - em_bits
    if unused_bits and masked_db[0] >> (8 - unused_bits):
        return False
    db_mask = _mgf1(h, db_len, hash_name)
    db = bytes(a ^ b for a, b in zip(masked_db, db_mask))
    if unused_bits:
        db = bytes([db[0] & (0xFF >> unused_bits)]) + db[1:]
    # DB = PS(0x00..) ‖ 0x01 ‖ salt
    sep = db.find(b"\x01")
    if sep == -1 or any(db[:sep]):
        return False
    salt = db[sep + 1:]
    if salt_len is not None and len(salt) != salt_len:
        return False
    m_prime = b"\x00" * 8 + m_hash + salt
    return hashlib.new(hash_name, m_prime).digest() == h


def _rsa_message(parsed: ParsedJWS, key: RSAPublicKey) -> int:
    """s^e mod n after the length and range checks."""
    sig = parsed.signature
    if len(sig) != (key.n.bit_length() + 7) // 8:
        raise InvalidSignatureError("signature verification failed")
    s = int.from_bytes(sig, "big")
    if s >= key.n:
        raise InvalidSignatureError("signature verification failed")
    return pow(s, key.e, key.n)


def _verify_rs(parsed: ParsedJWS, key: RSAPublicKey) -> None:
    k = (key.n.bit_length() + 7) // 8
    m = _rsa_message(parsed, key)
    hash_name = algs.HASH_FOR_ALG[parsed.alg]
    digest = hashlib.new(hash_name, parsed.signing_input).digest()
    try:
        em = pkcs1v15_em(digest, hash_name, k)
    except ValueError as e:
        raise InvalidSignatureError(
            f"signature verification failed: {e}") from e
    if m.to_bytes(k, "big") != em:
        raise InvalidSignatureError("signature verification failed")


def _verify_ps(parsed: ParsedJWS, key: RSAPublicKey) -> None:
    k = (key.n.bit_length() + 7) // 8
    m = _rsa_message(parsed, key)
    hash_name = algs.HASH_FOR_ALG[parsed.alg]
    digest = hashlib.new(hash_name, parsed.signing_input).digest()
    if not pss_check_em(m.to_bytes(k, "big"), digest,
                        key.n.bit_length() - 1, hash_name):
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
    UnsupportedAlgError for an alg outside ``algs.SUPPORTED_ALGORITHMS``.
    """
    alg = parsed.alg
    if alg not in algs.SUPPORTED_ALGORITHMS:
        raise UnsupportedAlgError(f"unsupported signing algorithm {alg!r}")
    if not key_matches_alg(key, alg):
        raise InvalidSignatureError(f"key type does not match alg {alg}")
    if alg in _RS:
        return _verify_rs(parsed, key)
    if alg in _PS:
        return _verify_ps(parsed, key)
    if alg in _EC_FOR_ALG:
        return _verify_es(parsed, key)
    if alg == algs.EdDSA:
        if not py_ed25519_verify(key.raw, parsed.signature,
                                 parsed.signing_input):
            raise InvalidSignatureError("signature verification failed")
        return None
    if alg in algs.MLDSA_ALGORITHMS:
        # py_verify applies every encoding rule (length, hint validity,
        # z range): all rejects are signature-layer rejects.
        if not mldsa_py_verify(key, parsed.signature,
                               parsed.signing_input):
            raise InvalidSignatureError("signature verification failed")
        return None
    # SLH-DSA: the only non-root reject gate is the signature length;
    # everything else lands in the root compare
    if not slhdsa_py_verify(key, parsed.signature, parsed.signing_input):
        raise InvalidSignatureError("signature verification failed")
    return None
