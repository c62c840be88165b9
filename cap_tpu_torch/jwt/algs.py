"""JOSE asymmetric signing algorithm registry (RFC 7518 §3.1).

Parity with jwt/algs.go:6-46: the same ten classical asymmetric
algorithms are supported, plus the post-quantum ML-DSA family (FIPS
204) under the JOSE names registered by draft-ietf-cose-dilithium
(``ML-DSA-44``/``-65``/``-87``); anything else (including ``none`` and
the HMAC family) is rejected.
"""

from __future__ import annotations

from typing import Iterable

from ..errors import UnsupportedAlgError

Alg = str

RS256: Alg = "RS256"  # RSASSA-PKCS1-v1.5 using SHA-256
RS384: Alg = "RS384"  # RSASSA-PKCS1-v1.5 using SHA-384
RS512: Alg = "RS512"  # RSASSA-PKCS1-v1.5 using SHA-512
ES256: Alg = "ES256"  # ECDSA using P-256 and SHA-256
ES384: Alg = "ES384"  # ECDSA using P-384 and SHA-384
ES512: Alg = "ES512"  # ECDSA using P-521 and SHA-512
PS256: Alg = "PS256"  # RSASSA-PSS using SHA-256 and MGF1-SHA-256
PS384: Alg = "PS384"  # RSASSA-PSS using SHA-384 and MGF1-SHA-384
PS512: Alg = "PS512"  # RSASSA-PSS using SHA-512 and MGF1-SHA-512
EdDSA: Alg = "EdDSA"  # Ed25519 using SHA-512

# Post-quantum lattice family (FIPS 204 final; JOSE names per
# draft-ietf-cose-dilithium). The whole message is absorbed by
# SHAKE256 inside the scheme, so these carry no HASH_FOR_ALG entry —
# there is no detached SHA-2 prehash step.
MLDSA44: Alg = "ML-DSA-44"  # ML-DSA-44 (NIST category 2)
MLDSA65: Alg = "ML-DSA-65"  # ML-DSA-65 (NIST category 3)
MLDSA87: Alg = "ML-DSA-87"  # ML-DSA-87 (NIST category 5)

MLDSA_ALGORITHMS = frozenset({MLDSA44, MLDSA65, MLDSA87})

# Post-quantum hash family (FIPS 205, SPHINCS+; JOSE names per
# draft-ietf-cose-sphincs-plus). Pure-hash: the scheme absorbs the
# whole message internally via SHAKE256 — no HASH_FOR_ALG entry,
# exactly like ML-DSA.
SLHDSA128S: Alg = "SLH-DSA-SHAKE-128s"  # small/slow, NIST category 1
SLHDSA128F: Alg = "SLH-DSA-SHAKE-128f"  # fast, NIST category 1

SLHDSA_ALGORITHMS = frozenset({SLHDSA128S, SLHDSA128F})

# The AKP (kty) families: parameter-set-named algs whose key object
# carries ``parameter_set`` — one membership test for the JWK /
# verify routing shared by both lattice and hash families.
PQ_ALGORITHMS = MLDSA_ALGORITHMS | SLHDSA_ALGORITHMS

SUPPORTED_ALGORITHMS = frozenset({
    RS256, RS384, RS512,
    ES256, ES384, ES512,
    PS256, PS384, PS512,
    EdDSA,
}) | PQ_ALGORITHMS

# Hash function name (hashlib) per algorithm (prehash families only:
# ML-DSA hashes internally via SHAKE and is deliberately absent).
HASH_FOR_ALG = {
    RS256: "sha256", RS384: "sha384", RS512: "sha512",
    ES256: "sha256", ES384: "sha384", ES512: "sha512",
    PS256: "sha256", PS384: "sha384", PS512: "sha512",
    EdDSA: "sha512",
}


def supported_signing_algorithm(*algs: Alg) -> None:
    """Raise UnsupportedAlgError if any given alg is not supported."""
    for a in algs:
        if a not in SUPPORTED_ALGORITHMS:
            raise UnsupportedAlgError(f"unsupported signing algorithm {a!r}")


def supported(algs: Iterable[Alg]) -> bool:
    return all(a in SUPPORTED_ALGORITHMS for a in algs)
