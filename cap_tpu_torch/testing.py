"""Fixtures without OpenSSL: seeded keys, JWT signing, the north-star
workload.

Everything here is pure Python integers over ``random.Random(seed)``:
RSA keys by Miller–Rabin, PKCS#1 v1.5 signatures by CRT ``pow``, P-256
signatures by :func:`~cap_tpu_torch.gpu.ec.host_ecdsa_sign`. Signing
exists ONLY to produce fixtures; nothing here is constant-time or fit
for real keys.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from typing import Any, Dict, List, Optional, Tuple

from .gpu.ec import HostECPublicKey, curve, host_ecdsa_sign
from .jwt import algs
from .jwt.jose import b64url_encode
from .jwt.jwk import JWK, RSAPublicKey, serialize_public_key
from .jwt.verify import pkcs1v15_em

_SMALL_PRIMES = [p for p in range(3, 2000)
                 if all(p % q for q in range(2, int(p ** 0.5) + 1))]
_SMALL_PROD = math.prod(_SMALL_PRIMES)
_EC_FOR_ALG = {algs.ES256: "P-256", algs.ES384: "P-384",
               algs.ES512: "P-521"}


def _probable_prime(n: int, rng: random.Random, rounds: int = 24) -> bool:
    if math.gcd(n, _SMALL_PROD) != 1:
        return n in _SMALL_PRIMES
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int, rng: random.Random, e: int) -> int:
    while True:
        cand = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if (cand - 1) % e and _probable_prime(cand, rng):
            return cand


class RSAPrivateKey:
    """An RSA key pair over host integers (CRT form)."""

    def __init__(self, p: int, q: int, e: int = 65537):
        self.p, self.q, self.e = p, q, e
        self.n = p * q
        self.d = pow(e, -1, (p - 1) * (q - 1))
        self.dp, self.dq = self.d % (p - 1), self.d % (q - 1)
        self.qinv = pow(q, -1, p)

    def public_key(self) -> RSAPublicKey:
        return RSAPublicKey(self.n, self.e)

    def raw_sign(self, m: int) -> int:
        """m^d mod n by the CRT."""
        s1 = pow(m, self.dp, self.p)
        s2 = pow(m, self.dq, self.q)
        return s2 + (self.qinv * (s1 - s2) % self.p) * self.q


class ECPrivateKey:
    """An ECDSA key pair over host integers."""

    def __init__(self, crv: str, d: int):
        self.crv, self.d = crv, d
        self._pub = HostECPublicKey.from_private(crv, d)

    def public_key(self) -> HostECPublicKey:
        return self._pub


def generate_rsa_key(rng: random.Random, bits: int = 2048,
                     e: int = 65537) -> RSAPrivateKey:
    """An RSA key with an exactly ``bits``-bit modulus."""
    while True:
        p = _random_prime(bits // 2, rng, e)
        q = _random_prime(bits - bits // 2, rng, e)
        if p != q and (p * q).bit_length() == bits:
            return RSAPrivateKey(p, q, e)


def generate_ec_key(rng: random.Random, crv: str = "P-256") -> ECPrivateKey:
    return ECPrivateKey(crv, rng.randrange(1, curve(crv).n))


def sign_jwt(priv, alg: str, claims: Dict[str, Any],
             kid: Optional[str] = None,
             extra_headers: Optional[Dict[str, Any]] = None,
             rng: Optional[random.Random] = None) -> str:
    """Sign ``claims`` into a compact JWS (RS* or ES*). ES* draws its
    nonce from ``rng`` (seeded fixtures stay reproducible)."""
    header: Dict[str, Any] = {"alg": alg, "typ": "JWT"}
    if kid:
        header["kid"] = kid
    if extra_headers:
        header.update(extra_headers)
    signing_input = (
        b64url_encode(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + b64url_encode(json.dumps(claims, separators=(",", ":")).encode())
    ).encode("ascii")
    hash_name = algs.HASH_FOR_ALG[alg]
    digest = hashlib.new(hash_name, signing_input).digest()
    if alg in (algs.RS256, algs.RS384, algs.RS512):
        k = (priv.n.bit_length() + 7) // 8
        m = int.from_bytes(pkcs1v15_em(digest, hash_name, k), "big")
        sig = priv.raw_sign(m).to_bytes(k, "big")
    elif alg in _EC_FOR_ALG:
        cp = curve(priv.crv)
        rng = rng if rng is not None else random.Random()
        e = int.from_bytes(digest, "big")
        excess = 8 * len(digest) - cp.nbits
        if excess > 0:
            e >>= excess
        while True:
            try:
                r, s = host_ecdsa_sign(priv.crv, priv.d, e,
                                       rng.randrange(1, cp.n))
                break
            except ValueError:
                continue
        sig = r.to_bytes(cp.coord_bytes, "big") + \
            s.to_bytes(cp.coord_bytes, "big")
    else:
        raise ValueError(f"unsupported alg {alg!r}")
    return signing_input.decode("ascii") + "." + b64url_encode(sig)


def default_claims(now: int = 1_700_000_000, ttl: int = 86400,
                   **extra) -> Dict[str, Any]:
    """A fixed claims set for fixture JWTs (no clock: reproducible)."""
    claims: Dict[str, Any] = {
        "iss": "https://example.com/", "sub": "alice",
        "aud": ["client-id"], "iat": now, "nbf": now, "exp": now + ttl,
    }
    claims.update(extra)
    return claims


def headline_fixtures(n_unique: int, seed: int = 0
                      ) -> Tuple[List[JWK], List[str], list]:
    """The north-star workload: a JWKS of 8 RSA-2048 keys (kids rs-i)
    and 8 P-256 keys (kids es-i), the JAX package's layout, and
    ``n_unique`` unique RS256/ES256 tokens signed round-robin over the
    keys. Returns (jwks, tokens, signers) with signers
    [(private key, alg, kid)]."""
    rng = random.Random(seed)
    jwks, signers = [], []
    for i in range(8):
        priv = generate_rsa_key(rng)
        jwks.append(JWK(priv.public_key(), kid=f"rs-{i}"))
        signers.append((priv, algs.RS256, f"rs-{i}"))
    for i in range(8):
        priv = generate_ec_key(rng)
        jwks.append(JWK(priv.public_key(), kid=f"es-{i}"))
        signers.append((priv, algs.ES256, f"es-{i}"))
    base = default_claims()
    tokens = []
    for j in range(n_unique):
        priv, alg, kid = signers[j % len(signers)]
        claims = dict(base, sub=f"user-{j:08d}", jti=f"tok-{j:012d}")
        tokens.append(sign_jwt(priv, alg, claims, kid=kid, rng=rng))
    return jwks, tokens, signers


def jwks_document(jwks: List[JWK]) -> Dict[str, Any]:
    """``{"keys": [...]}`` for a list of JWKs."""
    return {"keys": [serialize_public_key(j.key, kid=j.kid, alg=j.alg)
                     for j in jwks]}
