"""Fixtures without OpenSSL: seeded keys, JWT signing, the north-star,
PS256 + EdDSA, PS384 + PS512, ML-DSA, SLH-DSA, RS256/384/512 over
2048/4096-bit keys, limb-engine RSA and 300-key JWKS workloads, x5c JWKs
(a minimal DER certificate writer), SPKI and PKCS#1 PEMs, a self-signed
TLS CA (``generate_ca``), and loopback JWKS and OIDC discovery servers.

Everything here is pure Python integers over ``random.Random(seed)``:
RSA keys by Miller–Rabin, PKCS#1 v1.5 and PSS signatures by CRT
``pow``, P-256 signatures by :func:`~cap_tpu_torch.gpu.ec.host_ecdsa_sign`,
Ed25519 keys and RFC 8032 signatures from 32-byte seeds
(:func:`~cap_tpu_torch.gpu.ed25519.ed25519_sign`; deterministic, so
byte-equal to any other RFC 8032 signer), ML-DSA keys from 32-byte
seeds ξ and the deterministic FIPS 204 signer
(:func:`~cap_tpu_torch.gpu.mldsa.keygen`), SLH-DSA keys from 32-byte
seeds and the deterministic FIPS 205 signer
(:func:`~cap_tpu_torch.gpu.slhdsa.keygen`). Signing exists ONLY to
produce fixtures; nothing here is constant-time or fit for real keys.
"""

from __future__ import annotations

import base64
import hashlib
import json
import math
import random
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .gpu.ec import HostECPublicKey, curve, host_ecdsa_sign
from .gpu.ec import scalar_mult as _ec_mult
from .gpu.ed25519 import HostEd25519PublicKey, ed25519_sign
from .gpu.mldsa import PARAMS as MLDSA_PARAMS
from .gpu.mldsa import keygen as mldsa_keygen
from .gpu.mldsa import sig_decode, sig_encode
from .gpu.rsa import HASH_LEN
from .gpu.slhdsa import PARAMS as SLHDSA_PARAMS
from .gpu.slhdsa import keygen as slhdsa_keygen
from .jwt import algs
from .jwt.jose import b64url_encode
from .jwt.jwk import JWK, RSAPublicKey, serialize_public_key
from .jwt.verify import _mgf1, pkcs1v15_em

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


_SIEVE_PRIMES = [p for p in range(3, 1 << 16)
                 if all(p % q for q in range(2, int(p ** 0.5) + 1))]
_SIEVE_SPAN = 4096


def sieved_prime(bits: int, rng: random.Random,
                 exponents: Tuple[int, ...] = (65537,)) -> int:
    """A random ``bits``-bit prime p (its top two bits set) with p − 1
    prime to every exponent of ``exponents`` (each a prime).

    The cheaper search of the newer fixtures: from a random odd start,
    the next 4,096 odd numbers are sieved by every odd prime below 2^16
    at once, and only the survivors (about 1 in 10) get Miller–Rabin:
    8 rounds (random candidates, so far below a 2^-100 error), whose
    first witness ends a composite's test.
    """
    while True:
        start = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        alive = bytearray(b"\x01") * _SIEVE_SPAN
        for q in _SIEVE_PRIMES:
            # start + 2i ≡ 0 (mod q) at i ≡ −start · 2⁻¹
            i0 = (-(start % q) * ((q + 1) // 2)) % q
            alive[i0::q] = bytes(len(range(i0, _SIEVE_SPAN, q)))
        for i in range(_SIEVE_SPAN):
            cand = start + 2 * i
            if cand.bit_length() != bits:
                break
            if alive[i] and all((cand - 1) % e for e in exponents) \
                    and _probable_prime(cand, rng, rounds=8):
                return cand


def prime_pool(n: int, bits: int, rng: random.Random,
               exponents: Tuple[int, ...] = (65537,)) -> List[int]:
    """``n`` distinct primes of ``sieved_prime``."""
    pool: List[int] = []
    while len(pool) < n:
        p = sieved_prime(bits, rng, exponents)
        if p not in pool:
            pool.append(p)
    return pool


def pool_rsa_keys(pool: List[int], count: int,
                  exponents: Tuple[int, ...] = (65537,)
                  ) -> List["RSAPrivateKey"]:
    """``count`` RSA keys whose moduli are products of distinct pairs of
    ``pool`` (C(len(pool), 2) at most), key j with exponent
    ``exponents[j % len(exponents)]``: many distinct moduli, each a
    valid key for signing and verification, from few prime searches."""
    pairs = [(a, b) for i, a in enumerate(pool) for b in pool[i + 1:]]
    if count > len(pairs):
        raise ValueError(f"a pool of {len(pool)} primes makes "
                         f"{len(pairs)} moduli, not {count}")
    return [RSAPrivateKey(a, b, exponents[j % len(exponents)])
            for j, (a, b) in enumerate(pairs[:count])]


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


class MultiPrimeRSAKey:
    """An RSA key pair whose modulus is a product of more than two primes
    (RFC 8017 §3.1), signing by the CRT over every prime: to a verifier
    a key like any other of its width, and far cheaper to make and to
    sign with in pure Python than a two-prime key of 3,072 or 4,096
    bits."""

    def __init__(self, primes, e: int = 65537):
        self.primes, self.e = list(primes), e
        self.n = math.prod(self.primes)
        self.d = pow(e, -1, math.lcm(*(p - 1 for p in self.primes)))

    def public_key(self) -> RSAPublicKey:
        return RSAPublicKey(self.n, self.e)

    def raw_sign(self, m: int) -> int:
        """m^d mod n by the CRT (Garner's recombination)."""
        s, mod = 0, 1
        for p in self.primes:
            t = (pow(m, self.d % (p - 1), p) - s) * pow(mod, -1, p) % p
            s, mod = s + mod * t, mod * p
        return s


def multiprime_rsa_keys(pool: List[int], count: int, n_primes: int,
                        bits: int) -> List[MultiPrimeRSAKey]:
    """``count`` e = 65537 keys, each modulus the product of a distinct
    ``n_primes``-subset of ``pool`` that is exactly ``bits`` bits
    wide."""
    from itertools import combinations

    keys = [MultiPrimeRSAKey(c) for c in combinations(pool, n_primes)
            if math.prod(c).bit_length() == bits][:count]
    if len(keys) < count:
        raise ValueError(f"the pool makes {len(keys)} {bits}-bit moduli "
                         f"of {n_primes} primes, not {count}")
    return keys


class ECPrivateKey:
    """An ECDSA key pair over host integers."""

    def __init__(self, crv: str, d: int):
        self.crv, self.d = crv, d
        self._pub = HostECPublicKey.from_private(crv, d)

    def public_key(self) -> HostECPublicKey:
        return self._pub


class Ed25519PrivateKey:
    """An Ed25519 key pair from its RFC 8032 32-byte seed."""

    def __init__(self, seed: bytes):
        self.seed = bytes(seed)
        self._pub = HostEd25519PublicKey.from_seed(self.seed)

    def public_key(self) -> HostEd25519PublicKey:
        return self._pub

    def sign(self, msg: bytes) -> bytes:
        return ed25519_sign(self.seed, msg)


def generate_ed25519_key(rng: random.Random) -> Ed25519PrivateKey:
    return Ed25519PrivateKey(rng.randbytes(32))


def pss_em(digest: bytes, em_bits: int, hash_name: str,
           salt: bytes) -> bytes:
    """EMSA-PSS-ENCODE (RFC 8017 §9.1.1) of a message digest."""
    h_len = HASH_LEN[hash_name]
    em_len = (em_bits + 7) // 8
    if em_len < h_len + len(salt) + 2:
        raise ValueError("salt too long for the key")
    h = hashlib.new(hash_name, b"\x00" * 8 + digest + salt).digest()
    db = b"\x00" * (em_len - len(salt) - h_len - 2) + b"\x01" + salt
    masked = bytearray(a ^ b for a, b in
                       zip(db, _mgf1(h, em_len - h_len - 1, hash_name)))
    masked[0] &= 0xFF >> (8 * em_len - em_bits)
    return bytes(masked) + h + b"\xbc"


def signing_input(alg: str, claims: Dict[str, Any],
                  kid: Optional[str] = None,
                  extra_headers: Optional[Dict[str, Any]] = None) -> bytes:
    """The JWS signing input (header.payload) of a compact token."""
    header: Dict[str, Any] = {"alg": alg, "typ": "JWT"}
    if kid:
        header["kid"] = kid
    if extra_headers:
        header.update(extra_headers)
    return (
        b64url_encode(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + b64url_encode(json.dumps(claims, separators=(",", ":")).encode())
    ).encode("ascii")


def sign_em(priv: "RSAPrivateKey", si: bytes, em: bytes) -> str:
    """A token over ``si`` whose signature is em^d mod n for an EM given
    byte for byte (em < n): malformed PSS encodings on demand."""
    k = (priv.n.bit_length() + 7) // 8
    sig = priv.raw_sign(int.from_bytes(em, "big")).to_bytes(k, "big")
    return si.decode("ascii") + "." + b64url_encode(sig)


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
             rng: Optional[random.Random] = None,
             salt_len: Union[int, str, None] = None) -> str:
    """Sign ``claims`` into a compact JWS (RS*, PS*, ES*, EdDSA, ML-DSA-*
    or SLH-DSA-SHAKE-*, the last two with a private key of their set
    from ``gpu.mldsa.keygen`` or ``gpu.slhdsa.keygen``). ES*
    draws its nonce and PS* its salt from ``rng`` (seeded fixtures stay
    reproducible); ``salt_len`` is the PSS salt's length: the hash's
    length by default, any int, or "max"."""
    si = signing_input(alg, claims, kid, extra_headers)
    rng = rng if rng is not None else random.Random()
    if alg == algs.EdDSA or alg in algs.PQ_ALGORITHMS:
        return si.decode("ascii") + "." + b64url_encode(priv.sign(si))
    hash_name = algs.HASH_FOR_ALG[alg]
    digest = hashlib.new(hash_name, si).digest()
    if alg in (algs.RS256, algs.RS384, algs.RS512):
        k = (priv.n.bit_length() + 7) // 8
        return sign_em(priv, si, pkcs1v15_em(digest, hash_name, k))
    if alg in (algs.PS256, algs.PS384, algs.PS512):
        em_bits = priv.n.bit_length() - 1
        if salt_len is None:
            salt_len = HASH_LEN[hash_name]
        elif salt_len == "max":
            salt_len = (em_bits + 7) // 8 - HASH_LEN[hash_name] - 2
        em = pss_em(digest, em_bits, hash_name, rng.randbytes(salt_len))
        return sign_em(priv, si, em)
    if alg not in _EC_FOR_ALG:
        raise ValueError(f"unsupported alg {alg!r}")
    cp = curve(priv.crv)
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
    return si.decode("ascii") + "." + b64url_encode(sig)


def default_claims(now: int = 1_700_000_000, ttl: int = 86400,
                   **extra) -> Dict[str, Any]:
    """A fixed claims set for fixture JWTs (no clock: reproducible)."""
    claims: Dict[str, Any] = {
        "iss": "https://example.com/", "sub": "alice",
        "aud": ["client-id"], "iat": now, "nbf": now, "exp": now + ttl,
    }
    claims.update(extra)
    return claims


def _sign_round_robin(signers, n_unique: int, rng) -> List[str]:
    """``n_unique`` tokens, token j signed by signers[j % len(signers)]
    over the fixture claims with its own sub and jti."""
    base = default_claims()
    tokens = []
    for j in range(n_unique):
        priv, alg, kid = signers[j % len(signers)]
        claims = dict(base, sub=f"user-{j:08d}", jti=f"tok-{j:012d}")
        tokens.append(sign_jwt(priv, alg, claims, kid=kid, rng=rng))
    return tokens


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
    return jwks, _sign_round_robin(signers, n_unique, rng), signers


def config3_fixtures(n_unique: int, seed: int = 0
                     ) -> Tuple[List[JWK], List[str], list]:
    """The ES256 + ES384 workload (BASELINE.json's third configuration):
    a JWKS of 8 P-256 keys (kids es-i) and 8 P-384 keys (kids
    es384-i), and ``n_unique`` unique ES256/ES384 tokens signed
    round-robin over the keys (half under each curve). Returns (jwks,
    tokens, signers) with signers [(private key, alg, kid)]."""
    return _ec_fixtures(((algs.ES256, "P-256", "es"),
                         (algs.ES384, "P-384", "es384")), 8, n_unique,
                        seed)


def es512_fixtures(n_unique: int, seed: int = 0, n_keys: int = 2
                   ) -> Tuple[List[JWK], List[str], list]:
    """A small ES512 set: ``n_keys`` P-521 keys (kids es512-i) and
    ``n_unique`` unique ES512 tokens signed round-robin over them."""
    return _ec_fixtures(((algs.ES512, "P-521", "es512"),), n_keys,
                        n_unique, seed)


def _ec_fixtures(families, n_keys: int, n_unique: int, seed: int):
    rng = random.Random(seed)
    jwks, signers = [], []
    for alg, crv, tag in families:
        for i in range(n_keys):
            priv = generate_ec_key(rng, crv)
            jwks.append(JWK(priv.public_key(), kid=f"{tag}-{i}"))
            signers.append((priv, alg, f"{tag}-{i}"))
    return jwks, _sign_round_robin(signers, n_unique, rng), signers


def config4_fixtures(n_unique: int, seed: int = 0
                     ) -> Tuple[List[JWK], List[str], list]:
    """The PS256 + EdDSA workload (BASELINE.json's fourth configuration):
    a JWKS of 8 RSA-2048 keys (kids ps-i) and 8 Ed25519 keys (kids
    ed-i), and ``n_unique`` unique PS256/EdDSA tokens signed
    round-robin over the keys (PSS salts of 32 bytes). Returns (jwks,
    tokens, signers) with signers [(private key, alg, kid)]."""
    rng = random.Random(seed)
    jwks, signers = [], []
    for i in range(8):
        priv = generate_rsa_key(rng)
        jwks.append(JWK(priv.public_key(), kid=f"ps-{i}"))
        signers.append((priv, algs.PS256, f"ps-{i}"))
    for i in range(8):
        priv = generate_ed25519_key(rng)
        jwks.append(JWK(priv.public_key(), kid=f"ed-{i}"))
        signers.append((priv, algs.EdDSA, f"ed-{i}"))
    return jwks, _sign_round_robin(signers, n_unique, rng), signers


def ps512_fixtures(n_unique: int, seed: int = 0
                   ) -> Tuple[List[JWK], List[str], list]:
    """The PS384 + PS512 workload: a JWKS of 8 RSA-2048 keys (kids ps-i)
    and ``n_unique`` unique tokens signed round-robin over 16 signers,
    PS384 then PS512 under each key (PSS salts of the hash's length).
    Returns (jwks, tokens, signers) with signers [(private key, alg,
    kid)]: unique token u signs with signers[u % 16], PS512 at
    u % 16 ≥ 8."""
    rng = random.Random(seed)
    privs = [generate_rsa_key(rng) for _ in range(8)]
    jwks = [JWK(p.public_key(), kid=f"ps-{i}") for i, p in enumerate(privs)]
    signers = [(p, alg, f"ps-{i}") for alg in (algs.PS384, algs.PS512)
               for i, p in enumerate(privs)]
    return jwks, _sign_round_robin(signers, n_unique, rng), signers


def mldsa_fixtures(n_unique: int, seed: int = 0
                   ) -> Tuple[List[JWK], List[str], list]:
    """The ML-DSA workload: a JWKS of 8 ML-DSA-44 keys (kids
    mldsa44-i) and 8 ML-DSA-65 keys (kids mldsa65-i), AKP keys from
    seeded 32-byte ξ, and ``n_unique`` unique tokens signed round-robin
    over the keys (half under each set). Returns (jwks, tokens,
    signers) with signers [(private key, alg, kid)]."""
    rng = random.Random(seed)
    jwks, signers = [], []
    for alg, tag in ((algs.MLDSA44, "mldsa44"), (algs.MLDSA65, "mldsa65")):
        for i in range(8):
            priv, pub = mldsa_keygen(alg, rng.randbytes(32))
            jwks.append(JWK(pub, kid=f"{tag}-{i}"))
            signers.append((priv, alg, f"{tag}-{i}"))
    base = default_claims()
    tokens = []
    for j in range(n_unique):
        priv, alg, kid = signers[j % len(signers)]
        claims = dict(base, sub=f"user-{j:08d}", jti=f"tok-{j:012d}")
        tokens.append(sign_jwt(priv, alg, claims, kid=kid))
    return jwks, tokens, signers


def config2_fixtures(n_unique: int, seed: int = 0
                     ) -> Tuple[List[JWK], List[str], list]:
    """BASELINE.json's second configuration, "RS256/RS384/RS512 mix,
    2048/4096-bit keys, 8-key JWKS": 4 RSA-2048 keys (kids rs2k-i) and
    4 RSA-4096 keys (kids rs4k-i), e = 65537, from one pool of 8 sieved
    1,024-bit primes: the 2048-bit moduli products of pairs, the
    4096-bit ones of four primes (``MultiPrimeRSAKey``); ``n_unique`` tokens
    signed round-robin over 24 signers, RS256, RS384 then RS512 over
    the 8 keys (token u signs with signers[u % 24]: alg (u % 24) // 8,
    a 4096-bit key at u % 8 ≥ 4). Returns (jwks, tokens, signers)."""
    rng = random.Random(seed)
    pool = prime_pool(8, 1024, rng)
    keys = [(k, f"rs2k-{i}") for i, k in enumerate(pool_rsa_keys(pool, 4))]
    keys += [(k, f"rs4k-{i}")
             for i, k in enumerate(multiprime_rsa_keys(pool, 4, 4, 4096))]
    jwks = [JWK(k.public_key(), kid=kid) for k, kid in keys]
    signers = [(k, alg, kid) for alg in (algs.RS256, algs.RS384, algs.RS512)
               for k, kid in keys]
    return jwks, _sign_round_robin(signers, n_unique, rng), signers


LIMB_EXPONENTS = (3, 17, 65537, 2 ** 31 - 1)


def rns_unsupported_key(bits: int, rng: random.Random):
    """An e = 65537 key whose ``bits``-bit modulus is 4099 times sieved
    primes of about 1,024 bits: 4099 is the smallest prime of the RNS
    prime pool, so the key's class runs on the limb engine
    (``RNSUnsupportedKey``)."""
    n_big = max(1, round((bits - 12) / 1024))
    size = (bits - 12) // n_big
    big = [sieved_prime(size, rng) for _ in range(n_big)]
    while math.prod(big).bit_length() + 12 != bits \
            or (4099 * math.prod(big)).bit_length() != bits:
        big[rng.randrange(n_big)] = sieved_prime(size, rng)
    return MultiPrimeRSAKey([4099] + big)


def rsalimb_fixtures(n_unique: int, seed: int = 0
                     ) -> Tuple[List[JWK], List[str], list]:
    """RSA keys the RNS engine does not take, beside P-256 keys: an
    RSA-2048 class of e = 3, 17, 65537 and 2^31 − 1 keys (kids lim-i;
    ``modexp_vare`` over 31 bits), an RSA-3072 class of e = 65537 keys
    (three 1,024-bit primes a modulus) whose lim3k-0 modulus is 4099 ·
    q (``modexp_65537`` on limbs), and
    4 P-256 keys (es-i). ``n_unique`` tokens round-robin over 32
    signers: RS256 then PS256 over the 8 RSA keys (token u at u % 32 <
    16), ES256 over the P-256 keys (u % 32 ≥ 16). Returns (jwks,
    tokens, signers)."""
    rng = random.Random(seed)
    vare = pool_rsa_keys(prime_pool(4, 1024, rng, LIMB_EXPONENTS), 4,
                         LIMB_EXPONENTS)
    f4 = [rns_unsupported_key(3072, rng)] + multiprime_rsa_keys(
        prime_pool(5, 1024, rng), 3, 3, 3072)
    rsa = [(k, f"lim-{i}") for i, k in enumerate(vare)] + \
        [(k, f"lim3k-{i}") for i, k in enumerate(f4)]
    ec = [(generate_ec_key(rng), f"es-{i}") for i in range(4)]
    jwks = [JWK(k.public_key(), kid=kid) for k, kid in rsa + ec]
    signers = ([(k, alg, kid) for alg in (algs.RS256, algs.PS256)
                for k, kid in rsa]
               + [(k, algs.ES256, kid) for k, kid in ec] * 4)
    return jwks, _sign_round_robin(signers, n_unique, rng), signers


def bigjwks_fixtures(n_unique: int, seed: int = 0, n_keys: int = 300
                     ) -> Tuple[List[JWK], List[str], list]:
    """A multi-tenant JWKS of ``n_keys`` RSA-2048 keys (kids brs-i; e =
    65537, products of pairs from a pool of 25 sieved primes: C(25, 2) =
    300 moduli), ``n_keys`` P-256 keys (bes-i) and ``n_keys`` Ed25519
    keys (bed-i): each class more than the packed record's one-byte key
    row holds. ``n_unique`` tokens: token u is RS256, ES256 or EdDSA by
    u % 3, signed by row (u // 3) % n_keys of that family, so 3·n_keys
    tokens reach every row. Returns (jwks, tokens, signers) with
    signers [(private key, alg, kid)] in that order: family-major."""
    rng = random.Random(seed)
    pool = prime_pool(25, 1024, rng)
    fams = [(algs.RS256, "brs", pool_rsa_keys(pool, n_keys)),
            (algs.ES256, "bes", [generate_ec_key(rng)
                                 for _ in range(n_keys)]),
            (algs.EdDSA, "bed", [generate_ed25519_key(rng)
                                 for _ in range(n_keys)])]
    signers = [(k, alg, f"{tag}-{i}") for alg, tag, keys in fams
               for i, k in enumerate(keys)]
    jwks = [JWK(k.public_key(), kid=kid) for k, _, kid in signers]
    base = default_claims()
    tokens = []
    for j in range(n_unique):
        priv, alg, kid = signers[(j % 3) * n_keys + (j // 3) % n_keys]
        claims = dict(base, sub=f"user-{j:08d}", jti=f"tok-{j:012d}")
        tokens.append(sign_jwt(priv, alg, claims, kid=kid, rng=rng))
    return jwks, tokens, signers


def mldsa_bad_signatures(sig: bytes, parameter_set: str
                         ) -> List[Tuple[str, bytes]]:
    """The ML-DSA rejection classes made from one valid signature, as
    (label, signature): a bit flipped inside c̃ and inside z, one byte
    short and one long, hint indices of a polynomial not increasing, a
    hint count above ω, and a z coefficient re-encoded to γ1 − β (the
    signature decodes; the range check rejects it)."""
    p = MLDSA_PARAMS[parameter_set]
    tail = p.omega + p.k
    hints = bytearray(sig[-tail:])
    lo = 0
    for i in range(p.k):
        end = hints[p.omega + i]
        if end - lo >= 2:
            hints[lo], hints[lo + 1] = hints[lo + 1], hints[lo]
            break
        lo = end
    else:
        raise ValueError("no polynomial with two hints")
    count = bytearray(sig)
    count[-1] = p.omega + 1
    c_tilde, z, h = sig_decode(sig, p)
    z = z.copy()
    z[0, 3] = p.gamma1 - p.beta

    def flip(at: int) -> bytes:
        b = bytearray(sig)
        b[at] ^= 0x04
        return bytes(b)

    return [("c-tilde-bit", flip(5)), ("z-bit", flip(p.lam // 4 + 77)),
            ("short", sig[:-1]), ("long", sig + b"\0"),
            ("hint-order", sig[:-tail] + bytes(hints)),
            ("hint-count", bytes(count)),
            ("z-range", sig_encode(c_tilde, z, h, p))]


def slhdsa_fixtures(n_unique_f: int, n_unique_s: int, seed: int = 0
                    ) -> Tuple[List[JWK], List[str], list]:
    """The SLH-DSA workload: a JWKS of 8 SLH-DSA-SHAKE-128f keys (kids
    slh128f-i) and 8 SLH-DSA-SHAKE-128s keys (kids slh128s-i), AKP keys
    from seeded 32-byte seeds, ``n_unique_f`` unique 128f tokens and
    ``n_unique_s`` unique 128s tokens, each set's signed round-robin
    over its keys (a 128s signature takes seconds of pure Python).
    Returns (jwks, tokens, signers): the 128f tokens first, signers
    [(private key, alg, kid)] with the 128f keys at 0..7 and the 128s
    keys at 8..15; token u of a set signs with its set's signer u % 8."""
    rng = random.Random(seed)
    jwks, signers = [], []
    for alg, tag in ((algs.SLHDSA128F, "slh128f"),
                     (algs.SLHDSA128S, "slh128s")):
        for i in range(8):
            priv, pub = slhdsa_keygen(alg, rng.randbytes(32))
            jwks.append(JWK(pub, kid=f"{tag}-{i}"))
            signers.append((priv, alg, f"{tag}-{i}"))
    base = default_claims()
    tokens = []
    for off, n in ((0, n_unique_f), (8, n_unique_s)):
        for j in range(n):
            priv, alg, kid = signers[off + j % 8]
            claims = dict(base, sub=f"user-{off + j:08d}",
                          jti=f"tok-{off}-{j:010d}")
            tokens.append(sign_jwt(priv, alg, claims, kid=kid))
    return jwks, tokens, signers


def slhdsa_bad_signatures(sig: bytes, parameter_set: str
                          ) -> List[Tuple[str, bytes]]:
    """The SLH-DSA rejection classes made from one valid signature, as
    (label, signature), the JAX package's mutation sweep: a bit of the
    randomizer R flipped, a FORS byte flipped, one byte short and one
    long, a hypertree byte flipped. (Its last class, a changed message,
    is the caller's: another payload under the same signature.)"""
    p = SLHDSA_PARAMS[parameter_set]

    def flip(at: int, bits: int) -> bytes:
        b = bytearray(sig)
        b[at] ^= bits
        return bytes(b)

    return [("r-bit", flip(3, 0x08)),
            ("fors-byte", flip(p.n + 131, 0x20)),
            ("short", sig[:-1]), ("long", sig + b"\0"),
            ("hypertree-byte", flip(len(sig) - 54, 0xFF))]


def ladder_inputs(c, n_windows: int, m: int, n_keys: int, rng,
                  at_inf: int = 16, plant_every: int = 97,
                  zero_share: float = 0.0, pool: Optional[int] = None):
    """Seeded inputs of the whole ladder (``gpu.cuda_ladder.ladder``) and
    of the per-window one over ``c`` (an ``ec_rns`` context at its
    window width w), from the numpy Generator ``rng``: a window table of
    G and ``n_keys`` key slots, [n_windows·(n_keys+1)·(2^w − 1), 2·iap]
    packed words of random values < p (the ladder's arithmetic needs no
    curve points; with ``pool``, each coordinate drawn from ``pool``
    random values, which keeps a 12-bit table's host build short);
    w-bit digits [n_windows, m], a ``zero_share`` of them forced to 0
    and lanes below ``at_inf`` all 0 (they stay at infinity); the first
    half of the lanes on G's slot, the second on a random key's; and
    every ``plant_every``-th lane from ``at_inf`` on (at most 2^w − 1) a
    true same-x degeneracy: its window-1 row a copy of its window-0
    row, so window 1 adds the lifted point to itself. Returns numpy
    (tab, d_all, base, win_stride, true_deg)."""
    from .gpu import ec_rns

    per = (1 << c.w_bits) - 1
    stride = (n_keys + 1) * per
    rows = n_windows * stride
    nbytes = (c.p_int.bit_length() + 71) // 8
    n_vals = 2 * rows if pool is None else pool
    res = ec_rns._residue_matrix(
        c, [int.from_bytes(rng.bytes(nbytes), "big") % c.p_int
            for _ in range(n_vals)])
    if pool is not None:
        res = res[rng.integers(0, pool, 2 * rows)]
    tab = np.concatenate([ec_rns._pack_residue_rows(c, res[:rows]),
                          ec_rns._pack_residue_rows(c, res[rows:])],
                         axis=1)
    d = rng.integers(0, per + 1, (n_windows, m)).astype(np.int32)
    if zero_share:
        d[rng.random((n_windows, m)) < zero_share] = 0
    d[:, :at_inf] = 0
    base = np.zeros(m, np.int32)
    base[m // 2:] = (rng.integers(0, n_keys, m - m // 2) + 1) * per
    true_deg = np.zeros(m, bool)
    for k, j in enumerate(range(at_inf, m, plant_every)):
        if k == per:
            break
        a = 1 + int(rng.integers(0, per))
        d[0, j], d[1, j] = a, 1 + k
        tab[stride + base[j] + k] = tab[base[j] + a - 1]
        true_deg[j] = True
    return tab, d, base, stride, true_deg


_EDGE_HLEN = {"P-256": 32, "P-384": 48, "P-521": 64}


def ec_edge_vectors(crv: str):
    """The ES* ladders' edge vectors on one curve, the JAX package's
    ``tests/test_ec_affine.py`` fixture rebuilt from its seed (the same
    random draws, so the same key, signatures and digests): (public
    key, names, raw signatures, digests). Valid signatures (both s
    halves), tampered r and s, r or s of 0, n, 1 or n − 1, the merge's
    doubling (u1·G = u2·Q) and inverse (u1·G = −u2·Q), an e = 0 G chain
    that stays at infinity (rejecting, and a crafted accepting
    signature on the Q chain alone), and an all-ones digest (e ≥ n on
    P-256 and P-384)."""
    cp = curve(crv)
    rng = random.Random(0xC0FFEE + cp.nbits)
    cb = cp.coord_bytes
    hlen = _EDGE_HLEN[crv]
    d = rng.randrange(1, cp.n)
    key = HostECPublicKey.from_private(crv, d)
    q = (key.public_numbers().x, key.public_numbers().y)

    def sig(r, s):
        return r.to_bytes(cb, "big") + s.to_bytes(cb, "big")

    def dig(e):
        return e.to_bytes(hlen, "big")

    digest = bytes(rng.randrange(256) for _ in range(hlen))
    r, s = host_ecdsa_sign(crv, d, int.from_bytes(digest, "big"),
                           rng.randrange(1, cp.n))
    vectors = [
        ("valid", sig(r, s), digest),
        ("valid-high-s", sig(r, cp.n - s), digest),
        ("tampered-s", sig(r, s + 1 if s + 1 < cp.n else s - 1), digest),
        ("tampered-r", sig(r + 1 if r + 1 < cp.n else r - 1, s), digest),
        ("r-zero", sig(0, s), digest),
        ("s-zero", sig(r, 0), digest),
        ("r-eq-n", sig(cp.n, s), digest),
        ("s-eq-n", sig(r, cp.n), digest),
        ("r-s-one", sig(1, 1), digest),
        ("r-s-n-minus-1", sig(cp.n - 1, cp.n - 1), digest),
    ]
    # s = 1: u2 = r, u1 = e; e = d·r makes the chains meet (doubling),
    # e = −d·r makes them inverse; the digest width bounds e
    lim = 1 << (8 * hlen)
    r0 = rng.randrange(1, cp.n)
    while d * r0 % cp.n >= lim:
        r0 = rng.randrange(1, cp.n)
    vectors.append(("deg-double-merge", sig(r0, 1), dig(d * r0 % cp.n)))
    r1 = rng.randrange(1, cp.n)
    while (cp.n - d * r1 % cp.n) % cp.n >= lim:
        r1 = rng.randrange(1, cp.n)
    vectors.append(("deg-inverse-merge", sig(r1, 1),
                    dig((cp.n - d * r1 % cp.n) % cp.n)))
    vectors.append(("inf-g-reject", sig(r0, s), dig(0)))
    while True:
        u2 = rng.randrange(1, cp.n)
        ra = _ec_mult(cp, u2, q)[0] % cp.n
        if ra:
            break
    vectors.append(("inf-g-accept", sig(ra, ra * pow(u2, -1, cp.n) % cp.n),
                    dig(0)))
    big = b"\xff" * hlen
    rb, sb = host_ecdsa_sign(crv, d, int.from_bytes(big, "big"),
                             rng.randrange(1, cp.n))
    vectors.append(("valid-e-ge-n", sig(rb, sb), big))
    return (key, [v[0] for v in vectors], [v[1] for v in vectors],
            [v[2] for v in vectors])


def jwks_document(jwks: List[JWK]) -> Dict[str, Any]:
    """``{"keys": [...]}`` for a list of JWKs."""
    return {"keys": [serialize_public_key(j.key, kid=j.kid, alg=j.alg)
                     for j in jwks]}


# ---------------------------------------------------------------------------
# DER certificates and PEM keys
# ---------------------------------------------------------------------------

def _der(tag: int, body: bytes) -> bytes:
    n = len(body)
    if n < 0x80:
        return bytes([tag, n]) + body
    ln = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(ln)]) + ln + body


def _der_seq(*parts: bytes) -> bytes:
    return _der(0x30, b"".join(parts))


def _der_uint(v: int) -> bytes:
    return _der(0x02, v.to_bytes(v.bit_length() // 8 + 1, "big"))


def _der_oid(dotted: str) -> bytes:
    arcs = [int(a) for a in dotted.split(".")]
    out = bytearray()
    for v in [40 * arcs[0] + arcs[1]] + arcs[2:]:
        chunk = [v & 0x7F]
        v >>= 7
        while v:
            chunk.append(0x80 | (v & 0x7F))
            v >>= 7
        out += bytes(reversed(chunk))
    return _der(0x06, bytes(out))


_CURVE_OIDS = {"P-256": "1.2.840.10045.3.1.7", "P-384": "1.3.132.0.34",
               "P-521": "1.3.132.0.35"}


def spki_der(pub) -> bytes:
    """The DER SubjectPublicKeyInfo of an RSA, EC or Ed25519 key."""
    if isinstance(pub, RSAPublicKey):
        alg = _der_seq(_der_oid("1.2.840.113549.1.1.1"), b"\x05\x00")
        key = _der_seq(_der_uint(pub.n), _der_uint(pub.e))
    elif isinstance(pub, HostECPublicKey):
        alg = _der_seq(_der_oid("1.2.840.10045.2.1"),
                       _der_oid(_CURVE_OIDS[pub.curve_name]))
        size = curve(pub.curve_name).coord_bytes
        nums = pub.public_numbers()
        key = (b"\x04" + nums.x.to_bytes(size, "big")
               + nums.y.to_bytes(size, "big"))
    elif isinstance(pub, HostEd25519PublicKey):
        alg = _der_seq(_der_oid("1.3.101.112"))
        key = pub.raw
    else:
        raise ValueError(f"no SPKI for {type(pub).__name__}")
    return _der_seq(alg, _der(0x03, b"\x00" + key))


def _pem(label: str, der: bytes) -> str:
    b64 = base64.b64encode(der).decode("ascii")
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return (f"-----BEGIN {label}-----\n" + "\n".join(lines)
            + f"\n-----END {label}-----\n")


def spki_pem(pub) -> str:
    """A ``PUBLIC KEY`` PEM block (SubjectPublicKeyInfo)."""
    return _pem("PUBLIC KEY", spki_der(pub))


def pkcs1_pem(pub: RSAPublicKey) -> str:
    """An ``RSA PUBLIC KEY`` PEM block (PKCS#1 RSAPublicKey)."""
    return _pem("RSA PUBLIC KEY",
                _der_seq(_der_uint(pub.n), _der_uint(pub.e)))


def _utc_time(t: int) -> bytes:
    import time

    return _der(0x17, time.strftime("%y%m%d%H%M%SZ",
                                    time.gmtime(t)).encode("ascii"))


def certificate_der(priv, rng: Optional[random.Random] = None,
                    common_name: str = "cap-tpu-x5c",
                    valid_from: int = 1_700_000_000 - 300,
                    valid_to: int = 1_700_000_000 + 86400,
                    extensions: Tuple[bytes, ...] = ()) -> bytes:
    """A self-signed v3 certificate of ``priv``'s public key, signed
    with sha256WithRSAEncryption, ecdsa-with-SHA256 or Ed25519 by the
    port's integer signers; CN=``common_name`` as issuer and subject.
    By default valid from five minutes before the fixtures' clock
    (``default_claims``) to a day after it. ``extensions`` are DER
    ``Extension`` values (:func:`der_extension`), written as the
    ``[3]`` extensions block when there are any."""
    rng = rng if rng is not None else random.Random()
    pub = priv.public_key()
    if isinstance(priv, RSAPrivateKey):
        sig_alg = _der_seq(_der_oid("1.2.840.113549.1.1.11"), b"\x05\x00")
    elif isinstance(priv, ECPrivateKey):
        sig_alg = _der_seq(_der_oid("1.2.840.10045.4.3.2"))
    else:
        sig_alg = _der_seq(_der_oid("1.3.101.112"))
    name = _der_seq(_der(0x31, _der_seq(
        _der_oid("2.5.4.3"), _der(0x0C, common_name.encode("utf-8")))))
    tbs = _der_seq(
        _der(0xA0, _der_uint(2)),
        _der_uint(rng.getrandbits(159) | 1 << 150),
        sig_alg, name,
        _der_seq(_utc_time(valid_from), _utc_time(valid_to)),
        name, spki_der(pub),
        *([_der(0xA3, _der_seq(*extensions))] if extensions else []))
    if isinstance(priv, RSAPrivateKey):
        k = (priv.n.bit_length() + 7) // 8
        em = pkcs1v15_em(hashlib.sha256(tbs).digest(), "sha256", k)
        sig = priv.raw_sign(int.from_bytes(em, "big")).to_bytes(k, "big")
    elif isinstance(priv, ECPrivateKey):
        cp = curve(priv.crv)
        e = int.from_bytes(hashlib.sha256(tbs).digest(), "big")
        while True:
            try:
                r, s_ = host_ecdsa_sign(priv.crv, priv.d, e,
                                        rng.randrange(1, cp.n))
                break
            except ValueError:
                continue
        sig = _der_seq(_der_uint(r), _der_uint(s_))
    else:
        sig = priv.sign(tbs)
    return _der_seq(tbs, sig_alg, _der(0x03, b"\x00" + sig))


def der_extension(oid: str, value: bytes, critical: bool = False) -> bytes:
    """One X.509 ``Extension``: the OID, the critical flag when set, and
    the DER ``value`` wrapped in an OCTET STRING."""
    return _der_seq(_der_oid(oid),
                    *([_der(0x01, b"\xff")] if critical else []),
                    _der(0x04, value))


def ec_private_key_pem(priv: ECPrivateKey) -> str:
    """The unencrypted PKCS#8 ``PRIVATE KEY`` PEM of an EC key (RFC 5915
    ECPrivateKey with its public point, inside a PrivateKeyInfo)."""
    size = curve(priv.crv).coord_bytes
    nums = priv.public_key().public_numbers()
    point = (b"\x04" + nums.x.to_bytes(size, "big")
             + nums.y.to_bytes(size, "big"))
    ec_key = _der_seq(_der_uint(1), _der(0x04, priv.d.to_bytes(size, "big")),
                      _der(0xA1, _der(0x03, b"\x00" + point)))
    info = _der_seq(_der_uint(0),
                    _der_seq(_der_oid("1.2.840.10045.2.1"),
                             _der_oid(_CURVE_OIDS[priv.crv])),
                    _der(0x04, ec_key))
    return _pem("PRIVATE KEY", info)


def generate_ca(common_name: str = "cap-tpu-test-ca",
                rng: Optional[random.Random] = None
                ) -> Tuple[str, ECPrivateKey, str]:
    """A self-signed P-256 CA for loopback TLS: (certificate PEM, private
    key, PKCS#8 key PEM). Valid from five minutes ago for a day, with
    ``basicConstraints`` CA:TRUE (critical) and a subjectAltName of
    DNS ``localhost`` and IP ``127.0.0.1``, so Python's ``ssl`` serves
    it (``load_cert_chain``) and verifies it as its own trust anchor
    (``utils.http.ssl_context_for_ca``)."""
    import time

    rng = rng if rng is not None else random.Random()
    key = generate_ec_key(rng, "P-256")
    now = int(time.time())
    san = _der_seq(_der(0x82, b"localhost"), _der(0x87, bytes([127, 0, 0, 1])))
    der = certificate_der(
        key, rng, common_name=common_name, valid_from=now - 300,
        valid_to=now + 86400,
        extensions=(der_extension("2.5.29.19", _der_seq(_der(0x01, b"\xff")),
                                  critical=True),
                    der_extension("2.5.29.17", san)))
    return _pem("CERTIFICATE", der), key, ec_private_key_pem(key)


def x5c_jwk(priv, kid: Optional[str] = None, include_params: bool = False,
            rng: Optional[random.Random] = None) -> Dict[str, Any]:
    """A JWK whose key rides an ``x5c`` self-signed certificate
    (:func:`certificate_der`). Without ``include_params`` the n/e or
    x/y members are dropped, so the chain is the only key material."""
    der = certificate_der(priv, rng)
    jwk = serialize_public_key(priv.public_key(), kid=kid)
    jwk["x5c"] = [base64.b64encode(der).decode("ascii")]
    if not include_params:
        for field in ("n", "e", "x", "y"):
            jwk.pop(field, None)
    return jwk


# ---------------------------------------------------------------------------
# Loopback servers
# ---------------------------------------------------------------------------

SERVER_TIMEOUT_S = 10.0


def stop_server(srv, thread=None, timeout: float = SERVER_TIMEOUT_S) -> None:
    """Stop a ``serve_forever`` server within bounded waits: its
    shutdown (which waits for the serving loop to notice), the close of
    its listening socket, then the serving thread's exit."""
    import threading

    stopper = threading.Thread(target=srv.shutdown, daemon=True)
    stopper.start()
    stopper.join(timeout)
    srv.server_close()
    if thread is not None:
        thread.join(timeout)


@contextmanager
def _serve(state: Dict[str, Any], routes):
    """A loopback HTTP server answering GET by ``routes(path, base)`` →
    (status, JSON-able body); every GET increments ``state["fetches"]``.
    ``state["status"]``, when set, answers every GET with that status
    (and the same body); ``state["body"]`` (bytes), when set, replaces
    the JSON body. With ``state["etags"]`` true a 200 carries an ETag
    (a digest of its body) and a GET whose If-None-Match names it is
    answered 304 with no body, counted in ``state["not_modified"]``.
    Yields (base URL, server)."""
    import hashlib
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    state.setdefault("fetches", 0)
    state.setdefault("not_modified", 0)
    base = []

    class Handler(BaseHTTPRequestHandler):
        timeout = SERVER_TIMEOUT_S      # a stalled client frees its thread

        def do_GET(self):
            state["fetches"] += 1
            status, doc = routes(self.path, base[0])
            status = state.get("status") or status
            body = state.get("body") or json.dumps(doc).encode()
            etag = f'"{hashlib.sha256(body).hexdigest()[:16]}"'
            if (status == 200 and state.get("etags")
                    and self.headers.get("If-None-Match") == etag):
                state["not_modified"] += 1
                self.send_response(304)
                self.send_header("ETag", etag)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            if status == 200 and state.get("etags"):
                self.send_header("ETag", etag)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    base.append(f"http://127.0.0.1:{srv.server_address[1]}")
    thread = threading.Thread(target=srv.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    try:
        yield base[0], srv
    finally:
        stop_server(srv, thread)


@contextmanager
def jwks_test_server(state: Dict[str, Any]):
    """Serve ``{"keys": state["keys"]}`` over loopback HTTP, as the JAX
    package's fixture does: mutate ``state["keys"]`` between requests to
    rotate; every GET increments ``state["fetches"]``. Yields
    ``(url, server)``."""
    with _serve(state, lambda path, base: (200, {"keys": state["keys"]})
                ) as (base, srv):
        yield base + "/jwks", srv


@contextmanager
def discovery_test_server(state: Dict[str, Any]):
    """An issuer on loopback HTTP: ``/.well-known/openid-configuration``
    answers ``{"issuer": <base URL>, "jwks_uri": <base URL>/jwks}`` (the
    in-process IdP's discovery document; ``state["discovery"]``, when
    set, is served in its place) and ``/jwks`` answers
    ``{"keys": state["keys"]}``. Every GET increments
    ``state["fetches"]``. Yields ``(issuer, server)``."""
    def routes(path, base):
        if path == "/.well-known/openid-configuration":
            return 200, state.get("discovery",
                                  {"issuer": base, "jwks_uri": base + "/jwks"})
        if path == "/jwks":
            return 200, {"keys": state["keys"]}
        return 404, {"error": "not found"}

    with _serve(state, routes) as served:
        yield served
