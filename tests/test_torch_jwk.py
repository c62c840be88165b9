"""The port's JWK checks against the JAX package's, live: RSA n and e
with ``cryptography``'s checks, words and order (the port's refusal of
an even modulus at keyset build time is the JAX keyset's), and the
split between the JAX package's two EC JWK routes, pinned so that a
change to either shows."""

import base64
import random

import pytest

pytest.importorskip("cryptography")

from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402

from cap_tpu_torch.errors import InvalidJWKSError  # noqa: E402
from cap_tpu_torch.gpu.ec import curve  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402


def _b64(v: int, size: int = 0) -> str:
    raw = v.to_bytes(max(size, 1, (v.bit_length() + 7) // 8), "big")
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


def _outcome(parse, doc):
    """(class name, message) of a refusal, or the parsed key's numbers."""
    try:
        key = parse(doc).key
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    nums = key.public_numbers() if hasattr(key, "public_numbers") else key
    if hasattr(nums, "n"):
        return "key", (nums.n, nums.e)
    return "key", (nums.x, nums.y)


# ROADMAP §C.1's five cases, then n = 1 and n = 3
RSA_CASES = [(65535, 65537), (15, 17), (16, 3), (15, 4), (15, 1), (1, 3),
             (3, 3)]


@pytest.mark.parametrize("n,e", RSA_CASES)
def test_rsa_checks_as_the_jax_parser(n, e):
    doc = {"kty": "RSA", "n": _b64(n), "e": _b64(e)}
    want = _outcome(j_jwk.parse_jwk, doc)
    got = _outcome(t_jwk.parse_jwk, doc)
    assert got == want


def test_rsa_checks_messages():
    """The three messages, each raised as ``InvalidJWKSError``."""
    for (n, e), msg in (((1, 3), "n must be >= 3."),
                        ((65535, 65537), "e must be >= 3 and < n."),
                        ((15, 4), "e must be odd.")):
        with pytest.raises(InvalidJWKSError) as exc:
            t_jwk.parse_jwk({"kty": "RSA", "n": _b64(n), "e": _b64(e)})
        assert str(exc.value) == f"invalid RSA jwk: {msg}"


def test_even_modulus_refused_at_build_as_the_jax_keyset():
    """An even 2048-bit modulus parses in both packages and reaches the
    keyset, which refuses it with the JAX keyset's class and message."""
    rng = random.Random(5)
    n = (rng.getrandbits(2048) | 1 << 2047) & ~1
    doc = {"kty": "RSA", "n": _b64(n), "e": _b64(65537), "kid": "even"}
    outcomes = []
    for build in (lambda: TPUBatchKeySet([j_jwk.parse_jwk(doc)]),
                  lambda: GPUBatchKeySet([t_jwk.parse_jwk(doc)],
                                         device="cpu")):
        with pytest.raises(Exception) as exc:
            build()
        outcomes.append((type(exc.value), str(exc.value)))
    assert outcomes[0] == outcomes[1] == (ValueError, "modulus must be odd")


def test_ec_split_pinned():
    """The JAX package's two EC routes disagree on a coordinate ≥ p: its
    ``cryptography`` route reduces x = Gx + p mod p and accepts G, its
    crypto-less route (the port's) rejects. Off-curve keys get different
    messages on the two routes."""
    cp = curve("P-256")
    wide = {"kty": "EC", "crv": "P-256", "x": _b64(cp.gx + cp.p),
            "y": _b64(cp.gy, 32)}
    key = j_jwk.parse_jwk(wide).key
    assert (key.public_numbers().x, key.public_numbers().y) == (cp.gx, cp.gy)
    assert _outcome(t_jwk.parse_jwk, wide) == (
        "InvalidJWKSError", "invalid EC jwk: point is not on curve P-256")
    off = {"kty": "EC", "crv": "P-256", "x": _b64(cp.gx, 32),
           "y": _b64(cp.gy + 1, 32)}
    assert _outcome(j_jwk.parse_jwk, off) == (
        "InvalidJWKSError",
        "invalid EC jwk: Invalid EC key. Point is not on the curve "
        "specified.")
    assert _outcome(t_jwk.parse_jwk, off) == (
        "InvalidJWKSError", "invalid EC jwk: point is not on curve P-256")
    on = {"kty": "EC", "crv": "P-256", "x": _b64(cp.gx, 32),
          "y": _b64(cp.gy, 32)}
    assert _outcome(t_jwk.parse_jwk, on) == _outcome(j_jwk.parse_jwk, on)
