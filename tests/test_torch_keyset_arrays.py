"""RSA key classes of more than 255 keys (the arrays path, its key rows
an int64 tensor) against the JAX package: a class of 255 keys (the
packed path) and one of 256 (the arrays path) with e = 3, 17, 65537
and 2^31 − 1, verdicts of
GPUBatchKeySet (plain path on the CPU) bit-equal to TPUBatchKeySet's
on both sides, the path each batch took counted; all six RS*/PS* algs
on the arrays side. (P-256 and Ed25519 classes at the boundary:
``test_torch_keyset_arrays_ec.py`` and
``test_torch_keyset_arrays_ed.py``.)"""

import base64
import random

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.gpu import rsa as gpursa  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402

ALGS = ("RS256", "RS384", "RS512", "PS256", "PS384", "PS512")
EXPONENTS = (3, 17, 65537, 2 ** 31 - 1)
PATHS = ("verify_rs_packed_pending", "verify_ps_packed_pending",
         "verify_pkcs1v15_arrays_pending", "verify_pss_arrays_pending")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return a == b
    return type(a).__name__ == type(b).__name__ and str(a) == str(b)


def _sign(priv, alg, sub, rng, kid):
    return tt.sign_jwt(priv, alg, {"sub": sub}, kid=kid, rng=rng,
                       salt_len=16 if alg.startswith("PS") else None)


def _tampered(token: str) -> str:
    h, p, s = token.split(".")
    sig = bytearray(base64.urlsafe_b64decode(s + "=" * (-len(s) % 4)))
    sig[40] ^= 0x08
    return f"{h}.{p}.{_b64(bytes(sig))}"


@pytest.fixture(scope="module")
def keys():
    """257 768-bit keys, products of pairs of 24 pooled primes (each
    p − 1 prime to every exponent), exponents cycling 3, 17, 65537,
    2^31 − 1 by row; the last one signs the outsider's tokens."""
    rng = random.Random(21)
    return tt.pool_rsa_keys(tt.prime_pool(24, 384, rng, EXPONENTS), 257,
                            EXPONENTS)


def _run(keys, n_keys, cases):
    """Both keysets over the first ``n_keys`` keys: (labels, reference
    verdicts, port verdicts, calls of each path, port keyset)."""
    doc = {"keys": [t_jwk.serialize_public_key(k.public_key(), kid=f"r-{i}")
                    for i, k in enumerate(keys[:n_keys])]}
    tokens = [c[1] for c in cases]
    ref = TPUBatchKeySet(j_jwk.parse_jwks(doc)).verify_batch(tokens)
    calls = dict.fromkeys(PATHS, 0)
    with pytest.MonkeyPatch.context() as mp:
        for name in PATHS:
            def count(*a, name=name, real=getattr(gpursa, name)):
                calls[name] += 1
                return real(*a)

            mp.setattr(gpursa, name, count)
        ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
        port = ks.verify_batch(tokens)
    return [c[0] for c in cases], ref, port, calls, ks


def _specials(keys, n_keys, rng):
    out = keys[-1]
    return [("tampered", _tampered(_sign(keys[1], "RS256", "t", rng,
                                         "r-1"))),
            ("no-kid", _sign(keys[2], "RS256", "nk", rng, None)),
            ("unknown-kid-signer-in-set",
             _sign(keys[n_keys - 1], "RS256", "uk", rng, "nope")),
            ("unknown-kid-outsider", _sign(out, "RS256", "o", rng, "nope")),
            ("kid-of-other-key", _sign(keys[3], "RS256", "x", rng, "r-0"))]


@pytest.fixture(scope="module")
def packed_255(keys):
    rng = random.Random(22)
    cases = [("valid", _sign(keys[i], "RS256", f"v-{i}", rng, f"r-{i}"))
             for i in (0, 1, 2, 3, 254)]
    return _run(keys, 255, cases + _specials(keys, 255, rng))


@pytest.fixture(scope="module")
def arrays_256(keys):
    rng = random.Random(23)
    cases = [("valid", _sign(keys[i], alg, f"{alg}-{i}", rng, f"r-{i}"))
             for alg in ALGS for i in (0, 1, 2, 3, 255)]
    cases += [("tampered", _tampered(_sign(keys[i], alg, "t", rng,
                                           f"r-{i}")))
              for i, alg in enumerate(ALGS)]
    return _run(keys, 256, cases + _specials(keys, 256, rng))


@pytest.mark.parametrize("side", ["packed_255", "arrays_256"])
def test_verdicts_bit_equal(side, request):
    labels, ref, port, _, _ = request.getfixturevalue(side)
    diff = [(lab, r, p) for lab, r, p in zip(labels, ref, port)
            if not _same(r, p)]
    assert not diff
    accepted = {"valid", "no-kid", "unknown-kid-signer-in-set"}
    for lab, out in zip(labels, port):
        assert isinstance(out, dict) == (lab in accepted), (lab, out)


def test_255_keys_take_the_packed_path(packed_255):
    _, _, _, calls, ks = packed_255
    assert len(ks._rsa_tables[0].n_ints) == 255
    assert calls == {"verify_rs_packed_pending": 1,
                     "verify_ps_packed_pending": 0,
                     "verify_pkcs1v15_arrays_pending": 0,
                     "verify_pss_arrays_pending": 0}


def test_256_keys_take_the_arrays_path(arrays_256):
    """One chunk per alg, each on the arrays path, the class on
    ``modexp_vare`` (31 exponent bits)."""
    _, _, _, calls, ks = arrays_256
    (table,) = ks._rsa_tables
    assert len(table.n_ints) == 256 and table.max_ebits == 31
    assert calls == {"verify_rs_packed_pending": 0,
                     "verify_ps_packed_pending": 0,
                     "verify_pkcs1v15_arrays_pending": 3,
                     "verify_pss_arrays_pending": 3}
