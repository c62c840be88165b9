"""RSA keys the RNS engine does not take, on the limb engine, against
the JAX package's TPUBatchKeySet (GPUBatchKeySet on the CPU runs the
plain path), verdicts bit-equal: claims dicts equal, exception class
and message equal.

- ``modexp_vare``: a packed class of keys with e = 3, 17, 65537 and
  2^31 − 1 (31 exponent bits) under RS256 and PS384, with tampered,
  kid-less, unknown-kid and s ∈ {0, 1, n − 1, n} tokens;
- ``modexp_65537`` on limbs: a class of 256 e = 65537 keys (the arrays
  path) one of whose moduli is 4099 · q (4099 is an RNS base prime, so
  ``RNSUnsupportedKey``), under all six RS*/PS* algs, and the same
  modexp limb for limb against the JAX package's on one chunk's shape;
  a class too wide for the RNS prime pool takes the same branch;
- the keyset's construction errors for keys no engine takes.

``test_torch_limb_modexp.py`` has ``modexp_vare`` at 2, 5, 17 and 32
exponent bits, and ``test_torch_keyset_arrays.py`` all six algs over
the mixed-exponent class."""

import base64
import random

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

import jax.numpy as jnp  # noqa: E402

from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402
from cap_tpu.tpu import bignum as jb  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.gpu import bignum as tb  # noqa: E402
from cap_tpu_torch.gpu import limbs as L  # noqa: E402
from cap_tpu_torch.gpu import rsa as gpursa  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402
from cap_tpu_torch.jwt.jose import parse_jws  # noqa: E402

ALGS = ("RS256", "RS384", "RS512", "PS256", "PS384", "PS512")
EXPONENTS = (3, 17, 65537, 2 ** 31 - 1)


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


def _with_sig(token: str, sig: bytes) -> str:
    h, p, _ = token.split(".")
    return f"{h}.{p}.{_b64(sig)}"


def _sig(token: str) -> bytes:
    s = token.split(".")[2]
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return a == b
    return type(a).__name__ == type(b).__name__ and str(a) == str(b)


def _sign(priv, alg, sub, rng, kid):
    return tt.sign_jwt(priv, alg, {"sub": sub}, kid=kid, rng=rng,
                       salt_len=16 if alg.startswith("PS") else None)


def _tampered(token: str) -> str:
    bad = bytearray(_sig(token))
    bad[40] ^= 0x08
    return _with_sig(token, bytes(bad))


def _run(doc, tokens, counted=()):
    """(reference verdicts, port verdicts, calls, port keyset) with the
    port's ``gpu.rsa`` functions ``counted`` counted (the tokens of the
    chunk each call saw)."""
    ref = TPUBatchKeySet(j_jwk.parse_jwks(doc)).verify_batch(tokens)
    calls = {name: [] for name in counted}
    with pytest.MonkeyPatch.context() as mp:
        for name in counted:
            real = getattr(gpursa, name)

            def count(*a, name=name, real=real):
                calls[name].append(len(a[1]) if name.startswith("verify")
                                   else a[0].shape[1])
                return real(*a)

            mp.setattr(gpursa, name, count)
        ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
        port = ks.verify_batch(tokens)
    return ref, port, calls, ks


@pytest.fixture(scope="module")
def vare_batch():
    """One packed 1024-bit class of mixed exponents, RS256 and PS384."""
    rng = random.Random(12)
    keys = [tt.generate_rsa_key(rng, 1024, e=e) for e in EXPONENTS]
    outsider = tt.generate_rsa_key(rng, 1024, e=3)
    doc = {"keys": [t_jwk.serialize_public_key(k.public_key(), kid=f"l-{i}")
                    for i, k in enumerate(keys)]}
    cases = []
    for alg in ("RS256", "PS384"):
        for i, k in enumerate(keys):
            cases.append(("valid", _sign(k, alg, f"{alg}-{i}", rng,
                                         f"l-{i}")))
        cases.append(("tampered", _tampered(cases[-1][1])))
    good = cases[0][1]
    n0 = keys[0].n
    cases += [
        ("no-kid", _sign(keys[3], "RS256", "nk", rng, None)),
        ("unknown-kid-signer-in-set", _sign(keys[1], "PS384", "uk", rng,
                                            "nope")),
        ("unknown-kid-outsider", _sign(outsider, "RS256", "out", rng,
                                       "nope")),
        ("kid-of-other-key", _sign(keys[2], "RS256", "other", rng, "l-0")),
        ("wrong-length", _with_sig(good, _sig(good)[:-1])),
    ] + [(f"s-{name}", _with_sig(good, v.to_bytes(128, "big")))
         for name, v in (("0", 0), ("1", 1), ("n-1", n0 - 1), ("n", n0))]
    labels = [c[0] for c in cases]
    ref, port, calls, ks = _run(doc, [c[1] for c in cases],
                                ("modexp_vare", "modexp_65537"))
    return labels, ref, port, calls, ks


def test_vare_verdicts_bit_equal(vare_batch):
    labels, ref, port, _, _ = vare_batch
    diff = [(lab, r, p) for lab, r, p in zip(labels, ref, port)
            if not _same(r, p)]
    assert not diff
    accepted = {"valid", "no-kid", "unknown-kid-signer-in-set"}
    for lab, out in zip(labels, port):
        assert isinstance(out, dict) == (lab in accepted), (lab, out)


def test_the_mixed_class_runs_modexp_vare(vare_batch):
    """No RNS context: each alg's packed chunk runs ``modexp_vare`` over
    the widest exponent's 31 bits, ``modexp_65537`` never."""
    _, _, _, calls, ks = vare_batch
    (table,) = ks._rsa_tables
    assert (table.all_f4, table.ctx, table.max_ebits) == (False, None, 31)
    assert calls == {"modexp_vare": [128, 128], "modexp_65537": []}


@pytest.fixture(scope="module")
def f4_batch():
    """256 768-bit e = 65537 keys, one of them 4099 · q (row 7): the
    arrays path on the limb branch, all six algs."""
    rng = random.Random(16)
    keys = tt.pool_rsa_keys(tt.prime_pool(24, 384, rng), 256)
    keys[7] = tt.rns_unsupported_key(768, rng)
    doc = {"keys": [t_jwk.serialize_public_key(k.public_key(), kid=f"f-{i}")
                    for i, k in enumerate(keys)]}
    cases = []
    for alg in ALGS:
        for i in (0, 7, 255):
            cases.append(("valid", _sign(keys[i], alg, f"{alg}-{i}", rng,
                                         f"f-{i}")))
        cases.append(("tampered", _tampered(cases[-2][1])))
    cases += [("no-kid", _sign(keys[7], "PS256", "nk", rng, None)),
              ("unknown-kid", _sign(keys[200], "RS384", "uk", rng, "no"))]
    labels = [c[0] for c in cases]
    ref, port, calls, ks = _run(doc, [c[1] for c in cases],
                                ("modexp_65537",
                                 "verify_pkcs1v15_arrays_pending",
                                 "verify_pss_arrays_pending"))
    return labels, ref, port, calls, ks


def test_f4_limb_verdicts_bit_equal(f4_batch):
    labels, ref, port, _, _ = f4_batch
    diff = [(lab, r, p) for lab, r, p in zip(labels, ref, port)
            if not _same(r, p)]
    assert not diff
    for lab, out in zip(labels, port):
        assert isinstance(out, dict) == (lab != "tampered"), (lab, out)


def test_the_unsupported_class_runs_modexp_65537_on_limbs(f4_batch):
    _, _, _, calls, ks = f4_batch
    (table,) = ks._rsa_tables
    assert table.all_f4 and table.ctx is None and table.rtab is None
    assert calls == {"modexp_65537": [128] * 6,
                     "verify_pkcs1v15_arrays_pending": [128] * 3,
                     "verify_pss_arrays_pending": [128] * 3}


def test_modexp_65537_limb_equal(f4_batch):
    """s^65537 mod n at the class's chunk shape ([49, 128]: the JAX
    function's compiled program is the keyset's), with s = 0, 1, n − 1
    and random s < n, equal limb for limb to the JAX package's and to
    ``pow``."""
    _, _, _, _, ks = f4_batch
    (table,) = ks._rsa_tables
    rng = random.Random(17)
    rows = [rng.randrange(256) for _ in range(128)]
    rows[:3] = [7, 7, 7]
    idx = torch.as_tensor(rows)
    mods = [table.n_ints[r] for r in rows]
    s_ints = [0, 1, mods[2] - 1] + [rng.randrange(n) for n in mods[3:]]
    s = np.stack([L.int_to_limbs(v, table.k) for v in s_ints], axis=1)
    cols = [t[idx].T for t in (table.n_tab, table.np_tab, table.r2_tab)]
    ref = np.asarray(jb.modexp_65537(
        jnp.asarray(s), *(jnp.asarray(c.numpy().astype(np.uint32))
                          for c in cols)))
    got = tb.modexp_65537(torch.as_tensor(s.astype(np.int64)), *cols)
    assert np.array_equal(got.numpy(), ref.astype(np.int64))
    assert [L.limbs_to_int(got[:, j].tolist()) for j in range(128)] == \
        [pow(v, 65537, n) for v, n in zip(s_ints, mods)]


def test_packed_f4_limb_class_on_the_host_oracle():
    """A packed class (4 keys) with an RNS-unsupported modulus runs
    ``modexp_65537`` on limbs; its verdicts equal the pure-integer
    oracle's (``jwt.verify``)."""
    rng = random.Random(18)
    keys = [tt.rns_unsupported_key(768, rng)] + [tt.generate_rsa_key(rng, 768)
                                           for _ in range(3)]
    jwks = [t_jwk.JWK(k.public_key(), kid=f"p-{i}")
            for i, k in enumerate(keys)]
    tokens = [_sign(k, alg, f"{alg}-{i}", rng, f"p-{i}")
              for alg in ("RS512", "PS256") for i, k in enumerate(keys)]
    tokens.append(_tampered(tokens[0]))
    ks = GPUBatchKeySet(jwks, device="cpu")
    assert ks._rsa_tables[0].ctx is None
    got = ks.verify_batch(tokens)
    want = [ks._verify_one_parsed(parse_jws(t)) for t in tokens]
    assert all(_same(g, w) for g, w in zip(got, want))
    assert sum(isinstance(g, dict) for g in got) == 8


def _outcome(build, doc):
    try:
        build(doc)
    except Exception as e:  # noqa: BLE001 - compared below
        return type(e)
    return None


@pytest.mark.parametrize("case", ["e-2^32+1", "even-modulus"])
def test_construction_errors_as_the_jax_keyset(case):
    """Keys that parse but that no engine takes raise at keyset build
    the JAX keyset's class: an exponent of 2^32 or more OverflowError
    (the uint32 exponent table), an even modulus ValueError."""
    rng = random.Random(13)
    key = tt.generate_rsa_key(rng, 1024)
    n, e = key.n, 2 ** 32 + 1
    if case == "even-modulus":
        n, e = key.n + 1, 65537
    bad = {"kty": "RSA", "kid": "bad",
           "n": _b64(n.to_bytes(128, "big")),
           "e": _b64(e.to_bytes((e.bit_length() + 7) // 8, "big"))}
    doc = {"keys": [t_jwk.serialize_public_key(key.public_key(), kid="ok"),
                    bad]}
    ref = _outcome(lambda d: TPUBatchKeySet(j_jwk.parse_jwks(d)), doc)
    port = _outcome(
        lambda d: GPUBatchKeySet(t_jwk.parse_jwks(d), device="cpu"), doc)
    want = OverflowError if case == "e-2^32+1" else ValueError
    assert ref is port is want


def test_a_modulus_wider_than_the_prime_pool_runs_on_limbs():
    """The two RNS bases need 2·(nbits + 8) bits of 13-bit primes: a
    class of nine 1,024-bit primes' moduli (over 9,200 bits) exceeds the
    pool, so its e = 65537 keys take the limb branch too, as in the JAX
    table's ``rns()`` (its verdicts: ``test_torch_cuda.py``)."""
    rng = random.Random(15)
    key = tt.MultiPrimeRSAKey(tt.prime_pool(9, 1024, rng))
    table = gpursa.RSAKeyTable([(key.n, 65537)], device="cpu")
    assert key.n.bit_length() > 9200
    assert table.all_f4 and table.ctx is None and table.rtab is None
