"""ES256 + ES384 (+ ES512): GPUBatchKeySet (plain path on the CPU) with
its own ladder (the whole-ladder kernel's plain version) and with the
per-window ladder swapped in (``ec_rns.ladder_per_window``, one
``madd_ref`` a window), so both ladders run on every curve, against
the JAX package — accepts,
every rejection class of the config-3 cell, the trial path, and
degenerate P-384 lanes re-verified on the oracle — with verdicts
bit-equal: claims dicts equal, exception class and message equal.

The JAX references, by curve: ES256 tokens go through the JAX keyset's
batch path (``TPUBatchKeySet.verify_batch``, its P-256 RNS engine);
ES384 and ES512 tokens through the same keyset's host oracle
(``TPUBatchKeySet.verify_signature``, OpenSSL trial verification): its
jitted P-384/P-521 engines take minutes of CPU to compile (the JAX
suite runs them under ``heavy``/``slow`` only), and the ladder they
would run is held against the port's in ``test_torch_ladder.py``.
"""

import base64
import hashlib
import json
import random

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.gpu import ec_rns  # noqa: E402
from cap_tpu_torch.gpu.ec import (  # noqa: E402
    HostECPublicKey,
    curve,
    scalar_mult,
)
from cap_tpu_torch.jwt import algs  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402
from cap_tpu_torch.jwt.jose import parse_jws  # noqa: E402
from cap_tpu_torch.jwt.verify import verify_parsed  # noqa: E402

CURVES = {algs.ES256: ("P-256", "es"), algs.ES384: ("P-384", "es384"),
          algs.ES512: ("P-521", "es512")}
HASH = {algs.ES256: hashlib.sha256, algs.ES384: hashlib.sha384,
        algs.ES512: hashlib.sha512}
# which ladder every curve runs: the keyset's own (the whole ladder)
# or, swapped in, the per-window one
LADDERS = {"per-curve": False, "swapped": True}


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


def _sig(token: str) -> bytes:
    s = token.split(".")[2]
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _with_sig(token: str, sig: bytes) -> str:
    h, p, _ = token.split(".")
    return f"{h}.{p}.{_b64(sig)}"


def _degenerate_token(alg: str, kid: str, inverse: bool, rng):
    """A token whose two ladder chains meet at the merge, with the key
    derived from the token: Q = (±e/r)·G, so u1·G = ±u2·Q. The same-x
    flag sends it to the oracle, which accepts the doubling case and
    rejects the inverse one (the sum is infinity)."""
    crv, _ = CURVES[alg]
    cp = curve(crv)
    si = (_b64(json.dumps({"alg": alg, "kid": kid}).encode()) + "."
          + _b64(json.dumps({"sub": kid}).encode()))
    e = int.from_bytes(HASH[alg](si.encode()).digest(), "big")
    e >>= max(0, 8 * HASH[alg]().digest_size - cp.nbits)
    k = rng.randrange(1, cp.n)
    r = scalar_mult(cp, k, (cp.gx, cp.gy))[0] % cp.n
    d = (-e if inverse else e) * pow(r, -1, cp.n) % cp.n
    s = (rng.randrange(1, cp.n) if inverse
         else pow(k, -1, cp.n) * (e + r * d) % cp.n)
    cb = cp.coord_bytes
    return (HostECPublicKey.from_private(crv, d),
            si + "." + _b64(r.to_bytes(cb, "big") + s.to_bytes(cb, "big")))


@pytest.fixture(scope="module")
def batch():
    """The JWKS (two keys per curve and two derived P-384 keys) as one
    JWKS document for both packages, and one batch labelled by case."""
    rng = random.Random(31)
    keys = {alg: [tt.generate_ec_key(rng, crv) for _ in range(2)]
            for alg, (crv, _) in CURVES.items()}
    outsider = tt.generate_ec_key(rng, "P-384")
    dbl_key, dbl = _degenerate_token(algs.ES384, "deg-dbl", False, rng)
    inv_key, inv = _degenerate_token(algs.ES384, "deg-inv", True, rng)
    jwks = [t_jwk.JWK(k.public_key(), kid=f"{CURVES[alg][1]}-{i}")
            for alg, ks in keys.items() for i, k in enumerate(ks)]
    jwks += [t_jwk.JWK(dbl_key, kid="deg-dbl"),
             t_jwk.JWK(inv_key, kid="deg-inv")]
    doc = tt.jwks_document(jwks)

    cases = []
    claims = tt.default_claims()
    for alg, ks in keys.items():
        tag = CURVES[alg][1]
        n = CURVES[alg][0]
        cp = curve(n)
        cb = cp.coord_bytes
        good = [tt.sign_jwt(ks[j % 2], alg, dict(claims, sub=f"{tag}-u{j}"),
                            kid=f"{tag}-{j % 2}", rng=rng) for j in range(3)]
        cases += [(f"valid-{alg}", t) for t in good]
        sig = _sig(good[0])
        bad = bytearray(sig)
        bad[len(bad) // 2] ^= 0x10
        cases += [
            (f"tampered-{alg}", _with_sig(good[0], bytes(bad))),
            (f"r-zero-{alg}", _with_sig(good[0], b"\0" * cb + sig[cb:])),
            (f"s-ge-n-{alg}",
             _with_sig(good[1], sig[:cb] + cp.n.to_bytes(cb, "big"))),
            (f"short-{alg}", _with_sig(good[2], _sig(good[2])[:-1])),
            (f"no-kid-{alg}", tt.sign_jwt(ks[1], alg,
                                          dict(claims, sub="nk"), rng=rng)),
            (f"unknown-kid-signer-{alg}",
             tt.sign_jwt(ks[0], alg, claims, kid="nope", rng=rng)),
        ]
    p384 = keys[algs.ES384][0]
    cases += [
        ("es384-over-p256-kid",
         tt.sign_jwt(p384, algs.ES384, claims, kid="es-0", rng=rng)),
        ("unknown-kid-outsider",
         tt.sign_jwt(outsider, algs.ES384, claims, kid="nope", rng=rng)),
        ("degenerate-doubling", dbl),
        ("degenerate-inverse", inv),
    ]
    labels = [c[0] for c in cases]
    tokens = [c[1] for c in cases]

    ref = _jax_reference(doc, tokens)
    port = {name: _port_verdicts(doc, tokens, swap)
            for name, swap in LADDERS.items()}
    return labels, tokens, ref, port


def _port_verdicts(doc, tokens, swap: bool):
    """(verdicts, keyset, curves the ladder ran on) of the port on the
    CPU, with its own ladder or, with ``swap``, the per-window one."""
    ladder = ec_rns.ladder_per_window if swap else ec_rns.cuda_ladder.ladder
    curves = []

    def counted(c, *args):
        curves.append(c.cp.name)
        return ladder(c, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ec_rns.cuda_ladder, "ladder", counted)
        ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
        return ks.verify_batch(tokens), ks, curves


def _jax_reference(doc, tokens):
    """ES256 tokens through the JAX keyset's batch path, the rest
    through its host oracle (see the module docstring)."""
    ks = TPUBatchKeySet(j_jwk.parse_jwks(doc))
    es256 = [i for i, t in enumerate(tokens)
             if parse_jws(t).alg == algs.ES256]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        got = ks.verify_batch([tokens[i] for i in es256])
    ref = [None] * len(tokens)
    for i, out in zip(es256, got):
        ref[i] = out
    for i, tok in enumerate(tokens):
        if ref[i] is None:
            try:
                ref[i] = ks.verify_signature(tok)
            except Exception as e:  # noqa: BLE001 - the verdict
                ref[i] = e
    return ref


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return a == b
    return type(a).__name__ == type(b).__name__ and str(a) == str(b)


@pytest.mark.parametrize("ladders", list(LADDERS))
def test_verdicts_bit_equal(batch, ladders):
    labels, _, ref, port = batch
    diff = [(lab, r, p) for lab, r, p in zip(labels, ref, port[ladders][0])
            if not _same(r, p)]
    assert not diff


def test_the_two_ladders_agree(batch):
    _, _, _, port = batch
    assert all(_same(a, b) for a, b in zip(port["per-curve"][0],
                                           port["swapped"][0]))


def test_each_curve_has_its_ladder(batch):
    """Every curve's chunk runs the whole-ladder kernel (the faster on
    the card, PERF.md): one ladder call a chunk on P-256, P-384 and
    P-521."""
    _, _, _, port = batch
    assert sorted(port["per-curve"][2]) == ["P-256", "P-384", "P-521"]


@pytest.mark.parametrize("ladders", list(LADDERS))
def test_accepts_and_rejects_what_it_should(batch, ladders):
    labels, _, _, port = batch
    for lab, out in zip(labels, port[ladders][0]):
        should = lab.startswith(("valid", "no-kid", "unknown-kid-signer",
                                 "degenerate-doubling"))
        assert isinstance(out, dict) == should, (lab, out)
        if not should:
            assert type(out).__name__ == "InvalidSignatureError"


@pytest.mark.parametrize("ladders", list(LADDERS))
def test_degenerate_p384_lanes_reverify_on_the_oracle(batch, ladders):
    labels, _, _, port = batch
    results, ks, _ = port[ladders]
    assert ks.deg_reverified == 2
    got = dict(zip(labels, results))
    assert got["degenerate-doubling"] == {"sub": "deg-dbl"}


def test_config3_fixtures():
    """8 P-256 and 8 P-384 keys, tokens half ES256 and half ES384,
    each verifying on the oracle under its kid."""
    jwks, tokens, _ = tt.config3_fixtures(16, seed=2)
    assert [j.kid for j in jwks] == [f"es-{i}" for i in range(8)] + \
        [f"es384-{i}" for i in range(8)]
    by_kid = {j.kid: j.key for j in jwks}
    seen = []
    for tok in tokens:
        p = parse_jws(tok)
        verify_parsed(p, by_kid[p.kid])
        seen.append((p.alg, p.kid.split("-")[0]))
    assert seen == [(algs.ES256, "es")] * 8 + [(algs.ES384, "es384")] * 8
    jwks, tokens, _ = tt.es512_fixtures(2, seed=2)
    assert [j.kid for j in jwks] == ["es512-0", "es512-1"]
    assert all(parse_jws(t).alg == algs.ES512 for t in tokens)


@pytest.mark.parametrize("crv", ["P-256", "P-384", "P-521"])
def test_oracle_joint_ladder_equals_the_affine_sum(crv):
    """The oracle's u1·G + u2·Q (one Jacobian double-and-add) equals the
    affine double-and-add sum, on seeded scalars and keys and where the
    running sum meets the added point (doubling) or its negative
    (infinity), Q = ±G, and zero scalars."""
    from cap_tpu_torch.gpu import ec

    cp = curve(crv)
    G = (cp.gx, cp.gy)
    neg = (cp.gx, (-cp.gy) % cp.p)
    two_g = scalar_mult(cp, 2, G)
    rng = random.Random(3)
    cases = [(2, 1, two_g), (2, 1, (two_g[0], (-two_g[1]) % cp.p)),
             (1, 1, G), (1, 1, neg), (0, 5, G), (7, 0, G), (0, 0, G),
             (5, 5, neg), (cp.n - 1, 1, G)]
    for _ in range(40):
        Q = scalar_mult(cp, rng.randrange(1, cp.n), G)
        cases.append((rng.randrange(cp.n), rng.randrange(cp.n), Q))
    for u1, u2, Q in cases:
        want = cp.affine_add(scalar_mult(cp, u1, G), scalar_mult(cp, u2, Q))
        assert ec._shamir(cp, u1, u2, Q) == want, (u1, u2)
