"""``GPUBatchKeySet(mesh=)`` on the EdDSA family, and the whole mixed
batch: ``tests/test_parallel.py``'s batch (2 RS256 and 1 PS256
RSA-1024 keys, 2 P-256 keys, 1 Ed25519 key; 18 tokens round-robin, a
tampered RS256 and a tampered PS256 token, garbage) over a CPU mesh of
4 equal to the unmeshed port keyset's verdicts (raw mode too); its
EdDSA tokens, one of them tampered, and garbage over a mesh of 8 equal
to the JAX package's ``TPUBatchKeySet(jwks, mesh=make_mesh(8))`` under
``CAP_TPU_RNS=1`` (claims dicts, exception class and message,
``verify_batch_raw`` too). ``tests/test_torch_mesh_keyset_ec.py``
holds the ES family.
"""

import json

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu import testing as jt  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402
from cap_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402

from cap_tpu_torch.errors import InvalidSignatureError  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402
from cap_tpu_torch.parallel import make_mesh  # noqa: E402

ALGS = ["RS256", "RS256", "ES256", "ES256", "EdDSA", "PS256"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tamper(tok: str) -> str:
    return tok[:-8] + ("AAAAAAAA" if not tok.endswith("AAAAAAAA")
                       else "BBBBBBBB")


@pytest.fixture(scope="module")
def fx():
    """The JAX package's meshed-keyset fixture: keys m0..m5, 18 tokens
    round-robin over them, then a tampered RS256 token, a tampered
    PS256 token and garbage. ``doc`` is the JWKS both packages parse."""
    keys = [jt.generate_keys(a, **({"rsa_bits": 1024}
                                   if a[:2] in ("RS", "PS") else {}))
            for a in ALGS]
    doc = {"keys": [j_jwk.serialize_public_key(pub, kid=f"m{i}")
                    for i, (_, pub) in enumerate(keys)]}
    claims = jt.default_claims()
    toks = [jt.sign_jwt(keys[j % 6][0], ALGS[j % 6], claims,
                        kid=f"m{j % 6}") for j in range(18)]
    batch = toks + [_tamper(toks[0]), _tamper(toks[5]), "garbage"]
    return dict(doc=doc, toks=toks, batch=batch,
                jwks=t_jwk.parse_jwks(doc))


def _same(got, want):
    """Verdict lists equal: dicts equal, exceptions of one class and
    message."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, BaseException):
            assert type(g).__name__ == type(w).__name__, (i, g, w)
            assert str(g) == str(w), (i, g, w)
        else:
            assert g == w, (i, g, w)


def test_mixed_batch_over_a_mesh_equals_the_unmeshed_keyset(fx):
    meshed = GPUBatchKeySet(fx["jwks"], device="cpu",
                            mesh=make_mesh(4, device="cpu"))
    plain = GPUBatchKeySet(fx["jwks"], device="cpu")
    got = meshed.verify_batch(fx["batch"])
    _same(got, plain.verify_batch(fx["batch"]))
    assert all(isinstance(r, dict) for r in got[:18])
    assert isinstance(got[-3], InvalidSignatureError)
    assert isinstance(got[-2], InvalidSignatureError)    # tampered PS256
    assert isinstance(got[-1], Exception)
    raws = meshed.verify_batch_raw(fx["batch"])
    for r, d in zip(raws, got):
        if isinstance(d, Exception):
            assert type(r) is type(d)
        else:
            assert json.loads(r) == d


@pytest.fixture(scope="module")
def jax_ed(fx):
    """The batch's EdDSA tokens, one of them tampered, and garbage
    through the JAX meshed keyset on its RNS engines, dict and raw."""
    fam = [t for j, t in enumerate(fx["toks"]) if ALGS[j % 6] == "EdDSA"]
    batch = fam + [_tamper(fam[0]), "garbage"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        jks = TPUBatchKeySet(j_jwk.parse_jwks(fx["doc"]),
                             mesh=j_make_mesh(8))
        return batch, jks.verify_batch(batch), jks.verify_batch_raw(batch)


def test_ed_family_equals_the_jax_meshed_keyset(fx, jax_ed):
    batch, want, _ = jax_ed
    meshed = GPUBatchKeySet(fx["jwks"], device="cpu",
                            mesh=make_mesh(8, device="cpu"))
    _same(meshed.verify_batch(batch), want)
    assert [isinstance(r, dict) for r in want] == [True] * 3 + [False] * 2


def test_ed_raw_mode_equals_the_jax_meshed_keyset(fx, jax_ed):
    batch, _, want = jax_ed
    meshed = GPUBatchKeySet(fx["jwks"], device="cpu",
                            mesh=make_mesh(2, device="cpu"))
    _same(meshed.verify_batch_raw(batch), want)
