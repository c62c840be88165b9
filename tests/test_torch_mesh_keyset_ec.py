"""``GPUBatchKeySet(mesh=)`` on the ES family: the ES256 tokens of
``tests/test_parallel.py``'s mixed batch (2 RS256 and 1 PS256 RSA-1024
keys, 2 P-256 keys, 1 Ed25519 key; 18 tokens round-robin), one of them
tampered, and garbage, over a CPU mesh of 8, equal to the JAX package's
``TPUBatchKeySet(jwks, mesh=make_mesh(8))`` under ``CAP_TPU_RNS=1``
(its RNS engines, the port's; claims dicts, exception class and
message, ``verify_batch_raw`` too); a 128-row ES chunk and a 128-row
EdDSA chunk over 8 shards, 16 lanes a shard, each shard its own batch
inverse root. ``tests/test_torch_mesh_keyset.py`` holds the RSA
families, ML-DSA and the keyset's mesh surface,
``tests/test_torch_mesh_keyset_ed.py`` the EdDSA family and the whole
mixed batch (the JAX keyset compiles each family's sharded program
anew: 10–30 s a family here).
"""

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu import testing as jt  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402
from cap_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402

from cap_tpu_torch.gpu import bignum  # noqa: E402
from cap_tpu_torch.gpu import ec as gpuec  # noqa: E402
from cap_tpu_torch.gpu import ed25519 as gpued  # noqa: E402
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


@pytest.fixture(scope="module")
def jax_es(fx):
    """The batch's ES256 tokens, one of them tampered, and garbage
    through the JAX meshed keyset on its RNS engines, dict and raw."""
    fam = [t for j, t in enumerate(fx["toks"]) if ALGS[j % 6] == "ES256"]
    batch = fam + [_tamper(fam[0]), "garbage"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        jks = TPUBatchKeySet(j_jwk.parse_jwks(fx["doc"]),
                             mesh=j_make_mesh(8))
        return batch, jks.verify_batch(batch), jks.verify_batch_raw(batch)


def test_es_family_equals_the_jax_meshed_keyset(fx, jax_es):
    batch, want, _ = jax_es
    meshed = GPUBatchKeySet(fx["jwks"], device="cpu",
                            mesh=make_mesh(8, device="cpu"))
    _same(meshed.verify_batch(batch), want)
    assert [isinstance(r, dict) for r in want] == [True] * 6 + [False] * 2


def test_es_raw_mode_equals_the_jax_meshed_keyset(fx, jax_es):
    batch, _, want = jax_es
    meshed = GPUBatchKeySet(fx["jwks"], device="cpu",
                            mesh=make_mesh(2, device="cpu"))
    _same(meshed.verify_batch_raw(batch), want)


def test_es_and_ed_chunks_of_128_rows_over_8_shards(fx, monkeypatch):
    """A 128-row ES chunk and a 128-row EdDSA chunk over 8 shards: each
    shard's core runs on 16 lanes (its own batch inverse root), in
    batch order, every shard's work queued up to its root before any
    shard reads its root, and the verdicts equal the unmeshed
    keyset's."""
    toks = [t for j, t in enumerate(fx["toks"]) if ALGS[j % 6] in
            ("ES256", "EdDSA")]
    toks += [_tamper(toks[0]), _tamper(toks[2])]
    lanes = {"es": [], "ed": []}
    roots = []
    es_steps, ed_steps = gpuec._es_steps, gpued._ed_steps
    inv_steps = bignum.batch_mont_inverse_steps

    def es_spy(sig, *a, **k):
        lanes["es"].append(sig.shape[0])
        return es_steps(sig, *a, **k)

    def ed_spy(packed, *a, **k):
        lanes["ed"].append(packed.shape[0])
        return ed_steps(packed, *a, **k)

    def inv_spy(*a, **k):
        roots.append("queued")
        out = yield from inv_steps(*a, **k)
        roots.append("read")
        return out

    monkeypatch.setattr(gpuec, "_es_steps", es_spy)
    monkeypatch.setattr(gpued, "_ed_steps", ed_spy)
    monkeypatch.setattr(bignum, "batch_mont_inverse_steps", inv_spy)
    meshed = GPUBatchKeySet(fx["jwks"], device="cpu",
                            mesh=make_mesh(8, device="cpu"))
    got = meshed.verify_batch(toks)
    assert lanes == {"es": [16] * 8, "ed": [16] * 8}
    # the ES chunk, then the EdDSA chunk: each shard reaches its root
    # before any shard reads one
    assert roots == (["queued"] * 8 + ["read"] * 8) * 2
    # the shards read the keyset's own window tables: built once
    assert sorted(meshed._ec_tables["P-256"]._rns) == [8]
    assert meshed._ed_table._rns is not None
    _same(got, GPUBatchKeySet(fx["jwks"], device="cpu").verify_batch(toks))
    assert [isinstance(r, dict) for r in got] == [True] * 9 + [False] * 2
