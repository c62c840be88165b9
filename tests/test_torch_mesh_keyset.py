"""``GPUBatchKeySet(mesh=)``: every packed chunk sharded over a CPU mesh
(``make_mesh(n, device="cpu")``, the port's counterpart of the JAX
suite's virtual 8-device mesh), the tables replicated.

On ``tests/test_parallel.py``'s mixed batch (2 RS256 and 1 PS256
RSA-1024 keys, 2 P-256 keys, 1 Ed25519 key; 18 tokens, one tampered
RS256 and one tampered PS256 token, garbage), its RSA families over a
mesh of 8 equal the JAX package's ``TPUBatchKeySet(jwks,
mesh=make_mesh(8))`` (claims dicts, exception class and message;
``verify_batch_raw`` too). ML-DSA, ``swap_keys`` and ``GPURemoteKeySet``
over a mesh, the device check and the refusal of a mesh that does not
divide the chunk run on the port alone. The whole mixed batch, its ES
and EdDSA families against the JAX meshed keyset and 128-row ES and
EdDSA chunks over 8 shards are ``tests/test_torch_mesh_keyset_ec.py``,
SLH-DSA ``tests/test_torch_mesh_slhdsa.py``: the JAX keyset compiles
each family's sharded program anew (about 15 s a family here).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu import testing as jt  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402
from cap_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.gpu import mldsa as gpumldsa  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import (  # noqa: E402
    GPUBatchKeySet,
    GPURemoteKeySet,
)
from cap_tpu_torch.parallel import make_mesh  # noqa: E402
from cap_tpu_torch.parallel.mesh import Mesh  # noqa: E402

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
def jax_rsa(fx):
    """The RSA families of the batch (its RS256 and PS256 tokens, the
    two tampered ones, garbage) through the JAX meshed keyset, dict and
    raw."""
    rsa = [t for j, t in enumerate(fx["toks"]) if ALGS[j % 6][0] in "RP"]
    batch = rsa + fx["batch"][-3:]
    jks = TPUBatchKeySet(j_jwk.parse_jwks(fx["doc"]), mesh=j_make_mesh(8))
    return batch, jks.verify_batch(batch), jks.verify_batch_raw(batch)


def test_rsa_families_equal_the_jax_meshed_keyset(fx, jax_rsa):
    batch, want, _ = jax_rsa
    meshed = GPUBatchKeySet(fx["jwks"], device="cpu",
                            mesh=make_mesh(8, device="cpu"))
    _same(meshed.verify_batch(batch), want)


def test_raw_mode_equals_the_jax_meshed_keyset(fx, jax_rsa):
    batch, _, want = jax_rsa
    meshed = GPUBatchKeySet(fx["jwks"], device="cpu",
                            mesh=make_mesh(2, device="cpu"))
    _same(meshed.verify_batch_raw(batch), want)
    assert any(isinstance(r, bytes) for r in want)


def test_mldsa_over_a_mesh():
    """ML-DSA-44/65 through the meshed keyset (the fused engine, one
    shard a device) and the two-phase entry point with ``mesh=``, equal
    to the unmeshed verdicts; a tampered token rejects."""
    jwks, toks, _ = tt.mldsa_fixtures(18, seed=19)   # 44: 0-7, 16-17
    batch = toks + [_tamper(toks[1]), _tamper(toks[9])]
    mesh = make_mesh(2, device="cpu")
    got = GPUBatchKeySet(jwks, device="cpu", mesh=mesh).verify_batch(batch)
    _same(got, GPUBatchKeySet(jwks, device="cpu").verify_batch(batch))
    assert [isinstance(r, dict) for r in got] == [True] * 18 + [False] * 2
    table = gpumldsa.MLDSAKeyTable("ML-DSA-44",
                                   [j.key for j in jwks[:8]], "cpu")
    msgs = [t.rsplit(".", 1)[0].encode() for t in toks[:4:2]]
    sigs = [_unb64(t.rsplit(".", 1)[1]) for t in toks[:4:2]]
    sigs.append(sigs[0][:-1] + bytes([sigs[0][-1] ^ 1]))
    msgs.append(msgs[0])
    rows = np.asarray([0, 2, 0])
    pad = 4
    plain = gpumldsa.verify_mldsa_pending(table, sigs, msgs, rows, pad)()
    sharded = gpumldsa.verify_mldsa_pending(table, sigs, msgs, rows, pad,
                                            mesh=mesh)()
    assert sharded.tolist() == plain.tolist() == [True, True, False, False]
    fused = gpumldsa.verify_mldsa_fused_pending(table, sigs, msgs, rows,
                                                pad, mesh=mesh)
    assert [type(o).__name__ for o in fused.outs] == ["Sharded"] * 2
    assert fused().tolist() == plain.tolist()


def _unb64(s: str) -> bytes:
    import base64

    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def test_swap_keys_and_remote_keyset_over_a_mesh(fx):
    """A swap builds the new epoch on the mesh (its window tables on
    the mesh's device); ``GPURemoteKeySet(mesh=)`` hands the mesh to
    its keyset and to the rotation's rebuild."""
    mesh = make_mesh(2, device="cpu")
    keys = fx["doc"]["keys"]
    ks = GPUBatchKeySet(t_jwk.parse_jwks({"keys": keys[:3]}), device="cpu",
                        mesh=mesh)
    toks = fx["toks"]
    got = ks.verify_batch([toks[0], toks[2], toks[4]])
    assert [isinstance(r, dict) for r in got] == [True, True, False]
    ks.swap_keys({"keys": keys[2:5]}, grace_s=0)
    assert ks._tables.mesh is mesh
    assert sorted(ks._ec_tables["P-256"]._rns) == [8]
    got = ks.verify_batch([toks[0], toks[2], toks[4]])
    assert [isinstance(r, dict) for r in got] == [False, True, True]
    state = {"keys": keys[:2]}
    with tt.jwks_test_server(state) as (url, _):
        rk = GPURemoteKeySet(url, device="cpu", mesh=mesh,
                             min_refresh_interval=0.0)
        assert [isinstance(r, dict) for r in
                rk.verify_batch([toks[0], toks[2]])] == [True, False]
        assert rk._ensure().mesh is mesh
        state["keys"] = keys[:3]
        assert [isinstance(r, dict) for r in
                rk.verify_batch([toks[0], toks[2]])] == [True, True]
        assert rk._ensure().mesh is mesh
        assert rk._ensure()._tables.mesh is mesh


def test_device_follows_the_mesh(fx):
    mesh = make_mesh(2, device="cpu")
    assert GPUBatchKeySet(fx["jwks"], mesh=mesh).device == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="first device"):
        GPUBatchKeySet(fx["jwks"], device="cpu",
                       mesh=Mesh(["cuda:0", "cuda:0"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GPUBatchKeySet(fx["jwks"], mesh=Mesh(["cuda:0", "cuda:0"]))


def test_a_mesh_that_does_not_divide_the_chunk_raises(fx):
    """A 128-row chunk over 3 shards: the shard placement refuses, as
    the JAX keyset's does, and nothing is re-run unsharded."""
    ks = GPUBatchKeySet(fx["jwks"], device="cpu",
                        mesh=make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="divisible by 3"):
        ks.verify_batch(fx["toks"][:2])
