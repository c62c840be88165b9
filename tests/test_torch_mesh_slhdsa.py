"""SLH-DSA over a mesh: ``gpu.slhdsa.verify_slhdsa_batch(...,
mesh=make_mesh(2, device="cpu"))`` shards the arrays whose axis 0 is
the chunk's ``pad`` rows and replicates the layer-major ones, as the
JAX package's ``mesh=`` does; each shard's hash forest runs over its
own columns. Verdicts equal the host oracle's on a seeded 128f key's
signatures (a valid one, a tampered one, a wrong-length one, one under
the wrong key row), and a meshed keyset's verdicts equal the unmeshed
keyset's. SLH-DSA's plain Keccak path is slow on the CPU (about 9 s a
16-row 128f chunk), so the keyset half runs one chunk a keyset.
"""

import random

import numpy as np
import pytest
import torch

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import slhdsa
from cap_tpu_torch.jwt import algs
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
from cap_tpu_torch.jwt.jwk import JWK
from cap_tpu_torch.parallel import make_mesh
from cap_tpu_torch.parallel.place import Sharded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx():
    rng = random.Random(128)
    keys = [slhdsa.keygen(algs.SLHDSA128F, rng.randbytes(32))
            for _ in range(2)]
    claims = tt.default_claims()
    toks = [tt.sign_jwt(keys[j][0], algs.SLHDSA128F,
                        dict(claims, sub=f"s{j}"), kid=f"slh-{j}")
            for j in range(2)]
    return keys, toks


def _parts(tok):
    import base64

    si, sig = tok.rsplit(".", 1)
    return si.encode(), base64.urlsafe_b64decode(sig + "=" * (-len(sig) % 4))


def test_slhdsa_engine_over_a_mesh_equals_the_oracle(fx):
    keys, toks = fx
    table = slhdsa.SLHDSAKeyTable(algs.SLHDSA128F,
                                  [k[1] for k in keys], "cpu")
    (m0, s0), (m1, s1) = _parts(toks[0]), _parts(toks[1])
    sigs = [s0, s1, s0[:-1] + bytes([s0[-1] ^ 1]), s0[:-1], s1]
    msgs = [m0, m1, m0, m0, m1]
    rows = np.asarray([0, 1, 0, 0, 0])
    mesh = make_mesh(2, device="cpu")
    out = slhdsa.verify_slhdsa_pending(table, sigs, msgs, rows, mesh=mesh)
    assert isinstance(out, Sharded)
    assert [tuple(p.shape) for p in out.parts] == [(8,), (8,)]
    want = [slhdsa.py_verify(keys[r][1], s, m)
            for s, m, r in zip(sigs, msgs, rows)]
    assert want == [True, True, False, False, False]
    assert out.cpu().numpy()[:5].tolist() == want
    assert slhdsa.verify_slhdsa_batch(table, sigs[3:4], msgs[3:4],
                                      rows[3:4], mesh=mesh).tolist() == \
        [False]


def test_slhdsa_keyset_over_a_mesh_equals_the_unmeshed(fx):
    keys, toks = fx
    jwks = [JWK(k[1], kid=f"slh-{j}") for j, k in enumerate(keys)]
    batch = toks + [toks[0][:-8] + "AAAAAAAA"]
    got = GPUBatchKeySet(jwks, device="cpu",
                         mesh=make_mesh(2, device="cpu")).verify_batch(batch)
    want = GPUBatchKeySet(jwks, device="cpu").verify_batch(batch)
    assert [type(r).__name__ for r in got] == [type(r).__name__
                                               for r in want]
    assert got[:2] == want[:2] and isinstance(got[0], dict)
    assert str(got[2]) == str(want[2])
