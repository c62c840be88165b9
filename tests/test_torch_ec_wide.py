"""The limb ECDSA engine on P-384 and P-521, both window-add laws, held
against the JAX package's pure-integer oracle
(``cap_tpu.tpu.ec._py_verify_one``) and not against its limb engine,
whose jitted P-384 and P-521 programs take minutes of CPU to compile:
the edge vectors of ``tests/test_ec_affine.py`` on each curve
(``testing.ec_edge_vectors``, the same seeds) through the verify core
at 16 lanes, flagged lanes re-verified on the oracle as the entry
points do; the limb window tables against the JAX package's host rows.
"""

import numpy as np
import pytest
import torch

from cap_tpu.tpu import ec as jec

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import ec as gpuec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["P-384", "P-521"])
def curve_case(request):
    crv = request.param
    key, names, sigs, digs = tt.ec_edge_vectors(crv)
    nums = key.public_numbers()
    jtab = jec.ECKeyTable(crv, [jec.HostECPublicKey(crv, nums.x, nums.y)])
    want = [jec._py_verify_one(jtab, 0, sg, dg) for sg, dg in zip(sigs, digs)]
    return crv, key, names, sigs, digs, want


@pytest.mark.parametrize("ladder", ["jacobian", "affine"])
def test_limb_ladders_equal_the_jax_oracle(curve_case, ladder):
    crv, key, names, sigs, digs, want = curve_case
    table = gpuec.ECKeyTable(crv, [key], device="cpu")
    cp = table.curve
    n, lanes = len(sigs), 16
    sig = np.zeros((lanes, 2 * cp.coord_bytes), np.uint8)
    sig[:n] = np.frombuffer(b"".join(sigs), np.uint8).reshape(n, -1)
    dig = np.zeros((lanes, len(digs[0])), np.uint8)
    dig[:n] = np.frombuffer(b"".join(digs), np.uint8).reshape(n, -1)
    r, s, e = gpuec._ec_prep(torch.from_numpy(sig), torch.from_numpy(dig),
                             cp.k)
    ok, deg = gpuec._ecdsa_core(r, s, e, torch.zeros(lanes, dtype=torch.int64),
                                *table.limb_tables(), cp, ladder=ladder)
    ok, deg = ok.numpy()[:n].copy(), deg.numpy()[:n]
    for j in np.nonzero(deg)[0]:
        ok[j] = gpuec._py_verify_one(table, 0, sigs[j], digs[j])
    got = [bool(v) for v in ok]
    assert got == want, [(nm, g, w) for nm, g, w in zip(names, got, want)
                         if g != w]
    assert "deg-inverse-merge" in {nm for nm, f in zip(names, deg) if f}


def test_limb_rows_equal_the_jax_table(curve_case):
    """The key's rows byte-equal to the JAX table's (its per-row affine
    chain against the port's shared-inversion one)."""
    crv, key, *_ = curve_case
    tqx, tqy = gpuec.ECKeyTable(crv, [key], device="cpu").limb_tables()
    nums = key.public_numbers()
    jtab = jec.ECKeyTable(crv, [jec.HostECPublicKey(crv, nums.x, nums.y)])
    assert (tqx.numpy() == np.asarray(jtab.tqx)).all()
    assert (tqy.numpy() == np.asarray(jtab.tqy)).all()
