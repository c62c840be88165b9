"""The limb ECDSA engine's affine ladder (``gpu.ec._ecdsa_affine_tail``,
the entry points' ``rns=False, ladder="affine"``) against the JAX package's,
live: the edge vectors of ``tests/test_ec_affine.py`` on P-256
(``testing.ec_edge_vectors``, the same seed) through both packages'
``verify_ecdsa_batch``: verdicts equal to the JAX entry point's and its
oracle's, the merge's doubling and inverse flagged for the oracle, the
accept bits outside the flagged lanes the oracle's. The JAX side runs
with ``CAP_TPU_RNS=0``. (One JAX engine a file: its compile on the CPU
costs tens of seconds.)
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


@pytest.fixture(scope="module")
def p256():
    key, names, sigs, digs = tt.ec_edge_vectors("P-256")
    nums = key.public_numbers()
    jtab = jec.ECKeyTable("P-256",
                          [jec.HostECPublicKey("P-256", nums.x, nums.y)])
    want = [jec._py_verify_one(jtab, 0, sg, dg) for sg, dg in zip(sigs, digs)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "0")
        jax_ok = jec.verify_ecdsa_batch(jtab, sigs, digs,
                                        np.zeros(len(sigs), np.int32),
                                        ladder="affine")
    table = gpuec.ECKeyTable("P-256", [key], device="cpu")
    raw = []
    pending = gpuec.verify_ecdsa_arrays_pending

    def record(*a, **k):
        ok, deg = pending(*a, **k)
        raw.append((ok.numpy()[:len(sigs)], deg.numpy()[:len(sigs)]))
        return ok, deg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpuec, "verify_ecdsa_arrays_pending", record)
        port_ok = gpuec.verify_ecdsa_batch(table, sigs, digs,
                                           np.zeros(len(sigs), np.int64),
                                           ladder="affine", rns=False)
    return dict(names=names, want=want, jax_ok=jax_ok, port_raw=raw[0],
                port_ok=port_ok)


def test_verdicts_equal_the_jax_limb_affine_ladder_and_its_oracle(p256):
    names, want = p256["names"], p256["want"]
    port = [bool(v) for v in p256["port_ok"]]
    jax_ = [bool(v) for v in p256["jax_ok"]]
    assert port == jax_ == want, [
        (n, p, j, w) for n, p, j, w in zip(names, port, jax_, want)
        if not p == j == w]


def test_only_the_merge_degenerates(p256):
    """A chain of one scalar never meets its own window multiple: the
    flags are exactly the merge's doubling and inverse."""
    pok, pdeg = p256["port_raw"]
    assert {n for n, f in zip(p256["names"], pdeg) if f} == {
        "deg-double-merge", "deg-inverse-merge"}
    want = np.asarray(p256["want"])
    assert (pok[~pdeg] == want[~pdeg]).all()
