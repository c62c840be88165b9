"""The RNS affine ladder (``gpu.ec_rns.affine_ladder``, the entry
points' ``ladder="affine"``) against the JAX package's, live: the edge
vectors of ``tests/test_ec_affine.py`` on P-256 (``testing.
ec_edge_vectors``, the same seed) through ``verify_ecdsa_batch`` on
both packages, the port running the plain REDC; verdicts equal to the
JAX entry point's and its oracle's, the true degeneracies (the merge's
doubling and inverse) flagged; one REDC a multiply, counted. The JAX
side runs with ``CAP_TPU_RNS=1``. The port's batch inversion raises its
root to p − 2 by a square each bit and a multiply each 1 bit, the JAX
package's multiplies at every bit and selects: one value, other residue
representatives, so the 2-channel same-x probe may raise other false
positives (each only costs an oracle re-verify).
``tests/test_torch_ec_helpers.py`` holds the inversion and three
windows of the ladder on P-384 and P-521.
"""

import numpy as np
import pytest
import torch

from cap_tpu.tpu import ec as jec

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import cuda_redc
from cap_tpu_torch.gpu import ec as gpuec
from cap_tpu_torch.gpu import ec_rns


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
        mp.setenv("CAP_TPU_RNS", "1")
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

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpuec, "verify_ecdsa_arrays_pending", record)
        # every REDC of the path is cuda_redc.redc, which runs redc_ref
        # on a CPU tensor
        redc_ref = cuda_redc.redc_ref
        mp.setattr(cuda_redc, "redc_ref",
                   lambda *a: calls.append(1) or redc_ref(*a))
        mp.setattr(ec_rns.cuda_ladder, "ladder", None)   # never called
        port_ok = gpuec.verify_ecdsa_batch(table, sigs, digs,
                                           np.zeros(len(sigs), np.int64),
                                           ladder="affine", rns=True)
    return dict(names=names, want=want, jax_ok=jax_ok,
                port_raw=raw[0], port_ok=port_ok, redc_calls=len(calls))


def test_verdicts_equal_the_jax_affine_ladder_and_its_oracle(p256):
    names, want = p256["names"], p256["want"]
    port = [bool(v) for v in p256["port_ok"]]
    jax_ = [bool(v) for v in p256["jax_ok"]]
    assert port == jax_ == want, [
        (n, p, j, w) for n, p, j, w in zip(names, port, jax_, want)
        if not p == j == w]


def test_true_degeneracies_flagged(p256):
    """The merge's doubling and inverse raise the same-x flag (the JAX
    affine ladder flags both too, ``tests/test_ec_affine.py``); outside
    the flagged lanes the device accepts exactly what the oracle
    accepts."""
    pok, pdeg = p256["port_raw"]
    assert {"deg-double-merge", "deg-inverse-merge"} <= {
        n for n, f in zip(p256["names"], pdeg) if f}
    want = np.asarray(p256["want"])
    assert (pok[~pdeg] == want[~pdeg]).all()


def test_every_multiply_is_one_redc(p256):
    """W·(2·log2(M/128) + pbits + popcount(p − 2) + 2) for the ladder
    (W = 32 windows, M = 256 lanes), then 11 for the merge and the
    projective check: 32·(2 + 256 + 128 + 2) + 11 on P-256."""
    assert p256["redc_calls"] == ec_rns.affine_redc_launches("P-256", 128) \
        == 32 * (2 + 256 + 128 + 2) + 11
