"""The RNS affine ladder at 12-bit windows (``ladder="affine",
w_bits=12`` of ``gpu.ec``'s entry points) against the JAX package's
under ``CAP_TPU_RNS=1`` and ``CAP_TPU_EC_WBITS=12``, live, on the P-256
edge vectors (``testing.ec_edge_vectors``): verdicts equal to the JAX
entry point's and to both oracles, the merge's doubling and inverse
flagged, one REDC a multiply over the 22 windows
(``ec_rns.affine_redc_launches``). ``tests/test_torch_ec_affine.py``
holds the 8-bit ladder, ``tests/test_torch_ec_w12.py`` the Jacobian
one at 12 bits.
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
        mp.setenv("CAP_TPU_EC_WBITS", "12")
        jax_ok = jec.verify_ecdsa_batch(jtab, sigs, digs,
                                        np.zeros(len(sigs), np.int32),
                                        ladder="affine")
        assert jtab.rns().ctx.w_bits == 12
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
        redc_ref = cuda_redc.redc_ref
        mp.setattr(cuda_redc, "redc_ref",
                   lambda *a: calls.append(1) or redc_ref(*a))
        mp.setattr(ec_rns.cuda_ladder, "ladder", None)   # never called
        port_ok = gpuec.verify_ecdsa_batch(table, sigs, digs,
                                           np.zeros(len(sigs), np.int64),
                                           ladder="affine", w_bits=12)
    return dict(names=names, want=want, jax_ok=jax_ok, table=table,
                port_raw=raw[0], port_ok=port_ok, redc_calls=len(calls),
                oracle=[gpuec._py_verify_one(table, 0, sg, dg)
                        for sg, dg in zip(sigs, digs)])


def test_w12_affine_verdicts_equal_jax_and_both_oracles(p256):
    port = [bool(v) for v in p256["port_ok"]]
    jax_ = [bool(v) for v in p256["jax_ok"]]
    assert port == jax_ == p256["want"] == p256["oracle"], [
        (n, p, j, w) for n, p, j, w in zip(p256["names"], port, jax_,
                                           p256["want"]) if not p == j == w]


def test_w12_affine_true_degeneracies_flagged(p256):
    pok, pdeg = p256["port_raw"]
    assert {"deg-double-merge", "deg-inverse-merge"} <= {
        n for n, f in zip(p256["names"], pdeg) if f}
    want = np.asarray(p256["want"])
    assert (pok[~pdeg] == want[~pdeg]).all()


def test_w12_affine_every_multiply_is_one_redc(p256):
    """22 windows of (2·log2(256/128) + 256 + popcount(p − 2) + 2) REDCs
    over M = 256 lanes, then 11 for the merge and the check; the table
    built is the 12-bit one only."""
    assert p256["redc_calls"] == ec_rns.affine_redc_launches(
        "P-256", 128, w_bits=12) == 22 * (2 + 256 + 128 + 2) + 11
    assert sorted(p256["table"]._rns) == [12]
