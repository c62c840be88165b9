"""The two-phase ML-DSA arm (``gpu.mldsa.verify_mldsa_pending`` and
``verify_mldsa_batch``) against the JAX package's, live, on
ML-DSA-44: the mixed 120-token batch of ``tests/test_mldsa_fused.py``
(valid signatures; a flipped bit, a short signature, a changed
message, a flipped c̃ bit) and a malformed-hint signature, padded to
128 lanes — the w1 rows word-equal to the JAX
``verify_mldsa_core_pending`` on the same prepped chunk and to the
port's numpy mirror ``host_w1``, the prepped z/c/h rows equal to the
JAX ``_PreppedChunk``'s, verdicts equal to the JAX ``verify_mldsa_batch``
(``CAP_TPU_MLDSA_FUSED=0``) and to the oracle; the host SHAKE counted
(three a decodable token: SampleInBall, μ, the c̃ recompute) and no
Keccak on the arm. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from cap_tpu.tpu import mldsa as J

from cap_tpu_torch.gpu import cuda_keccak
from cap_tpu_torch.gpu import mldsa as T

PSET = "ML-DSA-44"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    seeds = [bytes([91 + i]) * 32 for i in range(2)]
    port = [T.keygen(PSET, s) for s in seeds]
    privs = [k for k, _ in port]
    pubs = [u for _, u in port]
    jpubs = [J.keygen(PSET, s)[1] for s in seeds]
    p = T.PARAMS[PSET]
    sigs, msgs, rows = [], [], []
    base = [(privs[i % 2].sign(f"tp-{i}".encode()), f"tp-{i}".encode(),
             i % 2) for i in range(8)]
    for i in range(120):
        sig, msg, row = base[i % len(base)]
        mode = i % 6
        if mode == 1:
            b = bytearray(sig)
            b[i % len(sig)] ^= 1 << (i % 8)
            sig = bytes(b)
        elif mode == 2:
            sig = sig[:-1]
        elif mode == 3:
            msg = msg + b"?"
        elif mode == 4:
            b = bytearray(sig)
            b[i % (p.lam // 4)] ^= 0x01
            sig = bytes(b)
        sigs.append(sig)
        msgs.append(msg)
        rows.append(row)
    # a hint count past ω: rejected at decode, never on the device
    bad = bytearray(base[0][0])
    bad[-1] = p.omega + 1
    sigs.append(bytes(bad))
    msgs.append(base[0][1])
    rows.append(0)
    rows = np.asarray(rows)
    return privs, pubs, jpubs, sigs, msgs, rows


def test_prepped_rows_and_w1_equal_jax_and_the_mirror(batch):
    _, pubs, jpubs, sigs, msgs, rows = batch
    table = T.MLDSAKeyTable(PSET, pubs, device="cpu")
    jtable = J.MLDSAKeyTable(PSET, jpubs)
    prep = T._PreppedChunk(table, sigs, msgs, rows, 128)
    jprep = J._PreppedChunk(jtable, sigs, msgs, rows.astype(np.int32), 128)
    assert (prep.valid == jprep.valid).all()
    assert 0 < prep.valid.sum() < len(sigs)
    assert (prep.z == jprep.z).all() and (prep.c == jprep.c).all()
    assert (prep.h == jprep.h).all()
    assert prep.mus == jprep.mus and prep.cts == jprep.cts
    w1 = T.verify_mldsa_core_pending(table, prep.z, prep.c, prep.h,
                                     prep.key_idx).numpy()
    jw1 = np.asarray(J.verify_mldsa_core_pending(
        jtable, jprep.z, jprep.c, jprep.h, jprep.key_idx))
    assert w1.dtype == np.uint8 and w1.shape == (128, 4, 256)
    assert (w1 == jw1).all()
    assert (w1[prep.valid] == T.host_w1(table, prep)[prep.valid]).all()


def test_verdicts_equal_jax_batch_and_oracle(batch, monkeypatch):
    _, pubs, jpubs, sigs, msgs, rows = batch
    table = T.MLDSAKeyTable(PSET, pubs, device="cpu")
    monkeypatch.setenv("CAP_TPU_MLDSA_FUSED", "0")
    want = J.verify_mldsa_batch(J.MLDSAKeyTable(PSET, jpubs), sigs, msgs,
                                rows.astype(np.int32))
    keccak_calls = []
    monkeypatch.setattr(cuda_keccak, "f1600",
                        lambda *a: keccak_calls.append(1))
    T.host_shake_calls = 0
    got = T.verify_mldsa_batch(table, sigs, msgs, rows)
    shakes = T.host_shake_calls
    n_valid = int(T._decode_batch(sigs, T.PARAMS[PSET])[0].sum())
    oracle = np.array([T.py_verify(pubs[r], s, m)
                       for s, m, r in zip(sigs, msgs, rows)])
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, oracle) and 0 < oracle.sum() < len(sigs)
    assert not keccak_calls
    # SampleInBall, μ and the c̃ recompute for each decodable token
    assert shakes == 3 * n_valid


def test_pending_pads_and_finishes_on_the_host(batch):
    _, pubs, _, sigs, msgs, rows = batch
    table = T.MLDSAKeyTable(PSET, pubs, device="cpu")
    full = T.verify_mldsa_pending(table, sigs, msgs, rows, pad=128)()
    assert full.shape == (128,) and not full[len(sigs):].any()
    assert np.array_equal(full[:len(sigs)],
                          T.verify_mldsa_batch(table, sigs, msgs, rows))
    empty = T.verify_mldsa_pending(table, [b"x"] * 3, [b""] * 3,
                                   np.zeros(3, np.int64), pad=128)()
    assert empty.shape == (128,) and not empty.any()
