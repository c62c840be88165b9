"""The RSA engine-level entry points against the JAX package's, live:
``verify_pkcs1v15_batch``, ``verify_pss_batch``,
``verify_pkcs1v15_arrays`` and ``verify_pss_arrays`` over two seeded
RSA-2048 keys — valid RS256 and PS256 signatures (salts of 32 and 0
bytes), a tampered one, a short one, s ≥ n, the other key's, a PSS EM
with a bad trailer — on both engines of the port (``rns=True``: the
RNS engine of an all-65537 class; ``rns=False``: ``bignum.
modexp_65537`` on limbs), each against the JAX function under the
matching ``CAP_TPU_RNS`` for the PKCS#1 v1.5 ones; the PSS ones
against the JAX package's limb engine (``verify_pss_batch`` takes it
whatever the setting; the RNS arm of ``verify_pss_arrays`` would add a
compile of its own). The port checks EMSA-PSS on the device where the
JAX package checks it on the host: the verdicts are equal.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from cap_tpu.tpu import rsa as jrsa

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import rsa as gpursa
from cap_tpu_torch.jwt.verify import pkcs1v15_em


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vectors():
    rng = random.Random(1801)
    keys = [tt.generate_rsa_key(rng) for _ in range(2)]
    k_bytes = 256

    def sig_of(key, em):
        return key.raw_sign(int.from_bytes(em, "big")).to_bytes(k_bytes,
                                                               "big")

    rs, ps = [], []             # (label, sig, digest, key row)
    for j in range(4):
        dig = hashlib.sha256(b"m%d" % j).digest()
        key = keys[j % 2]
        rs.append(("valid", sig_of(key, pkcs1v15_em(dig, "sha256", k_bytes)),
                   dig, j % 2))
        em = tt.pss_em(dig, key.n.bit_length() - 1, "sha256",
                       rng.randbytes(32 if j < 2 else 0))
        ps.append(("valid", sig_of(key, em), dig, j % 2))
    for group in (rs, ps):
        _, good, dig, row = group[0]
        flip = bytearray(good)
        flip[100] ^= 0x08
        group.append(("tampered", bytes(flip), dig, row))
        group.append(("short", good[:-1], dig, row))
        group.append(("s-ge-n", keys[row].n.to_bytes(k_bytes, "big"), dig,
                      row))
        group.append(("other-key", good, dig, 1 - row))
    rs.append(("other-digest", rs[0][1], hashlib.sha256(b"x").digest(), 0))
    dig = ps[0][2]
    em = tt.pss_em(dig, keys[0].n.bit_length() - 1, "sha256", b"s" * 32)
    ps.append(("bad-trailer", sig_of(keys[0], em[:-1] + b"\xbd"), dig, 0))
    nums = [(key.n, key.e) for key in keys]
    return nums, rs, ps


def _arrays(group):
    sigs = [g[1] for g in group]
    mat = np.zeros((len(sigs), 256), np.uint8)
    for j, sg in enumerate(sigs):
        mat[j, :len(sg)] = np.frombuffer(sg, np.uint8)
    lens = np.asarray([len(sg) for sg in sigs], np.int64)
    hmat = np.stack([np.frombuffer(g[2], np.uint8) for g in group])
    rows = np.asarray([g[3] for g in group], np.int64)
    return mat, lens, hmat, rows


def _lists(group):
    return ([g[1] for g in group], [g[2] for g in group],
            np.asarray([g[3] for g in group], np.int64))


@pytest.fixture(scope="module")
def jax_verdicts(vectors):
    nums, rs, ps = vectors
    table = jrsa.RSAKeyTable(nums)
    out = {}
    # both groups hold 9 vectors: one compiled limb modexp serves every
    # call of the JAX limb engine
    assert len(rs) == len(ps) == 9
    with pytest.MonkeyPatch.context() as mp:
        for rns in ("1", "0"):
            mp.setenv("CAP_TPU_RNS", rns)
            sigs, digs, rows = _lists(rs)
            out["pkcs1v15_batch", rns] = jrsa.verify_pkcs1v15_batch(
                table, sigs, digs, "sha256", rows.astype(np.int32))
            out["pkcs1v15_arrays", rns] = jrsa.verify_pkcs1v15_arrays(
                table, *_arrays(rs)[:3], "sha256", _arrays(rs)[3])
        # the JAX PSS entry points on its limb engine (verify_pss_batch
        # takes it whatever the setting)
        sigs, digs, rows = _lists(ps)
        out["pss_batch"] = jrsa.verify_pss_batch(
            table, sigs, digs, "sha256", rows.astype(np.int32))
        out["pss_arrays"] = jrsa.verify_pss_arrays(
            table, *_arrays(ps)[:3], "sha256", _arrays(ps)[3])
    return out


def _want(group):
    return [g[0] == "valid" for g in group]


@pytest.mark.parametrize("rns", [True, False])
def test_pkcs1v15_batch_equals_jax(vectors, jax_verdicts, rns):
    nums, rs, _ = vectors
    table = gpursa.RSAKeyTable(nums, device="cpu")
    got = gpursa.verify_pkcs1v15_batch(table, *_lists(rs)[:2], "sha256",
                                       _lists(rs)[2], rns=rns)
    ref = jax_verdicts["pkcs1v15_batch", "1" if rns else "0"]
    assert list(got) == list(ref) == _want(rs)


@pytest.mark.parametrize("rns", [True, False])
def test_pss_batch_equals_jax(vectors, jax_verdicts, rns):
    nums, _, ps = vectors
    table = gpursa.RSAKeyTable(nums, device="cpu")
    got = gpursa.verify_pss_batch(table, *_lists(ps)[:2], "sha256",
                                  _lists(ps)[2], rns=rns)
    assert list(got) == list(jax_verdicts["pss_batch"]) == _want(ps)


@pytest.mark.parametrize("rns", [True, False])
def test_arrays_entry_points_equal_jax(vectors, jax_verdicts, rns):
    nums, rs, ps = vectors
    table = gpursa.RSAKeyTable(nums, device="cpu")
    got_rs = gpursa.verify_pkcs1v15_arrays(table, *_arrays(rs)[:3],
                                           "sha256", _arrays(rs)[3], rns=rns)
    got_ps = gpursa.verify_pss_arrays(table, *_arrays(ps)[:3], "sha256",
                                      _arrays(ps)[3], rns=rns)
    assert list(got_rs) == list(
        jax_verdicts["pkcs1v15_arrays", "1" if rns else "0"]) == _want(rs)
    assert list(got_ps) == list(jax_verdicts["pss_arrays"]) == _want(ps)


def test_rns_false_runs_the_limb_modexp(vectors, monkeypatch):
    """rns=False sends an all-65537 class to ``modexp_65537``; the RNS
    engine runs nothing."""
    nums, rs, _ = vectors
    table = gpursa.RSAKeyTable(nums, device="cpu")
    assert table.ctx is not None
    calls = []
    real = gpursa.modexp_65537
    monkeypatch.setattr(gpursa, "modexp_65537",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(gpursa, "verify_em_equals_device", None)
    gpursa.verify_pkcs1v15_batch(table, *_lists(rs)[:2], "sha256",
                                 _lists(rs)[2], rns=False)
    assert calls == [1]
