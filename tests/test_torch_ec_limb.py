"""The limb ECDSA engine's Jacobian ladder (``gpu.ec._ecdsa_core``, the
entry points' ``rns=False``) against the JAX package's limb engine, live:
the edge vectors of ``tests/test_ec_affine.py`` on P-256
(``testing.ec_edge_vectors``, the same seed) through both engines'
verify cores, the raw ok and same-x flags word-equal and the verdicts
of ``verify_ecdsa_batch`` equal to the JAX entry point's and its
oracle's; the limb window tables byte-equal. The JAX side runs with
``CAP_TPU_RNS=0``, the limb engine it takes on the CPU. (One JAX
engine a file: its compile on the CPU costs tens of seconds.)
"""

import jax.numpy as jnp
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


def jax_table(crv, key):
    nums = key.public_numbers()
    return jec.ECKeyTable(crv, [jec.HostECPublicKey(crv, nums.x, nums.y)])


def jax_core(table, sigs, digs, ladder):
    """The JAX limb core's raw (ok, deg) on the vectors, through the
    program ``verify_ecdsa_batch`` compiles (same static arguments)."""
    cp = table.curve
    n_tok = len(sigs)
    safe = np.zeros((128, 2 * cp.coord_bytes), np.uint8)
    safe[:n_tok] = np.frombuffer(b"".join(sigs), np.uint8).reshape(n_tok, -1)
    dig = np.zeros((128, len(digs[0])), np.uint8)
    dig[:n_tok] = np.frombuffer(b"".join(digs), np.uint8).reshape(n_tok, -1)
    r, s, e = jec._ec_prep(jnp.asarray(safe), jnp.asarray(dig), k=cp.k)
    ok, deg = jec._ecdsa_core(
        r, s, e, jnp.zeros(128, jnp.int32), table.tqx, table.tqy,
        *cp.g_tables(), *cp.device_consts(), nbits=cp.nbits,
        n_windows=cp.n_windows, pbits=cp.pbits, ladder=ladder)
    return np.asarray(ok)[:n_tok], np.asarray(deg)[:n_tok]


def port_verify(table, sigs, digs, ladder, rns):
    """The port's ``verify_ecdsa_batch`` verdicts and the raw (ok, deg)
    of the one engine run under it."""
    raw = []
    pending = gpuec.verify_ecdsa_arrays_pending

    def record(*a, **k):
        ok, deg = pending(*a, **k)
        raw.append((ok.numpy()[:len(sigs)], deg.numpy()[:len(sigs)]))
        return ok, deg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpuec, "verify_ecdsa_arrays_pending", record)
        ok = gpuec.verify_ecdsa_batch(table, sigs, digs,
                                      np.zeros(len(sigs), np.int64),
                                      ladder=ladder, rns=rns)
    return raw[0], ok


@pytest.fixture(scope="module")
def p256():
    key, names, sigs, digs = tt.ec_edge_vectors("P-256")
    jt_ = jax_table("P-256", key)
    want = [jec._py_verify_one(jt_, 0, sg, dg) for sg, dg in zip(sigs, digs)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "0")
        jax_raw = jax_core(jt_, sigs, digs, "jacobian")
        jax_ok = jec.verify_ecdsa_batch(jt_, sigs, digs,
                                        np.zeros(len(sigs), np.int32),
                                        ladder="jacobian")
    table = gpuec.ECKeyTable("P-256", [key], device="cpu")
    port_raw, port_ok = port_verify(table, sigs, digs, "jacobian", False)
    return dict(names=names, want=want, jax_raw=jax_raw, jax_ok=jax_ok,
                port_raw=port_raw, port_ok=port_ok, jtab=jt_, table=table)


def test_verdicts_equal_the_jax_limb_engine_and_its_oracle(p256):
    names, want = p256["names"], p256["want"]
    port = [bool(v) for v in p256["port_ok"]]
    jax_ = [bool(v) for v in p256["jax_ok"]]
    assert port == jax_ == want, [
        (n, p, j, w) for n, p, j, w in zip(names, port, jax_, want)
        if not p == j == w]
    assert want.count(True) >= 3 and want.count(False) >= 5


def test_raw_ok_and_flags_word_equal(p256):
    """Before the oracle: the same ok bits and the same same-x flags
    (the merge's inverse vector among them)."""
    (jok, jdeg), (pok, pdeg) = p256["jax_raw"], p256["port_raw"]
    assert (pok == jok).all() and (pdeg == jdeg).all()
    assert "deg-inverse-merge" in {n for n, f in zip(p256["names"], pdeg)
                                   if f}


def test_limb_tables_byte_equal(p256):
    tqx, tqy = p256["table"].limb_tables()
    assert (tqx.numpy() == np.asarray(p256["jtab"].tqx)).all()
    assert (tqy.numpy() == np.asarray(p256["jtab"].tqy)).all()
    gx, gy = gpuec.curve("P-256").g_tables("cpu")
    jgx, jgy = jec.curve("P-256").g_tables()
    assert (gx.numpy() == np.asarray(jgx)).all()
    assert (gy.numpy() == np.asarray(jgy)).all()


def test_limb_tables_are_lazy():
    """An ES table builds no limb rows until the limb engine asks."""
    key, *_ = tt.ec_edge_vectors("P-256")
    table = gpuec.ECKeyTable("P-256", [key], device="cpu")
    assert table._limb is None and table._rns == {}
