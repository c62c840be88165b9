"""The port's REDC against the JAX package's: ``redc_ref`` (the plain
version of the CUDA kernel) against ``rns._redc`` and the Pallas
``_redc_kernel`` in interpret mode, and the RS256 RNS verify core.

Outputs compare by VALUE mod p (CRT over base A): the extension's α is
a float32 sum, so another summation order may pick another
representative of the same residue class.
"""

import hashlib

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

import jax.numpy as jnp  # noqa: E402

from cap_tpu.tpu import ec_rns as j_ec_rns  # noqa: E402
from cap_tpu.tpu import limbs as j_limbs  # noqa: E402
from cap_tpu.tpu import rns as j_rns  # noqa: E402
from cap_tpu.tpu import rsa as j_rsa  # noqa: E402

from cap_tpu_torch.gpu import cuda_redc  # noqa: E402
from cap_tpu_torch.gpu import ec_rns as t_ec_rns  # noqa: E402
from cap_tpu_torch.gpu import limbs as t_limbs  # noqa: E402
from cap_tpu_torch.gpu import rns as t_rns  # noqa: E402
from cap_tpu_torch.gpu import rsa as t_rsa  # noqa: E402

N_LANES = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_below(rng, bound: int) -> int:
    nbytes = (bound.bit_length() + 71) // 8
    return int.from_bytes(rng.bytes(nbytes), "big") % bound


def _residues(c, vals):
    a = np.array([[v % int(m) for m in c.A.m] for v in vals], np.int32)
    b = np.array([[v % int(m) for m in c.B.m] for v in vals], np.int32)
    return np.ascontiguousarray(a.T), np.ascontiguousarray(b.T)


def _values(c, plane_a):
    plane_a = np.asarray(plane_a)
    return [c.value_of(plane_a[:, j]) for j in range(plane_a.shape[1])]


def _redc_inputs(seed: int):
    """Digit-canonical products x = a·b of A-domain values a, b < 3p
    (what every rmul feeds its REDC), plus the edge values 0 and p."""
    c = t_ec_rns.ctx_for("P-256")
    p = c.p_int
    rng = np.random.default_rng(seed)
    vals = [_rand_below(rng, 3 * p) * _rand_below(rng, 3 * p)
            for _ in range(N_LANES - 2)] + [0, p]
    return c, vals, _residues(c, vals)


def _check_redc(c, vals, port, ref):
    p = c.p_int
    a_inv = pow(c.A.prod, -1, p)
    pv = _values(c, port[0])
    rv = _values(c, ref[0])
    for x, u, w in zip(vals, pv, rv):
        assert (u - x * a_inv) % p == 0
        assert (u - w) % p == 0
        assert u < 3 * p
    # the B residues carry the same value as the A residues
    _, b_of_a = _residues(c, pv)
    assert np.array_equal(np.asarray(port[1]), b_of_a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_redc_ref_matches_xla_redc(seed):
    c, vals, (xa, xb) = _redc_inputs(seed)
    jc = j_ec_rns.ctx_for("P-256")
    ref = j_rns._redc(jnp.asarray(xa), jnp.asarray(xb), jc.sig_c, jc.p_B,
                      jc.consts)
    port = cuda_redc.redc(c, torch.from_numpy(xa), torch.from_numpy(xb))
    _check_redc(c, vals, [t.numpy() for t in port], ref)


def test_redc_ref_matches_pallas_kernel_interpret(monkeypatch):
    monkeypatch.setenv("CAP_TPU_PALLAS", "1")
    c, vals, (xa, xb) = _redc_inputs(7)
    jc = j_ec_rns.ctx_for("P-256")
    ref = j_ec_rns._redc_dispatch(jc, jnp.asarray(xa), jnp.asarray(xb))
    port = cuda_redc.redc_ref(c, torch.from_numpy(xa), torch.from_numpy(xb))
    _check_redc(c, vals, [t.numpy() for t in port], ref)


def test_rs256_rns_verify_core_matches_jax():
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    keys = [rsa.generate_private_key(public_exponent=65537, key_size=2048)
            for _ in range(2)]
    n_ints = [k.public_key().public_numbers().n for k in keys]
    msgs = [b"rs core %d" % i for i in range(6)]
    rows = [0, 1, 0, 1, 0, 1]
    sigs = [keys[r].sign(m, padding.PKCS1v15(), hashes.SHA256())
            for m, r in zip(msgs, rows)]
    sigs[2] = bytes([sigs[2][0] ^ 1]) + sigs[2][1:]      # tampered
    sigs[3] = sigs[1]                                    # wrong message
    sigs[4] = (n_ints[0] - 1).to_bytes(256, "big")       # s = n - 1
    expect = [True, True, False, False, False, True]
    digests = [hashlib.sha256(m).digest() for m in msgs]
    k = 129

    jctx = j_rns.context(2048, k)
    jtab = j_rns.RNSKeyTable(jctx, n_ints)
    s_limbs = j_limbs.bytes_be_to_limbs(sigs, k)
    em_lens = np.full(len(sigs), 256)
    e_limbs = j_rsa.expected_pkcs1v15_em(digests, "sha256", em_lens, k)
    idx = jnp.asarray(rows)
    ref = np.asarray(j_rns._rns_verify_core(
        jctx, jnp.asarray(s_limbs), jnp.asarray(e_limbs),
        jtab.sig_c[idx].T, jtab.n_B[idx].T, jtab.a2_A[idx].T,
        jtab.a2_B[idx].T))

    tctx = t_rns.context(2048, k)
    ttab = t_rns.RNSKeyTable(tctx, n_ints)
    sig_mat = np.stack([np.frombuffer(s.rjust(2 * k, b"\0"), np.uint8)
                        for s in sigs])
    s_t = t_limbs.bytes_to_limbs_device(torch.from_numpy(sig_mat))
    assert np.array_equal(s_t.numpy(), s_limbs.astype(np.int64))
    dig = torch.from_numpy(np.stack([np.frombuffer(d, np.uint8)
                                     for d in digests]))
    e_t = t_rsa._expected_em_device(dig, torch.full((len(sigs),), 256),
                                    k, "sha256")
    assert np.array_equal(e_t.numpy(), e_limbs.astype(np.int64))
    ti = torch.as_tensor(rows)
    sig_c, n_B, a2_A, a2_B = ttab.device_tables("cpu")
    port = t_rns._rns_verify_core(tctx, s_t, e_t, sig_c[ti].T, n_B[ti].T,
                                  a2_A[ti].T, a2_B[ti].T)
    assert port.tolist() == ref.tolist() == expect
