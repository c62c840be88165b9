"""Host and field pieces of the engine modes against the JAX package,
live: ``limbs.ints_to_limbs``, ``bignum.add_mod`` and ``sub_mod`` on
seeded values, ``ec.resolve_ladder``'s refusal,
``ec_rns.rns_batch_inverse`` value-equal by CRT mod p to the JAX
function on seeded residues (the port raises the tree's root to p − 2
by a square each bit and a multiply each 1 bit, the JAX package
multiplies at every bit and selects: one value, other residue
representatives), ``ec_rns.affine_ladder`` over three windows of a
seeded P-384 and P-521 table against the affine law computed on host
integers (a full P-384 or P-521 verify on the affine RNS ladder runs
2·pbits REDCs a window: minutes of the plain REDC on the CPU, so it is
held against the oracle on the card, ``tests/test_torch_cuda.py``), and
the keyset's default path building no limb window table.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap_tpu.tpu import bignum as jbn
from cap_tpu.tpu import ec as jec
from cap_tpu.tpu import ec_rns as jrns
from cap_tpu.tpu import limbs as jlimbs

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import bignum as B
from cap_tpu_torch.gpu import cuda_redc
from cap_tpu_torch.gpu import ec as gpuec
from cap_tpu_torch.gpu import ec_rns
from cap_tpu_torch.gpu import limbs as L
from cap_tpu_torch.jwt import algs
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
from cap_tpu_torch.jwt.jwk import JWK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resolve_ladder_refuses_unknown_modes():
    assert gpuec.resolve_ladder("affine") == "affine"
    with pytest.raises(ValueError) as port:
        gpuec.resolve_ladder("projective")
    with pytest.raises(ValueError) as ref:
        jec.resolve_ladder("projective")
    assert str(port.value) == str(ref.value)


@pytest.fixture(scope="module")
def seeded():
    rng = np.random.default_rng(7)
    vals = [int(rng.integers(0, 2**62)) ** 4 % (1 << 250) for _ in range(9)]
    return rng, vals + [0, (1 << 256) - 1]


def test_host_limb_helpers_equal_the_jax_package(seeded):
    _, vals = seeded
    k = 16
    assert (L.ints_to_limbs(vals, k) == jlimbs.ints_to_limbs(vals, k)).all()
    with pytest.raises(ValueError):
        L.ints_to_limbs([1 << 256], k)
    with pytest.raises(ValueError):
        L.ints_to_limbs([-1], k)


def test_add_sub_mod_equal_the_jax_package():
    cp = gpuec.curve("P-256")
    rng = random.Random(3)
    a = [rng.randrange(cp.p) for _ in range(30)] + [0, cp.p - 1, 1]
    b = [rng.randrange(cp.p) for _ in range(30)] + [cp.p - 1, cp.p - 1, 0]
    la, lb = (L.ints_to_limbs(x, cp.k) for x in (a, b))
    p_col = L.int_to_limbs(cp.p, cp.k)[:, None]
    for port_fn, jax_fn, op in ((B.add_mod, jbn.add_mod, int.__add__),
                                (B.sub_mod, jbn.sub_mod, int.__sub__)):
        got = port_fn(torch.as_tensor(la.astype(np.int64)),
                      torch.as_tensor(lb.astype(np.int64)),
                      torch.as_tensor(p_col.astype(np.int64))).numpy()
        ref = np.asarray(jax.jit(jax_fn)(
            jnp.asarray(la), jnp.asarray(lb),
            jnp.broadcast_to(jnp.asarray(p_col), la.shape)))
        assert (got == ref).all()
        assert [L.limbs_to_int(got[:, j]) for j in range(len(a))] == [
            op(x, y) % cp.p for x, y in zip(a, b)]


def test_rns_batch_inverse_equals_the_jax_function_by_crt():
    rng = random.Random(21)
    c = ec_rns.ctx_for("P-256")
    jc = jrns.ctx_for("P-256", 8)
    p = c.cp.p
    m = 256
    vals = [rng.randrange(1, 8 * p) for _ in range(m - 2)] + [1, p - 1]
    vals = [v if v % p else v + 1 for v in vals]
    res = np.stack([c.residues_of(v) for v in vals], axis=1).astype(np.int32)
    ia = c.A.count
    got = ec_rns.rns_batch_inverse(
        c, (torch.as_tensor(res[:ia]), torch.as_tensor(res[ia:])),
        redc=cuda_redc.redc_ref)
    ref = jrns.rns_batch_inverse(jc, (jnp.asarray(res[:ia]),
                                      jnp.asarray(res[ia:])))
    a_mod = c.A.prod % p
    for j, v in enumerate(vals):
        port_v = c.value_of(got[0][:, j].numpy())
        jax_v = c.value_of(np.asarray(ref[0])[:, j])
        # den holds v = a·A, so the inverse is a⁻¹·A = v⁻¹·A²
        assert port_v % p == jax_v % p == pow(v, -1, p) * a_mod ** 2 % p
        assert port_v < 3 * p
    # the B residues carry the same value
    b_ref = np.stack([c.residues_of(c.value_of(got[0][:, j].numpy()))[ia:]
                      for j in range(m)], axis=1)
    assert (got[1].numpy() == b_ref).all()


def _host_affine_ladder(c, tab, d_all, base, stride):
    """The affine law on host integers over the table's values (A-domain
    residues → plain field values): (x, y, at infinity, same-x) a lane,
    x and y in the A-domain."""
    p, ia = c.p_int, c.A.count
    a_mod = c.A.prod % p
    a_inv = pow(a_mod, -1, p)
    iap = tab.shape[1] // 2

    def value(row, half):
        words = tab[row, half * iap:(half + 1) * iap]
        return c.value_of((words & 0xFFFF)[:ia]) * a_inv % p

    out = []
    for j in range(d_all.shape[1]):
        acc, deg = None, False
        for i in range(d_all.shape[0]):
            d = int(d_all[i, j])
            if not d:
                continue
            row = i * stride + int(base[j]) + d - 1
            x2, y2 = value(row, 0), value(row, 1)
            if acc is None:
                acc = (x2, y2)
                continue
            x, y = acc
            if x == x2:
                deg = True
                continue          # the device's lane is the oracle's
            lam = (y2 - y) * pow(x2 - x, -1, p) % p
            x3 = (lam * lam - x - x2) % p
            acc = (x3, (lam * (x - x3) - y) % p)
        out.append((None if acc is None else
                    (acc[0] * a_mod % p, acc[1] * a_mod % p), deg))
    return out


@pytest.mark.parametrize("crv", ["P-384", "P-521"])
def test_affine_ladder_windows_equal_the_host_affine_law(crv):
    c = ec_rns.ctx_for(crv)
    rng = np.random.default_rng(31 + len(crv))
    tab, d_all, base, stride, true_deg = tt.ladder_inputs(
        c, 3, 256, 2, rng, at_inf=8, plant_every=61, zero_share=0.25)
    x, y, inf, deg = ec_rns.affine_ladder(
        c, torch.as_tensor(tab), torch.as_tensor(d_all),
        torch.as_tensor(base), stride, redc=cuda_redc.redc_ref)
    p = c.p_int
    for j, (want, want_deg) in enumerate(_host_affine_ladder(
            c, tab, d_all, base, stride)):
        assert bool(inf[j]) == (want is None)
        if want_deg:
            assert deg[j], j
            continue
        if want is not None:
            assert (c.value_of(x[0][:, j].numpy()) % p,
                    c.value_of(y[0][:, j].numpy()) % p) == want, j
    assert deg[torch.as_tensor(true_deg)].all()


def test_default_path_builds_no_limb_tables():
    """The keyset's default path (RNS engines) leaves the limb window
    tables unbuilt: an ES table's ``tqx``/``tqy`` and the Ed25519
    table's ``tna`` are built only when a limb engine asks."""
    rng = random.Random(18)
    es, ed = tt.generate_ec_key(rng), tt.generate_ed25519_key(rng)
    jwks = [JWK(es.public_key(), kid="es-0"), JWK(ed.public_key(), kid="ed-0")]
    claims = tt.default_claims(sub="s")
    tokens = [tt.sign_jwt(es, algs.ES256, claims, kid="es-0", rng=rng),
              tt.sign_jwt(ed, algs.EdDSA, claims, kid="ed-0")]
    ks = GPUBatchKeySet(jwks, device="cpu")
    assert [r["sub"] for r in ks.verify_batch(tokens)] == ["s", "s"]
    assert sorted(ks._ec_tables["P-256"]._rns) == [8]
    assert ks._ec_tables["P-256"]._limb is None
    assert ks._ed_table._rns is not None and ks._ed_table._tna is None
