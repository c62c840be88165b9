"""The port's ladder-window mixed add against the JAX package's:
``madd_ref`` (the plain version of the CUDA kernel) against the Pallas
``_madd_kernel`` in interpret mode and against ``ec_rns._madd_rns``
with the ladder's lift/select.

X/Y/Z compare by VALUE mod p; ``deg`` must agree on every true
same-x degeneracy (false positives of the 2-channel probe only cost a
re-verify on the oracle and may differ).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cap_tpu.tpu import ec_rns as j_ec_rns
from cap_tpu.tpu import pallas_madd

from cap_tpu_torch.gpu import cuda_madd
from cap_tpu_torch.gpu import ec_rns as t_ec_rns

N_LANES = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SAME_X_EVERY = 9


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


def _case(seed: int):
    """Ladder states within the ladder's bounds (X < 15p, Y, Z < 11p,
    digit-canonical), table points < p, random has/inf, and every
    SAME_X_EVERY-th lane a true same-x degeneracy: X = x2·Z² in field
    values (A-domain encoded), has = 1, inf = 0."""
    c = t_ec_rns.ctx_for("P-256")
    p = c.p_int
    a = c.A.prod % p
    a_inv = pow(a, -1, p)
    rng = np.random.default_rng(seed)
    xs = [_rand_below(rng, 15 * p) for _ in range(N_LANES)]
    ys = [_rand_below(rng, 11 * p) for _ in range(N_LANES)]
    zs = [_rand_below(rng, 11 * p) for _ in range(N_LANES)]
    x2 = [_rand_below(rng, p) for _ in range(N_LANES)]
    y2 = [_rand_below(rng, p) for _ in range(N_LANES)]
    has = rng.integers(0, 2, N_LANES).astype(bool)
    inf = rng.integers(0, 2, N_LANES).astype(bool)
    true_deg = np.zeros(N_LANES, bool)
    for j in range(0, N_LANES, SAME_X_EVERY):
        z = zs[j] * a_inv % p
        xs[j] = (x2[j] * a_inv % p) * z * z % p * a % p
        has[j], inf[j] = True, False
        true_deg[j] = True

    def packed(vals):
        ra, rb = _residues(c, vals)
        return ra | (rb << 16)

    planes = [_residues(c, v) for v in (xs, ys, zs)]
    return c, planes, packed(x2), packed(y2), has, inf, true_deg, (x2, y2)


def _port(c, planes, x2p, y2p, has, inf):
    t = torch.from_numpy
    return cuda_madd.madd_ref(
        c, *[(t(a), t(b)) for a, b in planes], t(inf), t(has), t(x2p),
        t(y2p))


def _check(c, port, ref_xyz, ref_deg, true_deg, has, inf, planes):
    p = c.p_int
    for pt, rt, orig in zip(port[:3], ref_xyz, planes):
        pv = _values(c, pt[0].numpy())
        rv = _values(c, rt[0])
        assert all((u - w) % p == 0 for u, w in zip(pv, rv))
        # B residues carry the same values as the A residues
        _, b_of_a = _residues(c, pv)
        assert np.array_equal(pt[1].numpy(), b_of_a)
        # digit-0 lanes pass the state through untouched
        assert np.array_equal(pt[0].numpy()[:, ~has], orig[0][:, ~has])
    deg = port[3].numpy()
    ref_deg = np.asarray(ref_deg)
    assert deg[true_deg].all() and ref_deg[true_deg].all()
    assert not deg[~has | inf].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_madd_ref_matches_pallas_kernel_interpret(seed):
    c, planes, x2p, y2p, has, inf, true_deg, _ = _case(seed)
    jc = j_ec_rns.ctx_for("P-256")
    j = jnp.asarray
    X, Y, Z, dd = pallas_madd.madd_fused(
        jc, *[(j(a), j(b)) for a, b in planes], j(inf), j(has), j(x2p),
        j(y2p), interpret=True)
    port = _port(c, planes, x2p, y2p, has, inf)
    _check(c, port, [(np.asarray(t[0]), np.asarray(t[1]))
                     for t in (X, Y, Z)], dd, true_deg, has, inf, planes)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_madd_ref_matches_xla_madd_with_select(seed):
    c, planes, x2p, y2p, has, inf, true_deg, _ = _case(seed)
    jc = j_ec_rns.ctx_for("P-256")
    ia, ib = jc.A.count, jc.B.count
    j = jnp.asarray
    X, Y, Z = [(j(a), j(b)) for a, b in planes]
    jinf, jhas = j(inf), j(has)
    x2 = j_ec_rns.unpack_pt(j(x2p), ia, ib)
    y2 = j_ec_rns.unpack_pt(j(y2p), ia, ib)
    X3, Y3, Z3, dd = j_ec_rns._madd_rns(jc, X, Y, Z, jinf, x2, y2)
    lift = jinf & jhas
    one = j_ec_rns._one_dom(jc)
    X3 = j_ec_rns.rsel(lift, x2, X3)
    Y3 = j_ec_rns.rsel(lift, y2, Y3)
    Z3 = j_ec_rns.rsel(lift, (jnp.broadcast_to(one[0], Z3[0].shape),
                              jnp.broadcast_to(one[1], Z3[1].shape)), Z3)
    ref = [j_ec_rns.rsel(jhas, a, b) for a, b in ((X3, X), (Y3, Y),
                                                  (Z3, Z))]
    port = _port(c, planes, x2p, y2p, has, inf)
    _check(c, port, [(np.asarray(t[0]), np.asarray(t[1])) for t in ref],
           np.asarray(dd & jhas), true_deg, has, inf, planes)


def test_madd_lift_takes_the_table_point():
    """inf & has lanes become the affine addend with Z = A mod p (the
    A-domain one), whatever the state held."""
    c, planes, x2p, y2p, has, inf, _, (x2, y2) = _case(5)
    port = _port(c, planes, x2p, y2p, has, inf)
    lift = inf & has
    p = c.p_int
    one = c.A.prod % p
    for plane, want in ((port[0][0], x2), (port[1][0], y2)):
        got = _values(c, plane.numpy())
        assert all(got[j] == want[j] for j in np.nonzero(lift)[0])
    z = _values(c, port[2][0].numpy())
    assert all(z[j] == one for j in np.nonzero(lift)[0])
