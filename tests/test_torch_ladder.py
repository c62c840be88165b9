"""The port's whole-ladder kernel: ``cuda_ladder.ladder_ref`` (the plain
version of ``csrc/ladder.cu``) against the JAX package's
``pallas_madd.ladder_fused`` in interpret mode, and against the port's
own per-window path (``ec_rns.ladder_per_window`` over ``madd_ref``)
at the full window count of P-256, P-384 and P-521; and the wrapper's
refusals.

X/Y/Z compare by VALUE mod p; inf exactly; ``deg`` must hold on every
true same-x degeneracy (false positives of the 2-channel probe only
cost a re-verify on the oracle and may differ).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cap_tpu.tpu import ec_rns as j_ec_rns
from cap_tpu.tpu import pallas_madd

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import cuda_ladder
from cap_tpu_torch.gpu import ec_rns as t_ec_rns

AT_INF = 8                 # lanes 0..7 have every digit 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(crv: str, n_windows: int, m: int, seed: int):
    """A ladder over a random table of G and one key slot: digits with
    an extra 10% zeros, lanes 0..AT_INF−1 at infinity throughout, and
    every 9th lane a planted same-x degeneracy
    (``testing.ladder_inputs``)."""
    c = t_ec_rns.ctx_for(crv)
    return (c, *tt.ladder_inputs(c, n_windows, m, 1,
                                 np.random.default_rng(seed),
                                 at_inf=AT_INF, plant_every=9,
                                 zero_share=0.1))


def _values(c, plane_a):
    return [c.value_of(plane_a[:, j]) for j in range(plane_a.shape[1])]


def _residues_b(c, vals):
    return np.array([[v % int(m) for m in c.B.m] for v in vals],
                    np.int32).T


def _port(c, tab, d, base, stride):
    t = torch.from_numpy
    return cuda_ladder.ladder(c, t(tab), t(d), t(base), stride)


@pytest.mark.parametrize("crv,n_windows", [("P-256", 3), ("P-384", 3)])
def test_ladder_ref_matches_pallas_ladder_interpret(crv, n_windows):
    c, tab, d, base, stride, true_deg = _case(crv, n_windows, 512, seed=7)
    row0 = (np.arange(n_windows)[:, None] * stride
            + base[None, :]).astype(np.int32)
    j = jnp.asarray
    ref = pallas_madd.ladder_fused(j_ec_rns.ctx_for(crv), j(tab), j(d),
                                   j(row0), interpret=True)
    port = _port(c, tab, d, base, stride)
    p = c.p_int
    for pt, rt in zip(port[:3], ref[:3]):
        pv = _values(c, pt[0].numpy())
        rv = _values(c, np.asarray(rt[0]))
        assert all((u - w) % p == 0 for u, w in zip(pv, rv))
        # B residues carry the same values as the A residues
        assert np.array_equal(pt[1].numpy(), _residues_b(c, pv))
    inf = port[3].numpy()
    assert np.array_equal(inf, np.asarray(ref[3]))
    assert inf[:AT_INF].all() and not inf[AT_INF:].all()
    deg, ref_deg = port[4].numpy(), np.asarray(ref[4])
    assert deg[true_deg].all() and ref_deg[true_deg].all()
    assert not deg[inf].any()


@pytest.mark.parametrize("crv", ["P-256", "P-384", "P-521"])
def test_ladder_ref_equals_the_per_window_loop(crv):
    """At the curve's full window count (32, 48, 66), the fused plain
    ladder is the per-window path (``ec_rns.ladder_per_window`` over
    ``madd_ref``), bit for bit."""
    c = t_ec_rns.ctx_for(crv)
    _, tab, d, base, stride, true_deg = _case(crv, c.n_windows, 128,
                                              seed=11)
    fused = _port(c, tab, d, base, stride)
    t = torch.from_numpy
    loop = t_ec_rns.ladder_per_window(c, t(tab), t(d), t(base), stride)
    for f, w in zip(fused[:3], loop[:3]):
        assert torch.equal(f[0], w[0]) and torch.equal(f[1], w[1])
    assert torch.equal(fused[3], loop[3]) and torch.equal(fused[4], loop[4])
    assert fused[4].numpy()[true_deg].all()


def test_ladder_wrapper_refuses_what_the_kernel_does_not_take():
    c, tab, d, base, ws, _ = _case("P-256", 2, 128, seed=3)
    t = torch.from_numpy
    tab, d, base = t(tab), t(d), t(base)
    bad = [
        (tab.to(torch.int64), d, base, ws),               # dtype
        (tab, d.to(torch.int64), base, ws),
        (tab, d, base.to(torch.int16), ws),
        (tab[:, :-1], d, base, ws),                       # shapes
        (tab, d, base[:-1], ws),
        (tab, d[0], base, ws),
        (tab, d, base, 3 * ws),                           # rows
        (tab, d[:, ::2], base[::2], ws),                  # contiguity
        (tab, d.to("meta"), base, ws),                    # devices
        (tab, d, base.to("meta"), ws),
        (tab.to("meta"), d.to("meta"), base.to("meta"), ws),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cuda_ladder.ladder(c, *args)
    assert cuda_ladder.launches == 0
