"""The port's Ed25519 ladder-window mixed add against the JAX package's:
``edw_ref`` (the plain version of the CUDA kernel) against the Pallas
``_edw_kernel`` in interpret mode and against
``ed25519_rns._edw_madd_rns`` (XLA), on one 512-lane tile.

Outputs compare by VALUE mod p on both residue planes: the α of each
base extension is a float32 sum whose order differs between the
frameworks, so a representative may shift by a multiple of p.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cap_tpu.tpu import ed25519_rns as j_er
from cap_tpu.tpu import pallas_edw

from cap_tpu_torch.gpu import cuda_edw
from cap_tpu_torch.gpu import ed25519_rns as t_er

N_LANES = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_below(rng, bound: int, n: int):
    nbytes = (bound.bit_length() + 71) // 8
    return [int.from_bytes(rng.bytes(nbytes), "big") % bound
            for _ in range(n)]


def _residues(c, vals):
    a = np.array([[v % int(m) for m in c.A.m] for v in vals], np.int32)
    b = np.array([[v % int(m) for m in c.B.m] for v in vals], np.int32)
    return np.ascontiguousarray(a.T), np.ascontiguousarray(b.T)


def _crt(base, col) -> int:
    return sum(int(r) * int(inv) % int(m) * mi for r, inv, m, mi in
               zip(col, base.inv_Mi, base.m, base.Mi)) % base.prod


@pytest.fixture(scope="module", params=[0, 1])
def case(request):
    """Ladder states X, Y, Z, T < 3p (digit-canonical, the REDC output
    bound) and table triples ym, yp, t2 < p."""
    c = t_er.ctx()
    p = c.p_int
    rng = np.random.default_rng(request.param)
    planes = [_residues(c, _rand_below(rng, 3 * p, N_LANES))
              for _ in range(4)]
    planes += [_residues(c, _rand_below(rng, p, N_LANES)) for _ in range(3)]
    port = cuda_edw.edw_ref(
        c, *[(torch.from_numpy(a), torch.from_numpy(b)) for a, b in planes])
    return c, planes, [(t[0].numpy(), t[1].numpy()) for t in port]


def _check(c, port, ref):
    p = c.p_int
    for (pa, pb), (ra, rb) in zip(port, ref):
        ra, rb = np.asarray(ra), np.asarray(rb)
        for j in range(N_LANES):
            va, vb = _crt(c.A, pa[:, j]), _crt(c.B, pb[:, j])
            assert va == vb                      # one integer per lane
            assert (va - _crt(c.A, ra[:, j])) % p == 0
            assert (vb - _crt(c.B, rb[:, j])) % p == 0


def test_edw_ref_matches_pallas_kernel_interpret(case):
    c, planes, port = case
    j = jnp.asarray
    ref = pallas_edw.edw_madd_fused(
        j_er.ctx(), *[(j(a), j(b)) for a, b in planes], interpret=True)
    _check(c, port, ref)


def test_edw_ref_matches_xla_mixed_add(case):
    c, planes, port = case
    j = jnp.asarray
    ref = j_er._edw_madd_rns(j_er.ctx(),
                             *[(j(a), j(b)) for a, b in planes])
    _check(c, port, ref)


def test_edw_output_bounds(case):
    """The outputs are REDC outputs: digit-canonical, values < 3p (what
    the next window's lazy bounds assume)."""
    c, _, port = case
    p = c.p_int
    for pa, pb in port:
        assert (pa < np.asarray(c.A.m)[:, None]).all()
        assert (pb < np.asarray(c.B.m)[:, None]).all()
        assert all(_crt(c.A, pa[:, j]) < 3 * p for j in range(N_LANES))
