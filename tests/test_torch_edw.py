"""The port's Ed25519 ladder-window mixed add against the JAX package's:
``edw_ref`` (the plain mixed add) against the Pallas ``_edw_kernel`` in
interpret mode and against ``ed25519_rns._edw_madd_rns`` (XLA), on one
512-lane tile; ``edw_window_ref`` (the plain version of the CUDA
kernel, gather included) over the port's packed row-major table, built
from the JAX package's tables, against the Pallas kernel on the rows
``jnp.take`` gathers; the packed table and the window rows against the
JAX package's columns and per-window index.

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
from cap_tpu_torch.gpu.ed25519 import _B_POINT, ext_add, normalize, to_ext

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


@pytest.fixture(scope="module")
def tables():
    """The JAX package's window tables (the basepoint's and one key's,
    the point 2B) and the port's packed device table built from them."""
    b = to_ext(_B_POINT)
    key = normalize([ext_add(b, b)])[0]
    j_tna = j_er.Ed25519RNSKeyTable([key]).tna
    j_tb = j_er.b_table_rns()
    port = t_er.Ed25519RNSKeyTable(
        [key], tna=tuple(np.ascontiguousarray(np.asarray(t).T)
                         for t in j_tna),
        tb=tuple(np.ascontiguousarray(np.asarray(t).T) for t in j_tb))
    cat = [np.concatenate([np.asarray(b), np.asarray(a)])
           for b, a in zip(j_tb, j_tna)]        # 3 × [rows, I_A + I_B]
    return cat, port.device_tab("cpu")


def test_device_table_decodes_to_the_jax_columns(tables):
    """Row r of the packed table holds, word for word, row r of the JAX
    package's (basepoint ‖ keys) triples: A channel c in the low 16
    bits of word c, B channel c in the high 16."""
    cat, tab = tables
    c = t_er.ctx()
    ia, ib = c.A.count, c.B.count
    iap = max(ia, ib)
    tab = tab.numpy()
    assert tab.dtype == np.int32 and tab.shape == (cat[0].shape[0], 3 * iap)
    for t in range(3):
        words = tab[:, t * iap:(t + 1) * iap]
        assert np.array_equal(words[:, :ia] & 0xFFFF, cat[t][:, :ia])
        assert np.array_equal(words[:, :ib] >> 16, cat[t][:, ia:])


def test_window_rows_match_the_jax_ladder_index():
    """window_rows equals, window for window, the JAX ladder's gather
    index (cap_tpu.tpu.ed25519_rns._ed25519_rns_core's ``idx``)."""
    rng = np.random.default_rng(3)
    n, nk = 300, 5
    dig1 = rng.integers(0, 256, (j_er.NW8, n))
    dig2 = rng.integers(0, 256, (j_er.NW8, n))
    key_idx = rng.integers(0, nk, n)
    rows = t_er.window_rows(torch.from_numpy(dig1), torch.from_numpy(dig2),
                            torch.from_numpy(key_idx))
    assert rows.dtype == torch.int32
    assert tuple(rows.shape) == (j_er.NW8, 2 * n)
    q_off = j_er.b_table_rns()[0].shape[0]
    key_base = jnp.asarray(key_idx, jnp.int32) * (j_er.NW8 * j_er.PER)
    for i in range(j_er.NW8):
        idx = jnp.concatenate(
            [i * j_er.PER + jnp.asarray(dig1[i], jnp.int32),
             q_off + key_base + i * j_er.PER + jnp.asarray(dig2[i],
                                                           jnp.int32)])
        assert np.array_equal(rows[i].numpy(), np.asarray(idx))


def test_edw_window_ref_matches_pallas_kernel_on_gathered_rows(tables):
    """Two ladder windows from random states < 3p: the port's plain
    window over its packed table against the Pallas kernel (interpret
    mode) on the planes ``jnp.take`` gathers from the JAX tables; the
    states equal mod p after each window."""
    cat, tab = tables
    c = t_er.ctx()
    ia = c.A.count
    p = c.p_int
    rng = np.random.default_rng(11)
    half = N_LANES // 2
    planes = [_residues(c, _rand_below(rng, 3 * p, N_LANES))
              for _ in range(4)]
    port = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in planes]
    ref = [(jnp.asarray(a), jnp.asarray(b)) for a, b in planes]
    j_cat = [jnp.asarray(t) for t in cat]
    for i in (5, 31):
        d = rng.integers(0, t_er.PER, (2, half))
        rows = np.concatenate([i * t_er.PER + d[0],
                               (t_er.NW8 + i) * t_er.PER + d[1]])
        rows = rows.astype(np.int32)
        port = cuda_edw.edw_window_ref(c, *port, tab,
                                       torch.from_numpy(rows))
        g = [jnp.take(t, jnp.asarray(rows), axis=0).T for t in j_cat]
        ref = pallas_edw.edw_madd_fused(
            j_er.ctx(), *ref, *[(v[:ia], v[ia:]) for v in g],
            interpret=True)
        _check(c, [(a.numpy(), b.numpy()) for a, b in port], ref)
