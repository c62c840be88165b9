"""The mixed-add kernels' integer RNS arithmetic (``csrc/rns_int.cuh``),
modelled in numpy: the constant buffer of ``cuda_madd.madd_consts``,
the Barrett reduction without float conversions, and the base extension
with whole weights and the α correction folded into one sum, word for
word against the JAX package's split extension
(``cap_tpu.tpu.rns._extend``), live.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: E402

from cap_tpu.tpu import ec_rns as j_ec_rns  # noqa: E402
from cap_tpu.tpu import rns as j_rns  # noqa: E402

from cap_tpu_torch.gpu import cuda_madd  # noqa: E402
from cap_tpu_torch.gpu import ec_rns as t_ec_rns  # noqa: E402

CURVES = ["P-256", "P-384", "P-521"]
SHAPES = {"P-256": (23, 23), "P-384": (34, 33), "P-521": (45, 45)}
CSRC = Path(cuda_madd.__file__).resolve().parent / "csrc"


def _fields(c) -> dict:
    """The madd_consts buffer of context ``c``, cut into its named
    arrays (int64)."""
    buf = cuda_madd.madd_consts(c, "cpu").numpy().astype(np.int64)
    lay = cuda_madd.madd_layout(c.A.count, c.B.count)
    assert buf.size == lay["words"][0]
    return {name: buf[off:off + int(np.prod(shape))].reshape(shape)
            for name, (off, shape) in lay.items() if name != "words"}


def _split_weights(c):
    """(hi, lo) 7-bit halves of both extension matrices, as the
    context's ``W_AB``/``W_BA`` hold them for the plain extension."""
    return tuple(tuple(np.asarray(w, np.int64) for w in pair)
                 for pair in (c.W_AB, c.W_BA))


def bred(v, m, mu):
    """The kernels' Barrett reduction: q = umulhi(v, μ), r = v − q·m,
    one conditional subtract (uint64 model of the 32-bit ops)."""
    v = np.asarray(v, np.uint64)
    q = (v * np.asarray(mu, np.uint64)) >> np.uint64(32)
    r = v.astype(np.int64) - q.astype(np.int64) * np.asarray(m, np.int64)
    assert (r >= 0).all() and (r < 2 * np.asarray(m, np.int64)).all()
    return np.where(r >= m, r - m, r)


def extend_model(sig, alpha, w, neg, m, mu):
    """Whole-weight extension of σ [I_src, N] to [I_dst, N]: Σ_i σ_i·w_ji
    plus α_adj·((−src) mod m_j), one reduction (α_adj = α + m_j where
    α = −1)."""
    acc = w.astype(np.int64) @ sig.astype(np.int64)
    aadj = np.where(alpha[None, :] < 0, alpha[None, :] + m[:, None],
                    alpha[None, :])
    total = acc + aadj * neg[:, None]
    assert total.max() < 2 ** 31
    return bred(total, m[:, None], mu[:, None])


def test_layout_matches_the_kernel_header():
    """madd_layout lists KLayout's fields (rns_int.cuh) in its order."""
    src = (CSRC / "rns_int.cuh").read_text()
    body = src[src.index("struct KLayout"):]
    body = body[:body.index("};")]
    names = [n for n in re.findall(r"static constexpr int (\w+) =", body)
             if n not in ("PA", "PB", "SA", "SB")]
    assert names == list(cuda_madd.madd_layout(23, 23))


@pytest.mark.parametrize("crv", CURVES)
def test_whole_weights_are_the_split_halves(crv):
    c = t_ec_rns.ctx_for(crv)
    ia, ib = c.A.count, c.B.count
    assert (ia, ib) == SHAPES[crv]
    f = _fields(c)
    (whab, wlab), (whba, wlba) = _split_weights(c)
    mA, mB = f["mA"][:ia], f["mB"][:ib]
    assert np.array_equal(f["wAB"][:ib, :ia], whab * 128 + wlab)
    assert np.array_equal(f["wBA"][:ia, :ib], whba * 128 + wlba)
    assert (f["wAB"][:ib, :ia] < mB[:, None]).all()
    assert (f["wBA"][:ia, :ib] < mA[:, None]).all()
    # padding rows and columns are zero
    assert not f["wAB"][ib:].any() and not f["wAB"][:, ia:].any()
    assert not f["wBA"][ia:].any() and not f["wBA"][:, ib:].any()


@pytest.mark.parametrize("crv", CURVES)
def test_barrett_and_correction_constants(crv):
    c = t_ec_rns.ctx_for(crv)
    ia, ib = c.A.count, c.B.count
    f = _fields(c)
    for side, count, base in (("A", ia, c.A), ("B", ib, c.B)):
        m = f["m" + side]
        assert np.array_equal(m[:count], base.m)
        assert (m[count:] == cuda_madd.PAD_M).all()
        assert np.array_equal(f["mu" + side], (1 << 32) // m)
        assert (m < 1 << 13).all()
        cp = np.asarray(c.cp_A if side == "A" else c.cp_B, np.int64)
        mm = m[:count]
        assert np.array_equal(f["k16" + side][:count], cp[16] + mm)
        assert np.array_equal(f["k4" + side][:count], cp[4] + mm)
        assert np.array_equal(f["k8" + side][:count], cp[8] + 2 * mm)
        assert np.array_equal(f["one" + side][:count],
                              [c.a_mod_p % int(v) for v in mm])
    assert np.array_equal(f["negAB"][:ib],
                          [(-c.A.prod) % int(v) for v in c.B.m])
    assert np.array_equal(f["negBA"][:ia],
                          [(-c.B.prod) % int(v) for v in c.A.m])
    assert np.array_equal(f["invA"][:ia].astype(np.int32).view(np.float32),
                          np.asarray(c.dA["inv_f"], np.float32))
    assert np.array_equal(f["probe"],
                          np.asarray(c.cp_A, np.int64)[:20, :2])


@pytest.mark.parametrize("crv", CURVES)
def test_extension_sum_stays_below_2_31(crv):
    """The largest Σ σ_i·w_ji + α_adj·neg_j the kernels can form (every
    σ_i at m_i − 1, α_adj at m_j − 1), from the contexts' constants."""
    c = t_ec_rns.ctx_for(crv)
    ia, ib = c.A.count, c.B.count
    f = _fields(c)
    mA, mB = f["mA"][:ia], f["mB"][:ib]
    for w, m_src, m_dst, neg in (
            (f["wAB"][:ib, :ia], mA, mB, f["negAB"][:ib]),
            (f["wBA"][:ia, :ib], mB, mA, f["negBA"][:ia])):
        worst = w @ (m_src - 1) + (m_dst - 1) * neg
        assert worst.max() < 2 ** 31
        assert worst.max() < 1.1e9


@pytest.mark.parametrize("crv", CURVES)
def test_barrett_model_is_exact(crv):
    """bred equals v mod m at the edges and on 10^6 seeded values below
    2^31, for every modulus of the context."""
    c = t_ec_rns.ctx_for(crv)
    rng = np.random.default_rng(SHAPES[crv][0])
    vals = rng.integers(0, 2 ** 31, 10 ** 6, dtype=np.int64)
    for m in list(c.A.m) + list(c.B.m):
        m = int(m)
        mu = (1 << 32) // m
        edges = np.array([0, 1, m - 1, m, m + 1, 2 * m - 1, 2 * m,
                          2 ** 31 - 1, (2 ** 31 - 1) // m * m,
                          (2 ** 31 - 1) // m * m - 1]
                         + [k * m + d for k in (3, 4900, 10 ** 5, 4 * 10 ** 5)
                            for d in (-1, 0, 1)], np.int64)
        for v in (edges, vals):
            assert np.array_equal(bred(v, m, mu), v % m), m


@pytest.mark.parametrize("direction", ["A->B", "B->A"])
@pytest.mark.parametrize("crv", CURVES)
def test_whole_weight_extension_matches_jax(crv, direction):
    """The numpy model of the kernels' extension, on the madd_consts
    buffer, against cap_tpu.tpu.rns._extend (7-bit halves, three
    reductions and a separate α correction) on seeded σ, word for word.
    Both take the α the JAX function computes (a float32 sum, whose
    order the kernels do not share with XLA)."""
    jc = j_ec_rns.ctx_for(crv)
    c = t_ec_rns.ctx_for(crv)
    f = _fields(c)
    ia, ib = c.A.count, c.B.count
    if direction == "A->B":
        src, src_dev, dst_dev = jc.A, jc.dA, jc.dB
        w_pair, smod = jc.W_AB, jc.Amod_B
        w, neg = f["wAB"][:ib, :ia], f["negAB"][:ib]
        m, mu = f["mB"][:ib], f["muB"][:ib]
        offset = -1e-4
    else:
        src, src_dev, dst_dev = jc.B, jc.dB, jc.dA
        w_pair, smod = jc.W_BA, jc.Bmod_A
        w, neg = f["wBA"][:ia, :ib], f["negBA"][:ia]
        m, mu = f["mA"][:ia], f["muA"][:ia]
        offset = 0.5 - 1e-4
    rng = np.random.default_rng([ia, ib, direction == "A->B"])
    n = 2048
    m_src = np.asarray(src.m, np.int64)[:, None]
    sig = (rng.integers(0, 2 ** 31, (src.count, n)) % m_src).astype(np.int32)
    sig[:, 0] = 0
    sig[:, 1] = (m_src - 1)[:, 0]
    want = np.asarray(j_rns._extend(jnp.asarray(sig), src_dev, dst_dev,
                                    w_pair, smod, offset))
    alpha = np.asarray(jnp.floor(
        jnp.sum(jnp.asarray(sig).astype(jnp.float32)
                * src_dev["inv_f"][:, None], axis=0)
        + offset).astype(jnp.int32)).astype(np.int64)
    got = extend_model(sig, alpha, w, neg, m, mu)
    assert np.array_equal(got, want.astype(np.int64))
