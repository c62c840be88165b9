"""The port's ML-DSA NTT against the JAX package's: ``ntt_plain`` and
``intt_plain`` (the plain versions of the CUDA kernels) against
``ntt.ntt``/``ntt.intt`` on the jnp path, against the Pallas
``ntt_fused``/``intt_fused`` in interpret mode, and against the numpy
``ntt_ref``/``intt_ref``; the round trip, the edge values 0 and q − 1,
and UseHint at both γ2. Tolerance: exact, value for value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cap_tpu.tpu import ntt as j_ntt
from cap_tpu.tpu import pallas_ntt

from cap_tpu_torch.gpu import cuda_ntt
from cap_tpu_torch.gpu import ntt as t_ntt

Q = t_ntt.Q
GAMMA2 = ((Q - 1) // 88, (Q - 1) // 32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(seed: int, lead=(3, 5)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, lead + (256,), dtype=np.int64)
    x.reshape(-1, 256)[0, :8] = [0, Q - 1, 1, Q - 2, 0, 0, Q - 1, Q - 1]
    return x


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int32))


def test_constants_equal_the_jax_package():
    assert t_ntt.Q == j_ntt.Q and t_ntt.NQINV == j_ntt.NQINV
    for name in ("ZETAS", "ZETAS_MONT", "NEG_ZETAS_MONT"):
        assert np.array_equal(getattr(t_ntt, name), getattr(j_ntt, name))
    assert t_ntt.INV256_MONT == j_ntt.INV256_MONT


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_ntt_equals_jax_and_reference(seed):
    x = _rows(seed)
    got = t_ntt.ntt_plain(_t(x)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(j_ntt.ntt(
        jnp.asarray(x.astype(np.uint32)))).astype(np.int64))
    assert np.array_equal(got, j_ntt.ntt_ref(x))


@pytest.mark.parametrize("seed", [2, 3])
def test_plain_intt_equals_jax_and_reference(seed):
    x = _rows(seed)
    got = t_ntt.intt_plain(_t(x)).numpy()
    assert np.array_equal(got, np.asarray(j_ntt.intt(
        jnp.asarray(x.astype(np.uint32)))).astype(np.int64))
    assert np.array_equal(got, j_ntt.intt_ref(x))


@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
def test_plain_equals_pallas_interpret(inverse):
    """A few hundred rows: one full 256-row tile and a ragged one."""
    x = _rows(7 + inverse, lead=(300,))
    xs = jnp.asarray(x.astype(np.uint32))
    if inverse:
        want = pallas_ntt.intt_fused(xs, interpret=True)
        got = t_ntt.intt_plain(_t(x))
    else:
        want = pallas_ntt.ntt_fused(xs, interpret=True)
        got = t_ntt.ntt_plain(_t(x))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_round_trip_and_edge_values():
    edge = np.stack([np.zeros(256, np.int64), np.full(256, Q - 1),
                     np.arange(256) % 2 * (Q - 1)])
    x = np.concatenate([edge, _rows(11, lead=(5,))])
    fwd = t_ntt.ntt_plain(_t(x))
    assert np.array_equal(fwd.numpy(), j_ntt.ntt_ref(x))
    assert np.array_equal(t_ntt.intt_plain(fwd).numpy(), x)
    assert np.array_equal(t_ntt.ntt_plain(t_ntt.intt_plain(_t(x))).numpy(),
                          x)
    assert not fwd[0].any()


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    x = _t(_rows(12))
    before = (cuda_ntt.ntt_launches, cuda_ntt.intt_launches)
    assert torch.equal(t_ntt.ntt(x), t_ntt.ntt_plain(x))
    assert torch.equal(t_ntt.intt(x), t_ntt.intt_plain(x))
    assert (cuda_ntt.ntt_launches, cuda_ntt.intt_launches) == before
    with pytest.raises(ValueError):
        cuda_ntt.ntt(x.to("meta"))
    with pytest.raises(ValueError):
        cuda_ntt.intt(x.to("meta"))


def test_mont_mul_equals_jax():
    rng = np.random.default_rng(13)
    a = rng.integers(0, Q, 4096, dtype=np.int64)
    b = rng.integers(0, Q, 4096, dtype=np.int64)
    a[:3], b[:3] = [0, Q - 1, Q - 1], [Q - 1, Q - 1, 1]
    want = np.asarray(j_ntt.mont_mul(jnp.asarray(a.astype(np.uint32)),
                                     jnp.asarray(b.astype(np.uint32))))
    got = t_ntt.mont_mul(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("gamma2", GAMMA2)
def test_use_hint_equals_jax_at_both_gamma2(gamma2):
    rng = np.random.default_rng(gamma2)
    r = rng.integers(0, Q, (4, 256), dtype=np.int64)
    # the wrap: r − r0 = q − 1, and both sides of every decomposition
    r[0, :6] = [0, Q - 1, Q - 1 - gamma2, Q - gamma2, gamma2,
                2 * gamma2]
    h = rng.integers(0, 2, (4, 256), dtype=np.int64)
    h[0, :6] = 1
    want = np.asarray(j_ntt.use_hint(jnp.asarray(h.astype(np.uint8)),
                                     jnp.asarray(r.astype(np.uint32)),
                                     gamma2))
    got = t_ntt.use_hint(torch.from_numpy(h.astype(np.uint8)),
                         torch.from_numpy(r.astype(np.int32)), gamma2)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(got.numpy(), j_ntt.use_hint_ref(h, r, gamma2))


# -- the warp-a-row schedule of csrc/ntt.cu's ntt_fwd_kernel, in numpy ------

def _mont(a: np.ndarray, b) -> np.ndarray:
    """mont_mul of ntt.cu on uint64-held words: the REDC, step by step."""
    m32 = np.uint64(0xFFFFFFFF)
    p = a.astype(np.uint64) * np.uint64(b) if np.isscalar(b) else \
        a.astype(np.uint64) * b.astype(np.uint64)
    m = ((p & m32) * np.uint64(t_ntt.NQINV)) & m32
    u = (p + m * np.uint64(Q)) >> np.uint64(32)
    return np.where(u >= Q, u - np.uint64(Q), u)


def _pad(i):
    return i + ((i >> 5) << 2)


def _warp_schedule_ntt(x: np.ndarray) -> np.ndarray:
    """ntt_fwd_kernel on int64 rows [rows, 256]: one array row a warp,
    one column a thread, 8 registers each. Each register carries its
    coefficient index beside its value; every butterfly checks that it
    pairs indices ln apart and that the kernel's twiddle index is the
    stage's ZETAS[2^s + i / 2ln]."""
    zm = t_ntt.ZETAS_MONT.astype(np.uint64)
    rows = x.shape[0]
    t = np.arange(32)
    k = t >> 2
    idx = np.stack([t + 32 * j for j in range(8)], axis=-1)   # [32, 8]
    val = x.astype(np.uint64)[:, idx]                          # [rows,32,8]
    # the kernel's twiddle index of stage s, register j, thread t
    zidx = [lambda j: np.full(32, 1), lambda j: np.full(32, 2 + (j >> 2)),
            lambda j: np.full(32, 4 + (j >> 1)), lambda j: 8 + k,
            lambda j: 16 + 2 * k + (j >> 2), lambda j: 32 + 4 * k + (j >> 1),
            lambda j: 64 + 2 * t + (j >> 2), lambda j: 128 + 4 * t + (j >> 1)]

    def stage(s, half):
        ln = 128 >> s
        for j in range(8):
            if j & half:
                continue
            a, b = idx[:, j], idx[:, j + half]
            z = zidx[s](j)
            assert (b - a == ln).all() and \
                (z == (1 << s) + a // (2 * ln)).all(), (s, j)
            tt = _mont(val[:, :, j + half], zm[z])
            lo = val[:, :, j]
            val[:, :, j + half] = np.where(lo >= tt, lo - tt, lo + Q - tt)
            su = lo + tt
            val[:, :, j] = np.where(su >= Q, su - Q, su)

    def relayout(write, read):
        """Through a per-warp tile: register j of thread t to word
        write[t, j], then register j from word read[t, j]."""
        nonlocal idx, val
        assert len(set(write.ravel())) == 256 == len(set(read.ravel()))
        for j in range(8):
            # 32 distinct banks for each register's access
            assert len(set(write[:, j] % 32)) == 32
        tile_i = np.full(288, -1)
        tile_v = np.zeros((rows, 288), np.uint64)
        tile_i[write] = idx
        tile_v[:, write] = val
        idx, val = tile_i[read], tile_v[:, read]

    for s, half in ((0, 4), (1, 2), (2, 1)):
        stage(s, half)
    mid = ((t & 3) + 32 * k)[:, None] + 4 * np.arange(8)
    relayout(_pad(t[:, None] + 32 * np.arange(8)), _pad(mid))
    for j in range(8):
        assert len(set(_pad(mid[:, j]) % 32)) == 32
    assert np.array_equal(idx, mid)
    for s, half in ((3, 4), (4, 2), (5, 1)):
        stage(s, half)
    # the 16-byte reads: words pad(8t) + 0..3 and pad(8t + 4) + 0..3
    base = np.stack([_pad(8 * t), _pad(8 * t + 4)], axis=-1)
    read = (base[:, :, None] + np.arange(4)).reshape(32, 8)
    assert (base % 4 == 0).all()
    # a quarter warp's 16-byte reads cover the 8 bank quads once
    for q in range(4):
        for h in range(2):
            assert len(set(base[8 * q: 8 * q + 8, h] // 4 % 8)) == 8
    relayout(_pad(mid), read)
    assert np.array_equal(idx, 8 * t[:, None] + np.arange(8))
    for s, half in ((6, 2), (7, 1)):
        stage(s, half)
    out = np.zeros((rows, 256), np.int64)
    out[:, idx] = val.astype(np.int64)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_schedule_model_equals_the_references(seed):
    """The forward kernel's register layouts, re-layouts and twiddle
    indices, exact against ``ntt_ref``, the plain version and the JAX
    package's ``ntt_fused`` in interpret mode (edge rows of 0 and q − 1
    among seeded ones)."""
    x = np.concatenate([np.stack([np.zeros(256, np.int64),
                                  np.full(256, Q - 1)]),
                        _rows(30 + seed, lead=(40,))])
    got = _warp_schedule_ntt(x)
    assert np.array_equal(got, j_ntt.ntt_ref(x))
    assert np.array_equal(got, t_ntt.ntt_plain(_t(x)).numpy())
    want = pallas_ntt.ntt_fused(jnp.asarray(x.astype(np.uint32)),
                                interpret=True)
    assert np.array_equal(got, np.asarray(want).astype(np.int64))


# -- the warp-a-row schedule of csrc/ntt.cu's intt_kernel, in numpy --------

def _banks_once(words: np.ndarray) -> None:
    """A warp's 4-byte tile accesses, [32, 8] words: each register's
    32 words in 32 distinct banks."""
    for j in range(8):
        assert len(set(words[:, j] % 32)) == 32, j


def _quads_once(base: np.ndarray) -> None:
    """A warp's 16-byte tile accesses, [32, 2] first words: aligned,
    and each quarter warp's 8 words cover the 8 bank quads once."""
    assert (base % 4 == 0).all()
    for q in range(4):
        for h in range(2):
            assert len(set(base[8 * q: 8 * q + 8, h] // 4 % 8)) == 8


def _warp_schedule_intt(x: np.ndarray) -> np.ndarray:
    """intt_kernel on int64 rows [rows, 256]: one array row a warp, one
    column a thread, 8 registers each, each carrying its coefficient
    index beside its value. Every Gentleman–Sande butterfly checks
    that it pairs indices ln apart and that the kernel's twiddle index
    is the stage's NEG_ZETAS[2·nblk − 1 − i / 2ln]; every tile access
    its banks. The last stage folds in the 256⁻¹ scale: its sum times
    INV256, its difference times mont_mul(NEG_ZETAS[1], INV256)."""
    nz = t_ntt.NEG_ZETAS_MONT.astype(np.uint64)
    inv = np.uint64(t_ntt.INV256_MONT)
    neg1_inv = _mont(np.array([nz[1]]), inv)[0]
    rows = x.shape[0]
    t = np.arange(32)
    k = t >> 2
    # the 16-byte row loads: register j holds 8t + j
    idx = 8 * t[:, None] + np.arange(8)                       # [32, 8]
    val = x.astype(np.uint64)[:, idx]                          # [rows,32,8]
    # the kernel's twiddle index of stage s (ln = 2^s), register j,
    # thread t
    zidx = [lambda j: 255 - 4 * t - (j >> 1), lambda j: 127 - 2 * t - (j >> 2),
            lambda j: 63 - 4 * k - (j >> 1), lambda j: 31 - 2 * k - (j >> 2),
            lambda j: 15 - k, lambda j: np.full(32, 7 - (j >> 1)),
            lambda j: np.full(32, 3 - (j >> 2)), lambda j: np.full(32, 1)]

    def stage(s, half):
        ln, nblk = 1 << s, 128 >> s
        for j in range(8):
            if j & half:
                continue
            a, b = idx[:, j], idx[:, j + half]
            z = zidx[s](j)
            assert (b - a == ln).all() and \
                (z == 2 * nblk - 1 - a // (2 * ln)).all(), (s, j)
            lo, hi = val[:, :, j], val[:, :, j + half]
            d = np.where(lo >= hi, lo - hi, lo + Q - hi)
            su = lo + hi
            su = np.where(su >= Q, su - Q, su)
            if s < 7:
                val[:, :, j], val[:, :, j + half] = su, _mont(d, nz[z])
            else:
                val[:, :, j], val[:, :, j + half] = (_mont(su, inv),
                                                     _mont(d, neg1_inv))

    def relayout(write, read):
        """Register j of thread t to tile word write[t, j], then
        register j from word read[t, j]."""
        nonlocal idx, val
        assert len(set(write.ravel())) == 256 == len(set(read.ravel()))
        tile_i = np.full(288, -1)
        tile_v = np.zeros((rows, 288), np.uint64)
        tile_i[write] = idx
        tile_v[:, write] = val
        idx, val = tile_i[read], tile_v[:, read]

    for s, half in ((0, 1), (1, 2)):
        stage(s, half)
    # tile A: two 16-byte words at pad(8t) and pad(8t + 4), read back
    # at pad(mid + 4j)
    base = np.stack([_pad(8 * t), _pad(8 * t + 4)], axis=-1)
    _quads_once(base)
    mid = ((t & 3) + 32 * k)[:, None] + 4 * np.arange(8)
    _banks_once(_pad(mid))
    relayout((base[:, :, None] + np.arange(4)).reshape(32, 8), _pad(mid))
    assert np.array_equal(idx, mid)
    for s, half in ((2, 1), (3, 2), (4, 4)):
        stage(s, half)
    # tile B: written at pad(mid + 4j), read back at pad(t + 32j)
    wide = t[:, None] + 32 * np.arange(8)
    _banks_once(_pad(wide))
    relayout(_pad(mid), _pad(wide))
    assert np.array_equal(idx, wide)
    for s, half in ((5, 1), (6, 2), (7, 4)):
        stage(s, half)
    # stored 4 bytes a thread at t + 32j: coalesced
    out = np.zeros((rows, 256), np.int64)
    out[:, idx] = val.astype(np.int64)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_warp_schedule_model_equals_the_references(seed):
    """The inverse kernel's register layouts, re-layouts, tile banks,
    twiddle indices and folded scale, exact against ``intt_ref``, the plain version and
    the JAX package's ``intt_fused`` in interpret mode (edge rows of 0
    and q − 1 among seeded ones)."""
    x = np.concatenate([np.stack([np.zeros(256, np.int64),
                                  np.full(256, Q - 1)]),
                        _rows(40 + seed, lead=(40,))])
    got = _warp_schedule_intt(x)
    assert np.array_equal(got, j_ntt.intt_ref(x))
    assert np.array_equal(got, t_ntt.intt_plain(_t(x)).numpy())
    want = pallas_ntt.intt_fused(jnp.asarray(x.astype(np.uint32)),
                                 interpret=True)
    assert np.array_equal(got, np.asarray(want).astype(np.int64))
