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
