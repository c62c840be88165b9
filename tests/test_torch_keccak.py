"""The port's Keccak plane against the JAX package's: ``f1600_plain``
(the plain version of the CUDA kernel) against the jnp ``f1600``, the
Pallas ``f1600_pallas`` in interpret mode and the numpy ``f1600_ref``;
the absorb and squeeze drivers against ``hashlib.shake_128/256``
across rate boundaries; ``pack_blocks``, ``lanes_to_bytes`` and
``bits_to_lanes`` against the JAX package's. Tolerance: exact, bit for
bit (the port's int32 words viewed as uint32).
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cap_tpu.tpu import pallas_keccak as KK

from cap_tpu_torch.gpu import cuda_keccak
from cap_tpu_torch.gpu import keccak as TK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(seed: int, lead) -> np.ndarray:
    """Interleaved uint32 states [*lead, 25, 2] of random lanes, the
    all-zero state first."""
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, 2 ** 64, lead + (25,), dtype=np.uint64)
    lanes.reshape(-1, 25)[0] = 0
    lanes.reshape(-1, 25)[-1] = np.uint64(2 ** 64 - 1)
    return KK.interleave(lanes)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_host_tables_equal_the_jax_package():
    for name in ("RC64", "RHO", "PI_DEST", "PI_SRC", "RC_IL"):
        assert np.array_equal(getattr(TK, name), getattr(KK, name)), name
    lanes = np.random.default_rng(1).integers(0, 2 ** 64, 64,
                                              dtype=np.uint64)
    assert np.array_equal(TK.interleave(lanes), KK.interleave(lanes))
    assert np.array_equal(TK.deinterleave(KK.interleave(lanes)), lanes)


@pytest.mark.parametrize("lead", [(1,), (3, 7)], ids=["1", "3x7"])
def test_plain_permutation_equals_jax_and_reference(lead):
    s = _states(len(lead), lead)
    got = _u32(cuda_keccak.f1600(_t(s)))
    assert np.array_equal(got, np.asarray(KK.f1600(jnp.asarray(s))))
    assert np.array_equal(
        got, KK.interleave(KK.f1600_ref(KK.deinterleave(s))))
    assert np.array_equal(TK.f1600_ref(KK.deinterleave(s)),
                          KK.f1600_ref(KK.deinterleave(s)))


def test_plain_permutation_equals_pallas_interpret():
    s = _states(5, (40,))
    want = np.asarray(KK.f1600_pallas(jnp.asarray(s), interpret=True))
    assert np.array_equal(_u32(TK.f1600_plain(_t(s))), want)


def test_permute_counts_no_launch_on_cpu_and_refuses_other_devices():
    s = _t(_states(6, (4,)))
    before = cuda_keccak.launches
    assert torch.equal(TK.permute(s), TK.f1600_plain(s))
    assert cuda_keccak.launches == before
    with pytest.raises(ValueError):
        cuda_keccak.f1600(s.to("meta"))


LENS = [0, 1, 135, 136, 137, 167, 168, 169, 271, 272, 273, 500]


@pytest.mark.parametrize("rate,fn", [(136, hashlib.shake_256),
                                     (168, hashlib.shake_128)],
                         ids=["shake256", "shake128"])
def test_drivers_equal_hashlib_across_rate_boundaries(rate, fn):
    """Masked absorb of a mixed-length batch, then squeezes across
    the rate: every message's output equals hashlib's."""
    rng = np.random.default_rng(rate)
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in LENS]
    blocks, nblk = TK.pack_blocks(msgs, rate, min_blocks=5)
    jb, jn = KK.pack_blocks(msgs, rate, min_blocks=5)
    assert np.array_equal(blocks, jb) and np.array_equal(nblk, jn)
    state = TK.absorb(_t(blocks), torch.from_numpy(nblk))
    out = TK.lanes_to_bytes(TK.squeeze_lanes(state, rate, 3)).numpy()
    for i, m in enumerate(msgs):
        assert bytes(out[i].astype(np.uint8)) == \
            fn(m).digest(3 * rate), len(m)


def test_absorb_fixed_equals_the_masked_absorb_at_full_counts():
    rng = np.random.default_rng(8)
    msgs = [rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
            for _ in range(3)]
    blocks, nblk = TK.pack_blocks(msgs, 136)
    b = _t(blocks)
    assert torch.equal(TK.absorb_fixed(b),
                       TK.absorb(b, torch.from_numpy(nblk)))


def test_lanes_to_bytes_and_bits_to_lanes_equal_jax():
    lanes = _states(9, (3, 17))
    want = np.asarray(KK.lanes_to_bytes(jnp.asarray(lanes)))
    got = TK.lanes_to_bytes(_t(lanes)).numpy()
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))
    bits = np.random.default_rng(10).integers(0, 2, (4, 3 * 64))
    want = np.asarray(KK.bits_to_lanes(jnp.asarray(bits.astype(np.uint32))))
    got = TK.bits_to_lanes(torch.from_numpy(bits))
    assert np.array_equal(_u32(got), want)


# -- the lane split of csrc/keccak.cu, modelled in numpy ----------------------

def _funnel_rotl(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """__funnelshift_l(v, v, s) on uint32 words: a rotation by s & 31."""
    w = v.astype(np.uint64)
    w = (w << np.uint64(32)) | w
    return ((w << (s.astype(np.uint64) & np.uint64(31))) >> np.uint64(32)
            ).astype(np.uint32)


def _lane_split_f1600(words: np.ndarray) -> np.ndarray:
    """keccak_kernel on uint32 states [n, 25, 2], one array column a
    thread of a warp (32, the last 7 idle on zero words): every exchange
    is ``v[:, src]`` through a row of ``keccak.LANE_TAB``, every
    per-thread constant a row of it, as the kernel loads them."""
    tab = {name: TK.LANE_TAB[i].astype(np.int64)
           for i, name in enumerate(TK.LANE_TAB_ROWS)}
    n = words.shape[0]
    e = np.zeros((n, 32), np.uint32)
    o = np.zeros((n, 32), np.uint32)
    e[:, :25], o[:, :25] = words[..., 0], words[..., 1]
    swap = tab["swap"].astype(np.uint32)
    iota = tab["iota"].astype(np.uint32)
    one = np.ones(32, np.int64)
    for rc in TK.RC_IL:
        se, so = e ^ e[:, tab["up1"]], o ^ o[:, tab["up1"]]
        ce = se ^ se[:, tab["up2"]] ^ e[:, tab["up4"]]
        co = so ^ so[:, tab["up2"]] ^ o[:, tab["up4"]]
        e = e ^ ce[:, tab["xm1"]] ^ _funnel_rotl(co[:, tab["xp1"]], one)
        o = o ^ co[:, tab["xm1"]] ^ ce[:, tab["xp1"]]
        be = _funnel_rotl((o & swap) | (e & ~swap), tab["re"])
        bo = _funnel_rotl((e & swap) | (o & ~swap), tab["ro"])
        b0e, b0o = be[:, tab["pi0"]], bo[:, tab["pi0"]]
        b1e, b1o = be[:, tab["pi1"]], bo[:, tab["pi1"]]
        b2e, b2o = be[:, tab["pi2"]], bo[:, tab["pi2"]]
        e = b0e ^ (~b1e & b2e) ^ (np.uint32(rc[0]) & iota)
        o = b0o ^ (~b1o & b2o) ^ (np.uint32(rc[1]) & iota)
    return np.stack([e[:, :25], o[:, :25]], axis=-1)


def test_lane_tables_pin_the_jax_package_constants():
    """The per-thread tables the kernel uploads, row by row, against the
    JAX package's ρ amounts and π map; idle threads read themselves."""
    tab = dict(zip(TK.LANE_TAB_ROWS, TK.LANE_TAB.astype(np.int64)))
    assert TK.LANE_TAB.shape == (len(TK.LANE_TAB_ROWS), 32)
    assert TK.LANE_TAB.dtype == np.int32
    lanes = np.arange(25)
    x, y = lanes % 5, lanes // 5
    assert np.array_equal(tab["re"][:25], KK._RHO_RE)
    assert np.array_equal(tab["ro"][:25], KK._RHO_RO)
    assert np.array_equal(tab["swap"][:25], -KK._RHO_SWAP.astype(np.int64))
    # pi0 of the lane π sends lane l to is l
    assert np.array_equal(tab["pi0"][KK.PI_DEST], lanes)
    assert np.array_equal(tab["pi1"][:25],
                          tab["pi0"][(x + 1) % 5 + 5 * y])
    assert np.array_equal(tab["pi2"][:25],
                          tab["pi0"][(x + 2) % 5 + 5 * y])
    for name, dx, dy in (("up1", 0, 1), ("up2", 0, 2), ("up4", 0, 4),
                         ("xm1", -1, 0), ("xp1", 1, 0)):
        assert np.array_equal(tab[name][:25],
                              (x + dx) % 5 + 5 * ((y + dy) % 5)), name
    assert np.array_equal(tab["iota"][:25], -(lanes == 0).astype(np.int64))
    idle = np.arange(25, 32)
    for name in ("up1", "up2", "up4", "xm1", "xp1", "pi0", "pi1", "pi2"):
        assert np.array_equal(tab[name][25:], idle), name
    for name in ("re", "ro", "swap", "iota"):
        assert not tab[name][25:].any(), name


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_split_model_equals_the_references(seed):
    """The kernel's lane split on seeded states (the all-zero and the
    all-ones state among them), bit for bit against ``f1600_ref`` and
    the JAX package's ``f1600`` and ``f1600_pallas`` in interpret mode."""
    s = _states(20 + seed, (33,))
    got = _lane_split_f1600(s)
    assert np.array_equal(
        got, KK.interleave(KK.f1600_ref(KK.deinterleave(s))))
    assert np.array_equal(got, np.asarray(KK.f1600(jnp.asarray(s))))
    assert np.array_equal(got, np.asarray(
        KK.f1600_pallas(jnp.asarray(s), interpret=True)))
    assert np.array_equal(got, _u32(TK.f1600_plain(_t(s))))
