"""The mesh (``cap_tpu_torch.parallel``) against the JAX package's on
its virtual 8-device CPU mesh, live: ``make_mesh``'s devices and
errors, ``shard_batch``'s equal shards in order and the JAX package's
error for a batch the mesh size does not divide, the replicated-table
cache (hits, one copy a device, the LRU by bytes and its eviction
counter), and the three sharded steps on ``tests/test_parallel.py``'s
inputs (2 RSA-1024 keys, 32 tokens, two corrupted; the RNS step on 2
RSA-512 keys, 64 tokens): ok vectors bit-equal and totals equal.
"""

import hashlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap_tpu.parallel import mesh as jmesh
from cap_tpu.parallel import place as jplace
from cap_tpu.tpu import limbs as JL
from cap_tpu.tpu import rns as jrns
from cap_tpu.tpu.rsa import RSAKeyTable, expected_pkcs1v15_em

from cap_tpu_torch import telemetry
from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import rns as t_rns
from cap_tpu_torch.parallel import make_mesh, mesh as tmesh, place


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty replicated-table cache for the test."""
    from collections import OrderedDict

    monkeypatch.setattr(place, "_replicated_cache", OrderedDict())
    monkeypatch.setattr(place, "_replicated_cache_bytes", 0)


@pytest.fixture
def cards(monkeypatch):
    """CUDA present with 8 cards, for ``make_mesh``'s bookkeeping (no
    tensor touches a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)


def test_make_mesh_on_the_cpu_repeats_its_device():
    m = make_mesh(8, device="cpu")
    assert m.devices == (torch.device("cpu"),) * 8
    assert m.axis_names == ("dp",) == (jmesh.DP_AXIS,)
    assert place.batch_axis(m) == jplace.batch_axis(jmesh.make_mesh(8))
    assert m.distinct() == (torch.device("cpu"),)
    assert len(make_mesh(device="cpu")) == 1
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


def test_make_mesh_takes_the_first_cards(cards):
    m = make_mesh(2)
    assert m.devices == (torch.device("cuda:0"), torch.device("cuda:1"))
    assert len(make_mesh()) == 8 == jmesh.make_mesh().devices.size
    assert make_mesh(axis="batch").axis_names == ("batch",)


def test_make_mesh_too_many_cards_raises_the_reference_error(cards):
    with pytest.raises(ValueError) as port:
        make_mesh(9)
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(9)
    assert str(port.value) == str(ref.value) == \
        "requested 9 devices, have 8"


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(1)


def test_shard_batch_equal_shards_in_order_like_jax():
    arr = np.arange(128 * 3, dtype=np.int32).reshape(128, 3)
    port = place.shard_batch(make_mesh(8, device="cpu"), arr)
    ref = jplace.shard_batch(jmesh.make_mesh(8), arr)
    ref_parts = sorted(ref.addressable_shards,
                       key=lambda s: s.index[0].start)
    assert [tuple(p.shape) for p in port.parts] == [(16, 3)] * 8
    for p, r in zip(port.parts, ref_parts):
        assert np.array_equal(p.numpy(), np.asarray(r.data))
    assert np.array_equal(port.cpu().numpy(), arr)
    assert port.shape == (128, 3)


def test_shard_batch_arrays_shard_the_batch_axis_like_jax():
    a1 = np.arange(32, dtype=np.int64)
    a2 = np.arange(5 * 32, dtype=np.int64).reshape(5, 32)
    m, jm = make_mesh(4, device="cpu"), jmesh.make_mesh(4)
    p1, p2 = tmesh.shard_batch_arrays(m, a1, a2)
    r1, r2 = jmesh.shard_batch_arrays(jm, a1, a2)
    assert [tuple(p.shape) for p in p1.parts] == [(8,)] * 4
    assert [tuple(p.shape) for p in p2.parts] == [(5, 8)] * 4
    for port, ref, axis in ((p1, r1, 0), (p2, r2, 1)):
        shards = sorted(ref.addressable_shards,
                        key=lambda s: s.index[axis].start)
        for p, r in zip(port.parts, shards):
            assert np.array_equal(p.numpy(), np.asarray(r.data))


def test_a_batch_the_mesh_does_not_divide_raises_like_jax():
    """The JAX package's 8-device mesh cut to 3 refuses a 128-row batch
    with a ValueError; so does the port's, in the same words about the
    dimension."""
    arr = np.zeros((128, 4), np.uint8)
    with pytest.raises(ValueError) as ref:
        jplace.shard_batch(jmesh.make_mesh(3), arr)
    with pytest.raises(ValueError) as port:
        place.shard_batch(make_mesh(3, device="cpu"), arr)
    tail = ("should be divisible by 3, but it is equal to 128 "
            "(full shape: (128, 4))")
    assert tail in str(ref.value) and tail in str(port.value)
    with pytest.raises(ValueError, match="divisible by 3"):
        tmesh.shard_batch_arrays(make_mesh(3, device="cpu"),
                                 np.zeros((4, 10)))


def test_replicated_is_cached_per_mesh_and_tensor(fresh_cache):
    m = make_mesh(4, device="cpu")
    t = torch.arange(10)
    copies = place.replicated(m, t)
    assert len(copies) == 4 and all(c is t for c in copies)
    assert place.replicated(m, t) is copies
    other = make_mesh(4, device="cpu")
    assert place.replicated(other, t) is not copies
    host = np.arange(6, dtype=np.uint32)
    rep = place.replicated(m, host)
    assert rep[0].dtype == torch.int32 and rep[0] is rep[3]
    assert place._replicated_cache_bytes == t.numel() * 8 * 2 + 24


def test_replicated_lru_evicts_by_bytes_and_counts(fresh_cache):
    m = make_mesh(2, device="cpu")
    tabs = [torch.zeros(100_000, dtype=torch.int32) for _ in range(4)]
    with telemetry.recording() as rec:
        first = [place.replicated(m, t, cache_mb=1) for t in tabs[:2]]
        assert rec._counters.get("parallel.replicated_evictions") is None
        place.replicated(m, tabs[2], cache_mb=1)      # 1.2 MB > 1 MB
        assert rec._counters["parallel.replicated_evictions"] == 1
        assert place._replicated_cache_bytes == 800_000
        # the most recent entries stay; the evicted one is copied anew
        assert place.replicated(m, tabs[1], cache_mb=1) is first[1]
        place.replicated(m, tabs[0], cache_mb=1)
        assert rec._counters["parallel.replicated_evictions"] == 2
        place.replicated(m, tabs[3], cache_mb=1)
        assert rec._counters["parallel.replicated_evictions"] == 3
    assert len(place._replicated_cache) == 2


def test_on_shards_gives_outputs_in_batch_order():
    m = make_mesh(4, device="cpu")
    x = place.shard_batch(m, np.arange(16))
    doubled, pos = place.on_shards(
        m, lambda i, p: (p * 2, torch.full_like(p, i)), x)
    assert doubled.cpu().tolist() == [2 * j for j in range(16)]
    assert pos.cpu().tolist() == [j // 4 for j in range(16)]


def test_on_shards_advances_generator_cores_in_turns():
    """A core that yields before each host read runs on every shard to
    that read before any shard reads; the returns come back in batch
    order, and a plain shard's output beside them stays as it is."""
    m = make_mesh(3, device="cpu")
    log = []

    def core(i, p):
        log.append(("queue", i))
        yield
        log.append(("read", i))
        yield
        log.append(("tail", i))
        return p + 10 * i

    out = place.on_shards(m, core, place.shard_batch(m, np.arange(6)))
    assert out.cpu().tolist() == [0, 1, 12, 13, 24, 25]
    assert log == [(s, i) for s in ("queue", "read", "tail")
                   for i in range(3)]


def test_shard_batch_passes_a_batch_sharded_over_its_mesh():
    m, other = make_mesh(2, device="cpu"), make_mesh(2, device="cpu")
    x = place.shard_batch(m, np.arange(8))
    assert place.shard_batch(m, x) is x
    with pytest.raises(ValueError, match="is not sharded over"):
        place.shard_batch(other, x)


@pytest.fixture(scope="module")
def rsa_fixture():
    """``tests/test_parallel.py``'s inputs: 2 RSA-1024 keys (the port's
    seeded keys), 32 RS256 tokens alternating over them, the
    signatures of tokens 3 and 17 corrupted in a low limb bit."""
    rng = random.Random(0x5EED)
    digest = hashlib.sha256(b"parallel test message").digest()
    privs = [tt.generate_rsa_key(rng, 1024) for _ in range(2)]
    table = RSAKeyTable([(p.n, p.e) for p in privs])
    n_tok = 32
    key_idx = (np.arange(n_tok) % 2).astype(np.int32)
    sizes = np.asarray(table.sizes_bytes)[key_idx]
    expected = np.asarray(expected_pkcs1v15_em([digest] * n_tok, "sha256",
                                               sizes, table.k))
    ems = JL.limbs_to_ints(expected)
    s_host = np.array(JL.ints_to_limbs(
        [pow(ems[j], privs[i].d, privs[i].n)
         for j, i in enumerate(key_idx)], table.k))
    s_host[0, 3] ^= 1
    s_host[0, 17] ^= 1
    want = np.ones(n_tok, bool)
    want[3] = want[17] = False
    return table, key_idx, s_host, expected, want


def test_sharded_verify_step_equals_jax(rsa_fixture):
    table, key_idx, s, expected, want = rsa_fixture
    j_ok, j_total = jmesh.sharded_verify_step(jmesh.make_mesh(8))(
        jnp.asarray(table.n_tab), jnp.asarray(table.np_tab),
        jnp.asarray(table.r2_tab),
        *jmesh.shard_batch_arrays(jmesh.make_mesh(8), key_idx, s,
                                  expected))
    m = make_mesh(8, device="cpu")
    ok, total = tmesh.sharded_verify_step(m)(
        np.asarray(table.n_tab), np.asarray(table.np_tab),
        np.asarray(table.r2_tab),
        *tmesh.shard_batch_arrays(m, key_idx.astype(np.int64),
                                  s.astype(np.int64),
                                  expected.astype(np.int64)))
    assert ok.dtype == torch.bool and ok.shape == (32,)
    assert np.array_equal(ok.numpy(), np.asarray(j_ok))
    assert np.array_equal(ok.numpy(), want)
    assert int(total) == int(j_total) == 30


def test_sharded_rs256_verify_equals_jax(rsa_fixture):
    table, key_idx, s, expected, want = rsa_fixture
    gathered = [np.asarray(t)[key_idx].T for t in (table.n_tab,
                                                   table.np_tab,
                                                   table.r2_tab)]
    jm = jmesh.make_mesh(8)
    j_ok, j_total = jmesh.sharded_rs256_verify(jm)(
        *jmesh.shard_batch_arrays(jm, s, *gathered, expected))
    ok, total = tmesh.sharded_rs256_verify(make_mesh(4, device="cpu"))(
        s, *gathered, expected)
    assert np.array_equal(ok.numpy(), np.asarray(j_ok))
    assert np.array_equal(ok.numpy(), want)
    assert int(total) == int(j_total) == 30


def test_sharded_rns_verify_step_equals_jax():
    """``tests/test_parallel.py``'s RNS case: 2 RSA-512 moduli (seeded,
    regenerated until the RNS bases take them), 64 tokens whose
    expected values are s^65537 mod n, two of them corrupted."""
    rng = random.Random(0xD15C)

    def modulus(bits):
        p = rng.getrandbits(bits // 2) | (1 << (bits // 2 - 1)) | 1
        q = rng.getrandbits(bits // 2) | (1 << (bits // 2 - 1)) | 1
        return p * q

    k = 33
    mods = [modulus(512), modulus(512)]
    for _ in range(10):
        try:
            jctx = jrns.context(512, k)
            jtab = jrns.RNSKeyTable(jctx, mods)
            break
        except jrns.RNSUnsupportedKey:
            mods = [modulus(512), modulus(512)]
    n_tok = 64
    idx = np.asarray([i % 2 for i in range(n_tok)], np.int32)
    s = [rng.randrange(mods[i]) for i in idx]
    exp = [pow(x, 65537, mods[i]) for x, i in zip(s, idx)]
    exp[5] ^= 1
    exp[40] ^= 4
    s_l = np.asarray(JL.ints_to_limbs(s, k))
    e_l = np.asarray(JL.ints_to_limbs(exp, k))
    keys = [np.asarray(getattr(jtab, n))[idx].T
            for n in ("sig_c", "n_B", "a2_A", "a2_B")]
    jm = jmesh.make_mesh(8)
    j_ok, j_total = jmesh.sharded_rns_verify_step(jm, jctx)(
        *jmesh.shard_batch_arrays(jm, s_l, e_l, *keys))
    m = make_mesh(8, device="cpu")
    ok, total = tmesh.sharded_rns_verify_step(m, t_rns.context(512, k))(
        s_l, e_l, *keys)
    assert np.array_equal(ok.numpy(), np.asarray(j_ok))
    assert int(total) == int(j_total) == n_tok - 2
    assert not ok[5] and not ok[40]


def test_eight_devices_on_the_jax_side():
    assert len(jax.devices()) >= 8
