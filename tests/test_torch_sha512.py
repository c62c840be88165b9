"""The port's device SHA-384/512 (``gpu/sha512.py``, whole int64 words)
against hashlib and the JAX package's (hi, lo) u32-pair engine
(``cap_tpu.tpu.sha512``) on the same numpy-seeded messages: every
length 0–111 of the single-block ``*_fixed`` forms, every length
0–300 of the ``*_var`` forms, and each block edge. Tolerance: exact
(digests byte-equal)."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cap_tpu.tpu import sha512 as J

from cap_tpu_torch.gpu import sha512 as T

HASHES = ["sha384", "sha512"]
# the lengths where a padded message moves to another block: the
# 0x80 byte and the 16-byte length still fit (111), just not (112), the
# first block full (127, 128), and the same a block later (239, 240)
EDGES = [111, 112, 127, 128, 239, 240]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fns(mod, name):
    return getattr(mod, f"{name}_fixed"), getattr(mod, f"{name}_var")


def _var_batch(lens, width, seed):
    """[len(lens), width] uint8 messages of the given lengths, zero past
    each length (the ``*_var`` contract)."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((len(lens), width), np.uint8)
    for i, n in enumerate(lens):
        buf[i, :n] = rng.integers(0, 256, n)
    return buf


@pytest.mark.parametrize("name", HASHES)
def test_var_matches_hashlib_and_jax_at_every_length(name):
    lens = np.arange(301)
    buf = _var_batch(lens, 300, 5)
    t_var, j_var = _fns(T, name)[1], _fns(J, name)[1]
    got = t_var(torch.from_numpy(buf), torch.from_numpy(lens), 300).numpy()
    want = np.asarray(j_var(jnp.asarray(buf), jnp.asarray(lens), 300))
    assert np.array_equal(got, want)
    for i, n in enumerate(lens):
        assert got[i].tobytes() == hashlib.new(name, buf[i, :n].tobytes()) \
            .digest()


@pytest.mark.parametrize("name", HASHES)
def test_fixed_matches_hashlib_and_jax_at_every_length(name):
    """Every single-block length 0–111 against hashlib and against the
    JAX engine's one-block hash of the same messages (its ``*_var`` over
    a 111-byte buffer, one call); the JAX ``*_fixed`` itself at the
    lengths where the padding moves (each of its calls compiles)."""
    rng = np.random.default_rng(6)
    t_fixed = _fns(T, name)[0]
    j_fixed, j_var = _fns(J, name)
    msgs = [rng.integers(0, 256, (3, n), dtype=np.uint8) for n in range(112)]
    got = [t_fixed(torch.from_numpy(m)).numpy() for m in msgs]
    for n, (m, g) in enumerate(zip(msgs, got)):
        assert [r.tobytes() for r in g] == \
            [hashlib.new(name, row.tobytes()).digest() for row in m], n
    lens = np.repeat(np.arange(112), 3)
    buf = np.zeros((len(lens), 111), np.uint8)
    for i, n in enumerate(lens):
        buf[i, :n] = msgs[n][i % 3]
    want = np.asarray(j_var(jnp.asarray(buf), jnp.asarray(lens), 111))
    assert np.array_equal(np.concatenate(got), want)
    for n in (0, 1, 55, 56, 64, 111):
        assert np.array_equal(got[n], np.asarray(j_fixed(jnp.asarray(
            msgs[n])))), n


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("name", HASHES)
def test_block_edges(name, edge):
    """At each block edge, in a buffer wider than the message (bytes past
    it zero), all-0xFF and seeded messages; and the fixed form where
    one block holds it."""
    lens = np.full(4, edge)
    buf = _var_batch(lens, 300, edge)
    buf[0, :edge] = 0xFF
    t_fixed, t_var = _fns(T, name)
    j_fixed, j_var = _fns(J, name)
    got = t_var(torch.from_numpy(buf), torch.from_numpy(lens), 300).numpy()
    assert np.array_equal(got, np.asarray(
        j_var(jnp.asarray(buf), jnp.asarray(lens), 300)))
    want = [hashlib.new(name, row[:edge].tobytes()).digest() for row in buf]
    assert [g.tobytes() for g in got] == want
    if edge <= 111:
        fixed = t_fixed(torch.from_numpy(buf[:, :edge])).numpy()
        assert [g.tobytes() for g in fixed] == want


def test_words_wrap_and_shift_as_64_bit_patterns():
    """The int64 words behave as 64-bit patterns: an add past 2^63 wraps,
    a rotate or shift of a word with the sign bit set brings in zeros
    where a logical shift would."""
    m64 = (1 << 64) - 1
    vals = [0, 1, (1 << 63) - 1, 1 << 63, m64, 0x8123456789ABCDEF,
            0x7FEDCBA987654321]
    w = torch.tensor([T._signed(v) for v in vals], dtype=torch.int64)
    back = [v & m64 for v in w.tolist()]
    assert back == vals
    for r in (1, 7, 8, 19, 28, 41, 61):
        assert [v & m64 for v in T._ror(w, r).tolist()] == \
            [((v >> r) | (v << (64 - r))) & m64 for v in vals]
        assert [v & m64 for v in T._shr(w, r).tolist()] == \
            [v >> r for v in vals]
    assert [v & m64 for v in (w + w).tolist()] == \
        [(2 * v) & m64 for v in vals]
