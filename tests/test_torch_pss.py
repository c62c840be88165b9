"""The port's PS* engine against the JAX package's and the host:
SHA-256 (``sha256_fixed``/``sha256_var``) against hashlib and the JAX
engines at lengths 0–300, the RNS modexp to limbs against ``pow``, the
device EMSA-PSS check over SHA-256, SHA-384 and SHA-512 against the
JAX one and the host ``pss_check_em`` on crafted EMs, and the packed
PS256, PS384 and PS512 verdicts."""

import hashlib
import random

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

import jax.numpy as jnp  # noqa: E402

from cap_tpu import testing as jt  # noqa: E402
from cap_tpu.jwt import algs  # noqa: E402
from cap_tpu.tpu import rsa as j_rsa  # noqa: E402
from cap_tpu.tpu import sha256 as j_sha  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.gpu import limbs as t_limbs  # noqa: E402
from cap_tpu_torch.gpu import rns as t_rns  # noqa: E402
from cap_tpu_torch.gpu import rsa as t_rsa  # noqa: E402
from cap_tpu_torch.gpu import sha256 as t_sha  # noqa: E402
from cap_tpu_torch.jwt.jose import b64url_decode  # noqa: E402
from cap_tpu_torch.jwt.verify import pss_check_em  # noqa: E402


def _byte_matrix(rows, width):
    """Left-aligned [len(rows), width] u8 matrix, zero-padded."""
    out = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        b = r[:width]
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sig(token: str) -> bytes:
    return b64url_decode(token.split(".")[2])


def test_sha256_var_matches_hashlib_and_jax_at_every_length():
    rng = np.random.default_rng(1)
    lens = np.arange(301)
    buf = np.zeros((len(lens), 300), np.uint8)
    for i, n in enumerate(lens):
        buf[i, :n] = rng.integers(0, 256, n)
    got = t_sha.sha256_var(torch.from_numpy(buf), torch.from_numpy(lens),
                           300).numpy()
    want = np.asarray(j_sha.sha256_var(jnp.asarray(buf), jnp.asarray(lens),
                                       300))
    assert np.array_equal(got, want)
    for i, n in enumerate(lens):
        assert got[i].tobytes() == hashlib.sha256(buf[i, :n].tobytes()) \
            .digest()


@pytest.mark.parametrize("length", [0, 1, 36, 55])
def test_sha256_fixed_matches_hashlib_and_jax(length):
    msgs = np.random.default_rng(length).integers(0, 256, (9, length),
                                                  dtype=np.uint8)
    got = t_sha.sha256_fixed(torch.from_numpy(msgs)).numpy()
    assert np.array_equal(got, np.asarray(j_sha.sha256_fixed(
        jnp.asarray(msgs))))
    for i in range(9):
        assert got[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


@pytest.fixture(scope="module")
def key():
    priv = jt.generate_keys(algs.PS256)[0]
    nums = priv.private_numbers()
    return tt.RSAPrivateKey(nums.p, nums.q)


def test_rns_modexp_em_core_matches_pow(key):
    table = t_rsa.RSAKeyTable([(key.n, 65537)], device="cpu")
    rng = random.Random(2)
    s_ints = [0, 1, 2, key.n - 1] + [rng.randrange(key.n) for _ in range(12)]
    s = torch.from_numpy(np.stack([t_limbs.int_to_limbs(v, table.k)
                                   for v in s_ints], axis=1)
                         .astype(np.int64))
    idx = torch.zeros(len(s_ints), dtype=torch.int64)
    sig_c, n_B, a2_A, a2_B = table.rtab.device_tables("cpu")
    em = t_rns._rns_modexp_em_core(
        table.ctx, table.k + 1, s, sig_c[idx].T, n_B[idx].T, a2_A[idx].T,
        a2_B[idx].T, table.n_tab[idx].T)
    assert em.shape == (table.k, len(s_ints))
    assert [t_limbs.limbs_to_int(em[:, j].tolist())
            for j in range(len(s_ints))] == \
        [pow(v, 65537, key.n) for v in s_ints]


def _crafted_ems(key, hash_name="sha256"):
    """(label, EM bytes as a 2k-wide big-endian integer, mHash, mod bits,
    host verdict) for every structural case of EMSA-PSS-VERIFY. The
    label "salt-32" names the salt of the hash's length."""
    rng = random.Random(3)
    bits = key.n.bit_length()
    h_len = t_rsa.HASH_LEN[hash_name]
    mh = hashlib.new(hash_name, b"message").digest()
    out = []

    def add(label, em, mod_bits=bits, m_hash=mh):
        out.append((label, em, m_hash, mod_bits))

    em = tt.pss_em(mh, bits - 1, hash_name, rng.randbytes(h_len))
    add("salt-32", em)
    add("salt-0", tt.pss_em(mh, bits - 1, hash_name, b""))
    add("salt-max", tt.pss_em(mh, bits - 1, hash_name,
                              rng.randbytes((bits + 6) // 8 - h_len - 2)))
    add("wrong-hash", em, m_hash=hashlib.new(hash_name, b"other").digest())
    add("bad-trailer", em[:-1] + b"\xcc")
    sep = bytearray(em)
    sep[256 - h_len - 1 - h_len - 1] ^= 0x01
    add("no-separator", bytes(sep))
    ps = bytearray(em)
    ps[5] ^= 0x40
    add("nonzero-padding", bytes(ps))
    top = bytearray(em)
    top[0] |= 0x80
    add("top-bit", bytes(top))
    em_short = tt.pss_em(mh, bits - 4, hash_name, rng.randbytes(20))
    add("em-bits-2044", b"\0" + em_short, mod_bits=bits - 3)
    add("em-bits-2044-top", b"\0" + bytes([em_short[0] | 0x10])
        + em_short[1:], mod_bits=bits - 3)
    add("tiny-modulus", em, mod_bits=8 * 33)
    width = 2 * 129
    rows = []
    for label, em_, m_hash, mod_bits in out:
        wide = bytes(width - len(em_)) + em_
        host = pss_check_em(wide, m_hash, mod_bits - 1, hash_name)
        rows.append((label, wide, m_hash, mod_bits, host))
    lead = bytearray(rows[0][1])
    lead[0] = 1
    rows.append(("leading-byte", bytes(lead), mh, bits,
                 pss_check_em(bytes(lead), mh, bits - 1, hash_name)))
    return rows


def test_pss_verify_device_matches_jax_and_host(key):
    _pss_device_case(key, "sha256")


@pytest.mark.parametrize("hash_name", ["sha384", "sha512"])
def test_pss_verify_device_sha384_sha512_matches_jax_and_host(key,
                                                              hash_name):
    """The same crafted EMs under SHA-384 and SHA-512: MGF1 and H' on
    ``gpu.sha512``, verdicts equal to the JAX engine's and the host's."""
    _pss_device_case(key, hash_name)


def _pss_device_case(key, hash_name):
    rows = _crafted_ems(key, hash_name)
    em = np.stack([np.frombuffer(r[1], np.uint8) for r in rows])
    mh = np.stack([np.frombuffer(r[2], np.uint8) for r in rows])
    mod_bits = np.asarray([r[3] for r in rows], np.int64)
    host = [r[4] for r in rows]
    got = t_rsa._pss_verify_device(torch.from_numpy(em),
                                   torch.from_numpy(mh),
                                   torch.from_numpy(mod_bits), em.shape[1],
                                   hash_name).tolist()
    want = np.asarray(j_rsa._pss_verify_device(
        jnp.asarray(em), jnp.asarray(mh), jnp.asarray(mod_bits),
        width=em.shape[1], hash_name=hash_name)).tolist()
    assert got == want == host
    assert dict(zip([r[0] for r in rows], got)) == {
        "salt-32": True, "salt-0": True, "salt-max": True,
        "wrong-hash": False, "bad-trailer": False, "no-separator": False,
        "nonzero-padding": False, "top-bit": False, "em-bits-2044": True,
        "em-bits-2044-top": False, "tiny-modulus": False,
        "leading-byte": False}


def test_ps256_packed_verdicts_equal_jax(key, monkeypatch):
    """One 128-token PS256 chunk: honest (salts 32, 0, max), tampered,
    crafted-EM and wrong-length signatures, through both packed
    engines on the same records."""
    _packed_case(key, algs.PS256, monkeypatch)


@pytest.mark.parametrize("alg", ["PS384", "PS512"])
def test_ps384_ps512_packed_verdicts_equal_jax(key, monkeypatch, alg):
    """The same chunk under PS384 and PS512 (salts of the hash's length,
    0 and max)."""
    _packed_case(key, alg, monkeypatch)


def _packed_case(key, alg, monkeypatch):
    rng = random.Random(4)
    hash_name = algs.HASH_FOR_ALG[alg]
    h_len = t_rsa.HASH_LEN[hash_name]
    si = tt.signing_input(alg, {"sub": "x"}, "k")
    digest = hashlib.new(hash_name, si).digest()
    sigs = []
    for salt in (None, 0, "max"):
        tok = tt.sign_jwt(key, alg, {"sub": "x"}, kid="k", rng=rng,
                          salt_len=salt)
        sigs.append(_sig(tok))
    bad = bytearray(sigs[0])
    bad[100] ^= 2
    sigs.append(bytes(bad))
    em = tt.pss_em(digest, key.n.bit_length() - 1, hash_name,
                   rng.randbytes(h_len))
    sigs.append(_sig(tt.sign_em(key, si, em[:-1] + b"\x00")))
    sigs.append(sigs[0][:-1])
    expect = [True, True, True, False, False, False]
    n = 128
    sigs += [b""] * (n - len(sigs))
    lens = np.asarray([len(s) for s in sigs])
    hash_mat = np.zeros((n, 64), np.uint8)
    hash_mat[:, :h_len] = np.frombuffer(digest, np.uint8)
    key_idx = np.zeros(n, np.int64)

    table = t_rsa.RSAKeyTable([(key.n, 65537)], device="cpu")
    rec = t_rsa.rs_packed_records(table, _byte_matrix(sigs, 2 * table.k),
                                  lens, hash_mat, hash_name, key_idx, "ps")
    got = t_rsa.verify_ps_packed_pending(table, rec, hash_name).tolist()

    monkeypatch.setenv("CAP_TPU_RNS", "1")
    j_table = j_rsa.RSAKeyTable([(key.n, 65537)])
    j_rec = j_rsa.rs_packed_records(j_table, _byte_matrix(sigs, 2 * table.k),
                                    lens, hash_mat, hash_name,
                                    key_idx.astype(np.int32))
    j_rec[:, 2 * table.k + h_len] = (lens == 256).astype(np.uint8)
    assert np.array_equal(rec, j_rec)
    want = np.asarray(j_rsa.verify_ps_packed_pending(j_table, j_rec,
                                                     hash_name)).tolist()
    assert got == want
    assert got[:6] == expect and not any(got[6:])
