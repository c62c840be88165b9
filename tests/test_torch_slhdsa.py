"""The port's SLH-DSA engine (``gpu/slhdsa.py``) against the JAX
package's (``cap_tpu.tpu.slhdsa``), live, on the CPU: parameter sets
and codecs equal, keygen and signatures byte-equal (128f), the host
oracle against the pinned KAT file for both sets, the device helpers
(``_hash_lanes``, ``_with_hash_addr``, ``_digits_from_node``) word-equal
to the JAX functions on numpy-seeded lanes, the host decode
(``_SLHPrep``) array-equal, ``verify_slhdsa_batch`` verdict-equal to the
JAX engine's and to ``py_verify`` over the 64-case mutation sweep
(128f) and the KAT signatures (128s), with the keccak launches a chunk
counted, the key table carried across by ``convert.slhdsa_key_table``,
and the AKP JWK parse, serialize and oracle with the JAX package's
messages. Tolerance: exact. Every JAX engine call runs at pad 16, the
shape the JAX package's own tests compile."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cap_tpu.errors import CapError as JCapError
from cap_tpu.jwt import jwk as j_jwk
from cap_tpu.jwt import verify as j_verify
from cap_tpu.jwt.jose import parse_jws as j_parse_jws
from cap_tpu.tpu import slhdsa as J

from cap_tpu_torch import convert
from cap_tpu_torch import testing as tt
from cap_tpu_torch.errors import CapError as TCapError
from cap_tpu_torch.gpu import keccak as kk
from cap_tpu_torch.gpu import slhdsa as T
from cap_tpu_torch.jwt import jwk as t_jwk
from cap_tpu_torch.jwt import verify as t_verify
from cap_tpu_torch.jwt.jose import b64url_decode
from cap_tpu_torch.jwt.jose import parse_jws as t_parse_jws

FAST = "SLH-DSA-SHAKE-128f"
SMALL = "SLH-DSA-SHAKE-128s"
KAT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "slhdsa_kat.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kat():
    with open(KAT_PATH) as f:
        return json.load(f)


def _kat_set(kat, pset):
    """(port key, JAX key, signatures, messages, expected verdicts)."""
    jwk = [k for k in kat["keys"]["keys"] if k["alg"] == pset][0]
    pk = b64url_decode(jwk["pub"])
    vecs = [v for v in kat["vectors"] if v["alg"] == pset]
    return (T.SLHDSAPublicKey(pset, pk), J.SLHDSAPublicKey(pset, pk),
            [b64url_decode(v["signature_b64"]) for v in vecs],
            [b64url_decode(v["message_b64"]) for v in vecs],
            [v["testPassed"] for v in vecs])


@pytest.fixture(scope="module")
def fast_keys():
    """Two 128f key pairs from the port's keygen (the JAX package's test
    seeds)."""
    return [T.keygen(FAST, bytes([90 + i]) * 32) for i in range(2)]


class _Permutes:
    """Counts the Keccak permutations the engine asks for (on the CPU
    the wrapper runs the plain version and counts no launch)."""

    def __init__(self, monkeypatch):
        self.n = 0
        permute = kk.permute

        def counted(x):
            self.n += 1
            return permute(x)

        monkeypatch.setattr(kk, "permute", counted)


def test_parameter_sets_equal_jax():
    assert list(T.PARAMS) == list(J.PARAMS)
    for name, p in T.PARAMS.items():
        assert {s: getattr(p, s) for s in T.ParameterSet.__slots__} == \
            {s: getattr(J.PARAMS[name], s) for s in J.ParameterSet.__slots__}
    assert T.SLHDSA_ALGS == J.SLHDSA_ALGS
    assert (T.PARAMS[SMALL].sig_size, T.PARAMS[FAST].sig_size) == \
        (7856, 17088)


def test_codecs_equal_jax():
    rng = np.random.default_rng(205)
    for _ in range(20):
        data = rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
        for b, n in ((4, 32), (6, 33), (12, 14), (9, 9)):
            assert T.base_2b(data, b, n) == J.base_2b(data, b, n)
        for pset in T.PARAMS:
            p, jp = T.PARAMS[pset], J.PARAMS[pset]
            assert T._wots_digits(data[:16], p) == \
                J._wots_digits(data[:16], jp)
            assert T._digest_split(data[:p.m], p) == \
                J._digest_split(data[:p.m], jp)
        a, ja = T.ADRS(), J.ADRS()
        layer = int(rng.integers(0, 22))
        for obj in (a, ja):
            obj.set_layer(layer)
            obj.set_tree(int(data[0]) << 40 | 5)
            obj.set_type_and_clear(T._TREE)
            obj.set_tree_height(3)
            obj.set_tree_index(int(data[1]))
        assert a.bytes() == ja.bytes()
    assert T._m_prime(b"m", b"ctx") == J._m_prime(b"m", b"ctx")


def test_keygen_and_signature_byte_equal_jax(fast_keys):
    for i, (priv, pub) in enumerate(fast_keys):
        j_priv, j_pub = J.keygen(FAST, bytes([90 + i]) * 32)
        assert pub.pk == j_pub.pk
        assert (priv.sk_seed, priv.sk_prf) == (j_priv.sk_seed,
                                               j_priv.sk_prf)
    sig = fast_keys[0][0].sign(b"roundtrip")
    assert sig == J.keygen(FAST, bytes([90]) * 32)[0].sign(b"roundtrip")
    assert T.py_verify(fast_keys[0][1], sig, b"roundtrip")
    assert not T.py_verify(fast_keys[1][1], sig, b"roundtrip")


@pytest.mark.parametrize("pset", [FAST, SMALL])
def test_py_verify_matches_the_kat_file(kat, pset):
    key, j_key, sigs, msgs, want = _kat_set(kat, pset)
    got = [T.py_verify(key, s, m) for s, m in zip(sigs, msgs)]
    assert got == want
    assert got == [J.py_verify(j_key, s, m) for s, m in zip(sigs, msgs)]
    assert 0 < sum(got) < len(got)


def _lanes(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(x):
    return np.asarray(x).view(np.uint32)


# message lanes: F (2), H (4), T_k at 128s (28) and T_len (70): one,
# one, three and five absorbed blocks
@pytest.mark.parametrize("msg_lanes", [2, 4, 28, 70])
def test_hash_lanes_equal_jax(msg_lanes):
    rng = np.random.default_rng(msg_lanes)
    psd = _lanes(rng, (6, 1, 2, 2))
    adrs = _lanes(rng, (6, 3, 4, 2))
    msg = _lanes(rng, (6, 3, msg_lanes, 2))
    got = T._hash_lanes(_t(psd), _t(adrs), _t(msg))
    want = J._hash_lanes(jnp.asarray(psd), jnp.asarray(adrs),
                         jnp.asarray(msg))
    assert got.shape == (6, 3, 2, 2)
    assert np.array_equal(_u32(got.numpy()), np.asarray(want))
    assert np.array_equal(T._tail_pad(8 * (6 + msg_lanes)),
                          J._tail_pad(8 * (6 + msg_lanes)))


def test_with_hash_addr_and_digits_equal_jax():
    rng = np.random.default_rng(7)
    adrs = _lanes(rng, (5, 35, 4, 2))
    adrs[0] = 0xFFFFFFFF                       # bits 28/29 already set
    v = rng.integers(0, 30, (5, 35)).astype(np.int32)
    got = T._with_hash_addr(_t(adrs), torch.from_numpy(v))
    want = J._with_hash_addr(jnp.asarray(adrs), jnp.asarray(v))
    assert np.array_equal(_u32(got.numpy()), np.asarray(want))
    node = _lanes(rng, (64, 2, 2))
    node[0], node[1] = 0, 0xFFFFFFFF
    got = T._digits_from_node(_t(node)).numpy()
    want = np.asarray(J._digits_from_node(jnp.asarray(node)))
    assert got.shape == (64, 35) and np.array_equal(got, want)


def _j_table(pset, keys):
    return J.SLHDSAKeyTable(pset, [J.SLHDSAPublicKey(pset, k.pk)
                                   for k in keys])


@pytest.mark.parametrize("pset", [FAST, SMALL])
def test_host_decode_equals_jax(kat, pset):
    """``_SLHPrep`` on the KAT signatures (wrong lengths among them), 16
    rows: every array equal to the JAX package's."""
    key, _, sigs, msgs, _ = _kat_set(kat, pset)
    table = T.SLHDSAKeyTable(pset, [key], device="cpu")
    rows = np.zeros(len(sigs), np.int32)
    got = T._SLHPrep(table, sigs, msgs, rows, 16).arrays()
    want = J._SLHPrep(_j_table(pset, [key]), sigs, msgs, rows, 16).arrays()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _mutate(sig: bytes, msg: bytes, i: int, p):
    """The JAX package's sweep (tests/test_slhdsa.py): three intact
    cases, an R bit, a FORS byte, a wrong length, a hypertree byte and
    a changed message, in turn."""
    mode = i % 8
    if mode in (0, 1, 2):
        return sig, msg
    if mode == 3:
        b = bytearray(sig)
        b[i % p.n] ^= 1 << (i % 8)
        return bytes(b), msg
    if mode == 4:
        b = bytearray(sig)
        b[p.n + (i * 131) % (p.k * (1 + p.a) * p.n)] ^= 0x20
        return bytes(b), msg
    if mode == 5:
        return (sig[:-1] if i % 2 else sig + b"\x00"), msg
    if mode == 6:
        b = bytearray(sig)
        b[-(1 + (i * 53) % 512)] ^= 0xFF
        return bytes(b), msg
    return sig, msg + b"!"


def test_engine_matches_jax_and_oracle_fast(fast_keys, monkeypatch):
    """The JAX package's 64-case sweep over two keys: its 23 distinct
    (signature, message, key) inputs through the port's engine in one
    32-row call and the JAX engine in two 16-row calls, each case's
    verdict equal between the two and to ``py_verify`` on all 64; the
    port asks for ``chunk_launches`` permutations."""
    privs = [k[0] for k in fast_keys]
    pubs = [k[1] for k in fast_keys]
    p = pubs[0].params
    base = []
    for i in range(4):
        msg = f"par-{i}".encode()
        base.append((privs[i % 2].sign(msg), msg, i % 2))
    cases = []
    for i in range(64):
        sig, msg, row = base[i % 4]
        cases.append(_mutate(sig, msg, i, p) + (row,))
    uniq = list(dict.fromkeys(cases))
    assert len(uniq) == 23
    sigs, msgs, rows = zip(*uniq)
    rows = np.asarray(rows, np.int32)
    table = T.SLHDSAKeyTable(FAST, pubs, device="cpu")
    count = _Permutes(monkeypatch)
    got = T.verify_slhdsa_batch(table, sigs, msgs, rows)
    assert count.n == T.chunk_launches(p) == 518
    j_table = _j_table(FAST, pubs)
    want_jax = np.concatenate([
        J.verify_slhdsa_batch(j_table, sigs[lo: lo + 16], msgs[lo: lo + 16],
                              rows[lo: lo + 16]) for lo in (0, 16)])
    verdict = {c: (bool(g), bool(w))
               for c, g, w in zip(uniq, got, want_jax[:len(uniq)])}
    oracle = [T.py_verify(pubs[r], s, m) for s, m, r in cases]
    assert [verdict[c] for c in cases] == [(o, o) for o in oracle]
    assert 0 < sum(oracle) < 64


def test_engine_matches_kat_small_set(kat, monkeypatch):
    """128s without host signing: the KAT signatures through both
    engines; 219 permutations a chunk."""
    key, j_key, sigs, msgs, want = _kat_set(kat, SMALL)
    rows = np.zeros(len(sigs), np.int32)
    table = T.SLHDSAKeyTable(SMALL, [key], device="cpu")
    count = _Permutes(monkeypatch)
    got = T.verify_slhdsa_batch(table, sigs, msgs, rows)
    assert count.n == T.chunk_launches(table.params) == 219
    j_got = J.verify_slhdsa_batch(_j_table(SMALL, [key]), sigs, msgs, rows)
    assert got.tolist() == j_got[:len(sigs)].tolist() == want


def test_nothing_is_queued_without_a_valid_row(kat, monkeypatch):
    key, _, sigs, msgs, _ = _kat_set(kat, FAST)
    table = T.SLHDSAKeyTable(FAST, [key], device="cpu")
    count = _Permutes(monkeypatch)
    short = [s[:-1] for s in sigs[:3]]
    out = T.verify_slhdsa_pending(table, short, msgs[:3],
                                  np.zeros(3, np.int32))
    assert count.n == 0 and out.shape == (16,) and not out.any()


def test_key_table_carried_across(fast_keys):
    pubs = [k[1] for k in fast_keys]
    j_table = _j_table(FAST, pubs)
    carried = convert.slhdsa_key_table(FAST, pubs,
                                       np.asarray(j_table.pk_seed_l),
                                       np.asarray(j_table.pk_root_l),
                                       device="cpu")
    own = T.SLHDSAKeyTable(FAST, pubs, device="cpu")
    for name in ("pk_seed_l", "pk_root_l"):
        got = getattr(carried, name)
        assert got.dtype == torch.int32 and got.shape == (2, 2, 2)
        assert torch.equal(got, getattr(own, name))
        assert np.array_equal(_u32(got.numpy()),
                              np.asarray(getattr(j_table, name)))
    with pytest.raises(ValueError, match="pk_root_l: shape"):
        convert.slhdsa_key_table(FAST, pubs, np.asarray(j_table.pk_seed_l),
                                 np.zeros((3, 2, 2), np.uint32), device="cpu")


def test_akp_jwk_parse_serialize_and_oracle_equal_jax(fast_keys):
    priv, pub = fast_keys[0]
    doc = t_jwk.serialize_public_key(pub, kid="slh")
    assert doc == j_jwk.serialize_public_key(
        J.SLHDSAPublicKey(FAST, pub.pk), kid="slh")
    key = t_jwk.parse_jwk(doc).key
    assert isinstance(key, T.SLHDSAPublicKey) and key.pk == pub.pk
    for data in ({"kty": "AKP", "alg": "SLH-DSA-SHAKE-999", "pub": "AQAB"},
                 {"kty": "AKP", "alg": FAST},
                 {"kty": "AKP", "alg": FAST, "pub": "AQAB"},
                 {"kty": "AKP", "alg": SMALL, "pub": 7}):
        with pytest.raises(JCapError) as ref:
            j_jwk.parse_jwk(dict(data))
        with pytest.raises(TCapError) as got:
            t_jwk.parse_jwk(dict(data))
        assert (type(got.value).__name__, str(got.value)) == \
            (type(ref.value).__name__, str(ref.value))
    assert t_verify.key_matches_alg(key, FAST)
    assert not t_verify.key_matches_alg(key, SMALL)
    assert not t_verify.key_matches_alg(key, "ML-DSA-44")
    tok = tt.sign_jwt(priv, FAST, {"sub": "x"}, kid="slh")
    t_verify.verify_parsed(t_parse_jws(tok), key)
    bad = tok[:-6] + ("AAAAAA" if not tok.endswith("AAAAAA") else "BBBBBB")
    j_key = J.SLHDSAPublicKey(FAST, pub.pk)
    for parsed, verify, k, cls in (
            (t_parse_jws(bad), t_verify.verify_parsed, key, TCapError),
            (j_parse_jws(bad), j_verify.verify_parsed, j_key, JCapError)):
        with pytest.raises(cls) as err:
            verify(parsed, k)
        assert (type(err.value).__name__, str(err.value)) == \
            ("InvalidSignatureError", "signature verification failed")
