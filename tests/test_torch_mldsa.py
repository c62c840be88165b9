"""The port's ML-DSA engine against the JAX package's: keygen, public
keys and signatures byte-equal for all three parameter sets, the host
codecs equal, the w1 network equal to ``_w1_core`` (jitted), the fused
verify's verdicts equal to the JAX fused verify's (and the oracle's) on the
mixed 120-token batch of ``tests/test_mldsa_fused.py`` per set, tables
carried across by ``convert.mldsa_key_table``, the AKP JWK parse and
serialize with the JAX parser's messages, and the exhausted-lane
fallback. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cap_tpu.errors import CapError as JCapError
from cap_tpu.jwt import jwk as j_jwk
from cap_tpu.tpu import mldsa as J

from cap_tpu_torch import convert
from cap_tpu_torch.errors import CapError as TCapError
from cap_tpu_torch.gpu import mldsa as T
from cap_tpu_torch.jwt import jwk as t_jwk

PSETS = ("ML-DSA-44", "ML-DSA-65", "ML-DSA-87")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=PSETS)
def keys(request):
    """Two key pairs of one set from the port's keygen, and the JAX
    package's public keys from the same seeds."""
    pset = request.param
    seeds = [bytes([81 + i]) * 32 for i in range(2)]
    port = [T.keygen(pset, s) for s in seeds]
    jax_pubs = [J.keygen(pset, s)[1] for s in seeds]
    return pset, [p for p, _ in port], [u for _, u in port], jax_pubs


def test_keygen_and_signatures_byte_equal_jax(keys):
    pset, privs, pubs, jax_pubs = keys
    for pub, jpub in zip(pubs, jax_pubs):
        assert pub.pk == jpub.pk
        assert pub.tr == jpub.tr
        assert np.array_equal(pub.a_hat, jpub.a_hat)
        assert np.array_equal(pub.t1_hat_2d, jpub.t1_hat_2d)
    j_priv = J.keygen(pset, bytes([81]) * 32)[0]
    for msg in (b"", b"m" * 300):
        sig = privs[0].sign(msg)
        assert sig == j_priv.sign(msg)
        assert len(sig) == T.PARAMS[pset].sig_size
        assert T.py_verify(pubs[0], sig, msg)
        assert J.py_verify(jax_pubs[0], sig, msg)


def test_host_codecs_equal_jax(keys):
    pset, privs, pubs, _ = keys
    p, jp = T.PARAMS[pset], J.PARAMS[pset]
    for name in ("k", "l", "tau", "lam", "gamma1", "gamma2", "omega",
                 "beta", "z_bits", "w1_bits", "pk_size", "sig_size"):
        assert getattr(p, name) == getattr(jp, name), name
    sig = privs[1].sign(b"codec")
    ct, z, h = T.sig_decode(sig, p)
    jct, jz, jh = J.sig_decode(sig, jp)
    assert ct == jct and np.array_equal(z, jz) and np.array_equal(h, jh)
    assert T.sig_encode(ct, z, h, p) == sig
    assert np.array_equal(T.sample_in_ball(ct, p),
                          J.sample_in_ball(ct, jp))
    buf = np.random.default_rng(3).integers(0, 256, (3, 32 * p.z_bits),
                                            dtype=np.uint8)
    assert np.array_equal(T.bitunpack(buf, p.z_bits, 256),
                          J.bitunpack(buf, p.z_bits, 256))


def test_w1_network_equals_jax(keys):
    pset, _, pubs, jax_pubs = keys
    p = T.PARAMS[pset]
    rng = np.random.default_rng(len(pset))
    b = 6
    z = rng.integers(0, T.Q, (b, p.l, 256), dtype=np.int64)
    z[0] = 0
    z[1] = T.Q - 1
    c = np.stack([T.sample_in_ball(rng.bytes(p.lam // 4), p) % T.Q
                  for _ in range(b)])
    h = rng.integers(0, 2, (b, p.k, 256), dtype=np.int64)
    key_idx = np.array([0, 1, 1, 0, 1, 0])
    table = T.MLDSAKeyTable(pset, pubs, device="cpu")
    jtable = J.MLDSAKeyTable(pset, jax_pubs)
    got = T._w1_core(table.a_mont, table.t1_mont,
                     torch.from_numpy(z.astype(np.int32)),
                     torch.from_numpy(c.astype(np.int32)),
                     torch.from_numpy(h.astype(np.uint8)),
                     torch.from_numpy(key_idx), p.gamma2)
    want = J._core_jit()(jtable.a_mont, jtable.t1_mont,
                         jnp.asarray(z.astype(np.uint32)),
                         jnp.asarray(c.astype(np.uint32)),
                         jnp.asarray(h.astype(np.uint8)),
                         jnp.asarray(key_idx.astype(np.int32)), p.gamma2)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _mixed_batch(privs, p, n=120):
    """tests/test_mldsa_fused.py's batch: valid signatures and, by
    i % 6, a bit flipped anywhere, one byte short, the message changed,
    a bit flipped inside c̃."""
    base = [(privs[i % 2].sign(f"fu-{i}".encode()), f"fu-{i}".encode(),
             i % 2) for i in range(8)]
    sigs, msgs, rows = [], [], []
    for i in range(n):
        sig, msg, row = base[i % len(base)]
        mode = i % 6
        if mode == 1:
            b = bytearray(sig)
            b[i % len(sig)] ^= 1 << (i % 8)
            sig = bytes(b)
        elif mode == 2:
            sig = sig[:-1]
        elif mode == 3:
            msg = msg + b"?"
        elif mode == 4:
            b = bytearray(sig)
            b[i % (p.lam // 4)] ^= 0x01
            sig = bytes(b)
        sigs.append(sig)
        msgs.append(msg)
        rows.append(row)
    return sigs, msgs, np.asarray(rows)


def test_fused_verdicts_equal_jax_and_oracle(keys):
    pset, privs, pubs, jax_pubs = keys
    p = T.PARAMS[pset]
    sigs, msgs, rows = _mixed_batch(privs, p)
    n = len(sigs)
    table = T.MLDSAKeyTable(pset, pubs, device="cpu")
    fin = T.verify_mldsa_fused_pending(table, sigs, msgs, rows, pad=128)
    got = fin()
    want = J.verify_mldsa_fused_pending(
        J.MLDSAKeyTable(pset, jax_pubs), sigs, msgs,
        rows.astype(np.int32), pad=128)()
    assert got.shape == (128,) and not got[n:].any()
    assert np.array_equal(got, np.asarray(want))
    oracle = np.array([T.py_verify(pubs[rows[i]], sigs[i], msgs[i])
                       for i in range(n)])
    assert np.array_equal(got[:n], oracle)
    assert 0 < int(oracle.sum()) < n
    assert fin.reverified == 0


def test_converted_table_equals_a_table_built_from_the_keys(keys):
    pset, _, pubs, jax_pubs = keys
    jtable = J.MLDSAKeyTable(pset, jax_pubs)
    own = T.MLDSAKeyTable(pset, pubs, device="cpu")
    conv = convert.mldsa_key_table(pset, pubs, np.asarray(jtable.a_mont),
                                   np.asarray(jtable.t1_mont),
                                   device="cpu")
    assert torch.equal(conv.a_mont, own.a_mont)
    assert torch.equal(conv.t1_mont, own.t1_mont)
    with pytest.raises(ValueError):
        convert.mldsa_key_table(pset, pubs[:1], np.asarray(jtable.a_mont),
                                np.asarray(jtable.t1_mont), device="cpu")


def test_all_invalid_chunk_touches_no_device_and_rejects(keys):
    pset, _, pubs, _ = keys
    table = T.MLDSAKeyTable(pset, pubs[:1], device="cpu")
    fin = T.verify_mldsa_fused_pending(
        table, [b"\x00" * 7, b"\x01" * 9], [b"a", b"b"],
        np.zeros(2, np.int64), pad=4)
    assert fin.outs == []
    got = fin()
    assert got.shape == (4,) and not got.any()


def test_exhausted_lane_reverifies_on_the_oracle(keys, monkeypatch):
    """The device flags a lane whose SampleInBall walk ran out of
    squeezed bytes: it re-verifies on py_verify. Real hashes exhaust
    the budget with probability ~2^-1000, so the fused pass is stubbed
    to raise the flag; the host-side fallback is what is pinned."""
    pset, privs, pubs, _ = keys
    msg = b"exhaust-me"
    sig = privs[0].sign(msg)

    def fake_core(*args):
        return (torch.tensor([False, False]), torch.tensor([True, False]))

    monkeypatch.setattr(T, "_fused_core", fake_core)
    table = T.MLDSAKeyTable(pset, pubs, device="cpu")
    fin = T.verify_mldsa_fused_pending(table, [sig, sig[:-1]], [msg, msg],
                                       np.zeros(2, np.int64), pad=2)
    got = fin()
    assert bool(got[0]) is True           # the oracle accepts
    assert bool(got[1]) is False          # invalid stays rejected
    assert fin.reverified == 1


def test_akp_jwk_round_trip_equals_jax(keys):
    pset, _, pubs, jax_pubs = keys
    doc = t_jwk.serialize_public_key(pubs[0], kid="pq")
    assert doc == j_jwk.serialize_public_key(jax_pubs[0], kid="pq")
    for parsed in (t_jwk.parse_jwk(doc), t_jwk.parse_jwk(dict(
            doc, alg=pset))):
        assert isinstance(parsed.key, T.MLDSAPublicKey)
        assert parsed.key.pk == pubs[0].pk and parsed.kid == "pq"
        assert parsed.key.parameter_set == pset


_PK44 = "A" * 1752           # 1,314 bytes: not 1,312


@pytest.mark.parametrize("data", [
    {"kty": "AKP", "pub": "AAAA"},
    {"kty": "AKP", "alg": "RS256", "pub": "AAAA"},
    {"kty": "AKP", "alg": "ML-DSA-44"},
    {"kty": "AKP", "alg": "ML-DSA-44", "pub": 5},
    {"kty": "AKP", "alg": "ML-DSA-44", "pub": "AAAA"},
    {"kty": "AKP", "alg": "ML-DSA-65", "pub": _PK44},
    {"kty": "AKP", "alg": "ML-DSA-44", "pub": "!!!"},
], ids=["no-alg", "rsa-alg", "no-pub", "pub-not-str", "short", "long",
        "b64"])
def test_akp_jwk_errors_match_jax(data):
    with pytest.raises(JCapError) as ref:
        j_jwk.parse_jwk(dict(data))
    with pytest.raises(TCapError) as port:
        t_jwk.parse_jwk(dict(data))
    assert type(port.value).__name__ == type(ref.value).__name__
    assert str(port.value) == str(ref.value)


def test_akp_slh_dsa_keys_are_not_ported():
    """SLH-DSA AKP JWKs parse into the key of their set, as in the JAX
    parser, and a bad set name keeps its ``InvalidJWKSError``. (The
    name dates from when the port refused these keys; it is kept so the
    test's history stays one.)"""
    from cap_tpu.tpu import slhdsa as j_slh

    from cap_tpu_torch.gpu import slhdsa as t_slh

    for pset in ("SLH-DSA-SHAKE-128s", "SLH-DSA-SHAKE-128f"):
        data = {"kty": "AKP", "alg": pset, "pub": "A" * 43}
        key = t_jwk.parse_jwk(dict(data)).key
        ref = j_jwk.parse_jwk(dict(data)).key
        assert isinstance(key, t_slh.SLHDSAPublicKey)
        assert isinstance(ref, j_slh.SLHDSAPublicKey)
        assert (key.parameter_set, key.pk) == (pset, bytes(32)) == \
            (ref.parameter_set, ref.pk)
    data = {"kty": "AKP", "alg": "SLH-DSA-SHAKE-256s", "pub": "A" * 43}
    with pytest.raises(JCapError) as ref_err:
        j_jwk.parse_jwk(dict(data))
    with pytest.raises(TCapError) as err:
        t_jwk.parse_jwk(dict(data))
    assert type(err.value).__name__ == type(ref_err.value).__name__ == \
        "InvalidJWKSError"
    assert str(err.value) == str(ref_err.value)
