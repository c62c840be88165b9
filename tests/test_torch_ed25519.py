"""The port's Ed25519 engine against the JAX package's and OpenSSL:
window tables byte-equal, ``RNSToLimbs`` equal, the verify core's
verdicts equal (own and converted tables), RFC 8032 signing byte-equal
to OpenSSL's, the pure-integer oracle against OpenSSL on an
adversarial list, and the OKP JWK parse errors."""

import hashlib

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

import jax.numpy as jnp  # noqa: E402
from cryptography.exceptions import InvalidSignature  # noqa: E402
from cryptography.hazmat.primitives.asymmetric.ed25519 import (  # noqa: E402
    Ed25519PrivateKey,
    Ed25519PublicKey,
)
from cryptography.hazmat.primitives.serialization import (  # noqa: E402
    Encoding,
    PublicFormat,
)

from cap_tpu.errors import CapError as JCapError  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.tpu import ed25519 as j_ed  # noqa: E402
from cap_tpu.tpu import ed25519_rns as j_er  # noqa: E402
from cap_tpu.tpu import rns as j_rns  # noqa: E402

from cap_tpu_torch import convert  # noqa: E402
from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.errors import CapError as TCapError  # noqa: E402
from cap_tpu_torch.gpu import ed25519 as t_ed  # noqa: E402
from cap_tpu_torch.gpu import ed25519_rns as t_er  # noqa: E402
from cap_tpu_torch.gpu import rns as t_rns  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402

BAD_KEY = (2).to_bytes(32, "little")           # y = 2: not on the curve
N = 128                                        # the batch-inverse width


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(pub) -> bytes:
    return pub.public_bytes(Encoding.Raw, PublicFormat.Raw)


@pytest.fixture(scope="module")
def keys():
    seeds = [bytes([7 + i]) * 32 for i in range(2)]
    privs = [Ed25519PrivateKey.from_private_bytes(s) for s in seeds]
    pubs = [p.public_key() for p in privs] + [
        Ed25519PublicKey.from_public_bytes(BAD_KEY)]
    return seeds, privs, pubs


@pytest.fixture(scope="module")
def tables(keys):
    _, _, pubs = keys
    ref = j_ed.Ed25519KeyTable(pubs)
    port = t_ed.Ed25519KeyTable([_raw(p) for p in pubs], device="cpu")
    return ref, port


def _bytes_equal(port, ref):
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert port.tobytes() == ref.tobytes()


def test_key_tables_bytes_equal(tables):
    ref, port = tables
    assert list(port.invalid) == list(ref.invalid) == [False, False, True]
    assert port.key_bytes == ref.key_bytes
    for p_t, r_t in zip(port.rns().tna, ref.rns().tna):
        _bytes_equal(p_t, np.ascontiguousarray(np.asarray(r_t).T))


def test_basepoint_table_bytes_equal():
    for p_t, r_t in zip(t_er.b_table_rns(), j_er.b_table_rns()):
        _bytes_equal(p_t, np.ascontiguousarray(np.asarray(r_t).T))


def test_ed25519_context_matches():
    p, r = t_er.ctx(), j_er.ctx()
    assert (p.A.count, p.B.count) == (r.A.count, r.B.count) == (23, 23)
    for name in ("sig_c", "p_B", "cp_A", "cp_B"):
        _bytes_equal(getattr(p, name), getattr(r, name))
    assert p.a_mod_p == r.a_mod_p


def _rand_vals(rng, bound: int, n: int):
    nbytes = (bound.bit_length() + 71) // 8
    return [int.from_bytes(rng.bytes(nbytes), "big") % bound
            for _ in range(n)]


@pytest.mark.parametrize("which", ["ed25519", "rsa2048"])
def test_rns_to_limbs_matches_jax(which):
    rng = np.random.default_rng(3)
    if which == "ed25519":
        pc, jc, k_out = t_er.ctx(), j_er.ctx(), 17
        bound = 3 * pc.p_int
        conv_p, conv_j = pc.to_limbs, jc.to_limbs
    else:
        pc, jc, k_out = t_rns.context(2048, 129), j_rns.context(2048, 129), 130
        bound = 3 << 2048
        conv_p = t_rns._to_limbs_for(pc, k_out)
        conv_j = j_rns._to_limbs_for(jc, k_out)
    vals = _rand_vals(rng, bound, 64) + [0, 1, bound - 1]
    res = np.asarray([[v % int(m) for m in pc.A.m] for v in vals],
                     np.int32).T.copy()
    got = conv_p(torch.from_numpy(res)).numpy()
    want = np.asarray(conv_j(jnp.asarray(res))).astype(np.int64)
    assert got.shape == want.shape == (k_out, len(vals))
    assert np.array_equal(got, want)
    assert [sum(int(x) << (16 * i) for i, x in enumerate(got[:, j]))
            for j in range(len(vals))] == vals


def _chunk(keys):
    """A 128-lane chunk: honest, tampered, S + L, wrong-length and
    undecodable-key lanes; padding lanes empty on key row 0. Returns
    (sigs, msgs, rows, expected verdicts of the 12 live lanes)."""
    _, privs, _ = keys
    sigs, msgs, rows = [], [], []
    for j in range(12):
        m = b"msg-%d" % j
        sigs.append(privs[j % 2].sign(m))
        msgs.append(m)
        rows.append(j % 2)
    sigs[3] = sigs[3][:10] + bytes([sigs[3][10] ^ 4]) + sigs[3][11:]
    s = int.from_bytes(sigs[5][32:], "little") + t_ed.L_ORDER
    sigs[5] = sigs[5][:32] + s.to_bytes(32, "little")
    sigs[7] = sigs[7][:63]
    rows[9] = 2                                  # the undecodable key
    expect = [j not in (3, 5, 7, 9) for j in range(12)]
    fill = N - len(sigs)
    return (sigs + [b""] * fill, msgs + [b""] * fill,
            np.asarray(rows + [0] * fill), expect)


def _records(keys, table):
    sigs, msgs, rows, expect = _chunk(keys)
    return t_ed.ed_packed_records(table, sigs, msgs, rows), expect


def test_packed_records_bytes_equal(keys, tables):
    ref, port = tables
    sigs, msgs, rows, _ = _chunk(keys)
    _bytes_equal(t_ed.ed_packed_records(port, sigs, msgs, rows),
                 j_ed.ed_packed_records(ref, sigs, msgs,
                                        rows.astype(np.int32)))


def test_rns_core_verdicts_equal(keys, tables):
    ref, port = tables
    rec, expect = _records(keys, port)
    s, kk, yr, sign_r, idx, flags = t_ed._ed_packed_unpack(
        torch.from_numpy(rec))
    got = t_er._ed25519_rns_core(s, kk, yr, sign_r, idx, port.rns()) & flags
    js, jkk, jyr, jsign, jbad, jidx, jflags = j_ed._ed_packed_unpack(
        jnp.asarray(rec))
    want = j_er._ed25519_rns_core(
        js, jkk, jyr, jsign, jbad, jidx, *ref.rns().tna,
        *j_er.b_table_rns(), *j_ed.consts().dev) & jflags
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist()[:12] == expect


def test_converted_tables_give_the_same_verdicts(keys, tables):
    ref, port = tables
    c = j_er.ctx()
    ctx_arrays = {b: {k: np.asarray(getattr(c, b)[k]) for k in
                      ("m", "m_f", "inv_f", "inv_Mi")} for b in ("dA", "dB")}
    for w in ("W_AB", "W_BA"):
        ctx_arrays[w] = tuple(np.asarray(h, np.float32)
                              for h in getattr(c, w))
    for n in ("Amod_B", "Bmod_A", "invA_B", "sig_c", "p_B", "cp_A", "cp_B"):
        ctx_arrays[n] = np.asarray(getattr(c, n))
    conv = convert.ed25519_key_table(
        port.keys, ctx_arrays, [np.asarray(t) for t in ref.rns().tna],
        [np.asarray(t) for t in j_er.b_table_rns()], device="cpu")
    rec, expect = _records(keys, conv)
    assert t_ed.verify_ed_packed_pending(conv, rec).tolist()[:12] == expect


def test_rfc8032_signatures_bytes_equal_openssl():
    rng = np.random.default_rng(5)
    for _ in range(4):
        seed = rng.bytes(32)
        msg = rng.bytes(int(rng.integers(0, 200)))
        ossl = Ed25519PrivateKey.from_private_bytes(seed)
        port = tt.Ed25519PrivateKey(seed)
        assert port.public_key().raw == _raw(ossl.public_key())
        assert port.sign(msg) == ossl.sign(msg)


def _ossl_verify(raw: bytes, sig: bytes, msg: bytes) -> bool:
    try:
        Ed25519PublicKey.from_public_bytes(raw).verify(sig, msg)
        return True
    except InvalidSignature:
        return False


def _forged(raw: bytes, msg: bytes, order: int, rng) -> bytes:
    """A signature that verifies (without cofactor) under a key A of
    small order: R = [S]B + [j](−A) with j ≡ k mod order."""
    a = t_ed.decode_point(raw)
    neg_a = ((t_ed.P - a[0]) % t_ed.P, a[1])
    while True:
        s = int(rng.integers(1, 1 << 62))
        j = int(rng.integers(0, order))
        r = t_ed.normalize([t_ed.ext_add(
            t_ed.to_ext(t_ed.scalar_mult(s, t_ed._B_POINT)),
            t_ed.to_ext(t_ed.scalar_mult(j, neg_a)))])[0]
        rb = t_ed.encode_point(r)
        k = int.from_bytes(hashlib.sha512(rb + raw + msg).digest(),
                           "little") % t_ed.L_ORDER
        if k % order == j:
            return rb + s.to_bytes(32, "little")


def _adversarial():
    rng = np.random.default_rng(9)
    priv = Ed25519PrivateKey.from_private_bytes(b"\x11" * 32)
    raw = _raw(priv.public_key())
    msg = b"adversarial"
    sig = priv.sign(msg)
    s = int.from_bytes(sig[32:], "little")
    r_big = bytearray((t_ed.P + 3).to_bytes(32, "little"))
    identity = (1).to_bytes(32, "little")
    order2 = (t_ed.P - 1).to_bytes(32, "little")      # (0, −1)
    return [
        ("honest", raw, sig, msg, True),
        ("tampered message", raw, sig, msg + b"!", False),
        ("tampered R", raw, bytes([sig[0] ^ 1]) + sig[1:], msg, False),
        ("S + L", raw, sig[:32] + (s + t_ed.L_ORDER).to_bytes(32, "little"),
         msg, False),
        ("R with y >= p", raw, bytes(r_big) + sig[32:], msg, False),
        ("63-byte signature", raw, sig[:63], msg, False),
        ("65-byte signature", raw, sig + b"\0", msg, False),
        ("key that does not decode", BAD_KEY, sig, msg, False),
        ("small-order key (identity), forged", identity,
         _forged(identity, msg, 1, rng), msg, True),
        ("small-order key (order 2), forged", order2,
         _forged(order2, msg, 2, rng), msg, True),
        ("small-order key, honest signature of another key", identity, sig,
         msg, False),
    ]


@pytest.mark.parametrize("case", _adversarial(), ids=lambda c: c[0])
def test_oracle_agrees_with_openssl(case):
    _, raw, sig, msg, want = case
    assert t_ed.py_ed25519_verify(raw, sig, msg) is want
    assert _ossl_verify(raw, sig, msg) is want


@pytest.mark.parametrize("raw", [
    (1).to_bytes(31, "little") + b"\x80",          # x = 0, sign bit 1
    (t_ed.P + 1).to_bytes(32, "little"),            # y = p + 1 ≥ p
], ids=["x0-sign-set", "y-ge-p"])
def test_openssl_accepts_keys_the_device_ladder_rejects(raw):
    """The reference's two verifiers disagree on non-canonical key
    encodings of the identity (ROADMAP §C): OpenSSL decodes them and
    accepts R = [S]B for any message; RFC 8032 decoding (the JAX device
    ladder, and so the port) rejects the key."""
    s = 987654321
    sig = t_ed.encode_point(t_ed.scalar_mult(s, t_ed._B_POINT)) + \
        s.to_bytes(32, "little")
    assert t_ed.decode_point(raw) is None and j_ed.decode_point(raw) is None
    assert _ossl_verify(raw, sig, b"any message")
    assert not t_ed.py_ed25519_verify(raw, sig, b"any message")


@pytest.mark.parametrize("data", [
    {"kty": "OKP", "crv": "X448", "x": "AA"},
    {"kty": "OKP", "x": "AA"},
    {"kty": "OKP", "crv": "Ed25519"},
    {"kty": "OKP", "crv": "Ed25519", "x": 7},
    {"kty": "OKP", "crv": "Ed25519", "x": "AAAA"},
    {"kty": "OKP", "crv": "Ed25519", "x": "A" * 44},
    {"kty": "OKP", "crv": "Ed25519", "x": "!!!"},
], ids=["curve", "no-crv", "no-x", "x-not-str", "short", "long", "b64"])
def test_okp_jwk_errors_match_jax(data):
    with pytest.raises(JCapError) as ref:
        j_jwk.parse_jwk(dict(data))
    with pytest.raises(TCapError) as port:
        t_jwk.parse_jwk(dict(data))
    assert type(port.value).__name__ == type(ref.value).__name__
    assert str(port.value) == str(ref.value)


def test_okp_jwk_round_trip_and_undecodable_key():
    raw = _raw(Ed25519PrivateKey.from_private_bytes(b"\x05" * 32)
               .public_key())
    for key_raw in (raw, BAD_KEY):
        doc = t_jwk.serialize_public_key(t_ed.HostEd25519PublicKey(key_raw),
                                         kid="k")
        assert doc["kty"] == "OKP" and doc["crv"] == "Ed25519"
        assert t_jwk.parse_jwk(doc).key.raw == key_raw
        assert _raw(j_jwk.parse_jwk(doc).key) == key_raw
