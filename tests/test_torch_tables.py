"""The port's table builders against the JAX package's, byte for byte,
and tables carried across by cap_tpu_torch.convert."""

import hashlib

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu import testing as jt  # noqa: E402
from cap_tpu.jwt import algs  # noqa: E402
from cap_tpu.tpu import ec_rns as j_ec_rns  # noqa: E402
from cap_tpu.tpu import rns as j_rns  # noqa: E402

from cap_tpu_torch import convert  # noqa: E402
from cap_tpu_torch.gpu import ec as t_ec  # noqa: E402
from cap_tpu_torch.gpu import ec_rns as t_ec_rns  # noqa: E402
from cap_tpu_torch.gpu import rns as t_rns  # noqa: E402
from cap_tpu_torch.gpu import rsa as t_rsa  # noqa: E402

BASE_KEYS = ("m", "m_f", "inv_f", "inv_Mi")


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


def _np(a, dtype=None):
    a = np.asarray(a)
    if dtype is not None and a.dtype != dtype:
        assert np.array_equal(a.astype(np.float64),
                              np.round(a.astype(np.float64)))
        a = a.astype(dtype)
    return a


def _bytes_equal(port, ref):
    ref = np.asarray(ref)
    port = np.asarray(port)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    assert port.shape == ref.shape
    assert port.tobytes() == ref.tobytes()


def _ctx_arrays(c, field: bool):
    out = {b: {k: np.asarray(getattr(c, b)[k]) for k in BASE_KEYS}
           for b in ("dA", "dB")}
    for w in ("W_AB", "W_BA"):
        out[w] = tuple(np.asarray(h, np.float32) for h in getattr(c, w))
    names = ("Amod_B", "Bmod_A", "invA_B")
    if field:
        names += ("sig_c", "p_B", "cp_A", "cp_B")
    for n in names:
        out[n] = np.asarray(getattr(c, n))
    return out


def _check_context(port, ref, field: bool):
    assert (port.A.count, port.B.count) == (ref.A.count, ref.B.count)
    for b in ("dA", "dB"):
        for k in BASE_KEYS:
            _bytes_equal(getattr(port, b)[k], getattr(ref, b)[k])
    for w in ("W_AB", "W_BA", "T_A", "T_B"):
        for ph, rh in zip(getattr(port, w), getattr(ref, w)):
            _bytes_equal(ph, _np(rh, np.int32))
    names = ("Amod_B", "Bmod_A", "invA_B")
    if field:
        names += ("sig_c", "p_B", "cp_A", "cp_B")
    for n in names:
        _bytes_equal(getattr(port, n), getattr(ref, n))
    if field:
        for ph, rh in zip(port.A2, ref.A2):
            _bytes_equal(ph, rh)


@pytest.fixture(scope="module")
def rsa_keys():
    return [jt.generate_keys(algs.RS256)[0] for _ in range(2)]


@pytest.fixture(scope="module")
def ec_keys():
    return [jt.generate_keys(algs.ES256)[0] for _ in range(2)]


def test_rsa2048_context_bytes_equal():
    _check_context(t_rns.RNSContext(2048, 129),
                   j_rns.RNSContext(2048, 129), field=False)


def test_rsa_key_table_bytes_equal(rsa_keys):
    n_ints = [k.public_key().public_numbers().n for k in rsa_keys]
    ref = j_rns.RNSKeyTable(j_rns.context(2048, 129), n_ints)
    port = t_rns.RNSKeyTable(t_rns.context(2048, 129), n_ints)
    for n in ("sig_c", "n_B", "a2_A", "a2_B"):
        _bytes_equal(getattr(port, n), getattr(ref, n))


def test_p256_context_bytes_equal():
    _check_context(t_ec_rns.ctx_for("P-256"), j_ec_rns.ctx_for("P-256"),
                   field=True)


def test_p256_window_table_bytes_equal(ec_keys):
    pubs = [k.public_key() for k in ec_keys]
    ref = j_ec_rns.ECRNSKeyTable("P-256", pubs)
    port = t_ec_rns.ECRNSKeyTable("P-256", [
        t_ec.HostECPublicKey("P-256", p.public_numbers().x,
                             p.public_numbers().y) for p in pubs])
    _bytes_equal(port.tab, ref.tab)


def _rs_case(rsa_keys):
    """Two valid RS256 signatures, one tampered, one of wrong length."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    msg = b"convert parity"
    sigs = [k.sign(msg, padding.PKCS1v15(), hashes.SHA256())
            for k in rsa_keys]
    bad = bytearray(sigs[0])
    bad[10] ^= 1
    sigs += [bytes(bad), sigs[1][:-1]]
    rows = np.asarray([0, 1, 0, 1])
    return msg, sigs, rows, [True, True, False, False]


def test_converted_rsa_tables_give_the_same_verdicts(rsa_keys):
    msg, sigs, rows, expect = _rs_case(rsa_keys)
    nums = [(k.public_key().public_numbers().n, 65537) for k in rsa_keys]
    ref_ctx = j_rns.context(2048, 129)
    ref_tab = j_rns.RNSKeyTable(ref_ctx, [n for n, _ in nums])
    conv = convert.rsa_key_table(
        nums, _ctx_arrays(ref_ctx, field=False),
        {n: np.asarray(getattr(ref_tab, n))
         for n in ("sig_c", "n_B", "a2_A", "a2_B")}, device="cpu")
    own = t_rsa.RSAKeyTable(nums, device="cpu")
    digest = hashlib.sha256(msg).digest()
    hash_mat = np.tile(np.frombuffer(digest, np.uint8), (len(sigs), 1))
    lens = np.asarray([len(s) for s in sigs])
    for table in (conv, own):
        rec = t_rsa.rs_packed_records(
            table, _byte_matrix(sigs, 2 * table.k), lens, hash_mat,
            "sha256", rows)
        ok = t_rsa.verify_rs_packed_pending(table, rec, "sha256")
        assert ok.tolist() == expect


def test_converted_ec_tables_give_the_same_verdicts(ec_keys):
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        decode_dss_signature,
    )

    msg = b"convert parity"
    digest = hashlib.sha256(msg).digest()
    sigs = []
    for k in ec_keys:
        r, s = decode_dss_signature(k.sign(msg, ec.ECDSA(hashes.SHA256())))
        sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big"))
    bad = bytearray(sigs[0])
    bad[-1] ^= 1
    sigs += [bytes(bad), b"\x00" * 64]
    rows = np.asarray([0, 1, 0, 0])
    expect = [True, True, False, False]
    pubs = [k.public_key() for k in ec_keys]
    host = [t_ec.HostECPublicKey("P-256", p.public_numbers().x,
                                 p.public_numbers().y) for p in pubs]
    ref = j_ec_rns.ECRNSKeyTable("P-256", pubs)
    conv = convert.ec_key_table(
        "P-256", host, _ctx_arrays(ref.ctx, field=True),
        np.asarray(ref.tab), device="cpu")
    own = t_ec.ECKeyTable("P-256", host, device="cpu")
    n = 128                                   # the batch-inverse width
    sig_mat = np.zeros((n, 64), np.uint8)
    sig_mat[:len(sigs)] = _byte_matrix(sigs, 64)
    lens = np.zeros(n, np.int64)
    lens[:len(sigs)] = 64
    hash_mat = np.zeros((n, 32), np.uint8)
    hash_mat[:len(sigs)] = np.frombuffer(digest, np.uint8)
    key_idx = np.zeros(n, np.int64)
    key_idx[:len(sigs)] = rows
    for table in (conv, own):
        rec = t_ec.es_packed_records(table, sig_mat, lens, hash_mat, 32,
                                     key_idx)
        ok, deg = t_ec.verify_es_packed_pending(table, rec, 32)
        assert ok[:len(sigs)].tolist() == expect
        assert not deg.any()


def test_convert_rejects_mismatched_shapes():
    ctx = t_ec_rns.ctx_for("P-256")
    arrays = _ctx_arrays(ctx, field=True)
    arrays["cp_A"] = arrays["cp_A"][:3]
    with pytest.raises(ValueError, match="cp_A"):
        convert.load_context(ctx, arrays)
    arrays = _ctx_arrays(ctx, field=True)
    arrays["Amod_B"] = arrays["Amod_B"] + 0.5
    with pytest.raises(ValueError, match="non-integer"):
        convert.load_context(ctx, arrays)
    assert torch.equal(
        ctx.device_consts("cpu").mA,
        convert.load_context(ctx, _ctx_arrays(ctx, True))
        .device_consts("cpu").mA)


_ES_FOR = {"P-384": (algs.ES384, "sha384"), "P-521": (algs.ES512, "sha512")}


@pytest.fixture(scope="module")
def wide_keys():
    """One OpenSSL key on each of P-384 and P-521, with the JAX
    package's window table of it."""
    out = {}
    for crv, (alg, _) in _ES_FOR.items():
        key = jt.generate_keys(alg)[0]
        out[crv] = key, j_ec_rns.ECRNSKeyTable(crv, [key.public_key()])
    return out


@pytest.mark.parametrize("crv", ["P-384", "P-521"])
def test_wide_curve_context_bytes_equal(crv):
    port, ref = t_ec_rns.ctx_for(crv), j_ec_rns.ctx_for(crv)
    _check_context(port, ref, field=True)
    assert port.n_windows == ref.n_windows


@pytest.mark.parametrize("crv", ["P-384", "P-521"])
def test_wide_curve_window_table_bytes_equal(crv, wide_keys):
    key, ref = wide_keys[crv]
    nums = key.public_key().public_numbers()
    port = t_ec_rns.ECRNSKeyTable(crv, [t_ec.HostECPublicKey(crv, nums.x,
                                                             nums.y)])
    _bytes_equal(port.tab, ref.tab)


@pytest.mark.parametrize("crv", ["P-384", "P-521"])
def test_converted_wide_curve_tables_give_the_same_verdicts(crv,
                                                            wide_keys):
    """``convert.ec_key_table`` carries the JAX package's P-384 and P-521
    context and table across; the converted table and the port's own
    give the same verdicts (coordinates 48 and 66 bytes, SHA-384 and
    SHA-512 digests, no truncation at 512 < 521 bits)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        decode_dss_signature,
    )

    _, hash_name = _ES_FOR[crv]
    key, ref = wide_keys[crv]
    cb = t_ec.curve(crv).coord_bytes
    msg = b"convert parity " + crv.encode()
    digest = hashlib.new(hash_name, msg).digest()
    h = hashes.SHA384() if hash_name == "sha384" else hashes.SHA512()
    r, s = decode_dss_signature(key.sign(msg, ec.ECDSA(h)))
    good = r.to_bytes(cb, "big") + s.to_bytes(cb, "big")
    bad = bytearray(good)
    bad[-1] ^= 1
    sigs = [good, bytes(bad), b"\x00" * (2 * cb), good[:-1]]
    expect = [True, False, False, False]
    nums = key.public_key().public_numbers()
    host = [t_ec.HostECPublicKey(crv, nums.x, nums.y)]
    conv = convert.ec_key_table(crv, host, _ctx_arrays(ref.ctx, field=True),
                                np.asarray(ref.tab), device="cpu")
    own = t_ec.ECKeyTable(crv, host, device="cpu")
    n = 128                                   # the batch-inverse width
    sig_mat = np.zeros((n, 2 * cb), np.uint8)
    sig_mat[:len(sigs)] = _byte_matrix(sigs, 2 * cb)
    lens = np.zeros(n, np.int64)
    lens[:len(sigs)] = [len(s) for s in sigs]
    hash_mat = np.zeros((n, 64), np.uint8)
    hash_mat[:len(sigs), :len(digest)] = np.frombuffer(digest, np.uint8)
    key_idx = np.zeros(n, np.int64)
    for table in (conv, own):
        rec = t_ec.es_packed_records(table, sig_mat, lens, hash_mat,
                                     len(digest), key_idx)
        ok, deg = t_ec.verify_es_packed_pending(table, rec, len(digest))
        assert ok[:len(sigs)].tolist() == expect
        assert not deg.any()
    _bytes_equal(conv.rns().tab, own.rns().tab)
