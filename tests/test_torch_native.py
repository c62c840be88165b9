"""The port's native batch prep (``cap_tpu_torch.runtime.native_binding``)
against the JAX package's (``cap_tpu.runtime.native_binding``), live,
on the same tokens: ``prepare_batch_arrays`` field by field (status,
alg id and raw alg bytes, kid bytes and length, signature, payload,
signing input, digest) and its error objects (class and message);
``sha_batch`` against ``hashlib``; the record packer byte-equal to the
numpy builders ``rs_packed_records`` and ``es_packed_records``; and
``prefetch_claims`` equal to ``json.loads``, its fallback envelope
included."""

import hashlib
import json
import random

import numpy as np
import pytest

from cap_tpu.jwt import tpu_keyset as j_keyset
from cap_tpu.runtime import native_binding as ref

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import ec as t_ec
from cap_tpu_torch.gpu import mldsa
from cap_tpu_torch.gpu import rsa as t_rsa
from cap_tpu_torch.jwt import algs
from cap_tpu_torch.jwt.gpu_keyset import es_records, rsa_records
from cap_tpu_torch.jwt.jose import b64url_encode, parse_jws
from cap_tpu_torch.runtime import native_binding as nb


def _h(d) -> str:
    return b64url_encode(json.dumps(d).encode())


def _raw(header: bytes, payload: bytes = b"{}", sig: bytes = b"sig") -> str:
    return ".".join(b64url_encode(x) for x in (header, payload, sig))


@pytest.fixture(scope="module")
def valid_tokens():
    """One signed token of each of the ten classical algs and of
    ML-DSA-44/65/87 (the port's seeded signers)."""
    rng = random.Random(9)
    rsa_key = tt.generate_rsa_key(rng, 1024)
    ec_keys = {c: tt.generate_ec_key(rng, c)
               for c in ("P-256", "P-384", "P-521")}
    ed_key = tt.generate_ed25519_key(rng)
    out = []
    for alg in ("RS256", "RS384", "RS512", "PS256", "PS384", "PS512"):
        out.append(tt.sign_jwt(rsa_key, alg, {"sub": alg}, kid="rsa",
                               rng=rng, salt_len=32))
    for alg, crv in (("ES256", "P-256"), ("ES384", "P-384"),
                     ("ES512", "P-521")):
        out.append(tt.sign_jwt(ec_keys[crv], alg, {"sub": alg}, kid=crv,
                               rng=rng))
    out.append(tt.sign_jwt(ed_key, algs.EdDSA, {"sub": "ed"}))
    for k, pset in enumerate(("ML-DSA-44", "ML-DSA-65", "ML-DSA-87")):
        priv, _ = mldsa.keygen(pset, bytes([k + 1]) * 32)
        out.append(tt.sign_jwt(priv, pset, {"sub": pset}, kid=pset))
    return out


MALFORMED = [
    "", "a", "a.b", "a.b.c.d", "..", "a..c", ".e30.c2ln",
    "!!!.e30.c2ln", "e30.!!!.c2ln", "e30.e30.!!!", "e30.e30.c2ln=",
    "aaaaa.e30.c2ln",                              # header length % 4 == 1
    "e30.aaaaa.c2ln", "e30.e30.aaaaa",
    _h({"alg": "RS256"}) + "." + _h({}) + ".",     # unsigned
    _h({"alg": "RS256", "crit": ["exp"]}) + ".e30.c2ln",
    _h({"alg": "RS256", "crit": None}) + ".e30.c2ln",
    b64url_encode(b"[1]") + ".e30.c2ln",           # header not an object
    b64url_encode(b"{}") + ".e30.c2ln",            # no alg
    b64url_encode(b'{"alg":""}') + ".e30.c2ln",    # empty alg
    b64url_encode(b'{"alg":42}') + ".e30.c2ln",    # alg not a string
    b64url_encode(b'{"alg":"RS256"') + ".e30.c2ln",     # truncated JSON
    b64url_encode(b'{"alg":"RS256"} x') + ".e30.c2ln",  # trailing junk
    b64url_encode(b"not json") + ".e30.c2ln",
    b64url_encode(b'{"alg":"RS256","kid":"\xff"}') + ".e30.c2ln",  # not UTF-8
    "é.é.é", _h({"alg": "RS256"}) + ".e30.c2ln☃",
    "é" + _h({"alg": "RS256"}) + ".e30.c2ln",
]

TRICKY = [
    # duplicate alg keys: the last wins (json.loads)
    b64url_encode(b'{"alg":"RS256","alg":"ES256"}') + "." + _h({"a": 1})
    + ".c2ln",
    # nested objects and arrays around alg; a unicode escape in kid
    b64url_encode(
        b'{"x":{"alg":"PS256"},"alg":"RS384","arr":[1,{"kid":"no"},null],'
        b'"kid":"k\\u00e9y","n":1.5e3,"b":true}') + "." + _h({}) + ".c2ln",
    b64url_encode(b'{"alg":"EdDSA","kid":123}') + ".e30.c2ln",  # non-str kid
    b64url_encode(b'{"alg":"ES256","kid":null}') + ".e30.c2ln",
    b64url_encode(b'{"alg":"ES256","kid":["a"]}') + ".e30.c2ln",
    b64url_encode(b'{"alg":"HS256"}') + ".e30.c2ln",      # unknown alg
    b64url_encode(b'{"alg":"ML-DSA-65"}') + ".e30.c2ln",
    b64url_encode(b'{"alg":"' + b"A" * 40 + b'"}') + ".e30.c2ln",  # > 32 B
    b64url_encode(b'{"alg":"RS256\\u0000"}') + ".e30.c2ln",
    b64url_encode(b' \n{"alg" : "ES384" , "typ":"JWT"}\t ') + ".e30.c2ln",
]

KIDS = ["", "a\x00b", "kéy", "中文", "\U0001f600", "K" * 160,
        "K" * 161, "é" * 80, "é" * 81, "k" * 300]


def _kid_tokens():
    out = [_h({"alg": "RS256", "kid": k}) + "." + _h({}) + ".c2ln"
           for k in KIDS]
    out.append(b64url_encode('{"alg":"RS256","kid":"ké"}'.encode())
               + ".e30.c2ln")                      # raw UTF-8 in the header
    return out


def _fuzz_tokens(valid):
    """Seeded random byte mutations of valid tokens: 1-3 characters
    replaced by a base64url character, a dot, or a byte no segment
    accepts."""
    rng = np.random.default_rng(20261017)
    alphabet = list("AZaz09._-!=+/ {}\"")
    out = []
    for _ in range(400):
        chars = list(valid[int(rng.integers(len(valid)))])
        for _ in range(int(rng.integers(1, 4))):
            chars[int(rng.integers(len(chars)))] = alphabet[
                int(rng.integers(len(alphabet)))]
        out.append("".join(chars))
    return out


def _assert_same_prep(tokens):
    """The port's PreparedBatch equals the JAX package's on every
    field; returns the port's."""
    a = nb.prepare_batch_arrays(tokens)
    b = ref.prepare_batch_arrays(tokens)
    assert a.n == b.n == len(tokens)
    for f in ("status", "alg_id", "alg_len", "alg_raw", "kid_len",
              "kid_mat", "sig_len", "payload_len", "si_len", "digest",
              "digest_len"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for i in range(len(tokens)):
        if a.status[i] != 0:
            ea, eb = a.error(i), b.error(i)
            assert type(ea).__name__ == type(eb).__name__, tokens[i]
            assert str(ea) == str(eb), tokens[i]
            continue
        assert a.alg(i) == b.alg(i) and a.kid(i) == b.kid(i), tokens[i]
        assert a.signature(i) == b.signature(i), tokens[i]
        assert a.payload_bytes(i) == b.payload_bytes(i), tokens[i]
        assert a.signing_input(i) == b.signing_input(i), tokens[i]
        assert a.token(i) == b.token(i), tokens[i]
        pa, pb_ = a.parsed(i), b.parsed(i)
        assert (pa.alg, pa.kid, pa.signature, pa.payload,
                pa.signing_input, pa.digest()) == \
            (pb_.alg, pb_.kid, pb_.signature, pb_.payload,
             pb_.signing_input, pb_.digest()), tokens[i]
    return a


def test_valid_tokens_equal_the_reference_and_the_strict_parser(
        valid_tokens):
    pb = _assert_same_prep(valid_tokens)
    assert (pb.status == 0).all()
    for i, tok in enumerate(valid_tokens):
        p = parse_jws(tok)
        assert (pb.alg(i), pb.kid(i)) == (p.alg, p.kid)
        assert pb.signature(i) == p.signature
        assert pb.payload_bytes(i) == p.payload
        assert pb.signing_input(i) == p.signing_input
        if p.alg in algs.HASH_FOR_ALG and p.alg != algs.EdDSA:
            want = hashlib.new(algs.HASH_FOR_ALG[p.alg],
                               p.signing_input).digest()
        else:
            want = b""
        assert pb.parsed(i).digest() == want, p.alg
    ml = [i for i, t in enumerate(valid_tokens)
          if parse_jws(t).alg.startswith("ML-DSA")]
    assert len(ml) == 3 and all(pb.alg_id[i] == -1 for i in ml)


@pytest.mark.parametrize("case", ["malformed", "tricky", "kids", "fuzz"])
def test_prepare_equals_the_reference(valid_tokens, case):
    tokens = {"malformed": lambda: MALFORMED, "tricky": lambda: TRICKY,
              "kids": _kid_tokens,
              "fuzz": lambda: _fuzz_tokens(valid_tokens)}[case]()
    pb = _assert_same_prep(list(tokens))
    if case == "malformed":
        assert (pb.status != 0).all()
    if case == "kids":
        assert [pb.kid(i) for i in range(len(KIDS))] == KIDS
        assert list(pb.kid_len[:len(KIDS)]) == [
            -2 if len(k.encode()) > 160 else len(k.encode()) for k in KIDS]
    if case == "fuzz":
        # the mutations reach both sides of every branch
        assert 0 < (pb.status == 0).sum() < pb.n
        assert len(set(pb.status.tolist())) >= 3


def test_kid_rows_equal_the_reference():
    tokens = _kid_tokens() + [_h({"alg": "RS256"}) + ".e30.c2ln"]
    a = nb.prepare_batch_arrays(tokens)
    b = ref.prepare_batch_arrays(tokens)
    table = {"": 9, "a\x00b": 3, "kéy": 1, "K" * 160: 7,
             "K" * 161: 5, "é" * 80: 4}
    idx = np.arange(len(tokens))
    got = a.kid_rows(idx, table)
    np.testing.assert_array_equal(got, b.kid_rows(idx, table))
    # overlong kids and kids outside the table: -2; no kid: -1
    assert list(got) == [9, 3, 1, -2, -2, 7, -2, 4, -2, -2, -2, -1]


@pytest.mark.parametrize("bits", [256, 384, 512])
def test_sha_batch_equals_hashlib(bits):
    rng = np.random.default_rng(bits)
    chunks = [b"", b"abc", bytes(55), bytes(56), bytes(64), bytes(111),
              bytes(112), bytes(128), b"x" * 1000,
              bytes(range(256)) * 7] + [
        rng.integers(0, 256, int(rng.integers(0, 600)), np.uint8).tobytes()
        for _ in range(40)]
    want = [hashlib.new(f"sha{bits}", c).digest() for c in chunks]
    assert nb.sha_batch(chunks, bits) == want
    assert ref.sha_batch(chunks, bits) == want
    assert nb.sha_batch([], bits) == []
    assert nb.sha_batch([b""], bits) == [hashlib.new(f"sha{bits}").digest()]


def _pad_rows(rows, width):
    out = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        out[i, :min(len(r), width)] = np.frombuffer(r[:width], np.uint8)
    return out


@pytest.mark.parametrize("case", [("rs", "RS256"), ("rs", "RS512"),
                                  ("ps", "PS256"), ("es", "P-256"),
                                  ("es", "P-384"), ("es", "P-521")])
def test_pack_sig_records_equal_the_numpy_builders(case):
    """40 tokens of one family (signatures of the right length, one
    byte short, one byte long, one byte) in a 128-row chunk: the
    native records equal the numpy builder's on the same inputs, the
    digest taken by hashlib."""
    kind, which = case
    rng = np.random.default_rng(sum(map(ord, kind + which)))
    if kind == "es":
        alg = {"P-256": "ES256", "P-384": "ES384", "P-521": "ES512"}[which]
        cp = t_ec.curve(which)
        table = t_ec.ECKeyTable(which, [t_ec.HostECPublicKey(
            which, cp.gx, cp.gy)] * 3, device="cpu")
        sizes = [2 * table.coord_bytes] * 3
    else:
        alg = which
        pyrng = random.Random(5)
        # a 512-bit key: too short for PKCS#1 v1.5 under SHA-512
        keys = [tt.generate_rsa_key(pyrng, b) for b in (1024, 768, 512)]
        table = t_rsa.RSAKeyTable([(k.n, k.e) for k in keys], device="cpu")
        sizes = table.sizes_bytes
    hash_name = algs.HASH_FOR_ALG[alg]
    h_len = t_rsa.HASH_LEN[hash_name]
    m, pad = 40, 128
    rows = rng.integers(0, 3, m)
    tokens, sigs = [], []
    for j in range(m):
        size = sizes[rows[j]]
        length = [size, size - 1, size + 1, 1][j % 4]
        sig = rng.integers(0, 256, length, np.uint8).tobytes()
        sigs.append(sig)
        tokens.append(_raw(json.dumps({"alg": alg}).encode(),
                           b'{"sub":"%d"}' % j, sig))
    pb = nb.prepare_batch_arrays(tokens)
    assert (pb.status == 0).all()
    chunk = np.arange(m)
    width = 2 * (table.coord_bytes if kind == "es" else table.k)
    sig_mat = np.zeros((pad, width), np.uint8)
    sig_mat[:m] = _pad_rows(sigs, width)
    sig_lens = np.zeros(pad, np.int64)
    sig_lens[:m] = [len(s) for s in sigs]
    hash_mat = np.zeros((pad, 64), np.uint8)
    hash_mat[:m] = _pad_rows([hashlib.new(hash_name, pb.signing_input(j))
                              .digest() for j in range(m)], 64)
    key_idx = np.zeros(pad, np.int64)
    key_idx[:m] = rows
    rb = ref.prepare_batch_arrays(tokens)
    if kind == "es":
        want = t_ec.es_packed_records(table, sig_mat, sig_lens, hash_mat,
                                      h_len, key_idx)
        got = es_records(pb, table, chunk, rows, h_len, pad)
        jax_native = j_keyset._pack_es_record(rb, table, chunk,
                                              rows.astype(np.int32), h_len,
                                              pad)
    else:
        want = t_rsa.rs_packed_records(table, sig_mat, sig_lens, hash_mat,
                                       hash_name, key_idx, kind)
        got = rsa_records(pb, table, kind, hash_name, chunk, rows, pad)
        jax_native = j_keyset._pack_rsa_record(rb, table, kind, hash_name,
                                               chunk, rows.astype(np.int32),
                                               pad)
    assert got.shape == want.shape == (pad, width + h_len + 2)
    assert got.tobytes() == jax_native.tobytes()
    flags = got[:m, width + h_len]
    assert flags.any() and not flags.all()
    # one difference, as between the JAX package's two packers: a row
    # of the right length whose key is too short for PKCS#1 v1.5 under
    # the hash has flag 0 in both; the native packer zeroes its
    # signature, the numpy builder keeps it
    size_ok = sig_lens == np.asarray(sizes)[key_idx]
    short_key = size_ok & (got[:, width + h_len] == 0)
    if alg == "RS512":
        assert short_key[:m].any() and (rows[short_key[:m]] == 2).all()
        assert want[short_key, :width].any()
        want[short_key, :width] = 0
    else:
        assert not short_key.any()
    assert got.tobytes() == want.tobytes()


def test_pack_sig_records_refuses_bad_indices():
    pb = nb.prepare_batch_arrays([_raw(b'{"alg":"ES256"}')] * 2)
    one = np.ones(2, np.int64)
    with pytest.raises(ValueError):
        pb.pack_sig_records(np.array([0, 2]), one, one, one, 64, 32, 128)
    with pytest.raises(ValueError):
        pb.pack_sig_records(np.array([0, 1]), one, one, one, 64, 32, 1)
    with pytest.raises(ValueError):
        pb.pack_sig_records(np.array([0, 1]), one, one, one, 64, 65, 128)


CLAIMS_EDGE = [
    b"", b"{", b"[1,2", b'{"a":}', b"nul", b'{"a":1}garbage', b"123",
    b'"just a string"', b"[]", b"{}", b"null", b'{"a": NaN}',
    b'{"a": Infinity}', b'{"a": -Infinity}', b'{"\\ud800": 1}',
    b'{"x": "\\udc00 lone"}', b'{"x": "\\ud83d\\ude00"}', b'{"a":1e999}',
    b'{"a":-0.0}', b'{"a":0.1e+5}', b'{"dup":1,"dup":2}',
    b'{"a":' + b"[" * 63 + b"]" * 63 + b"}",
    b'{"a":' + b"[" * 64 + b"]" * 64 + b"}",
    b'{"a":' + b"[" * 100 + b"]" * 100 + b"}",
    b'{"big":' + b"9" * 4300 + b"}", b'{"big":' + b"9" * 4301 + b"}",
    b'{"big":-' + b"9" * 4500 + b"}", b"\xff\xfe", b'{"a":"\xc3\x28"}',
    b'\xef\xbb\xbf{"bom":1}', b'{"a":01}', b'{"a":+1}', b'{"a":.5}',
    b'{"a":1.}', b'{"a":"\x01"}', b'  {"ws": 1}  ',
    b'{"t":true,"f":false,"n":null}',
    b'{"neg":-9223372036854775808,"pos":9223372036854775807}',
    b'{"over":9223372036854775808,"under":-9223372036854775809}',
    b'{"u":"\\u0041\\u00e9\\u4e2d\\uffff"}',
    b'{"s":"\\/\\\\\\"\\b\\f\\n\\r\\t"}', b'{"e":{}}', b'{"e":[[],{}]}',
    b'{"a":2.2250738585072014e-308}', b'{"a":1}{"b":2}',
]


def _claims_fuzz():
    rng = random.Random(20261017)

    def val(d=0):
        r = rng.random()
        if d > 3 or r < 0.3:
            return rng.choice([
                None, True, False, 12345, -7, 0, 3.14159, 1.5e300,
                -2.5e-10, 10 ** 25, -(10 ** 30), "plain", "unié中",
                'esc"q\\u\n\t', "", "x" * 257])
        if r < 0.55:
            return [val(d + 1) for _ in range(rng.randint(0, 4))]
        if r < 0.65:
            return rng.randint(-(10 ** 40), 10 ** 40)
        return {f"k{rng.randint(0, 20)}": val(d + 1)
                for _ in range(rng.randint(0, 5))}

    return [json.dumps({"iss": "https://idp.example.com", "sub": f"u-{i}",
                        "aud": ["a", "b"], "exp": 1790000000 + i,
                        "extra": val()},
                       ensure_ascii=rng.random() < 0.5).encode()
            for i in range(600)]


def _same_typed(a, b):
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same_typed(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same_typed, a, b))
    return a == b or (a != a and b != b)


@pytest.mark.parametrize("case", ["edge", "fuzz"])
def test_prefetch_claims_equals_json_loads(case):
    payloads = CLAIMS_EDGE if case == "edge" else _claims_fuzz()
    tokens = [_raw(b'{"alg":"ES256"}', p) for p in payloads]
    pb = nb.prepare_batch_arrays(tokens)
    rb = ref.prepare_batch_arrays(tokens)
    assert (pb.status == 0).all()
    half = np.arange(0, len(tokens), 2)
    pb.prefetch_claims(half)                       # a cache already there
    pb.prefetch_claims(np.arange(len(tokens)))
    rb.prefetch_claims(np.arange(len(tokens)))
    assert sorted(pb._claims_cache) == list(range(len(tokens)))
    for i, p in enumerate(payloads):
        try:
            want = json.loads(p)
            if not isinstance(want, dict):
                want = "MalformedTokenError: payload is not a JSON object"
        except (ValueError, UnicodeDecodeError) as e:
            want = f"MalformedTokenError: payload is not valid JSON: {e}"
        for got in (pb._claims_cache[i], rb._claims_cache[i]):
            if isinstance(got, Exception):
                got = f"{type(got).__name__}: {got}"
            assert _same_typed(got, want), (p[:80], got, want)
        try:
            via = pb.claims(i)
        except Exception as e:  # noqa: BLE001 - compared below
            via = f"{type(e).__name__}: {e}"
        assert _same_typed(via, want)
    if case == "edge":
        # each fallback class reached the json.loads branch
        assert sum(not isinstance(pb._claims_cache[i], dict)
                   for i in range(len(payloads))) >= 15
