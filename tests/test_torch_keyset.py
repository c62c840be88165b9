"""The slice as a whole: GPUBatchKeySet (plain path on the CPU) against
the JAX package's TPUBatchKeySet (RNS engines) on one mixed RS256 +
ES256 batch — accepts, every rejection class, the trial path — with
verdicts bit-equal: claims dicts equal, exception class and message
equal."""

import base64
import hashlib
import json
import random

import pytest
import torch

pytest.importorskip("cryptography")

from cryptography.hazmat.primitives import hashes  # noqa: E402
from cryptography.hazmat.primitives.asymmetric import ec, padding  # noqa: E402
from cryptography.hazmat.primitives.asymmetric.utils import (  # noqa: E402
    decode_dss_signature,
)

from cap_tpu import testing as jt  # noqa: E402
from cap_tpu.jwt import algs  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.errors import UnsupportedAlgError  # noqa: E402
from cap_tpu_torch.gpu.ec import (  # noqa: E402
    HostECPublicKey,
    curve,
    scalar_mult,
)
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402

P256_N = curve("P-256").n


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _sign_raw(priv, alg: str, header: dict, payload: bytes) -> str:
    """A token over arbitrary payload bytes, signed with an OpenSSL key."""
    si = (_b64(json.dumps(header).encode()) + "." + _b64(payload)).encode()
    if alg == algs.RS256:
        sig = priv.sign(si, padding.PKCS1v15(), hashes.SHA256())
    else:
        r, s = decode_dss_signature(priv.sign(si, ec.ECDSA(hashes.SHA256())))
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    return si.decode() + "." + _b64(sig)


def _with_sig(token: str, sig: bytes) -> str:
    h, p, _ = token.split(".")
    return f"{h}.{p}.{_b64(sig)}"


def _sig(token: str) -> bytes:
    s = token.split(".")[2]
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _degenerate_token(kid: str, inverse: bool, rng):
    """An ES256 token whose two ladder chains meet at the merge, with
    the key derived from the token: Q = (e/r)·G makes u1·G == u2·Q (a
    valid signature through the doubling case), Q = (−e/r)·G makes
    u1·G == −u2·Q (the sum is infinity: rejected). Both raise the
    same-x flag, so the verdict comes from the oracle re-verify."""
    cp = curve("P-256")
    claims = jt.default_claims(now=1_700_000_000, sub=kid)
    si = (_b64(json.dumps({"alg": "ES256", "kid": kid}).encode()) + "."
          + _b64(json.dumps(claims).encode()))
    e = int.from_bytes(hashlib.sha256(si.encode()).digest(), "big")
    k = rng.randrange(1, cp.n)
    r = scalar_mult(cp, k, (cp.gx, cp.gy))[0] % cp.n
    d = (-e if inverse else e) * pow(r, -1, cp.n) % cp.n
    s = (rng.randrange(1, cp.n) if inverse
         else pow(k, -1, cp.n) * (e + r * d) % cp.n)
    key = HostECPublicKey.from_private("P-256", d)
    sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    return key, si + "." + _b64(sig)


@pytest.fixture(scope="module")
def batch():
    """Both keysets over one JWKS document, and one batch of tokens
    labelled by case."""
    rs = [jt.generate_keys(algs.RS256)[0] for _ in range(2)]
    es = [jt.generate_keys(algs.ES256)[0] for _ in range(2)]
    outsider = jt.generate_keys(algs.RS256)[0]
    rng = random.Random(11)
    p_rsa = tt.generate_rsa_key(rng)
    p_ec = tt.generate_ec_key(rng)
    deg_dbl_key, deg_dbl = _degenerate_token("deg-dbl", False, rng)
    deg_inv_key, deg_inv = _degenerate_token("deg-inv", True, rng)
    doc = {"keys": (
        [j_jwk.serialize_public_key(k.public_key(), kid=f"rs-{i}")
         for i, k in enumerate(rs)]
        + [j_jwk.serialize_public_key(k.public_key(), kid=f"es-{i}")
           for i, k in enumerate(es)]
        + [t_jwk.serialize_public_key(p_rsa.public_key(), kid="port-rs"),
           t_jwk.serialize_public_key(p_ec.public_key(), kid="port-es"),
           t_jwk.serialize_public_key(deg_dbl_key, kid="deg-dbl"),
           t_jwk.serialize_public_key(deg_inv_key, kid="deg-inv")])}

    cases = []

    def add(label, token):
        cases.append((label, token))

    claims = jt.default_claims(now=1_700_000_000)
    for j in range(6):
        c = dict(claims, sub=f"u{j}")
        add("valid-rs", jt.sign_jwt(rs[j % 2], algs.RS256, c,
                                    kid=f"rs-{j % 2}"))
        add("valid-es", jt.sign_jwt(es[j % 2], algs.ES256, c,
                                    kid=f"es-{j % 2}"))
    good_rs = cases[0][1]
    good_es = cases[1][1]
    for tok in (good_rs, good_es):
        bad = bytearray(_sig(tok))
        bad[len(bad) // 2] ^= 0x10
        add("tampered", _with_sig(tok, bytes(bad)))
    add("unknown-kid-signer-in-set",
        jt.sign_jwt(rs[0], algs.RS256, claims, kid="nope"))
    add("unknown-kid-outsider",
        jt.sign_jwt(outsider, algs.RS256, claims, kid="nope"))
    add("no-kid", jt.sign_jwt(rs[1], algs.RS256, claims))
    add("no-kid", jt.sign_jwt(es[0], algs.ES256, claims))
    add("no-kid-outsider", jt.sign_jwt(outsider, algs.RS256, claims))
    add("kid-of-other-family",
        jt.sign_jwt(es[0], algs.ES256, claims, kid="rs-0"))
    h_none = _b64(b'{"alg":"none"}') + "." + _b64(json.dumps(claims).encode())
    add("alg-none-unsigned", h_none + ".")
    add("alg-none-signed", h_none + "." + _b64(b"\x01" * 32))
    es_sig = _sig(good_es)
    add("r-zero", _with_sig(good_es, b"\0" * 32 + es_sig[32:]))
    add("s-zero", _with_sig(good_es, es_sig[:32] + b"\0" * 32))
    add("s-ge-n", _with_sig(good_es, es_sig[:32] + P256_N.to_bytes(32, "big")))
    add("s-ge-n", _with_sig(good_es, es_sig[:32] + b"\xff" * 32))
    add("r-ge-n", _with_sig(good_es, P256_N.to_bytes(32, "big") + es_sig[32:]))
    add("wrong-length", _with_sig(good_es, es_sig[:-1]))
    add("wrong-length", _with_sig(good_es, es_sig + b"\0"))
    add("wrong-length", _with_sig(good_rs, _sig(good_rs)[:-1]))
    rs_n = rs[0].public_key().public_numbers().n
    add("rs-s-ge-n", _with_sig(good_rs, rs_n.to_bytes(256, "big")))
    for alg, key, kid in ((algs.RS256, rs[0], "rs-0"),
                          (algs.ES256, es[1], "es-1")):
        hdr = {"alg": alg, "kid": kid}
        add("payload-array", _sign_raw(key, alg, hdr, b"[1, 2]"))
        add("payload-number", _sign_raw(key, alg, hdr, b"42"))
        add("payload-not-json", _sign_raw(key, alg, hdr, b"{nope"))
    add("crit", jt.sign_jwt(rs[0], algs.RS256, claims, kid="rs-0",
                            extra_headers={"crit": ["exp"]}))
    add("segments", "a.b")
    add("segments", "a.b.c.d")
    add("segments", "")
    add("bad-b64", "!!!." + good_rs.split(".", 1)[1])
    add("bad-b64", good_rs[:-2] + "*A")
    add("header-not-object", _b64(b"[1]") + ".e30." + _b64(b"x"))
    add("header-no-alg", _b64(b'{"kid":"rs-0"}') + ".e30." + _b64(b"x"))
    add("json-form", jt.to_json_form(cases[2][1]))
    add("json-form-unprotected-kid",
        jt.to_json_form(jt.sign_jwt(rs[1], algs.RS256, claims),
                        unprotected={"kid": "rs-1"}))
    for j in range(3):
        c = dict(claims, sub=f"p{j}")
        add("port-signed", tt.sign_jwt(p_rsa, algs.RS256, c,
                                       kid="port-rs", rng=rng))
        add("port-signed", tt.sign_jwt(p_ec, algs.ES256, c,
                                       kid="port-es", rng=rng))

    add("degenerate-doubling", deg_dbl)
    add("degenerate-inverse", deg_inv)

    labels = [c[0] for c in cases]
    tokens = [c[1] for c in cases]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        ref = TPUBatchKeySet(j_jwk.parse_jwks(doc)).verify_batch(tokens)
    port_ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
    port = port_ks.verify_batch(tokens)
    return labels, tokens, ref, port, port_ks


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return a == b
    return type(a).__name__ == type(b).__name__ and str(a) == str(b)


def test_verdicts_bit_equal(batch):
    labels, _, ref, port, _ = batch
    diff = [(lab, r, p) for lab, r, p in zip(labels, ref, port)
            if not _same(r, p)]
    assert not diff


def test_accepts_what_it_should(batch):
    labels, _, _, port, _ = batch
    for lab, out in zip(labels, port):
        accepted = isinstance(out, dict)
        should = lab.startswith(("valid", "no-kid", "port-signed",
                                 "unknown-kid-signer", "json-form",
                                 "degenerate-doubling"))
        should = should and lab != "no-kid-outsider"
        assert accepted == should, (lab, out)


@pytest.mark.parametrize("label,cls", [
    ("tampered", "InvalidSignatureError"),
    ("unknown-kid-outsider", "InvalidSignatureError"),
    ("kid-of-other-family", "InvalidSignatureError"),
    ("alg-none-unsigned", "TokenNotSignedError"),
    ("alg-none-signed", "InvalidSignatureError"),
    ("r-zero", "InvalidSignatureError"),
    ("s-ge-n", "InvalidSignatureError"),
    ("wrong-length", "InvalidSignatureError"),
    ("rs-s-ge-n", "InvalidSignatureError"),
    ("payload-array", "MalformedTokenError"),
    ("payload-not-json", "MalformedTokenError"),
    ("crit", "MalformedTokenError"),
    ("segments", "MalformedTokenError"),
    ("bad-b64", "MalformedTokenError"),
])
def test_rejection_classes(batch, label, cls):
    labels, _, ref, port, _ = batch
    outs = [(r, p) for lab, r, p in zip(labels, ref, port) if lab == label]
    assert outs
    for r, p in outs:
        assert type(p).__name__ == cls and _same(r, p)


def test_port_signed_tokens_verify_under_jax(batch):
    labels, _, ref, _, _ = batch
    got = [r for lab, r in zip(labels, ref) if lab == "port-signed"]
    assert len(got) == 6 and all(isinstance(r, dict) for r in got)
    assert sorted(r["sub"] for r in got) == sorted(
        f"p{j}" for j in range(3) for _ in range(2))


def test_degenerate_lanes_reverify_on_the_oracle(batch):
    """Exactly the two adversarial tokens raise the same-x flag; the
    oracle accepts the doubling case and rejects the inverse case, as
    the JAX keyset's oracle does."""
    labels, _, ref, port, port_ks = batch
    assert port_ks.deg_reverified == 2
    got = {lab: (r, p) for lab, r, p in zip(labels, ref, port)
           if lab.startswith("degenerate")}
    assert got["degenerate-doubling"][1]["sub"] == "deg-dbl"
    assert type(got["degenerate-inverse"][1]).__name__ == \
        "InvalidSignatureError"
    assert all(_same(r, p) for r, p in got.values())


def test_ps256_is_refused_per_token(monkeypatch):
    """PS256 and PS384 are on the packed path now: their tokens (and a
    PS256 header over an RS256 signature) get verdicts bit-equal to the
    JAX keyset's, beside an RS256 token (PS512:
    ``test_torch_keyset_config4.py``). (The name dates from when the
    keyset refused PS384; it is kept so the test's history stays
    one.)"""
    rng = random.Random(3)
    key = tt.generate_rsa_key(rng)
    doc = {"keys": [t_jwk.serialize_public_key(key.public_key(), kid="k")]}
    ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
    rs = tt.sign_jwt(key, algs.RS256, {"sub": "x"}, kid="k")
    h = _b64(b'{"alg":"PS256","kid":"k"}')
    tokens = [rs, tt.sign_jwt(key, algs.PS256, {"sub": "y"}, kid="k",
                              rng=rng),
              h + "." + rs.split(".", 1)[1]]
    good = tt.sign_jwt(key, algs.PS384, {"sub": "z"}, kid="k", rng=rng)
    bad = bytearray(_sig(good))
    bad[7] ^= 0x40
    tokens += [good, _with_sig(good, bytes(bad))]
    out = ks.verify_batch(tokens)
    monkeypatch.setenv("CAP_TPU_RNS", "1")
    ref = TPUBatchKeySet(j_jwk.parse_jwks(doc)).verify_batch(tokens)
    assert all(_same(r, p) for r, p in zip(ref, out))
    assert [o.get("sub") if isinstance(o, dict) else type(o).__name__
            for o in out] == ["x", "y", "InvalidSignatureError", "z",
                              "InvalidSignatureError"]
    assert not any(isinstance(o, UnsupportedAlgError) for o in out)


@pytest.mark.parametrize("alg,crv", [("ES384", "P-384"), ("ES512", "P-521")])
def test_es384_and_es512_are_refused_per_token(alg, crv):
    """ES384 and ES512 are on the packed path now: a JWKS holding a key
    on another curve builds that curve's table beside P-256's, and its
    token verifies beside the ES256 one. (The name dates from when the
    keyset refused them; it is kept so the test's history stays
    one.)"""
    rng = random.Random(4)
    p256, other = tt.generate_ec_key(rng), tt.generate_ec_key(rng, crv)
    ks = GPUBatchKeySet([t_jwk.JWK(p256.public_key(), kid="p256"),
                         t_jwk.JWK(other.public_key(), kid="other")],
                        device="cpu")
    out = ks.verify_batch([
        tt.sign_jwt(p256, algs.ES256, {"sub": "x"}, kid="p256", rng=rng),
        tt.sign_jwt(other, alg, {"sub": "y"}, kid="other", rng=rng)])
    assert out == [{"sub": "x"}, {"sub": "y"}]
    assert sorted(ks._ec_tables) == sorted(["P-256", crv])


def test_one_native_prep_call_and_no_python_parse(batch, monkeypatch):
    """A batch takes one ``cap_prepare_batch`` call: no token goes
    through the strict Python parser, a base64url decode, json.loads of
    its claims or a host hash (the packed path and the prep rejections;
    the claims parse natively)."""
    import hashlib as hl

    from cap_tpu_torch.jwt import gpu_keyset, jose
    from cap_tpu_torch.runtime import native_binding as nb

    labels, tokens, _, port, ks = batch
    keep = {"valid-rs", "valid-es", "tampered", "port-signed", "r-zero",
            "s-zero", "s-ge-n", "r-ge-n", "wrong-length", "rs-s-ge-n",
            "crit", "segments", "bad-b64", "header-not-object",
            "header-no-alg", "alg-none-unsigned", "alg-none-signed"}
    pick = [i for i, lab in enumerate(labels) if lab in keep]
    calls = []

    def refuse(name):
        def f(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} called on the batch path")
        return f

    for mod, name in ((jose, "parse_jws"), (jose, "parse_compact"),
                      (jose, "b64url_decode"), (gpu_keyset, "parse_jws"),
                      (nb, "_loads_claims"), (hl, "new"), (hl, "sha256"),
                      (hl, "sha384"), (hl, "sha512")):
        monkeypatch.setattr(mod, name, refuse(name))
    before = nb.prepare_calls
    out = ks.verify_batch([tokens[i] for i in pick])
    monkeypatch.undo()
    assert nb.prepare_calls - before == 1 and not calls
    assert all(_same(o, port[i]) for o, i in zip(out, pick))
    assert sum(isinstance(o, dict) for o in out) == 18


@pytest.mark.parametrize("how", ["missing", "fails"])
def test_a_failed_host_build_raises(tmp_path, monkeypatch, how):
    """The batch prep has no Python fallback: with no g++ on the PATH,
    or a source that does not compile, into an empty build directory,
    ``verify_batch`` raises and builds nothing."""
    from cap_tpu_torch import _build
    from cap_tpu_torch.runtime import native_binding as nb

    rng = random.Random(6)
    key = tt.generate_ec_key(rng)
    ks = GPUBatchKeySet([t_jwk.JWK(key.public_key(), kid="k")],
                        device="cpu")
    token = tt.sign_jwt(key, algs.ES256, {"sub": "x"}, kid="k", rng=rng)
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(nb, "_LIB", None)
    if how == "missing":
        monkeypatch.setenv("PATH", str(tmp_path))
        match = "g\\+\\+ not found"
    else:
        src = tmp_path / "src"
        src.mkdir()
        for f in ("jose_native.cpp", "claims_ext.cpp", "claims_tape.h"):
            (src / f).write_text("this is not C++\n")
        monkeypatch.setattr(_build, "HOST_SRC", src)
        match = "the build failed for jose"
    with pytest.raises(RuntimeError, match=match):
        ks.verify_batch([token])
    assert not list(build.glob("*.so"))


def test_entries_not_str_or_not_ascii_as_the_jax_keyset():
    """A non-ASCII character is a byte no segment accepts: its token is
    rejected, with the JAX keyset's class and message. An entry that
    is not a str raises TypeError for the whole batch, in both keysets
    (the JAX keyset's join of the batch; ROADMAP §C)."""
    rng = random.Random(7)
    key = tt.generate_ec_key(rng)
    doc = {"keys": [t_jwk.serialize_public_key(key.public_key(), kid="k")]}
    good = tt.sign_jwt(key, algs.ES256, {"sub": "x"}, kid="k", rng=rng)
    h, p, s = good.split(".")
    tokens = [f"{h}.{p}.{s}é", f"é{h}.{p}.{s}", f"{h}.{p}☃.{s}",
              f"{h}.{p}.{s[:-1]}\U0001f600", "é", "é.é.é",
              f"{h}.é.{p}.{s}",
              json.dumps({"protected": h, "payload": p + "é",
                          "signature": s})]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        jks = TPUBatchKeySet(j_jwk.parse_jwks(doc))
    tks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
    ref, port = jks.verify_batch(tokens), tks.verify_batch(tokens)
    assert all(isinstance(r, Exception) for r in ref)
    assert [(type(r).__name__, str(r)) for r in ref] == \
        [(type(p).__name__, str(p)) for p in port]
    for bad in ([good, None], [good.encode()], [7, good]):
        with pytest.raises(TypeError):
            jks.verify_batch(bad)
        with pytest.raises(TypeError):
            tks.verify_batch(bad)
