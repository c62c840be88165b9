"""``verify_id_token_batch`` in dict and raw modes over the card's
keyset, against the JAX package's over its own, live: the port's
``Provider`` over ``GPUBatchKeySet(device="cpu")`` (the kernels' plain
versions) against the JAX ``Provider`` over ``TPUBatchKeySet`` on a
few hundred ES256 tokens signed by two seeded P-256 keys. They carry
the vectors of ``tests/test_oidc_raw_batch.py``, payloads that are not
objects, JSON-form tokens (one that has no compact form), and tokens
of the trial path. ``GPUBatchKeySet.verify_batch_raw`` is held to
``TPUBatchKeySet.verify_batch_raw`` the same way: payload bytes for
accepted tokens, the same class and message for the rest."""

import base64
import hashlib
import json
import random

import pytest
import torch

from cap_tpu.jwt import jwk as j_jwk
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet
from cap_tpu.oidc import Config as JConfig
from cap_tpu.oidc import Provider as JProvider
from cap_tpu.oidc import Request as JRequest

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu.ec import curve, host_ecdsa_sign
from cap_tpu_torch.jwt import GPUBatchKeySet
from cap_tpu_torch.jwt import jwk as t_jwk
from cap_tpu_torch.oidc import Config, Provider, Request
from cap_tpu_torch.oidc import claims_native

ISSUER = "https://idp.example/"
CLIENT = "client-1"
NONCE = "n-batch"
NOW = 1_750_000_000.0
N_GOOD = 224


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_the_rns_engine():
    """One torch thread; the JAX keyset on its RNS engine (the one the
    port runs; on the CPU it compiles in about half the limb engine's
    time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        yield
    torch.set_num_threads(n)


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _sign_bytes(priv, header: dict, payload: bytes, rng) -> str:
    """An ES256 token over arbitrary payload bytes."""
    si = _b64(json.dumps(header).encode()) + "." + _b64(payload)
    e = int.from_bytes(hashlib.sha256(si.encode()).digest(), "big")
    r, s = host_ecdsa_sign("P-256", priv.d, e,
                           rng.randrange(1, curve("P-256").n))
    return si + "." + _b64(r.to_bytes(32, "big") + s.to_bytes(32, "big"))


def _claims(**over):
    c = {"iss": ISSUER, "sub": "alice", "aud": [CLIENT],
         "iat": int(NOW) - 10, "nbf": int(NOW) - 10,
         "exp": int(NOW) + 3600, "nonce": NONCE}
    c.update(over)
    return c


@pytest.fixture(scope="module")
def rig():
    rng = random.Random(1313)
    keys = [tt.generate_ec_key(rng) for _ in range(2)]
    doc = {"keys": [t_jwk.serialize_public_key(k.public_key(),
                                               kid=f"es-{i}")
                    for i, k in enumerate(keys)]}

    def sign(claims, kid="es-0", key=0, **kw):
        return tt.sign_jwt(keys[key], "ES256", claims, kid=kid, rng=rng, **kw)

    good = sign(_claims())
    vectors = [
        ("good", good),
        ("expired", sign(_claims(exp=1000))),
        ("future-nbf", sign(_claims(nbf=2 ** 33))),
        ("future-iat", sign(_claims(iat=2 ** 33))),
        ("no-exp", sign({k: v for k, v in _claims().items() if k != "exp"})),
        ("wrong-nonce", sign(_claims(nonce="nope"))),
        ("wrong-aud", sign(_claims(aud=["other"]))),
        ("aud-string", sign(_claims(aud=CLIENT))),
        ("multi-aud-azp", sign(_claims(aud=[CLIENT, "x"], azp=CLIENT))),
        ("multi-aud-bad-azp", sign(_claims(aud=[CLIENT, "x"],
                                           azp="intruder"))),
        ("multi-aud-no-client", sign(_claims(aud=["x", "y"]))),
        ("multi-aud-non-string", sign(_claims(aud=[CLIENT, 42]))),
        ("aud-object-fallback", sign(_claims(aud={"weird": 1}))),
        ("exp-bool-fallback", sign(_claims(exp=True))),
        ("escaped-key-fallback", _sign_bytes(
            keys[0], {"alg": "ES256", "kid": "es-0"},
            json.dumps(_claims()).replace('"iss"', '"i\\u0073s"').encode(),
            rng)),
        ("wrong-issuer", sign(_claims(iss="https://evil.example/"))),
        ("tampered", good[:-6] + ("AAAAAA" if not good.endswith("AAAAAA")
                                  else "BBBBBB")),
        ("not-a-jwt", "garbage"),
        ("alg-none", _b64(b'{"alg":"none"}') + "." + _b64(b"{}") + "."),
        ("payload-array", _sign_bytes(keys[1], {"alg": "ES256",
                                                "kid": "es-1"}, b"[1, 2]",
                                      rng)),
        ("payload-not-json", _sign_bytes(keys[1], {"alg": "ES256",
                                                   "kid": "es-1"}, b"{nope",
                                         rng)),
        ("payload-bom", _sign_bytes(keys[0], {"alg": "ES256", "kid": "es-0"},
                                    b"\xef\xbb\xbf" + json.dumps(
                                        _claims()).encode(), rng)),
        ("no-kid-trial", sign(_claims(sub="trial"), kid=None, key=1)),
        ("unknown-kid-trial", sign(_claims(sub="trial2"), kid="nope")),
        ("json-form", tt_json_form(sign(_claims(sub="json")))),
        ("json-form-unprotected-kid", _unprotected_kid(
            sign(_claims(sub="unprot"), kid=None, key=1), "es-1")),
        ("json-form-two-signatures", _two_signatures(
            sign(_claims(sub="two")), sign(_claims(sub="two"), kid="es-1",
                                           key=1))),
    ]
    for j in range(N_GOOD):
        vectors.append(("good-tiled", sign(_claims(sub=f"u{j}"),
                                           kid=f"es-{j % 2}", key=j % 2)))
    names, toks = zip(*vectors)
    toks = list(toks)

    j_ks = TPUBatchKeySet(j_jwk.parse_jwks(doc))
    t_ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
    common = dict(issuer=ISSUER, client_id=CLIENT,
                  supported_signing_algs=["ES256"])
    jp = JProvider(JConfig(now_func=lambda: NOW, **common), keyset=j_ks,
                   discovery_doc={"issuer": ISSUER})
    tp = Provider(Config(now_func=lambda: NOW, **common), keyset=t_ks,
                  discovery_doc={"issuer": ISSUER})
    req_kw = dict(nonce=NONCE, now_func=lambda: NOW)
    return dict(names=list(names), toks=toks, j_ks=j_ks, t_ks=t_ks,
                jp=jp, tp=tp,
                jreq=JRequest(3600.0, "http://127.0.0.1:1/cb", **req_kw),
                treq=Request(3600.0, "http://127.0.0.1:1/cb", **req_kw))


def tt_json_form(token):
    h, p, s = token.split(".")
    return json.dumps({"payload": p, "protected": h, "signature": s})


def _unprotected_kid(token, kid):
    """The flattened JSON form with the kid in the unprotected header:
    no compact form keeps its key selection, so both keysets verify it
    on the object path."""
    h, p, s = token.split(".")
    return json.dumps({"payload": p, "protected": h, "header": {"kid": kid},
                       "signature": s})


def _two_signatures(a, b):
    """The general JSON form with two signatures: refused by both."""
    ha, p, sa = a.split(".")
    hb, _, sb = b.split(".")
    return json.dumps({"payload": p, "signatures": [
        {"protected": ha, "signature": sa},
        {"protected": hb, "signature": sb}]})


def _verdict(v):
    if isinstance(v, Exception):
        return (type(v).__name__, str(v))
    return v


def test_keyset_raw_equals_the_jax_keyset(rig):
    """verify_batch_raw: the JAX keyset's bytes and errors; its accepted
    bytes are exactly what verify_batch parses into its dicts."""
    want = rig["j_ks"].verify_batch_raw(rig["toks"])
    got = rig["t_ks"].verify_batch_raw(rig["toks"])
    assert [_verdict(v) for v in got] == [_verdict(v) for v in want]
    dicts = rig["t_ks"].verify_batch(rig["toks"])
    by_name = {}
    for name, g, d in zip(rig["names"], got, dicts):
        assert isinstance(g, bytes) == isinstance(d, dict), name
        if isinstance(g, bytes):
            assert json.loads(g) == d
        else:
            assert _verdict(g) == _verdict(d), name
        by_name.setdefault(name, g)
    for name in ("json-form", "json-form-unprotected-kid", "no-kid-trial",
                 "unknown-kid-trial", "payload-bom", "good"):
        assert isinstance(by_name[name], bytes), name
    for name in ("payload-array", "payload-not-json",
                 "json-form-two-signatures"):
        assert type(by_name[name]).__name__ == "MalformedTokenError"


@pytest.mark.parametrize("raw", [False, True])
def test_provider_batch_equals_the_jax_provider(rig, raw, monkeypatch):
    """verify_id_token_batch: every verdict of the port Provider over
    GPUBatchKeySet equal to the JAX Provider's over TPUBatchKeySet
    (class and message), and, in raw mode, the port's counters equal
    to the JAX package's telemetry counters."""
    from cap_tpu import telemetry as j_telemetry

    monkeypatch.setenv("CAP_OIDC_NATIVE", "1")
    rec = j_telemetry.enable()
    rec.reset()
    try:
        want = rig["jp"].verify_id_token_batch(rig["toks"], rig["jreq"],
                                               raw=raw)
        counts = rec.counters()
    finally:
        j_telemetry.disable()
    claims_native.reset_counts()
    got = rig["tp"].verify_id_token_batch(rig["toks"], rig["treq"], raw=raw)
    bad = [(n, _verdict(w), _verdict(g)) for n, w, g in
           zip(rig["names"], want, got) if _verdict(w) != _verdict(g)]
    assert not bad, bad[:4]
    n_ok = sum(not isinstance(g, Exception) for g in got)
    assert n_ok >= N_GOOD
    if raw:
        assert all(isinstance(g, bytes) for g in got
                   if not isinstance(g, Exception))
        assert (claims_native.native_validated,
                claims_native.native_fallbacks) == (
            counts["oidc.native_validated"], counts["oidc.native_fallbacks"])
        assert claims_native.native_fallbacks >= 3
    else:
        assert claims_native.native_validated == \
            claims_native.native_fallbacks == 0


def test_raw_and_dict_modes_agree(rig):
    """Per token: the same class in both modes; the raw bytes parse to
    the dict mode's claims."""
    d = rig["tp"].verify_id_token_batch(rig["toks"], rig["treq"])
    r = rig["tp"].verify_id_token_batch(rig["toks"], rig["treq"], raw=True)
    for name, a, b in zip(rig["names"], d, r):
        if isinstance(a, dict):
            assert isinstance(b, bytes) and json.loads(b) == a, name
        else:
            assert type(a) is type(b), name


def test_raw_mode_needs_verify_batch_raw(rig):
    from cap_tpu_torch.errors import InvalidParameterError
    from cap_tpu_torch.jwt import StaticKeySet

    p = Provider(rig["tp"].config, keyset=StaticKeySet(
        [j.key for j in rig["t_ks"]._jwks]), discovery_doc={"issuer": ISSUER})
    with pytest.raises(InvalidParameterError, match="raw"):
        p.verify_id_token_batch(["x.y.z"], rig["treq"], raw=True)
