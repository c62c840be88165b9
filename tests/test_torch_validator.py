"""The port's ``Validator``/``Expected`` against the JAX package's, live:
every case of ``tests/test_validator.py`` through both packages on the
same keys (made by ``cap_tpu.testing``, carried across by
``serialize_public_key`` → ``parse_jwk``) with equal class and message,
or equal claims; then ``validate_batch`` over ``GPUBatchKeySet`` (plain
path on the CPU) against ``validate_batch`` over ``TPUBatchKeySet`` on
a mixed RS256 + ES256 batch holding every claims rejection class and an
x5c-only key, verdicts bit-equal."""

import base64
import json
import time

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu import testing as captest  # noqa: E402
from cap_tpu.jwt import Expected as JExpected  # noqa: E402
from cap_tpu.jwt import StaticKeySet as JStaticKeySet  # noqa: E402
from cap_tpu.jwt import Validator as JValidator  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt import validator as j_validator  # noqa: E402
from cap_tpu.jwt.keyset import KeySet as JKeySet  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402

from cap_tpu_torch.jwt import (  # noqa: E402
    DEFAULT_LEEWAY_SECONDS,
    Expected,
    GPUBatchKeySet,
    StaticKeySet,
    Validator,
)
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt import validator as t_validator  # noqa: E402
from cap_tpu_torch.jwt.keyset import KeySet  # noqa: E402

NOW = 1_700_000_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rs_keys():
    return captest.generate_keys("RS256")


@pytest.fixture(scope="module")
def es_keys():
    return captest.generate_keys("ES256")


def _port_key(pub):
    return t_jwk.parse_jwk(j_jwk.serialize_public_key(pub)).key


def _claims(**kw):
    base = {"iss": "https://issuer/", "sub": "alice", "aud": ["aud1"],
            "iat": int(NOW) - 10, "nbf": int(NOW) - 10, "exp": int(NOW) + 300}
    base.update(kw)
    return {k: v for k, v in base.items() if v is not None}


def _outcome(fn):
    try:
        return "claims", fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


def both(pub, token, **kw):
    """One token through both Validators over a one-key StaticKeySet;
    asserts equal outcomes and returns the outcome."""
    kw.setdefault("now", lambda: NOW)
    want = _outcome(lambda: JValidator(JStaticKeySet([pub])).validate(
        token, JExpected(**kw)))
    got = _outcome(lambda: Validator(StaticKeySet([_port_key(pub)]))
                   .validate(token, Expected(**kw)))
    assert got == want
    return got


def test_requires_keyset():
    outs = [_outcome(lambda: v(None)) for v in (JValidator, Validator)]
    assert outs[0] == outs[1] == ("NilParameterError",
                                  "keySet must not be None")


def test_constants_as_the_jax_package():
    assert DEFAULT_LEEWAY_SECONDS == j_validator.DEFAULT_LEEWAY_SECONDS
    assert (t_validator.DEFAULT_CLOCK_SKEW_SECONDS
            == j_validator.DEFAULT_CLOCK_SKEW_SECONDS)


def test_valid_roundtrip(rs_keys):
    priv, pub = rs_keys
    token = captest.sign_jwt(priv, "RS256", _claims())
    got = both(pub, token, issuer="https://issuer/", subject="alice",
               audiences=["aud1"], signing_algorithms=["RS256"])
    assert got[0] == "claims" and got[1]["sub"] == "alice"


def test_default_alg_is_rs256(rs_keys, es_keys):
    assert both(rs_keys[1], captest.sign_jwt(rs_keys[0], "RS256",
                                             _claims()))[0] == "claims"
    es_token = captest.sign_jwt(es_keys[0], "ES256", _claims())
    assert both(es_keys[1], es_token)[0] == "UnsupportedAlgError"


@pytest.mark.parametrize("algs", [["ES256"], ["none"], ["RS256", "ES256"],
                                  ["PS256", "RS384"]])
def test_unexpected_alg_rejected(rs_keys, algs):
    priv, pub = rs_keys
    token = captest.sign_jwt(priv, "RS256", _claims())
    both(pub, token, signing_algorithms=algs)


def test_bad_signature_rejected(rs_keys):
    priv, pub = rs_keys
    token = captest.sign_jwt(priv, "RS256", _claims())
    assert both(pub, token[:-6] + "AAAAAA")[0] == "InvalidSignatureError"


@pytest.mark.parametrize("kw", [dict(issuer="https://issuer/", id="id-1"),
                                dict(issuer="https://other/"),
                                dict(subject="bob"), dict(id="id-2")])
def test_wrong_issuer_subject_jti(rs_keys, kw):
    priv, pub = rs_keys
    both(pub, captest.sign_jwt(priv, "RS256", _claims(jti="id-1")), **kw)


@pytest.mark.parametrize("aud,expected", [
    (["a", "b"], ["b", "z"]), (["a", "b"], ["z"]), ("solo", ["solo"]),
    ("solo", ["other"]), (5, ["x"]), ([1], ["x"]), (None, ["x"]),
    (None, [])])
def test_audience_matching(rs_keys, aud, expected):
    priv, pub = rs_keys
    both(pub, captest.sign_jwt(priv, "RS256", _claims(aud=aud)),
         audiences=expected)


def test_validate_audience_empty_expected_skips():
    for v in (j_validator, t_validator):
        v.validate_audience([], ["anything"])
        v.validate_audience([], [])
    assert t_validator.audience_claim({"aud": "x"}) == ["x"]


@pytest.mark.parametrize("claims,kw", [
    (dict(exp=int(NOW) - 3600), {}),                        # expired
    (dict(exp=int(NOW) - 30), {}),                          # within skew
    (dict(exp=int(NOW) - 30), dict(clock_skew_leeway=-1)),
    (dict(nbf=int(NOW) + 3600), {}),                        # not yet valid
    (dict(iat=int(NOW) + 3600, nbf=int(NOW) - 10), {}),     # future iat
    (dict(iat=None, nbf=None, exp=None), {}),               # no time claims
    (dict(iat=int(NOW) - 100, nbf=None, exp=None), {}),
    (dict(iat=int(NOW) - 100, nbf=None, exp=None),
     dict(expiration_leeway=-1)),
    (dict(iat=None, nbf=None, exp=int(NOW) + 400), {}),
    (dict(iat=None, nbf=None, exp=int(NOW) + 400),
     dict(not_before_leeway=500)),
    (dict(iat="soon"), {}), (dict(exp=True), {}), (dict(iss=7),
                                                   dict(issuer="x")),
    (dict(nbf=int(NOW) + 30), dict(clock_skew_leeway=0)),
    (dict(nbf=int(NOW) + 30), dict(clock_skew_leeway=10.5)),
])
def test_time_claims(rs_keys, claims, kw):
    priv, pub = rs_keys
    both(pub, captest.sign_jwt(priv, "RS256", _claims(**claims)), **kw)


def test_real_time_default_now(rs_keys):
    priv, pub = rs_keys
    t = time.time()
    token = captest.sign_jwt(priv, "RS256", {
        "iss": "i", "iat": int(t), "nbf": int(t), "exp": int(t) + 60})
    out = _outcome(lambda: Validator(StaticKeySet([_port_key(pub)]))
                   .validate(token, Expected()))
    assert out == _outcome(lambda: JValidator(JStaticKeySet([pub]))
                           .validate(token, JExpected()))
    assert out[0] == "claims"


def test_validate_batch_mixed(rs_keys):
    priv, pub = rs_keys
    good = captest.sign_jwt(priv, "RS256", _claims())
    expired = captest.sign_jwt(priv, "RS256", _claims(exp=int(NOW) - 3600))
    tokens = [good, expired, good[:-6] + "AAAAAA", "a.b", good]
    want = JValidator(JStaticKeySet([pub])).validate_batch(
        tokens, JExpected(now=lambda: NOW))
    got = Validator(StaticKeySet([_port_key(pub)])).validate_batch(
        tokens, Expected(now=lambda: NOW))
    assert [_same_key(g) for g in got] == [_same_key(w) for w in want]
    assert got[0]["sub"] == "alice"


def _same_key(v):
    return v if isinstance(v, dict) else (type(v).__name__, str(v))


def test_non_cap_errors_are_wrapped():
    """A keyset's non-CapError becomes InvalidSignatureError, on both the
    single and the batch path."""
    def keyset(base):
        class Raising(base):
            def verify_signature(self, token):
                raise ValueError("boom")
        return Raising()

    tok = captest.sign_jwt(captest.generate_keys("ES256")[0], "ES256",
                           _claims())
    outs = []
    for ks, v, e in ((keyset(JKeySet), JValidator, JExpected),
                     (keyset(KeySet), Validator, Expected)):
        outs.append((_outcome(lambda: v(ks).validate(tok, e())),
                     [_same_key(r) for r in v(ks).validate_batch([tok],
                                                                 e())]))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# validate_batch over the batched keysets
# ---------------------------------------------------------------------------

def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


@pytest.fixture(scope="module")
def batch():
    """One JWKS document (2 RSA, 2 P-256 and one x5c-only P-256 key) and
    one batch with every claims rejection class, through
    ``validate_batch`` over both batched keysets."""
    rs = [captest.generate_keys("RS256")[0] for _ in range(2)]
    es = [captest.generate_keys("ES256")[0] for _ in range(3)]
    doc = {"keys": (
        [j_jwk.serialize_public_key(k.public_key(), kid=f"rs-{i}")
         for i, k in enumerate(rs)]
        + [j_jwk.serialize_public_key(k.public_key(), kid=f"es-{i}")
           for i, k in enumerate(es[:2])]
        + [captest.x5c_jwk(es[2], es[2].public_key(), kid="x5c-es")])}
    assert "x" not in doc["keys"][-1]
    now = 1_700_000_000
    base = captest.default_claims(now=now)
    signers = [(rs[0], "RS256", "rs-0"), (rs[1], "RS256", "rs-1"),
               (es[0], "ES256", "es-0"), (es[1], "ES256", "es-1"),
               (es[2], "ES256", "x5c-es")]
    variants = {
        "valid": {}, "expired": dict(exp=now - 3600),
        "not-yet-valid": dict(nbf=now + 7200),
        "issued-in-future": dict(iat=now + 7200, nbf=now - 10),
        "no-time-claims": dict(iat=None, nbf=None, exp=None),
        "wrong-iss": dict(iss="https://evil.example/"),
        "wrong-aud": dict(aud=["someone-else"]),
        "aud-not-string": dict(aud=[7]), "aud-number": dict(aud=7),
        "iss-not-string": dict(iss=["x"]), "exp-not-number": dict(exp="x"),
        "string-aud": dict(aud="client-id"),
    }
    tokens, labels = [], []
    for label, change in variants.items():
        for priv, alg, kid in signers:
            c = {k: v for k, v in dict(base, **change).items()
                 if v is not None}
            tokens.append(captest.sign_jwt(priv, alg, c, kid=kid))
            labels.append(label)
    good = tokens[0]
    tokens += [good[:-6] + "AAAAAA", "a.b", "",
               _b64(b'{"alg":"none"}') + "." + _b64(json.dumps(base)
                                                    .encode()) + ".",
               captest.sign_jwt(es[0], "ES256", base),       # no kid
               captest.sign_jwt(rs[0], "RS256", base, kid="nope")]
    labels += ["tampered", "malformed", "malformed", "unsigned", "no-kid",
               "unknown-kid"]
    expected = dict(issuer="https://example.com/", audiences=["client-id"],
                    signing_algorithms=["RS256", "ES256"],
                    now=lambda: now + 100)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        jv = JValidator(TPUBatchKeySet(j_jwk.parse_jwks(doc)))
        ref = [jv.validate_batch(tokens, JExpected(**expected)),
               jv.validate_batch(tokens, JExpected(
                   **dict(expected, signing_algorithms=["RS256"])))]
    tv = Validator(GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu"))
    port = [tv.validate_batch(tokens, Expected(**expected)),
            tv.validate_batch(tokens, Expected(
                **dict(expected, signing_algorithms=["RS256"])))]
    single = [_outcome(lambda: tv.validate(t, Expected(**expected)))
              for t in tokens]
    return labels, tokens, ref, port, single


@pytest.mark.parametrize("run", [0, 1], ids=["RS256+ES256", "RS256-only"])
def test_validate_batch_bit_equal_to_the_jax_keyset(batch, run):
    labels, tokens, ref, port, _ = batch
    diff = [(labels[i], _same_key(p), _same_key(r))
            for i, (p, r) in enumerate(zip(port[run], ref[run]))
            if _same_key(p) != _same_key(r)]
    assert not diff, diff[:5]


def test_validate_batch_covers_every_class(batch):
    labels, tokens, ref, port, single = batch
    classes = {lab: type(p).__name__ for lab, p in zip(labels, port[0])}
    assert classes["valid"] == classes["string-aud"] == "dict"
    assert classes["expired"] == "ExpiredTokenError"
    assert classes["not-yet-valid"] == "InvalidNotBeforeError"
    assert classes["issued-in-future"] == "InvalidIssuedAtError"
    assert classes["no-time-claims"] == "MissingClaimError"
    assert classes["wrong-iss"] == "InvalidIssuerError"
    assert classes["wrong-aud"] == "InvalidAudienceError"
    assert classes["aud-not-string"] == "MalformedTokenError"
    assert classes["tampered"] == "InvalidSignatureError"
    es_only = [type(p).__name__ for p, t in zip(port[1], tokens)
               if t.startswith(_b64(b'{"alg":"ES256"'))]
    assert es_only and set(es_only) == {"UnsupportedAlgError"}
    # the batch path gives what the single path gives (but for the
    # words of a parse failure, which are the native prep's on the batch
    # path, in both packages)
    assert [_same_key(p) for p, lab in zip(port[0], labels)
            if lab != "malformed"] == [
        s[1] if s[0] == "claims" else s
        for s, lab in zip(single, labels) if lab != "malformed"]
