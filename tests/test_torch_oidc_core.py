"""The port's OIDC core (``pkce``, ``id``, ``request``, ``token``,
``id_token``, ``config``, and the ``redact``, ``base62`` and
``strutils`` helpers) against the JAX package's, live: the same inputs
through both, with equal outputs, or equal exception classes and
messages. Pins the reference's bare ``KeyError`` on the at_hash/c_hash
check of an ML-DSA or SLH-DSA token, which the port keeps."""

import base64
import hashlib
import json
import random

import pytest

import cap_tpu.oidc as j_oidc
from cap_tpu.oidc import config as j_config
from cap_tpu.oidc import id as j_id
from cap_tpu.oidc import pkce as j_pkce
from cap_tpu.utils import base62 as j_base62
from cap_tpu.utils import redact as j_redact
from cap_tpu.utils import strutils as j_strutils

import cap_tpu_torch.oidc as t_oidc
from cap_tpu_torch import testing as tt
from cap_tpu_torch.jwt import x509 as t_x509
from cap_tpu_torch.oidc import config as t_config
from cap_tpu_torch.oidc import id as t_id
from cap_tpu_torch.oidc import pkce as t_pkce
from cap_tpu_torch.utils import base62 as t_base62
from cap_tpu_torch.utils import redact as t_redact
from cap_tpu_torch.utils import strutils as t_strutils

SIDES = {"jax": (j_oidc, j_pkce, j_config, j_id),
         "port": (t_oidc, t_pkce, t_config, t_id)}
NOW = 1_700_000_000.0


def _outcome(fn):
    """fn()'s value, or its exception as (class name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__, str(e))


def _both(fn):
    """fn(side modules) on both packages; the two outcomes, equal."""
    out = {name: _outcome(lambda m=mods: fn(*m))
           for name, mods in SIDES.items()}
    assert out["jax"] == out["port"], out
    return out["port"]


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _token(alg: str, claims) -> str:
    """A compact token with any alg: IDToken never checks signatures."""
    return (_b64(json.dumps({"alg": alg, "typ": "JWT"}).encode()) + "."
            + _b64(json.dumps(claims).encode()) + "." + _b64(b"sig"))


def _half(hash_name: str, value: str) -> str:
    d = hashlib.new(hash_name, value.encode()).digest()
    return _b64(d[: len(d) // 2])


# -- redact, base62, strutils, id --------------------------------------------

def test_redacted_string_renders_alike():
    for cls_j, cls_t in ((j_redact.RedactedString, t_redact.RedactedString),
                         (j_config.ClientSecret, t_config.ClientSecret),
                         (j_oidc.IDToken, t_oidc.IDToken),
                         (j_oidc.AccessToken, t_oidc.AccessToken),
                         (j_oidc.RefreshToken, t_oidc.RefreshToken)):
        for raw in ("super-secret", ""):
            a, b = cls_j(raw), cls_t(raw)
            assert (str(a), repr(a), f"{a:>30}", a.to_json(), a.reveal(),
                    bool(a), hash(a), a == raw, a + "!") == \
                (str(b), repr(b), f"{b:>30}", b.to_json(), b.reveal(),
                 bool(b), hash(b), b == raw, b + "!")
            assert raw not in str(b) or not raw
            assert (a == b) and (b == a)


def test_base62_and_strutils():
    assert t_base62.CHARSET == j_base62.CHARSET
    s = t_base62.random_base62(200)
    assert len(s) == 200 and set(s) <= set(t_base62.CHARSET)
    with pytest.raises(ValueError, match="non-negative"):
        t_base62.random_base62(-1)
    for items, cs in ((["a", " A", "b", "", "  ", "a "], False),
                      (["a", " A", "b", "", "  ", "a "], True),
                      (["none", "NONE", " login "], False), ([], True)):
        assert t_strutils.remove_duplicates_stable(items, cs) == \
            j_strutils.remove_duplicates_stable(items, cs)
    assert t_strutils.str_list_contains(["x", "y"], "y")


@pytest.mark.parametrize("prefix,length", [("", 20), ("st", 20), ("n", 5),
                                           ("x", 0), ("", -3)])
def test_new_id(prefix, length):
    out = _both(lambda o, p, c, i: (lambda v: (len(v), v.split("_")[0]
                                               if prefix else None))(
        i.new_id(prefix=prefix, length=length)))
    if length > 0:
        assert out[1][0] == length + (len(prefix) + 1 if prefix else 0)
    assert t_id.DEFAULT_ID_LENGTH == j_id.DEFAULT_ID_LENGTH


# -- PKCE -------------------------------------------------------------------

@pytest.mark.parametrize("verifier", ["a" * 43, "Zz9" * 20, "q" * 128,
                                      "a" * 42, "b" * 129, None])
def test_s256_verifier(verifier):
    if verifier is None:
        v = t_pkce.S256Verifier()
        assert len(v.verifier()) == 43
        assert v.challenge() == j_pkce.S256Verifier(v.verifier()).challenge()
        return
    out = _both(lambda o, p, c, i: (
        lambda v: (v.verifier(), v.challenge(), v.method(),
                   v.copy().challenge(), repr(v),
                   p.create_code_challenge(v)))(p.S256Verifier(verifier)))
    if out[0] == "ok":
        assert out[1][1] == _b64(hashlib.sha256(verifier.encode()).digest())


@pytest.mark.parametrize("method", ["S256", "plain"])
def test_create_code_challenge_by_method(method):
    def run(o, p, c, i):
        class Custom(p.CodeVerifier):
            def verifier(self):
                return "v" * 50

            def method(self):
                return method

        return p.create_code_challenge(Custom())

    _both(run)


# -- Request ------------------------------------------------------------------

REQUEST_CASES = {
    "defaults": dict(state="st_1", nonce="n_1"),
    "every option": dict(
        state="st_2", nonce="n_2", scopes=["email", "profile"],
        audiences=["aud-1", "aud-2"], max_age=30,
        prompts=["login", "consent"], display="page",
        ui_locales=["en-US", "fr"], claims={"id_token": {"email": None}},
        acr_values=["phr", "phrh"]),
    "pkce": dict(state="st_3", nonce="n_3", pkce="v" * 43),
    "implicit": dict(state="st_4", nonce="n_4", implicit_flow=True),
    "implicit + access token": dict(state="st_5", nonce="n_5",
                                    implicit_access_token=True),
    "claims as text": dict(state="s", nonce="n", claims='{"a": 1}'),
    "claims as bytes": dict(state="s", nonce="n", claims=b'{"b": [2]}'),
    "max_age 0": dict(state="s", nonce="n", max_age=0),
    "generated state and nonce": dict(),
    "bad: expires_in 0": dict(expires_in=0),
    "bad: redirect empty": dict(redirect=""),
    "bad: state empty": dict(state=""),
    "bad: nonce empty": dict(nonce=""),
    "bad: state == nonce": dict(state="same", nonce="same"),
    "bad: implicit + pkce": dict(implicit_flow=True, pkce="v" * 43),
    "bad: max_age < 0": dict(max_age=-1),
    "bad: claims not JSON": dict(claims="{not json"),
}


@pytest.mark.parametrize("case", list(REQUEST_CASES))
def test_request(case):
    kw = dict(REQUEST_CASES[case])
    expires_in = kw.pop("expires_in", 60)
    redirect = kw.pop("redirect", "https://app/cb")
    pkce = kw.pop("pkce", None)

    def run(o, p, c, i):
        r = o.Request(expires_in, redirect, now_func=lambda: NOW,
                      pkce_verifier=p.S256Verifier(pkce) if pkce else None,
                      **kw)
        state, nonce = r.state(), r.nonce()
        if "state" not in kw:
            assert state.startswith("st_") and nonce.startswith("n_")
            state, nonce = "generated", "generated"
        v = r.pkce_verifier()
        scopes, auds = r.scopes(), r.audiences()
        scopes.append("mutated")
        auds.append("mutated")
        return (state, nonce, r.redirect_url(), r.scopes(), r.audiences(),
                r.implicit_flow(),
                (v.verifier(), v.challenge()) if v else None, r.max_age(),
                r.prompts(), r.display(), r.ui_locales(), r.claims(),
                r.acr_values(), r.expiration(), r.is_expired())

    _both(run)


def test_request_expiry_skew():
    t = [NOW]
    for o in (j_oidc, t_oidc):
        t[0] = NOW
        r = o.Request(10, "https://app/cb", now_func=lambda: t[0])
        t[0] = NOW + 11.0
        assert not r.is_expired()
        t[0] = NOW + 11.5
        assert r.is_expired()
    assert t_oidc.REQUEST_EXPIRY_SKEW == j_oidc.REQUEST_EXPIRY_SKEW


# -- Token ----------------------------------------------------------------------

TOKEN_CASES = {
    "valid": dict(access_token="at", expiry=NOW + 1000),
    "inside the skew": dict(access_token="at", expiry=NOW + 5),
    "zero expiry": dict(access_token="at", expiry=0.0),
    "no access token": dict(),
    "refresh": dict(access_token="at", refresh_token="rt", expiry=NOW - 1),
    "bad: empty id_token": dict(id_token=""),
}


@pytest.mark.parametrize("case", list(TOKEN_CASES))
def test_token(case):
    kw = dict(TOKEN_CASES[case])
    raw = kw.pop("id_token", _token("ES256", {"sub": "alice"}))

    def run(o, p, c, i):
        t = o.Token(raw, now_func=lambda: NOW, **kw)
        src = t.static_token_source()
        return (t.id_token().reveal(), t.access_token().reveal(),
                t.refresh_token().reveal(), t.expiry(), t.is_expired(),
                t.valid(), repr(t),
                src.token().reveal() if src is not None else None)

    _both(run)
    assert t_oidc.TOKEN_EXPIRY_SKEW == j_oidc.TOKEN_EXPIRY_SKEW


# -- IDToken ----------------------------------------------------------------------

@pytest.mark.parametrize("raw", [
    "", "a.b", "a.b.c.d", _token("ES256", {"sub": "x"}),
    _token("ES256", [1, 2]), "eyJhbGciOiJFUzI1NiJ9.!!!.c2ln",
    "eyJhbGciOiJFUzI1NiJ9." + _b64(b"{nope") + ".c2ln",
    "eyJhbGciOiJFUzI1NiJ9." + _b64(b"\xff\xfe") + ".c2ln",
])
def test_id_token_claims_and_alg(raw):
    _both(lambda o, p, c, i: o.IDToken(raw).claims())
    _both(lambda o, p, c, i: o.IDToken(raw).signing_alg())
    _both(lambda o, p, c, i: (str(o.IDToken(raw)), repr(o.IDToken(raw))))


HASH_ALGS = ["RS256", "ES384", "PS512", "ES512", "EdDSA", "ML-DSA-44",
             "SLH-DSA-SHAKE-128s", "HS256"]


@pytest.mark.parametrize("alg", HASH_ALGS)
@pytest.mark.parametrize("claim", ["at_hash", "c_hash"])
def test_hash_claims(alg, claim):
    """Every alg against a right, a wrong, an absent and a non-string
    claim, and an empty value: equal verdicts, classes and messages."""
    value = "the-value"
    hash_name = {"256": "sha256", "384": "sha384",
                 "512": "sha512"}.get(alg[-3:], "sha256")
    for claims, checked in (({claim: _half(hash_name, value)}, value),
                            ({claim: _half(hash_name, value)}, "other"),
                            ({}, value), ({claim: 7}, value),
                            ({claim: "x"}, "")):
        raw = _token(alg, dict(claims, sub="alice"))

        def run(o, p, c, i):
            t = o.IDToken(raw)
            if claim == "at_hash":
                return t.verify_access_token(o.AccessToken(checked))
            return t.verify_authorization_code(checked)

        out = _both(run)
        if alg in ("ML-DSA-44", "SLH-DSA-SHAKE-128s") and checked:
            # the reference's fault, kept: a bare KeyError on the
            # alg's last three characters
            assert out == ("raise", "KeyError", repr(alg[-3:])), out


def test_ml_dsa_at_hash_key_error_pinned():
    for alg, key in (("ML-DSA-44", "-44"), ("SLH-DSA-SHAKE-128s", "28s")):
        raw = _token(alg, {"at_hash": "x"})
        for o in (j_oidc, t_oidc):
            with pytest.raises(KeyError) as e:
                o.IDToken(raw).verify_access_token("abc")
            assert e.value.args == (key,)


# -- Config ----------------------------------------------------------------------

CONFIG_CASES = {
    "valid": dict(),
    "http issuer": dict(issuer="http://localhost:8080"),
    "every option": dict(scopes=["email"], audiences=["a", "b"],
                         allowed_redirect_urls=["https://a/cb",
                                                "http://localhost/cb"]),
    "bad: client id empty": dict(client_id=""),
    "bad: issuer empty": dict(issuer=""),
    "bad: ftp issuer": dict(issuer="ftp://x"),
    "bad: no algs": dict(supported_signing_algs=[]),
    "bad: alg none": dict(supported_signing_algs=["none"]),
    "bad: alg HS256": dict(supported_signing_algs=["HS256"]),
    "bad: redirect URL": dict(allowed_redirect_urls=["http://[::1"]),
    "bad: CA PEM": dict(provider_ca="-----BEGIN CERTIFICATE-----\nAAAA\n"
                                    "-----END CERTIFICATE-----\n"),
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_config(case):
    kw = dict(issuer="https://idp.example.com", client_id="client-id",
              client_secret="hush",
              supported_signing_algs=["RS256", "ML-DSA-65"],
              allowed_redirect_urls=["https://app/callback"])
    kw.update(CONFIG_CASES[case])

    def run(o, p, c, i):
        cfg = o.Config(now_func=lambda: NOW, **kw)
        return (cfg.issuer, cfg.client_id, str(cfg.client_secret),
                cfg.client_secret.reveal(), cfg.supported_signing_algs,
                cfg.allowed_redirect_urls, cfg.scopes, cfg.audiences,
                cfg.provider_ca, cfg.now(),
                type(cfg.client_secret).__name__)

    _both(run)


def test_config_provider_ca():
    pem, _, _ = tt.generate_ca("cap-config", random.Random(3))
    for o in (j_oidc, t_oidc):
        cfg = o.Config("https://idp", "c", supported_signing_algs=["ES256"],
                       provider_ca=pem)
        assert cfg.provider_ca == pem


def test_encode_certificates_as_cryptography():
    """The PEM text of DER bytes and of the port's certificate objects
    equals what the JAX package writes from ``cryptography`` objects."""
    x509 = pytest.importorskip("cryptography.x509")

    rng = random.Random(7)
    ders = [tt.certificate_der(tt.generate_ec_key(rng), rng),
            tt.certificate_der(tt.generate_ed25519_key(rng), rng)]
    pem, _, _ = tt.generate_ca("cap-enc", rng)
    ders.append(t_x509.load_pem_x509_certificate(pem.encode()).der)
    objs = [x509.load_der_x509_certificate(d) for d in ders]
    want = j_config.encode_certificates(*objs)
    assert t_config.encode_certificates(*ders) == want
    assert t_config.encode_certificates(
        *[t_x509.load_der_x509_certificate(d) for d in ders]) == want
    assert t_config.encode_certificates(ders[2]) == pem
    for args in ((), (ders[0], None)):
        jargs = tuple(objs[0] if a is not None else None for a in args)
        assert _outcome(lambda: t_config.encode_certificates(*args)) == \
            _outcome(lambda: j_config.encode_certificates(*jargs))
