"""The port's ``Provider`` against the JAX package's, live, over real
TLS: every case of ``tests/test_oidc_provider.py`` (discovery, auth
URLs with every option, exchange with and without PKCE, the
verify_id_token rules, max_age, key rotation, userinfo, the batch),
run by both Providers against the JAX package's ``TestProvider`` with
equal results, or equal exception classes and messages; then the
converse, the JAX ``Provider`` against the port's ``TestProvider``
(its pure-Python TLS CA and IdP) with the results it gets against its
own. Both sides get an explicit state and nonce and one fixed clock,
so auth URLs and claims compare equal."""

import json
import random
import time
from urllib.parse import parse_qs, urlparse

import pytest

import cap_tpu.errors as j_errors
import cap_tpu.oidc as j_oidc

import cap_tpu_torch.errors as t_errors
import cap_tpu_torch.oidc as t_oidc
from cap_tpu_torch import testing as tt
from cap_tpu_torch.oidc.testing import TestProvider as PortIdP

REDIRECT = "https://app.example.com/callback"
# the IdPs' and the relying parties' clock, whole seconds
CLOCK = float(int(time.time()))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__, str(e))


@pytest.fixture(scope="module")
def jax_idp():
    pytest.importorskip("cryptography")
    from cap_tpu.oidc.testing import TestProvider

    tp = TestProvider().start()
    tp.set_now_func(lambda: CLOCK)
    yield tp
    tp.stop()


@pytest.fixture(scope="module")
def port_idp():
    tp = PortIdP(rng=random.Random(2026)).start()
    tp.set_now_func(lambda: CLOCK)
    yield tp
    tp.stop()


def _signer(idp):
    """Sign claims with the IdP's current key, by the IdP package's
    own signer."""
    priv, _, alg, kid = idp.signing_keys()
    if isinstance(idp, PortIdP):
        return lambda claims: tt.sign_jwt(priv, alg, claims, kid=kid)
    from cap_tpu import testing as captest

    return lambda claims: captest.sign_jwt(priv, alg, claims, kid=kid)


class Side:
    """One relying party package against one IdP."""

    def __init__(self, o, errors, idp):
        self.o, self.errors, self.idp = o, errors, idp

    def config(self, **over):
        kw = dict(issuer=self.idp.issuer(), client_id=self.idp.client_id,
                  client_secret=self.idp.client_secret,
                  supported_signing_algs=["ES256"],
                  allowed_redirect_urls=[REDIRECT],
                  provider_ca=self.idp.ca_cert(), now_func=lambda: CLOCK)
        kw.update(over)
        return self.o.Config(**kw)

    def provider(self, **over):
        return self.o.Provider(self.config(**over))

    def request(self, tag, **kw):
        return self.o.Request(60, kw.pop("redirect", REDIRECT),
                              state=f"st_{tag}", nonce=f"n_{tag}", **kw)


def _token_data(tok):
    return (tok.id_token().claims(), tok.access_token().reveal(),
            tok.refresh_token().reveal(), tok.expiry(), tok.valid(),
            tok.is_expired())


def _query(url):
    u = urlparse(url)
    return u.path, sorted(parse_qs(u.query).items())


# -- the cases: each returns a list of outcomes ------------------------------

def case_discovery(s):
    p = s.provider()
    return [(p.authorization_endpoint.replace(s.idp.issuer(), "<iss>"),
             p.token_endpoint.replace(s.idp.issuer(), "<iss>"),
             p.userinfo_endpoint.replace(s.idp.issuer(), "<iss>"),
             p.jwks_uri.replace(s.idp.issuer(), "<iss>"))]


def case_discovery_issuer_mismatch(s):
    cfg = s.config(client_id="x", client_secret="y")
    return [_outcome(lambda: s.o.Provider(
        cfg, discovery_doc={"issuer": "https://evil.example.com"}))]


AUTH_URL_REQUESTS = {
    "code": dict(scopes=["email", "profile"]),
    "pkce": dict(pkce="v" * 43),
    "implicit": dict(implicit_flow=True, implicit_access_token=True),
    "implicit id_token only": dict(implicit_flow=True),
    "options": dict(max_age=30, prompts=["login", "consent", "LOGIN"],
                    display="page", ui_locales=["en-US", "fr"],
                    acr_values=["phr"], claims={"id_token": {}}),
    "prompt none alone": dict(prompts=["none", "login"]),
    "prompt none": dict(prompts=["none"]),
    "unauthorized redirect": dict(redirect="https://evil.example.com/cb"),
}


def case_auth_url(s):
    p = s.provider(scopes=["cfg-scope"])
    out = []
    for tag, kw in AUTH_URL_REQUESTS.items():
        kw = dict(kw)
        pkce = kw.pop("pkce", None)
        if pkce:
            kw["pkce_verifier"] = s.o.S256Verifier(pkce)
        req = s.request(tag.replace(" ", "-"), **kw)
        out.append(_outcome(lambda: _query(p.auth_url(req))))
    out.append(_outcome(lambda: p.auth_url(None)))
    return out


def case_loopback_redirect(s):
    p = s.provider(allowed_redirect_urls=["http://localhost:3000/cb",
                                          "http://127.0.0.1/x"])
    return [_outcome(lambda: p.valid_redirect(u)) for u in (
        "http://localhost:9999/cb", "http://localhost:9999/other",
        "http://127.0.0.1:5/x", "https://localhost:3000/cb",
        "https://other.example/cb", "http://[::1]:8/cb")]


def case_exchange_full_flow(s):
    p = s.provider()
    req = s.request("full")
    s.idp.set_expected_auth_nonce(req.nonce())
    return [_outcome(lambda: _token_data(
        p.exchange(req, req.state(), s.idp.expected_auth_code)))]


def case_exchange_pkce_flow(s):
    p = s.provider()
    v = s.o.S256Verifier("k" * 50)
    req = s.request("pkce", pkce_verifier=v)
    s.idp.set_expected_auth_nonce(req.nonce())
    out = []
    try:
        s.idp.set_expected_code_verifier(v.verifier())
        out.append(_outcome(lambda: _token_data(
            p.exchange(req, req.state(), s.idp.expected_auth_code))))
        s.idp.set_expected_code_verifier("w" * 50)
        out.append(_outcome(lambda: p.exchange(
            req, req.state(), s.idp.expected_auth_code)))
    finally:
        s.idp.expected_code_verifier = None
    return out


def case_exchange_guards(s):
    p = s.provider()
    req = s.request("guards")
    imp = s.request("imp", implicit_flow=True)
    expired = s.o.Request(60, REDIRECT, state="st_e", nonce="n_e",
                          now_func=lambda: 0.0)
    expired._now_func = None
    bad_redirect = s.request("bad", redirect="https://evil.example/cb")
    return [_outcome(lambda: p.exchange(req, "other-state", "code")),
            _outcome(lambda: p.exchange(imp, imp.state(), "code")),
            _outcome(lambda: p.exchange(expired, expired.state(), "code")),
            _outcome(lambda: p.exchange(bad_redirect, bad_redirect.state(),
                                        "code")),
            _outcome(lambda: p.exchange(None, "s", "c"))]


def case_exchange_wrong_code(s):
    p = s.provider()
    req = s.request("wrong-code")
    return [_outcome(lambda: p.exchange(req, req.state(), "wrong-code"))]


def case_exchange_token_disabled(s):
    p = s.provider()
    req = s.request("disabled")
    s.idp.set_disable_token(True)
    try:
        return [_outcome(lambda: p.exchange(req, req.state(),
                                            s.idp.expected_auth_code))]
    finally:
        s.idp.set_disable_token(False)


def case_exchange_omit_tokens(s):
    p = s.provider()
    req = s.request("omit")
    s.idp.set_expected_auth_nonce(req.nonce())
    out = []
    for knob in ("set_omit_id_tokens", "set_omit_access_tokens",
                 "set_omit_at_hash"):
        getattr(s.idp, knob)(True)
        try:
            out.append(_outcome(lambda: _token_data(p.exchange(
                req, req.state(), s.idp.expected_auth_code))))
        finally:
            getattr(s.idp, knob)(False)
    return out


def case_exchange_client_secret(s):
    """A wrong client secret, then none at all."""
    req = s.request("secret")
    s.idp.set_expected_auth_nonce(req.nonce())
    return [_outcome(lambda: s.provider(client_secret=sec).exchange(
        req, req.state(), s.idp.expected_auth_code)) for sec in ("bad", "")]


def case_verify_id_token_rules(s):
    p = s.provider()
    req = s.request("rules")
    req_aud = s.request("aud", audiences=["expected-aud"])
    idp = s.idp
    vectors = [
        (req, dict(nonce="some-other-nonce")),
        (req, dict(nonce=req.nonce(), extra_claims={"exp": 1000000})),
        (req, dict(nonce=req.nonce(), extra_claims={"exp": "soon"})),
        (req, dict(nonce=req.nonce(),
                   extra_claims={"nbf": CLOCK + 3600})),
        (req, dict(nonce=req.nonce(),
                   extra_claims={"iat": CLOCK + 3600})),
        (req, dict(nonce=req.nonce(), extra_claims={"iss": "https://evil"})),
        (req, dict(nonce=req.nonce(),
                   extra_claims={"aud": ["someone-else"]})),
        (req_aud, dict(nonce=req_aud.nonce(),
                       extra_claims={"aud": ["someone-else"]})),
        (req_aud, dict(nonce=req_aud.nonce(),
                       extra_claims={"aud": ["expected-aud"]})),
        (req, dict(nonce=req.nonce(), extra_claims={"azp": "other-party"})),
        (req, dict(nonce=req.nonce(),
                   extra_claims={"aud": [idp.client_id, "second"],
                                 "azp": idp.client_id})),
        (req, dict(nonce=req.nonce(),
                   extra_claims={"aud": [idp.client_id, "second"]})),
        (req, dict(nonce=req.nonce(),
                   extra_claims={"aud": ["second", "third"],
                                 "azp": idp.client_id})),
        (req, dict(nonce=req.nonce(), extra_claims={"aud": [idp.client_id,
                                                            42]})),
        (req, dict(nonce=req.nonce(), extra_claims={"aud": idp.client_id})),
        (req, dict(nonce=req.nonce())),
    ]
    out = [_outcome(lambda: p.verify_id_token(
        idp.issue_signed_jwt(**kw), r)) for r, kw in vectors]
    idp.set_invalid_jwt_signature(True)
    try:
        out.append(_outcome(lambda: p.verify_id_token(
            idp.issue_signed_jwt(nonce=req.nonce()), req)))
    finally:
        idp.set_invalid_jwt_signature(False)
    out.append(_outcome(lambda: p.verify_id_token("", req)))
    out.append(_outcome(lambda: p.verify_id_token("a.b", req)))
    return out


def case_unsupported_alg(s):
    p = s.provider(supported_signing_algs=["RS256"])
    req = s.request("alg")
    return [_outcome(lambda: p.verify_id_token(
        s.idp.issue_signed_jwt(nonce=req.nonce()), req))]


def case_max_age(s):
    p = s.provider()
    idp = s.idp
    req = s.request("ma", max_age=300, now_func=lambda: CLOCK)
    req2 = s.request("ma2", max_age=10, now_func=lambda: CLOCK)
    base = s.o.IDToken(idp.issue_signed_jwt(nonce=req2.nonce())).claims()
    no_auth_time = {k: v for k, v in base.items() if k != "auth_time"}
    return [
        _outcome(lambda: p.verify_id_token(
            idp.issue_signed_jwt(nonce=req.nonce()), req)),
        _outcome(lambda: p.verify_id_token(idp.issue_signed_jwt(
            nonce=req2.nonce(), extra_claims={"auth_time": 1000000}), req2)),
        _outcome(lambda: p.verify_id_token(idp.issue_signed_jwt(
            nonce=req2.nonce(), extra_claims={"auth_time": None}), req2)),
        _outcome(lambda: p.verify_id_token(
            _signer(idp)(no_auth_time), req2)),
    ]


def case_key_rotation_refetch(s):
    p = s.provider()
    req = s.request("rot")
    out = [_outcome(lambda: p.verify_id_token(
        s.idp.issue_signed_jwt(nonce=req.nonce()), req))]
    s.idp.rotate_signing_keys()
    out.append(_outcome(lambda: p.verify_id_token(
        s.idp.issue_signed_jwt(nonce=req.nonce()), req)))
    return out


def case_userinfo(s):
    p = s.provider()

    class TS:
        def token(self):
            return "test-access-token"

    out = [_outcome(lambda: p.userinfo(TS(), s.idp.replay_subject)),
           _outcome(lambda: p.userinfo(TS(), "mallory")),
           _outcome(lambda: p.userinfo(None, "x")),
           _outcome(lambda: p.userinfo(TS(), s.idp.replay_subject,
                                       audiences=["some-aud"]))]
    s.idp.set_user_info_reply({"sub": s.idp.replay_subject,
                               "iss": "https://other", "aud": "a"})
    out.append(_outcome(lambda: p.userinfo(TS(), s.idp.replay_subject)))
    s.idp.set_user_info_reply({"sub": s.idp.replay_subject, "aud": ["a"]})
    out.append(_outcome(lambda: p.userinfo(TS(), s.idp.replay_subject,
                                           audiences=["a"])))
    s.idp.set_user_info_reply({"email": "x"})
    out.append(_outcome(lambda: p.userinfo(TS(), s.idp.replay_subject)))
    s.idp.user_info_reply = None
    s.idp.set_disable_userinfo(True)
    try:
        out.append(_outcome(lambda: p.userinfo(TS(), s.idp.replay_subject)))
    finally:
        s.idp.set_disable_userinfo(False)
    return out


def case_discovery_and_jwks_faults(s):
    out = []
    s.idp.set_disable_discovery(True)
    try:
        out.append(_outcome(lambda: s.provider()))
    finally:
        s.idp.set_disable_discovery(False)
    req = s.request("jwks")
    for knob in ("set_disable_jwks", "set_invalid_jwks"):
        p = s.provider()
        getattr(s.idp, knob)(True)
        try:
            out.append(_outcome(lambda: type(p.verify_id_token(
                s.idp.issue_signed_jwt(nonce=req.nonce()), req)).__name__))
        finally:
            getattr(s.idp, knob)(False)
    return out


def case_batch(s):
    p = s.provider()
    req = s.request("batch")
    good = [s.idp.issue_signed_jwt(nonce=req.nonce()) for _ in range(3)]
    bad_nonce = s.idp.issue_signed_jwt(nonce="wrong")
    tampered = good[0][:-10] + "AAAAAAAAAA"
    out = p.verify_id_token_batch(
        [s.o.IDToken(good[0])] + good[1:] + [bad_nonce, tampered, "x"], req)
    return [r if isinstance(r, dict) else (type(r).__name__, str(r))
            for r in out]


def case_done(s):
    p = s.provider()
    p.done()
    return [p.keyset is None]


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


def _run(case, side):
    out = CASES[case](side)
    iss = side.idp.issuer()
    return json.loads(json.dumps(out, default=repr).replace(iss, "<issuer>"))


@pytest.mark.parametrize("case", list(CASES))
def test_port_provider_against_the_jax_idp(case, jax_idp):
    want = _run(case, Side(j_oidc, j_errors, jax_idp))
    got = _run(case, Side(t_oidc, t_errors, jax_idp))
    assert got == want


@pytest.mark.parametrize("case", list(CASES))
def test_jax_provider_against_the_port_idp(case, jax_idp, port_idp):
    want = _run(case, Side(j_oidc, j_errors, jax_idp))
    got = _run(case, Side(j_oidc, j_errors, port_idp))
    assert got == want


@pytest.mark.parametrize("case", ["exchange_full_flow", "verify_id_token_rules",
                                  "max_age", "batch"])
def test_port_provider_against_the_port_idp(case, port_idp):
    """The port alone (as on the card's machine, without
    ``cryptography``): the port Provider against its own IdP gives
    what the JAX Provider gets there."""
    pytest.importorskip("cryptography")
    want = _run(case, Side(j_oidc, j_errors, port_idp))
    got = _run(case, Side(t_oidc, t_errors, port_idp))
    assert got == want


def test_port_idp_serves_over_its_own_ca(port_idp):
    from cap_tpu_torch.utils import http as t_http

    ctx = t_http.ssl_context_for_ca(port_idp.ca_cert())
    status, body, _ = t_http.get(
        port_idp.issuer() + "/.well-known/openid-configuration", ctx)
    doc = json.loads(body)
    assert status == 200 and doc["issuer"] == port_idp.issuer()
    status, body, _ = t_http.get(doc["jwks_uri"], ctx)
    assert status == 200 and json.loads(body) == port_idp.jwks_document()
    with pytest.raises(OSError):
        t_http.get(port_idp.issuer() + "/.well-known/openid-configuration",
                   t_http.ssl_context_for_ca(
                       tt.generate_ca("other", random.Random(1))[0]))
