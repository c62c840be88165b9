"""The port's OIDC callback handlers (``oidc.callback``: ``auth_code``,
``implicit``, ``SingleRequestReader``, ``AuthenErrorResponse``)
against the JAX package's, live: each WSGI app driven the way a
browser would after the IdP's ``/authorize`` (the code flow's redirect
query, the implicit flow's posted form), by both packages against one
in-process TLS IdP, with equal status lines, headers and bodies on
success, on the IdP's error, and on every guard (unknown state,
expired request, wrong flow, missing id_token, a bad at_hash, a failed
exchange)."""

import http.client
import io
import re
import ssl
import time
from urllib.parse import urlencode, urlparse

import pytest

import cap_tpu.oidc as j_oidc
import cap_tpu.oidc.callback as j_callback

import cap_tpu_torch.oidc as t_oidc
import cap_tpu_torch.oidc.callback as t_callback

REDIRECT = "https://app.example.com/callback"
CLOCK = float(int(time.time()))
SIDES = {"jax": (j_oidc, j_callback), "port": (t_oidc, t_callback)}


@pytest.fixture(scope="module")
def idp():
    pytest.importorskip("cryptography")
    from cap_tpu.oidc.testing import TestProvider

    tp = TestProvider().start()
    tp.set_now_func(lambda: CLOCK)
    yield tp
    tp.stop()


def _authorize(idp, url):
    """GET the IdP's authorize URL without following its redirect:
    (status, headers, body)."""
    u = urlparse(url)
    ctx = ssl.create_default_context(cadata=idp.ca_cert())
    conn = http.client.HTTPSConnection(u.hostname, u.port, context=ctx)
    try:
        conn.request("GET", u.path + "?" + u.query)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _call(app, method="GET", query="", form=None):
    """One WSGI request: (status line, headers, body)."""
    environ = {"REQUEST_METHOD": method, "QUERY_STRING": query}
    if form is not None:
        body = urlencode(form).encode()
        environ.update(CONTENT_LENGTH=str(len(body)),
                       CONTENT_TYPE="application/x-www-form-urlencoded")
        environ["wsgi.input"] = io.BytesIO(body)
    seen = {}

    def start_response(status, headers):
        seen["status"], seen["headers"] = status, headers

    out = b"".join(app(environ, start_response))
    return seen["status"], seen["headers"], out


def _success(state, token, environ):
    claims = token.id_token().claims()
    return (200, [("Content-Type", "text/plain")],
            f"success:{state}:{claims['sub']}:{claims['nonce']}:"
            f"{token.access_token().reveal()}:{token.valid()}")


def _error(state, resp, err, environ):
    if resp is not None:
        text = f"idp:{resp.error}:{resp.description}:{resp.uri}"
    else:
        text = f"local:{type(err).__name__}:{err}"
    return (401, [("Content-Type", "text/plain")], f"error:{state}:{text}")


def _provider(o, idp):
    return o.Provider(o.Config(
        issuer=idp.issuer(), client_id=idp.client_id,
        client_secret=idp.client_secret, supported_signing_algs=["ES256"],
        allowed_redirect_urls=[REDIRECT], provider_ca=idp.ca_cert(),
        now_func=lambda: CLOCK))


def _code_flow(o, cb, idp, tag, mutate=None, reader=None, via_post=False):
    p = _provider(o, idp)
    req = o.Request(60, REDIRECT, state=f"st_{tag}", nonce=f"n_{tag}")
    idp.set_expected_auth_nonce(req.nonce())
    status, headers, _ = _authorize(idp, p.auth_url(req))
    assert status == 302
    query = urlparse(headers["Location"]).query
    if mutate is not None:
        query = mutate(req, query)
    app = cb.auth_code(p, reader(req) if reader else
                       cb.SingleRequestReader(req), _success, _error)
    if via_post:
        from urllib.parse import parse_qsl

        return _call(app, "POST", "", dict(parse_qsl(query)))
    return _call(app, "GET", query)


def _implicit_flow(o, cb, idp, tag, access_token=True, mutate=None,
                   reader=None):
    p = _provider(o, idp)
    req = o.Request(60, REDIRECT, state=f"st_{tag}", nonce=f"n_{tag}",
                    implicit_flow=True, implicit_access_token=access_token)
    status, _, body = _authorize(idp, p.auth_url(req))
    assert status == 200
    fields = dict(re.findall(r'name="([^"]+)" value="([^"]+)"',
                             body.decode()))
    if mutate is not None:
        fields = mutate(req, fields)
    app = cb.implicit(p, reader(req) if reader else
                      cb.SingleRequestReader(req), _success, _error)
    return _call(app, "POST", "", fields)


def _expired(o, cb):
    def reader(req):
        req._expiration = 0.0
        return cb.SingleRequestReader(req)
    return reader


class _Failing:
    def __init__(self, cb):
        self.cb = cb

    def __call__(self, req):
        class R(self.cb.RequestReader):
            def read(self, state):
                raise RuntimeError(f"store down for {state}")
        return R()


CASES = {
    "code: success": lambda o, cb, idp: _code_flow(o, cb, idp, "ok"),
    "code: success, posted": lambda o, cb, idp: _code_flow(
        o, cb, idp, "post", via_post=True),
    "code: idp error": lambda o, cb, idp: _code_flow(
        o, cb, idp, "err", mutate=lambda r, q: urlencode(
            {"state": r.state(), "error": "access_denied",
             "error_description": "nope", "error_uri": "https://e/x"})),
    "code: unknown state": lambda o, cb, idp: _code_flow(
        o, cb, idp, "unk", mutate=lambda r, q: q.replace(
            r.state(), "unknown-state")),
    "code: expired request": lambda o, cb, idp: _code_flow(
        o, cb, idp, "exp", reader=_expired(o, cb)),
    "code: reader fails": lambda o, cb, idp: _code_flow(
        o, cb, idp, "fail", reader=_Failing(cb)),
    "code: wrong code": lambda o, cb, idp: _code_flow(
        o, cb, idp, "code", mutate=lambda r, q: urlencode(
            {"state": r.state(), "code": "stolen"})),
    "code: implicit request": lambda o, cb, idp: _call(
        cb.auth_code(_provider(o, idp), cb.SingleRequestReader(
            o.Request(60, REDIRECT, state="st_i", nonce="n_i",
                      implicit_flow=True)), _success, _error),
        "GET", "state=st_i&code=x"),
    "implicit: success": lambda o, cb, idp: _implicit_flow(
        o, cb, idp, "iok"),
    "implicit: id_token only": lambda o, cb, idp: _implicit_flow(
        o, cb, idp, "ionly", access_token=False),
    "implicit: idp error": lambda o, cb, idp: _implicit_flow(
        o, cb, idp, "ierr", mutate=lambda r, f: {
            "state": r.state(), "error": "login_required"}),
    "implicit: bad at_hash": lambda o, cb, idp: _implicit_flow(
        o, cb, idp, "ihash", mutate=lambda r, f: dict(
            f, access_token="other-access-token")),
    "implicit: missing id_token": lambda o, cb, idp: _implicit_flow(
        o, cb, idp, "imiss", mutate=lambda r, f: {
            k: v for k, v in f.items() if k != "id_token"}),
    "implicit: tampered id_token": lambda o, cb, idp: _implicit_flow(
        o, cb, idp, "itamp", mutate=lambda r, f: dict(
            f, id_token=f["id_token"][:-6] + "AAAAAA")),
    "implicit: expired request": lambda o, cb, idp: _implicit_flow(
        o, cb, idp, "iexp", reader=_expired(o, cb)),
    "implicit: unknown state": lambda o, cb, idp: _implicit_flow(
        o, cb, idp, "iunk", mutate=lambda r, f: dict(f, state="nobody")),
    "implicit: code request": lambda o, cb, idp: _call(
        cb.implicit(_provider(o, idp), cb.SingleRequestReader(
            o.Request(60, REDIRECT, state="st_c", nonce="n_c")),
            _success, _error), "POST", "", {"state": "st_c",
                                            "id_token": "x.y.z"}),
}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("case", list(CASES))
def test_callback_as_the_jax_package(case, idp):
    want, got = (_outcome(lambda m=mods: CASES[case](*m, idp))
                 for mods in SIDES.values())
    assert got == want
    assert want[0] == "ok"
    status, _, body = want[1]
    assert status.startswith("200") == body.startswith(b"success:")


@pytest.mark.parametrize("which", ["auth_code", "implicit"])
def test_factory_guards(which, idp):
    for args in ((None, object()), ("p", None)):
        outs = [_outcome(lambda cb=cb: getattr(cb, which)(
            args[0] if args[0] is None else _provider(o, idp), args[1],
            _success, _error)) for o, cb in SIDES.values()]
        assert outs[0] == outs[1] and outs[0][0] == "raise", outs


def test_reader_and_error_response():
    for o, cb in SIDES.values():
        req = o.Request(60, REDIRECT, state="s1", nonce="n1")
        r = cb.SingleRequestReader(req)
        assert r.read("s1") is req and r.read("s2") is None
        with pytest.raises(NotImplementedError):
            cb.RequestReader().read("s")
    a = j_callback.AuthenErrorResponse("e", "d")
    b = t_callback.AuthenErrorResponse("e", "d")
    assert (a.error, a.description, a.uri) == (b.error, b.description, b.uri)
