"""The port's CPU keysets (``StaticKeySet``, ``JSONWebKeySet``,
``new_oidc_discovery_keyset``) and ``parse_public_key_pem`` against the
JAX package's, live: every case of ``tests/test_keyset.py`` (all ten
algorithms at the reference's key sizes) through both packages on the
same keys and the same loopback servers, with equal claims or equal
class and message, and equal fetch counts; then the rotation, cooldown,
404, garbage and wrong-kid cases, and discovery's issuer check and
missing ``jwks_uri``."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

pytest.importorskip("cryptography")

from cryptography.hazmat.primitives.serialization import (  # noqa: E402
    Encoding,
    PublicFormat,
)

from cap_tpu import testing as captest  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt import keyset as j_keyset  # noqa: E402
from cap_tpu.jwt import pem as j_pem  # noqa: E402
from cap_tpu.utils import http as j_http  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt import keyset as t_keyset  # noqa: E402
from cap_tpu_torch.jwt import pem as t_pem  # noqa: E402
from cap_tpu_torch.jwt.jose import b64url_encode  # noqa: E402
from cap_tpu_torch.utils import http as t_http  # noqa: E402

KEY_LADDER = [
    ("RS256", {"rsa_bits": 2048}), ("RS384", {"rsa_bits": 3072}),
    ("RS512", {"rsa_bits": 4096}), ("PS256", {"rsa_bits": 2048}),
    ("PS384", {"rsa_bits": 3072}), ("PS512", {"rsa_bits": 4096}),
    ("ES256", {}), ("ES384", {}), ("ES512", {}), ("EdDSA", {}),
]
ALGS = [a for a, _ in KEY_LADDER]


@pytest.fixture(scope="module")
def keypairs():
    return {alg: captest.generate_keys(alg, **kw) for alg, kw in KEY_LADDER}


def _port_key(pub):
    return t_jwk.parse_jwk(j_jwk.serialize_public_key(pub)).key


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


def _static(pkg, pubs):
    keys = pubs if pkg is j_keyset else [_port_key(p) for p in pubs]
    return pkg.StaticKeySet(keys)


def both_static(pubs, token):
    outs = [_outcome(lambda: _static(pkg, pubs).verify_signature(token))
            for pkg in (j_keyset, t_keyset)]
    assert outs[1] == outs[0]
    return outs[1]


class _Handler(BaseHTTPRequestHandler):
    body = b"{}"
    status = 200
    hits = 0

    def do_GET(self):
        type(self).hits += 1
        self.send_response(self.status)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(self.body)

    def log_message(self, *a):
        pass


@pytest.fixture()
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _Handler.status, _Handler.hits, _Handler.body = 200, 0, b"{}"
    yield f"http://127.0.0.1:{srv.server_address[1]}/jwks"
    srv.shutdown()
    srv.server_close()


def _set_jwks(pairs):
    _Handler.body = json.dumps({"keys": [
        j_jwk.serialize_public_key(k, kid=kid) for kid, k in pairs]}).encode()


def both_scenario(scenario):
    """Run ``scenario(keyset module)`` for each package with the hit
    counter reset; equal results and equal fetch counts."""
    outs = []
    for pkg in (j_keyset, t_keyset):
        _Handler.hits = 0
        result = scenario(pkg)
        outs.append((result, _Handler.hits))
    assert outs[1] == outs[0]
    return outs[1]


# ---------------------------------------------------------------------------
# StaticKeySet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ALGS)
def test_static_keyset_all_algs(alg, keypairs):
    priv, pub = keypairs[alg]
    token = captest.sign_jwt(priv, alg, captest.default_claims())
    out = both_static([pub], token)
    assert out[0] == "ok" and out[1]["sub"] == "alice"


@pytest.mark.parametrize("alg", ALGS)
def test_static_keyset_wrong_key_rejected(alg, keypairs):
    priv, _ = keypairs[alg]
    kw = dict(KEY_LADDER)[alg]
    _, other_pub = captest.generate_keys(alg, **kw)
    token = captest.sign_jwt(priv, alg, captest.default_claims())
    assert both_static([other_pub], token)[0] == "InvalidSignatureError"


@pytest.mark.parametrize("alg", ALGS)
def test_static_keyset_tampered_rejected(alg, keypairs):
    priv, pub = keypairs[alg]
    token = captest.sign_jwt(priv, alg, captest.default_claims())
    header, _, sig = token.split(".")
    evil = b64url_encode(json.dumps({"sub": "mallory",
                                     "exp": 9999999999}).encode())
    assert both_static([pub], f"{header}.{evil}.{sig}")[0] == \
        "InvalidSignatureError"


def test_static_keyset_trial_verification_order(keypairs):
    rs_priv, rs_pub = keypairs["RS256"]
    _, es_pub = keypairs["ES256"]
    _, ed_pub = keypairs["EdDSA"]
    token = captest.sign_jwt(rs_priv, "RS256", captest.default_claims())
    assert both_static([es_pub, ed_pub, rs_pub], token)[0] == "ok"
    assert both_static([es_pub, ed_pub], token)[0] == "InvalidSignatureError"
    for bad in ("a.b", "", "!!!.e30.e30"):
        both_static([rs_pub], bad)


def test_static_keyset_requires_keys():
    outs = [_outcome(lambda: pkg.StaticKeySet([])) for pkg in
            (j_keyset, t_keyset)]
    assert outs[0] == outs[1] == ("NilParameterError",
                                  "public keys are required")


def test_verify_batch_default_loop(keypairs):
    priv, pub = keypairs["RS256"]
    good = captest.sign_jwt(priv, "RS256", captest.default_claims())
    tokens = [good, good[:-8] + "AAAAAAAA", good, "a.b"]
    outs = [[r if isinstance(r, dict) else (type(r).__name__, str(r))
             for r in _static(pkg, [pub]).verify_batch(tokens)]
            for pkg in (j_keyset, t_keyset)]
    assert outs[0] == outs[1]
    assert outs[1][0]["sub"] == "alice"


def test_pem_roundtrip(keypairs):
    for alg in ("RS256", "ES256", "EdDSA", "ES512", "PS384"):
        priv, pub = keypairs[alg]
        pem = pub.public_bytes(Encoding.PEM,
                               PublicFormat.SubjectPublicKeyInfo).decode()
        token = captest.sign_jwt(priv, alg, captest.default_claims())
        outs = [_outcome(lambda: pkg.StaticKeySet(
                    [pem_mod.parse_public_key_pem(pem)])
                    .verify_signature(token))
                for pkg, pem_mod in ((j_keyset, j_pem), (t_keyset, t_pem))]
        assert outs[0] == outs[1] and outs[1][0] == "ok"
    # the port's own PEM writers, read by both
    rs = _port_key(keypairs["RS256"][1])
    for pem in (tt.spki_pem(rs), tt.pkcs1_pem(rs)):
        assert _port_key(j_pem.parse_public_key_pem(pem)).n == \
            t_pem.parse_public_key_pem(pem).n == rs.n


# ---------------------------------------------------------------------------
# JSONWebKeySet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ALGS)
def test_jwks_keyset_all_algs(alg, keypairs, server):
    priv, pub = keypairs[alg]
    _set_jwks([("kid-1", pub)])
    token = captest.sign_jwt(priv, alg, captest.default_claims(),
                             kid="kid-1")
    (status, claims), hits = both_scenario(
        lambda pkg: _outcome(lambda: pkg.JSONWebKeySet(server)
                             .verify_signature(token)))
    assert status == "ok" and claims["sub"] == "alice" and hits == 1


def test_jwks_kid_rotation_refetches(keypairs, server):
    priv, pub = keypairs["ES256"]
    token = captest.sign_jwt(priv, "ES256", captest.default_claims(),
                             kid="new-kid")

    def scenario(pkg):
        _set_jwks([("old-kid", pub)])
        ks = pkg.JSONWebKeySet(server)
        ks.keys()
        _set_jwks([("new-kid", pub)])
        return _outcome(lambda: ks.verify_signature(token))

    (status, claims), hits = both_scenario(scenario)
    assert status == "ok" and hits == 2


def test_jwks_no_refetch_on_forged_token(keypairs, server):
    priv, pub = keypairs["ES256"]
    _set_jwks([("kid-1", pub)])
    good = captest.sign_jwt(priv, "ES256", captest.default_claims(),
                            kid="kid-1")
    forged = good[:-12] + "AAAAAAAAAAAA"

    def scenario(pkg):
        ks = pkg.JSONWebKeySet(server)
        ks.keys()
        return [_outcome(lambda: ks.verify_signature(forged))
                for _ in range(3)]

    outs, hits = both_scenario(scenario)
    assert hits == 1 and outs[0][0] == "InvalidSignatureError"


def test_jwks_refresh_cooldown(keypairs, server):
    """An unknown kid refetches once, then is refused inside the
    cooldown without a fetch; a kid-less token with no candidate too."""
    rs_priv, rs_pub = keypairs["RS256"]
    es_priv, _ = keypairs["ES256"]
    _set_jwks([("a", rs_pub)])
    unknown = captest.sign_jwt(rs_priv, "RS256", captest.default_claims(),
                               kid="zzz")
    no_kid_es = captest.sign_jwt(es_priv, "ES256", captest.default_claims())

    def scenario(pkg):
        ks = pkg.JSONWebKeySet(server, refresh_cooldown_s=3600)
        return [_outcome(lambda: ks.verify_signature(t))
                for t in (unknown, unknown, no_kid_es)]

    outs, hits = both_scenario(scenario)
    assert [o[0] for o in outs] == ["UnknownKeyIDError", "UnknownKeyIDError",
                                    "InvalidSignatureError"]
    assert hits == 2

    def no_cooldown(pkg):
        ks = pkg.JSONWebKeySet(server, refresh_cooldown_s=0)
        return [_outcome(lambda: ks.verify_signature(t))
                for t in (no_kid_es, unknown)]

    outs, hits = both_scenario(no_cooldown)
    assert hits == 3


@pytest.mark.parametrize("status,body", [
    (404, b"{}"), (500, b"oops"), (200, b"not json at all"), (200, b"[1]"),
    (200, b'{"keys": 5}'), (200, b'{"keys": [5]}'),
    (200, b'{"keys": [{"kty": "RSA", "n": "AQAB", "e": "AQAB"}]}'),
    (200, b'{"keys": [{"kty": "EC", "crv": "P-256", "x5c": ["!!!"]}]}')])
def test_jwks_bad_documents_rejected(server, status, body):
    _Handler.status, _Handler.body = status, body
    (result, hits) = both_scenario(
        lambda pkg: _outcome(lambda: pkg.JSONWebKeySet(server).keys()))
    assert result[0] in ("InvalidJWKSError", "MalformedTokenError")


def test_jwks_wrong_kid_rejected(keypairs, server):
    priv, _ = keypairs["ES256"]
    _, other_pub = captest.generate_keys("ES256")
    _set_jwks([("a", other_pub)])
    token = captest.sign_jwt(priv, "ES256", captest.default_claims(), kid="a")
    (result, hits) = both_scenario(
        lambda pkg: _outcome(lambda: pkg.JSONWebKeySet(server)
                             .verify_signature(token)))
    assert result[0] == "InvalidSignatureError" and hits == 1


def test_keyset_arguments():
    for fn in (lambda pkg: pkg.JSONWebKeySet(""),
               lambda pkg: pkg.new_oidc_discovery_keyset(""),
               lambda pkg: pkg.JSONWebKeySet("http://127.0.0.1:1/x",
                                             jwks_ca_pem="garbage")):
        outs = [_outcome(lambda: fn(pkg)) for pkg in (j_keyset, t_keyset)]
        assert outs[0][0] == outs[1][0] and outs[0][0] != "ok"
        assert outs[0][1].split(":")[0] == outs[1][1].split(":")[0]
    assert t_http.ssl_context_for_ca(None) is None is \
        j_http.ssl_context_for_ca(None)


# ---------------------------------------------------------------------------
# discovery
# ---------------------------------------------------------------------------

def test_discovery_keyset_loads_x5c_keys(keypairs):
    es_priv, es_pub = keypairs["ES256"]
    rs_priv, rs_pub = keypairs["RS256"]
    state = {"keys": [captest.x5c_jwk(es_priv, es_pub, kid="es"),
                      j_jwk.serialize_public_key(rs_pub, kid="rs")]}
    tokens = [captest.sign_jwt(es_priv, "ES256", captest.default_claims(),
                               kid="es"),
              captest.sign_jwt(rs_priv, "RS256", captest.default_claims(),
                               kid="rs")]
    with tt.discovery_test_server(state) as (issuer, _srv):
        outs = []
        for pkg in (j_keyset, t_keyset):
            state["fetches"] = 0
            ks = pkg.new_oidc_discovery_keyset(issuer)
            outs.append(([_outcome(lambda: ks.verify_signature(t))
                          for t in tokens], [j.kid for j in ks.keys()],
                         state["fetches"]))
    assert outs[0] == outs[1]
    assert outs[1][1] == ["es", "rs"] and outs[1][2] == 2


@pytest.mark.parametrize("doc", [
    {"issuer": "https://elsewhere.example/", "jwks_uri": "http://x/jwks"},
    {"jwks_uri": "http://x/jwks"}, "TRAILING-SLASH", [1], None,
    "MISSING-JWKS-URI", "EMPTY-JWKS-URI", "404"])
def test_discovery_failures(doc):
    state = {"keys": []}
    with tt.discovery_test_server(state) as (issuer, _srv):
        if doc == "TRAILING-SLASH":
            doc = {"issuer": issuer + "/", "jwks_uri": issuer + "/jwks"}
        elif doc == "MISSING-JWKS-URI":
            doc = {"issuer": issuer}
        elif doc == "EMPTY-JWKS-URI":
            doc = {"issuer": issuer, "jwks_uri": ""}
        if doc == "404":
            issuer += "/nowhere"
        elif doc is not None:
            state["discovery"] = doc
        else:
            state["discovery"] = {"issuer": issuer, "jwks_uri": 5}
        outs = [_outcome(lambda: pkg.new_oidc_discovery_keyset(issuer))
                for pkg in (j_keyset, t_keyset)]
    assert outs[0] == outs[1]
    assert outs[1][0] in ("InvalidIssuerError", "InvalidParameterError")
