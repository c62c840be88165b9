"""TestProvider: a stateful in-process HTTPS OIDC IdP for tests.

A real TLS server (its self-signed CA from ``testing.generate_ca``, a
pure-Python P-256 certificate, exposed by ``ca_cert()``) that serves
the five IdP endpoints (discovery, JWKS, authorize, token, userinfo),
with knobs that double as fault injection:

- ``set_disable_jwks`` (404 JWKS), ``set_invalid_jwks`` (garbage body)
- ``set_disable_token`` (401), ``set_disable_implicit``,
  ``set_disable_userinfo``, ``set_disable_discovery``
- ``set_omit_id_tokens`` / ``set_omit_access_tokens``
- ``set_expected_state`` (send a wrong state back)
- ``set_signing_keys`` (key rotation), ``set_now_func`` (clock control)
- ``set_expected_auth_code``, ``set_expected_auth_nonce``,
  ``set_client_creds``, ``set_expected_code_verifier`` (PKCE),
  ``set_custom_claims``, ``set_custom_audiences``,
  ``set_user_info_reply``, ``set_allowed_redirect_uris``,
  ``set_expected_expiry``, ``set_invalid_jwt_signature``

Client and IdP run in one process over real HTTPS. Keys and signatures
are the port's pure-integer fixtures (``cap_tpu_torch.testing``), drawn
from ``rng`` (a ``random.Random``; a fresh system-seeded one by
default): RS*/PS* over a 2048-bit RSA key, ES256/384/512 over P-256/
P-384/P-521, EdDSA over Ed25519.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import ssl
import sys
import tempfile
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlencode, urlparse

from .. import testing as captest
from ..jwt import algs as _algs
from ..jwt.jose import b64url_encode
from ..jwt.jwk import serialize_public_key

DEFAULT_EXPECTED_EXPIRY = 300.0


class _Server(ThreadingHTTPServer):
    def handle_error(self, request, client_address):
        # the TLS handshake runs on the request's thread: a client that
        # drops it (one that does not trust the CA) is not a server fault
        if not isinstance(sys.exc_info()[1], (ssl.SSLError,
                                               ConnectionError)):
            super().handle_error(request, client_address)

_EC_CURVE = {_algs.ES256: "P-256", _algs.ES384: "P-384",
             _algs.ES512: "P-521"}


def generate_keys(alg: str, rng: random.Random) -> Tuple[Any, Any]:
    """(private key, public key) of a fresh key pair for ``alg``."""
    if alg in _EC_CURVE:
        priv = captest.generate_ec_key(rng, _EC_CURVE[alg])
    elif alg == _algs.EdDSA:
        priv = captest.generate_ed25519_key(rng)
    elif alg in (_algs.RS256, _algs.RS384, _algs.RS512,
                 _algs.PS256, _algs.PS384, _algs.PS512):
        priv = captest.generate_rsa_key(rng, 2048)
    else:
        raise ValueError(f"unsupported alg {alg!r}")
    return priv, priv.public_key()


class TestProvider:
    """In-process HTTPS OIDC IdP. Start with ``TestProvider.start()``
    (or use as a context manager); ``stop()`` shuts the server down."""

    __test__ = False  # not a pytest test class despite the name

    def __init__(self, alg: str = _algs.ES256,
                 client_id: str = "test-client-id",
                 client_secret: str = "test-client-secret",
                 expected_auth_code: str = "test-auth-code",
                 with_port: int = 0,
                 no_tls: bool = False,
                 rng: Optional[random.Random] = None):
        self._lock = threading.RLock()
        self._alg = alg
        self._rng = rng if rng is not None else random.Random()
        priv, pub = generate_keys(alg, self._rng)
        self._signing_key, self._public_key, self._kid = priv, pub, "kid-0"
        self._key_counter = 0
        self.client_id = client_id
        self.client_secret = client_secret
        self.expected_auth_code = expected_auth_code
        self.expected_auth_nonce: Optional[str] = None
        self.expected_code_verifier: Optional[str] = None
        self.expected_state: Optional[str] = None  # override sent-back state
        self.expected_expiry = DEFAULT_EXPECTED_EXPIRY
        self.allowed_redirect_uris: Optional[List[str]] = None
        self.replay_subject = "alice@example.com"
        self.custom_claims: Dict[str, Any] = {}
        self.custom_audiences: Optional[List[str]] = None
        self.user_info_reply: Optional[Dict[str, Any]] = None
        self.now_func: Optional[Callable[[], float]] = None
        self.disable_jwks = False
        self.invalid_jwks = False
        self.disable_token = False
        self.disable_implicit = False
        self.disable_userinfo = False
        self.disable_discovery = False
        self.invalid_jwt_signature = False
        self.omit_id_tokens = False
        self.omit_access_tokens = False
        self.omit_at_hash = False  # issue id_tokens without at_hash

        # nonce bound at /authorize time, replayed by /token per real-IdP
        # semantics (expected_auth_nonce overrides when set)
        self._nonce_for_code: Dict[str, str] = {}
        self._no_tls = no_tls
        self._requested_port = with_port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ca_pem = ""

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "TestProvider":
        provider = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 so clients exercise keep-alive connection reuse
            # (the pooled HTTP client).
            protocol_version = "HTTP/1.1"
            # a stalled client (no handshake, no request) frees its
            # thread after this long
            timeout = captest.SERVER_TIMEOUT_S

            def do_GET(self):  # noqa: N802
                provider._handle(self)

            def do_POST(self):  # noqa: N802
                provider._handle(self)

            def log_message(self, *args):
                pass

        self._server = _Server(("127.0.0.1", self._requested_port), Handler)
        scheme = "http" if self._no_tls else "https"
        if not self._no_tls:
            ca_pem, key, key_pem = captest.generate_ca("cap-tpu-test-idp",
                                                       self._rng)
            self._ca_pem = ca_pem
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            with tempfile.NamedTemporaryFile("w", suffix=".pem",
                                             delete=False) as f:
                f.write(ca_pem)
                f.write(key_pem)
                chain = f.name
            try:
                ctx.load_cert_chain(chain)
            finally:
                os.unlink(chain)  # never leave key material on disk
            # the handshake runs on the request's thread under the
            # handler's timeout, not in the accept loop, where a client
            # that never speaks would stall every request
            self._server.socket = ctx.wrap_socket(
                self._server.socket, server_side=True,
                do_handshake_on_connect=False)
        port = self._server.server_address[1]
        self.addr = f"{scheme}://127.0.0.1:{port}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            captest.stop_server(self._server, self._thread)
            self._server = None

    def __enter__(self) -> "TestProvider":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- accessors ---------------------------------------------------------

    def issuer(self) -> str:
        return self.addr

    def ca_cert(self) -> str:
        """PEM of the server's self-signed CA."""
        return self._ca_pem

    def signing_keys(self) -> Tuple[Any, Any, str, str]:
        with self._lock:
            return self._signing_key, self._public_key, self._alg, self._kid

    def now(self) -> float:
        return self.now_func() if self.now_func else _time.time()

    # -- knobs ---------------------------------------------------------------

    def set_expected_auth_code(self, code: str) -> None:
        with self._lock:
            self.expected_auth_code = code

    def set_expected_auth_nonce(self, nonce: str) -> None:
        with self._lock:
            self.expected_auth_nonce = nonce

    def set_expected_code_verifier(self, verifier: str) -> None:
        with self._lock:
            self.expected_code_verifier = verifier

    def set_expected_state(self, state: str) -> None:
        with self._lock:
            self.expected_state = state

    def set_client_creds(self, client_id: str, client_secret: str) -> None:
        with self._lock:
            self.client_id, self.client_secret = client_id, client_secret

    def set_expected_expiry(self, seconds: float) -> None:
        with self._lock:
            self.expected_expiry = seconds

    def set_allowed_redirect_uris(self, uris: List[str]) -> None:
        with self._lock:
            self.allowed_redirect_uris = list(uris)

    def set_custom_claims(self, claims: Dict[str, Any]) -> None:
        with self._lock:
            self.custom_claims = dict(claims)

    def set_custom_audiences(self, auds: List[str]) -> None:
        with self._lock:
            self.custom_audiences = list(auds)

    def set_user_info_reply(self, reply: Dict[str, Any]) -> None:
        with self._lock:
            self.user_info_reply = dict(reply)

    def set_now_func(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self.now_func = fn

    def set_signing_keys(self, priv, pub, alg: str, kid: str) -> None:
        with self._lock:
            self._signing_key, self._public_key = priv, pub
            self._alg, self._kid = alg, kid

    def rotate_signing_keys(self) -> None:
        """Generate a fresh key pair under a new kid (rotation tests)."""
        with self._lock:
            self._key_counter += 1
            priv, pub = generate_keys(self._alg, self._rng)
            self._signing_key, self._public_key = priv, pub
            self._kid = f"kid-{self._key_counter}"

    def set_disable_jwks(self, v: bool = True) -> None:
        with self._lock:
            self.disable_jwks = v

    def set_invalid_jwks(self, v: bool = True) -> None:
        with self._lock:
            self.invalid_jwks = v

    def set_disable_token(self, v: bool = True) -> None:
        with self._lock:
            self.disable_token = v

    def set_disable_implicit(self, v: bool = True) -> None:
        with self._lock:
            self.disable_implicit = v

    def set_disable_userinfo(self, v: bool = True) -> None:
        with self._lock:
            self.disable_userinfo = v

    def set_disable_discovery(self, v: bool = True) -> None:
        with self._lock:
            self.disable_discovery = v

    def set_omit_id_tokens(self, v: bool = True) -> None:
        with self._lock:
            self.omit_id_tokens = v

    def set_omit_access_tokens(self, v: bool = True) -> None:
        with self._lock:
            self.omit_access_tokens = v

    def set_omit_at_hash(self, v: bool = True) -> None:
        with self._lock:
            self.omit_at_hash = v

    def set_invalid_jwt_signature(self, v: bool = True) -> None:
        """Issue id_tokens whose signature bytes are corrupted."""
        with self._lock:
            self.invalid_jwt_signature = v

    # -- token issuing -----------------------------------------------------

    def issue_signed_jwt(self, nonce: str = "",
                         extra_claims: Optional[Dict[str, Any]] = None) -> str:
        with self._lock:
            now = self.now()
            claims: Dict[str, Any] = {
                "iss": self.issuer(),
                "sub": self.replay_subject,
                "aud": (self.custom_audiences
                        if self.custom_audiences is not None
                        else [self.client_id]),
                "iat": int(now),
                "nbf": int(now),
                "exp": int(now + self.expected_expiry),
                "auth_time": int(now),
            }
            if nonce:
                claims["nonce"] = nonce
            claims.update(self.custom_claims)
            if extra_claims:
                claims.update(extra_claims)
            token = captest.sign_jwt(self._signing_key, self._alg, claims,
                                     kid=self._kid, rng=self._rng)
            if self.invalid_jwt_signature:
                token = token[:-8] + ("A" * 8 if token[-8:] != "A" * 8
                                      else "B" * 8)
            return token

    # -- HTTP --------------------------------------------------------------

    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(h.path)
        path = parsed.path.rstrip("/") or "/"
        try:
            if path == "/.well-known/openid-configuration":
                self._serve_discovery(h)
            elif path == "/.well-known/jwks.json":
                self._serve_jwks(h)
            elif path == "/authorize":
                self._serve_authorize(h, parsed)
            elif path == "/token":
                self._serve_token(h)
            elif path == "/userinfo":
                self._serve_userinfo(h)
            else:
                self._reply(h, 404, {"error": "not found"})
        except (BrokenPipeError, ConnectionResetError):
            pass

    @staticmethod
    def _reply(h, status: int, payload, content_type="application/json",
               headers=None) -> None:
        body = (json.dumps(payload).encode()
                if content_type == "application/json"
                and not isinstance(payload, (bytes, str)) else
                payload if isinstance(payload, bytes) else
                str(payload).encode())
        h.send_response(status)
        h.send_header("Content-Type", content_type)
        h.send_header("Cache-Control", "no-store")
        h.send_header("Content-Length", str(len(body)))  # keep-alive
        for k, v in (headers or {}).items():
            h.send_header(k, v)
        h.end_headers()
        h.wfile.write(body)

    def _serve_discovery(self, h) -> None:
        if self.disable_discovery:
            self._reply(h, 404, {"error": "discovery disabled"})
            return
        self._reply(h, 200, {
            "issuer": self.issuer(),
            "authorization_endpoint": self.issuer() + "/authorize",
            "token_endpoint": self.issuer() + "/token",
            "userinfo_endpoint": self.issuer() + "/userinfo",
            "jwks_uri": self.issuer() + "/.well-known/jwks.json",
            "response_types_supported": ["code", "id_token",
                                         "id_token token"],
            "subject_types_supported": ["public"],
            "id_token_signing_alg_values_supported": [self._alg],
        })

    def _serve_jwks(self, h) -> None:
        if self.disable_jwks:
            self._reply(h, 404, {"error": "jwks disabled"})
            return
        if self.invalid_jwks:
            self._reply(h, 200, b"{ this is not valid json ]",
                        content_type="application/json")
            return
        with self._lock:
            doc = self.jwks_document()
        self._reply(h, 200, doc)

    def jwks_document(self) -> Dict[str, Any]:
        """The JWKS the IdP serves: its signing key."""
        return {"keys": [serialize_public_key(
            self._public_key, kid=self._kid, alg=self._alg)]}

    def _serve_authorize(self, h, parsed) -> None:
        q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        state = self.expected_state or q.get("state", "")
        redirect = q.get("redirect_uri", "")
        if self.allowed_redirect_uris is not None and \
                redirect not in self.allowed_redirect_uris:
            self._reply(h, 403, {"error": "unauthorized redirect_uri"})
            return
        response_type = q.get("response_type", "code")
        nonce = q.get("nonce", "")
        if "id_token" in response_type:
            if self.disable_implicit:
                self._reply(h, 403, {"error": "implicit disabled"})
                return
            fields: Dict[str, str] = {"state": state}
            if not self.omit_id_tokens:
                fields["id_token"] = self.issue_signed_jwt(nonce=nonce)
            if "token" in response_type.split() and not self.omit_access_tokens:
                fields["access_token"] = "test-access-token"
                # at_hash binding when both tokens are issued
                if "id_token" in fields:
                    fields["id_token"] = self._with_hash_claims(
                        nonce, access_token=fields["access_token"])
            inputs = "".join(
                f'<input type="hidden" name="{k}" value="{v}"/>'
                for k, v in fields.items())
            html = (f'<html><body onload="document.forms[0].submit()">'
                    f'<form method="post" action="{redirect}">{inputs}'
                    f'</form></body></html>')
            self._reply(h, 200, html.encode(), content_type="text/html")
            return
        # code flow: redirect back with code + state
        with self._lock:
            self._nonce_for_code[self.expected_auth_code] = nonce
        sep = "&" if "?" in redirect else "?"
        location = redirect + sep + urlencode(
            {"state": state, "code": self.expected_auth_code})
        h.send_response(302)
        h.send_header("Location", location)
        h.send_header("Content-Length", "0")  # keep-alive framing
        h.end_headers()

    def _with_hash_claims(self, nonce: str, access_token: str = "",
                          code: str = "") -> str:
        extra: Dict[str, Any] = {}
        hash_name = {"256": "sha256", "384": "sha384",
                     "512": "sha512"}.get(self._alg[-3:], "sha256")

        def half_hash(value: str) -> str:
            d = hashlib.new(hash_name, value.encode()).digest()
            return b64url_encode(d[: len(d) // 2])

        if access_token and not self.omit_at_hash:
            extra["at_hash"] = half_hash(access_token)
        if code:
            extra["c_hash"] = half_hash(code)
        return self.issue_signed_jwt(nonce=nonce, extra_claims=extra)

    def _serve_token(self, h) -> None:
        if self.disable_token:
            self._reply(h, 401, {"error": "token endpoint disabled"})
            return
        length = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(length).decode() if length else ""
        fields = {k: v[0] for k, v in parse_qs(body).items()}
        if fields.get("grant_type") != "authorization_code":
            self._reply(h, 400, {"error": "unsupported_grant_type"})
            return
        if fields.get("code") != self.expected_auth_code:
            self._reply(h, 401, {"error": "invalid_grant"})
            return
        # client authentication: accept post body or basic auth
        import base64

        cid, csec = fields.get("client_id"), fields.get("client_secret")
        auth = h.headers.get("Authorization", "")
        if auth.startswith("Basic "):
            try:
                decoded = base64.b64decode(auth[6:]).decode()
                cid, _, csec = decoded.partition(":")
            except Exception:  # noqa: BLE001
                pass
        if self.client_secret and csec != self.client_secret:
            self._reply(h, 401, {"error": "invalid_client"})
            return
        if cid != self.client_id:
            self._reply(h, 401, {"error": "invalid_client"})
            return
        if self.expected_code_verifier is not None and \
                fields.get("code_verifier") != self.expected_code_verifier:
            self._reply(h, 401, {"error": "invalid PKCE verifier"})
            return
        with self._lock:
            nonce = (self.expected_auth_nonce
                     or self._nonce_for_code.get(fields.get("code", ""), ""))
        payload: Dict[str, Any] = {
            "token_type": "Bearer",
            "expires_in": int(self.expected_expiry),
        }
        access_token = None
        if not self.omit_access_tokens:
            access_token = "test-access-token"
            payload["access_token"] = access_token
            payload["refresh_token"] = "test-refresh-token"
        if not self.omit_id_tokens:
            payload["id_token"] = self._with_hash_claims(
                nonce, access_token=access_token or "")
        self._reply(h, 200, payload)

    def _serve_userinfo(self, h) -> None:
        if self.disable_userinfo:
            self._reply(h, 404, {"error": "userinfo disabled"})
            return
        auth = h.headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            self._reply(h, 401, {"error": "missing bearer token"})
            return
        with self._lock:
            reply = self.user_info_reply or {
                "sub": self.replay_subject,
                "iss": self.issuer(),
                "email": self.replay_subject,
            }
        self._reply(h, 200, reply)
