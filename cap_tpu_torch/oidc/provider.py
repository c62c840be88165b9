"""Provider: the OIDC relying-party engine.

Discovery at construction, ``auth_url``, ``exchange`` (the token
endpoint over the pooled HTTP client's ``post_form``),
``verify_id_token`` (the keyset's signature check, then the registered
claims rules), ``userinfo``, ``valid_redirect`` and ``done``, with the
JAX package's messages and rule order. The Provider takes a keyset: a
:class:`~cap_tpu_torch.jwt.gpu_keyset.GPUBatchKeySet` makes
``verify_id_token_batch`` one batch on the card, and its raw mode
(``raw=True``, over ``verify_batch_raw``) decides the claims rules of
the accepted tokens in one call of the native rules engine
(:mod:`.claims_native`), the tokens that engine hands back going
through the Python rules.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlencode, urlparse, urlunparse

import numpy as np

from ..errors import (
    CapError,
    ExpiredAuthTimeError,
    ExpiredTokenError,
    InvalidAudienceError,
    InvalidAuthorizedPartyError,
    InvalidFlowError,
    InvalidIssuedAtError,
    InvalidIssuerError,
    InvalidNonceError,
    InvalidNotBeforeError,
    InvalidParameterError,
    InvalidSignatureError,
    InvalidSubjectError,
    MissingClaimError,
    MissingIDTokenError,
    NilParameterError,
    UnauthorizedRedirectURIError,
    UnsupportedAlgError,
    UserInfoFailedError,
)
from ..jwt.jose import is_json_form, peek_alg
from ..jwt.keyset import JSONWebKeySet, KeySet
from ..runtime.native_binding import registered_claims_from_payloads
from ..utils import http as _http
from ..utils.strutils import remove_duplicates_stable, str_list_contains
from .config import SCOPE_OPENID, Config
from .id_token import IDToken
from .prompt import NONE as PROMPT_NONE
from .request import Request
from .token import Token

_VERIFY_LEEWAY = 60.0  # 1-minute leeway on iat/nbf


class Provider:
    """An OIDC relying party bound to one issuer.

    Performs discovery at construction (network) unless given the
    discovery document. ``done()`` drops the keyset.
    """

    def __init__(self, config: Config, keyset: Optional[KeySet] = None,
                 discovery_doc: Optional[Dict[str, Any]] = None):
        if config is None:
            raise NilParameterError("provider config is nil")
        config.validate()
        self.config = config
        self._ssl_ctx = _http.ssl_context_for_ca(config.provider_ca or None)
        # alg by compact header segment: tokens from one IdP share the
        # exact header bytes, so one peek_alg a distinct header serves
        # the batch.
        self._alg_cache: Dict[str, str] = {}
        # (allowed?, alg) by header segment — the native claims
        # engine's per-token alg_ok input (bounded like _alg_cache;
        # exact: supported_signing_algs is fixed per Provider)
        self._alg_ok_cache: Dict[str, tuple] = {}

        if discovery_doc is None:
            discovery_doc = _http.fetch_discovery(config.issuer, self._ssl_ctx)
        if discovery_doc.get("issuer") != config.issuer:
            raise InvalidIssuerError(
                f"oidc issuer did not match the issuer returned by provider, "
                f"expected {config.issuer!r} got {discovery_doc.get('issuer')!r}"
            )
        self._discovery = discovery_doc
        self.authorization_endpoint = discovery_doc.get(
            "authorization_endpoint", "")
        self.token_endpoint = discovery_doc.get("token_endpoint", "")
        self.userinfo_endpoint = discovery_doc.get("userinfo_endpoint", "")
        self.jwks_uri = discovery_doc.get("jwks_uri", "")

        if keyset is not None:
            self._keyset = keyset
        else:
            if not self.jwks_uri:
                raise InvalidIssuerError("discovery document missing jwks_uri")
            self._keyset = JSONWebKeySet(
                self.jwks_uri, jwks_ca_pem=config.provider_ca or None)

    def done(self) -> None:
        """Release provider resources."""
        self._keyset = None  # type: ignore[assignment]

    @property
    def keyset(self) -> KeySet:
        return self._keyset

    # -- AuthURL -----------------------------------------------------------

    def auth_url(self, request: Request) -> str:
        """Build the IdP authorize URL."""
        if request is None:
            raise NilParameterError("request is nil")
        if not request.state():
            raise InvalidParameterError("request id is empty")
        if not request.nonce():
            raise InvalidParameterError("request nonce is empty")
        if request.state() == request.nonce():
            raise InvalidParameterError(
                "request id and nonce cannot be equal")
        with_implicit, with_implicit_at = request.implicit_flow()
        if request.pkce_verifier() is not None and with_implicit:
            raise InvalidParameterError(
                "request requests both implicit flow and authorization "
                "code with PKCE")
        if not request.redirect_url():
            raise InvalidParameterError("request redirect URL is empty")
        self.valid_redirect(request.redirect_url())

        scopes = request.scopes() or list(self.config.scopes)
        if not str_list_contains(scopes, SCOPE_OPENID):
            scopes = [SCOPE_OPENID] + scopes

        params: List[Tuple[str, str]] = [
            ("response_type", "code"),
            ("client_id", self.config.client_id),
            ("redirect_uri", request.redirect_url()),
            ("scope", " ".join(scopes)),
            ("state", request.state()),
            ("nonce", request.nonce()),
        ]
        if with_implicit:
            req_tokens = ["id_token"] + (["token"] if with_implicit_at else [])
            params = [(k, v) for k, v in params if k != "response_type"]
            params += [
                ("response_type", " ".join(req_tokens)),
                ("response_mode", "form_post"),
            ]
        verifier = request.pkce_verifier()
        if verifier is not None:
            params += [
                ("code_challenge", verifier.challenge()),
                ("code_challenge_method", verifier.method()),
            ]
        max_age, auth_after = request.max_age()
        if auth_after:
            params.append(("max_age", str(int(max_age))))
        if request.prompts():
            prompts = remove_duplicates_stable(
                [str(p) for p in request.prompts()], case_sensitive=False)
            if str_list_contains(prompts, str(PROMPT_NONE)) and len(prompts) > 1:
                raise InvalidParameterError(
                    f'prompts ({prompts}) includes "none" with other values')
            params.append(("prompt", " ".join(prompts)))
        if request.display():
            params.append(("display", str(request.display())))
        if request.ui_locales():
            params.append(("ui_locales", " ".join(request.ui_locales())))
        if request.claims():
            params.append(("claims", request.claims().decode("utf-8")))
        if request.acr_values():
            params.append(("acr_values", " ".join(request.acr_values())))

        sep = "&" if "?" in self.authorization_endpoint else "?"
        return self.authorization_endpoint + sep + urlencode(params)

    # -- Exchange ----------------------------------------------------------

    def exchange(self, request: Request, authorization_state: str,
                 authorization_code: str) -> Token:
        """Auth code → verified Token."""
        if request is None:
            raise NilParameterError("request is nil")
        with_implicit, _ = request.implicit_flow()
        if with_implicit:
            raise InvalidFlowError(
                f"request ({request.state()}) should not be using the "
                f"implicit flow")
        if request.state() != authorization_state:
            raise InvalidParameterError(
                "authentication request state and authorization state "
                "are not equal")
        if not request.redirect_url():
            raise InvalidParameterError(
                "authentication request redirect URL is empty")
        self.valid_redirect(request.redirect_url())
        if request.is_expired():
            raise InvalidParameterError(
                "authentication request is expired")

        fields = {
            "grant_type": "authorization_code",
            "code": authorization_code,
            "redirect_uri": request.redirect_url(),
            "client_id": self.config.client_id,
        }
        secret = self.config.client_secret.reveal()
        if secret:
            fields["client_secret"] = secret
        verifier = request.pkce_verifier()
        if verifier is not None:
            fields["code_verifier"] = verifier.verifier()
        status, body, _ = _http.post_form(
            self.token_endpoint, fields, self._ssl_ctx)
        if status != 200:
            raise InvalidParameterError(
                f"unable to exchange auth code with provider: "
                f"status {status}: {body[:200]!r}")
        try:
            payload = json.loads(body)
        except ValueError as e:
            raise InvalidParameterError(
                f"token endpoint returned invalid JSON: {e}") from e

        raw_id_token = payload.get("id_token")
        if not isinstance(raw_id_token, str) or not raw_id_token:
            raise MissingIDTokenError(
                "id_token is missing from auth code exchange")
        expires_in = payload.get("expires_in")
        expiry = 0.0
        if isinstance(expires_in, (int, float)) and expires_in:
            expiry = self.config.now() + float(expires_in)
        token = Token(
            IDToken(raw_id_token),
            access_token=payload.get("access_token", "") or "",
            refresh_token=payload.get("refresh_token", "") or "",
            expiry=expiry,
            now_func=self.config.now_func,
        )
        claims = self.verify_id_token(token.id_token(), request)
        if token.access_token().reveal():
            token.id_token().verify_access_token(token.access_token())
        c_hash = claims.get("c_hash")
        if isinstance(c_hash, str) and c_hash:
            token.id_token().verify_authorization_code(authorization_code)
        return token

    # -- VerifyIDToken -----------------------------------------------------

    def verify_id_token(self, id_token: IDToken | str,
                        request: Request) -> Dict[str, Any]:
        """Full id_token verification.

        Signature + iss + exp/nbf via the KeySet/claims engine, then
        nonce, iat (1-minute leeway), audience (request override →
        config default), multi-aud must contain client_id, the three azp
        rules, and auth_time against a requested max_age.
        """
        t = id_token if isinstance(id_token, IDToken) else IDToken(id_token)
        if not t.reveal():
            raise InvalidParameterError("id_token is empty")
        if not request.nonce():
            raise InvalidParameterError("nonce is empty")
        claims = self._verify_signature_and_times(t.reveal())
        return self._validate_id_claims(claims, t.reveal(), request)

    def verify_id_token_batch(self, id_tokens: Sequence[str],
                              request: Request,
                              raw: bool = False) -> List[Any]:
        """Batched verify_id_token: one keyset batch for the signatures
        (one batch on the card with a GPUBatchKeySet), then the claims
        rules per token. Returns a claims dict or an exception per
        token.

        ``raw=True``: an accepted token yields its signed payload bytes
        (already the claims JSON) in place of a dict, and the rules read
        the registered claims only: one native rules call decides the
        batch, and the tokens it hands back (status ``fallback``) go
        through the Python rules over the registered-claims subset. The
        verdicts are the dict mode's; a native reject's message keeps
        its template without the payload's value (``claims_native.
        status_error``). Needs a keyset with ``verify_batch_raw``.
        """
        raws = [t.reveal() if isinstance(t, IDToken) else str(t)
                for t in id_tokens]
        if raw:
            if not hasattr(self._keyset, "verify_batch_raw"):
                raise InvalidParameterError(
                    "raw id_token batch mode needs a keyset with "
                    "verify_batch_raw (GPUBatchKeySet)")
            results = self._keyset.verify_batch_raw(raws)
            out = [None] * len(raws)
            acc: List[int] = []
            for i, res in enumerate(results):
                if isinstance(res, Exception):
                    # same wrapping as the single-token path so callers
                    # see one taxonomy regardless of which API they used
                    out[i] = res if isinstance(res, InvalidSignatureError) \
                        else InvalidSignatureError(
                            f"failed to verify id token signature: {res}")
                else:
                    acc.append(i)
            self._validate_accepted_raw(acc, raws, results, request, out)
            return out
        results = self._keyset.verify_batch(raws)
        out = []
        for raw_tok, res in zip(raws, results):
            if isinstance(res, Exception):
                if isinstance(res, InvalidSignatureError):
                    out.append(res)
                else:
                    out.append(InvalidSignatureError(
                        f"failed to verify id token signature: {res}"))
                continue
            try:
                self._check_times(res)
                self._validate_id_claims(res, raw_tok, request)
                out.append(res)
            except Exception as e:  # noqa: BLE001 - per-token error channel
                out.append(e)
        return out

    def _validate_accepted_raw(self, acc: List[int], raws: Sequence[str],
                               results: Sequence[Any], request: Request,
                               out: List[Any]) -> None:
        """Claims validation of the raw batch's signature-accepted
        tokens, filling ``out`` in place (payload bytes or exception).

        One native rules call (claims_validate.cpp) decides the batch,
        ``_check_times`` included. The Python rules decide the tokens
        it returns ``fallback`` for, and the whole batch when the
        policy has a field the engine's blob cannot carry (an audience
        that is not a string; ``claims_native.policy_expressible``).
        Every token the Python rules decide adds to
        ``claims_native.native_fallbacks``. A failed build or load of
        the engine, or a layout handshake that does not match, raises.
        """
        from . import claims_native

        if not acc:
            return
        audiences = request.audiences() or list(self.config.audiences)
        if not claims_native.policy_expressible(
                self.config.issuer, self.config.client_id,
                request.nonce(), audiences):
            claims_native.count_fallbacks(len(acc))
            self._python_validate_raw(acc, raws, results, request, out)
            return
        # Per-token allowed-alg verdicts off the header-segment cache:
        # one (ok, alg) entry per distinct compact header (an IdP has a
        # handful). JSON-form tokens (no stable prefix) take _alg_of
        # per token; a token whose alg does not parse takes the Python
        # rules.
        alg_ok = np.zeros(len(acc), np.uint8)
        algs: List[Any] = [None] * len(acc)
        forced_fb = []
        supported = self.config.supported_signing_algs
        cache = self._alg_ok_cache
        for j, i in enumerate(acc):
            t = raws[i]
            seg = t.partition(".")[0] if t[:1] != "{" else None
            hit = cache.get(seg) if seg is not None else None
            if hit is None:
                try:
                    a = self._alg_of(t)
                except CapError:
                    forced_fb.append(j)
                    continue
                hit = (1 if a in supported else 0, a)
                if seg is not None:
                    if len(cache) >= 1024:
                        cache.clear()
                    cache[seg] = hit
            alg_ok[j] = hit[0]
            algs[j] = hit[1]
        statuses = claims_native.validate_payloads(
            [results[i] for i in acc], alg_ok, self.config.now(),
            self._policy_blob(request))
        statuses[forced_fb] = claims_native.STATUS_FALLBACK
        if not statuses.any():
            # every token accepted: the common batch
            for i in acc:
                out[i] = results[i]
            claims_native.count_validated(len(acc))
            return
        fb: List[int] = []
        now = self.config.now()
        client = self.config.client_id
        for j, i in enumerate(acc):
            st = int(statuses[j])
            if st == claims_native.STATUS_OK:
                out[i] = results[i]
            elif st == claims_native.STATUS_FALLBACK:
                fb.append(i)
            else:
                out[i] = claims_native.status_error(
                    st, alg=algs[j], client_id=client, now=now)
        claims_native.count_validated(len(acc) - len(fb))
        claims_native.count_fallbacks(len(fb))
        self._python_validate_raw(fb, raws, results, request, out)

    def _python_validate_raw(self, idx: List[int], raws: Sequence[str],
                             results: Sequence[Any], request: Request,
                             out: List[Any]) -> None:
        """The Python rules for raw-mode tokens: the registered-claims
        subset of each payload (``json.loads`` where the extension
        flags it), then ``_check_times`` and ``_validate_id_claims``
        per token."""
        if not idx:
            return
        claims_sub = registered_claims_from_payloads(
            [results[i] for i in idx])
        for i, claims in zip(idx, claims_sub):
            try:
                if isinstance(claims, Exception):
                    raise claims
                self._check_times(claims)
                self._validate_id_claims(claims, raws[i], request)
                out[i] = results[i]
            except Exception as e:  # noqa: BLE001 - per-token channel
                out[i] = e

    def _policy_blob(self, request: Request) -> bytes:
        """The native engine's policy for one batch: issuer, client,
        nonce, audiences, leeway, and the max_age bit that leaves
        auth_time to the Python rules."""
        from . import claims_native

        _, auth_after = request.max_age()
        return claims_native.pack_policy(
            self.config.issuer, self.config.client_id, request.nonce(),
            request.audiences() or list(self.config.audiences),
            _VERIFY_LEEWAY, bool(auth_after))

    def _verify_signature_and_times(self, raw: str) -> Dict[str, Any]:
        try:
            claims = self._keyset.verify_signature(raw)
        except InvalidSignatureError:
            raise
        except Exception as e:  # noqa: BLE001
            raise InvalidSignatureError(
                f"failed to verify id token signature: {e}") from e
        self._check_times(claims)
        return claims

    def _alg_of(self, raw: str) -> str:
        """peek_alg with a header-segment cache.

        alg is a pure function of the compact header segment, and the
        token already parsed successfully upstream, so caching by that
        segment is exact; JSON-form tokens (no stable prefix) always
        take the full peek. The cache is bounded — a rotating IdP has
        a handful of distinct headers, an attacker spraying unique
        headers just evicts.
        """
        if is_json_form(raw):           # no stable prefix to key on
            return peek_alg(raw)
        seg, _, rest = raw.partition(".")
        if not rest:
            return peek_alg(raw)
        alg = self._alg_cache.get(seg)
        if alg is None:
            alg = peek_alg(raw)
            if len(self._alg_cache) >= 1024:
                self._alg_cache.clear()
            self._alg_cache[seg] = alg
        return alg

    def _check_times(self, claims: Dict[str, Any]) -> None:
        now = self.config.now()
        exp = claims.get("exp")
        if not isinstance(exp, (int, float)):
            raise MissingClaimError("id_token missing exp claim")
        if now > float(exp):
            raise ExpiredTokenError("token is expired")
        nbf = claims.get("nbf")
        if isinstance(nbf, (int, float)) and now + _VERIFY_LEEWAY < float(nbf):
            raise InvalidNotBeforeError(
                "current time before the nbf (not before) time")

    def _validate_id_claims(self, claims: Dict[str, Any], raw: str,
                            request: Request) -> Dict[str, Any]:
        # issuer, against the discovery document's
        iss = claims.get("iss")
        if iss != self.config.issuer:
            raise InvalidIssuerError(
                "id token issued by a different provider")
        # signing alg must be in the configured supported list
        alg = self._alg_of(raw)
        if alg not in self.config.supported_signing_algs:
            raise UnsupportedAlgError(
                f"id_token signed with unsupported algorithm {alg!r}")
        if claims.get("nonce") != request.nonce():
            raise InvalidNonceError("invalid id_token nonce")
        now = self.config.now()
        iat = claims.get("iat")
        if isinstance(iat, (int, float)) and now + _VERIFY_LEEWAY < float(iat):
            raise InvalidIssuedAtError(
                f"current time {now} before the iat (issued at) time {iat}")

        aud_claim = claims.get("aud")
        if isinstance(aud_claim, str):
            aud_list = [aud_claim]
        elif isinstance(aud_claim, list):
            # an aud array may only hold strings: ["client", 42] is
            # rejected, not read as a single audience
            if any(not isinstance(a, str) for a in aud_claim):
                raise InvalidAudienceError(
                    "aud claim contains a non-string value")
            aud_list = list(aud_claim)
        else:
            aud_list = []
        audiences = request.audiences() or list(self.config.audiences)
        if audiences:
            if not any(str_list_contains(aud_list, a) for a in audiences):
                raise InvalidAudienceError("invalid id_token audiences")
        if len(aud_list) > 1 and not str_list_contains(
                aud_list, self.config.client_id):
            raise InvalidAudienceError(
                f"multiple audiences ({aud_list}) and one of them is not "
                f"equal client_id ({self.config.client_id})")

        azp = claims.get("azp")
        client = self.config.client_id
        if azp is not None and azp != client:
            raise InvalidAuthorizedPartyError(
                f"authorized party ({azp}) is not equal client_id ({client})")
        if len(aud_list) > 1 and azp != client:
            raise InvalidAuthorizedPartyError(
                f"multiple audiences and authorized party ({azp}) is not "
                f"equal client_id ({client})")
        if (len(aud_list) == 1 and aud_list[0] != client) and azp != client:
            raise InvalidAuthorizedPartyError(
                f"one audience ({aud_list[0]}) which is not the client_id "
                f"({client}) and authorized party ({azp}) is not equal "
                f"client_id ({client})")

        max_age, auth_after = request.max_age()
        if auth_after:
            at_claim = claims.get("auth_time")
            if not isinstance(at_claim, (int, float)):
                raise MissingClaimError(
                    "missing auth_time claim when max age was requested")
            if not (float(at_claim) + _VERIFY_LEEWAY > auth_after):
                raise ExpiredAuthTimeError(
                    f"auth_time ({at_claim}) is beyond max age ({max_age})")
        return claims

    # -- UserInfo ----------------------------------------------------------

    def userinfo(self, token_source, valid_sub: str,
                 audiences: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        """Fetch and validate userinfo claims."""
        if token_source is None:
            raise NilParameterError("token source is nil")
        if not self.userinfo_endpoint:
            raise UserInfoFailedError(
                "provider does not advertise a userinfo endpoint")
        access = token_source.token()
        raw = access.reveal() if hasattr(access, "reveal") else str(access)
        status, body, _ = _http.get(
            self.userinfo_endpoint, self._ssl_ctx,
            headers={"Authorization": f"Bearer {raw}"})
        if status != 200:
            raise UserInfoFailedError(
                f"userinfo request failed: status {status}")
        try:
            claims = json.loads(body)
        except ValueError as e:
            raise UserInfoFailedError(
                f"userinfo returned invalid JSON: {e}") from e
        if not isinstance(claims, dict):
            raise UserInfoFailedError("userinfo claims are not an object")
        sub = claims.get("sub")
        if not sub:
            raise MissingClaimError("userinfo response missing sub claim")
        if sub != valid_sub:
            raise InvalidSubjectError(
                "sub from userinfo does not match the expected sub")
        iss = claims.get("iss")
        if iss is not None and iss != self.config.issuer:
            raise InvalidIssuerError(
                "iss from userinfo does not match the provider issuer")
        if audiences:
            aud = claims.get("aud")
            aud_list = [aud] if isinstance(aud, str) else (
                aud if isinstance(aud, list) else [])
            if not any(a in aud_list for a in audiences):
                raise InvalidAudienceError("invalid userinfo audiences")
        return claims

    # -- redirect validation (RFC 8252 §7.3) --------------------------------

    def valid_redirect(self, uri: str) -> None:
        allowed = self.config.allowed_redirect_urls
        if not allowed:
            return
        try:
            parsed = urlparse(uri)
        except ValueError as e:
            raise InvalidParameterError(
                f"redirect URI {uri} is an invalid URI: {e}") from e

        loopbacks = ("localhost", "127.0.0.1", "::1")
        if parsed.hostname not in loopbacks:
            if uri in allowed:
                return
            raise UnauthorizedRedirectURIError(f"redirect URI {uri}")

        # loopback: port-agnostic comparison
        stripped = _strip_port(parsed)
        for a in allowed:
            try:
                allowed_parsed = urlparse(a)
            except ValueError as e:
                raise InvalidParameterError(
                    f"allowed redirect URI {a} is an invalid URI: {e}"
                ) from e
            if stripped == _strip_port(allowed_parsed):
                return
        raise UnauthorizedRedirectURIError(f"redirect URI {uri}")


def _strip_port(parsed) -> str:
    host = parsed.hostname or ""
    if ":" in host:  # IPv6 literal
        host = f"[{host}]"
    return urlunparse(parsed._replace(netloc=host))
