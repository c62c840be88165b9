"""OIDCRawKeySet: a Provider bound to one Request, as a keyset.

Wraps a :class:`~cap_tpu_torch.oidc.provider.Provider` and the
:class:`~cap_tpu_torch.oidc.request.Request` that holds the relying
party's expected nonce and audiences, and serves the whole verify-and-
validate path under the keyset interface: ``verify_batch`` is
``verify_id_token_batch``, ``verify_batch_raw`` its raw mode, whose
claims rules run in the native engine (claims_validate.cpp) with the
per-token Python fallback counted in ``claims_native.native_fallbacks``.

``key_epoch`` and ``swap_keys`` pass through to the provider's keyset
where it has them. ``oidc_rp_keyset_from_spec`` builds one from the
options of an ``oidc-rp:issuer=...;client=...;nonce=...[;algs=ES256+
RS256][;aud=a+b]`` spec, with the discovery document given, never
fetched.
"""

from __future__ import annotations

from typing import Any, List, Sequence

from .provider import Provider
from .request import Request


class OIDCRawKeySet:
    """``Provider.verify_id_token_batch`` under the keyset interface:
    ``verify_batch_raw`` gives an accepted token's signed payload bytes
    once every registered-claims rule (iss, exp, nbf, iat, nonce, aud,
    azp, auth_time) has passed."""

    def __init__(self, provider: Provider, request: Request):
        self._provider = provider
        self._request = request

    @property
    def provider(self) -> Provider:
        return self._provider

    @property
    def request(self) -> Request:
        return self._request

    def verify_batch(self, tokens: Sequence[str]) -> List[Any]:
        return self._provider.verify_id_token_batch(
            list(tokens), self._request)

    def verify_batch_raw(self, tokens: Sequence[str]) -> List[Any]:
        return self._provider.verify_id_token_batch(
            list(tokens), self._request, raw=True)

    # -- key rotation passthrough ---------------------------------------

    @property
    def key_epoch(self):
        return getattr(self._provider.keyset, "key_epoch", None)

    def swap_keys(self, jwks, epoch=None, grace_s: float = 0.0):
        swap = getattr(self._provider.keyset, "swap_keys", None)
        if swap is None:
            raise TypeError(
                f"{type(self._provider.keyset).__name__} does not "
                "support hot key rotation")
        return swap(jwks, epoch=epoch, grace_s=grace_s)


def oidc_rp_keyset_from_spec(opts: dict, inner) -> OIDCRawKeySet:
    """An OIDCRawKeySet from parsed ``oidc-rp:`` spec options over the
    keyset ``inner``."""
    from .config import Config

    issuer = opts.get("issuer", "")
    client = opts.get("client", "")
    algs = [a for a in (opts.get("algs") or "ES256").split("+") if a]
    auds = [a for a in (opts.get("aud") or "").split("+") if a]
    cfg = Config(issuer=issuer, client_id=client,
                 supported_signing_algs=algs,
                 audiences=auds or None)
    provider = Provider(cfg, keyset=inner,
                        discovery_doc={"issuer": issuer})
    request = Request(3600.0, opts.get("redirect", "http://127.0.0.1:1/cb"),
                      nonce=opts.get("nonce") or None)
    return OIDCRawKeySet(provider, request)
