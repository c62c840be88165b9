"""Request: one OIDC authentication attempt.

State and nonce are generated (base62, ``st_`` and ``n_`` prefixes)
unless given; the request expires ``expires_in`` seconds after it is
made, with a 1-second skew. It carries the redirect URL, per-request
scope and audience overrides, the implicit flow or PKCE (never both),
max_age (and the auth_after instant it implies), prompts, display,
ui_locales, the claims JSON and acr_values. Accessors return copies.
"""

from __future__ import annotations

import json
import time as _time
from typing import Callable, List, Optional, Sequence, Tuple

from ..errors import InvalidParameterError
from .display import Display
from .id import new_id
from .pkce import CodeVerifier
from .prompt import Prompt

REQUEST_EXPIRY_SKEW = 1.0  # seconds


class Request:
    """One authentication attempt's state.

    Construct with ``expires_in`` seconds and the redirect URL; state
    and nonce are generated unless overridden (they must differ).
    """

    def __init__(
        self,
        expires_in: float,
        redirect_url: str,
        *,
        state: Optional[str] = None,
        nonce: Optional[str] = None,
        scopes: Optional[Sequence[str]] = None,
        audiences: Optional[Sequence[str]] = None,
        implicit_flow: bool = False,
        implicit_access_token: bool = False,
        pkce_verifier: Optional[CodeVerifier] = None,
        max_age: Optional[float] = None,
        prompts: Optional[Sequence[Prompt]] = None,
        display: Optional[Display] = None,
        ui_locales: Optional[Sequence[str]] = None,
        claims: Optional[bytes | str | dict] = None,
        acr_values: Optional[Sequence[str]] = None,
        now_func: Optional[Callable[[], float]] = None,
    ):
        if expires_in <= 0:
            raise InvalidParameterError("expires_in must be positive")
        if not redirect_url:
            raise InvalidParameterError("redirect URL is empty")
        self._now_func = now_func
        now = self._now()
        self._expiration = now + float(expires_in)
        self._redirect_url = redirect_url
        self._state = state if state is not None else new_id(prefix="st")
        self._nonce = nonce if nonce is not None else new_id(prefix="n")
        if not self._state:
            raise InvalidParameterError("state is empty")
        if not self._nonce:
            raise InvalidParameterError("nonce is empty")
        if self._state == self._nonce:
            raise InvalidParameterError("state and nonce cannot be equal")

        if (implicit_flow or implicit_access_token) and pkce_verifier:
            raise InvalidParameterError(
                "request cannot use both implicit flow and PKCE"
            )
        self._implicit = bool(implicit_flow or implicit_access_token)
        self._implicit_access_token = bool(implicit_access_token)
        self._pkce_verifier = pkce_verifier

        self._scopes = list(scopes) if scopes else []
        self._audiences = list(audiences) if audiences else []

        self._max_age: Optional[float] = None
        self._auth_after: float = 0.0
        if max_age is not None:
            if max_age < 0:
                raise InvalidParameterError("max_age must be non-negative")
            self._max_age = float(max_age)
            self._auth_after = now - float(max_age)

        if prompts:
            self._prompts = [Prompt(p) for p in prompts]
        else:
            self._prompts = []
        self._display = Display(display) if display else None
        self._ui_locales = list(ui_locales) if ui_locales else []
        self._acr_values = list(acr_values) if acr_values else []

        if claims is None:
            self._claims: Optional[bytes] = None
        else:
            if isinstance(claims, dict):
                claims = json.dumps(claims).encode("utf-8")
            elif isinstance(claims, str):
                claims = claims.encode("utf-8")
            try:
                json.loads(claims)
            except ValueError as e:
                raise InvalidParameterError(
                    f"claims must be valid JSON: {e}"
                ) from e
            self._claims = bytes(claims)

    # -- accessors (defensive copies) --------------------------------------

    def state(self) -> str:
        return self._state

    def nonce(self) -> str:
        return self._nonce

    def redirect_url(self) -> str:
        return self._redirect_url

    def scopes(self) -> List[str]:
        return list(self._scopes)

    def audiences(self) -> List[str]:
        return list(self._audiences)

    def implicit_flow(self) -> Tuple[bool, bool]:
        """(using implicit flow, access token also requested)."""
        return self._implicit, self._implicit_access_token

    def pkce_verifier(self) -> Optional[CodeVerifier]:
        return self._pkce_verifier.copy() if self._pkce_verifier else None

    def max_age(self) -> Tuple[Optional[float], float]:
        """(max_age seconds, auth_after instant; 0.0 when unset)."""
        return self._max_age, self._auth_after

    def prompts(self) -> List[Prompt]:
        return list(self._prompts)

    def display(self) -> Optional[Display]:
        return self._display

    def ui_locales(self) -> List[str]:
        return list(self._ui_locales)

    def claims(self) -> Optional[bytes]:
        return bytes(self._claims) if self._claims is not None else None

    def acr_values(self) -> List[str]:
        return list(self._acr_values)

    def expiration(self) -> float:
        return self._expiration

    def _now(self) -> float:
        return self._now_func() if self._now_func is not None else _time.time()

    def is_expired(self) -> bool:
        """True once now is past expiration + skew."""
        return self._now() > self._expiration + REQUEST_EXPIRY_SKEW
