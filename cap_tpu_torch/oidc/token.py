"""Token: an id_token and the optional OAuth2 access and refresh tokens.

Access and refresh tokens redact themselves; validity checks allow a
10-second expiry skew; an expiry of 0 means "does not expire"; a static
token source feeds ``Provider.userinfo``.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Optional

from ..errors import InvalidParameterError
from ..utils.redact import RedactedString
from .id_token import IDToken

TOKEN_EXPIRY_SKEW = 10.0  # seconds


class AccessToken(RedactedString):
    redact_label = "access_token"


class RefreshToken(RedactedString):
    redact_label = "refresh_token"


class Token:
    """One authentication's tokens. id_token required; the rest optional."""

    def __init__(self, id_token: IDToken | str,
                 access_token: str = "", refresh_token: str = "",
                 expiry: float = 0.0,
                 now_func: Optional[Callable[[], float]] = None):
        self._id_token = (id_token if isinstance(id_token, IDToken)
                          else IDToken(id_token))
        if not self._id_token.reveal():
            raise InvalidParameterError("id_token is empty")
        self._access_token = AccessToken(access_token or "")
        self._refresh_token = RefreshToken(refresh_token or "")
        self._expiry = float(expiry or 0.0)
        self._now_func = now_func

    # -- accessors ---------------------------------------------------------

    def id_token(self) -> IDToken:
        return self._id_token

    def access_token(self) -> AccessToken:
        return self._access_token

    def refresh_token(self) -> RefreshToken:
        return self._refresh_token

    def expiry(self) -> float:
        """Unix seconds; 0 means no known expiry."""
        return self._expiry

    # -- state -------------------------------------------------------------

    def _now(self) -> float:
        return self._now_func() if self._now_func is not None else _time.time()

    def is_expired(self) -> bool:
        """True if the access token is expired (or absent)."""
        if not self._access_token.reveal():
            return True
        if self._expiry == 0:
            return False
        return self._expiry < self._now() + TOKEN_EXPIRY_SKEW

    def valid(self) -> bool:
        """True if there is an unexpired access token."""
        if not self._access_token.reveal():
            return False
        return not self.is_expired()

    def static_token_source(self):
        """A token source that always returns this token's access token
        (for UserInfo); None when there is no access token."""
        if not self._access_token.reveal():
            return None
        token = self._access_token

        class _Static:
            def token(self) -> AccessToken:
                return token

        return _Static()

    def __repr__(self) -> str:
        return (f"Token(id_token={self._id_token!r}, "
                f"access_token={self._access_token!r}, "
                f"refresh_token={self._refresh_token!r})")
