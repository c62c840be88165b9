"""Success and error response callables of the callback handlers:

- ``success_fn(state, token, environ) -> (status, headers, body)``
- ``error_fn(state, error_response, exception, environ)
  -> (status, headers, body)``

where ``error_response`` is the IdP's OAuth error (when the IdP
redirected with error parameters) and ``exception`` a local callback
failure; exactly one of the two is set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class AuthenErrorResponse:
    """OAuth 2.0 error response parameters from the IdP."""

    error: str
    description: str = ""
    uri: str = ""
