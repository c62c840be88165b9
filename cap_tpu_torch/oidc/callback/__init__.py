"""HTTP callback handlers for OIDC responses: the authorization-code
and implicit handler factories (WSGI applications), the RequestReader
lookup keyed by state, and the IdP's error response.
"""

from .authcode import auth_code
from .implicit import implicit
from .request_reader import RequestReader, SingleRequestReader
from .response_func import AuthenErrorResponse

__all__ = [
    "auth_code", "implicit",
    "RequestReader", "SingleRequestReader", "AuthenErrorResponse",
]
