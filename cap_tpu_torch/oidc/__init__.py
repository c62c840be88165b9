"""OIDC relying party: the port of the JAX package's ``oidc`` package.

Config, Provider (discovery, auth_url, exchange, verify_id_token,
userinfo), Request, Token, IDToken with at_hash/c_hash verification,
PKCE S256, state and nonce generation, prompts and displays, and the
redacting secret types. A Provider over a
:class:`~cap_tpu_torch.jwt.gpu_keyset.GPUBatchKeySet` verifies a batch
of ID tokens on the card (``verify_id_token_batch``), its raw mode
deciding the claims rules in the native engine
(:mod:`.claims_native`). ``callback`` has the WSGI callback handlers,
``testing`` the in-process TLS IdP.
"""

from .config import ClientSecret, Config
from .display import Display
from .id import DEFAULT_ID_LENGTH, new_id
from .id_token import IDToken
from .pkce import CodeVerifier, S256Verifier, create_code_challenge
from .prompt import Prompt
from .provider import Provider
from .request import REQUEST_EXPIRY_SKEW, Request
from .serve_keyset import OIDCRawKeySet
from .token import TOKEN_EXPIRY_SKEW, AccessToken, RefreshToken, Token

__all__ = [
    "ClientSecret", "Config", "Display", "DEFAULT_ID_LENGTH", "new_id",
    "IDToken", "CodeVerifier", "S256Verifier", "create_code_challenge",
    "Prompt", "Provider", "OIDCRawKeySet", "REQUEST_EXPIRY_SKEW",
    "Request", "TOKEN_EXPIRY_SKEW", "AccessToken", "RefreshToken",
    "Token",
]
