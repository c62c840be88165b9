"""JWT verification: the port of the JAX package's ``jwt`` surface.

- :class:`Alg` registry and :func:`supported_signing_algorithm`
- JOSE parsing (:func:`parse_jws` and the compact/JSON forms)
- :class:`KeySet` with :class:`StaticKeySet`, :class:`JSONWebKeySet`,
  :func:`new_oidc_discovery_keyset` (CPU, on the pure-integer oracle)
- :class:`Validator` / :class:`Expected` claims engine
- :func:`parse_public_key_pem`
- the batched keyset on the card: :class:`GPUBatchKeySet`, and
  :class:`GPURemoteKeySet` over a remote JWKS
"""

from .algs import (
    Alg,
    RS256, RS384, RS512, ES256, ES384, ES512, PS256, PS384, PS512, EdDSA,
    MLDSA44, MLDSA65, MLDSA87, MLDSA_ALGORITHMS,
    SUPPORTED_ALGORITHMS,
    supported_signing_algorithm,
)
from .gpu_keyset import GPUBatchKeySet, GPURemoteKeySet
from .jose import (
    ParsedJWS, json_to_compact, parse_compact, parse_json, parse_jws,
)
from .keyset import (
    JSONWebKeySet, KeySet, StaticKeySet, new_oidc_discovery_keyset,
)
from .pem import parse_public_key_pem
from .validator import DEFAULT_LEEWAY_SECONDS, Expected, Validator

__all__ = [
    "Alg", "RS256", "RS384", "RS512", "ES256", "ES384", "ES512",
    "PS256", "PS384", "PS512", "EdDSA",
    "MLDSA44", "MLDSA65", "MLDSA87", "MLDSA_ALGORITHMS",
    "SUPPORTED_ALGORITHMS",
    "supported_signing_algorithm",
    "ParsedJWS", "parse_compact", "parse_json", "parse_jws",
    "json_to_compact", "parse_public_key_pem",
    "KeySet", "StaticKeySet", "JSONWebKeySet", "new_oidc_discovery_keyset",
    "DEFAULT_LEEWAY_SECONDS", "Expected", "Validator", "GPUBatchKeySet",
    "GPURemoteKeySet",
]
