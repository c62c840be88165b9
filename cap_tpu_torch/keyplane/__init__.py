"""Keyplane: epoch-versioned JWKS distribution with hot key rotation.

The port of ``cap_tpu.keyplane``, the key-distribution control plane
at fleet scale:

- :mod:`cap_tpu_torch.keyplane.source` — where key material comes
  from (static file, remote JWKS URL, OIDC discovery);
- :mod:`cap_tpu_torch.keyplane.refresher` — epoch-versioned snapshots
  with jittered periodic refresh, singleflight on-miss refresh under a
  cooldown, and a TTL'd negative-kid cache;
- :mod:`cap_tpu_torch.keyplane.plane` — :class:`KeyPlaneKeySet`, the
  rotation-aware ``GPUBatchKeySet`` a fleet worker serves from;
- fleet propagation rides the CVB1 KEYS frame pair (types 11/12,
  :mod:`cap_tpu_torch.serve.protocol`) pushed by
  :meth:`cap_tpu_torch.fleet.pool.WorkerPool.push_keys`.

docs/KEYPLANE.md has the epoch model, the grace window and the wire
format.
"""

from .refresher import Refresher, Snapshot
from .source import (
    KeySource,
    OIDCDiscoverySource,
    RemoteJWKSSource,
    StaticFileSource,
    canonical_digest,
    source_for_spec,
)

__all__ = [
    "KeySource",
    "StaticFileSource",
    "RemoteJWKSSource",
    "OIDCDiscoverySource",
    "canonical_digest",
    "source_for_spec",
    "Refresher",
    "Snapshot",
    "KeyPlaneKeySet",
]


def __getattr__(name):
    # KeyPlaneKeySet pulls in the jwt stack (and torch) on use, not on
    # package import.
    if name == "KeyPlaneKeySet":
        from .plane import KeyPlaneKeySet

        return KeyPlaneKeySet
    raise AttributeError(name)
