"""The verify service layer: a worker on the card behind a wire protocol.

The port of ``cap_tpu.serve``'s Python serve chain. Host applications
(any language) talk to a colocated verify worker that owns the card
and the batched keyset, over a length-prefixed binary protocol on
TCP/UDS (``protocol``, byte-equal to the JAX package's), through an
adaptive batcher (``batcher``) that trades p99 latency against batch
throughput, a verdict cache (``vcache``) and per-tenant admission
(``admission``, ``drr``). ``worker`` is the server; ``client`` the
Python client.

The service never logs tokens, keys, or claims — telemetry records
only counts and timings.
"""

from .batcher import AdaptiveBatcher
from .client import VerifyClient
from .vcache import VerdictCache
from .worker import VerifyWorker

__all__ = ["AdaptiveBatcher", "VerdictCache", "VerifyClient",
           "VerifyWorker"]
