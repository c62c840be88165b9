"""The verify service layer: a worker on the card behind a wire protocol.

The port of ``cap_tpu.serve``. Host applications (any language) talk
to a colocated verify worker that owns the card and the batched
keyset, over a length-prefixed binary protocol on TCP/UDS
(``protocol``, byte-equal to the JAX package's) or per-connection
shared-memory rings (``shm_ring``, ``shm_client``), through an
adaptive batcher (``batcher``) that trades p99 latency against batch
throughput, a verdict cache (``vcache``) and per-tenant admission
(``admission``, ``drr``). ``worker`` is the server, with a Python
serve chain and a native one (``native_serve``: C++ readers, writers
and a lock-free ring); ``client`` the Python client and
``native_client`` the C one.

The service never logs tokens, keys, or claims — telemetry records
only counts and timings.
"""

from .batcher import AdaptiveBatcher
from .client import VerifyClient
from .native_client import NativeVerifyClient
from .native_serve import NativeServeChain, NativeTelemetryPlane
from .shm_client import ShmVerifyClient
from .shm_ring import (RingConsumer, RingProducer, ShmFormatError,
                       ShmRegion, StaleGenerationError)
from .vcache import VerdictCache
from .worker import VerifyWorker

__all__ = ["AdaptiveBatcher", "NativeServeChain", "NativeTelemetryPlane",
           "NativeVerifyClient", "RingConsumer", "RingProducer",
           "ShmFormatError", "ShmRegion", "ShmVerifyClient",
           "StaleGenerationError", "VerdictCache", "VerifyClient",
           "VerifyWorker"]
