"""Multi-device execution and fleet placement.

The port of ``cap_tpu.parallel``. The parallelism axes of a batched
verify:

- ``dp``: data parallelism over the token batch: each device verifies
  a shard of the tokens (:func:`make_mesh`, the sharded steps, and the
  engines' and ``GPUBatchKeySet``'s ``mesh=``). Tokens are independent,
  so no device waits on another in the hot loop;
- key gather: per-token kid indices gather rows from the key tables,
  which are small and replicated on every device, so the gather stays
  local.

The verdict reduction (the count of valid tokens) is the ``psum`` of
the shards' counts. :mod:`.place` also holds the single-owner
placement of fleet workers on cards.
"""

from .mesh import (  # noqa: F401
    make_mesh,
    sharded_rs256_verify,
    sharded_verify_step,
)
from .place import (  # noqa: F401
    PlacementError,
    WorkerPlacement,
    assert_single_owner,
    single_owner_placement,
)

__all__ = ["make_mesh", "sharded_rs256_verify", "sharded_verify_step",
           "PlacementError", "WorkerPlacement", "assert_single_owner",
           "single_owner_placement"]
