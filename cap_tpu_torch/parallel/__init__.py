"""Placement of fleet workers on cards: single-owner device groups.

The port of the placement half of ``cap_tpu.parallel``
(:mod:`cap_tpu_torch.parallel.place`). The mesh half — batches sharded
over several cards with the tables replicated — is not ported yet
(ROADMAP A item 10).
"""

from .place import (  # noqa: F401
    PlacementError,
    WorkerPlacement,
    assert_single_owner,
    single_owner_placement,
)

__all__ = ["PlacementError", "WorkerPlacement", "assert_single_owner",
           "single_owner_placement"]
