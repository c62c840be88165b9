"""Single-owner placement of fleet workers on cards.

The port of the placement half of ``cap_tpu.parallel.place``: every
card belongs to EXACTLY ONE worker process, expressed as subprocess
environment rather than runtime cooperation, so ownership is enforced
by process isolation. ``shard_batch`` and ``replicated`` (the mesh
half) are not ported yet (ROADMAP A item 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

PLATFORMS = ("cuda", "cpu")


class PlacementError(ValueError):
    """A fleet placement violates the single-owner-per-device model."""


@dataclass(frozen=True)
class WorkerPlacement:
    """One worker process's exclusive device group.

    - ``platform="cuda"``: ``CUDA_VISIBLE_DEVICES`` restricts the child
      to its card group and the worker runs ``--device cuda``; two
      owners of one card are refused (:func:`assert_single_owner`);
    - ``platform="cpu"``: ``CUDA_VISIBLE_DEVICES=""`` hides every card
      from the child and the worker runs ``--device cpu`` (the kernels'
      plain versions), so a CPU worker cannot touch a card. CPU
      workers own no card: their ``device_ids`` are slots, disjoint
      among the CPU workers only.
    """

    worker_id: int
    device_ids: Tuple[int, ...]
    platform: str = "cuda"

    def __post_init__(self):
        if self.platform not in PLATFORMS:
            raise PlacementError(
                f"unknown platform {self.platform!r} (one of "
                f"{', '.join(PLATFORMS)})")

    def env(self) -> Dict[str, str]:
        """Environment overrides for the worker subprocess."""
        if self.platform == "cuda":
            return {"CUDA_VISIBLE_DEVICES":
                    ",".join(str(d) for d in self.device_ids)}
        return {"CUDA_VISIBLE_DEVICES": ""}

    def args(self) -> List[str]:
        """``worker_main`` flags for the worker subprocess."""
        return ["--device", self.platform]


def single_owner_placement(n_workers: int, n_devices: int,
                           platform: str = "cuda",
                           devices_per_worker: Optional[int] = None,
                           ) -> List[WorkerPlacement]:
    """Partition ``n_devices`` into disjoint contiguous groups, one per
    worker — no device is ever assigned twice (card sharing between
    processes is the failure mode this model exists to forbid).

    ``devices_per_worker`` defaults to an even split; the placement is
    rejected (:class:`PlacementError`) if it would overcommit.
    """
    if n_workers < 1:
        raise PlacementError(f"need at least one worker, got {n_workers}")
    if devices_per_worker is None:
        devices_per_worker = n_devices // n_workers
    if devices_per_worker < 1:
        raise PlacementError(
            f"{n_workers} workers over {n_devices} devices leaves some "
            "worker with no device (single-owner placement cannot share)")
    if n_workers * devices_per_worker > n_devices:
        raise PlacementError(
            f"{n_workers} workers x {devices_per_worker} devices = "
            f"{n_workers * devices_per_worker} > {n_devices} available: "
            "refusing to double-book a device")
    placements = [
        WorkerPlacement(
            worker_id=w,
            device_ids=tuple(range(w * devices_per_worker,
                                   (w + 1) * devices_per_worker)),
            platform=platform)
        for w in range(n_workers)
    ]
    assert_single_owner(placements)
    return placements


def assert_single_owner(placements: List[WorkerPlacement]) -> None:
    """Raise :class:`PlacementError` if any device has two owners. A
    CPU placement owns no card: its slots conflict only with another
    CPU placement's."""
    owner: Dict[Tuple[str, int], int] = {}
    for p in placements:
        for d in p.device_ids:
            if (p.platform, d) in owner:
                raise PlacementError(
                    f"device {d} owned by both worker "
                    f"{owner[(p.platform, d)]} and worker {p.worker_id}")
            owner[(p.platform, d)] = p.worker_id
