"""Placements for the port: fleet workers on cards, and batches on a mesh.

The port of ``cap_tpu.parallel.place``:

- single-owner placement of fleet workers: every card belongs to
  EXACTLY ONE worker process, expressed as subprocess environment
  rather than runtime cooperation, so ownership is enforced by process
  isolation;
- the two placements of a meshed verify (:mod:`.mesh`): a batch
  sharded along its axis 0 (:func:`shard_batch`, equal shards in order,
  one a mesh device) and a table replicated on every mesh device
  (:func:`replicated`, cached per (mesh, tensor) under a byte-bounded
  LRU). Where the JAX package lets GSPMD partition one program, the
  port runs one copy of the engine's core a shard on the shard's
  device (:func:`on_shards`), each shard dispatched before any is
  read, and gives the outputs back as :class:`Sharded` values.
"""

from __future__ import annotations

import copy
import inspect
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry

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


# ---------------------------------------------------------------------------
# Batches on a mesh
# ---------------------------------------------------------------------------

# The LRU bound of the replicated-table cache, in MB (the JAX package
# reads CAP_TPU_REPLICATED_CACHE_MB; here it is ``replicated``'s
# ``cache_mb`` keyword).
REPLICATED_CACHE_MB = 1024

# (id(mesh), id(tensor)) → (mesh, tensor, copies). The STRONG refs to
# the keying objects make id-aliasing impossible while an entry lives
# (a rebuilt key table can never be served another table's copies),
# and the LRU bound keeps dropped keysets from pinning device memory.
# It is bounded by bytes, not entries: tables range from a few KB to
# hundreds of MB (12-bit EC windows), so a count bound either evicts a
# live working set or pins GBs of dropped keysets' copies. The
# ``parallel.replicated_evictions`` counter ticking under load is the
# thrash signal.
_replicated_cache: "OrderedDict[Tuple[int, int], Any]" = OrderedDict()
_replicated_cache_bytes = 0
# replicated() is called concurrently (the serve dispatcher and user
# threads on one mesh); every cache mutation happens under this lock.
_cache_lock = threading.Lock()


def _nbytes(t) -> int:
    if torch.is_tensor(t):
        return t.numel() * t.element_size()
    return int(getattr(t, "nbytes", 0) or 0)


def _as_tensor(a) -> torch.Tensor:
    """A host array as a tensor (uint32 lanes as their int32 bit
    patterns, the port's layout of every Keccak lane)."""
    if torch.is_tensor(a):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


class Sharded:
    """A batch split over a mesh: ``parts[i]`` lives on
    ``mesh.devices[i]`` and holds the i-th equal slice of the batch
    along ``axis``. ``cpu()`` gathers the parts in batch order (the
    one sync of a meshed chunk's verdicts)."""

    def __init__(self, mesh, parts: Sequence[torch.Tensor], axis: int = 0):
        self.mesh = mesh
        self.parts = tuple(parts)
        self.axis = axis

    @property
    def shape(self) -> Tuple[int, ...]:
        shape = list(self.parts[0].shape)
        shape[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return tuple(shape)

    def cpu(self) -> torch.Tensor:
        return torch.cat([p.cpu() for p in self.parts], dim=self.axis)

    def to(self, device) -> torch.Tensor:
        """The whole batch on one device, in batch order."""
        return torch.cat([p.to(device) for p in self.parts], dim=self.axis)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, axis={self.axis}, "
                f"devices={[str(p.device) for p in self.parts]})")


def batch_axis(mesh) -> str:
    """The mesh axis the batch shards over (its first axis)."""
    return mesh.axis_names[0]


def shard_bounds(mesh, n: int, axis: int = 0,
                 shape: Optional[Tuple[int, ...]] = None) -> List[slice]:
    """The mesh positions' slices of a batch of ``n`` rows: equal and in
    order. Raises the JAX package's ``ValueError`` when the mesh size
    does not divide ``n``."""
    size = len(mesh.devices)
    if n % size:
        full = tuple(shape) if shape is not None else (n,)
        raise ValueError(
            f"One of device_put args was given the sharding of {mesh!r} "
            f"along axis {axis} ({batch_axis(mesh)!r}), which implies that "
            f"the global size of its dimension {axis} should be divisible "
            f"by {size}, but it is equal to {n} (full shape: {full})")
    step = n // size
    return [slice(i * step, (i + 1) * step) for i in range(size)]


def shard_batch(mesh, arr, axis: int = 0) -> Sharded:
    """A host array (or a tensor) split along ``axis`` into equal
    shards, one a mesh device in mesh order, each copied to its
    device. A batch already sharded over ``mesh`` along ``axis`` is
    returned as it is."""
    if isinstance(arr, Sharded):
        if arr.mesh is not mesh or arr.axis != axis:
            raise ValueError(f"{arr!r} is not sharded over {mesh!r} along "
                             f"axis {axis}")
        return arr
    t = _as_tensor(arr)
    bounds = shard_bounds(mesh, t.shape[axis], axis, tuple(t.shape))
    parts = []
    for dev, sl in zip(mesh.devices, bounds):
        idx = (slice(None),) * axis + (sl,)
        parts.append(t[idx].contiguous().to(dev))
    return Sharded(mesh, parts, axis)


def broadcast(mesh, arr) -> Tuple[torch.Tensor, ...]:
    """One copy of a host array (or a tensor) a mesh device, uncached:
    positions on one device share its copy, and a device that holds the
    tensor already uses it as it is."""
    src = _as_tensor(arr)
    by_dev: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in by_dev:
            by_dev[dev] = src.to(dev)
    return tuple(by_dev[dev] for dev in mesh.devices)


def replicated(mesh, tensor, cache_mb: int = REPLICATED_CACHE_MB
               ) -> Tuple[torch.Tensor, ...]:
    """One copy of ``tensor`` a mesh device (positions on one device
    share its copy, and a device that holds the tensor already uses it
    as it is), cached per (mesh, tensor).

    The cache holds strong references to the mesh and the tensor, so
    an entry can never be aliased by id reuse after garbage collection;
    an LRU bounded by ``cache_mb`` MB of source bytes evicts the copies
    of dropped keysets (counted in ``parallel.replicated_evictions``).
    """
    global _replicated_cache_bytes
    key = (id(mesh), id(tensor))
    with _cache_lock:
        hit = _replicated_cache.get(key)
        if hit is not None:
            _replicated_cache.move_to_end(key)
            return hit[2]
    out = broadcast(mesh, tensor)
    with _cache_lock:
        # a concurrent caller may have inserted the same key meanwhile:
        # keep (and return) the first copies, so every shard reads one
        # buffer
        hit = _replicated_cache.get(key)
        if hit is not None:
            _replicated_cache.move_to_end(key)
            return hit[2]
        _replicated_cache[key] = (mesh, tensor, out)
        _replicated_cache_bytes += _nbytes(tensor)
        limit = int(cache_mb) << 20
        while _replicated_cache_bytes > limit and len(_replicated_cache) > 1:
            _, (_, old, _) = _replicated_cache.popitem(last=False)
            _replicated_cache_bytes -= _nbytes(old)
            telemetry.count("parallel.replicated_evictions")
    return out


def replicated_views(mesh, table, names: Sequence[str]) -> List[Any]:
    """One shallow copy of a key table a mesh position, its tensors
    ``names`` replaced by their :func:`replicated` copies on that
    position's device and its ``device`` attribute (where it has one of
    its own) set to it. Caches the table shares by reference (RNS
    contexts and key tables, built once a device) serve every view; an
    attribute a view would set lazily is lost with it, so a table with
    lazy state is not given views (the EC and Ed25519 engines read their
    window tables where the shard's tensors live)."""
    reps = {n: replicated(mesh, getattr(table, n)) for n in names}
    views = []
    for i, dev in enumerate(mesh.devices):
        view = copy.copy(table)
        for n in names:
            setattr(view, n, reps[n][i])
        if "device" in vars(table):
            view.device = dev
        views.append(view)
    return views


def on_shards(mesh, fn: Callable, *sharded: Sharded):
    """``fn(i, *parts)`` at every mesh position i over the positions'
    parts of ``sharded``, every position dispatched before any output
    is read (the cards overlap); returns the outputs as :class:`Sharded`
    (a tuple of them where ``fn`` returns a tuple). A core that reads
    the device part-way (the ES and Ed25519 batch inverses' host
    ``pow``) is a generator that yields before each read
    (``gpu.bignum.run_steps``): the shards advance in turns, each to
    its next read, so every shard's work up to a read is queued before
    the first shard reads. A shard that raises raises here: nothing is
    re-run elsewhere."""
    outs = [fn(i, *(s.parts[i] for s in sharded))
            for i in range(len(mesh.devices))]
    live = [i for i, o in enumerate(outs) if inspect.isgenerator(o)]
    gens = {i: outs[i] for i in live}
    while live:
        still = []
        for i in live:
            try:
                next(gens[i])
                still.append(i)
            except StopIteration as stop:
                outs[i] = stop.value
        live = still
    if isinstance(outs[0], tuple):
        return tuple(Sharded(mesh, [o[j] for o in outs])
                     for j in range(len(outs[0])))
    return Sharded(mesh, outs)
