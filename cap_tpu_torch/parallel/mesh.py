"""Device meshes and the sharded verification steps.

The port of ``cap_tpu.parallel.mesh``. A :class:`Mesh` is a 1-D row of
devices (``cuda:0`` … ``cuda:n−1`` by :func:`make_mesh`); a batch
shards along its batch axis over the mesh in equal, ordered shards
(:func:`.place.shard_batch`) and the key tables replicate on every
mesh device (:func:`.place.replicated`). Where the JAX package
``shard_map``s one jitted program, each shard's core here runs on its
own device, every shard dispatched before any is read; the verdicts
come back in batch order and the ``psum`` total is their sum.

A mesh's devices may repeat (``Mesh([cuda:0, cuda:0])``, or
``make_mesh(8, device="cpu")``): the shards then share a device, the
counterpart of the JAX suite's eight virtual host devices, so one card
or the CPU can drive every sharded path. The batch axis must be a
multiple of the mesh size (the keyset's chunk pads are powers of two,
so any power-of-two mesh divides them).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..gpu import bignum
from .place import Sharded, on_shards, replicated, shard_batch

DP_AXIS = "dp"


class Mesh:
    """A 1-D mesh: ``devices`` (torch devices, repeats allowed) along
    the one axis ``axis_names[0]``, the batch axis."""

    def __init__(self, devices: Sequence, axis_names=(DP_AXIS,)):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)

    def distinct(self) -> tuple:
        """The mesh's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_names[0]!r}: {len(self.devices)}, "
                f"devices=[{', '.join(str(d) for d in self.devices)}])")


def make_mesh(n_devices: Optional[int] = None, axis: str = DP_AXIS,
              device: str = "cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` cards (``cuda:0`` …), all of
    them by default.

    ``device="cpu"``: ``n_devices`` (1 by default) shards on the CPU,
    where the kernels' plain versions run. Raises ``ValueError`` when
    asked for more cards than there are, ``RuntimeError`` without CUDA
    unless ``device="cpu"``.
    """
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"requested {n} devices")
        return Mesh(["cpu"] * n, (axis,))
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; make_mesh takes the "
                           "cards unless device='cpu' is given")
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if n < 1:
        raise ValueError(f"requested {n} devices")
    return Mesh([f"cuda:{i}" for i in range(n)], (axis,))


def _limbs(a) -> object:
    """A host limb array as int64 (the port's limb dtype); Sharded and
    tensors pass as they are."""
    if isinstance(a, Sharded) or torch.is_tensor(a):
        return a
    import numpy as np

    return np.asarray(a).astype(np.int64)


def _placed(mesh: Mesh, a, axis: int) -> Sharded:
    return a if isinstance(a, Sharded) else shard_batch(mesh, a, axis)


def _rs256_core(s, n, nprime, r2, expected):
    """Per-shard RS* verify core: modexp + EM compare + range check.

    All inputs are [K, Nl] limb-first tensors of the shard. Returns the
    shard's [Nl] bool verdicts and its count of valid tokens.
    """
    s, n, nprime, r2, expected = (t.to(torch.int64) for t in (
        s, n, nprime, r2, expected))
    em = bignum.modexp_65537(s, n, nprime, r2)
    ok = (em == expected).all(dim=0) & ~bignum.compare_ge(s, n)
    return ok, ok.sum()


def _gather_total(mesh: Mesh, ok: Sharded, counts: Sharded):
    """(ok [N] in batch order, total): the shards' verdicts and the sum
    of their counts (the ``psum``), both on the mesh's first device."""
    dev0 = mesh.devices[0]
    total = sum(c.to(dev0) for c in counts.parts)
    return ok.to(dev0), total


def sharded_rs256_verify(mesh: Mesh):
    """The multi-device RS256 verify step for ``mesh``.

    Returns fn(s, n, nprime, r2, expected) -> (ok [N] bool, total) with
    every [K, N] operand (host arrays, or :class:`.place.Sharded` from
    :func:`shard_batch_arrays`) sharded over the batch axis: each
    device receives its token shard's operands directly.
    """
    def fn(s, n, nprime, r2, expected):
        args = [_placed(mesh, _limbs(a), 1) for a in (s, n, nprime, r2,
                                                      expected)]
        ok, counts = on_shards(mesh, lambda i, *p: _rs256_core(*p), *args)
        return _gather_total(mesh, ok, counts)

    return fn


def sharded_verify_step(mesh: Mesh):
    """The full multi-device batch-verify step: key gather + modexp +
    check.

    fn(n_tab, np_tab, r2_tab, key_idx, s, expected): the [nk, K] tables
    are replicated on every mesh device; key_idx [N], s [K, N] and
    expected [K, N] are sharded over the batch axis. The gather of each
    token's key row runs on its shard's device.
    """
    def fn(n_tab, np_tab, r2_tab, key_idx, s, expected):
        tabs = [replicated(mesh, _to_tensor(_limbs(t)))
                for t in (n_tab, np_tab, r2_tab)]
        idx = _placed(mesh, _limbs(key_idx), 0)
        s_d = _placed(mesh, _limbs(s), 1)
        e_d = _placed(mesh, _limbs(expected), 1)

        def shard(i, ki, si, ei):
            n, nprime, r2 = (t[i][ki.to(torch.int64)].T for t in tabs)
            return _rs256_core(si, n, nprime, r2, ei)

        ok, counts = on_shards(mesh, shard, idx, s_d, e_d)
        return _gather_total(mesh, ok, counts)

    return fn


def _to_tensor(a):
    return a if torch.is_tensor(a) else torch.from_numpy(a)


def sharded_rns_verify_step(mesh: Mesh, ctx):
    """Multi-device RS256 verify on the RNS engine.

    fn(s_limbs, expected, sig_c, n_B, a2_A, a2_B) → (ok [N], total):
    every operand is [·, N], sharded over the batch axis; the RNS
    context's constants are built once on each mesh device
    (``ctx.device_consts``).
    """
    from ..gpu import rns

    def fn(s_limbs, expected, sig_c, n_B, a2_A, a2_B):
        limbs = [_placed(mesh, _limbs(a), 1) for a in (s_limbs, expected)]
        res = [_placed(mesh, _residues(a), 1) for a in (sig_c, n_B, a2_A,
                                                       a2_B)]

        def shard(i, s, e, *keys):
            ok = rns._rns_verify_core(ctx, s.to(torch.int64),
                                      e.to(torch.int64),
                                      *(k.to(torch.int32) for k in keys))
            return ok, ok.sum()

        ok, counts = on_shards(mesh, shard, *limbs, *res)
        return _gather_total(mesh, ok, counts)

    return fn


def _residues(a):
    """Residue rows as int32 (the port's RNS dtype)."""
    if isinstance(a, Sharded) or torch.is_tensor(a):
        return a
    import numpy as np

    return np.asarray(a).astype(np.int32)


def shard_batch_arrays(mesh: Mesh, *arrays):
    """Place [.., N]-batch arrays with their natural sharding on
    ``mesh``: ndim 1 shards over the batch axis on axis 0, ndim 2
    ([K, N]) on axis 1. Returns :class:`.place.Sharded` values."""
    return tuple(shard_batch(mesh, a, 0 if a.ndim == 1 else 1)
                 for a in arrays)
