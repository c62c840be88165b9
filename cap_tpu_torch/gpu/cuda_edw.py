"""One Ed25519 ladder window's mixed add: the hand-written CUDA kernel
and its plain PyTorch version.

``edw(ctx, X, Y, Z, T, ym, yp, t2)`` runs what the JAX package's
``pallas_edw._edw_kernel`` runs: the complete a = −1 extended +
precomputed mixed add (madd-2008-hwcd-3), 7 RNS multiplies and the
lazy adds and subs — no masks, no probe, no lift (the Edwards law is
complete and the tables hold the identity at digit 0). Every operand
is an (A [I_A, N], B [I_B, N]) int32 pair; the table triples arrive
gathered. Returns (X', Y', Z', T').

On a CUDA tensor it launches ``csrc/edw.cu`` (or raises); on a CPU
tensor it runs :func:`edw_ref`. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_redc

launches = 0

# edw.cu is instantiated for the Ed25519 field's channel counts only.
KERNEL_SHAPES = ((23, 23),)


def edw_ref(ctx, X, Y, Z, T, ym, yp, t2):
    """Plain PyTorch mixed add: ``ed25519_rns._edw_madd_rns`` over the
    plain REDC."""
    from .ed25519_rns import _edw_madd_rns

    return _edw_madd_rns(ctx, X, Y, Z, T, ym, yp, t2,
                         redc=cuda_redc.redc_ref)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("edw")
        vp = ctypes.c_void_p
        lib.cap_edw.argtypes = [vp] * 23 + [ctypes.c_int] * 4 + [vp]
        lib.cap_edw.restype = ctypes.c_int
        _lib = lib
    return _lib


def edw(ctx, X, Y, Z, T, ym, yp, t2):
    global launches
    if X[0].device.type == "cpu":
        return edw_ref(ctx, X, Y, Z, T, ym, yp, t2)
    if X[0].device.type != "cuda":
        raise ValueError(f"unsupported device {X[0].device}")
    cuda_redc.check_shape(ctx, KERNEL_SHAPES)
    ia, ib = ctx.A.count, ctx.B.count
    dev = X[0].device
    n = X[0].shape[1] if X[0].dim() == 2 else -1
    ins = [t for pair in (X, Y, Z, T, ym, yp, t2) for t in pair]
    cuda_redc.check_planes(ins, (ia, ib) * 7, dev, n)
    consts = cuda_redc.kernel_consts(ctx, dev)
    outs = [torch.empty_like(t) for t in ins[:8]]
    if n == 0:
        return tuple(zip(outs[0::2], outs[1::2]))
    rc = _kernel().cap_edw(
        *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs),
        consts.data_ptr(), consts.numel(), n, ia, ib,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edw kernel launch failed: CUDA error {rc}")
    launches += 1
    return tuple(zip(outs[0::2], outs[1::2]))
