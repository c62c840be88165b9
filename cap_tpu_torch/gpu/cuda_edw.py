"""One Ed25519 ladder window: the hand-written CUDA kernel and its
plain PyTorch version.

``edw_window(ctx, X, Y, Z, T, tab, rows)`` adds to each lane's state
the table entry of its row and returns (X', Y', Z', T'): the gather
(``jnp.take`` of the window's rows in the JAX package's ladder) and
the mixed add that the JAX package's ``pallas_edw._edw_kernel`` runs,
the complete a = −1 extended + precomputed mixed add
(madd-2008-hwcd-3), 7 RNS multiplies and the lazy adds and subs — no
masks, no probe, no lift (the Edwards law is complete and the tables
hold the identity at digit 0). The state is (A [I_A, N], B [I_B, N])
int32 pairs; ``tab`` is ``Ed25519RNSKeyTable.device_tab``, [rows,
3·max(I_A, I_B)] int32, each row the triple (y−x, y+x, 2dxy) as packed
A|B<<16 words; ``rows`` is [N] int32.

On a CUDA tensor it launches ``csrc/edw.cu`` (or raises); on a CPU
tensor it runs :func:`edw_window_ref`. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_madd, cuda_redc
from .ec_rns import unpack_pt

launches = 0

# edw.cu is instantiated for the Ed25519 field's channel counts only.
KERNEL_SHAPES = ((23, 23),)


def edw_ref(ctx, X, Y, Z, T, ym, yp, t2):
    """Plain PyTorch mixed add of gathered table planes ym, yp, t2:
    ``ed25519_rns._edw_madd_rns`` over the plain REDC."""
    from .ed25519_rns import _edw_madd_rns

    return _edw_madd_rns(ctx, X, Y, Z, T, ym, yp, t2,
                         redc=cuda_redc.redc_ref)


def edw_window_ref(ctx, X, Y, Z, T, tab, rows):
    """Plain PyTorch window: gather the rows, unpack the triples into
    planes, :func:`edw_ref`."""
    ia, ib = ctx.A.count, ctx.B.count
    iap = max(ia, ib)
    g = tab.index_select(0, rows.to(torch.int64)).T    # [3·iap, N]
    ym, yp, t2 = (unpack_pt(g[k * iap:(k + 1) * iap], ia, ib)
                  for k in range(3))
    return edw_ref(ctx, X, Y, Z, T, ym, yp, t2)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("edw")
        vp = ctypes.c_void_p
        lib.cap_edw.argtypes = [vp] * 19 + [ctypes.c_int] * 4 + [vp]
        lib.cap_edw.restype = ctypes.c_int
        _lib = lib
    return _lib


def edw_window(ctx, X, Y, Z, T, tab, rows):
    global launches
    if X[0].device.type == "cpu":
        return edw_window_ref(ctx, X, Y, Z, T, tab, rows)
    if X[0].device.type != "cuda":
        raise ValueError(f"unsupported device {X[0].device}")
    cuda_redc.check_shape(ctx, KERNEL_SHAPES)
    ia, ib = ctx.A.count, ctx.B.count
    dev = X[0].device
    n = X[0].shape[1] if X[0].dim() == 2 else -1
    ins = [t for pair in (X, Y, Z, T) for t in pair]
    cuda_redc.check_planes(ins, (ia, ib) * 4, dev, n)
    width = 3 * max(ia, ib)
    if tab.device != dev or tab.dtype != torch.int32 or tab.dim() != 2 \
            or tab.shape[1] != width or not tab.is_contiguous():
        raise ValueError(f"tab must be a contiguous int32 [rows, {width}] "
                         f"tensor on {dev}")
    if rows.device != dev or rows.dtype != torch.int32 or \
            tuple(rows.shape) != (n,) or not rows.is_contiguous():
        raise ValueError(f"rows must be a contiguous int32 [{n}] tensor on "
                         f"{dev}")
    consts = cuda_madd.madd_consts(ctx, dev)
    outs = [torch.empty_like(t) for t in ins]
    if n == 0:
        return tuple(zip(outs[0::2], outs[1::2]))
    rc = _kernel().cap_edw(
        *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs),
        tab.data_ptr(), rows.data_ptr(), consts.data_ptr(), consts.numel(),
        n, ia, ib, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edw kernel launch failed: CUDA error {rc}")
    launches += 1
    return tuple(zip(outs[0::2], outs[1::2]))
