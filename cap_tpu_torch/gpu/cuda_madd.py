"""One ladder window's mixed add: the hand-written CUDA kernel and its
plain PyTorch version.

``madd(ctx, X, Y, Z, inf, has, x2p, y2p)`` runs what the JAX package's
``pallas_madd._madd_kernel`` runs: unpack the packed A|B<<16 table
words, the Jacobian + affine mixed add (11 RNS multiplies, lazy adds
and subs), the same-x degeneracy probe (20 candidates on 2 channels),
and the infinity lift and digit-0 select. X/Y/Z: (A [I_A, N],
B [I_B, N]) int32 pairs; x2p/y2p: packed [max(I_A, I_B), N] int32;
inf/has: [N] bool. Returns (X', Y', Z', deg [N] bool).

On a CUDA tensor it launches ``csrc/madd.cu`` (or raises); on a CPU
tensor it runs :func:`madd_ref`. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_redc

launches = 0


def madd_ref(ctx, X, Y, Z, inf, has, x2p, y2p):
    """Plain PyTorch mixed add: ``ec_rns._madd_rns`` over the plain REDC,
    then the lift/select bookkeeping of the ladder."""
    from .ec_rns import _madd_rns, rsel, unpack_pt

    ia, ib = ctx.A.count, ctx.B.count
    x2 = unpack_pt(x2p, ia, ib)
    y2 = unpack_pt(y2p, ia, ib)
    X3, Y3, Z3, dd = _madd_rns(ctx, X, Y, Z, inf, x2, y2,
                               redc=cuda_redc.redc_ref)
    lift = inf & has
    one = ctx.device_consts(x2p.device).one
    X3 = rsel(lift, x2, X3)
    Y3 = rsel(lift, y2, Y3)
    Z3 = rsel(lift, (one[0].expand_as(Z3[0]), one[1].expand_as(Z3[1])), Z3)
    return (rsel(has, X3, X), rsel(has, Y3, Y), rsel(has, Z3, Z),
            dd & has)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("madd")
        vp = ctypes.c_void_p
        lib.cap_madd.argtypes = [vp] * 18 + [ctypes.c_int] * 4 + [vp]
        lib.cap_madd.restype = ctypes.c_int
        _lib = lib
    return _lib


def madd(ctx, X, Y, Z, inf, has, x2p, y2p):
    global launches
    if x2p.device.type == "cpu":
        return madd_ref(ctx, X, Y, Z, inf, has, x2p, y2p)
    if x2p.device.type != "cuda":
        raise ValueError(f"unsupported device {x2p.device}")
    cuda_redc.check_shape(ctx)
    ia, ib = ctx.A.count, ctx.B.count
    iap = max(ia, ib)
    dev = x2p.device
    n = x2p.shape[1] if x2p.dim() == 2 else -1
    cuda_redc.check_planes(
        (X[0], X[1], Y[0], Y[1], Z[0], Z[1], x2p, y2p),
        (ia, ib, ia, ib, ia, ib, iap, iap), dev, n)
    for m in (inf, has):
        if m.device != dev or m.dtype != torch.bool or \
                tuple(m.shape) != (n,) or not m.is_contiguous():
            raise ValueError(f"inf/has must be contiguous bool [{n}] on "
                             f"{dev}")
    consts = cuda_redc.kernel_consts(ctx, dev)
    outs = [torch.empty_like(t) for t in (X[0], X[1], Y[0], Y[1],
                                          Z[0], Z[1])]
    deg = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return (outs[0], outs[1]), (outs[2], outs[3]), \
            (outs[4], outs[5]), deg
    rc = _kernel().cap_madd(
        X[0].data_ptr(), X[1].data_ptr(), Y[0].data_ptr(),
        Y[1].data_ptr(), Z[0].data_ptr(), Z[1].data_ptr(),
        x2p.data_ptr(), y2p.data_ptr(), has.data_ptr(), inf.data_ptr(),
        *(o.data_ptr() for o in outs), deg.data_ptr(),
        consts.data_ptr(), consts.numel(), n, ia, ib,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"madd kernel launch failed: CUDA error {rc}")
    launches += 1
    return (outs[0], outs[1]), (outs[2], outs[3]), (outs[4], outs[5]), deg
