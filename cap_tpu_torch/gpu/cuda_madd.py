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

The mixed-add kernels (``madd.cu`` and the whole ladder's ``ladder.cu``)
read their per-context constants from ONE int32 buffer
(:func:`madd_consts`), laid out as ``KLayout<IA, IB>`` in
``csrc/rns_int.cuh``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_redc
from .rns import _ext_matrix

launches = 0

PROBE_C = 20          # same-x probe candidates (c·p rows 0..19)
PAD_M = 8191          # the modulus of a padding channel (prime, < 2^13)


def _round_up(v: int, k: int) -> int:
    return (v + k - 1) // k * k


def madd_layout(ia: int, ib: int) -> dict:
    """Word offsets of ``KLayout<ia, ib>`` (csrc/rns_int.cuh): name →
    (offset, shape). Per-channel vectors hold PA = ⌈ia⌉₈ (or PB)
    entries, weight rows SA = ⌈ia⌉₄ (or SB)."""
    pa, pb = _round_up(ia, 8), _round_up(ib, 8)
    sa, sb = _round_up(ia, 4), _round_up(ib, 4)
    names = ([(n, (pa,)) for n in ("mA", "muA", "invA", "sigc", "negBA",
                                    "oneA", "k16A", "k4A", "k8A")]
             + [(n, (pb,)) for n in ("mB", "muB", "invB", "pB", "invab",
                                      "invmib", "negAB", "oneB", "k16B",
                                      "k4B", "k8B")]
             + [("wAB", (pb, sa)), ("wBA", (pa, sb)), ("probe", (PROBE_C, 2))])
    out, off = {}, 0
    for name, shape in names:
        out[name] = (off, shape)
        off += int(np.prod(shape))
    out["words"] = (off, ())
    return out


def madd_consts(ctx, device) -> torch.Tensor:
    """The context's constants as the mixed-add kernels' int32 buffer on
    ``device`` (order, sizes and padding: ``madd_layout``). Whole
    extension weights (A/a_i mod b_j, not 7-bit halves), Barrett
    constants μ = ⌊2^32/m⌋, the α corrections as (−A) mod b_j and
    (−B) mod a_i, and the three rsub constants c·p + g·m the mixed add
    uses."""
    device = torch.device(device)
    cache = ctx.__dict__.setdefault("_madd_consts", {})
    hit = cache.get(device)
    if hit is not None:
        return hit
    ia, ib = ctx.A.count, ctx.B.count
    lay = madd_layout(ia, ib)
    buf = np.zeros(lay["words"][0], np.int64)
    mA = np.asarray(ctx.A.m, np.int64)
    mB = np.asarray(ctx.B.m, np.int64)
    one = ctx.a_mod_p
    cpA = np.asarray(ctx.cp_A, np.int64)
    cpB = np.asarray(ctx.cp_B, np.int64)

    def f32(a):
        return np.asarray(a, np.float32).view(np.int32)

    def put(name, vals, fill=0):
        off, shape = lay[name]
        block = np.full(shape, fill, np.int64)
        vals = np.asarray(vals, np.int64)
        block[tuple(slice(0, d) for d in vals.shape)] = vals
        buf[off:off + block.size] = block.ravel()

    for side, m in (("A", mA), ("B", mB)):
        put("m" + side, m, PAD_M)
        put("mu" + side, (1 << 32) // m, (1 << 32) // PAD_M)
        put("inv" + side, f32(ctx.dA["inv_f"] if side == "A"
                              else ctx.dB["inv_f"]))
        put("one" + side, [one % int(v) for v in m])
        cp = cpA if side == "A" else cpB
        put("k16" + side, cp[16] + m)
        put("k4" + side, cp[4] + m)
        put("k8" + side, cp[8] + 2 * m)
    put("sigc", np.asarray(ctx.sig_c).ravel())
    put("negBA", [(-ctx.B.prod) % int(v) for v in mA])
    put("pB", np.asarray(ctx.p_B).ravel())
    put("invab", np.asarray(ctx.invA_B).ravel())
    put("invmib", np.asarray(ctx.dB["inv_Mi"]).ravel())
    put("negAB", [(-ctx.A.prod) % int(v) for v in mB])
    put("wAB", _ext_matrix(ctx.A, ctx.B))
    put("wBA", _ext_matrix(ctx.B, ctx.A))
    put("probe", cpA[:PROBE_C, :2])
    out = torch.as_tensor(buf.astype(np.int32), device=device)
    cache[device] = out
    return out


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
    consts = madd_consts(ctx, dev)
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
