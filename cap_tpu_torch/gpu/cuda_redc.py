"""RNS Montgomery reduction (REDC): the hand-written CUDA kernel and
its plain PyTorch version.

``redc(ctx, xA, xB)`` computes t = x·A⁻¹ mod p for per-channel (EC)
contexts: σ = x_A·sig_c, the A→B extension, t_B = (x_B + q·p)·A⁻¹,
the B→A extension — what the JAX package's ``pallas_redc._redc_kernel``
computes. On a CUDA tensor it launches ``csrc/redc.cu`` (or raises);
on a CPU tensor it runs :func:`redc_ref`. ``launches`` counts kernel
launches.

Every RNS kernel (this one, the mixed adds of ``cuda_madd``,
``cuda_ladder`` and ``cuda_edw``) runs the arithmetic of
``csrc/rns_int.cuh`` on one constant buffer, ``cuda_madd.madd_consts``.
"""

from __future__ import annotations

import ctypes

import torch

from .rns import _redc

launches = 0

# The REDC, mixed-add and ladder kernels are instantiated for these
# (I_A, I_B) channel counts: P-256 (and the Ed25519 field), P-384 and
# P-521. Other contexts raise on the card.
KERNEL_SHAPES = ((23, 23), (34, 33), (45, 45))


def redc_ref(ctx, xA: torch.Tensor, xB: torch.Tensor):
    """Plain PyTorch REDC (``rns._redc`` with the context's constants)."""
    cc = ctx.device_consts(xA.device)
    return _redc(xA, xB, cc.sig_c, cc.p_B, cc)


def check_shape(ctx, shapes=KERNEL_SHAPES) -> None:
    """Raise unless the context's channel counts are among ``shapes``
    (the instantiations of the calling kernel)."""
    shape = (ctx.A.count, ctx.B.count)
    if shape not in shapes:
        raise NotImplementedError(
            f"no CUDA kernel instantiated for {shape[0]}+{shape[1]} RNS "
            f"channels (built: {shapes})")


def check_planes(planes, rows, device, n: int) -> None:
    """Raise unless every plane is a contiguous int32 [rows, n] tensor
    on ``device``."""
    for t, r in zip(planes, rows):
        if t.device != device or t.dtype != torch.int32:
            raise ValueError(f"expected int32 planes on {device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != (r, n):
            raise ValueError(f"expected shape {(r, n)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("planes must be contiguous")


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("redc")
        vp = ctypes.c_void_p
        lib.cap_redc.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 vp]
        lib.cap_redc.restype = ctypes.c_int
        _lib = lib
    return _lib


def redc(ctx, xA: torch.Tensor, xB: torch.Tensor):
    """REDC of residue planes xA [I_A, N], xB [I_B, N] (int32, digit
    canonical products) → (tA, tB), value < 3p."""
    global launches
    if xA.device.type == "cpu":
        return redc_ref(ctx, xA, xB)
    if xA.device.type != "cuda":
        raise ValueError(f"unsupported device {xA.device}")
    check_shape(ctx)
    ia, ib = ctx.A.count, ctx.B.count
    n = xA.shape[1] if xA.dim() == 2 else -1
    check_planes((xA, xB), (ia, ib), xA.device, n)
    from .cuda_madd import madd_consts

    consts = madd_consts(ctx, xA.device)
    tA = torch.empty_like(xA)
    tB = torch.empty_like(xB)
    if n == 0:
        return tA, tB
    rc = _kernel().cap_redc(
        xA.data_ptr(), xB.data_ptr(), tA.data_ptr(), tB.data_ptr(),
        consts.data_ptr(), consts.numel(), n, ia, ib,
        torch.cuda.current_stream(xA.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"redc kernel launch failed: CUDA error {rc}")
    launches += 1
    return tA, tB
