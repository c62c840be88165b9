"""The ML-DSA NTT and inverse NTT: the hand-written CUDA kernels and
their plain PyTorch versions.

``ntt(x)`` and ``intt(x)`` compute what the JAX package's
``pallas_ntt._ntt_kernel`` and ``_intt_kernel`` compute: all 8
butterfly stages (and, for the inverse, the folded 256⁻¹ scale) on
int32 ``[..., 256]`` rows of canonical values in [0, q). The kernels
take the rows as one contiguous ``[rows, 256]`` buffer (the leading
axes folded), one warp a row, the 8 stages in registers. The inverse
reads each row as 16-byte words, so its input must start 16-byte
aligned: a misaligned view raises.

On a CUDA tensor each launches ``csrc/ntt.cu`` (or raises); on a CPU
tensor it runs ``ntt.ntt_plain`` / ``ntt.intt_plain``.
``ntt_launches`` and ``intt_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import ntt as _ntt

ntt_launches = 0
intt_launches = 0

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("ntt")
        vp = ctypes.c_void_p
        lib.cap_ntt_set_tables.argtypes = [vp, vp, ctypes.c_uint]
        lib.cap_ntt_set_tables.restype = ctypes.c_int
        for fn in (lib.cap_ntt, lib.cap_intt):
            fn.argtypes = [vp, vp, ctypes.c_int, vp]
            fn.restype = ctypes.c_int
        zetas = np.ascontiguousarray(_ntt.ZETAS_MONT, np.uint32)
        neg = np.ascontiguousarray(_ntt.NEG_ZETAS_MONT, np.uint32)
        rc = lib.cap_ntt_set_tables(zetas.ctypes.data, neg.ctypes.data,
                                    int(_ntt.INV256_MONT))
        if rc != 0:
            raise RuntimeError(f"ntt twiddle upload failed: CUDA error {rc}")
        _lib = lib
    return _lib


def _check_rows(x: torch.Tensor) -> None:
    """Raise unless x is a contiguous int32 CUDA tensor [..., 256]."""
    if x.dtype != torch.int32:
        raise ValueError(f"expected int32 coefficients, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] != _ntt.N:
        raise ValueError(f"expected [..., {_ntt.N}] rows, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("rows must be contiguous")


def _launch(x: torch.Tensor, inverse: bool):
    """(output, 1 if a kernel launched else 0)."""
    _check_rows(x)
    if inverse and x.data_ptr() % 16:
        raise ValueError("intt reads 16-byte words: rows must start "
                         "16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // _ntt.N
    if rows == 0:
        return out, 0
    lib = _kernel()
    fn = lib.cap_intt if inverse else lib.cap_ntt
    rc = fn(x.data_ptr(), out.data_ptr(), rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        name = "intt" if inverse else "ntt"
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, 1


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT of int32 [..., 256] rows in [0, q)."""
    global ntt_launches
    if x.device.type == "cpu":
        return _ntt.ntt_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out, launched = _launch(x, False)
    ntt_launches += launched
    return out


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT (256⁻¹ folded) of int32 [..., 256] rows in [0, q)."""
    global intt_launches
    if x.device.type == "cpu":
        return _ntt.intt_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out, launched = _launch(x, True)
    intt_launches += launched
    return out
