"""Keccak-f[1600]: the hand-written CUDA kernel and its plain PyTorch
version.

``f1600(state)`` runs what the JAX package's
``pallas_keccak._f1600_kernel`` runs: the 24-round permutation of
every state of an int32 ``[..., 25, 2]`` tensor of bit-interleaved
words (the uint32 bit patterns; ``[..., l, 0]`` the even bits of lane
l, ``[..., l, 1]`` the odd). The kernel takes that layout as it is,
one contiguous ``[n, 25, 2]`` buffer with the leading axes folded,
25 threads (one warp) a state; its per-thread constants are
``keccak.LANE_TAB``, uploaded once per process.

On a CUDA tensor it launches ``csrc/keccak.cu`` (or raises); on a CPU
tensor it runs ``keccak.f1600_plain``. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

launches = 0

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("keccak")
        vp = ctypes.c_void_p
        lib.cap_keccak.argtypes = [vp, vp, ctypes.c_int, vp]
        lib.cap_keccak.restype = ctypes.c_int
        lib.cap_keccak_set_tables.argtypes = [vp]
        lib.cap_keccak_set_tables.restype = ctypes.c_int
        from .keccak import LANE_TAB

        tab = np.ascontiguousarray(LANE_TAB, np.int32)
        rc = lib.cap_keccak_set_tables(tab.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"keccak table upload failed: CUDA error {rc}")
        _lib = lib
    return _lib


def f1600(state: torch.Tensor) -> torch.Tensor:
    """The permutation of int32 [..., 25, 2] interleaved states."""
    global launches
    if state.device.type == "cpu":
        from .keccak import f1600_plain

        return f1600_plain(state)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    if state.dtype != torch.int32:
        raise ValueError(f"expected int32 words, got {state.dtype}")
    if state.dim() < 2 or tuple(state.shape[-2:]) != (25, 2):
        raise ValueError(f"expected [..., 25, 2] states, got "
                         f"{tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("states must be contiguous")
    out = torch.empty_like(state)
    n = state.numel() // 50
    if n == 0:
        return out
    rc = _kernel().cap_keccak(
        state.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(state.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"keccak kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
