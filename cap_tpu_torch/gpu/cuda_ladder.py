"""The whole ES ladder in one launch: the hand-written CUDA kernel and
its plain PyTorch version.

``ladder(ctx, tab, d_all, base, win_stride)`` computes what the JAX
package's ``pallas_madd.ladder_fused`` returns: W windows of the mixed
add (``cuda_madd``'s math) from the point at infinity, each lane's
table row ``i·win_stride + base + (d − 1)`` for a digit d > 0 (the
lane's state passes through a digit 0), the final infinity mask and
the OR of the windows' same-x flags. tab: the row-major window table
[rows, 2·iap] int32 (packed x words, then packed y words, a row);
d_all: [W, M] int32 digits of any width w ≤ 16 (both ladder chains
concatenated; 2^w − 1 rows a slot and window); base:
[M] int32 slot base of each lane. Returns (X, Y, Z, inf, deg): (A
[I_A, M], B [I_B, M]) int32 pairs and [M] bools.

The wrapper checks its arguments on either device (:func:`_check_args`);
then on a CUDA tensor it launches ``csrc/ladder.cu`` (or raises), on a
CPU tensor it runs :func:`ladder_ref`. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_madd, cuda_redc

launches = 0
_MAX_ROWS = (1 << 31) - 1


def ladder_ref(ctx, tab, d_all, base, win_stride: int):
    """Plain PyTorch ladder, ``ladder_fused`` step for step: gather every
    window's rows, the entry-infinity masks as an exclusive any-scan of
    digit > 0, ``madd_ref`` a window, the flags ORed, the final
    infinity from the scan's total."""
    ia, ib = ctx.A.count, ctx.B.count
    iap = max(ia, ib)
    n_windows, m = d_all.shape
    dev = tab.device
    d = d_all.to(torch.int64)
    has_all = d > 0
    row0 = (torch.arange(n_windows, device=dev)[:, None] * win_stride
            + base.to(torch.int64)[None, :])
    idx = row0 + torch.where(has_all, d - 1, torch.zeros_like(d))
    g = tab.index_select(0, idx.reshape(-1))           # [W·M, 2·iap]
    G = g.reshape(n_windows, m, 2 * iap).permute(0, 2, 1)
    has_i = has_all.to(torch.int32)
    hc = torch.cumsum(has_i, dim=0)
    inf_all = (hc - has_i) == 0                        # entry infinity
    zA = torch.zeros((ia, m), dtype=torch.int32, device=dev)
    zB = torch.zeros((ib, m), dtype=torch.int32, device=dev)
    X, Y, Z = (zA, zB), (zA, zB), (zA, zB)
    deg = torch.zeros(m, dtype=torch.bool, device=dev)
    for i in range(n_windows):
        gi = G[i].contiguous()
        X, Y, Z, dd = cuda_madd.madd_ref(ctx, X, Y, Z, inf_all[i],
                                         has_all[i], gi[:iap], gi[iap:])
        deg = deg | dd
    return X, Y, Z, hc[n_windows - 1] == 0, deg


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("ladder")
        vp = ctypes.c_void_p
        lib.cap_ladder.argtypes = ([vp] * 3 + [ctypes.c_int] * 2 + [vp] * 9
                                   + [ctypes.c_int] * 4 + [vp])
        lib.cap_ladder.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_int32(t, shape, name: str, dev) -> None:
    if t.device != dev or t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 on {dev}, got {t.dtype} "
                         f"on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_args(ctx, tab, d_all, base, win_stride: int) -> None:
    """Raise ValueError unless the arguments are what the kernel takes:
    contiguous int32 tab [rows, 2·iap], d_all [W, M] and base [M] on
    one device, W ≥ 1 windows of ``win_stride`` rows within the
    table. (Digits in [0, 2^w) and base + 2^w − 1 ≤ win_stride are
    the caller's contract: checking them would wait on the device.)"""
    iap = max(ctx.A.count, ctx.B.count)
    dev = tab.device
    if tab.dim() != 2 or d_all.dim() != 2:
        raise ValueError("tab and d_all must be 2-D")
    n_windows, m = d_all.shape
    _check_int32(tab, (tab.shape[0], 2 * iap), "tab", dev)
    _check_int32(d_all, (n_windows, m), "d_all", dev)
    _check_int32(base, (m,), "base", dev)
    if n_windows < 1 or win_stride < 1 or \
            n_windows * win_stride > tab.shape[0]:
        raise ValueError(f"{n_windows} windows of stride {win_stride} do "
                         f"not fit the table's {tab.shape[0]} rows")
    # the kernel forms row indices in int and byte offsets in size_t: a
    # table of up to 2^31 − 1 rows (12-bit P-521 windows of G and 8
    # keys: 1,621,620 rows; of G and 300 keys: 54,234,180)
    if tab.shape[0] > _MAX_ROWS:
        raise ValueError(f"a table of {tab.shape[0]} rows exceeds the "
                         f"kernel's {_MAX_ROWS}")


def ladder(ctx, tab, d_all, base, win_stride: int):
    global launches
    if tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tab.device}")
    _check_args(ctx, tab, d_all, base, win_stride)
    if tab.device.type == "cpu":
        return ladder_ref(ctx, tab, d_all, base, win_stride)
    cuda_redc.check_shape(ctx)
    ia, ib = ctx.A.count, ctx.B.count
    dev = tab.device
    n_windows, m = d_all.shape
    consts = cuda_madd.madd_consts(ctx, dev)
    outs = [torch.empty((r, m), dtype=torch.int32, device=dev)
            for r in (ia, ib) * 3]
    inf = torch.empty(m, dtype=torch.bool, device=dev)
    deg = torch.empty(m, dtype=torch.bool, device=dev)
    pairs = (outs[0], outs[1]), (outs[2], outs[3]), (outs[4], outs[5])
    if m == 0:
        return (*pairs, inf, deg)
    rc = _kernel().cap_ladder(
        tab.data_ptr(), d_all.data_ptr(), base.data_ptr(), win_stride,
        n_windows, *(o.data_ptr() for o in outs), inf.data_ptr(),
        deg.data_ptr(), consts.data_ptr(), consts.numel(), m, ia, ib,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ladder kernel launch failed: CUDA error {rc}")
    launches += 1
    return (*pairs, inf, deg)
