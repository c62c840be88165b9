"""Carry key and context tables across from the JAX package.

The JAX package's tables, given as numpy arrays (``np.asarray`` of its
attributes), become this package's tables, so both packages can
compute on the same constants:

- RNS context constants: ``dA``/``dB`` (dicts of ``m``, ``m_f``,
  ``inv_f``, ``inv_Mi``), ``W_AB``/``W_BA`` ((hi, lo) 7-bit halves, any
  numeric dtype — the JAX package keeps them in bf16), ``Amod_B``,
  ``Bmod_A``, ``invA_B``; for field contexts also ``sig_c``, ``p_B``,
  ``cp_A``, ``cp_B``;
- ``RNSKeyTable``: ``sig_c``, ``n_B``, ``a2_A``, ``a2_B``;
- ``ECRNSKeyTable``: ``tab``, at the width of the JAX context's
  ``w_bits`` (given in the context arrays);
- ``Ed25519RNSKeyTable``: ``tna`` and the basepoint's ``b_table_rns()``
  (the JAX package's [rows, I_A + I_B] planes; the port keeps them
  transposed);
- ``MLDSAKeyTable``: ``a_mont`` and ``t1_mont`` (uint32 in the JAX
  package, int32 here; Montgomery-form values in [0, q));
- ``SLHDSAKeyTable``: ``pk_seed_l`` and ``pk_root_l`` (interleaved
  Keccak lanes, uint32 in the JAX package, the same bit patterns as
  int32 here).

Every array must have the shape of the table it replaces and hold
integers (floats only where the port keeps floats).
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np

from .gpu.ec import ECKeyTable
from .gpu.ec_rns import ECRNSKeyTable
from .gpu.ed25519 import Ed25519KeyTable
from .gpu.mldsa import PARAMS as MLDSA_PARAMS
from .gpu.mldsa import MLDSAKeyTable
from .gpu.rns import RNSKeyTable
from .gpu.rsa import RSAKeyTable
from .gpu.slhdsa import SLHDSAKeyTable

_CTX_SCALARS = ("Amod_B", "Bmod_A", "invA_B")
_FIELD_ARRAYS = ("sig_c", "p_B", "cp_A", "cp_B")
_BASE_KEYS = ("m", "m_f", "inv_f", "inv_Mi")


def _like(ref: np.ndarray, a, name: str) -> np.ndarray:
    a = np.asarray(a)
    if a.shape != ref.shape:
        raise ValueError(f"{name}: shape {a.shape}, expected {ref.shape}")
    if ref.dtype.kind == "f":
        return a.astype(ref.dtype)
    as_f = a.astype(np.float64)
    if not np.array_equal(as_f, np.round(as_f)):
        raise ValueError(f"{name}: non-integer entries")
    return as_f.astype(ref.dtype)


def load_context(ctx, arrays: Dict):
    """A copy of ``ctx`` (an ``RNSContext`` or ``FieldRNSContext``) whose
    constants come from ``arrays``."""
    new = copy.copy(ctx)
    for base in ("dA", "dB"):
        ref = getattr(ctx, base)
        setattr(new, base, {k: _like(ref[k], arrays[base][k],
                                     f"{base}.{k}") for k in _BASE_KEYS})
    for name in ("W_AB", "W_BA"):
        ref = getattr(ctx, name)
        setattr(new, name, tuple(_like(r, a, f"{name}[{i}]") for i, (r, a)
                                 in enumerate(zip(ref, arrays[name]))))
    names = _CTX_SCALARS + (_FIELD_ARRAYS if hasattr(ctx, "cp_A") else ())
    for name in names:
        setattr(new, name, _like(getattr(ctx, name), arrays[name], name))
    new._dev = {}
    new.__dict__.pop("_madd_consts", None)
    new.__dict__.pop("_to_limbs", None)
    return new


def rns_key_table(ctx, arrays: Dict) -> RNSKeyTable:
    """An ``RNSKeyTable`` on ``ctx`` from the JAX table's arrays."""
    nk = np.asarray(arrays["sig_c"]).shape[0]
    out = RNSKeyTable.__new__(RNSKeyTable)
    out.ctx = ctx
    shapes = {"sig_c": (nk, ctx.A.count), "n_B": (nk, ctx.B.count),
              "a2_A": (nk, ctx.A.count), "a2_B": (nk, ctx.B.count)}
    out.set_arrays(*(_like(np.zeros(shapes[k], np.int32), arrays[k], k)
                     for k in ("sig_c", "n_B", "a2_A", "a2_B")))
    return out


def rsa_key_table(public_numbers: Sequence, ctx_arrays: Dict,
                  table_arrays: Dict, device="cuda") -> RSAKeyTable:
    """An ``RSAKeyTable`` computing on the JAX package's constants."""
    table = RSAKeyTable(public_numbers, device)
    table.ctx = load_context(table.ctx, ctx_arrays)
    table.rtab = rns_key_table(table.ctx, table_arrays)
    return table


def ec_key_table(crv: str, keys: Sequence, ctx_arrays: Dict, tab,
                 device="cuda") -> ECKeyTable:
    """An ``ECKeyTable`` whose RNS context and window table are the JAX
    package's, at the window width of the JAX table's context
    (``ctx_arrays["w_bits"]``, 8 where absent): the table serves
    ``rns(w_bits)`` and the entry points' ``w_bits=`` of that width."""
    from .gpu.ec_rns import ctx_for, packed_cols

    w_bits = int(ctx_arrays.get("w_bits", 8))
    ctx = load_context(ctx_for(crv, w_bits), ctx_arrays)
    per = (1 << ctx.w_bits) - 1
    rows = ctx.n_windows * (len(keys) + 1) * per
    tab = _like(np.zeros((rows, 2 * packed_cols(ctx)), np.int32), tab,
                "tab")
    table = ECKeyTable(crv, keys, device)
    table._rns[w_bits] = ECRNSKeyTable(crv, keys, tab=tab, ctx=ctx)
    return table


def ed25519_key_table(keys: Sequence, ctx_arrays: Dict, tna: Sequence,
                      tb: Sequence, device="cuda") -> Ed25519KeyTable:
    """An ``Ed25519KeyTable`` whose RNS context and window tables (the
    keys' ``tna`` and the basepoint's ``tb``, three [rows, I_A + I_B]
    planes each) are the JAX package's."""
    from .gpu import ed25519_rns as er

    ctx = load_context(er.ctx(), ctx_arrays)
    rows = er.NW8 * er.PER
    w = ctx.A.count + ctx.B.count

    def planes(arrs, n_rows, name):
        return tuple(np.ascontiguousarray(
            _like(np.zeros((n_rows, w), np.int32), a, f"{name}[{t}]").T)
            for t, a in enumerate(arrs))

    table = Ed25519KeyTable(keys, device)
    table._rns = er.Ed25519RNSKeyTable(
        table.decoded, tna=planes(tna, len(keys) * rows, "tna"),
        tb=planes(tb, rows, "tb"), ctx_=ctx)
    return table


def mldsa_key_table(parameter_set: str, keys: Sequence, a_mont, t1_mont,
                    device="cuda") -> MLDSAKeyTable:
    """An ``MLDSAKeyTable`` of ``keys`` (``MLDSAPublicKey``s of one
    parameter set) whose Â and t̂1·2^d are the JAX table's ``a_mont``
    [nk, k, l, 256] and ``t1_mont`` [nk, k, 256]."""
    from .gpu.ntt import Q

    p = MLDSA_PARAMS[parameter_set]
    nk = len(keys)
    a = _like(np.zeros((nk, p.k, p.l, 256), np.int64), a_mont, "a_mont")
    t = _like(np.zeros((nk, p.k, 256), np.int64), t1_mont, "t1_mont")
    for name, arr in (("a_mont", a), ("t1_mont", t)):
        if arr.size and (arr.min() < 0 or arr.max() >= Q):
            raise ValueError(f"{name}: entries outside [0, q)")
    return MLDSAKeyTable(parameter_set, keys, device, a_mont=a, t1_mont=t)


def slhdsa_key_table(parameter_set: str, keys: Sequence, pk_seed_l,
                     pk_root_l, device="cuda") -> SLHDSAKeyTable:
    """An ``SLHDSAKeyTable`` of ``keys`` (``SLHDSAPublicKey``s of one
    parameter set) whose lanes are the JAX table's ``pk_seed_l`` and
    ``pk_root_l`` ([nk, 2, 2] uint32 words)."""
    shape = (len(keys), 2, 2)
    lanes = []
    for name, a in (("pk_seed_l", pk_seed_l), ("pk_root_l", pk_root_l)):
        a = _like(np.zeros(shape, np.int64), a, name)
        if a.size and (a.min() < 0 or a.max() >= 1 << 32):
            raise ValueError(f"{name}: entries outside [0, 2^32)")
        lanes.append(a.astype(np.uint32))
    return SLHDSAKeyTable(parameter_set, keys, device, pk_seed_l=lanes[0],
                          pk_root_l=lanes[1])
