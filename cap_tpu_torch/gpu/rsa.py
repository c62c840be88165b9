"""Batched RS* (PKCS#1 v1.5) verification in PyTorch.

The port of the JAX package's packed RS* path, RNS branch: per chunk
one u8 record matrix [sig ‖ digest ‖ flag ‖ key row] goes to the
device; the signature bytes become 16-bit limbs there, the expected
encoded message EM is built there from the digest, and
``rns._rns_verify_core`` checks s^65537 ≡ EM (mod n) entirely in
RNS. Only an [N] bool returns.

The RS REDC runs on per-token key constants and stays plain torch
ops (the JAX package computes it outside any Pallas kernel too), with
its extension products as float32 ``torch.matmul``.

Keys must have e = 65537 and RNS-compatible moduli; the JAX package
sends other keys to its limb engine, which this port does not have
yet, so building a table for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import limbs as L
from .bignum import compare_ge
from .rns import RNSKeyTable, RNSUnsupportedKey, _rns_verify_core, context

# ASN.1 DigestInfo prefixes (RFC 8017 §9.2 notes).
DIGEST_INFO_PREFIX = {
    "sha256": bytes.fromhex("3031300d060960864801650304020105000420"),
    "sha384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "sha512": bytes.fromhex("3051300d060960864801650304020305000440"),
}
HASH_LEN = {"sha256": 32, "sha384": 48, "sha512": 64}
RS_REC_EXTRA = 2          # trailing bytes per record: flags, key row


def _expected_em_device(dig: torch.Tensor, sizes: torch.Tensor, k: int,
                        hash_name: str) -> torch.Tensor:
    """The PKCS#1 v1.5 expected EM as [K, N] int64 limbs, built where
    the digests live.

    dig: [N, hlen] u8; sizes: [N] per-token emLen. EM = 00 01 FF.. 00
    DigestInfo ‖ H, right-aligned in [N, 2k] bytes.
    """
    prefix = DIGEST_INFO_PREFIX[hash_name]
    h_len = HASH_LEN[hash_name]
    t_len = len(prefix) + h_len
    width = 2 * k
    n = dig.shape[0]
    dev = dig.device
    cols = torch.arange(width, device=dev)[None, :]
    start = (width - sizes.to(torch.int64))[:, None]
    val = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    val[(cols == start + 1).expand(n, width)] = 1
    val[((cols >= start + 2) & (cols < width - t_len - 1))
        .expand(n, width)] = 0xFF
    val[:, width - t_len: width - h_len] = torch.tensor(
        list(prefix), dtype=torch.uint8, device=dev)
    val[:, width - h_len:] = dig
    return L.bytes_to_limbs_device(val)


class RSAKeyTable:
    """The RSA public keys of one limb-width class on a device.

    All keys pad to a common limb count K (one spare limb beyond the
    widest modulus, at least 8: the JAX package's rule), so one record
    layout serves the class. ``rtab`` holds the per-key RNS constants.
    """

    def __init__(self, public_numbers: Sequence, device="cuda"):
        """public_numbers: list of (n_int, e_int)."""
        self.n_ints = [n for n, _ in public_numbers]
        self.e_ints = [e for _, e in public_numbers]
        if any(e != 65537 for e in self.e_ints):
            raise NotImplementedError(
                "RSA keys with e != 65537 need the limb engine, which "
                "cap_tpu_torch does not have yet")
        self.sizes_bytes = [(n.bit_length() + 7) // 8 for n in self.n_ints]
        need = L.nlimbs_for_bits(max(n.bit_length() for n in self.n_ints))
        self.k = max(need + 1, 8)
        self.device = torch.device(device)
        nbits = max(n.bit_length() for n in self.n_ints)
        nbits = ((nbits + 255) // 256) * 256
        try:
            self.ctx = context(nbits, self.k)
            self.rtab = RNSKeyTable(self.ctx, self.n_ints)
        except RNSUnsupportedKey as e:
            raise NotImplementedError(
                f"{e}: such keys need the limb engine, which "
                f"cap_tpu_torch does not have yet") from e
        n_tab = np.stack([L.int_to_limbs(n, self.k) for n in self.n_ints])
        self.n_tab = torch.as_tensor(n_tab.astype(np.int64),
                                     device=self.device)
        self.sizes_dev = torch.as_tensor(self.sizes_bytes,
                                         dtype=torch.int64,
                                         device=self.device)


def rs_packed_records(table: RSAKeyTable, sig_mat: np.ndarray,
                      sig_lens: np.ndarray, hash_mat: np.ndarray,
                      hash_name: str, key_idx: np.ndarray) -> np.ndarray:
    """Host: the packed [N, 2k + hlen + 2] u8 record matrix.

    Row layout: right-aligned signature bytes (2k) ‖ digest (hlen) ‖
    validity flag u8 ‖ key row u8. Wrong-length signatures are zeroed
    with flag 0 (the oracle's length rejections).
    """
    sizes = np.asarray(table.sizes_bytes, np.int64)[key_idx]
    len_ok = sig_lens == sizes
    em_len_ok = sizes >= len(DIGEST_INFO_PREFIX[hash_name]) + \
        HASH_LEN[hash_name] + 11
    flags = (len_ok & em_len_ok).astype(np.uint8)
    safe_lens = np.where(len_ok, sig_lens, 0)
    width = 2 * table.k
    aligned = L.right_align_bytes(
        np.where(len_ok[:, None], sig_mat[:, :width], 0), safe_lens, width)
    h_len = HASH_LEN[hash_name]
    rec = np.empty((sig_mat.shape[0], width + h_len + RS_REC_EXTRA),
                   np.uint8)
    rec[:, :width] = aligned
    rec[:, width:width + h_len] = hash_mat[:, :h_len]
    rec[:, width + h_len] = flags
    rec[:, width + h_len + 1] = key_idx.astype(np.uint8)
    return rec


def _rs_packed_unpack(packed: torch.Tensor, k: int, h_len: int):
    """Record matrix → (s_limbs, dig, flags, idx)."""
    width = 2 * k
    s_limbs = L.bytes_to_limbs_device(packed[:, :width])
    dig = packed[:, width:width + h_len]
    flags = packed[:, width + h_len] != 0
    idx = packed[:, width + h_len + 1].to(torch.int64)
    return s_limbs, dig, flags, idx


def _rs_packed_rns_impl(packed: torch.Tensor, table: RSAKeyTable,
                        hash_name: str) -> torch.Tensor:
    s_limbs, dig, flags, idx = _rs_packed_unpack(packed, table.k,
                                                 HASH_LEN[hash_name])
    expected = _expected_em_device(dig, table.sizes_dev[idx], table.k,
                                   hash_name)
    in_range = ~compare_ge(s_limbs, table.n_tab[idx].T)
    sig_c, n_B, a2_A, a2_B = table.rtab.device_tables(packed.device)
    ok = _rns_verify_core(table.ctx, s_limbs, expected, sig_c[idx].T,
                          n_B[idx].T, a2_A[idx].T, a2_B[idx].T)
    return ok & in_range & flags


def verify_rs_packed_pending(table: RSAKeyTable, rec: np.ndarray,
                             hash_name: str) -> torch.Tensor:
    """Queue one packed RS* chunk on the table's device; returns the
    device [N] bool (materialized by the caller's one sync)."""
    dev = torch.from_numpy(np.ascontiguousarray(rec)).to(table.device)
    return _rs_packed_rns_impl(dev, table, hash_name)
