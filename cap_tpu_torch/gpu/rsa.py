"""Batched RS* (PKCS#1 v1.5) and PS* (PSS) verification in PyTorch.

The port of the JAX package's RS*/PS* paths. Packed: per chunk one u8
record matrix [sig ‖ digest ‖ flag ‖ key row] goes to the device; the
signature bytes become 16-bit limbs there. Arrays (key classes of
more than 255 keys, whose row does not fit the record's byte): the
right-aligned signatures, digests and int64 key rows go separately.

Each key class takes one of two engines, as in the JAX package:

- RNS, for a class whose keys all have e = 65537 and an
  RNS-compatible modulus, unless the caller asks for ``rns=False``.
  RS*: the expected encoded message EM is built on the device from
  the digest, and ``rns._rns_verify_core`` checks s^65537 ≡ EM
  (mod n) entirely in RNS. PS*:
  ``rns._rns_modexp_em_core`` returns s^65537 mod n as limbs (CRT
  reconstruction). Its REDC runs on per-token key constants as plain
  torch ops (the JAX package computes it outside any Pallas kernel
  too), with its extension products as float32 ``torch.matmul``.
- limbs, for every other class (``bignum.modexp_65537`` when every e
  is 65537 but a modulus shares a factor with an RNS prime, is too
  wide for the prime pool, or ``rns=False`` was asked for;
  ``bignum.modexp_vare`` over the class's widest exponent otherwise),
  plain torch ops too.

PS* runs the whole EMSA-PSS-VERIFY with its SHA-256 (``gpu.sha256``)
or SHA-384/512 (``gpu.sha512``) on the device, on either engine and
path (the JAX package's arrays path checks the EM on the host; the
verdicts are the same). Only an [N] bool returns. The synchronous
entry points (``verify_pkcs1v15_batch``, ``verify_pss_batch``,
``verify_pkcs1v15_arrays``, ``verify_pss_arrays``) return the host
verdicts of the same paths.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import limbs as L
from .bignum import compare_ge, modexp_65537, modexp_vare, mont_params
from .rns import (
    RNSKeyTable,
    RNSUnsupportedKey,
    context,
    modexp_em_device,
    verify_em_equals_device,
)

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
    widest modulus, at least 8: the JAX package's rule, so the limb
    engine's lazy Montgomery chain has R ≥ 4n), so one record layout
    serves the class. The limb tables hold n, N' = −n⁻¹ mod R, R² mod n
    and R mod n per key; ``e_arr`` the exponents as uint32, so an
    exponent of 2^32 or more raises ``OverflowError`` here, as in the
    JAX table. ``ctx``/``rtab`` are the RNS context and per-key
    constants, or None where the class runs on limbs (an exponent other
    than 65537, or a modulus the RNS bases cannot take).
    """

    def __init__(self, public_numbers: Sequence, device="cuda"):
        """public_numbers: list of (n_int, e_int)."""
        self.n_ints = [n for n, _ in public_numbers]
        self.e_ints = [e for _, e in public_numbers]
        self.sizes_bytes = [(n.bit_length() + 7) // 8 for n in self.n_ints]
        self.mod_bits = [n.bit_length() for n in self.n_ints]
        need = L.nlimbs_for_bits(max(self.mod_bits))
        self.k = max(need + 1, 8)
        tabs = np.empty((4, len(self.n_ints), self.k), np.int64)
        for i, n in enumerate(self.n_ints):
            # mont_params refuses an even modulus before any other check
            for t, v in enumerate((n,) + mont_params(n, self.k)):
                tabs[t, i] = L.int_to_limbs(v, self.k)
        self.e_arr = np.asarray(self.e_ints, np.uint32)
        self.all_f4 = all(e == 65537 for e in self.e_ints)
        self.max_ebits = max(e.bit_length() for e in self.e_ints)
        self.device = torch.device(device)
        self.n_tab, self.np_tab, self.r2_tab, self.one_tab = (
            torch.as_tensor(t, device=self.device) for t in tabs)
        self.e_dev = torch.as_tensor(self.e_arr.astype(np.int64),
                                     device=self.device)
        self.sizes_dev = torch.as_tensor(self.sizes_bytes,
                                         dtype=torch.int64,
                                         device=self.device)
        self.mod_bits_dev = torch.as_tensor(self.mod_bits,
                                            dtype=torch.int64,
                                            device=self.device)
        self.ctx = self.rtab = None
        if self.all_f4:
            nbits = ((max(self.mod_bits) + 255) // 256) * 256
            try:
                ctx = context(nbits, self.k)
                self.rtab = RNSKeyTable(ctx, self.n_ints)
                self.ctx = ctx
            except RNSUnsupportedKey:
                pass                     # the class runs on limbs


def modexp_for_table(table: RSAKeyTable, s_limbs: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """s^e mod n on the limb engine, [K, N] canonical limbs.

    s_limbs: [K, N] signature integers; idx: [N] key rows (int64 on the
    table's device). ``modexp_65537`` when every key of the class has
    e = 65537, else ``modexp_vare`` over the class's widest exponent.
    """
    n = table.n_tab[idx].T
    nprime = table.np_tab[idx].T
    r2 = table.r2_tab[idx].T
    if table.all_f4:
        return modexp_65537(s_limbs, n, nprime, r2)
    return modexp_vare(s_limbs, table.e_dev[idx], n, nprime, r2,
                       table.one_tab[idx].T, table.max_ebits)


def s_in_range_mask(table: RSAKeyTable, s_limbs: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """[N] bool: signature integer s < n (RFC 8017 step 1)."""
    return ~compare_ge(s_limbs, table.n_tab[idx].T)


def _rs_em_ok(table: RSAKeyTable, s_limbs: torch.Tensor,
              expected: torch.Tensor, idx: torch.Tensor,
              rns: bool) -> torch.Tensor:
    """[N] bool: s^e mod n == the expected EM, on the class's engine
    (the limb engine where ``rns`` is False)."""
    if rns and table.ctx is not None:
        return verify_em_equals_device(table.ctx, table.rtab, s_limbs,
                                       expected, idx)
    return (modexp_for_table(table, s_limbs, idx) == expected).all(dim=0)


def _ps_em(table: RSAKeyTable, s_limbs: torch.Tensor,
           idx: torch.Tensor, rns: bool) -> torch.Tensor:
    """s^e mod n as [N, 2K] big-endian bytes, on the class's engine
    (the limb engine where ``rns`` is False)."""
    if rns and table.ctx is not None:
        em = modexp_em_device(table.ctx, table.rtab, s_limbs, idx,
                              table.n_tab[idx].T)
    else:
        em = modexp_for_table(table, s_limbs, idx)
    return _limbs_to_bytes(em)


def rs_packed_records(table: RSAKeyTable, sig_mat: np.ndarray,
                      sig_lens: np.ndarray, hash_mat: np.ndarray,
                      hash_name: str, key_idx: np.ndarray,
                      kind: str = "rs") -> np.ndarray:
    """Host: the packed [N, 2k + hlen + 2] u8 record matrix.

    Row layout: right-aligned signature bytes (2k) ‖ digest (hlen) ‖
    validity flag u8 ‖ key row u8. Wrong-length signatures are zeroed
    with flag 0 (the oracle's length rejections). ``kind`` "rs" also
    clears the flag where PKCS#1 v1.5 needs emLen ≥ tLen + 11; "ps"
    keeps plain length validity (the PSS length checks run on the
    device), as the JAX keyset's record packer does.
    """
    sizes = np.asarray(table.sizes_bytes, np.int64)[key_idx]
    len_ok = sig_lens == sizes
    flags = len_ok
    if kind == "rs":
        flags = flags & (sizes >= len(DIGEST_INFO_PREFIX[hash_name])
                         + HASH_LEN[hash_name] + 11)
    flags = flags.astype(np.uint8)
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


def _rs_verify(s_limbs, dig, flags, idx, table: RSAKeyTable,
               hash_name: str, rns: bool) -> torch.Tensor:
    expected = _expected_em_device(dig, table.sizes_dev[idx], table.k,
                                   hash_name)
    return (_rs_em_ok(table, s_limbs, expected, idx, rns)
            & s_in_range_mask(table, s_limbs, idx) & flags)


# the key table's own tensors, replicated on every device of a mesh
TABLE_TENSORS = ("n_tab", "np_tab", "r2_tab", "one_tab", "e_dev",
                 "sizes_dev", "mod_bits_dev")


def _packed_pending(table: RSAKeyTable, rec, hash_name: str, verify,
                    mesh):
    """One packed chunk through ``verify`` (:func:`_rs_verify` or
    :func:`_ps_verify`): on the table's device, or with a mesh the
    record sharded along the batch axis and the tables replicated, one
    shard's core a mesh device (a :class:`..parallel.place.Sharded`
    verdict)."""
    h_len = HASH_LEN[hash_name]

    def run(view, dev_rec):
        s_limbs, dig, flags, idx = _rs_packed_unpack(dev_rec, view.k, h_len)
        return verify(s_limbs, dig, flags, idx, view, hash_name, True)

    if mesh is not None:
        from ..parallel.place import on_shards, replicated_views, shard_batch

        views = replicated_views(mesh, table, TABLE_TENSORS)
        return on_shards(mesh, lambda i, r: run(views[i], r),
                         shard_batch(mesh, rec))
    # the keyset hands over the card's chunks already on the device
    dev = (rec if torch.is_tensor(rec)
           else torch.from_numpy(np.ascontiguousarray(rec))).to(
        table.device)
    return run(table, dev)


def verify_rs_packed_pending(table: RSAKeyTable, rec: np.ndarray,
                             hash_name: str, mesh=None):
    """Queue one packed RS* chunk on the table's device; returns the
    device [N] bool (materialized by the caller's one sync). With a
    ``mesh`` (:func:`cap_tpu_torch.parallel.make_mesh`) the record
    shards along the batch axis and the tables replicate."""
    return _packed_pending(table, rec, hash_name, _rs_verify, mesh)


# ---------------------------------------------------------------------------
# PS*: device-side EMSA-PSS-VERIFY (SHA-256/384/512)
# ---------------------------------------------------------------------------

def _limbs_to_bytes(limbs: torch.Tensor) -> torch.Tensor:
    """[K, N] 16-bit limbs → [N, 2K] uint8 big-endian bytes."""
    be = limbs.T.flip(1)
    return torch.stack([be >> 8, be & 0xFF], dim=2).reshape(
        be.shape[0], -1).to(torch.uint8)


def _vshift_left(mat: torch.Tensor, sh: torch.Tensor,
                 max_shift: int) -> torch.Tensor:
    """out[i, j] = mat[i, j + sh[i]] (zero fill), sh ∈ [0, max_shift].

    A binary-decomposed variable shift: log2(max_shift) masked static
    slices instead of a per-token gather (the JAX package's layout).
    """
    n = mat.shape[0]
    x = mat
    step = 1
    while step <= max_shift:
        shifted = torch.cat([x[:, step:], x.new_zeros((n, step))], dim=1)
        x = torch.where(((sh & step) != 0)[:, None], shifted, x)
        step *= 2
    return x


def _pss_hash_fns(hash_name: str):
    """(fixed_fn, var_fn, h_len) for the device PSS hashing."""
    if hash_name == "sha256":
        from . import sha256 as S

        return S.sha256_fixed, S.sha256_var, 32
    from . import sha512 as S

    if hash_name == "sha384":
        return S.sha384_fixed, S.sha384_var, 48
    if hash_name == "sha512":
        return S.sha512_fixed, S.sha512_var, 64
    raise ValueError(f"unsupported PSS hash {hash_name!r}")


def _pss_verify_device(em_bytes: torch.Tensor, mhash: torch.Tensor,
                       mod_bits: torch.Tensor, width: int,
                       hash_name: str) -> torch.Tensor:
    """RFC 8017 §9.1.2 on the device, salt auto-recovered: [N] bool.

    em_bytes: [N, width] big-endian EM integer bytes (width = 2k);
    mhash: [N, h_len] u8; mod_bits: [N] per-token modulus bits. The
    MGF1 blocks (all of them in one batched hash) and H' run through
    ``gpu.sha256`` or ``gpu.sha512`` (:func:`_pss_hash_fns`); every
    per-token offset is a ``_vshift_left``. Every
    structural rejection of the host check (``jwt.verify.pss_check_em``:
    short emLen, missing 0xBC, nonzero leading bits or bytes, bad
    PS/0x01 separator, H' mismatch) gives the same verdict.
    """
    sha_fixed, sha_var, h_len = _pss_hash_fns(hash_name)
    n = em_bytes.shape[0]
    dev = em_bytes.device
    em_bits = mod_bits.to(torch.int64) - 1
    em_len = (em_bits + 7) // 8                      # [N]
    start = width - em_len                           # first EM byte
    cols = torch.arange(width, device=dev)[None, :]

    # EM < 2^emBits: bytes before `start` must be zero
    lead_ok = ~((cols < start[:, None]) & (em_bytes != 0)).any(dim=1)
    db_len = em_len - h_len - 1
    len_ok = em_len >= h_len + 2
    trailer_ok = em_bytes[:, width - 1] == 0xBC

    # H and maskedDB at per-token offsets
    h_mat = em_bytes[:, width - 1 - h_len: width - 1]
    db_max = width - h_len - 1
    dbj = torch.arange(db_max, device=dev)[None, :]
    masked_db = _vshift_left(em_bytes, start.clamp(0, width),
                             width)[:, :db_max]
    in_db = dbj < db_len[:, None]
    masked_db = torch.where(in_db, masked_db, 0)

    unused = 8 * em_len - em_bits                    # [N] ∈ [0, 7]
    top_ok = (unused == 0) | \
        ((masked_db[:, 0].to(torch.int64) >> (8 - unused)) == 0)

    # MGF1(H, dbLen): byte j = Hash(H ‖ be32(j // h_len))[j % h_len];
    # all counters hash as one batch of [n_ctr·N] single blocks
    n_ctr = (db_max + h_len - 1) // h_len
    seeds = torch.zeros((n_ctr, n, h_len + 4), dtype=torch.uint8,
                        device=dev)
    seeds[:, :, :h_len] = h_mat
    ctr = torch.arange(n_ctr, device=dev)
    seeds[:, :, h_len + 2] = (ctr >> 8).to(torch.uint8)[:, None]
    seeds[:, :, h_len + 3] = (ctr & 0xFF).to(torch.uint8)[:, None]
    mask = sha_fixed(seeds.reshape(n_ctr * n, h_len + 4))
    mask = mask.reshape(n_ctr, n, h_len).permute(1, 0, 2).reshape(
        n, n_ctr * h_len)[:, :db_max]
    db = masked_db ^ torch.where(in_db, mask, 0)
    top_mask = (torch.full_like(unused, 0xFF) >> unused).to(torch.uint8)
    db[:, 0] &= top_mask

    # DB = 0x00.. ‖ 0x01 ‖ salt: the first nonzero byte must be 0x01
    nz = (db != 0) & in_db
    sep = torch.argmax(nz.to(torch.int8), dim=1)     # 0 when none
    sep_ok = nz.any(dim=1) & (db.gather(1, sep[:, None])[:, 0] == 1)
    salt_len = db_len - sep - 1

    # M' = 0^8 ‖ mHash ‖ salt; the salt is DB shifted left by sep + 1
    salt_max = db_max - 1
    sj = torch.arange(salt_max, device=dev)[None, :]
    salt = _vshift_left(db, sep + 1, db_max)[:, :salt_max]
    salt = torch.where(sj < salt_len[:, None], salt, 0)
    mp_max = 8 + h_len + salt_max
    mprime = torch.zeros((n, mp_max), dtype=torch.uint8, device=dev)
    mprime[:, 8:8 + h_len] = mhash[:, :h_len]
    mprime[:, 8 + h_len:] = salt
    hprime = sha_var(mprime, 8 + h_len + salt_len, mp_max)

    h_ok = (hprime == h_mat).all(dim=1)
    return (lead_ok & len_ok & trailer_ok & top_ok & sep_ok & h_ok
            & (db_len > 0))


def _ps_verify(s_limbs, dig, flags, idx, table: RSAKeyTable,
               hash_name: str, rns: bool) -> torch.Tensor:
    ok = _pss_verify_device(_ps_em(table, s_limbs, idx, rns), dig,
                            table.mod_bits_dev[idx], 2 * table.k,
                            hash_name)
    return ok & s_in_range_mask(table, s_limbs, idx) & flags


def verify_ps_packed_pending(table: RSAKeyTable, rec: np.ndarray,
                             hash_name: str, mesh=None):
    """Queue one packed PS* chunk (records of ``rs_packed_records`` with
    kind "ps") on the table's device; returns the device [N] bool. The
    EM never leaves the device. ``mesh`` as in
    :func:`verify_rs_packed_pending`."""
    return _packed_pending(table, rec, hash_name, _ps_verify, mesh)


# ---------------------------------------------------------------------------
# Arrays dispatch: key classes of more than 255 keys
# ---------------------------------------------------------------------------

def _arrays_inputs(table: RSAKeyTable, sig_mat: np.ndarray,
                   sig_lens: np.ndarray, hash_mat: np.ndarray,
                   hash_name: str, key_idx: np.ndarray):
    """Host arrays → (s_limbs, dig, idx) on the table's device and the
    host [N] bool of signatures of the key's length."""
    sizes = np.asarray(table.sizes_bytes, np.int64)[key_idx]
    len_ok = sig_lens == sizes
    aligned = L.right_align_bytes(
        np.where(len_ok[:, None], sig_mat, 0), np.where(len_ok, sig_lens, 0),
        2 * table.k)
    dev = table.device
    s_limbs = L.bytes_to_limbs_device(torch.from_numpy(aligned).to(dev))
    dig = torch.from_numpy(np.ascontiguousarray(
        hash_mat[:, :HASH_LEN[hash_name]])).to(dev)
    idx = torch.as_tensor(np.asarray(key_idx, np.int64), device=dev)
    return s_limbs, dig, idx, len_ok


def verify_pkcs1v15_arrays_pending(table: RSAKeyTable, sig_mat: np.ndarray,
                                   sig_lens: np.ndarray,
                                   hash_mat: np.ndarray, hash_name: str,
                                   key_idx: np.ndarray,
                                   rns: bool = True) -> torch.Tensor:
    """Queue one RS* chunk given as arrays; returns the device [N] bool.

    sig_mat: [N, W ≤ 2k] left-aligned signature bytes; sig_lens: [N];
    hash_mat: [N, ≥ hlen] digests; key_idx: [N] table rows of any size.
    Signatures not of the key's length, and keys too short for
    PKCS#1 v1.5 with the hash, verify False.
    """
    s_limbs, dig, idx, len_ok = _arrays_inputs(
        table, sig_mat, sig_lens, hash_mat, hash_name, key_idx)
    sizes = np.asarray(table.sizes_bytes, np.int64)[key_idx]
    flags = len_ok & (sizes >= len(DIGEST_INFO_PREFIX[hash_name])
                      + HASH_LEN[hash_name] + 11)
    return _rs_verify(s_limbs, dig, torch.as_tensor(flags, device=idx.device),
                      idx, table, hash_name, rns)


def verify_pss_arrays_pending(table: RSAKeyTable, sig_mat: np.ndarray,
                              sig_lens: np.ndarray, hash_mat: np.ndarray,
                              hash_name: str, key_idx: np.ndarray,
                              rns: bool = True) -> torch.Tensor:
    """Queue one PS* chunk given as arrays (as
    :func:`verify_pkcs1v15_arrays_pending`); the EMSA-PSS check runs on
    the device, so only the [N] bool returns."""
    s_limbs, dig, idx, len_ok = _arrays_inputs(
        table, sig_mat, sig_lens, hash_mat, hash_name, key_idx)
    return _ps_verify(s_limbs, dig, torch.as_tensor(len_ok, device=idx.device),
                      idx, table, hash_name, rns)


# ---------------------------------------------------------------------------
# Synchronous entry points (arrays, and lists of raw signatures)
# ---------------------------------------------------------------------------

def verify_pkcs1v15_arrays(table: RSAKeyTable, sig_mat: np.ndarray,
                           sig_lens: np.ndarray, hash_mat: np.ndarray,
                           hash_name: str, key_idx: np.ndarray,
                           rns: bool = True) -> np.ndarray:
    """[N] bool RS* verdicts of :func:`verify_pkcs1v15_arrays_pending`."""
    return verify_pkcs1v15_arrays_pending(
        table, sig_mat, sig_lens, hash_mat, hash_name, key_idx,
        rns=rns).cpu().numpy()


def verify_pss_arrays(table: RSAKeyTable, sig_mat: np.ndarray,
                      sig_lens: np.ndarray, hash_mat: np.ndarray,
                      hash_name: str, key_idx: np.ndarray,
                      rns: bool = True) -> np.ndarray:
    """[N] bool PS* verdicts of :func:`verify_pss_arrays_pending`."""
    return verify_pss_arrays_pending(
        table, sig_mat, sig_lens, hash_mat, hash_name, key_idx,
        rns=rns).cpu().numpy()


def _list_arrays(table: RSAKeyTable, sigs: Sequence[bytes],
                 msg_hashes: Sequence[bytes], hash_name: str):
    """Lists of raw signatures and digests → (sig_mat [N, 2k] left-
    aligned, sig_lens, hash_mat); a signature wider than 2k bytes keeps
    its length (it fails the length check) but no bytes."""
    n = len(sigs)
    width = 2 * table.k
    sig_mat = np.zeros((n, width), np.uint8)
    sig_lens = np.fromiter((len(sg) for sg in sigs), np.int64, n)
    for j, sg in enumerate(sigs):
        if len(sg) <= width:
            sig_mat[j, :len(sg)] = np.frombuffer(sg, np.uint8)
    hash_mat = np.zeros((n, HASH_LEN[hash_name]), np.uint8)
    for j, h in enumerate(msg_hashes):
        hash_mat[j] = np.frombuffer(h, np.uint8)
    return sig_mat, sig_lens, hash_mat


def verify_pkcs1v15_batch(table: RSAKeyTable, sigs: Sequence[bytes],
                          msg_hashes: Sequence[bytes], hash_name: str,
                          key_idx: np.ndarray,
                          rns: bool = True) -> np.ndarray:
    """[N] bool verdicts for one RS* bucket given as lists; signatures
    not of their key's length fail."""
    return verify_pkcs1v15_arrays(
        table, *_list_arrays(table, sigs, msg_hashes, hash_name),
        hash_name, np.asarray(key_idx, np.int64), rns=rns)


def verify_pss_batch(table: RSAKeyTable, sigs: Sequence[bytes],
                     msg_hashes: Sequence[bytes], hash_name: str,
                     key_idx: np.ndarray, rns: bool = True) -> np.ndarray:
    """[N] bool verdicts for one PS* bucket given as lists: the modexp
    and the whole EMSA-PSS check on the device."""
    return verify_pss_arrays(
        table, *_list_arrays(table, sigs, msg_hashes, hash_name),
        hash_name, np.asarray(key_idx, np.int64), rns=rns)
