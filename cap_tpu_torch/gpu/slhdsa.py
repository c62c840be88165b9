"""Batched SLH-DSA (FIPS 205, SPHINCS+) signature verification.

The port of the JAX package's ``tpu/slhdsa.py``, for the parameter
sets SLH-DSA-SHAKE-128s and -128f (FIPS 205 Table 2; the JOSE alg
names of draft-ietf-cose-sphincs-plus are the set names). SLH-DSA is
pure hash: one verify walks thousands of SHAKE256 evaluations, each a
fixed-shape absorb of one to five blocks, so the device half runs on
the Keccak kernel alone (``gpu/keccak.py``, ``csrc/keccak.cu``).

- **host** (:class:`_SLHPrep`: per-token Python, one hashlib SHAKE a
  token, as in the JAX package): the signature length gate and field
  split, H_msg → md / idx_tree / idx_leaf / the FORS indices, and,
  since every tree and leaf index is then known, every ADRS of the
  token as interleaved lanes;
- **device** (:func:`_slh_core`): every F/H/T evaluation — the k FORS
  leaves, the a auth folds and T_k, then a Python loop over the d
  hypertree layers (WOTS digits from the running root, the masked
  15-step chain walk with the hash address injected into the ADRS
  lanes on the device, T_len, the XMSS auth fold) — ending in a root
  compare against the key table. Only the [pad] bool verdicts return.

Each F/H/T call is one absorb of fixed length (:func:`_hash_lanes`),
one kernel launch a block: a 128f chunk launches keccak 518 times, a
128s chunk 219 (``chunk_launches``).

:func:`py_verify` is the pure-hashlib host oracle (the keyset's trial
path); :func:`keygen` and the deterministic signer exist only to make
fixtures and are nowhere near constant-time.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import keccak as _kk

# ADRS type words (FIPS 205 §4.2)
_WOTS_HASH = 0
_WOTS_PK = 1
_TREE = 2
_FORS_TREE = 3
_FORS_ROOTS = 4
_WOTS_PRF = 5
_FORS_PRF = 6

W = 16                              # Winternitz (lg_w = 4, all sets)
LG_W = 4


class ParameterSet:
    """One FIPS 205 parameter set (Table 2) plus derived sizes."""

    __slots__ = ("name", "n", "h", "d", "hp", "a", "k", "m",
                 "len1", "len2", "wlen", "pk_size", "sig_size")

    def __init__(self, name: str, n: int, h: int, d: int, hp: int,
                 a: int, k: int, m: int):
        self.name = name
        self.n, self.h, self.d, self.hp = n, h, d, hp
        self.a, self.k, self.m = a, k, m
        self.len1 = 2 * n                     # 8n / lg_w
        self.len2 = 3                         # lg_w = 4, n = 16..32
        self.wlen = self.len1 + self.len2
        self.pk_size = 2 * n
        self.sig_size = n * (1 + k * (1 + a) + h + d * self.wlen)


PARAMS: Dict[str, ParameterSet] = {
    "SLH-DSA-SHAKE-128s": ParameterSet("SLH-DSA-SHAKE-128s",
                                       16, 63, 7, 9, 12, 14, 30),
    "SLH-DSA-SHAKE-128f": ParameterSet("SLH-DSA-SHAKE-128f",
                                       16, 66, 22, 3, 6, 33, 34),
}

SLHDSA_ALGS = tuple(PARAMS)         # the JOSE alg names ARE the names


def _shake(data: bytes, outlen: int) -> bytes:
    return hashlib.shake_256(data).digest(outlen)


# ---------------------------------------------------------------------------
# ADRS — 32 bytes, big-endian words (§4.2; SHAKE uses the full form)
# ---------------------------------------------------------------------------

class ADRS:
    __slots__ = ("b",)

    def __init__(self, b: Optional[bytearray] = None):
        self.b = bytearray(32) if b is None else bytearray(b)

    def copy(self) -> "ADRS":
        return ADRS(self.b)

    def set_layer(self, v: int) -> None:
        self.b[0:4] = v.to_bytes(4, "big")

    def set_tree(self, v: int) -> None:
        self.b[4:16] = v.to_bytes(12, "big")

    def set_type_and_clear(self, t: int) -> None:
        self.b[16:20] = t.to_bytes(4, "big")
        self.b[20:32] = bytes(12)

    def set_keypair(self, v: int) -> None:
        self.b[20:24] = v.to_bytes(4, "big")

    def set_chain(self, v: int) -> None:      # == tree height word
        self.b[24:28] = v.to_bytes(4, "big")

    set_tree_height = set_chain

    def set_hash(self, v: int) -> None:       # == tree index word
        self.b[28:32] = v.to_bytes(4, "big")

    set_tree_index = set_hash

    def tree_index(self) -> int:
        return int.from_bytes(self.b[28:32], "big")

    def bytes(self) -> bytes:
        return bytes(self.b)


# ---------------------------------------------------------------------------
# integer / bit codecs (§4.1)
# ---------------------------------------------------------------------------

def base_2b(data: bytes, b: int, out_len: int) -> List[int]:
    """MSB-first b-bit groups from a byte string (Algorithm 4)."""
    vals = []
    acc = 0
    bits = 0
    i = 0
    for _ in range(out_len):
        while bits < b:
            acc = (acc << 8) | data[i]
            i += 1
            bits += 8
        bits -= b
        vals.append((acc >> bits) & ((1 << b) - 1))
    return vals


def _wots_digits(msg: bytes, p: ParameterSet) -> List[int]:
    """len1 message nibbles + the 3 checksum nibbles (Algorithms 7/8's
    shared digit schedule: csum left-shifted 4, big-endian)."""
    digits = base_2b(msg, LG_W, p.len1)
    csum = sum(W - 1 - d for d in digits)
    return digits + [(csum >> 8) & 15, (csum >> 4) & 15, csum & 15]


# ---------------------------------------------------------------------------
# hash primitives (SHAKE instantiation, §11.1)
# ---------------------------------------------------------------------------

def _F(pk_seed: bytes, adrs: ADRS, m: bytes, n: int) -> bytes:
    return _shake(pk_seed + adrs.bytes() + m, n)


_H = _F                              # same construction, 2n message
_T = _F                              # same construction, l*n message


def _PRF(pk_seed: bytes, sk_seed: bytes, adrs: ADRS, n: int) -> bytes:
    return _shake(pk_seed + adrs.bytes() + sk_seed, n)


# ---------------------------------------------------------------------------
# WOTS+ / XMSS / FORS host implementation (sign side is fixture-only)
# ---------------------------------------------------------------------------

def _chain(x: bytes, start: int, steps: int, pk_seed: bytes,
           adrs: ADRS, n: int) -> bytes:
    for j in range(start, start + steps):
        adrs.set_hash(j)
        x = _F(pk_seed, adrs, x, n)
    return x


def _wots_pk_gen(sk_seed: bytes, pk_seed: bytes, adrs: ADRS,
                 p: ParameterSet) -> bytes:
    sk_adrs = adrs.copy()
    sk_adrs.set_type_and_clear(_WOTS_PRF)
    sk_adrs.b[20:24] = adrs.b[20:24]
    tmp = b""
    for i in range(p.wlen):
        sk_adrs.set_chain(i)
        sk = _PRF(pk_seed, sk_seed, sk_adrs, p.n)
        adrs.set_chain(i)
        tmp += _chain(sk, 0, W - 1, pk_seed, adrs, p.n)
    pk_adrs = adrs.copy()
    pk_adrs.set_type_and_clear(_WOTS_PK)
    pk_adrs.b[20:24] = adrs.b[20:24]
    return _T(pk_seed, pk_adrs, tmp, p.n)


def _wots_sign(msg: bytes, sk_seed: bytes, pk_seed: bytes, adrs: ADRS,
               p: ParameterSet) -> bytes:
    digits = _wots_digits(msg, p)
    sk_adrs = adrs.copy()
    sk_adrs.set_type_and_clear(_WOTS_PRF)
    sk_adrs.b[20:24] = adrs.b[20:24]
    sig = b""
    for i, dgt in enumerate(digits):
        sk_adrs.set_chain(i)
        sk = _PRF(pk_seed, sk_seed, sk_adrs, p.n)
        adrs.set_chain(i)
        sig += _chain(sk, 0, dgt, pk_seed, adrs, p.n)
    return sig


def _wots_pk_from_sig(sig: bytes, msg: bytes, pk_seed: bytes,
                      adrs: ADRS, p: ParameterSet) -> bytes:
    digits = _wots_digits(msg, p)
    n = p.n
    tmp = b""
    for i, dgt in enumerate(digits):
        adrs.set_chain(i)
        tmp += _chain(sig[i * n: (i + 1) * n], dgt, W - 1 - dgt,
                      pk_seed, adrs, n)
    pk_adrs = adrs.copy()
    pk_adrs.set_type_and_clear(_WOTS_PK)
    pk_adrs.b[20:24] = adrs.b[20:24]
    return _T(pk_seed, pk_adrs, tmp, n)


def _xmss_node(sk_seed: bytes, i: int, z: int, pk_seed: bytes,
               adrs: ADRS, p: ParameterSet) -> bytes:
    if z == 0:
        adrs.set_type_and_clear(_WOTS_HASH)
        adrs.set_keypair(i)
        return _wots_pk_gen(sk_seed, pk_seed, adrs, p)
    l = _xmss_node(sk_seed, 2 * i, z - 1, pk_seed, adrs, p)
    r = _xmss_node(sk_seed, 2 * i + 1, z - 1, pk_seed, adrs, p)
    adrs.set_type_and_clear(_TREE)
    adrs.set_tree_height(z)
    adrs.set_tree_index(i)
    return _H(pk_seed, adrs, l + r, p.n)


def _xmss_sign(msg: bytes, sk_seed: bytes, idx: int, pk_seed: bytes,
               adrs: ADRS, p: ParameterSet) -> bytes:
    auth = b""
    for j in range(p.hp):
        k = (idx >> j) ^ 1
        auth += _xmss_node(sk_seed, k, j, pk_seed, adrs.copy(), p)
    adrs.set_type_and_clear(_WOTS_HASH)
    adrs.set_keypair(idx)
    return _wots_sign(msg, sk_seed, pk_seed, adrs, p) + auth


def _xmss_pk_from_sig(idx: int, sig_xmss: bytes, msg: bytes,
                      pk_seed: bytes, adrs: ADRS,
                      p: ParameterSet) -> bytes:
    n = p.n
    adrs.set_type_and_clear(_WOTS_HASH)
    adrs.set_keypair(idx)
    sig = sig_xmss[: p.wlen * n]
    auth = sig_xmss[p.wlen * n:]
    node = _wots_pk_from_sig(sig, msg, pk_seed, adrs, p)
    adrs.set_type_and_clear(_TREE)
    adrs.set_tree_index(idx)
    for lev in range(p.hp):
        adrs.set_tree_height(lev + 1)
        a_node = auth[lev * n: (lev + 1) * n]
        if (idx >> lev) & 1 == 0:
            adrs.set_tree_index(adrs.tree_index() // 2)
            node = _H(pk_seed, adrs, node + a_node, n)
        else:
            adrs.set_tree_index((adrs.tree_index() - 1) // 2)
            node = _H(pk_seed, adrs, a_node + node, n)
    return node


def _fors_node(sk_seed: bytes, i: int, z: int, pk_seed: bytes,
               adrs: ADRS, p: ParameterSet) -> bytes:
    if z == 0:
        sk_adrs = adrs.copy()
        sk_adrs.set_type_and_clear(_FORS_PRF)
        sk_adrs.b[20:24] = adrs.b[20:24]
        sk_adrs.set_tree_index(i)
        sk = _PRF(pk_seed, sk_seed, sk_adrs, p.n)
        adrs.set_tree_height(0)
        adrs.set_tree_index(i)
        return _F(pk_seed, adrs, sk, p.n)
    l = _fors_node(sk_seed, 2 * i, z - 1, pk_seed, adrs, p)
    r = _fors_node(sk_seed, 2 * i + 1, z - 1, pk_seed, adrs, p)
    adrs.set_tree_height(z)
    adrs.set_tree_index(i)
    return _H(pk_seed, adrs, l + r, p.n)


def _fors_sign(md: bytes, sk_seed: bytes, pk_seed: bytes, adrs: ADRS,
               p: ParameterSet) -> bytes:
    indices = base_2b(md, p.a, p.k)
    sig = b""
    for i, idx in enumerate(indices):
        sk_adrs = adrs.copy()
        sk_adrs.set_type_and_clear(_FORS_PRF)
        sk_adrs.b[20:24] = adrs.b[20:24]
        sk_adrs.set_tree_index(i * (1 << p.a) + idx)
        sig += _PRF(pk_seed, sk_seed, sk_adrs, p.n)
        for j in range(p.a):
            s = (idx >> j) ^ 1
            sig += _fors_node(sk_seed, i * (1 << (p.a - j)) + s, j,
                              pk_seed, adrs.copy(), p)
    return sig


def _fors_pk_from_sig(sig_fors: bytes, md: bytes, pk_seed: bytes,
                      adrs: ADRS, p: ParameterSet) -> bytes:
    n = p.n
    indices = base_2b(md, p.a, p.k)
    roots = b""
    for i, idx in enumerate(indices):
        off = i * (1 + p.a) * n
        sk = sig_fors[off: off + n]
        adrs.set_tree_height(0)
        adrs.set_tree_index(i * (1 << p.a) + idx)
        node = _F(pk_seed, adrs, sk, n)
        auth = sig_fors[off + n: off + (1 + p.a) * n]
        for j in range(p.a):
            a_node = auth[j * n: (j + 1) * n]
            adrs.set_tree_height(j + 1)
            if (idx >> j) & 1 == 0:
                adrs.set_tree_index(adrs.tree_index() // 2)
                node = _H(pk_seed, adrs, node + a_node, n)
            else:
                adrs.set_tree_index((adrs.tree_index() - 1) // 2)
                node = _H(pk_seed, adrs, a_node + node, n)
        roots += node
    pk_adrs = adrs.copy()
    pk_adrs.set_type_and_clear(_FORS_ROOTS)
    pk_adrs.b[20:24] = adrs.b[20:24]
    return _T(pk_seed, pk_adrs, roots, n)


# ---------------------------------------------------------------------------
# message digest split (§9.3 / §10.2)
# ---------------------------------------------------------------------------

def _digest_split(digest: bytes,
                  p: ParameterSet) -> Tuple[bytes, int, int]:
    ka8 = (p.k * p.a + 7) // 8
    t8 = (p.h - p.hp + 7) // 8
    l8 = (p.hp + 7) // 8
    md = digest[:ka8]
    idx_tree = int.from_bytes(digest[ka8: ka8 + t8], "big") \
        % (1 << (p.h - p.hp))
    idx_leaf = int.from_bytes(digest[ka8 + t8: ka8 + t8 + l8], "big") \
        % (1 << p.hp)
    return md, idx_tree, idx_leaf


def _m_prime(message: bytes, ctx: bytes) -> bytes:
    return b"\x00" + bytes([len(ctx)]) + ctx + message


# ---------------------------------------------------------------------------
# key objects + keygen + fixture signer
# ---------------------------------------------------------------------------

class SLHDSAPublicKey:
    """SLH-DSA public key: parameter set + (PK.seed ‖ PK.root).

    Duck-typed for the JWK/keyset layer exactly like
    ``MLDSAPublicKey``: ``parameter_set`` routes ``key_matches_alg``
    and the AKP JWK serialization; ``pk`` is the FIPS 205 encoding.
    """

    __slots__ = ("parameter_set", "pk", "pk_seed", "pk_root")

    def __init__(self, parameter_set: str, pk: bytes):
        if parameter_set not in PARAMS:
            raise ValueError(
                f"unknown SLH-DSA parameter set {parameter_set!r}")
        p = PARAMS[parameter_set]
        if len(pk) != p.pk_size:
            raise ValueError(
                f"{p.name} public key must be {p.pk_size} bytes, "
                f"got {len(pk)}")
        self.parameter_set = parameter_set
        self.pk = bytes(pk)
        self.pk_seed = self.pk[: p.n]
        self.pk_root = self.pk[p.n:]

    @property
    def params(self) -> ParameterSet:
        return PARAMS[self.parameter_set]

    def verify(self, signature: bytes, message: bytes) -> bool:
        return py_verify(self, signature, message)


class SLHDSAPrivateKey:
    """Fixture-only deterministic signer (opt_rand = PK.seed, the
    FIPS 205 deterministic variant). Exists to mint KATs, bench
    tokens, and chaos traffic — never production signing."""

    __slots__ = ("public_key", "sk_seed", "sk_prf")

    def __init__(self, pub: SLHDSAPublicKey, sk_seed: bytes,
                 sk_prf: bytes):
        self.public_key = pub
        self.sk_seed = sk_seed
        self.sk_prf = sk_prf

    def sign(self, message: bytes, ctx: bytes = b"") -> bytes:
        if len(ctx) > 255:
            raise ValueError("ctx must be at most 255 bytes")
        pub = self.public_key
        p = pub.params
        n = p.n
        m_prime = _m_prime(message, ctx)
        r = _shake(self.sk_prf + pub.pk_seed + m_prime, n)  # PRF_msg
        digest = _shake(r + pub.pk_seed + pub.pk_root + m_prime, p.m)
        md, idx_tree, idx_leaf = _digest_split(digest, p)
        adrs = ADRS()
        adrs.set_tree(idx_tree)
        adrs.set_type_and_clear(_FORS_TREE)
        adrs.set_keypair(idx_leaf)
        sig = r + _fors_sign(md, self.sk_seed, pub.pk_seed, adrs, p)
        pk_fors = _fors_pk_from_sig(sig[n:], md, pub.pk_seed,
                                    adrs.copy(), p)
        # ht_sign
        node = pk_fors
        itree, ileaf = idx_tree, idx_leaf
        for layer in range(p.d):
            a2 = ADRS()
            a2.set_layer(layer)
            a2.set_tree(itree)
            sig_x = _xmss_sign(node, self.sk_seed, ileaf, pub.pk_seed,
                               a2, p)
            sig += sig_x
            if layer < p.d - 1:
                node = _xmss_pk_from_sig(
                    ileaf, sig_x, node, pub.pk_seed, _layer_adrs(
                        layer, itree), p)
                ileaf = itree & ((1 << p.hp) - 1)
                itree >>= p.hp
        return sig


def _layer_adrs(layer: int, itree: int) -> ADRS:
    a = ADRS()
    a.set_layer(layer)
    a.set_tree(itree)
    return a


def keygen(parameter_set: str,
           seed: bytes) -> Tuple[SLHDSAPrivateKey, SLHDSAPublicKey]:
    """slh_keygen_internal from one 32-byte fixture seed (SK.seed,
    SK.prf, PK.seed expand from it; PK.root is the top XMSS root)."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    p = PARAMS[parameter_set]
    n = p.n
    hh = _shake(seed + bytes([p.d, p.k]), 3 * n)
    sk_seed, sk_prf, pk_seed = hh[:n], hh[n: 2 * n], hh[2 * n:]
    adrs = ADRS()
    adrs.set_layer(p.d - 1)
    pk_root = _xmss_node(sk_seed, 0, p.hp, pk_seed, adrs, p)
    pub = SLHDSAPublicKey(parameter_set, pk_seed + pk_root)
    return SLHDSAPrivateKey(pub, sk_seed, sk_prf), pub


# ---------------------------------------------------------------------------
# pure-hashlib host oracle
# ---------------------------------------------------------------------------

def py_verify(pub: SLHDSAPublicKey, signature: bytes,
              message: bytes, ctx: bytes = b"") -> bool:
    """slh_verify (Algorithm 24), entirely host-side hashlib.

    The oracle of last resort AND the engine's parity reference —
    malformed and adversarial inputs included. The only reject gate
    is the signature length; everything else lands in the final root
    compare (the FIPS 205 shape: no malleable encodings to police).
    """
    p = pub.params
    sig = bytes(signature)
    if len(sig) != p.sig_size or len(ctx) > 255:
        return False
    n = p.n
    m_prime = _m_prime(bytes(message), ctx)
    r = sig[:n]
    sig_fors = sig[n: n + p.k * (1 + p.a) * n]
    sig_ht = sig[n + p.k * (1 + p.a) * n:]
    digest = _shake(r + pub.pk_seed + pub.pk_root + m_prime, p.m)
    md, idx_tree, idx_leaf = _digest_split(digest, p)
    adrs = ADRS()
    adrs.set_tree(idx_tree)
    adrs.set_type_and_clear(_FORS_TREE)
    adrs.set_keypair(idx_leaf)
    node = _fors_pk_from_sig(sig_fors, md, pub.pk_seed, adrs, p)
    # ht_verify
    itree, ileaf = idx_tree, idx_leaf
    xmss_bytes = (p.wlen + p.hp) * n
    for layer in range(p.d):
        sig_x = sig_ht[layer * xmss_bytes: (layer + 1) * xmss_bytes]
        node = _xmss_pk_from_sig(ileaf, sig_x, node, pub.pk_seed,
                                 _layer_adrs(layer, itree), p)
        ileaf = itree & ((1 << p.hp) - 1)
        itree >>= p.hp
    return node == pub.pk_root


# ---------------------------------------------------------------------------
# device engine: batched Keccak lanes over the keccak kernel
# ---------------------------------------------------------------------------
#
# Lane tensors are int32 ``[..., L, 2]`` bit-interleaved words, the
# Keccak layout of ``gpu/keccak.py``; the host builds them as uint32
# numpy (the JAX package's arrays) and views them as int32 on the way
# to the device.

def _il_pairs(raw: bytes, n_vals: int) -> np.ndarray:
    """n-byte hash values packed back-to-back -> interleaved lanes
    uint32 [n_vals, 2, 2] (16-byte values = 2 u64 lanes each)."""
    arr = np.frombuffer(raw, np.uint8).view("<u8").reshape(n_vals, 2)
    return _kk.interleave(arr)


@functools.lru_cache(maxsize=None)
def _tail_pad(total_bytes: int) -> np.ndarray:
    """XOR pad uint32 [nb, 25, 2] for a fixed ``total_bytes`` SHAKE256
    absorb (nb = total//136 + 1; pad10*1 always adds a byte)."""
    nb = total_bytes // 136 + 1
    buf = np.zeros(nb * 136, np.uint8)
    buf[total_bytes] = _kk.DOMAIN_SHAKE
    buf[nb * 136 - 1] ^= 0x80
    out = np.zeros((nb, 25, 2), np.uint32)
    out[:, :17] = _kk.interleave(buf.view("<u8")).reshape(nb, 17, 2)
    return out


@functools.lru_cache(maxsize=None)
def _tail_pad_dev(total_bytes: int, device: torch.device) -> torch.Tensor:
    return _kk.to_device(_tail_pad(total_bytes), device)


def _hash_lanes(psd: torch.Tensor, adrs: torch.Tensor,
                msg_lanes: torch.Tensor) -> torch.Tensor:
    """Batched F/H/T: SHAKE256(pk_seed ‖ ADRS ‖ msg, 16) on interleaved
    lanes. psd [..., 2, 2] broadcastable, adrs [..., 4, 2], msg_lanes
    [..., L, 2] -> [..., 2, 2]. One keccak launch a 136-byte block."""
    lead = msg_lanes.shape[:-2]
    content = torch.cat([psd.expand(lead + (2, 2)),
                         adrs.expand(lead + (4, 2)), msg_lanes], dim=-2)
    nl = content.shape[-2]
    total = 8 * nl
    nb = total // 136 + 1
    zeros = content.new_zeros
    content = torch.cat([content, zeros(lead + (nb * 17 - nl, 2))], dim=-2)
    blocks = torch.cat([content.reshape(lead + (nb, 17, 2)),
                        zeros(lead + (nb, 8, 2))], dim=-2)
    blocks = blocks ^ _tail_pad_dev(total, msg_lanes.device)
    return _kk.absorb_fixed(blocks)[..., :2, :]


def _with_hash_addr(adrs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """ADRS lanes [..., 4, 2] with the dynamic WOTS hash-address word
    (bytes 28-31, value < 16) injected on the device: the value's 4 bits
    land at u64-lane-3 bits 56-59, i.e. interleaved-word bits 28/29."""
    v = v.to(torch.int32)
    e_add = ((v & 1) << 28) | (((v >> 2) & 1) << 29)
    o_add = (((v >> 1) & 1) << 28) | (((v >> 3) & 1) << 29)
    delta = torch.stack([e_add, o_add], dim=-1)[..., None, :]  # [...,1,2]
    zero = delta.new_zeros(delta.shape[:-2] + (3, 2))
    return adrs ^ torch.cat([zero, delta], dim=-2)


def _digits_from_node(node: torch.Tensor) -> torch.Tensor:
    """WOTS+ message digits [..., 35] (len1 nibbles MSB-first per byte
    + 3 checksum nibbles) from a 16-byte node in interleaved lanes."""
    by = _kk.lanes_to_bytes(node)                         # [..., 16]
    digs = torch.stack([by >> 4, by & 15], dim=-1) \
        .reshape(by.shape[:-1] + (32,))
    csum = (W - 1 - digs).sum(dim=-1, dtype=torch.int32)
    tail = torch.stack([csum >> 8, (csum >> 4) & 15, csum & 15], dim=-1)
    return torch.cat([digs, tail], dim=-1)                # [..., 35]


def _slh_core(pk_seed_l, pk_root_l, key_idx, valid,
              fors_sk, fors_adrs, fors_sel, fors_auth, tk_adrs,
              wots_sig, chain_adrs, tlen_adrs,
              xmss_auth, xmss_adrs, xmss_sel) -> torch.Tensor:
    """The whole verify graph of one chunk: [B] accept bits.

    fors_sk [B,k,2,2]; fors_adrs [B,k,a+1,4,2] (level 0 = leaf F);
    fors_sel [B,k,a]; fors_auth [B,k,a,2,2]; tk_adrs [B,4,2];
    wots_sig [d,B,len,2,2]; chain_adrs [d,B,len,4,2] (hash word 0);
    tlen_adrs [d,B,4,2]; xmss_auth [d,B,hp,2,2]; xmss_adrs
    [d,B,hp,4,2]; xmss_sel [d,B,hp]. The shapes carry every parameter.
    """
    b, k = fors_sk.shape[0], fors_sk.shape[1]
    a = fors_auth.shape[2]
    hp = xmss_auth.shape[2]
    psd = pk_seed_l[key_idx]                              # [B, 2, 2]
    psd_k = psd[:, None]                                  # [B, 1, 2, 2]

    # FORS: k leaves in parallel, then a auth folds, then T_k
    node = _hash_lanes(psd_k, fors_adrs[:, :, 0], fors_sk)
    for j in range(a):
        s = fors_sel[:, :, j, None, None]
        left = torch.where(s, fors_auth[:, :, j], node)
        right = torch.where(s, node, fors_auth[:, :, j])
        node = _hash_lanes(psd_k, fors_adrs[:, :, j + 1],
                           torch.cat([left, right], dim=-2))
    node = _hash_lanes(psd, tk_adrs, node.reshape(b, 2 * k, 2))

    # the hypertree, one layer after another (the JAX package's scan)
    for layer in range(wots_sig.shape[0]):
        c_adrs = chain_adrs[layer]
        digits = _digits_from_node(node)                  # [B, len]
        vals = wots_sig[layer]                            # [B, len, 2, 2]
        for t in range(W - 1):
            # lanes past their digit's chain end keep their value; the
            # address of such a lane (digit + t > 14) is never used
            active = digits <= W - 2 - t
            nxt = _hash_lanes(psd[:, None],
                              _with_hash_addr(c_adrs, digits + t), vals)
            vals = torch.where(active[..., None, None], nxt, vals)
        wlen = vals.shape[1]
        node = _hash_lanes(psd, tlen_adrs[layer],
                           vals.reshape(b, 2 * wlen, 2))
        for lev in range(hp):
            s = xmss_sel[layer][:, lev, None, None]
            auth = xmss_auth[layer][:, lev]
            node = _hash_lanes(psd, xmss_adrs[layer][:, lev],
                               torch.cat([torch.where(s, auth, node),
                                          torch.where(s, node, auth)],
                                         dim=-2))
    ok = (node == pk_root_l[key_idx]).all(dim=-1).all(dim=-1)
    return ok & valid


def chunk_launches(p: ParameterSet) -> int:
    """Keccak launches of one chunk of :func:`_slh_core`: one a block of
    every absorb (FORS leaf, a folds, T_k; per layer 15 chain steps,
    T_len and hp folds)."""
    def nb(msg_lanes: int) -> int:
        return 8 * (6 + msg_lanes) // 136 + 1

    return (nb(2) + p.a * nb(4) + nb(2 * p.k)
            + p.d * ((W - 1) * nb(2) + nb(2 * p.wlen) + p.hp * nb(4)))


class SLHDSAKeyTable:
    """Key material of ONE parameter set on a device: PK.seed lanes (the
    first 16 bytes of every F/H/T input) and PK.root compare lanes,
    int32 [nk, 2, 2] each (``pk_seed_l``, ``pk_root_l``)."""

    def __init__(self, parameter_set: str, keys: Sequence[SLHDSAPublicKey],
                 device="cuda", pk_seed_l: Optional[np.ndarray] = None,
                 pk_root_l: Optional[np.ndarray] = None):
        self.parameter_set = parameter_set
        self.params = PARAMS[parameter_set]
        self.keys = list(keys)
        if pk_seed_l is None:
            pk_seed_l = _il_pairs(b"".join(k.pk_seed for k in self.keys),
                                  len(self.keys))
        if pk_root_l is None:
            pk_root_l = _il_pairs(b"".join(k.pk_root for k in self.keys),
                                  len(self.keys))
        self.pk_seed_l = _kk.to_device(np.asarray(pk_seed_l), device)
        self.pk_root_l = _kk.to_device(np.asarray(pk_root_l), device)

    @property
    def device(self) -> torch.device:
        return self.pk_seed_l.device


class _SLHPrep:
    """Host-side decode of one chunk: sig split, the single H_msg SHAKE,
    index derivation, and EVERY ADRS as interleaved lanes. Pure byte
    shuffling plus one hashlib call per token (the JAX package's
    decode, array for array)."""

    __slots__ = ("valid", "key_idx", "fors_sk", "fors_adrs",
                 "fors_sel", "fors_auth", "tk_adrs", "wots_sig",
                 "chain_adrs", "tlen_adrs", "xmss_auth", "xmss_adrs",
                 "xmss_sel", "m")

    def __init__(self, table: SLHDSAKeyTable, sigs: Sequence[bytes],
                 msgs: Sequence[bytes], key_idx: np.ndarray,
                 pad: int):
        p = table.params
        n, k, a, d, hp, wlen = (p.n, p.k, p.a, p.d, p.hp, p.wlen)
        m = len(sigs)
        self.m = m
        self.valid = np.zeros(pad, bool)
        self.key_idx = np.zeros(pad, np.int32)
        self.key_idx[:m] = np.asarray(key_idx, np.int32)[:m]
        self.fors_sk = np.zeros((pad, k, 2, 2), np.uint32)
        self.fors_auth = np.zeros((pad, k, a, 2, 2), np.uint32)
        self.fors_sel = np.zeros((pad, k, a), bool)
        fors_adrs8 = np.zeros((pad, k, a + 1, 32), np.uint8)
        tk_adrs8 = np.zeros((pad, 32), np.uint8)
        self.wots_sig = np.zeros((d, pad, wlen, 2, 2), np.uint32)
        chain_adrs8 = np.zeros((d, pad, wlen, 32), np.uint8)
        tlen_adrs8 = np.zeros((d, pad, 32), np.uint8)
        self.xmss_auth = np.zeros((d, pad, hp, 2, 2), np.uint32)
        xmss_adrs8 = np.zeros((d, pad, hp, 32), np.uint8)
        self.xmss_sel = np.zeros((d, pad, hp), bool)
        xmss_bytes = (wlen + hp) * n

        for i in range(m):
            sig = bytes(sigs[i])
            if len(sig) != p.sig_size:
                continue
            self.valid[i] = True
            key = table.keys[int(self.key_idx[i])]
            r = sig[:n]
            sig_fors = sig[n: n + k * (1 + a) * n]
            sig_ht = sig[n + k * (1 + a) * n:]
            digest = _shake(r + key.pk_seed + key.pk_root
                            + _m_prime(bytes(msgs[i]), b""), p.m)
            md, idx_tree, idx_leaf = _digest_split(digest, p)
            indices = base_2b(md, a, k)

            adrs = ADRS()
            adrs.set_tree(idx_tree)
            adrs.set_type_and_clear(_FORS_TREE)
            adrs.set_keypair(idx_leaf)
            for t in range(k):
                off = t * (1 + a) * n
                self.fors_sk[i, t] = _il_pairs(
                    sig_fors[off: off + n], 1)[0]
                self.fors_auth[i, t] = _il_pairs(
                    sig_fors[off + n: off + (1 + a) * n], a)
                idx = indices[t]
                adrs.set_tree_height(0)
                adrs.set_tree_index(t * (1 << a) + idx)
                fors_adrs8[i, t, 0] = np.frombuffer(adrs.bytes(),
                                                    np.uint8)
                ti = t * (1 << a) + idx
                for j in range(a):
                    self.fors_sel[i, t, j] = bool((idx >> j) & 1)
                    ti //= 2
                    adrs.set_tree_height(j + 1)
                    adrs.set_tree_index(ti)
                    fors_adrs8[i, t, j + 1] = np.frombuffer(
                        adrs.bytes(), np.uint8)
            tk = adrs.copy()
            tk.set_type_and_clear(_FORS_ROOTS)
            tk.set_keypair(idx_leaf)
            tk_adrs8[i] = np.frombuffer(tk.bytes(), np.uint8)

            itree, ileaf = idx_tree, idx_leaf
            for layer in range(d):
                sig_x = sig_ht[layer * xmss_bytes:
                               (layer + 1) * xmss_bytes]
                self.wots_sig[layer, i] = _il_pairs(
                    sig_x[: wlen * n], wlen)
                self.xmss_auth[layer, i] = _il_pairs(
                    sig_x[wlen * n:], hp)
                base = ADRS()
                base.set_layer(layer)
                base.set_tree(itree)
                base.set_type_and_clear(_WOTS_HASH)
                base.set_keypair(ileaf)
                for c in range(wlen):
                    base.set_chain(c)
                    chain_adrs8[layer, i, c] = np.frombuffer(
                        base.bytes(), np.uint8)
                tl = base.copy()
                tl.set_type_and_clear(_WOTS_PK)
                tl.set_keypair(ileaf)
                tlen_adrs8[layer, i] = np.frombuffer(tl.bytes(),
                                                     np.uint8)
                tr = base.copy()
                tr.set_type_and_clear(_TREE)
                ti = ileaf
                for lev in range(hp):
                    self.xmss_sel[layer, i, lev] = bool(
                        (ileaf >> lev) & 1)
                    ti //= 2
                    tr.set_tree_height(lev + 1)
                    tr.set_tree_index(ti)
                    xmss_adrs8[layer, i, lev] = np.frombuffer(
                        tr.bytes(), np.uint8)
                ileaf = itree & ((1 << hp) - 1)
                itree >>= hp

        def il_adrs(arr8):
            return _kk.interleave(
                np.ascontiguousarray(arr8).view("<u8"))

        self.fors_adrs = il_adrs(fors_adrs8)
        self.tk_adrs = il_adrs(tk_adrs8)
        self.chain_adrs = il_adrs(chain_adrs8)
        self.tlen_adrs = il_adrs(tlen_adrs8)
        self.xmss_adrs = il_adrs(xmss_adrs8)

    def arrays(self) -> tuple:
        """The device inputs of :func:`_slh_core` after the key tables,
        in its argument order (numpy, uint32 lanes)."""
        return (self.key_idx, self.valid, self.fors_sk,
                self.fors_adrs, self.fors_sel, self.fors_auth,
                self.tk_adrs, self.wots_sig, self.chain_adrs,
                self.tlen_adrs, self.xmss_auth, self.xmss_adrs,
                self.xmss_sel)


def pad_rows(m: int) -> int:
    """The JAX package's pad: a power of two with a 16-row floor."""
    pad = 16
    while pad < m:
        pad *= 2
    return pad


def verify_slhdsa_pending(table: SLHDSAKeyTable, sigs: Sequence[bytes],
                          msgs: Sequence[bytes], key_idx: np.ndarray,
                          pad: Optional[int] = None, mesh=None):
    """Decode one chunk now and queue its hash forest on the table's
    device; returns the device [pad] bool verdicts (read by the
    caller's one sync).

    Wrong-length signatures finish False without touching the device,
    the verdicts ``py_verify`` gives (the length is SLH-DSA's only
    non-root reject gate); when no row is valid nothing is queued.

    With a ``mesh``, as in the JAX package, the arrays whose axis 0 is
    the chunk's ``pad`` rows shard along it and the layer-major ones
    (the batch on axis 1) replicate; each shard's forest runs on its
    device over its own columns of those, and the verdicts come back as
    :class:`..parallel.place.Sharded` in batch order.
    """
    if pad is None:
        pad = pad_rows(len(sigs))
    prep = _SLHPrep(table, sigs, msgs, key_idx, pad)
    if mesh is not None:
        return _slh_sharded(table, prep, pad, mesh)
    dev = table.device
    if not prep.valid.any():
        return torch.zeros(pad, dtype=torch.bool, device=dev)
    arrs = [_kk.to_device(x, dev) for x in prep.arrays()]
    arrs[0] = arrs[0].to(torch.int64)                    # key rows
    return _slh_core(table.pk_seed_l, table.pk_root_l, *arrs)


# the key table's tensors, replicated on every device of a mesh
TABLE_TENSORS = ("pk_seed_l", "pk_root_l")


def _slh_sharded(table: SLHDSAKeyTable, prep: "_SLHPrep", pad: int, mesh):
    """:func:`verify_slhdsa_pending`'s chunk over a mesh."""
    from ..parallel.place import (Sharded, broadcast, on_shards,
                                  replicated_views, shard_batch,
                                  shard_bounds)

    bounds = shard_bounds(mesh, pad)
    if not prep.valid.any():
        return Sharded(mesh, [torch.zeros(sl.stop - sl.start,
                                          dtype=torch.bool, device=d)
                              for sl, d in zip(bounds, mesh.devices)])
    views = replicated_views(mesh, table, TABLE_TENSORS)
    arrs = prep.arrays()
    rows = [a.shape[0] == pad for a in arrs]
    # the layer-major arrays whole on each device (this chunk's data,
    # so not through the table cache)
    reps = [None if r else broadcast(mesh, a) for a, r in zip(arrs, rows)]
    sharded = [shard_batch(mesh, a) for a, r in zip(arrs, rows) if r]

    def shard(i, *parts):
        it = iter(parts)
        args = [next(it) if r else rep[i][:, bounds[i]]
                for r, rep in zip(rows, reps)]
        args[0] = args[0].to(torch.int64)                # key rows
        return _slh_core(views[i].pk_seed_l, views[i].pk_root_l, *args)

    return on_shards(mesh, shard, *sharded)


def verify_slhdsa_batch(table: SLHDSAKeyTable, sigs: Sequence[bytes],
                        msgs: Sequence[bytes], key_idx: np.ndarray,
                        mesh=None) -> np.ndarray:
    """[N] bool verdicts for one SLH-DSA bucket (blocking), sharded over
    ``mesh`` if one is given."""
    out = verify_slhdsa_pending(table, sigs, msgs, key_idx, mesh=mesh)
    return out.cpu().numpy()[:len(sigs)]
