"""Batched ML-DSA (FIPS 204) signature verification.

The port of the JAX package's ``tpu/mldsa.py``, fused engine: per
chunk the host decodes bytes only (length, hint and z-range gates,
z/hint unpacking, μ-input block packing, c̃ as lanes), and one device
pass computes everything else:

- μ = SHAKE256(tr ‖ 0 ‖ 0 ‖ M, 64), a masked absorb, SampleInBall's
  SHAKE256(c̃) absorb and squeeze, and the c̃ recompute
  SHAKE256(μ ‖ w1Encode(w1), λ/4): the Keccak kernel
  (``gpu/keccak.py``, ``csrc/keccak.cu``), 14 launches a chunk for
  ML-DSA-44/65 messages of up to 4 blocks;
- NTT(z), NTT(c), the Â∘ẑ − ĉ∘(t̂1·2^d) sum against the key table,
  the inverse NTT and UseHint: the NTT kernels (``gpu/ntt.py``,
  ``csrc/ntt.cu``), 2 forward and 1 inverse launch a chunk;
- SampleInBall itself, a τ-step walk of gathers and selects in
  PyTorch, and the final compare.

A chunk's states never leave the card until its two bit vectors
(accept, exhausted) do. A lane whose SampleInBall walk runs past the
3-block squeeze flags ``exhausted`` and is re-verified on
:func:`py_verify`, the pure-integer host oracle (numpy int64 over
``ntt.ntt_ref``), which is also the keyset's trial path. Keygen and a
deterministic signer exist only to make fixtures.

The two-phase arm (:func:`verify_mldsa_batch`; the JAX keyset's
``CAP_TPU_MLDSA_FUSED=0``) keeps the hashing on the host: the chunk's
decode, μ and SampleInBall by hashlib SHAKE (:class:`_PreppedChunk`),
then the w1 network alone on the device (:func:`verify_mldsa_core_pending`:
2 ntt and 1 intt launches a chunk, no Keccak), then w1Encode and the
c̃ compare on the host.

``host_shake_calls`` counts every host SHAKE this module computes:
per key (tr, ExpandA at table build) and in the oracle and signer,
never per token on the fused path (three a token on the two-phase
arm).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import keccak as _kk
from . import ntt as _ntt

Q = _ntt.Q
N = 256
D = 13                               # dropped t bits (all parameter sets)

host_shake_calls = 0


class ParameterSet:
    """One FIPS 204 parameter set (Table 1) plus derived sizes."""

    __slots__ = ("name", "k", "l", "eta", "tau", "lam", "gamma1",
                 "gamma2", "omega", "beta", "z_bits", "w1_bits",
                 "pk_size", "sig_size", "m")

    def __init__(self, name: str, k: int, l: int, eta: int, tau: int,
                 lam: int, gamma1: int, gamma2: int, omega: int):
        self.name = name
        self.k, self.l = k, l
        self.eta, self.tau, self.lam = eta, tau, lam
        self.gamma1, self.gamma2, self.omega = gamma1, gamma2, omega
        self.beta = tau * eta
        self.z_bits = 1 + (gamma1 - 1).bit_length()       # 18 or 20
        self.m = (Q - 1) // (2 * gamma2)                  # 44 or 16
        self.w1_bits = (self.m - 1).bit_length()          # 6 or 4
        self.pk_size = 32 + 32 * 10 * k
        self.sig_size = lam // 4 + l * 32 * self.z_bits + omega + k


PARAMS: Dict[str, ParameterSet] = {
    "ML-DSA-44": ParameterSet("ML-DSA-44", 4, 4, 2, 39, 128,
                              1 << 17, (Q - 1) // 88, 80),
    "ML-DSA-65": ParameterSet("ML-DSA-65", 6, 5, 4, 49, 192,
                              1 << 19, (Q - 1) // 32, 55),
    "ML-DSA-87": ParameterSet("ML-DSA-87", 8, 7, 2, 60, 256,
                              1 << 19, (Q - 1) // 32, 75),
}

MLDSA_ALGS = tuple(PARAMS)           # the JOSE alg names ARE the set names


def _shake256(data: bytes, outlen: int) -> bytes:
    global host_shake_calls
    host_shake_calls += 1
    return hashlib.shake_256(data).digest(outlen)


def _shake128(data: bytes, outlen: int) -> bytes:
    global host_shake_calls
    host_shake_calls += 1
    return hashlib.shake_128(data).digest(outlen)


# ---------------------------------------------------------------------------
# bit packing (FIPS 204 §7.1: IntegerToBits is little-endian, bytes
# fill LSB-first)
# ---------------------------------------------------------------------------

def bitpack(arr: np.ndarray, bits: int) -> np.ndarray:
    """[..., n] non-negative ints < 2^bits → uint8 [..., n·bits/8]."""
    a = np.asarray(arr, np.int64)
    b = ((a[..., :, None] >> np.arange(bits)) & 1).astype(np.uint8)
    flat = b.reshape(a.shape[:-1] + (a.shape[-1] * bits,))
    return np.packbits(flat, axis=-1, bitorder="little")


def bitunpack(buf: np.ndarray, bits: int, n: int) -> np.ndarray:
    """uint8 [..., n·bits/8] → int64 [..., n] (inverse of bitpack), for
    bits ≤ 24: each value is read from the four bytes that start at its
    first bit."""
    if not 0 < bits <= 24:
        raise ValueError(f"bitunpack takes 1..24 bits, got {bits}")
    u = np.asarray(buf, np.uint8)
    first = np.arange(n) * bits
    off, shift = first // 8, first % 8
    padded = np.zeros(u.shape[:-1] + (u.shape[-1] + 3,), np.uint32)
    padded[..., : u.shape[-1]] = u
    word = (padded[..., off] | (padded[..., off + 1] << 8)
            | (padded[..., off + 2] << 16) | (padded[..., off + 3] << 24))
    return ((word >> shift.astype(np.uint32))
            & np.uint32((1 << bits) - 1)).astype(np.int64)


# ---------------------------------------------------------------------------
# host sampling (SHAKE expansion; the rejection loops grow and retry,
# which re-absorbs the same prefix: outputs equal a streaming squeeze)
# ---------------------------------------------------------------------------

def _rej_ntt_poly(seed: bytes) -> np.ndarray:
    """RejNTTPoly (Alg 30): 23-bit rejection sampling from SHAKE128."""
    outlen = 1024                    # 341 triples ≈ 256/0.999 needed
    while True:
        buf = np.frombuffer(_shake128(seed, outlen), np.uint8)
        t = buf[: len(buf) - len(buf) % 3].reshape(-1, 3).astype(np.int64)
        vals = t[:, 0] | (t[:, 1] << 8) | ((t[:, 2] & 0x7F) << 16)
        vals = vals[vals < Q]
        if len(vals) >= N:
            return vals[:N]
        outlen *= 2


def expand_a(rho: bytes, p: ParameterSet) -> np.ndarray:
    """ExpandA (Alg 32): the NTT-domain [k, l, 256] public matrix."""
    out = np.empty((p.k, p.l, N), np.int64)
    for r in range(p.k):
        for s in range(p.l):
            out[r, s] = _rej_ntt_poly(rho + bytes([s, r]))
    return out


def _rej_bounded_poly(seed: bytes, eta: int) -> np.ndarray:
    """RejBoundedPoly (Alg 31): centered coefficients in [-η, η]."""
    outlen = 192
    while True:
        buf = np.frombuffer(_shake256(seed, outlen), np.uint8)
        z = np.stack([buf & 0xF, buf >> 4], axis=1).reshape(-1) \
            .astype(np.int64)
        if eta == 2:
            z = z[z < 15]
            z = 2 - z % 5
        else:                        # eta == 4
            z = z[z < 9]
            z = 4 - z
        if len(z) >= N:
            return z[:N]
        outlen *= 2


def expand_s(rho_prime: bytes,
             p: ParameterSet) -> Tuple[np.ndarray, np.ndarray]:
    """ExpandS (Alg 33): secret vectors s1 [l, 256], s2 [k, 256]."""
    s1 = np.stack([_rej_bounded_poly(rho_prime + r.to_bytes(2, "little"),
                                     p.eta) for r in range(p.l)])
    s2 = np.stack([_rej_bounded_poly(rho_prime
                                     + (p.l + r).to_bytes(2, "little"),
                                     p.eta) for r in range(p.k)])
    return s1, s2


def expand_mask(rho2: bytes, kappa: int, p: ParameterSet) -> np.ndarray:
    """ExpandMask (Alg 34): the signer's y vector [l, 256], centered."""
    c = p.z_bits
    out = np.empty((p.l, N), np.int64)
    for r in range(p.l):
        v = _shake256(rho2 + (kappa + r).to_bytes(2, "little"), 32 * c)
        out[r] = p.gamma1 - bitunpack(np.frombuffer(v, np.uint8), c, N)
    return out


def sample_in_ball(c_tilde: bytes, p: ParameterSet) -> np.ndarray:
    """SampleInBall (Alg 29): τ ±1 coefficients, centered int64 [256]."""
    outlen = 8 + 8 * p.tau
    while True:
        buf = _shake256(c_tilde, outlen)
        signs = int.from_bytes(buf[:8], "little")
        c = np.zeros(N, np.int64)
        pos = 8
        ok = True
        for i in range(N - p.tau, N):
            while True:
                if pos >= len(buf):
                    ok = False
                    break
                j = buf[pos]
                pos += 1
                if j <= i:
                    break
            if not ok:
                break
            c[i] = c[j]
            c[j] = 1 - 2 * (signs & 1)
            signs >>= 1
        if ok:
            return c
        outlen *= 2


# ---------------------------------------------------------------------------
# rounding (FIPS 204 §7.4) — numpy int64, centered representations
# ---------------------------------------------------------------------------

def power2round(t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(t1, t0) with t = t1·2^d + t0, t0 centered in (-2^{d-1}, 2^{d-1}]."""
    t = np.asarray(t, np.int64)
    rm = t % (1 << D)
    r0 = np.where(rm > (1 << (D - 1)), rm - (1 << D), rm)
    return (t - r0) >> D, r0


def decompose(r: np.ndarray,
              gamma2: int) -> Tuple[np.ndarray, np.ndarray]:
    """(r1, r0) with r ≡ r1·2γ2 + r0 and the q-1 wrap special case."""
    r = np.asarray(r, np.int64)
    two = 2 * gamma2
    rm = r % two
    r0 = np.where(rm > gamma2, rm - two, rm)
    special = (r - r0) == Q - 1
    r1 = np.where(special, 0, (r - r0) // two)
    r0 = np.where(special, r0 - 1, r0)
    return r1, r0


def make_hint(z: np.ndarray, r: np.ndarray,
              gamma2: int) -> np.ndarray:
    """MakeHint (Alg 39): 1 where adding z changes HighBits(r)."""
    r1, _ = decompose(r, gamma2)
    v1, _ = decompose((r + z) % Q, gamma2)
    return (r1 != v1).astype(np.uint8)


def w1_encode(w1: np.ndarray, p: ParameterSet) -> bytes:
    """w1Encode (Alg 28): SimpleBitPack of the [k, 256] w1 lanes."""
    return bitpack(np.asarray(w1, np.int64).reshape(-1), p.w1_bits) \
        .tobytes()


# ---------------------------------------------------------------------------
# hint encoding (Alg 20/21): HintBitUnpack rejects exactly what FIPS
# 204 rejects — count overflow, unsorted or duplicate indices, nonzero
# padding (part of the signature's malleability surface)
# ---------------------------------------------------------------------------

def hint_bit_pack(h: np.ndarray, p: ParameterSet) -> bytes:
    y = bytearray(p.omega + p.k)
    idx = 0
    for i in range(p.k):
        for j in range(N):
            if h[i, j]:
                y[idx] = j
                idx += 1
        y[p.omega + i] = idx
    return bytes(y)


def hint_bit_unpack(y: bytes, p: ParameterSet) -> Optional[np.ndarray]:
    h = np.zeros((p.k, N), np.uint8)
    idx = 0
    for i in range(p.k):
        end = y[p.omega + i]
        if end < idx or end > p.omega:
            return None
        first = idx
        while idx < end:
            if idx > first and y[idx] <= y[idx - 1]:
                return None
            h[i, y[idx]] = 1
            idx += 1
    for j in range(idx, p.omega):
        if y[j] != 0:
            return None
    return h


# ---------------------------------------------------------------------------
# key / signature encodings
# ---------------------------------------------------------------------------

def pk_encode(rho: bytes, t1: np.ndarray) -> bytes:
    return rho + bitpack(np.asarray(t1, np.int64).reshape(-1),
                         10).tobytes()


def pk_decode(pk: bytes, p: ParameterSet) -> Tuple[bytes, np.ndarray]:
    if len(pk) != p.pk_size:
        raise ValueError(
            f"{p.name} public key must be {p.pk_size} bytes, "
            f"got {len(pk)}")
    rho = pk[:32]
    t1 = bitunpack(np.frombuffer(pk[32:], np.uint8), 10,
                   p.k * N).reshape(p.k, N)
    return rho, t1


def sig_encode(c_tilde: bytes, z: np.ndarray, h: np.ndarray,
               p: ParameterSet) -> bytes:
    zenc = bitpack(p.gamma1 - np.asarray(z, np.int64).reshape(-1),
                   p.z_bits).tobytes()
    return c_tilde + zenc + hint_bit_pack(h, p)


def sig_decode(sig: bytes, p: ParameterSet
               ) -> Optional[Tuple[bytes, np.ndarray, np.ndarray]]:
    """(c̃, z centered [l, 256], h [k, 256]) or None when the hint
    encoding is malformed. The caller checks the total length."""
    c_tilde = sig[: p.lam // 4]
    z_len = p.l * 32 * p.z_bits
    zbuf = np.frombuffer(sig[p.lam // 4: p.lam // 4 + z_len], np.uint8)
    z = p.gamma1 - bitunpack(zbuf, p.z_bits, p.l * N).reshape(p.l, N)
    h = hint_bit_unpack(sig[p.lam // 4 + z_len:], p)
    if h is None:
        return None
    return c_tilde, z, h


# ---------------------------------------------------------------------------
# key objects
# ---------------------------------------------------------------------------

def _matvec_ntt(a_hat: np.ndarray, x_hat: np.ndarray) -> np.ndarray:
    """NTT-domain matrix·vector: [k, l, 256] ∘ [l, 256] → [k, 256]."""
    return ((a_hat * x_hat[None, :, :]) % Q).sum(axis=1) % Q


class MLDSAPublicKey:
    """ML-DSA public key: parameter set + the FIPS 204 pk encoding.

    ``parameter_set`` routes ``key_matches_alg``; the per-key
    precompute (Â from ρ, t̂1·2^d, tr) is cached on first use, so JWKS
    parsing stays cheap.
    """

    __slots__ = ("parameter_set", "pk", "rho", "t1", "_a_hat",
                 "_t1_hat_2d", "_tr")

    def __init__(self, parameter_set: str, pk: bytes):
        if parameter_set not in PARAMS:
            raise ValueError(
                f"unknown ML-DSA parameter set {parameter_set!r}")
        p = PARAMS[parameter_set]
        self.parameter_set = parameter_set
        self.pk = bytes(pk)
        self.rho, self.t1 = pk_decode(self.pk, p)
        self._a_hat: Optional[np.ndarray] = None
        self._t1_hat_2d: Optional[np.ndarray] = None
        self._tr: Optional[bytes] = None

    @property
    def params(self) -> ParameterSet:
        return PARAMS[self.parameter_set]

    @property
    def tr(self) -> bytes:
        if self._tr is None:
            self._tr = _shake256(self.pk, 64)
        return self._tr

    @property
    def a_hat(self) -> np.ndarray:
        if self._a_hat is None:
            self._a_hat = expand_a(self.rho, self.params)
        return self._a_hat

    @property
    def t1_hat_2d(self) -> np.ndarray:
        if self._t1_hat_2d is None:
            self._t1_hat_2d = _ntt.ntt_ref((self.t1 << D) % Q)
        return self._t1_hat_2d


class MLDSAPrivateKey:
    """Fixture-only deterministic signer (FIPS 204 Alg 7, rnd = 0³²).
    Nothing here is constant-time or fit for real keys."""

    __slots__ = ("public_key", "_K", "_s1_hat", "_s2_hat", "_t0_hat")

    def __init__(self, pub: MLDSAPublicKey, K: bytes, s1: np.ndarray,
                 s2: np.ndarray, t0: np.ndarray):
        self.public_key = pub
        self._K = K
        self._s1_hat = _ntt.ntt_ref(s1 % Q)
        self._s2_hat = _ntt.ntt_ref(s2 % Q)
        self._t0_hat = _ntt.ntt_ref(t0 % Q)

    def sign(self, message: bytes, ctx: bytes = b"") -> bytes:
        if len(ctx) > 255:
            raise ValueError("ctx must be at most 255 bytes")
        m_prime = b"\x00" + bytes([len(ctx)]) + ctx + message
        return self._sign_internal(m_prime, b"\x00" * 32)

    def _sign_internal(self, m_prime: bytes, rnd: bytes) -> bytes:
        pub = self.public_key
        p = pub.params
        mu = _shake256(pub.tr + m_prime, 64)
        rho2 = _shake256(self._K + rnd + mu, 64)
        kappa = 0
        while True:
            y = expand_mask(rho2, kappa, p)
            kappa += p.l
            w = _ntt.intt_ref(_matvec_ntt(pub.a_hat,
                                          _ntt.ntt_ref(y % Q)))
            w1, _ = decompose(w, p.gamma2)
            c_tilde = _shake256(mu + w1_encode(w1, p), p.lam // 4)
            c_hat = _ntt.ntt_ref(sample_in_ball(c_tilde, p) % Q)
            cs1 = _center(_ntt.intt_ref((c_hat * self._s1_hat) % Q))
            z = y + cs1
            if np.abs(z).max() >= p.gamma1 - p.beta:
                continue
            cs2 = _center(_ntt.intt_ref((c_hat * self._s2_hat) % Q))
            _, r0 = decompose((w - cs2) % Q, p.gamma2)
            if np.abs(r0).max() >= p.gamma2 - p.beta:
                continue
            ct0 = _center(_ntt.intt_ref((c_hat * self._t0_hat) % Q))
            if np.abs(ct0).max() >= p.gamma2:
                continue
            h = make_hint(-ct0 % Q, (w - cs2 + ct0) % Q, p.gamma2)
            if int(h.sum()) > p.omega:
                continue
            return sig_encode(c_tilde, z, h, p)


def _center(x: np.ndarray) -> np.ndarray:
    """Representative in (-(q-1)/2, (q-1)/2]."""
    x = np.asarray(x, np.int64) % Q
    return np.where(x > (Q - 1) // 2, x - Q, x)


def keygen(parameter_set: str,
           seed: bytes) -> Tuple[MLDSAPrivateKey, MLDSAPublicKey]:
    """ML-DSA.KeyGen_internal (Alg 6) from a 32-byte seed ξ."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    p = PARAMS[parameter_set]
    hh = _shake256(seed + bytes([p.k, p.l]), 128)
    rho, rho_prime, K = hh[:32], hh[32:96], hh[96:128]
    a_hat = expand_a(rho, p)
    s1, s2 = expand_s(rho_prime, p)
    t = (_ntt.intt_ref(_matvec_ntt(a_hat, _ntt.ntt_ref(s1 % Q)))
         + s2) % Q
    t1, t0 = power2round(t)
    pub = MLDSAPublicKey(parameter_set, pk_encode(rho, t1))
    pub._a_hat = a_hat               # already expanded — share it
    return MLDSAPrivateKey(pub, K, s1, s2, t0), pub


# ---------------------------------------------------------------------------
# pure-integer host oracle
# ---------------------------------------------------------------------------

def _decode_checked(sig: bytes, p: ParameterSet):
    """Length + hint-validity + z-range gates. Returns (c̃, z centered,
    h) or None (reject)."""
    if len(sig) != p.sig_size:
        return None
    dec = sig_decode(sig, p)
    if dec is None:
        return None
    c_tilde, z, h = dec
    if int(np.abs(z).max()) >= p.gamma1 - p.beta:
        return None
    return c_tilde, z, h


def mu_for(tr: bytes, message: bytes, ctx: bytes = b"") -> bytes:
    """μ = SHAKE256(tr ‖ M', 64) with the pure-ML-DSA domain prefix."""
    return _shake256(tr + b"\x00" + bytes([len(ctx)]) + ctx + message,
                     64)


def py_verify(pub: MLDSAPublicKey, signature: bytes,
              message: bytes) -> bool:
    """ML-DSA.Verify (Alg 8), entirely host-side exact integers: the
    oracle and the reference the device engine is held to, malformed
    and adversarial inputs included."""
    p = pub.params
    dec = _decode_checked(bytes(signature), p)
    if dec is None:
        return False
    c_tilde, z, h = dec
    mu = mu_for(pub.tr, bytes(message))
    c_hat = _ntt.ntt_ref(sample_in_ball(c_tilde, p) % Q)
    z_hat = _ntt.ntt_ref(z % Q)
    w_approx = _ntt.intt_ref(
        (_matvec_ntt(pub.a_hat, z_hat)
         - (c_hat * pub.t1_hat_2d) % Q) % Q)
    w1 = _ntt.use_hint_ref(h, w_approx, p.gamma2)
    return _shake256(mu + w1_encode(w1, p), p.lam // 4) == c_tilde


# ---------------------------------------------------------------------------
# device engine: per-parameter-set key tables + the fused verify
# ---------------------------------------------------------------------------

# the key table's tensors, replicated on every device of a mesh
TABLE_TENSORS = ("a_mont", "t1_mont")


class MLDSAKeyTable:
    """Key material of ONE parameter set on the device.

    Per key: Â (k·l NTT-domain polys, expanded on the host from ρ
    once) and t̂1·2^d, both in Montgomery form (int32 values < q), so
    every pointwise product with per-token plain-domain data is one
    ``mont_mul``: ``a_mont`` [nk, k, l, 256], ``t1_mont`` [nk, k, 256].
    """

    def __init__(self, parameter_set: str, keys: Sequence[MLDSAPublicKey],
                 device="cuda", a_mont: Optional[np.ndarray] = None,
                 t1_mont: Optional[np.ndarray] = None):
        p = PARAMS[parameter_set]
        self.params = p
        self.parameter_set = parameter_set
        self.keys = list(keys)
        if a_mont is None:
            a = np.stack([k.a_hat for k in self.keys])     # [nk,k,l,256]
            a_mont = (a << _ntt.MONT_BITS) % Q
        if t1_mont is None:
            t = np.stack([k.t1_hat_2d for k in self.keys])  # [nk,k,256]
            t1_mont = (t << _ntt.MONT_BITS) % Q
        self.a_mont = torch.as_tensor(np.asarray(a_mont).astype(np.int32),
                                      device=device)
        self.t1_mont = torch.as_tensor(
            np.asarray(t1_mont).astype(np.int32), device=device)

    @property
    def device(self) -> torch.device:
        return self.a_mont.device


def _w1_core(a_mont, t1_mont, z, c, h, key_idx, gamma2: int):
    """The w1 network: w1 values from per-token z/c/h rows.

    z: int32 [B, l, 256] plain-domain canonical; c: int32 [B, 256];
    h: [B, k, 256] 0/1; key_idx: [B] int64 table rows. Returns int64
    [B, k, 256] w1 values in [0, m).
    """
    z_hat = _ntt.ntt(z)                                  # [B, l, 256]
    c_hat = _ntt.ntt(c)                                  # [B, 256]
    a = a_mont[key_idx]                                  # [B, k, l, 256]
    t1 = t1_mont[key_idx]                                # [B, k, 256]
    prod = _ntt.mont_mul(a, z_hat[:, None, :, :])
    acc = prod.sum(dim=2) % Q
    acc = _ntt.sub_q(acc, _ntt.mont_mul(c_hat[:, None, :], t1))
    w = _ntt.intt(acc.to(torch.int32))
    return _ntt.use_hint(h, w, gamma2)


# SampleInBall squeeze budget: 3 SHAKE256 blocks = 408 bytes. The walk
# needs ~8 + 1.1·τ bytes in expectation (≤ 76 even for τ = 60); a lane
# that walks past the budget raises ``exhausted`` and re-verifies on
# the host oracle, so verdict parity does not rest on a probability.
_SIB_BLOCKS = 3
_SIB_BYTES = _SIB_BLOCKS * 136


def _sample_in_ball(sib_state: torch.Tensor, tau: int):
    """The τ-step SampleInBall walk on absorbed SHAKE256(c̃) states
    [B, 25, 2]: (c int32 [B, 256] in [0, q), exhausted [B] bool), the
    oracle's trajectory: each draw takes the first byte at or after
    ``pos`` that is ≤ i."""
    b = sib_state.shape[0]
    dev = sib_state.device
    sib_bytes = _kk.lanes_to_bytes(
        _kk.squeeze_lanes(sib_state, 136, _SIB_BLOCKS))  # [B, 408]
    lane0 = _kk._to_words(sib_state[:, 0, :])            # signs u64
    sh = torch.arange(32, device=dev)
    sign_bits = torch.stack([(lane0[:, 0, None] >> sh) & 1,
                             (lane0[:, 1, None] >> sh) & 1],
                            dim=-1).reshape(b, 64)       # bit t of u64
    idx = torch.arange(_SIB_BYTES, device=dev)
    coeff = torch.arange(N, device=dev)
    c = torch.zeros((b, N), dtype=torch.int32, device=dev)
    pos = torch.full((b,), 8, dtype=torch.int64, device=dev)
    exhausted = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(tau):
        i = N - tau + t
        ok_pos = (idx[None, :] >= pos[:, None]) & (sib_bytes <= i)
        first = torch.where(ok_pos, idx, _SIB_BYTES).min(dim=1).values
        found = first < _SIB_BYTES
        p_sel = torch.where(found, first, 0)
        j = sib_bytes.gather(1, p_sel[:, None]).to(torch.int64)  # [B, 1]
        cj = c.gather(1, j)
        c = torch.where(coeff[None, :] == i, cj, c)
        pm1 = torch.where(sign_bits[:, t, None] != 0, Q - 1, 1) \
            .to(torch.int32)
        c = torch.where(coeff[None, :] == j, pm1, c)
        pos = torch.where(found, p_sel + 1, pos)
        exhausted = exhausted | ~found
    return c, exhausted


def _fused_core(a_mont, t1_mont, mu_blocks, mu_nblk, ct_block, ct_cmp, z,
                h, key_idx, valid, w1_pad, gamma2: int, tau: int,
                w1_bits: int):
    """The fused device pass: (accept [B] bool, exhausted [B] bool) from
    decoded byte lanes. Keccak states are int32 [..., 25, 2]."""
    b = z.shape[0]
    # μ = SHAKE256(tr ‖ 0x00 ‖ 0x00 ‖ M, 64): masked variable-length
    # absorb; the first 8 lanes of the final state are μ's 64 bytes.
    mu_lanes = _kk.absorb(mu_blocks, mu_nblk)[:, :8, :]  # [B, 8, 2]
    c, exhausted = _sample_in_ball(_kk.absorb_fixed(ct_block), tau)
    w1 = _w1_core(a_mont, t1_mont, z, c, h, key_idx, gamma2)
    # w1Encode on the device: LSB-first bits -> interleaved lanes
    bit_sh = torch.arange(w1_bits, device=z.device)
    bits = ((w1[..., None] >> bit_sh) & 1).reshape(b, -1)
    w1_lanes = _kk.bits_to_lanes(bits)                   # [B, nw, 2]
    # SHAKE256(μ ‖ w1enc, λ/4) ?= c̃: fixed-shape absorb, the padding a
    # precomputed XOR tensor
    nb2 = w1_pad.shape[0]
    content = torch.cat(
        [mu_lanes, w1_lanes,
         torch.zeros((b, nb2 * 17 - 8 - w1_lanes.shape[1], 2),
                     dtype=torch.int32, device=z.device)],
        dim=1).reshape(b, nb2, 17, 2)
    blocks2 = torch.zeros((b, nb2, 25, 2), dtype=torch.int32,
                          device=z.device)
    blocks2[:, :, :17] = content
    st2 = _kk.absorb_fixed(blocks2 ^ w1_pad[None])
    nc = ct_cmp.shape[1]
    match = (st2[:, :nc, :] == ct_cmp).all(dim=2).all(dim=1)
    return match & valid & ~exhausted, exhausted & valid


def _w1_pad_lanes(p: ParameterSet) -> np.ndarray:
    """The XOR pad tensor uint32 [n_blocks, 25, 2] of the fixed-length
    SHAKE256(μ ‖ w1enc) absorb of one parameter set."""
    total = 64 + N * p.k * p.w1_bits // 8
    nb = total // 136 + 1                 # pad10*1 always adds a byte
    buf = np.zeros(nb * 136, np.uint8)
    buf[total] = _kk.DOMAIN_SHAKE
    buf[nb * 136 - 1] ^= 0x80
    out = np.zeros((nb, 25, 2), np.uint32)
    out[:, :17] = _kk.interleave(buf.view("<u8")).reshape(nb, 17, 2)
    return out


_W1_PAD: Dict[str, np.ndarray] = {
    name: _w1_pad_lanes(p) for name, p in PARAMS.items()}


def _decode_batch(sigs: Sequence[bytes], p: ParameterSet):
    """``_decode_checked`` over a chunk: (valid [m] bool, c̃ bytes
    [m, λ/4] uint8, z [m, l, 256] centered int64, h [m, k, 256] uint8);
    the rows of rejected signatures are zero. z unpacks for all
    signatures of the right length at once."""
    m = len(sigs)
    ct_len = p.lam // 4
    z_len = p.l * 32 * p.z_bits
    valid = np.array([len(s) == p.sig_size for s in sigs], bool)
    ct = np.zeros((m, ct_len), np.uint8)
    z = np.zeros((m, p.l, N), np.int64)
    h = np.zeros((m, p.k, N), np.uint8)
    rows = np.nonzero(valid)[0]
    if len(rows) == 0:
        return valid, ct, z, h
    mat = np.frombuffer(b"".join(sigs[i] for i in rows.tolist()),
                        np.uint8).reshape(len(rows), p.sig_size)
    zr = p.gamma1 - bitunpack(mat[:, ct_len: ct_len + z_len], p.z_bits,
                              p.l * N)
    in_range = np.abs(zr).max(axis=1) < p.gamma1 - p.beta
    for r, i in enumerate(rows.tolist()):
        hi = hint_bit_unpack(sigs[i][ct_len + z_len:], p) \
            if in_range[r] else None
        if hi is None:
            valid[i] = False
            continue
        h[i] = hi
    ok = valid[rows]
    ct[rows[ok]] = mat[ok, :ct_len]
    z[rows[ok]] = zr[ok].reshape(-1, p.l, N)
    return valid, ct, z, h


class _FusedPrep:
    """Host-side decode of one chunk for the fused path: byte shuffling
    only — signature gates, z/hint unpack, μ-input block packing, c̃ as
    lanes. No hash."""

    def __init__(self, table: MLDSAKeyTable, sigs: Sequence[bytes],
                 msgs: Sequence[bytes], key_idx: np.ndarray, pad: int):
        p = table.params
        m = len(sigs)
        self.m = m
        self.sigs = [bytes(s) for s in sigs]
        self.msgs = [bytes(x) for x in msgs]
        self.key_idx = np.zeros(pad, np.int64)
        self.key_idx[:m] = np.asarray(key_idx, np.int64)[:m]
        valid, ct_m, z_m, h_m = _decode_batch(self.sigs, p)
        self.valid = np.zeros(pad, bool)
        self.valid[:m] = valid
        self.z = np.zeros((pad, p.l, N), np.int32)
        self.z[:m] = z_m % Q
        self.h = np.zeros((pad, p.k, N), np.uint8)
        self.h[:m] = h_m
        ct = np.zeros((pad, p.lam // 4), np.uint8)
        ct[:m] = ct_m
        mu_msgs: List[bytes] = [b""] * pad
        for i in np.nonzero(valid)[0].tolist():
            key = table.keys[int(self.key_idx[i])]
            mu_msgs[i] = key.tr + b"\x00\x00" + self.msgs[i]
        # the μ block count is bucketed to a power of two ≥ 4, as the
        # JAX package buckets it against recompiles
        blocks, nblk = _kk.pack_blocks(mu_msgs, 136)
        nb = 4
        while nb < blocks.shape[1]:
            nb *= 2
        if blocks.shape[1] < nb:
            blocks = np.concatenate(
                [blocks, np.zeros((pad, nb - blocks.shape[1], 25, 2),
                                  np.uint32)], axis=1)
        self.mu_blocks = blocks
        self.mu_nblk = nblk
        # c̃: one absorb block + whole-lane compare target
        ctb = np.zeros((pad, 1, 25, 2), np.uint32)
        pad_buf = np.zeros((pad, 136), np.uint8)
        pad_buf[:, : p.lam // 4] = ct
        pad_buf[:, p.lam // 4] = _kk.DOMAIN_SHAKE
        pad_buf[:, 135] ^= 0x80
        ctb[:, 0, :17] = _kk.interleave(
            pad_buf.view("<u8").reshape(pad, 17))
        self.ct_block = ctb
        self.ct_cmp = _kk.interleave(
            ct.view("<u8").reshape(pad, p.lam // 32))


class FusedPending:
    """One chunk queued on the device: ``outs`` holds the (accept,
    exhausted) bit vectors (empty when no lane decoded); calling it
    returns the [pad] bool verdicts with exhausted lanes re-verified on
    :func:`py_verify`."""

    def __init__(self, table: MLDSAKeyTable, prep: _FusedPrep, pad: int,
                 outs: List[torch.Tensor]):
        self.table, self.prep, self.pad, self.outs = table, prep, pad, outs
        self.reverified = 0

    def verdicts(self, arrs: Sequence[np.ndarray]) -> np.ndarray:
        """Verdicts from the host copies of ``outs`` (any prefix of the
        lanes)."""
        if not arrs:
            return np.zeros(self.pad, bool)
        ok = np.array(arrs[0], bool)
        for i in np.nonzero(arrs[1])[0].tolist():
            if i < self.prep.m:
                self.reverified += 1
                key = self.table.keys[int(self.prep.key_idx[i])]
                ok[i] = py_verify(key, self.prep.sigs[i],
                                  self.prep.msgs[i])
        return ok

    def __call__(self) -> np.ndarray:
        return self.verdicts([o.cpu().numpy() for o in self.outs])


def verify_mldsa_fused_pending(table: MLDSAKeyTable,
                               sigs: Sequence[bytes],
                               msgs: Sequence[bytes],
                               key_idx: np.ndarray,
                               pad: Optional[int] = None,
                               mesh=None) -> FusedPending:
    """Decode now and queue the one fused device pass; the returned
    :class:`FusedPending` gives [pad] bool verdicts when called.

    Tokens invalid at decode finish False without touching the hash
    chain; lanes whose SampleInBall walk exhausts its budget re-verify
    on the host oracle. With a ``mesh`` every per-token array shards
    along the batch axis (``pad`` a multiple of the mesh size), the
    key tables and the w1 pad replicate, and ``outs`` are
    :class:`..parallel.place.Sharded`.
    """
    if pad is None:
        pad = len(sigs)
    p = table.params
    prep = _FusedPrep(table, sigs, msgs, key_idx, pad)
    if not prep.valid.any():
        return FusedPending(table, prep, pad, [])
    arrs = (prep.mu_blocks, prep.mu_nblk, prep.ct_block, prep.ct_cmp,
            prep.z, prep.h, prep.key_idx, prep.valid)
    w1_pad = _W1_PAD[table.parameter_set]
    if mesh is not None:
        from ..parallel.place import (on_shards, replicated,
                                      replicated_views, shard_batch)

        views = replicated_views(mesh, table, TABLE_TENSORS)
        pads = replicated(mesh, w1_pad)
        outs = on_shards(
            mesh, lambda i, *a: _fused_core(
                views[i].a_mont, views[i].t1_mont, *a, pads[i], p.gamma2,
                p.tau, p.w1_bits),
            *(shard_batch(mesh, a) for a in arrs))
        return FusedPending(table, prep, pad, list(outs))
    dev = table.device
    put = [_kk.to_device(a, dev) for a in arrs + (w1_pad,)]
    outs = _fused_core(table.a_mont, table.t1_mont, *put,
                       p.gamma2, p.tau, p.w1_bits)
    return FusedPending(table, prep, pad, list(outs))


# ---------------------------------------------------------------------------
# The two-phase arm: host μ / SampleInBall / c̃ around the device w1 network
# ---------------------------------------------------------------------------

def _to_dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def verify_mldsa_core_pending(table: MLDSAKeyTable, z: np.ndarray,
                              c: np.ndarray, h: np.ndarray,
                              key_idx: np.ndarray, mesh=None):
    """Queue the w1 network on the table's device: z int32 [B, l, 256],
    c int32 [B, 256] (both in [0, q)), h uint8 [B, k, 256], key_idx [B]
    → the device uint8 [B, k, 256] w1 values (2 ntt + 1 intt launches).
    With a ``mesh`` the four arrays shard along the batch axis, the key
    tables replicate, and the w1 values are
    :class:`..parallel.place.Sharded` (2 ntt + 1 intt a shard)."""
    if mesh is not None:
        from ..parallel.place import on_shards, replicated_views, shard_batch

        views = replicated_views(mesh, table, TABLE_TENSORS)
        return on_shards(
            mesh, lambda i, *a: w1_resident(views[i], *a),
            *(shard_batch(mesh, a) for a in (z, c, h,
                                             key_idx.astype(np.int64))))
    dev = table.device
    return w1_resident(table, _to_dev(z, dev), _to_dev(c, dev),
                       _to_dev(h, dev), _to_dev(key_idx.astype(np.int64),
                                                dev))


def w1_resident(table: MLDSAKeyTable, z: torch.Tensor, c: torch.Tensor,
                h: torch.Tensor, key_idx: torch.Tensor) -> torch.Tensor:
    """The w1 network on tensors already on the table's device (no
    host-to-device copy on the timed path)."""
    return _w1_core(table.a_mont, table.t1_mont, z, c, h, key_idx,
                    table.params.gamma2).to(torch.uint8)


class _PreppedChunk:
    """Host side of one two-phase chunk: the signature gates and z/h
    rows (:func:`_decode_batch`), and per decodable token SampleInBall's
    c, μ and c̃ by host SHAKE (counted in ``host_shake_calls``)."""

    def __init__(self, table: MLDSAKeyTable, sigs: Sequence[bytes],
                 msgs: Sequence[bytes], key_idx: np.ndarray, pad: int):
        p = table.params
        m = len(sigs)
        self.m = m
        self.key_idx = np.zeros(pad, np.int64)
        self.key_idx[:m] = np.asarray(key_idx, np.int64)[:m]
        valid, ct_m, z_m, h_m = _decode_batch([bytes(x) for x in sigs], p)
        self.valid = np.zeros(pad, bool)
        self.valid[:m] = valid
        self.z = np.zeros((pad, p.l, N), np.int32)
        self.z[:m] = z_m % Q
        self.h = np.zeros((pad, p.k, N), np.uint8)
        self.h[:m] = h_m
        self.c = np.zeros((pad, N), np.int32)
        self.mus: List[Optional[bytes]] = [None] * pad
        self.cts: List[Optional[bytes]] = [None] * pad
        for i in np.nonzero(valid)[0].tolist():
            ct = ct_m[i].tobytes()
            self.c[i] = sample_in_ball(ct, p) % Q
            self.mus[i] = mu_for(table.keys[int(self.key_idx[i])].tr,
                                 bytes(msgs[i]))
            self.cts[i] = ct

    def finalize(self, table: MLDSAKeyTable, w1: np.ndarray) -> np.ndarray:
        """Host finish: w1Encode and the SHAKE256(μ ‖ w1enc) == c̃
        compare → [pad] bool (w1 needs the rows of the valid lanes)."""
        p = table.params
        ok = np.zeros(len(self.valid), bool)
        for i in np.nonzero(self.valid)[0].tolist():
            ok[i] = _shake256(self.mus[i] + w1_encode(w1[i], p),
                              p.lam // 4) == self.cts[i]
        return ok


def verify_mldsa_pending(table: MLDSAKeyTable, sigs: Sequence[bytes],
                         msgs: Sequence[bytes], key_idx: np.ndarray,
                         pad: Optional[int] = None, mesh=None):
    """The two-phase arm: host decode and hashing now, the w1 network
    queued on the device; returns ``fin()`` → [pad] bool verdicts (the
    w1 copy and the host finish run on the call). Tokens invalid at
    decode never reach the device and finish False, as
    :func:`py_verify` decides them. ``mesh`` shards the w1 network as
    in :func:`verify_mldsa_core_pending`."""
    if pad is None:
        pad = len(sigs)
    prep = _PreppedChunk(table, sigs, msgs, key_idx, pad)
    w1_dev = (verify_mldsa_core_pending(table, prep.z, prep.c, prep.h,
                                        prep.key_idx, mesh=mesh)
              if prep.valid.any() else None)

    def fin() -> np.ndarray:
        if w1_dev is None:
            return np.zeros(pad, bool)
        return prep.finalize(table, w1_dev.cpu().numpy())

    return fin


def verify_mldsa_batch(table: MLDSAKeyTable, sigs: Sequence[bytes],
                       msgs: Sequence[bytes], key_idx: np.ndarray,
                       mesh=None) -> np.ndarray:
    """[N] bool verdicts for one ML-DSA bucket on the two-phase arm (the
    JAX package's blocking interface), sharded over ``mesh`` if one is
    given."""
    return verify_mldsa_pending(table, sigs, msgs, key_idx, mesh=mesh)()


def host_w1(table: MLDSAKeyTable, prep: _PreppedChunk) -> np.ndarray:
    """numpy mirror of the w1 network over a prepped chunk: int64 [pad,
    k, 256], zero rows for the lanes that did not decode."""
    p = table.params
    out = np.zeros((len(prep.valid), p.k, N), np.int64)
    for i in np.nonzero(prep.valid)[0].tolist():
        key = table.keys[int(prep.key_idx[i])]
        z_hat = _ntt.ntt_ref(prep.z[i].astype(np.int64))
        c_hat = _ntt.ntt_ref(prep.c[i].astype(np.int64))
        w = _ntt.intt_ref((_matvec_ntt(key.a_hat, z_hat)
                           - (c_hat * key.t1_hat_2d) % Q) % Q)
        out[i] = _ntt.use_hint_ref(prep.h[i], w, p.gamma2)
    return out
