"""Batched SHA-512 and SHA-384 in plain PyTorch (FIPS 180-4).

The port of the JAX package's ``tpu/sha512.py``: the device hashing of
the PS384/PS512 verify tail (MGF1 blocks and H' = Hash(0^8 ‖ mHash ‖
salt)), so no EM bytes leave the device. The JAX package computes it
in XLA, outside any Pallas kernel, and so does the port: every round
is elementwise over the lane axis.

Words are whole int64 tensors holding the 64-bit patterns (the JAX
package splits them into (hi, lo) uint32 pairs only because the TPU
has no 64-bit integers). Adds wrap modulo 2^64, as PyTorch's integer
kernels do on the CPU and on CUDA (the card tests pin it), and every
right shift and rotate masks off the sign bits that torch's arithmetic
``>>`` drags in. Per-token message lengths run the maximum block count
and snapshot each token's state after its own final block, as
``sha256_var`` does.
"""

from __future__ import annotations

import functools

import torch

_K512 = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f,
    0xe9b5dba58189dbbc, 0x3956c25bf348b538, 0x59f111f1b605d019,
    0x923f82a4af194f9b, 0xab1c5ed5da6d8118, 0xd807aa98a3030242,
    0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235,
    0xc19bf174cf692694, 0xe49b69c19ef14ad2, 0xefbe4786384f25e3,
    0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65, 0x2de92c6f592b0275,
    0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f,
    0xbf597fc7beef0ee4, 0xc6e00bf33da88fc2, 0xd5a79147930aa725,
    0x06ca6351e003826f, 0x142929670a0e6e70, 0x27b70a8546d22ffc,
    0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6,
    0x92722c851482353b, 0xa2bfe8a14cf10364, 0xa81a664bbc423001,
    0xc24b8b70d0f89791, 0xc76c51a30654be30, 0xd192e819d6ef5218,
    0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99,
    0x34b0bcb5e19b48a8, 0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb,
    0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3, 0x748f82ee5defb2fc,
    0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915,
    0xc67178f2e372532b, 0xca273eceea26619c, 0xd186b8c721c0c207,
    0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178, 0x06f067aa72176fba,
    0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc,
    0x431d67c49c100d4c, 0x4cc5d4becb3e42b6, 0x597f299cfc657e2a,
    0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
]

_H512 = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
         0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
         0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]

_H384 = [0xcbbb9d5dc1059ed8, 0x629a292a367cd507, 0x9159015a3070dd17,
         0x152fecd8f70e5939, 0x67332667ffc00b31, 0x8eb44a8768581511,
         0xdb0c2e0d64f98fa7, 0x47b5481dbefa4fa4]


def _signed(v: int) -> int:
    """A 64-bit pattern as the int64 value that holds it."""
    return v - (1 << 64) if v >= 1 << 63 else v


_K = [_signed(k) for k in _K512]


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of 64-bit words by r ∈ (0, 64)."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _ror(x: torch.Tensor, r: int) -> torch.Tensor:
    return _shr(x, r) | (x << (64 - r))


def compress(state, words: torch.Tensor):
    """One SHA-512 compression over the batch.

    state: tuple of 8 [N] int64 words; words: [16, N] int64 message
    words. Returns the new 8-tuple.
    """
    w = list(words.unbind(0))
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        if t >= 16:
            w15, w2 = w[t - 15], w[t - 2]
            s0 = _ror(w15, 1) ^ _ror(w15, 8) ^ _shr(w15, 7)
            s1 = _ror(w2, 19) ^ _ror(w2, 61) ^ _shr(w2, 6)
            w.append(w[t - 16] + s0 + w[t - 7] + s1)
        s1 = _ror(e, 14) ^ _ror(e, 18) ^ _ror(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K[t] + w[t]
        s0 = _ror(a, 28) ^ _ror(a, 34) ^ _ror(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = t1 + s0 + maj, a, b, c, d + t1, e, f, g
    return tuple(s + v for s, v in zip(state, (a, b, c, d, e, f, g, h)))


@functools.lru_cache(maxsize=None)
def _byte_shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(56, -8, -8, device=device)


def _bytes_to_words(block: torch.Tensor) -> torch.Tensor:
    """[N, 128] uint8 → [16, N] int64 big-endian words."""
    b = block.to(torch.int64).reshape(block.shape[0], 16, 8)
    return (b << _byte_shifts(block.device)).sum(dim=2).T


def _init_state(n: int, h0, device):
    v = torch.tensor([_signed(x) for x in h0], dtype=torch.int64,
                     device=device)
    return tuple(v[i].expand(n) for i in range(8))


def _digest_bytes(state, out_words: int) -> torch.Tensor:
    """8×[N] words → [N, 8·out_words] uint8 big-endian digest."""
    w = torch.stack(state[:out_words], dim=1)            # [N, out_words]
    return ((w[:, :, None] >> _byte_shifts(w.device)) & 0xFF) \
        .to(torch.uint8).reshape(w.shape[0], 8 * out_words)


def _hash_fixed(msgs: torch.Tensor, h0, out_words: int) -> torch.Tensor:
    n, length = msgs.shape
    assert length <= 111, "single-block limit (SHA-512 family)"
    block = torch.zeros((n, 128), dtype=torch.uint8, device=msgs.device)
    block[:, :length] = msgs
    block[:, length] = 0x80
    bits = length * 8
    block[:, 126] = bits >> 8
    block[:, 127] = bits & 0xFF
    state = compress(_init_state(n, h0, msgs.device), _bytes_to_words(block))
    return _digest_bytes(state, out_words)


def _hash_var(msgs: torch.Tensor, lens: torch.Tensor, max_len: int, h0,
              out_words: int) -> torch.Tensor:
    n = msgs.shape[0]
    dev = msgs.device
    n_blocks = (max_len + 17 + 127) // 128
    buf = torch.zeros((n, n_blocks * 128), dtype=torch.uint8, device=dev)
    buf[:, :msgs.shape[1]] = msgs
    pos = torch.arange(n_blocks * 128, device=dev)[None, :]
    lens = lens.to(torch.int64)[:, None]
    buf = torch.where(pos == lens, torch.full_like(buf, 0x80), buf)
    # the 128-bit big-endian bit length ends the token's final block
    # (lens < 2^28: its four low bytes suffice, the rest stay zero)
    final_block = (lens + 16) // 128
    msg_bits = lens * 8
    for j in range(4):
        byte = ((msg_bits >> (8 * (3 - j))) & 0xFF).to(torch.uint8)
        buf = torch.where(pos == final_block * 128 + 124 + j,
                          byte.expand_as(buf), buf)
    state = _init_state(n, h0, dev)
    out = state
    for i in range(n_blocks):
        state = compress(state,
                         _bytes_to_words(buf[:, i * 128:(i + 1) * 128]))
        final = final_block[:, 0] == i
        out = tuple(torch.where(final, s, o) for s, o in zip(state, out))
    return _digest_bytes(out, out_words)


def sha512_fixed(msgs: torch.Tensor) -> torch.Tensor:
    """SHA-512 of [N, L] uint8, fixed L ≤ 111 (one block) → [N, 64]."""
    return _hash_fixed(msgs, _H512, 8)


def sha384_fixed(msgs: torch.Tensor) -> torch.Tensor:
    """SHA-384 of [N, L] uint8, fixed L ≤ 111 (one block) → [N, 48]."""
    return _hash_fixed(msgs, _H384, 6)


def sha512_var(msgs: torch.Tensor, lens: torch.Tensor,
               max_len: int) -> torch.Tensor:
    """SHA-512 of [N, W] uint8 buffers with per-token ``lens`` ≤ max_len
    → [N, 64]. Bytes at and beyond each token's length MUST be zero."""
    return _hash_var(msgs, lens, max_len, _H512, 8)


def sha384_var(msgs: torch.Tensor, lens: torch.Tensor,
               max_len: int) -> torch.Tensor:
    """SHA-384 of [N, W] uint8 buffers with per-token ``lens`` ≤ max_len
    → [N, 48]. Bytes at and beyond each token's length MUST be zero."""
    return _hash_var(msgs, lens, max_len, _H384, 6)
