"""Batched SHA-256 in plain PyTorch (FIPS 180-4).

The port of the JAX package's ``tpu/sha256.py``: the device hashing of
the PS256 verify tail (MGF1 blocks and H' = SHA-256(0^8 ‖ mHash ‖
salt)), so no EM bytes leave the device. The JAX package computes it
in XLA, outside any Pallas kernel, and so does the port: every round
is elementwise over the lane axis.

Words are int64 tensors holding 32-bit values (torch has no uint32
rotate): every add and shift-left is masked back to 32 bits. Per-token
message lengths run the maximum block count and snapshot each token's
state after its own final block.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
    0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
    0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
    0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
    0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
    0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
    0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
    0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def _ror(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) | ((x << (32 - r)) & M32)


def compress(state, words: torch.Tensor):
    """One SHA-256 compression over the batch.

    state: tuple of 8 [N] int64 32-bit words; words: [16, N] int64
    message words. Returns the new 8-tuple.
    """
    w = list(words.unbind(0))
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t >= 16:
            w15, w2 = w[t - 15], w[t - 2]
            s0 = _ror(w15, 7) ^ _ror(w15, 18) ^ (w15 >> 3)
            s1 = _ror(w2, 17) ^ _ror(w2, 19) ^ (w2 >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
        s1 = _ror(e, 6) ^ _ror(e, 11) ^ _ror(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K[t] + w[t]
        s0 = _ror(a, 2) ^ _ror(a, 13) ^ _ror(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & M32, a, b, c,
                                  (d + t1) & M32, e, f, g)
    return tuple((s + v) & M32 for s, v in
                 zip(state, (a, b, c, d, e, f, g, h)))


def _bytes_to_words(block: torch.Tensor) -> torch.Tensor:
    """[N, 64] uint8 → [16, N] int64 big-endian words."""
    b = block.to(torch.int64).reshape(block.shape[0], 16, 4)
    w = (b[:, :, 0] << 24) | (b[:, :, 1] << 16) | (b[:, :, 2] << 8) | \
        b[:, :, 3]
    return w.T


def _init_state(n: int, device):
    h0 = torch.tensor(_H0, dtype=torch.int64, device=device)
    return tuple(h0[i].expand(n) for i in range(8))


def _digest_bytes(state) -> torch.Tensor:
    """8×[N] 32-bit words → [N, 32] uint8 big-endian digest."""
    w = torch.stack(state, dim=1)                        # [N, 8]
    shifts = torch.tensor([24, 16, 8, 0], device=w.device)
    return ((w[:, :, None] >> shifts) & 0xFF).to(torch.uint8) \
        .reshape(w.shape[0], 32)


def sha256_fixed(msgs: torch.Tensor) -> torch.Tensor:
    """SHA-256 of [N, L] uint8 messages, fixed L ≤ 55 (one block).
    Returns [N, 32] uint8 digests (the MGF1 seeds take this path)."""
    n, length = msgs.shape
    assert length <= 55, "single-block limit"
    block = torch.zeros((n, 64), dtype=torch.uint8, device=msgs.device)
    block[:, :length] = msgs
    block[:, length] = 0x80
    bits = length * 8
    block[:, 62] = bits >> 8
    block[:, 63] = bits & 0xFF
    state = compress(_init_state(n, msgs.device), _bytes_to_words(block))
    return _digest_bytes(state)


def sha256_var(msgs: torch.Tensor, lens: torch.Tensor,
               max_len: int) -> torch.Tensor:
    """SHA-256 of [N, W] uint8 buffers with per-token ``lens`` ≤ max_len.

    Bytes at and beyond each token's length MUST already be zero (the
    0x80 and the bit length are placed per token here). Runs
    ceil((max_len + 9) / 64) compressions and keeps each token's state
    after its own final block. Returns [N, 32] uint8.
    """
    n = msgs.shape[0]
    dev = msgs.device
    n_blocks = (max_len + 9 + 63) // 64
    buf = torch.zeros((n, n_blocks * 64), dtype=torch.uint8, device=dev)
    buf[:, :msgs.shape[1]] = msgs
    pos = torch.arange(n_blocks * 64, device=dev)[None, :]
    lens = lens.to(torch.int64)[:, None]
    buf = torch.where(pos == lens, torch.full_like(buf, 0x80), buf)
    # the 64-bit big-endian bit length ends the token's final block
    # (lens < 2^28: its four low bytes suffice, the rest stay zero)
    final_block = (lens + 8) // 64
    msg_bits = lens * 8
    for j in range(4):
        byte = ((msg_bits >> (8 * (3 - j))) & 0xFF).to(torch.uint8)
        buf = torch.where(pos == final_block * 64 + 60 + j,
                          byte.expand_as(buf), buf)
    state = _init_state(n, dev)
    out = state
    for i in range(n_blocks):
        state = compress(state,
                         _bytes_to_words(buf[:, i * 64:(i + 1) * 64]))
        final = final_block[:, 0] == i
        out = tuple(torch.where(final, s, o) for s, o in zip(state, out))
    return _digest_bytes(out)

