"""CVB1 on the wire: the port's frames are byte-equal to
``cap_tpu.serve.protocol``'s for seeded frames of every type the port
speaks, and a malformed frame raises the same class with the same
message in both."""

import json
import struct
import zlib

import numpy as np
import pytest

from cap_tpu import errors as j_errors
from cap_tpu.serve import protocol as jp

from cap_tpu_torch import errors as t_errors
from cap_tpu_torch.serve import protocol as tp


class _Sink:
    """A socket stand-in that keeps what is sent."""

    def __init__(self):
        self.data = bytearray()

    def sendall(self, b):
        self.data += b


def _sent(fn, *a, **k) -> bytes:
    s = _Sink()
    fn(s, *a, **k)
    return bytes(s.data)


def _tokens(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 300))
        out.append("".join(chr(c) for c in rng.integers(33, 0x2FF, k)))
    return out


def _results(errors, seed: int, n: int):
    """Seeded accepts (dicts and payload bytes) and one of each
    rejection class."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pick = int(rng.integers(3))
        if pick == 0:
            out.append({"sub": f"u{i}", "n": int(rng.integers(1 << 40)),
                        "aud": ["a", "ü"]})
        elif pick == 1:
            out.append(bytes(rng.integers(0, 256, int(rng.integers(64)),
                                          dtype=np.uint8)))
        else:
            out.append(errors.InvalidSignatureError(
                "no known key successfully validated the token signature"))
    out += [errors.MalformedTokenError("token is malformed"),
            errors.UnsupportedAlgError(),
            errors.ExpiredTokenError(),
            errors.ThrottledError(retry_after_ms=250),
            errors.UnknownKeyIDError("kid k9")]
    return out


TRACE = "0123456789abcdef"


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("mode", ["plain", "crc", "trace"])
def test_request_frames(seed, mode):
    toks = _tokens(seed, 12)
    kw = {"plain": {}, "crc": {"crc": True}, "trace": {"trace": TRACE}}[mode]
    got = _sent(tp.send_request, toks, **kw)
    assert got == _sent(jp.send_request, toks, **kw)
    assert tp.parse_frame_bytes(got) == jp.parse_frame_bytes(got)


@pytest.mark.parametrize("mode", ["plain", "crc", "trace"])
def test_response_frames(mode):
    kw = {"plain": {}, "crc": {"crc": True}, "trace": {"trace": TRACE}}[mode]
    got = tp.encode_response(_results(t_errors, 3, 40), **kw)
    assert got == jp.encode_response(_results(j_errors, 3, 40), **kw)
    assert _sent(tp.send_response, _results(t_errors, 3, 40), **kw) == got
    assert tp.parse_frame_bytes(got) == jp.parse_frame_bytes(got)
    ftype, entries, _, _ = tp.parse_frame_bytes(got)
    heads = [p.decode().split(":")[0] for s, p in entries if s == 1]
    assert "ThrottledError" in heads
    throttled = [p.decode() for s, p in entries
                 if p.startswith(b"ThrottledError")][0]
    assert tp.retry_after_hint(throttled) == jp.retry_after_hint(
        throttled) == 0.25


def test_control_frames():
    doc = {"keys": [{"kty": "EC", "crv": "P-256", "kid": "k", "x": "AA",
                     "y": "BB"}]}
    stats = {"pid": 7, "key_epoch": 3, "counters": {"a": 1},
             "series": {}, "snapshot": {}}
    pairs = [
        (_sent(tp.send_ping), _sent(jp.send_ping)),
        (_sent(tp.send_pong), _sent(jp.send_pong)),
        (_sent(tp.send_stats_request), _sent(jp.send_stats_request)),
        (tp.encode_stats_response(stats), jp.encode_stats_response(stats)),
        (tp.keys_payload(doc, 4), jp.keys_payload(doc, 4)),
        (_sent(tp.send_keys_push, doc, 4), _sent(jp.send_keys_push, doc, 4)),
        (tp.encode_keys_ack(epoch=4), jp.encode_keys_ack(epoch=4)),
        (tp.encode_keys_ack(error="InvalidJWKSError: bad"),
         jp.encode_keys_ack(error="InvalidJWKSError: bad")),
        (_sent(tp.send_peer_fill, {"op": "export", "max": 8}),
         _sent(jp.send_peer_fill, {"op": "export", "max": 8})),
        (tp.encode_peer_ack(doc={"imported": 2}),
         jp.encode_peer_ack(doc={"imported": 2})),
        (tp.encode_peer_ack(error="TypeError: no cache"),
         jp.encode_peer_ack(error="TypeError: no cache")),
        (_sent(tp.send_shm_attach, "/tmp/region"),
         _sent(jp.send_shm_attach, "/tmp/region")),
        (tp.encode_shm_ack(), jp.encode_shm_ack()),
        (tp.encode_shm_ack(error="TypeError: no shm"),
         jp.encode_shm_ack(error="TypeError: no shm")),
    ]
    for i, (t, j) in enumerate(pairs):
        assert t == j, i
        if i != 4:                  # the KEYS payload is not a frame
            assert tp.parse_frame_bytes(t) == jp.parse_frame_bytes(t), i


def _hdr(ftype, count, magic=tp.MAGIC):
    return struct.pack("<IBI", magic, ftype, count)


def _crc(b: bytes) -> bytes:
    return b + struct.pack("<I", zlib.crc32(b) & 0xFFFFFFFF)


def _malformed():
    good = _sent(jp.send_request, ["a.b.c"], crc=True)
    flipped = bytearray(good)
    flipped[12] ^= 0x01
    return {
        "bad magic": _hdr(1, 0, magic=0x12345678),
        "unknown type": _hdr(99, 0),
        "ping with entries": _hdr(3, 1),
        "too many entries": _hdr(1, tp.MAX_FRAME_ENTRIES + 1),
        "oversize entry": _hdr(1, 1) + struct.pack(
            "<I", tp.MAX_ENTRY_BYTES + 1),
        "oversize frame": _hdr(1, 300) + b"".join(
            struct.pack("<I", tp.MAX_ENTRY_BYTES) for _ in range(1)),
        "bad status": _hdr(2, 1) + struct.pack("<BI", 7, 0),
        "crc mismatch": bytes(flipped),
        "bad trace": _crc(_hdr(9, 0) + bytes([3]) + b"XYZ"),
        "empty trace": _crc(_hdr(9, 0) + bytes([0])),
        "truncated": _hdr(1, 2) + struct.pack("<I", 5) + b"ab",
    }


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_malformed_frames_raise_alike(case):
    data = _malformed()[case]
    errs = []
    for mod in (tp, jp):
        try:
            mod.parse_frame_bytes(data)
            errs.append(None)
        except Exception as e:  # noqa: BLE001 - compared below
            errs.append((type(e).__name__, str(e)))
    assert errs[0] is not None and errs[0] == errs[1], errs


def test_frame_reader_matches_over_a_stream():
    """The buffered reader of each package reads the other's frames."""
    frames = [_sent(jp.send_request, _tokens(4, 5), trace=TRACE),
              tp.encode_response(_results(t_errors, 5, 9), crc=True),
              _sent(tp.send_ping),
              jp.encode_keys_ack(epoch=9)]
    blob = b"".join(frames)

    class _Src:
        def __init__(self, data):
            self.data = memoryview(data)

        def recv(self, n):
            out = bytes(self.data[:min(n, 7)])
            self.data = self.data[len(out):]
            return out

        def recv_into(self, view, n=0):
            out = self.recv(len(view))
            view[:len(out)] = out
            return len(out)

    outs = []
    for mod in (tp, jp):
        r = mod.FrameReader(_Src(blob))
        outs.append([r.recv_frame_ex() for _ in frames])
    assert outs[0] == outs[1]
    assert json.loads(outs[0][3][1][0][1]) == {"epoch": 9}
