"""The port's native serve chain against the JAX package's.

The copied C++ sources are the reference's, byte for byte; the port's
``native_serve.probe_frame`` gives the JAX one's status, and the class
both ``protocol`` parsers raise, on the malformed-frame corpus, a
seeded mutation sweep and the Go golden vectors; ``VerifyWorker(
serve_native=True)`` over ``GPUBatchKeySet(device="cpu")`` answers
with the JAX native worker's frames over ``TPUBatchKeySet`` on one
JWKS (2 RSA-2048 + 2 P-256 keys, raw claims on and off), pipelined and
with KEYS / STATS / PING interleaved; the telemetry planes count alike;
each package's native client talks to the other's native worker; the
native drain caches no accept made inside a KEYS grace window.

The JAX keyset's packed RS/ES runners go to its own CPU fallback (as
in test_torch_serve_worker.py). Every socket has a timeout, every
worker closes with a deadline."""

import filecmp
import functools
import json
import os
import pathlib
import random
import socket
import struct
import threading
import time
import zlib

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu import telemetry as j_tel  # noqa: E402
from cap_tpu.fleet import worker_main as j_main  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402
from cap_tpu.serve import native_client as j_nclient  # noqa: E402
from cap_tpu.serve import native_serve as j_native  # noqa: E402
from cap_tpu.serve import protocol as jp  # noqa: E402
from cap_tpu.serve import worker as j_worker  # noqa: E402

from cap_tpu_torch import _build  # noqa: E402
from cap_tpu_torch import telemetry as t_tel  # noqa: E402
from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.fleet import worker_main as t_main  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402
from cap_tpu_torch.jwt.jose import b64url_encode  # noqa: E402
from cap_tpu_torch.obs import decision as t_dec  # noqa: E402
from cap_tpu_torch.serve import batcher as t_batcher  # noqa: E402
from cap_tpu_torch.serve import native_client as t_nclient  # noqa: E402
from cap_tpu_torch.serve import native_serve as t_native  # noqa: E402
from cap_tpu_torch.serve import protocol as tp  # noqa: E402
from cap_tpu_torch.serve import worker as t_worker  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "clients" / "go" / "captpu" / "testdata"
TIMEOUT_S = 10.0
TRACE = "00112233445566aa"
COPIES = [("runtime/native", n) for n in (
    "cvb1_wire.h", "shm_ring.h", "shm_ring.cpp", "telemetry_native.h",
    "telemetry_native.cpp", "serve_native.cpp")] + [
    ("serve/native", "client_native.cpp")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the sources and the build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where,name", COPIES,
                         ids=[n for _, n in COPIES])
def test_native_source_is_the_reference_copy(where, name):
    ours = REPO / "cap_tpu_torch" / where / name
    theirs = REPO / "cap_tpu" / where / name
    assert filecmp.cmp(ours, theirs, shallow=False), name


def test_serve_and_client_targets(monkeypatch, tmp_path):
    """``serve`` links the JOSE prep's sha2::sha256 (a library without
    it would not load); each target's name hashes every source and
    header, so an edit of a shared header rebuilds it."""
    assert _build.HOST_TARGETS["serve"] == (
        ("jose_native.cpp", "serve_native.cpp", "telemetry_native.cpp",
         "shm_ring.cpp"),
        ("cvb1_wire.h", "shm_ring.h", "telemetry_native.h"))
    assert _build.HOST_TARGETS["client"] == (("client_native.cpp",), ())
    for name in ("serve", "client"):
        assert pathlib.Path(_build.load(name)._name).parent == \
            _build.BUILD_DIR
    assert t_native.load() is _build.load("serve")
    names = {_build._target("serve")}
    for header in ("cvb1_wire.h", "shm_ring.h", "telemetry_native.h",
                   "jose_native.cpp"):
        src = tmp_path / header
        src.mkdir()
        for f in _build.HOST_SRC.iterdir():
            (src / f.name).write_bytes(f.read_bytes())
        with open(src / header, "ab") as f:
            f.write(b"\n")
        monkeypatch.setattr(_build, "HOST_SRC", src)
        names.add(_build._target("serve"))
    assert len(names) == 5


def test_missing_symbol_or_layout_drift_raises(monkeypatch):
    """Nothing optional: a library without a symbol of any group, or
    whose layout drifted from the registries, raises at load."""
    lib = _build.load("serve")

    class Stale:
        def __getattr__(self, name):
            if name == "cap_serve_drain_enq":
                raise AttributeError(name)
            return getattr(lib, name)

    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(_build, "load", lambda name: Stale())
    with pytest.raises(ImportError, match="cap_serve_drain_enq"):
        t_native.load()
    monkeypatch.undo()
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_dec, "RING_SAMPLE_EVERY",
                        t_dec.RING_SAMPLE_EVERY + 1)
    with pytest.raises(ImportError, match="telemetry layout"):
        t_native.load()
    monkeypatch.undo()
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_dec, "N_TENANT", t_dec.N_TENANT + 1)
    with pytest.raises(ImportError, match="layout"):
        t_native.load()


def test_uds_with_the_native_chain_raises(tmp_path):
    with pytest.raises(ValueError, match="TCP only"):
        t_worker.VerifyWorker(t_main.StubKeySet(), serve_native=True,
                              uds_path=str(tmp_path / "w.sock"))
    assert not (tmp_path / "w.sock").exists()


# ---------------------------------------------------------------------------
# frame rejection: the same status and class in both packages
# ---------------------------------------------------------------------------


def _hdr(ftype: int, count: int) -> bytes:
    return struct.pack("<IBI", tp.MAGIC, ftype, count)


def _crc_fix(frame: bytes) -> bytes:
    body = frame[:-4]
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


class _Sink:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


def _frame(send, *a, **kw) -> bytes:
    """The bytes ``send(sock, ...)`` writes."""
    sink = _Sink()
    send(sink, *a, **kw)
    return sink.data


def _corpus():
    P = tp
    plain_req = _frame(P.send_request, ["corpus-a.ok", "corpus-b"])
    crc_req = _frame(P.send_request, ["corpus-crc"], crc=True)
    traced_req = _frame(P.send_request, ["corpus-tr"],
                        trace="00112233aabbccdd")
    crc_resp = _frame(P.send_response, [{"s": 1}], crc=True)
    return [
        ("count-bomb", _hdr(P.T_VERIFY_REQ, 0xFFFFFFFF)),
        ("entry-length-bomb",
         _hdr(P.T_VERIFY_REQ, 1) + struct.pack("<I", 0xFFFFFFFF)),
        ("entry-over-bound",
         _hdr(P.T_VERIFY_REQ, 1) + struct.pack("<I", P.MAX_ENTRY_BYTES + 1)),
        ("response-length-bomb",
         _hdr(P.T_VERIFY_RESP, 1) + struct.pack("<BI", 0, 0xFFFFFFFF)),
        ("bad-magic", b"XXXX" + plain_req[4:]),
        ("unknown-type", _hdr(99, 0)),
        ("ping-nonzero-count", _hdr(P.T_PING, 2)),
        ("keys-push-two-entries", _crc_fix(
            _hdr(P.T_KEYS_PUSH, 2) + struct.pack("<I", 1) + b"x"
            + struct.pack("<I", 1) + b"y" + b"\0\0\0\0")),
        ("shm-attach-two-entries", _crc_fix(
            _hdr(P.T_SHM_ATTACH, 2) + struct.pack("<I", 1) + b"x"
            + struct.pack("<I", 1) + b"y" + b"\0\0\0\0")),
        ("shm-ack-two-entries", _crc_fix(
            _hdr(P.T_SHM_ACK, 2) + struct.pack("<BI", 0, 1) + b"x"
            + struct.pack("<BI", 0, 1) + b"y" + b"\0\0\0\0")),
        ("shm-attach-bad-crc",
         (lambda f: f[:-5] + bytes([f[-5] ^ 0x01]) + f[-4:])(
             _frame(P.send_shm_attach, "/dev/shm/corpus"))),
        ("bad-status-plain",
         _hdr(P.T_VERIFY_RESP, 1) + struct.pack("<BI", 7, 1) + b"z"),
        ("bad-status-checksummed", _crc_fix(
            _hdr(P.T_VERIFY_RESP_CRC, 1) + struct.pack("<BI", 7, 1)
            + b"z" + b"\0\0\0\0")),
        ("bad-crc-request",
         crc_req[:-5] + bytes([crc_req[-5] ^ 0x01]) + crc_req[-4:]),
        ("bad-crc-response",
         crc_resp[:15] + bytes([crc_resp[15] ^ 0x80]) + crc_resp[16:]),
        ("length-bomb-beats-crc",
         crc_resp[:12] + bytes([crc_resp[12] ^ 0x80]) + crc_resp[13:]),
        ("bad-crc-traced",
         traced_req[:20] + bytes([traced_req[20] ^ 0x01])
         + traced_req[21:]),
        ("trace-len-zero", _hdr(P.T_VERIFY_REQ_TRACE, 0) + b"\x00"),
        ("trace-len-overlong",
         _hdr(P.T_VERIFY_REQ_TRACE, 0) + bytes([P.MAX_TRACE_BYTES + 1])
         + b"a" * (P.MAX_TRACE_BYTES + 1) + b"\0\0\0\0"),
        ("trace-not-hex", _crc_fix(
            _hdr(P.T_VERIFY_REQ_TRACE, 0) + bytes([4]) + b"GGGG"
            + b"\0\0\0\0")),
        ("trace-truncated",
         _hdr(P.T_VERIFY_REQ_TRACE, 0) + bytes([16]) + b"ab12"),
        ("token-not-utf8",
         _hdr(P.T_VERIFY_REQ, 1) + struct.pack("<I", 2) + b"\xff\xfe"),
        ("truncated-mid-entry", plain_req[: len(plain_req) - 3]),
    ]


CORPUS = _corpus()


def _py_class(proto, frame):
    """The class name ``proto.parse_frame_bytes`` raises (None: ok)."""
    try:
        proto.parse_frame_bytes(frame)
        return None
    except (proto.ProtocolError, ConnectionError, UnicodeDecodeError) as e:
        return type(e).__name__


def _native_class(proto, status):
    return None if status == 0 else proto.NATIVE_STATUS_ERRORS[status].__name__


@pytest.mark.parametrize("name,frame", CORPUS, ids=[n for n, _ in CORPUS])
def test_malformed_corpus_same_status_and_class(name, frame):
    st = t_native.probe_frame(frame)
    assert st != 0, name
    assert st == j_native.probe_frame(frame), name
    got = _native_class(tp, st)
    assert got == _native_class(jp, st)
    assert got == _py_class(tp, frame) == _py_class(jp, frame), name


def test_mutation_sweep_same_status_and_class():
    """Seeded single-byte mutations of a checksummed and a traced
    request and a response: the port's native status equals the JAX
    one on every mutant, and its class is (a base of) both Python
    parsers' class."""
    rng = random.Random(15)
    classes = {c.__name__: c for c in (
        tp.ProtocolError, tp.MalformedFrameError, tp.FrameTooLargeError,
        tp.FrameCorruptError, ConnectionError, UnicodeDecodeError)}
    bases = [_frame(tp.send_request, ["fuzz-a.ok", "fuzz-b"], crc=True),
             _frame(tp.send_request, ["fuzz-c"], trace=TRACE),
             _frame(tp.send_response, [{"sub": "x"}, ValueError("no")])]
    n = 0
    for base in bases:
        for off in range(len(base)):
            for xor in (0x01, 0x80, rng.randrange(1, 256)):
                frame = base[:off] + bytes([base[off] ^ xor]) + base[off + 1:]
                st = t_native.probe_frame(frame)
                assert st == j_native.probe_frame(frame), (off, xor)
                want = _py_class(tp, frame)
                assert want == _py_class(jp, frame), (off, xor)
                got = _native_class(tp, st)
                assert got == want or (
                    got is not None and want is not None and issubclass(
                        classes[want], tp.NATIVE_STATUS_ERRORS[st])), \
                    (off, xor, got, want)
                n += 1
    assert n == 3 * sum(len(b) for b in bases)


def test_golden_vectors_accepted_by_both_parsers():
    names = sorted(f for f in os.listdir(GOLDEN_DIR) if f.endswith(".bin"))
    assert len(names) >= 8
    for name in names:
        data = (GOLDEN_DIR / name).read_bytes()
        for proto in (tp, jp):
            assert proto.parse_frame_bytes(data)[3] == len(data), name
        assert t_native.probe_frame(data) == 0, name
        assert j_native.probe_frame(data) == 0, name


# ---------------------------------------------------------------------------
# the native worker against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fx():
    rng = random.Random(43)
    rs = [tt.generate_rsa_key(rng) for _ in range(3)]
    es = [tt.generate_ec_key(rng) for _ in range(2)]
    keys = [t_jwk.serialize_public_key(k.public_key(), kid=f"rs-{i}")
            for i, k in enumerate(rs)]
    keys += [t_jwk.serialize_public_key(k.public_key(), kid=f"es-{i}")
             for i, k in enumerate(es)]
    toks = []
    for i in range(6):
        toks.append(tt.sign_jwt(rs[i % 2], "RS256",
                                tt.default_claims(sub=f"r{i}"),
                                kid=f"rs-{i % 2}", rng=rng))
        toks.append(tt.sign_jwt(es[i % 2], "ES256",
                                tt.default_claims(sub=f"e{i}"),
                                kid=f"es-{i % 2}", rng=rng))
    h, p, s = toks[0].split(".")
    toks += [f"{h}.{p}.{s[:-4]}AAAA", "not-a-token", "",
             tt.sign_jwt(rs[2], "RS256", tt.default_claims(), kid="rs-2",
                         rng=rng),
             h + "." + b64url_encode(b"[1]") + "." + s]
    return dict(doc={"keys": keys[:2] + keys[3:]},
                doc_next={"keys": keys}, toks=toks, rs=rs)


def _host_runners(jk):
    """Send the JAX keyset's packed RS/ES tokens to its CPU fallback."""
    def to_slow(idx, pb, parts, meta, pending, slow, *a, **k):
        slow.extend(int(i) for i in idx)

    jk._run_rsa_packed = lambda kind, h, *a, **k: to_slow(*a, **k)
    jk._run_ec_packed = lambda alg, *a, **k: to_slow(*a, **k)
    return jk


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise ConnectionError("peer closed")
        buf += got
    return bytes(buf)


def _recv_raw_frame(sock) -> bytes:
    """One whole response-side frame as the bytes on the wire."""
    hdr = _recv_exact(sock, 9)
    _, ftype, count = struct.unpack("<IBI", hdr)
    out = bytearray(hdr)
    if ftype in (tp.T_VERIFY_REQ_TRACE, tp.T_VERIFY_RESP_TRACE):
        n = _recv_exact(sock, 1)
        out += n + _recv_exact(sock, n[0])
    for _ in range(count):
        head = _recv_exact(sock, 5)
        out += head + _recv_exact(sock, struct.unpack("<BI", head)[1])
    if ftype >= tp.T_VERIFY_REQ_CRC:
        out += _recv_exact(sock, 4)
    return bytes(out)


def _connect(addr):
    return socket.create_connection(addr, timeout=TIMEOUT_S)


def _exchange(addr, frames):
    """Send every request frame first (pipelined), then read one
    response frame each, in order."""
    with _connect(addr) as s:
        for f in frames:
            s.sendall(f)
        return [_recv_raw_frame(s) for _ in frames]


def _request(tokens, **kw):
    return _frame(tp.send_request, tokens, **kw)


def _conns(addr, batches):
    out = [None] * len(batches)
    errs = []

    def run(i):
        try:
            out[i] = _exchange(addr, batches[i])
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(batches))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(TIMEOUT_S * 3)
    assert not errs, errs
    assert all(o is not None for o in out)
    return out


def _close_all(workers):
    for w in workers:
        t0 = time.monotonic()
        w.close(deadline_s=TIMEOUT_S)
        assert time.monotonic() - t0 < TIMEOUT_S + 2


@pytest.fixture(scope="module")
def workers(fx):
    """(port native worker, JAX native worker), raw claims on and off."""
    made = {}
    try:
        for raw in (True, False):
            gk = GPUBatchKeySet(t_jwk.parse_jwks(fx["doc"]), device="cpu")
            jk = _host_runners(TPUBatchKeySet(j_jwk.parse_jwks(fx["doc"])))
            kw = dict(raw_claims=raw, target_batch=64, max_wait_ms=150.0,
                      serve_native=True)
            made[raw] = (t_worker.VerifyWorker(gk, **kw),
                         j_worker.VerifyWorker(jk, **kw))
            assert [w.serve_chain for w in made[raw]] == ["native"] * 2
        yield made
    finally:
        for pair in made.values():
            _close_all(pair)


@pytest.mark.parametrize("raw", [True, False])
def test_native_responses_equal_the_jax_native_workers(fx, workers, raw):
    tw, jw = workers[raw]
    t = fx["toks"]
    batches = [[_request(t[:6]), _request(t[6:10], crc=True),
                _request(t[10:], trace=TRACE), _request(t[2:4])],
               [_request(t[4:], crc=True), _request(t[:1])],
               [_request(t[8:12], trace=TRACE), _request(t)]]
    got = _conns(tw.address, batches)
    assert got == _conns(jw.address, batches)
    first = tp.parse_frame_bytes(got[0][0])[1]
    assert [st for st, _ in first] == [0] * 6
    assert json.loads(first[0][1])["sub"] == "r0"
    # and the port's Python chain answers with the same bytes
    gk = GPUBatchKeySet(t_jwk.parse_jwks(fx["doc"]), device="cpu")
    py = t_worker.VerifyWorker(gk, raw_claims=raw, target_batch=64,
                               max_wait_ms=150.0)
    try:
        assert _conns(py.address, batches) == got
    finally:
        _close_all([py])


def test_native_control_frames_in_order(fx, workers):
    """Verify, PING, STATS, KEYS, verify, peer fill on one connection:
    responses in request order, equal to the JAX native worker's but
    for the STATS document."""
    tw, jw = workers[True]
    frames = [_request(fx["toks"][:3]), _frame(jp.send_ping),
              _frame(jp.send_stats_request),
              _frame(jp.send_shm_attach, "/nonexistent/region"),
              _frame(jp.send_keys_push, fx["doc_next"], 3),
              _request([fx["toks"][-2]]),
              _frame(jp.send_peer_fill, {"op": "export", "max": 64})]
    got = _exchange(tw.address, frames)
    want = _exchange(jw.address, frames)
    for i in (0, 1, 3, 4, 5):
        assert got[i] == want[i], i
    stats = [json.loads(tp.parse_frame_bytes(f[2])[1][0][1])
             for f in (got, want)]
    assert set(stats[0]) == set(stats[1])
    for k in ("serve_chain", "transport", "key_epoch", "obs_port"):
        assert stats[0][k] == stats[1][k], k
    assert stats[0]["serve_chain"] == "native"
    assert tp.parse_frame_bytes(got[1])[0] == tp.T_PONG
    assert tp.parse_frame_bytes(got[3])[1][0][0] == 1          # refused
    assert json.loads(tp.parse_frame_bytes(got[4])[1][0][1]) == {"epoch": 3}
    assert tp.parse_frame_bytes(got[5])[1][0][0] == 0          # new kid
    assert tw.key_epoch == jw.key_epoch == 3
    t_doc = json.loads(tp.parse_frame_bytes(got[6])[1][0][1])
    j_doc = json.loads(tp.parse_frame_bytes(want[6])[1][0][1])
    assert t_doc["epoch"] == j_doc["epoch"] == 3
    assert sorted(e[:2] for e in t_doc["entries"]) == \
        sorted(e[:2] for e in j_doc["entries"])
    counters = tw._native.counters()
    assert counters["serve.native.frames"] >= len(frames)
    assert counters["serve.native.pongs"] >= 1


def test_native_clients_cross_talk():
    """Each package's C client against the other's native worker."""
    toks = [f"n{i}.{'ok' if i % 3 else 'no'}" for i in range(40)]
    tw = t_worker.VerifyWorker(t_main.StubKeySet(), serve_native=True,
                               max_wait_ms=2.0)
    jw = j_worker.VerifyWorker(j_main.StubKeySet(), serve_native=True,
                               max_wait_ms=2.0)
    try:
        outs = []
        for client_mod, w in ((j_nclient, tw), (t_nclient, jw)):
            c = client_mod.NativeVerifyClient(*w.address)
            try:
                assert c.ping()
                outs.append(c.verify_batch(toks) + c.verify_batch(toks[:3]))
            finally:
                c.close()
        norm = [[(type(r).__name__, str(r)) if isinstance(r, Exception)
                 else r for r in o] for o in outs]
        assert norm[0] == norm[1]
        assert norm[0][1] == {"sub": "n1.ok"}
        assert norm[0][0] == ("RemoteVerifyError", "InvalidSignatureError: "
                              "no known key successfully validated the "
                              "token signature")
    finally:
        _close_all([tw, jw])


def test_telemetry_planes_count_alike(fx):
    """The same mixed traffic through both native workers with the
    telemetry plane on: equal decision counters and latency series
    counts; then one standalone fold through each plane."""
    toks = [f"t{i}.{'ok' if i % 4 else 'no'}" for i in range(64)]
    toks += fx["toks"]
    snaps = []
    with t_tel.recording(), j_tel.recording():
        tw = t_worker.VerifyWorker(t_main.StubKeySet(), serve_native=True,
                                   max_wait_ms=2.0)
        jw = j_worker.VerifyWorker(j_main.StubKeySet(), serve_native=True,
                                   max_wait_ms=2.0)
        try:
            assert tw._native.obs_plane is not None
            assert jw._native.obs_plane is not None
            for w in (tw, jw):
                # one request at a time: each is one drained chunk
                for req in (_request(toks[:40]), _request(toks[40:],
                                                          crc=True)):
                    _exchange(w.address, [req])
                deadline = time.monotonic() + TIMEOUT_S
                while True:
                    c = w._native.obs_plane.counters()
                    if sum(v for k, v in c.items()
                           if k == "decision.serve.accept"
                           or k.startswith("decision.serve.reject.")
                           ) >= len(toks) \
                            or time.monotonic() > deadline:
                        break
                    time.sleep(0.02)
                snaps.append(w._native.obs_plane.snapshot())
        finally:
            _close_all([tw, jw])
    assert snaps[0]["counters"] == snaps[1]["counters"]
    assert snaps[0]["counters"]["decision.serve.reject.bad_signature"] > 0
    for name in ("serve.native.request_s", "serve.native.chunk_tokens"):
        assert snaps[0]["series"].get(name, {}).get("count") == \
            snaps[1]["series"].get(name, {}).get("count"), name
    planes = [t_native.NativeTelemetryPlane(),
              j_native.NativeTelemetryPlane()]
    try:
        from cap_tpu import errors as j_err
        from cap_tpu_torch import errors as t_err

        for plane, err in zip(planes, (t_err, j_err)):
            results = [{"sub": "a"}, err.ExpiredTokenError("x"),
                       err.InvalidSignatureError("y"), {"sub": "b"},
                       err.MalformedTokenError("z"),
                       err.UnknownKeyIDError("k")]
            plane.fold_batch(results, tokens=fx["toks"][:6],
                             latency_s=0.004, trace=TRACE)
        assert planes[0].counters() == planes[1].counters()
    finally:
        for plane in planes:
            plane.destroy()


def _decision_counts(counters):
    return {k: v for k, v in counters.items()
            if k.startswith("decision.serve.") and v}


def test_native_obs_off_folds_alike(fx):
    """native_obs=False: the native chain folds its decisions in Python
    (record_batch) into the recorder, with the same decision counters
    as the telemetry plane counts on the same traffic."""
    toks = [f"t{i}.{'ok' if i % 4 else 'no'}" for i in range(64)]
    toks += fx["toks"]
    got = []
    for obs in (True, False):
        with t_tel.recording() as rec:
            w = t_worker.VerifyWorker(t_main.StubKeySet(), serve_native=True,
                                      max_wait_ms=2.0, native_obs=obs)
            try:
                plane = w._native.obs_plane
                assert (plane is not None) == obs
                # one request at a time: each is one drained chunk
                for req in (_request(toks[:40]), _request(toks[40:],
                                                          crc=True)):
                    _exchange(w.address, [req])
                deadline = time.monotonic() + TIMEOUT_S
                while True:
                    counts = _decision_counts(
                        plane.counters() if obs else rec.counters())
                    if sum(v for k, v in counts.items()
                           if k == "decision.serve.accept"
                           or k.startswith("decision.serve.reject.")
                           ) >= len(toks) \
                            or time.monotonic() > deadline:
                        break
                    time.sleep(0.02)
            finally:
                _close_all([w])
        got.append(counts)
    assert got[0] == got[1]
    assert got[0]["decision.serve.reject.bad_signature"] > 0


class _HeldTimer:
    """threading.Timer held until the test fires it."""

    made = []

    def __init__(self, interval, function, args=()):
        self.function, self.args, self.daemon = function, args, False
        _HeldTimer.made.append(self)

    def start(self):
        pass


def test_cache_forgets_the_grace_accepts(fx, monkeypatch):
    """On the native chains: an accept verified inside a KEYS push's
    grace window is not cached by the port's drain, so once the grace
    kid retires the token is rejected, as the keyset alone rejects it.
    The reference's native drain caches it (its fault, ROADMAP C): the
    two workers' frames are equal up to that last answer."""
    monkeypatch.setattr(threading, "Timer", _HeldTimer)
    _HeldTimer.made.clear()
    tok = tt.sign_jwt(fx["rs"][0], "RS256",
                      tt.default_claims(now=int(time.time()), ttl=3600),
                      kid="rs-0", rng=random.Random(7))
    push = _frame(jp.send_keys_push, {"keys": [
        k for k in fx["doc_next"]["keys"] if k["kid"] != "rs-0"]}, 1)
    gk = GPUBatchKeySet(t_jwk.parse_jwks(fx["doc"]), device="cpu")
    jk = _host_runners(TPUBatchKeySet(j_jwk.parse_jwks(fx["doc"])))
    jk.swap_keys = functools.partial(jk.swap_keys, grace_s=5.0)
    workers = [t_worker.VerifyWorker(gk, keys_grace_s=5.0,
                                     serve_native=True),
               j_worker.VerifyWorker(jk, serve_native=True)]
    try:
        assert [w.serve_chain for w in workers] == ["native"] * 2
        socks = [_connect(w.address) for w in workers]
        try:
            out = []
            for s in socks:
                s.sendall(push + _request([tok]))
                out.append([_recv_raw_frame(s), _recv_raw_frame(s)])
            assert len(_HeldTimer.made) == 2
            for t in _HeldTimer.made:
                t.function(*t.args)
            for s, o in zip(socks, out):
                s.sendall(_request([tok]))
                o.append(_recv_raw_frame(s))
        finally:
            for s in socks:
                s.close()
    finally:
        _close_all(workers)
    assert out[0][:2] == out[1][:2]
    status = [[tp.parse_frame_bytes(f)[1][0][0] for f in o[1:]] for o in out]
    assert status[1] == [0, 0]                 # the reference's cache
    assert status[0][0] == 0 and status[0][1] != 0
    assert tp.parse_frame_bytes(out[0][2])[1][0][1].decode().startswith(
        "InvalidSignatureError")


def test_close_drains_and_joins_within_its_deadline():
    """Requests queued in the ring when close starts are answered;
    the C++ threads join inside the deadline."""
    w = t_worker.VerifyWorker(t_main.StubKeySet(batch_ms=40.0),
                              serve_native=True, max_wait_ms=1.0,
                              target_batch=8)
    toks = [[f"d{i}.{k}.ok" for k in range(5)] for i in range(6)]
    s = _connect(w.address)
    try:
        for t in toks:
            s.sendall(_request(t))
        first = _recv_raw_frame(s)
        t0 = time.monotonic()
        w.close(deadline_s=TIMEOUT_S)
        assert time.monotonic() - t0 < TIMEOUT_S
        frames = [first] + [_recv_raw_frame(s) for _ in toks[1:]]
    finally:
        s.close()
    for t, f in zip(toks, frames):
        entries = tp.parse_frame_bytes(f)[1]
        assert [json.loads(p) for _, p in entries] == [{"sub": x} for x in t]
    assert w._native.counters()["serve.native.frames"] == len(toks)


def test_batcher_handoff_callback_runs_once_per_chunk():
    calls = []
    b = t_batcher.AdaptiveBatcher(t_main.StubKeySet(), target_batch=8,
                                  max_wait_ms=1.0)
    try:
        p = b.submit_handoff(["h1.ok", "h2.bad", "h3.ok"],
                             on_done=lambda rs: calls.append(list(rs)))
        assert p.event.wait(TIMEOUT_S)
        assert len(calls) == 1
        assert calls[0][0] == {"sub": "h1.ok"}
        assert isinstance(calls[0][1], Exception)
        b.submit_handoff([], on_done=lambda rs: calls.append(rs))
        assert calls[1] == []
    finally:
        b.close(deadline_s=TIMEOUT_S)
