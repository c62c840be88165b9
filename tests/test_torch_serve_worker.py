"""The port's verify worker against the JAX package's, compared as
frames: VerifyWorker over GPUBatchKeySet(device="cpu") and over the
JAX TPUBatchKeySet on one JWKS (2 RSA-2048 + 2 P-256 keys), driven
over 2–3 connections with pipelined requests, raw claims on and off;
each client against the other package's worker over StubKeySet; the
control frames (KEYS, STATS, PING, peer fill, SHM attach); the drain
on close; and ``python -m cap_tpu_torch.fleet.worker_main`` as a
process.

The JAX keyset's packed RS/ES runners go to its own CPU fallback (as
in test_torch_keyset_swap.py), so its verdicts come without an XLA
compile; the engines are held against each other in
test_torch_keyset.py. Every socket has a timeout, every wait a bound."""

import functools
import json
import os
import pathlib
import queue
import random
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu.fleet import worker_main as j_main  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402
from cap_tpu.serve import client as j_client  # noqa: E402
from cap_tpu.serve import protocol as jp  # noqa: E402
from cap_tpu.serve import worker as j_worker  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.fleet import worker_main as t_main  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.jose import b64url_decode, b64url_encode  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402
from cap_tpu_torch.serve import client as t_client  # noqa: E402
from cap_tpu_torch.serve import protocol as tp  # noqa: E402
from cap_tpu_torch.serve import worker as t_worker  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 10.0
TRACE = "00112233445566aa"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx():
    rng = random.Random(41)
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


def _request(tokens, **kw):
    return _frame(tp.send_request, tokens, **kw)


def _frames(fx):
    t = fx["toks"]
    return [[_request(t[:6]), _request(t[6:10], crc=True),
             _request(t[10:], trace=TRACE), _request(t[2:4])],
            [_request(t[4:], crc=True), _request(t[:1])],
            [_request(t[8:12], trace=TRACE), _request(t)]]


def _conns(addr, batches):
    """Each list of frames on its own connection, all at once."""
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


@pytest.fixture(scope="module")
def workers(fx):
    """(port worker, JAX worker) pairs, raw claims on and off."""
    made = {}
    try:
        for raw in (True, False):
            gk = GPUBatchKeySet(t_jwk.parse_jwks(fx["doc"]), device="cpu")
            jk = _host_runners(TPUBatchKeySet(j_jwk.parse_jwks(fx["doc"])))
            kw = dict(raw_claims=raw, target_batch=64, max_wait_ms=150.0)
            made[raw] = (t_worker.VerifyWorker(gk, **kw),
                         j_worker.VerifyWorker(jk, **kw))
        yield made
    finally:
        for pair in made.values():
            for w in pair:
                w.close(deadline_s=TIMEOUT_S)


@pytest.mark.parametrize("raw", [True, False])
def test_responses_equal_the_jax_workers(fx, workers, raw):
    tw, jw = workers[raw]
    batches = _frames(fx)
    got = _conns(tw.address, batches)
    want = _conns(jw.address, batches)
    assert got == want
    first = tp.parse_frame_bytes(got[0][0])[1]
    assert [s for s, _ in first] == [0] * 6
    payload = first[0][1]
    if raw:
        assert payload == b64url_decode(fx["toks"][0].split(".")[1])
    assert json.loads(payload)["sub"] == "r0"
    # the port's client, pipelined, reads the same verdicts
    with t_client.VerifyClient(*tw.address, timeout=TIMEOUT_S) as c, \
            j_client.VerifyClient(*jw.address, timeout=TIMEOUT_S) as jc:
        t_out = list(c.verify_stream([fx["toks"][:5], fx["toks"][5:]]))
        j_out = list(jc.verify_stream([fx["toks"][:5], fx["toks"][5:]]))
    norm = [[(type(r).__name__, str(r)) if isinstance(r, Exception)
             else r for r in b] for b in t_out]
    assert norm == [[(type(r).__name__, str(r)) if isinstance(r, Exception)
                     else r for r in b] for b in j_out]


def test_control_frames(fx, workers):
    tw, jw = workers[True]
    t_stats, j_stats = tw.stats(), jw.stats()
    assert set(t_stats) == set(j_stats)
    for k in ("key_epoch", "serve_chain", "transport", "obs_port"):
        assert t_stats[k] == j_stats[k], k
    frames = [_frame(jp.send_ping),
              _frame(jp.send_shm_attach, "/nonexistent/region"),
              _request(fx["toks"][:3]),
              _frame(jp.send_keys_push, fx["doc_next"], 3),
              _request([fx["toks"][-2]]),
              _frame(jp.send_peer_fill, {"op": "export", "max": 64})]
    got = _exchange(tw.address, frames)
    want = _exchange(jw.address, frames)
    assert got[:5] == want[:5]
    assert tp.parse_frame_bytes(got[1])[1][0][0] == 1       # refused
    assert json.loads(tp.parse_frame_bytes(got[3])[1][0][1]) == {
        "epoch": 3}
    assert tw.key_epoch == jw.key_epoch == 3
    # after the push the new kid verifies, on both
    assert tp.parse_frame_bytes(got[4])[1][0][0] == 0
    # peer fill: the same cached accepts, importable into the other
    t_doc = json.loads(tp.parse_frame_bytes(got[5])[1][0][1])
    j_doc = json.loads(tp.parse_frame_bytes(want[5])[1][0][1])
    assert t_doc["epoch"] == j_doc["epoch"] == 3
    assert sorted(e[:2] for e in t_doc["entries"]) == \
        sorted(e[:2] for e in j_doc["entries"])
    assert tw.peer_fill({"op": "import", "entries": j_doc["entries"],
                         "epoch": 3}) == jw.peer_fill(
        {"op": "import", "entries": t_doc["entries"], "epoch": 3})


class _HeldTimer:
    """threading.Timer held until the test fires it."""

    made = []

    def __init__(self, interval, function, args=()):
        self.function, self.args, self.daemon = function, args, False
        _HeldTimer.made.append(self)

    def start(self):
        pass


def test_cache_forgets_the_grace_accepts(fx, monkeypatch):
    """An accept verified inside a KEYS push's grace window is not
    cached by the port, so once the grace kid retires the token is
    rejected, as the keyset alone rejects it. The reference caches it
    and serves it after the retirement (its fault, ROADMAP C): the two
    workers' frames are equal up to that last answer."""
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
    workers = [t_worker.VerifyWorker(gk, keys_grace_s=5.0),
               j_worker.VerifyWorker(jk)]
    try:
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
        for w in workers:
            w.close(deadline_s=TIMEOUT_S)
    assert out[0][:2] == out[1][:2]
    status = [[tp.parse_frame_bytes(f)[1][0][0] for f in o[1:]] for o in out]
    assert status[1] == [0, 0]                 # the reference's cache
    assert status[0][0] == 0 and status[0][1] != 0
    assert type(gk.verify_batch([tok])[0]).__name__ == \
        type(jk.verify_batch([tok])[0]).__name__ == "InvalidSignatureError"
    assert tp.parse_frame_bytes(out[0][2])[1][0][1].decode().startswith(
        "InvalidSignatureError")


def _stub_pair(**kw):
    return (t_worker.VerifyWorker(t_main.StubKeySet(**kw), max_wait_ms=5.0),
            j_worker.VerifyWorker(j_main.StubKeySet(**kw), max_wait_ms=5.0))


@pytest.mark.parametrize("raw", [0.0, 1.0])
def test_clients_cross_talk_over_the_stub(raw):
    toks = [f"t{i}.{'ok' if i % 3 else 'no'}" for i in range(40)]
    tw, jw = _stub_pair(raw=raw, pipeline=1.0)
    try:
        outs = []
        for client_mod, w in ((j_client, tw), (t_client, jw)):
            with client_mod.VerifyClient(*w.address, timeout=TIMEOUT_S,
                                         crc=True) as c:
                assert c.ping()
                outs.append([c.verify_batch(toks[:7]),
                             list(c.verify_stream([toks[7:], toks[:3]])),
                             c.stats()["serve_chain"]])
        norm = [[(type(r).__name__, str(r)) if isinstance(r, Exception)
                 else r for r in x] if isinstance(x, list) else x
                for x in outs[0][:1]]
        assert norm == [[(type(r).__name__, str(r))
                         if isinstance(r, Exception) else r
                         for r in outs[1][0]]]
        assert outs[0][2] == outs[1][2] == "python"
        assert str(outs[0][0][0]) == ("InvalidSignatureError: no known key "
                                      "successfully validated the token "
                                      "signature")
    finally:
        tw.close(deadline_s=TIMEOUT_S)
        jw.close(deadline_s=TIMEOUT_S)


def test_close_drains_in_flight_requests():
    w = t_worker.VerifyWorker(t_main.StubKeySet(batch_ms=40.0),
                              max_wait_ms=1.0, target_batch=8)
    toks = [[f"d{i}.{k}.ok" for k in range(5)] for i in range(6)]
    s = _connect(w.address)
    try:
        for t in toks:
            s.sendall(_request(t))
        first = _recv_raw_frame(s)
        w.close(deadline_s=TIMEOUT_S)
        frames = [first] + [_recv_raw_frame(s) for _ in toks[1:]]
    finally:
        s.close()
        w.close(deadline_s=TIMEOUT_S)
    for t, f in zip(toks, frames):
        entries = tp.parse_frame_bytes(f)[1]
        assert [json.loads(p) for _, p in entries] == [{"sub": x}
                                                       for x in t]


def test_not_ported_options_raise():
    """Only the front door is still to port: its spec raises, and the
    JAX package's other specs build."""
    with pytest.raises(ValueError, match="ROADMAP"):
        t_main.make_keyset("frontdoor:pool=a:1")
    with pytest.raises(ValueError, match="unknown keyset spec"):
        t_main.make_keyset("nope:x")


def test_worker_main_process():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cap_tpu_torch.fleet.worker_main",
         "--keyset", "stub", "--device", "cpu", "--drain-deadline-s", "5"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        ready = lines.get(timeout=30)
        assert ready.startswith("CAP_FLEET_READY port=")
        fields = dict(kv.split("=", 1) for kv in ready.split()[1:])
        assert fields["pid"] == str(proc.pid)
        assert fields["serve_chain"] == "python"
        with t_client.VerifyClient("127.0.0.1", int(fields["port"]),
                                   timeout=TIMEOUT_S) as c:
            got = c.verify_batch(["a.ok", "b.no"])
        assert got[0] == {"sub": "a.ok"}
        assert type(got[1]).__name__ == "RemoteVerifyError"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT_S)
        proc.stdout.close()
        proc.stderr.close()
