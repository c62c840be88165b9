"""The port's shared-memory transport against the JAX package's.

A region either package writes, the other reads: the port's Python
ring with the JAX C ring (``cap_shm_*``), the JAX Python ring with the
port's C ring, both ways with wraparound. Torn writes, stale
generations, overruns and oversize records raise classes of the same
name in both packages. Both of the port's serve chains with
``transport="shm"`` answer the port's and the JAX package's
``ShmVerifyClient`` with the socket transport's frames (over
``GPUBatchKeySet(device="cpu")``); a ``transport="socket"`` worker
refuses the attach and keeps serving the socket; a kill -9 of an shm
client costs the worker nothing; ``worker_main --serve-chain native
--transport shm`` serves a request and drains on SIGTERM."""

import ctypes
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

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu.serve import native_serve as j_native  # noqa: E402
from cap_tpu.serve import shm_client as j_shmc  # noqa: E402
from cap_tpu.serve import shm_ring as j_ring  # noqa: E402

from cap_tpu_torch import telemetry as t_tel  # noqa: E402
from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.fleet import worker_main as t_main  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402
from cap_tpu_torch.serve import client as t_client  # noqa: E402
from cap_tpu_torch.serve import native_serve as t_native  # noqa: E402
from cap_tpu_torch.serve import protocol as tp  # noqa: E402
from cap_tpu_torch.serve import shm_client as t_shmc  # noqa: E402
from cap_tpu_torch.serve import shm_ring as t_ring  # noqa: E402
from cap_tpu_torch.serve import worker as t_worker  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 10.0
RINGS = {"port": t_ring, "jax": j_ring}
CHAINS = ["python", "native"]
_u8p = ctypes.POINTER(ctypes.c_uint8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the region and its rings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("py,c", [("port", "jax"), ("jax", "port")])
def test_python_ring_and_c_ring_interoperate(tmp_path, py, c):
    """Records the one package's Python ring writes, the other's C ring
    reads intact, and back, through several wraparounds."""
    ring = RINGS[py]
    lib = (t_native if c == "port" else j_native).load()
    path = str(tmp_path / "interop")
    r = ring.ShmRegion.create(path, req_size=8192, resp_size=8192)
    try:
        cr = lib.cap_shm_open(path.encode())
        assert cr
        buf = np.zeros(8192, np.uint8)
        try:
            prod = ring.RingProducer(r, "req")
            for i in range(200):
                msg = (b"py->c-%03d-" % i) + b"z" * (i * 7 % 500)
                prod.write(msg)
                n = int(lib.cap_shm_read(ctypes.c_void_p(cr), 0,
                                         buf.ctypes.data_as(_u8p), 8192,
                                         1.0))
                assert n == len(msg) and buf[:n].tobytes() == msg, i
            cons = ring.RingConsumer(r, "resp")
            for i in range(200):
                msg = (b"c->py-%03d-" % i) + b"q" * (i * 11 % 500)
                arr = np.frombuffer(msg, np.uint8)
                assert int(lib.cap_shm_write(ctypes.c_void_p(cr), 1,
                                             arr.ctypes.data_as(_u8p),
                                             len(msg), 1.0)) == 0
                assert cons.read(timeout=1.0) == msg, i
        finally:
            lib.cap_shm_close(ctypes.c_void_p(cr), 0)
    finally:
        r.close(unlink=True)


def test_regions_cross_packages(tmp_path):
    """A region one package creates the other opens with the same
    geometry and generation, and reads what the first wrote."""
    for a, b in (("port", "jax"), ("jax", "port")):
        path = str(tmp_path / f"{a}-{b}")
        r = RINGS[a].ShmRegion.create(path, req_size=16384,
                                      resp_size=4096, gen=77)
        try:
            o = RINGS[b].ShmRegion.open(path)
            assert (o.gen, o.ring_size, o.ring_off) == \
                (77, r.ring_size, r.ring_off)
            RINGS[a].RingProducer(r, "req").write(b"hello " + a.encode())
            assert RINGS[b].RingConsumer(o, "req").read(1.0) == \
                b"hello " + a.encode()
            o.close()
        finally:
            r.close(unlink=True)
        assert not os.path.exists(path)


def _wraparound(ring, tmp_path):
    r = ring.ShmRegion.create(str(tmp_path / "wrap"), req_size=4096,
                              resp_size=4096)
    try:
        prod, cons = ring.RingProducer(r, "req"), ring.RingConsumer(r, "req")
        out = []
        for i in range(300):
            msg = bytes([i & 0xFF]) * (1 + (i * 37) % 900)
            prod.write(msg)
            out.append(cons.read(timeout=1.0) == msg)
        out.append(cons.read(timeout=0.01))
        return out
    finally:
        r.close(unlink=True)


def _torn(ring, tmp_path):
    r = ring.ShmRegion.create(str(tmp_path / "torn"), req_size=4096,
                              resp_size=4096)
    try:
        struct.pack_into("<II", r._mm, ring.HDR_SIZE, 100, r.gen)
        r._mm[ring.HDR_SIZE + 8: ring.HDR_SIZE + 58] = b"T" * 50
        cons = ring.RingConsumer(r, "req")
        first = cons.read(timeout=0.05)
        ring.RingProducer(r, "req").write(b"after-torn")
        return [first, cons.read(timeout=1.0)]
    finally:
        r.close(unlink=True)


def _stale(ring, tmp_path):
    r = ring.ShmRegion.create(str(tmp_path / "stale"), req_size=4096,
                              resp_size=4096, gen=7)
    try:
        struct.pack_into("<II", r._mm, ring.HDR_SIZE, 5, 999)
        r._mm[ring.HDR_SIZE + 8: ring.HDR_SIZE + 13] = b"stale"
        struct.pack_into("<Q", r._mm, 64, 16)
        ring.RingConsumer(r, "req").read(timeout=0.5)
    finally:
        r.close(unlink=True)


def _overrun(ring, tmp_path):
    r = ring.ShmRegion.create(str(tmp_path / "over"), req_size=4096,
                              resp_size=4096)
    try:
        struct.pack_into("<Q", r._mm, 64, 4096 + 64)
        ring.RingConsumer(r, "req").read(timeout=0.5)
    finally:
        r.close(unlink=True)


def _oversize(ring, tmp_path):
    r = ring.ShmRegion.create(str(tmp_path / "big"), req_size=4096,
                              resp_size=4096)
    try:
        ring.RingProducer(r, "req").write(b"x" * 3000)
    finally:
        r.close(unlink=True)


def _garbage(ring, tmp_path):
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x00" * 16384)
    ring.ShmRegion.open(str(bad))


def _outcome(fn, ring, tmp_path):
    """(exception class names along the MRO, or the value returned)."""
    try:
        return ("ok", fn(ring, tmp_path))
    except Exception as e:  # noqa: BLE001 - compared below
        return ("raised", [c.__name__ for c in type(e).__mro__])


@pytest.mark.parametrize("case", [_wraparound, _torn, _stale, _overrun,
                                  _oversize, _garbage],
                         ids=lambda f: f.__name__.strip("_"))
def test_ring_faults_same_class_in_both_packages(tmp_path, case):
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    got = _outcome(case, t_ring, tmp_path / "port")
    want = _outcome(case, j_ring, tmp_path / "jax")
    assert got == want
    if case is _wraparound:
        assert got == ("ok", [True] * 300 + [None])
    elif case is _torn:
        assert got == ("ok", [None, b"after-torn"])
    else:
        name = {_stale: "StaleGenerationError", _overrun:
                "MalformedFrameError", _oversize: "FrameTooLargeError",
                _garbage: "ShmFormatError"}[case]
        assert got[0] == "raised" and got[1][0] == name
        assert "ProtocolError" in got[1]


def test_default_dir_takes_an_argument(tmp_path):
    import tempfile

    assert t_ring.default_dir(str(tmp_path)) == str(tmp_path)
    assert t_ring.default_dir() in ("/dev/shm", tempfile.gettempdir())


# ---------------------------------------------------------------------------
# the worker over shm, both chains
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fx():
    rng = random.Random(44)
    rs = tt.generate_rsa_key(rng)
    es = tt.generate_ec_key(rng)
    keys = [t_jwk.serialize_public_key(rs.public_key(), kid="rs-0"),
            t_jwk.serialize_public_key(es.public_key(), kid="es-0")]
    toks = []
    for i in range(4):
        toks.append(tt.sign_jwt(rs, "RS256", tt.default_claims(sub=f"r{i}"),
                                kid="rs-0", rng=rng))
        toks.append(tt.sign_jwt(es, "ES256", tt.default_claims(sub=f"e{i}"),
                                kid="es-0", rng=rng))
    h, p, s = toks[0].split(".")
    toks += [f"{h}.{p}.{s[:-4]}AAAA", "not-a-token", ""]
    return dict(doc={"keys": keys}, toks=toks)


@pytest.fixture(scope="module")
def shm_workers(fx):
    made = {}
    with t_tel.recording():
        yield from _shm_workers(fx, made)


def _shm_workers(fx, made):
    try:
        for chain in CHAINS:
            ks = GPUBatchKeySet(t_jwk.parse_jwks(fx["doc"]), device="cpu")
            made[chain] = t_worker.VerifyWorker(
                ks, serve_native=chain == "native", transport="shm",
                target_batch=64, max_wait_ms=20.0)
            assert made[chain].serve_chain == chain
            assert made[chain].transport == "shm"
        yield made
    finally:
        for w in made.values():
            w.close(deadline_s=TIMEOUT_S)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise ConnectionError("peer closed")
        buf += got
    return bytes(buf)


def _socket_frames(addr, frames):
    """Raw response frames over the socket transport."""
    reader_frames = []
    with socket.create_connection(addr, timeout=TIMEOUT_S) as s:
        for f in frames:
            s.sendall(f)
        for _ in frames:
            hdr = _recv_exact(s, 9)
            _, ftype, count = struct.unpack("<IBI", hdr)
            out = bytearray(hdr)
            if ftype == tp.T_VERIFY_RESP_TRACE:
                n = _recv_exact(s, 1)
                out += n + _recv_exact(s, n[0])
            for _ in range(count):
                head = _recv_exact(s, 5)
                out += head + _recv_exact(s, struct.unpack("<BI", head)[1])
            if ftype >= tp.T_VERIFY_REQ_CRC:
                out += _recv_exact(s, 4)
            reader_frames.append(bytes(out))
    return reader_frames


def _shm_frames(client, frames):
    """Raw response frames over an attached client's rings."""
    assert client.transport == "shm", client.attach_error
    for f in frames:
        client._producer.write(f)
    out = []
    for _ in frames:
        rec = client._consumer.read(timeout=TIMEOUT_S)
        assert rec is not None
        out.append(rec)
    return out


class _Sink:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


def _frame(send, *a, **kw) -> bytes:
    sink = _Sink()
    send(sink, *a, **kw)
    return sink.data


@pytest.mark.parametrize("chain", CHAINS)
def test_shm_frames_equal_the_socket_transports(fx, shm_workers, chain,
                                                tmp_path):
    w = shm_workers[chain]
    t = fx["toks"]
    frames = [_frame(tp.send_request, t[:5]),
              _frame(tp.send_request, t[5:], crc=True),
              _frame(tp.send_request, t[2:4], trace="00112233445566aa"),
              _frame(tp.send_ping),
              _frame(tp.send_request, t)]
    want = _socket_frames(w.address, frames)
    assert [st for st, _ in tp.parse_frame_bytes(want[0])[1]] == [0] * 5
    for mod in (t_shmc, j_shmc):
        with mod.ShmVerifyClient(*w.address, timeout=TIMEOUT_S,
                                 shm_dir=str(tmp_path)) as c:
            assert _shm_frames(c, frames) == want, mod.__name__
            assert c.ping()
            out = c.verify_batch(t[:3])
            assert [r["sub"] for r in out] == ["r0", "e0", "r1"]
            st = c.stats()
            assert st["transport"] == "shm" and st["serve_chain"] == chain
        assert not list(tmp_path.iterdir())        # the region unlinked
    with t_shmc.ShmVerifyClient(*w.address, timeout=TIMEOUT_S, raw=True,
                                shm_dir=str(tmp_path)) as c:
        got = list(c.verify_stream([t[:4], t[4:], t[:1]], depth=2))
        assert [len(g) for g in got] == [4, len(t) - 4, 1]
        assert isinstance(got[0][0], bytes)
        assert type(got[1][-1]).__name__ == "RemoteVerifyError"
    counters = w.stats()["counters"]
    assert counters.get("serve.shm.attaches", 0) >= 3, counters


@pytest.mark.parametrize("chain", CHAINS)
def test_attach_refused_keeps_socket_serving(chain, tmp_path):
    w = t_worker.VerifyWorker(t_main.StubKeySet(),
                              serve_native=chain == "native",
                              max_wait_ms=1.0, transport="socket")
    try:
        for mod in (t_shmc, j_shmc):
            with mod.ShmVerifyClient(*w.address, timeout=TIMEOUT_S,
                                     shm_dir=str(tmp_path)) as c:
                assert c.transport == "socket"
                assert "TypeError" in c.attach_error
                assert c.verify_batch(["fb.ok"])[0] == {"sub": "fb.ok"}
                assert c.ping()
        assert not list(tmp_path.iterdir())
        with t_client.VerifyClient(*w.address, timeout=TIMEOUT_S) as c:
            assert c.stats()["transport"] == "socket"
        if chain == "native":
            assert w._native.counters()["serve.shm_fallbacks"] == 2
    finally:
        w.close(deadline_s=TIMEOUT_S)


def test_stale_worker_drop_redials_socket_only(tmp_path):
    """A worker that drops the attach frame: the client redials and
    serves over the socket."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    accepted = []

    def stale_worker():
        c1, _ = srv.accept()
        accepted.append(1)
        c1.recv(4096)
        c1.close()
        c2, _ = srv.accept()
        accepted.append(2)
        rd = tp.FrameReader(c2)
        ftype, entries = rd.recv_frame()
        tp.send_response(c2, [{"sub": e} for e in entries])
        c2.close()

    th = threading.Thread(target=stale_worker, daemon=True)
    th.start()
    try:
        with t_shmc.ShmVerifyClient(*srv.getsockname(), timeout=TIMEOUT_S,
                                    shm_dir=str(tmp_path)) as c:
            assert c.transport == "socket" and c.attach_error
            assert c.verify_batch(["stale.ok"]) == [{"sub": "stale.ok"}]
    finally:
        srv.close()
    th.join(TIMEOUT_S)
    assert accepted == [1, 2]
    assert not list(tmp_path.iterdir())


_CHAOS_CLIENT = r"""
import sys
sys.path.insert(0, sys.argv[4])
from cap_tpu_torch.serve.shm_client import ShmVerifyClient

host, port, shm_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
cl = ShmVerifyClient(host, port, shm_dir=shm_dir)
assert cl.transport == "shm", cl.attach_error
print("ATTACHED", cl._region.path, flush=True)
i = 0
while True:
    i += 1
    cl.verify_batch([f"chaos-{i}-{j}.ok" for j in range(64)])
"""


@pytest.mark.parametrize("chain", CHAINS)
def test_kill9_shm_client_worker_survives(chain, tmp_path):
    """kill -9 an shm client mid-stream: the worker reclaims its region
    file and a socket client sees every verdict, before and after."""
    with t_tel.recording():
        _kill9(chain, tmp_path)


def _kill9(chain, tmp_path):
    w = t_worker.VerifyWorker(t_main.StubKeySet(),
                              serve_native=chain == "native",
                              max_wait_ms=1.0, transport="shm")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHAOS_CLIENT, *map(str, w.address),
         str(tmp_path), str(REPO)],
        stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("ATTACHED"), line
        ring_path = line.split()[1]
        with t_client.VerifyClient(*w.address, timeout=TIMEOUT_S) as c:
            for i in range(3):
                toks = [f"sv-{i}-{j}.ok" for j in range(16)]
                assert [r["sub"] for r in c.verify_batch(toks)] == toks
            time.sleep(0.2)
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=TIMEOUT_S)
            for i in range(5):
                toks = [f"sv2-{i}-{j}.ok" for j in range(16)]
                assert [r["sub"] for r in c.verify_batch(toks)] == toks
            attaches = c.stats()["counters"].get("serve.shm.attaches", 0)
        assert attaches >= 1
        deadline = time.monotonic() + TIMEOUT_S
        while os.path.exists(ring_path) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not os.path.exists(ring_path), "region not reclaimed"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT_S)
        proc.stdout.close()
        w.close(deadline_s=TIMEOUT_S)


def test_worker_main_native_shm(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cap_tpu_torch.fleet.worker_main",
         "--keyset", "stub", "--device", "cpu", "--serve-chain", "native",
         "--transport", "shm", "--drain-deadline-s", "5"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        ready = lines.get(timeout=60)
        assert ready.startswith("CAP_FLEET_READY port="), ready
        fields = dict(kv.split("=", 1) for kv in ready.split()[1:])
        assert fields["serve_chain"] == "native"
        assert fields["transport"] == "shm"
        with t_shmc.ShmVerifyClient("127.0.0.1", int(fields["port"]),
                                    timeout=TIMEOUT_S,
                                    shm_dir=str(tmp_path)) as c:
            assert c.transport == "shm", c.attach_error
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


@pytest.mark.parametrize("chain", CHAINS)
def test_stale_generation_detaches_only_its_connection(chain, tmp_path):
    """A record stamped by a foreign generation poisons only its own
    connection: counted (serve.shm.stale_gen), detached, and every
    other client keeps its verdicts."""
    with t_tel.recording() as rec:
        w = t_worker.VerifyWorker(t_main.StubKeySet(),
                                  serve_native=chain == "native",
                                  max_wait_ms=1.0, transport="shm")
        try:
            c = t_shmc.ShmVerifyClient(*w.address, timeout=TIMEOUT_S,
                                       shm_dir=str(tmp_path))
            try:
                assert c.verify_batch(["pre.ok"]) == [{"sub": "pre.ok"}]
                region = c._region
                head = region.cursor("req", "head")
                size = region.ring_size["req"]
                off = region.ring_off["req"] + (head & (size - 1))
                struct.pack_into("<II", region._mm, off, 5, region.gen + 1)
                region._mm[off + 8: off + 13] = b"stale"
                region.set_cursor("req", "head", head + 16)

                def stale():
                    if chain == "native":
                        return w._native.counters()["serve.shm.stale_gen"]
                    return rec.counters().get("serve.shm.stale_gen", 0)

                deadline = time.monotonic() + TIMEOUT_S
                while not stale() and time.monotonic() < deadline:
                    time.sleep(0.02)
                assert stale() == 1
            finally:
                c.close()
            with t_client.VerifyClient(*w.address, timeout=TIMEOUT_S) as s:
                assert s.verify_batch(["post.ok"]) == [{"sub": "post.ok"}]
            with t_shmc.ShmVerifyClient(*w.address, timeout=TIMEOUT_S,
                                        shm_dir=str(tmp_path)) as c2:
                assert c2.transport == "shm"
                assert c2.verify_batch(["post2.ok"]) == [{"sub": "post2.ok"}]
        finally:
            w.close(deadline_s=TIMEOUT_S)
