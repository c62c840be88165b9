"""The port's native relay gate against the JAX package's, live.

``NativeFrontDoorServer`` over the port's ``frontdoor`` library (its
own g++ target, ``frontdoor_native.cpp`` byte-identical to the JAX
package's copy) beside the JAX gate over ``libcapruntime.so``:
``probe_route`` equal to the Python ring and to the JAX relay's at
four ring sizes, through a breaker trip and a membership change; every
CVB1 frame family through both gates to the SAME port stub workers,
with equal responses and equal relay counters; pipelined frames in
per-connection order; a malformed frame severing only its own
connection; a dead pool counted as an upstream failure and then pushed
down; the build and layout refusals; ``worker_main``'s gateway on both
chains; and a kill -9 under load through the native gate in front of
two ``WorkerPool``s.

Every socket has a timeout and a SIGALRM watchdog bounds each test."""

import json
import os
import pathlib
import random
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from cap_tpu.fleet import FrontDoor as JFrontDoor
from cap_tpu.fleet import frontdoor as j_fd
from cap_tpu.fleet.frontdoor import NativeFrontDoorServer as JGate
from cap_tpu.serve import native_serve as j_ns

from cap_tpu_torch import _build
from cap_tpu_torch.fleet import ConsistentHashRing, FrontDoor, WorkerPool
from cap_tpu_torch.fleet import frontdoor as t_fd
from cap_tpu_torch.fleet.chaos import kill9
from cap_tpu_torch.fleet.frontdoor import NativeFrontDoorServer
from cap_tpu_torch.fleet.worker_main import StubKeySet
from cap_tpu_torch.serve import native_serve as t_ns
from cap_tpu_torch.serve import protocol as P
from cap_tpu_torch.serve import vcache as t_vc
from cap_tpu_torch.serve.worker import VerifyWorker

from test_torch_fleet import _dead_addr, _wait

REPO = pathlib.Path(__file__).resolve().parent.parent
HARD_TIMEOUT_S = 60
TIMEOUT_S = 10.0


@pytest.fixture(autouse=True)
def _hard_timeout():
    def on_alarm(signum, frame):
        raise TimeoutError(f"relay test exceeded {HARD_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _bare(cls, n_pools, **kw):
    return cls([[("127.0.0.1", 1 + i)] for i in range(n_pools)], **kw)


def _connect(addr):
    s = socket.create_connection(addr, timeout=TIMEOUT_S)
    s.settimeout(TIMEOUT_S)
    return s, P.FrameReader(s)


@pytest.fixture(scope="module")
def stub_workers():
    ws = [VerifyWorker(StubKeySet(), target_batch=64, max_wait_ms=1.0)
          for _ in range(2)]
    yield ws
    for w in ws:
        w.close(5)


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------

def test_relay_library_is_its_own_target(monkeypatch):
    """The relay is the ``frontdoor`` target (the JAX package's copy
    of its source, the prep's SHA-256 beside it), bound with the JAX
    binding's symbols and slots; a failed build raises RuntimeError,
    a missing symbol or a drifted layout ImportError, and the gate
    raises with them."""
    srcs, headers = _build.HOST_TARGETS["frontdoor"]
    assert srcs == ("jose_native.cpp", "frontdoor_native.cpp")
    assert headers == ("cvb1_wire.h",)
    for f in srcs + headers:
        assert (_build.HOST_SRC / f).read_bytes() == (
            REPO / "cap_tpu" / "runtime" / "native" / f).read_bytes(), f
    assert t_ns.load_frontdoor() is _build.load("frontdoor")
    assert t_ns._FD_SYMBOLS == j_ns._FD_SYMBOLS
    for name in dir(j_ns):
        if name.startswith("FDC_") or name == "FD_MAX_POOLS":
            assert getattr(t_ns, name) == getattr(j_ns, name), name
    # the drain's reason codes and the counter slots' names
    assert t_fd._SLOW_REASONS == j_fd._SLOW_REASONS == {
        j_ns.FD_R_CONTROL: "control", j_ns.FD_R_DEAD_POOL: "dead_pool",
        j_ns.FD_R_OVERLOAD: "overload",
        j_ns.FD_R_UPSTREAM_FAIL: "upstream_fail",
        j_ns.FD_R_UNROUTED: "unrouted"}
    assert t_fd._FDC_NAMES == j_fd._FDC_NAMES
    assert len(t_fd._FDC_NAMES) == t_ns.FDC_N

    monkeypatch.setattr(t_ns, "_fd_lib", None)
    monkeypatch.setattr(t_ns, "FDC_N", t_ns.FDC_N + 1)
    with pytest.raises(ImportError, match="drifted"):
        t_ns.load_frontdoor()
    monkeypatch.undo()

    class Stale:
        cap_frontdoor_create = None

    monkeypatch.setattr(t_ns, "_fd_lib", None)
    monkeypatch.setattr(_build, "load", lambda name: Stale())
    with pytest.raises(ImportError, match="cap_frontdoor_drain"):
        t_ns.load_frontdoor()

    def fail(name):
        raise RuntimeError("the build failed for frontdoor")

    monkeypatch.setattr(_build, "load", fail)
    fd = _bare(FrontDoor, 2)
    with pytest.raises(RuntimeError, match="build failed"):
        NativeFrontDoorServer(fd)
    fd.close()
    monkeypatch.undo()
    assert t_ns.load_frontdoor() is _build.load("frontdoor")


# ---------------------------------------------------------------------------
# the routing decision: native == Python ring == the JAX relay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pools,vnodes", [(1, 64), (2, 64), (3, 16),
                                            (5, 64)])
def test_probe_route_equals_ring_and_jax(n_pools, vnodes):
    rng = random.Random(0xF00D + n_pools)
    digests = [rng.randbytes(16) for _ in range(300)]
    digests += [bytes(16), b"\xff" * 16]
    gates = [JGate(_bare(JFrontDoor, n_pools, vnodes=vnodes),
                   refresh_s=999.0),
             NativeFrontDoorServer(_bare(FrontDoor, n_pools,
                                         vnodes=vnodes), refresh_s=999.0)]
    try:
        ring = gates[1].frontdoor._ring
        digests += [p.to_bytes(8, "big") + bytes(8)
                    for p in ring._points[:8]]
        digests += [(p - 1).to_bytes(8, "big") + bytes(8)
                    for p in ring._points[:8]]
        want = [ring.primary(d) for d in digests]
        for g in gates:
            assert g.probe_route(digests) == want
        # a breaker trip: the dead owner's tokens take the slow path
        # (-1), every other decision unchanged
        dead = n_pools - 1
        for g in gates:
            g._lib.cap_frontdoor_set_live(g._h, dead, 0)
            assert g.probe_route(digests) == [
                -1 if w == dead else w for w in want]
            g._lib.cap_frontdoor_set_live(g._h, dead, 1)
            assert g.probe_route(digests) == want
        assert gates[1].probe_route([]) == []
    finally:
        for g in gates:
            g.close(deadline_s=5.0)


def test_probe_route_membership_change():
    """A grown ring pushed down: the relay follows the new ring, and
    only the new pool's segments moved."""
    rng = random.Random(29)
    digests = [rng.randbytes(16) for _ in range(300)]
    routes = []
    for n in (2, 3):
        gate = NativeFrontDoorServer(_bare(FrontDoor, n), refresh_s=999.0)
        try:
            routes.append(gate.probe_route(digests))
            assert routes[-1] == [ConsistentHashRing(range(n)).primary(d)
                                  for d in digests]
        finally:
            gate.close(deadline_s=5.0)
    moved = [(b, a) for b, a in zip(*routes) if b != a]
    assert moved and all(a == 2 for _, a in moved)


# ---------------------------------------------------------------------------
# the relay end to end
# ---------------------------------------------------------------------------

def _drive(gate, epoch):
    """Every frame family, one at a time, on one connection: verify
    (plain, checksummed, traced; one owner and two), ping, STATS, KEYS,
    peer fill, shm attach, verify again. Returns the responses."""
    s, r = _connect(gate.address)
    out = []
    toks = [f"relay-{i}.ok" for i in range(24)] + ["relay-bad"]
    one = [t for t in toks
           if ConsistentHashRing([0, 1]).primary(t_vc.token_digest(t))
           == 0][:3]
    try:
        for batch, crc, trace in ((toks, False, None), (toks, True, None),
                                  (toks, False, "ab12cd34"),
                                  (one, False, None), (one, True, None)):
            P.send_request(s, batch, crc=crc, trace=trace)
            out.append(r.recv_frame_ex())
        P.send_ping(s)
        out.append(r.recv_frame())
        P.send_stats_request(s)
        ftype, entries = r.recv_frame()
        doc = json.loads(entries[0][1])
        out.append((ftype, doc["frontdoor_chain"],
                    doc["frontdoor"]["routing"]))
        P.send_keys_push(s, {"keys": []}, epoch=epoch)
        ftype, entries = r.recv_frame()
        out.append((ftype, entries[0][0],
                    json.loads(entries[0][1])["epoch"] - epoch))
        P.send_peer_fill(s, {"op": "export", "max_entries": 10})
        out.append(r.recv_frame())
        P.send_shm_attach(s, "/bogus/ring")
        out.append(r.recv_frame())
        P.send_request(s, ["after-control.ok"])
        out.append(r.recv_frame())
    finally:
        s.close()
    return out


def test_relay_e2e_equals_jax(stub_workers):
    """Both gates over the same two workers: equal responses frame by
    frame and equal relay counters; the lookups fold exactly
    (``frontdoor.lookups == affinity_hits + affinity_misses``, the
    native lookups all hits); the KEYS push fans out to both workers;
    the workers' tokens equal what the ring gave each."""
    w0, w1 = stub_workers
    runs = []
    for k, (fd_cls, gate_cls) in enumerate(((JFrontDoor, JGate),
                                            (FrontDoor,
                                             NativeFrontDoorServer))):
        gate = gate_cls(fd_cls([[w0.address], [w1.address]]),
                        refresh_s=0.05)
        try:
            epoch = 5 + k
            out = _drive(gate, epoch)
            assert w0.key_epoch == epoch and w1.key_epoch == epoch
            nc = gate.native_counters()
            nc.pop("frontdoor.native.conns_closed")   # races the close
            c = gate.stats()["counters"]
            runs.append((out, nc))
        finally:
            gate.close(deadline_s=5.0)
    assert runs[1] == runs[0]
    out, nc = runs[1]
    assert [e[0] for e in out[0][1]] == [0] * 24 + [1]
    assert [json.loads(p) for _, p in out[0][1][:24]] == [
        {"sub": f"relay-{i}.ok"} for i in range(24)]
    assert [f[0] for f in out[:3]] == [P.T_VERIFY_RESP,
                                       P.T_VERIFY_RESP_CRC,
                                       P.T_VERIFY_RESP_TRACE]
    assert out[2][2] == "ab12cd34"
    assert out[6] == (P.T_STATS_RESP, "native", "affinity")
    assert out[7] == (P.T_KEYS_ACK, 0, 0)
    assert out[8][0] == P.T_PEER_ACK and out[8][1][0][0] == 1
    assert out[9][0] == P.T_SHM_ACK and out[9][1][0][0] == 1
    assert out[10][0] == P.T_VERIFY_RESP and out[10][1][0][0] == 0
    n_tok = 3 * 25 + 2 * 3 + 1
    assert nc["frontdoor.native.lookups"] == nc[
        "frontdoor.native.hits"] == nc[
        "frontdoor.native.relay_tokens"] == n_tok
    # one owner, plain: spliced whole; else one relay a owner
    assert nc["frontdoor.native.splices"] == 2
    assert nc["frontdoor.native.relays"] == 3 * 2 + 1
    assert nc["frontdoor.native.slow_frames"] == 4      # the controls
    assert nc["frontdoor.native.pongs"] == 1
    assert nc["frontdoor.native.frames"] == 11
    for k in ("proto_errors", "upstream_fails", "dropped_posts"):
        assert nc[f"frontdoor.native.{k}"] == 0, k
    assert c["frontdoor.lookups"] == n_tok == (
        c["frontdoor.affinity_hits"] + c["frontdoor.affinity_misses"])
    assert c["frontdoor.native.slow.control"] == 4


def test_pipelined_frames_keep_their_order(stub_workers):
    """40 single-token frames sent before any answer is read: answered
    in submission order though the two pools answer at their own pace,
    each token relayed or slow-pathed exactly once."""
    w0, w1 = stub_workers
    gate = NativeFrontDoorServer(FrontDoor([[w0.address], [w1.address]]),
                                 refresh_s=0.05)
    try:
        s, r = _connect(gate.address)
        toks = [f"seq-{i}.a.ok" for i in range(40)]
        for t in toks:
            P.send_request(s, [t])
        for t in toks:
            ftype, entries = r.recv_frame()
            assert ftype == P.T_VERIFY_RESP
            assert json.loads(entries[0][1]) == {"sub": t}, \
                "responses out of submission order"
        s.close()
        nc = gate.native_counters()
        assert nc["frontdoor.native.splices"] >= 20
        assert nc["frontdoor.native.relay_tokens"] + nc[
            "frontdoor.native.slow_tokens"] == 40
    finally:
        gate.close(deadline_s=5.0)


def test_malformed_frame_severs_only_its_connection(stub_workers):
    w0, w1 = stub_workers
    gate = NativeFrontDoorServer(FrontDoor([[w0.address], [w1.address]]))
    try:
        a, ra = _connect(gate.address)
        P.send_request(a, ["before.ok"])
        assert ra.recv_frame()[1][0][0] == 0
        b, _ = _connect(gate.address)
        b.sendall(b"\x00" * 64)                  # bad magic
        assert b.recv(1) == b"", "the reader must sever on bad magic"
        b.close()
        for s, r in ((a, ra), _connect(gate.address)):
            P.send_request(s, ["survivor.ok", "survivor.bad"])
            ftype, entries = r.recv_frame()
            assert ftype == P.T_VERIFY_RESP
            assert [e[0] for e in entries] == [0, 1]
            s.close()
        assert gate.native_counters()[
            "frontdoor.native.proto_errors"] == 1
    finally:
        gate.close(deadline_s=5.0)


def test_dead_pool_upstream_fail_then_pushed_down(stub_workers):
    """A pool whose endpoint is dead from the start: the first relay
    there fails upstream and the whole frame takes the Python slow
    path (which opens the breaker); the refresh pushes live=0 down and
    later frames slow-path as dead-pool at the edge. No verdict lost
    or wrong."""
    w0, w1 = stub_workers
    fd = FrontDoor([[w0.address], [w1.address], [_dead_addr()]],
                   fallback=StubKeySet(),
                   client_kw={"attempt_timeout": 1.0, "total_deadline": 5.0,
                              "max_rounds": 1, "breaker_threshold": 1,
                              "breaker_reset_s": 60.0})
    gate = NativeFrontDoorServer(fd, refresh_s=0.05)
    try:
        s, r = _connect(gate.address)
        toks = [f"death-{i}.ok" for i in range(48)]
        for rep in range(6):
            P.send_request(s, toks)
            ftype, entries = r.recv_frame()
            assert ftype == P.T_VERIFY_RESP and len(entries) == 48
            assert [e[0] for e in entries] == [0] * 48, rep
            time.sleep(0.12)           # the breaker → set_live refresh
        s.close()
        c = gate.stats()["counters"]
        # a frame re-dispatched after an upstream failure is looked up
        # again on the slow path: both lookups counted, both exact
        assert c["frontdoor.lookups"] >= 6 * 48
        assert c["frontdoor.lookups"] == (
            c["frontdoor.affinity_hits"] + c["frontdoor.affinity_misses"])
        assert c["frontdoor.native.upstream_fails"] > 0
        assert c["frontdoor.native.slow.upstream_fail"] > 0
        assert c["frontdoor.native.slow.dead_pool"] > 0
        assert c["frontdoor.reroutes"] > 0
    finally:
        gate.close(deadline_s=5.0)


def test_gate_refuses_rr_and_too_many_pools():
    """The same refusals, in the same words, as the JAX gate."""
    for kw, n in (({"routing": "rr"}, 2), ({}, t_ns.FD_MAX_POOLS + 1)):
        errs = []
        for fd_cls, gate_cls in ((JFrontDoor, JGate),
                                 (FrontDoor, NativeFrontDoorServer)):
            fd = _bare(fd_cls, n, **kw)
            with pytest.raises(ValueError) as e:
                gate_cls(fd)
            errs.append(str(e.value))
            fd.close()
        assert errs[1] == errs[0]


# ---------------------------------------------------------------------------
# the deployable gateway
# ---------------------------------------------------------------------------

def _gateway_proc(pool_port, *args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "cap_tpu_torch.fleet.worker_main",
         "--keyset", f"frontdoor:pool=127.0.0.1:{pool_port}",
         "--obs-port", "-1", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(REPO))


def test_worker_main_gateway_on_both_chains(stub_workers):
    """``--frontdoor-chain`` picks the chain (native by default), the
    ready line reports it, both serve the same verdicts, and
    ``CAP_FRONTDOOR_NATIVE=0`` changes nothing; there is no ``auto``."""
    port = stub_workers[0].address[1]
    procs = [_gateway_proc(port, env_extra={"CAP_FRONTDOOR_NATIVE": "0"}),
             _gateway_proc(port, "--frontdoor-chain", "python"),
             _gateway_proc(port, "--frontdoor-chain", "auto")]
    try:
        assert procs[2].wait(timeout=TIMEOUT_S) == 2
        assert "invalid choice: 'auto'" in procs[2].stderr.read()
        for p, chain in zip(procs, ("native", "python")):
            line = p.stdout.readline().strip()
            assert line.startswith("CAP_FLEET_READY"), (
                line, p.stderr.read() if p.poll() is not None else "")
            kv = dict(f.split("=", 1) for f in line.split()[1:])
            assert kv["frontdoor_chain"] == chain, kv
            s, r = _connect(("127.0.0.1", int(kv["port"])))
            P.send_request(s, ["gate.ok", "gate.bad"])
            ftype, entries = r.recv_frame()
            assert [e[0] for e in entries] == [0, 1]
            s.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=TIMEOUT_S))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rcs.append("hung")
            p.stdout.close()
            p.stderr.close()
    assert rcs == [0, 0, 2], "SIGTERM drains a gateway and exits 0"


# ---------------------------------------------------------------------------
# kill -9 under load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain", ["native"])
def test_kill9_under_load_reroutes(chain):
    """Two one-worker pools behind the native gate; a stream of
    requests; kill -9 of pool 1's worker in the middle. Every verdict
    right, pool 1's tokens re-routed, none lost; after the respawn the
    ring's owner serves its tokens again, and a KEYS push through the
    gate converges both pools (epoch skew 0)."""
    pools = [WorkerPool(1, keyset_spec="stub:batch_ms=5", platform="cpu",
                        ping_interval=0.1, max_restarts=5,
                        max_wait_ms=1.0, drain_grace=5.0)
             for _ in range(2)]
    gate = None
    try:
        for p in pools:
            assert p.wait_all_ready(30.0)
        fd = FrontDoor(pools, client_kw={"attempt_timeout": 2.0,
                                         "total_deadline": 20.0})
        gate = NativeFrontDoorServer(fd, refresh_s=0.05)
        ring = fd._ring
        toks = [f"k9-{i}.ok" for i in range(30)] + ["k9-bad"]
        owners = [ring.primary(t_vc.token_digest(t)) for t in toks]
        assert set(owners) == {0, 1}
        s, r = _connect(gate.address)
        done, errs = [], []

        def stream():
            try:
                for _ in range(40):
                    P.send_request(s, toks)
                    ftype, entries = r.recv_frame()
                    done.append([e[0] for e in entries])
            except Exception as e:  # noqa: BLE001 - raised below
                errs.append(e)

        th = threading.Thread(target=stream, daemon=True)
        th.start()
        assert _wait(lambda: len(done) >= 3, TIMEOUT_S)
        victim = pools[1].pid(0)
        kill9(victim)
        th.join(30.0)
        assert not th.is_alive() and not errs, errs
        assert done == [[0] * 30 + [1]] * 40, "a wrong or lost verdict"
        c = gate.stats()["counters"]
        assert c["frontdoor.reroutes"] > 0
        assert c.get("frontdoor.native.slow.upstream_fail", 0) + c.get(
            "frontdoor.native.slow.dead_pool", 0) > 0
        assert c["frontdoor.lookups"] >= 40 * 31
        assert c["frontdoor.lookups"] == (
            c["frontdoor.affinity_hits"] + c["frontdoor.affinity_misses"])

        assert _wait(lambda: pools[1].state(0) == "ready"
                     and pools[1].pid(0) != victim, 30.0)
        assert _wait(lambda: gate.probe_route(
            [t_vc.token_digest(t) for t in toks]) == owners, TIMEOUT_S)
        before = pools[1].stats()[0]["counters"].get("worker.tokens", 0)
        P.send_request(s, toks)
        assert [e[0] for e in r.recv_frame()[1]] == [0] * 30 + [1]
        assert pools[1].stats()[0]["counters"]["worker.tokens"] - \
            before == owners.count(1)
        P.send_keys_push(s, {"keys": []}, epoch=7)
        ftype, entries = r.recv_frame()
        assert ftype == P.T_KEYS_ACK and entries[0][0] == 0
        assert fd.key_epochs() == {"p0.w0": 7, "p1.w0": 7}
        assert fd.epoch_skew() == 0
        s.close()
    finally:
        if gate is not None:
            gate.close(deadline_s=5.0)
        for p in pools:
            p.close()
