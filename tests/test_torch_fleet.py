"""The port's fleet: placement, the worker pool, the failover router,
fault injection, postmortems and the autoscaler.

Pools here are ``python -m cap_tpu_torch.fleet.worker_main`` processes
over the stub keyset (tokens ending ``.ok`` verify; no torch import in
the children), so a worker boots in about a second. Ground truth is the
stub rule, the same in every worker and in the JAX package, so a
verdict is comparable wherever it was produced: zero wrong verdicts and
zero lost submissions under kill -9, stalls, black holes and corrupt
frames. The autoscaler's decisions equal the JAX autoscaler's on the
same scripted merged snapshots, and the JAX ``FleetClient`` against a
port pool sends and receives the same frames as the port's.

Every pool is closed with a deadline, every socket has a timeout, and
a SIGALRM watchdog gives each test a hard deadline."""

import json
import signal
import socket
import threading
import time

import numpy as np
import pytest

from cap_tpu import telemetry as j_tel
from cap_tpu.fleet import FleetClient as JFleetClient
from cap_tpu.fleet.autoscale import PoolAutoscaler as JPoolAutoscaler
from cap_tpu.obs import decision as j_dec
from cap_tpu.parallel import place as j_place

from cap_tpu_torch import telemetry
from cap_tpu_torch.fleet import (
    FleetClient,
    FleetError,
    FleetExhaustedError,
    PoolAutoscaler,
    WorkerPool,
)
from cap_tpu_torch.fleet.chaos import ChaosProxy, kill9
from cap_tpu_torch.fleet.worker_main import StubKeySet, make_keyset
from cap_tpu_torch.obs import postmortem as t_pm
from cap_tpu_torch.obs import slo
from cap_tpu_torch.parallel import (
    PlacementError,
    WorkerPlacement,
    assert_single_owner,
    single_owner_placement,
)
from cap_tpu_torch.serve.client import VerifyClient

HARD_TIMEOUT_S = 50
WAIT_S = 30.0


@pytest.fixture(autouse=True)
def _hard_timeout():
    def on_alarm(signum, frame):
        raise TimeoutError(f"fleet test exceeded {HARD_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _assert_verdicts(tokens, results):
    """Zero lost: one verdict per token. Zero wrong: accept/reject as
    the stub rule says; accepted claims carry the token."""
    assert len(results) == len(tokens), "lost submissions"
    for t, r in zip(tokens, results):
        if t.endswith(".ok"):
            assert r == {"sub": t}, f"WRONG verdict for {t!r}: {r!r}"
        else:
            assert isinstance(r, Exception), f"WRONG verdict for {t!r}"


def _wait(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _jwks(*kids):
    return {"keys": [{"kty": "RSA", "kid": k, "n": "AQAB", "e": "AQAB"}
                     for k in kids]}


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_single_owner_placement_env_and_args():
    ps = single_owner_placement(4, 8)
    assert [p.device_ids for p in ps] == [(0, 1), (2, 3), (4, 5), (6, 7)]
    assert ps[1].platform == "cuda"
    assert ps[1].env() == {"CUDA_VISIBLE_DEVICES": "2,3"}
    assert ps[1].args() == ["--device", "cuda"]
    cpu = single_owner_placement(2, 2, platform="cpu")[1]
    assert cpu.env() == {"CUDA_VISIBLE_DEVICES": ""}
    assert cpu.args() == ["--device", "cpu"]
    with pytest.raises(PlacementError, match="unknown platform"):
        WorkerPlacement(0, (0,), "tpu")


@pytest.mark.parametrize("args", [(3, 4, 2), (5, 4, None), (0, 4, None)])
def test_placement_overcommit_equals_jax(args):
    n, d, per = args
    with pytest.raises(j_place.PlacementError) as je:
        j_place.single_owner_placement(n, d, devices_per_worker=per)
    with pytest.raises(PlacementError) as te:
        single_owner_placement(n, d, devices_per_worker=per)
    assert str(te.value) == str(je.value)


def test_assert_single_owner():
    for platform in ("cuda", "cpu"):
        ps = [WorkerPlacement(0, (0, 1), platform),
              WorkerPlacement(1, (1, 2), platform)]
        with pytest.raises(PlacementError,
                           match="device 1 owned by both worker 0 and "
                                 "worker 1"):
            assert_single_owner(ps)
    # a CPU worker owns no card: one card worker beside it is fine
    assert_single_owner([WorkerPlacement(0, (0,), "cuda"),
                         WorkerPlacement(1, (0,), "cpu")])
    with pytest.raises(FleetError, match="placements"):
        WorkerPool(2, placements=[WorkerPlacement(0, (0,), "cpu")])
    with pytest.raises(PlacementError, match="owned by both"):
        WorkerPool(2, placements=[WorkerPlacement(0, (0,), "cuda"),
                                  WorkerPlacement(1, (0,), "cuda")])


def test_make_keyset_specs():
    ks = make_keyset("stub:batch_ms=1.5,token_us=2")
    assert isinstance(ks, StubKeySet)
    with pytest.raises(ValueError, match="unknown stub option"):
        make_keyset("stub:bogus=1")
    with pytest.raises(ValueError, match="unknown keyset spec"):
        make_keyset("nope")


# ---------------------------------------------------------------------------
# a pool of stub workers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    p = WorkerPool(2, keyset_spec="stub:batch_ms=20", platform="cpu",
                   ping_interval=0.2, max_restarts=20, max_wait_ms=1.0,
                   postmortem_interval=0.2, drain_grace=5.0)
    try:
        assert p.wait_all_ready(WAIT_S), "fleet did not come up"
        yield p
    finally:
        p.close()
    assert all(h.proc.poll() is not None for h in p._handles)


def _ready(pool):
    assert pool.wait_all_ready(WAIT_S)
    return pool


def test_pool_spawns_with_disjoint_placement(pool):
    _ready(pool)
    assert pool.placement_map() == {0: (0,), 1: (1,)}
    eps = pool.endpoints()
    assert len(eps) == 2 and eps[0] != eps[1]
    assert pool.pid(0) != pool.pid(1)
    assert set(pool.obs_endpoints()) == {0, 1}
    assert set(pool.serve_chains().values()) == {"python"}
    assert set(pool.transports().values()) == {"socket"}


def test_router_balance_and_stats(pool):
    _ready(pool)
    before = {w: s["counters"].get("worker.requests", 0)
              for w, s in pool.stats().items()}
    cl = FleetClient(pool, rr_seed=0)
    with telemetry.recording() as rec:
        for i in range(8):
            toks = [f"t{i}.ok", f"t{i}-bad", f"u{i}.ok"]
            _assert_verdicts(toks, cl.verify_batch(toks))
        assert rec.counters()["decision.router.accept"] == 16
        assert rec.counters()["decision.router.reject.bad_signature"] == 8
    after = {w: s["counters"].get("worker.requests", 0)
             for w, s in pool.stats().items()}
    assert {w: after[w] - before[w] for w in after} == {0: 4, 1: 4}
    agg = pool.stats_merged()["aggregate"]
    assert agg["pool_size"] == 2 and agg["epoch_skew"] == 0
    results = slo.evaluate_once(agg["snapshot"], slo.default_rules())
    assert not slo.any_breach(results), slo.format_results(results)


def test_router_concurrent_batches(pool):
    _ready(pool)
    cl = FleetClient(pool)
    results = {}

    def one(i):
        results[i] = cl.verify_batch([f"c{i}-{j}.ok" for j in range(4)])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    for i in range(8):
        _assert_verdicts([f"c{i}-{j}.ok" for j in range(4)], results[i])


def _dead_addr():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()                          # nothing listens here now
    return addr


def test_router_dead_endpoint_opens_breaker(pool):
    _ready(pool)
    dead = _dead_addr()
    cl = FleetClient([dead] + list(pool.endpoints().values()),
                     attempt_timeout=1.0, breaker_threshold=1,
                     breaker_reset_s=30.0, rr_seed=0)
    with telemetry.recording() as rec:
        for i in range(4):
            _assert_verdicts([f"d{i}.ok"], cl.verify_batch([f"d{i}.ok"]))
    assert rec.counters()["fleet.failovers"] == 1
    assert rec.counters()["fleet.breaker_opens"] == 1
    assert cl.breaker_states()[dead]["open_for_s"] > 0


def test_router_exhausted_without_fallback_raises():
    cl = FleetClient([_dead_addr()], attempt_timeout=0.5,
                     total_deadline=2.0, max_rounds=2)
    with telemetry.recording() as rec:
        with pytest.raises(FleetExhaustedError):
            cl.verify_batch(["x.ok"])
        assert "fleet.fallback_tokens" not in rec.counters()
        # only a fallback the caller passes verifies on the host
        cl = FleetClient([_dead_addr()], fallback=StubKeySet(),
                         attempt_timeout=0.5, total_deadline=2.0,
                         max_rounds=2)
        _assert_verdicts(["y.ok", "y.no"], cl.verify_batch(["y.ok", "y.no"]))
        assert rec.counters()["fleet.fallback_tokens"] == 2
        assert rec.counters()["fleet.fallback_batches"] == 1
    assert FleetClient([("127.0.0.1", 1)]).verify_batch([]) == []


def test_stall_hedges_to_healthy_peer(pool):
    _ready(pool)
    with ChaosProxy(lambda: pool.address(0)) as p0, \
            ChaosProxy(lambda: pool.address(1)) as p1:
        cl = FleetClient(lambda: [p0.address, p1.address],
                         attempt_timeout=3.0, hedge_after=0.2,
                         breaker_reset_s=0.5, rr_seed=0)
        _assert_verdicts(["warm.ok"], cl.verify_batch(["warm.ok"]))
        p0.stall()
        cl = FleetClient(lambda: [p0.address, p1.address],
                         attempt_timeout=3.0, hedge_after=0.2,
                         breaker_reset_s=0.5, rr_seed=0)
        toks = [f"s{i}.ok" for i in range(4)] + ["s-bad"]
        with telemetry.recording() as rec:
            t0 = time.monotonic()
            _assert_verdicts(toks, cl.verify_batch(toks))
            assert time.monotonic() - t0 < 3.0
        assert rec.counters()["fleet.hedges"] == 1
        assert rec.counters()["fleet.hedge_wins"] == 1


@pytest.mark.parametrize("fault", ["stall", "blackhole", "corrupt_s2c",
                                   "corrupt_c2s", "delay"])
def test_chaos_faults_never_a_wrong_verdict(pool, fault):
    _ready(pool)
    with ChaosProxy(lambda: pool.address(0)) as p0, \
            ChaosProxy(lambda: pool.address(1)) as p1:
        cl = FleetClient(lambda: [p0.address, p1.address],
                         attempt_timeout=1.0, total_deadline=20.0,
                         breaker_reset_s=0.3, rr_seed=0)
        _assert_verdicts(["warm.ok"], cl.verify_batch(["warm.ok"]))
        if fault == "stall":
            p0.stall()
        elif fault == "blackhole":
            p0.blackhole()
        elif fault == "delay":
            p0.delay_accept(0.3)
            p1.delay_accept(0.3)
        with telemetry.recording() as rec:
            # each c2s corruption, stall or black hole costs an attempt
            # timeout (the proxy's close does not wake its other pump)
            offsets = ([0, 4, 9, 14, 20] if fault in ("corrupt_s2c",
                                                      "delay") else [0, 1])
            for i, off in enumerate(offsets):
                if fault.startswith("corrupt"):
                    # c2s: a byte of the first token (the frame's CRC
                    # refuses it); s2c: magic, type, status, length,
                    # payload
                    for p in (p0, p1):
                        p.corrupt(direction=fault[-3:], offset=14 + i
                                  if fault == "corrupt_c2s" else off,
                                  xor=0x01)
                toks = [f"x{i}.ok", f"x{i}-bad", f"y{i}.ok"]
                _assert_verdicts(toks, cl.verify_batch(toks))
            c = rec.counters()
        if fault != "delay":
            assert c.get("fleet.failovers", 0) >= 1, c
        p0.clear()
        p1.clear()
        _assert_verdicts(["after.ok"], cl.verify_batch(["after.ok"]))


def test_kill9_failover_respawn_and_postmortem(pool):
    """kill -9 lands mid-batch: every verdict right, the pool respawns
    the slot, collects its postmortem (flight ring and counters, no
    token segment), and the new process rejoins routing."""
    _ready(pool)
    cl = FleetClient(pool, attempt_timeout=2.0, total_deadline=WAIT_S,
                     rr_seed=0)
    toks = [f"eyJhbGciOiJSUzI1NiJ9.eyJzdWIiOiJwbTk{i}In0.c2lnOTk{i}.ok"
            for i in range(4)] + ["eyJhbGciOiJub25lIn0.eyJ4IjoxfQ.bad"]
    with telemetry.recording():
        for i in range(4):
            with telemetry.trace():
                _assert_verdicts(toks, cl.verify_batch(toks))
    victim, path = pool.pid(0), pool.postmortem_path(0)
    # a checkpoint after the traced traffic
    assert _wait(lambda: (t_pm.read_postmortem(path) or {}).get("flight"),
                 10)
    batches = [[f"k{i}-{j}.ok" for j in range(4)] + [f"k{i}-bad"]
               for i in range(8)]
    results = {}

    def submit(i):
        results[i] = cl.verify_batch(batches[i])

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(batches))]
    for t in threads:
        t.start()
    time.sleep(0.01)
    kill9(victim)
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), "submission thread wedged"
    for i, b in enumerate(batches):
        _assert_verdicts(b, results[i])
    assert _wait(lambda: pool.state(0) == "ready"
                 and pool.pid(0) != victim)
    doc = pool.postmortem(0)
    assert doc["pid"] == victim
    counters = doc["snapshot"]["counters"]
    assert counters["worker.requests"] >= 2
    assert counters["decision.serve.accept"] >= 1
    assert doc["flight"], "final flight ring missing"
    raw = open(path).read() + json.dumps(doc)
    for tok in toks:
        for seg in tok.split("."):
            if len(seg) >= 8:
                assert seg not in raw
    assert "decisions[serve]" in t_pm.render_postmortem(doc)
    _assert_verdicts(["post.ok"], cl.verify_batch(["post.ok"]))


def test_sigterm_drain_writes_fresh_postmortem(pool):
    _ready(pool)
    victim = pool.pid(1)
    with VerifyClient(*pool.address(1), timeout=10.0) as direct:
        _assert_verdicts(["drain-a.ok", "drain-b.bad"],
                         direct.verify_batch(["drain-a.ok",
                                              "drain-b.bad"]))
    pool.restart(1, graceful=True)
    doc = pool.postmortem(1)
    assert doc["pid"] == victim and doc["reason"] == "sigterm-drain"
    assert time.time() - doc["t_write"] < WAIT_S
    assert doc["snapshot"]["counters"]["decision.serve.accept"] >= 1
    assert _ready(pool).pid(1) != victim


def test_push_keys_converge_and_repush_after_kill(pool):
    _ready(pool)
    e0 = (pool.keys_epoch() or 0) + 1
    assert pool.push_keys(_jwks("k-1"), epoch=e0) == {0: e0, 1: e0}
    assert pool.key_epochs() == {0: e0, 1: e0} and pool.epoch_skew() == 0
    assert {s["key_epoch"] for s in pool.stats().values()} == {e0}
    # a worker killed before the next push misses it; the respawn path
    # re-pushes the pool's current keys until it converges
    victim = pool.pid(1)
    kill9(victim)
    acks = pool.push_keys(_jwks("k-2"))
    assert acks[0] == e0 + 1
    assert _wait(lambda: pool.pid(1) != victim
                 and pool.key_epochs() == {0: e0 + 1, 1: e0 + 1})
    assert pool.epoch_skew() == 0
    assert _wait(lambda: {s and s["key_epoch"] for s in
                          pool.stats().values()} == {e0 + 1})
    cl = FleetClient(pool)
    _assert_verdicts(["r.ok", "r.bad"], cl.verify_batch(["r.ok", "r.bad"]))


# ---------------------------------------------------------------------------
# wire interop: the JAX FleetClient against the port's pool
# ---------------------------------------------------------------------------

class _Tap:
    """A one-upstream TCP forwarder that records the bytes each way."""

    def __init__(self, upstream):
        self.upstream = upstream
        self.c2s, self.s2c = bytearray(), bytearray()
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.address = self.sock.getsockname()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            u = socket.create_connection(self.upstream, timeout=10.0)
            c.settimeout(10.0)
            for src, dst, buf in ((c, u, self.c2s), (u, c, self.s2c)):
                threading.Thread(target=self._pump, args=(src, dst, buf),
                                 daemon=True).start()

    @staticmethod
    def _pump(src, dst, buf):
        try:
            while True:
                chunk = src.recv(65536)
                if not chunk:
                    break
                buf += chunk
                dst.sendall(chunk)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass

    def close(self):
        self.sock.close()


def test_jax_fleet_client_against_port_pool(pool):
    _ready(pool)
    toks = [f"w{i}.ok" for i in range(5)] + ["w-bad", "", "x.y.z"]
    j_got = JFleetClient(pool, rr_seed=0).verify_batch(toks)
    t_got = FleetClient(pool, rr_seed=0).verify_batch(toks)
    norm = lambda rs: [(type(r).__name__, str(r))  # noqa: E731
                       if isinstance(r, Exception) else r for r in rs]
    assert norm(t_got) == norm(j_got)
    _assert_verdicts(toks, t_got)
    taps = []
    for cls in (JFleetClient, FleetClient):
        tap = _Tap(pool.address(0))
        try:
            cls([tap.address], rr_seed=0).verify_batch(toks)
            assert _wait(lambda: len(tap.s2c) > 0, 10)
        finally:
            tap.close()
        taps.append((bytes(tap.c2s), bytes(tap.s2c)))
    assert taps[1] == taps[0]
    assert taps[0][0][4] == 7          # the checksummed request frame


# ---------------------------------------------------------------------------
# the autoscaler: decisions against the JAX one, and one live resize
# ---------------------------------------------------------------------------

class _FakePool:
    def __init__(self, n):
        self.n, self.calls = n, []

    def size(self):
        return self.n

    def resize(self, n, reason=""):
        self.calls.append(("resize", n, reason))
        self.n = n

    def shed_tenant(self, t, s, reason=""):
        self.calls.append(("shed", t, s, reason))

    def stats_merged(self):
        raise AssertionError("tick() is given merged explicitly")


def _merged_script(seed, n=40):
    rng = np.random.default_rng(seed)
    flood = j_dec.issuer_hash("https://flood.example")
    quiet = j_dec.issuer_hash("https://quiet.example")
    counters = {}
    out = []
    for _ in range(n):
        for t, rej in ((flood, rng.random() < 0.7),
                       (quiet, rng.random() < 0.1)):
            k = int(rng.integers(0, 50))
            counters[f"decision.serve.tenant.{t}.tokens"] = \
                counters.get(f"decision.serve.tenant.{t}.tokens", 0) + k
            if rej:
                key = f"decision.serve.tenant.{t}.reject"
                counters[key] = counters.get(key, 0) + k
        queued = int(rng.choice([0, 0, 50, 5000]))
        ring = int(rng.choice([0, 300]))
        out.append({"aggregate": {"queued_tokens": queued,
                                  "counters": dict(counters),
                                  "snapshot": {"counters": dict(counters)}},
                    "workers": {0: {"ring_depth": ring}, 1: None}})
    return out


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_autoscaler_decisions_equal_jax(seed):
    script = _merged_script(seed)
    runs = []
    for cls, tel in ((JPoolAutoscaler, j_tel), (PoolAutoscaler, telemetry)):
        fake = _FakePool(1)
        sc = cls(fake, min_workers=1, max_workers=3,
                 high_queue_per_worker=200, sustain_ticks=2,
                 quiet_ticks=3, interval_s=1.0, shed_scale=0.25,
                 tenant_weights={"abc": 3})
        with tel.recording() as rec:
            acts = [sc.tick(now=float(i) * 0.7, merged=m)
                    for i, m in enumerate(script)]
            gauges = rec.gauges()
        runs.append((acts, fake.calls, dict(sc.shed_state), gauges))
    assert runs[1] == runs[0]
    assert any(a is not None for a in runs[1][0])


def test_pool_live_resize():
    with WorkerPool(1, keyset_spec="stub", platform="cpu",
                    ping_interval=0.3, drain_grace=5.0) as p:
        assert p.wait_all_ready(WAIT_S)
        with telemetry.recording() as rec:
            assert p.resize(2, reason="test") == 2
            assert p.wait_all_ready(WAIT_S)
            assert p.size() == 2 and sorted(p.endpoints()) == [0, 1]
            assert p.placement_map() == {0: (0,), 1: (1,)}
            cl = FleetClient(p, rr_seed=0)
            for i in range(4):
                _assert_verdicts([f"z{i}.ok"], cl.verify_batch([f"z{i}.ok"]))
            assert p.resize(1, reason="test") == 1
            assert p.size() == 1 and sorted(p.endpoints()) == [0]
            assert p.postmortem(1)["reason"] == "sigterm-drain"
            assert [e["kind"] for e in p.resize_events()] == ["up", "down"]
            c = rec.counters()
        assert (c["fleet.resize.up"], c["fleet.resize.down"]) == (1, 1)
        with pytest.raises(FleetError, match="below 1"):
            p.resize(0)
    with WorkerPool(1, keyset_spec="stub", placements=[
            WorkerPlacement(0, (0,), "cuda")], ping_interval=5.0) as p:
        # a card pool cannot grow past the cards it was given (the
        # stub worker boots whatever the card; only its flags say cuda)
        assert p.wait_all_ready(WAIT_S)
        with pytest.raises(FleetError, match="CUDA pool"):
            p.resize(2)
