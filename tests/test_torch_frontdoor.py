"""The port's front door against the JAX package's, live.

``ConsistentHashRing`` and ``FrontDoor`` of both packages side by side:
the ring's points, owners and choices on seeded digests; ``_partition``'s
groups, hit flags, counters and arm accounting under stubbed in-flight
loads and breakers (spill, re-route off a dead pool, ``rr``);
``frontdoor_from_spec``'s parse and errors; and sequential batches
routed by each front door to the SAME port workers over CVB1 — stub
workers (tokens ending ``.ok`` verify) behind byte taps for the
routing, the request bytes each pool receives and the counters, and a
pair of ``GPUBatchKeySet(device="cpu")`` workers for real verdicts.
No JAX keyset is built.

Two faults of the reference are repaired here and shown: when every
pool of a multi-group batch is down and there is no fallback, the JAX
``FrontDoor`` loses the error raised in its dispatch threads and
returns ``None`` for those tokens (the serve encoder would send them
as accepts), where the port raises :class:`FleetExhaustedError`; and a
JAX gate sends a worker's rejection on as "RemoteVerifyError:
<ErrorClass>: …" (which a client then classifies as ``internal``),
where the port's sends the worker's own text.

Every socket has a timeout and a SIGALRM watchdog bounds each test."""

import base64
import json
import random
import signal
import socket

import numpy as np
import pytest
import torch

from cap_tpu.fleet import ConsistentHashRing as JRing
from cap_tpu.fleet import FrontDoor as JFrontDoor
from cap_tpu.fleet.frontdoor import frontdoor_from_spec as j_from_spec
from cap_tpu.serve import worker as j_worker

from cap_tpu_torch import testing as tt
from cap_tpu_torch.fleet import (
    ConsistentHashRing,
    FleetExhaustedError,
    FrontDoor,
)
from cap_tpu_torch.fleet.frontdoor import frontdoor_from_spec
from cap_tpu_torch.fleet.worker_main import StubKeySet, make_keyset
from cap_tpu_torch.jwt import jwk as t_jwk
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
from cap_tpu_torch.serve import protocol as P
from cap_tpu_torch.serve import vcache as t_vc
from cap_tpu_torch.serve.client import RemoteVerifyError
from cap_tpu_torch.serve.worker import VerifyWorker

from test_torch_fleet import _Tap, _dead_addr

HARD_TIMEOUT_S = 60
CLIENT_KW = {"attempt_timeout": 5.0, "total_deadline": 10.0}


@pytest.fixture(autouse=True)
def _hard_timeout():
    def on_alarm(signum, frame):
        raise TimeoutError(f"front-door test exceeded {HARD_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _b64(obj) -> str:
    return base64.urlsafe_b64encode(
        json.dumps(obj, separators=(",", ":")).encode()).rstrip(
            b"=").decode()


def _stub_tokens(n, tag, seed):
    """JWT-shaped stub tokens over three issuers (so the per-tenant
    counters have tenants), every seventh one rejected."""
    rng = random.Random(seed)
    hdr = _b64({"alg": "RS256", "kid": "k"})
    out = []
    for i in range(n):
        iss = rng.choice(["https://a.example", "https://b.example",
                          "https://c.example"])
        body = _b64({"iss": iss, "sub": f"{tag}-{i}"})
        out.append(f"{hdr}.{body}." + ("bad" if i % 7 == 3 else "ok"))
    return out


def _norm(results):
    return [(type(r).__name__, str(r)) if isinstance(r, Exception) else r
            for r in results]


def _assert_stub(tokens, results):
    assert len(results) == len(tokens), "lost submissions"
    for t, r in zip(tokens, results):
        if t.endswith(".ok"):
            assert r == {"sub": t}, f"WRONG verdict for {t!r}: {r!r}"
        else:
            assert isinstance(r, Exception), f"WRONG verdict for {t!r}"


def _digests(n, seed):
    rng = np.random.default_rng(seed)
    ds = [rng.bytes(16) for _ in range(n)]
    return ds + [bytes(16), b"\xff" * 16]


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pools,vnodes", [(1, 64), (2, 64), (3, 16),
                                            (5, 64)])
def test_ring_equals_jax(n_pools, vnodes):
    """Points, owners, primary and every preference length equal the
    JAX ring's, at the ring's own points too; after a membership
    change (a pool id joins) again, and only the new pool's segments
    moved."""
    ids = list(range(n_pools))
    digests = _digests(300, 1000 * n_pools + vnodes)
    before = None
    for members in (ids, ids + [n_pools + 3]):
        j, t = JRing(members, vnodes=vnodes), ConsistentHashRing(
            members, vnodes=vnodes)
        assert t._points == j._points and t._owners == j._owners
        edges = [p.to_bytes(8, "big") + bytes(8) for p in t._points[:8]]
        edges += [(p - 1).to_bytes(8, "big") + bytes(8)
                  for p in t._points[:8]]
        for d in digests + edges:
            assert t.primary(d) == j.primary(d)
            for n in range(1, len(members) + 2):
                assert t.preference(d, n) == j.preference(d, n)
        owners = [t.primary(d) for d in digests]
        if before is not None:
            moved = [(b, a) for b, a in zip(before, owners) if b != a]
            assert moved and all(a == n_pools + 3 for _, a in moved)
        before = owners
    for cls in (JRing, ConsistentHashRing):
        with pytest.raises(ValueError, match="empty ring"):
            cls([]).primary(bytes(16))


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------

def _pair(n_pools=3, **kw):
    # listed but unreachable endpoints: a partition never dispatches,
    # and a listed endpoint with a closed breaker counts as live
    eps = [[("127.0.0.1", 1 + i)] for i in range(n_pools)]
    return JFrontDoor(eps, **kw), FrontDoor(eps, **kw)


def _arms(fd):
    return [(a.pool_id, a.tokens, a.affinity_hits, a.spills_in,
             a.reroutes_in, a.inflight, a.live()) for a in fd._arms]


def _kill_arm(fd, pid):
    cl = fd._arms[pid].client
    for ep in cl._live_endpoints():
        for _ in range(5):
            cl._on_failure(ep)


@pytest.mark.parametrize("case", ["affinity", "digests", "spill", "dead",
                                  "rr", "rr_dead", "one_pool"])
def test_partition_equals_jax(case):
    """Groups, hit flags, counters (tenants included) and per-arm
    accounting of ``_partition`` equal the JAX front door's, call
    after call."""
    kw = {"routing": "rr"} if case.startswith("rr") else {}
    fds = _pair(1 if case == "one_pool" else 3, **kw)
    toks = _stub_tokens(64, case, seed=len(case))
    digests = None
    if case == "digests":
        # handed-down digests are used as given (None: hashed here)
        digests = [bytes(16) if i % 3 == 0 else None if i % 3 == 1
                   else t_vc.token_digest(t) for i, t in enumerate(toks)]
    for fd in fds:
        if case == "spill":
            for pid, load in ((0, 40), (1, 0), (2, 5)):
                fd._arms[pid].inflight = load
        if case in ("dead", "rr_dead"):
            _kill_arm(fd, 1 if case == "dead" else 0)
    runs = []
    for fd in fds:
        calls = [fd._partition(toks, digests),
                 fd._partition(toks[:5], None),
                 fd._partition(toks[7:40], None)]
        runs.append((calls, fd.counters(), _arms(fd)))
        fd.close()
    assert runs[1] == runs[0]
    calls, c, _ = runs[1]
    assert c["frontdoor.lookups"] == \
        c["frontdoor.affinity_hits"] + c["frontdoor.affinity_misses"]
    assert any(k.startswith("frontdoor.tenant.") for k in c)
    if case == "spill":
        assert c["frontdoor.spills"] > 0
    if case == "dead":
        assert c["frontdoor.reroutes"] > 0 and all(
            1 not in groups for groups, _ in calls)
    if case == "rr":
        assert [next(iter(g)) for g, _ in calls] == [0, 1, 2]
    if case == "rr_dead":
        assert all(0 not in groups for groups, _ in calls)


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "pool=127.0.0.1:19001+127.0.0.1:19002;pool=127.0.0.1:19003;"
    "routing=rr;spill=3.5",
    ";pool=h1:1;;pool=[::1]:2;spill=2",
    "pool=127.0.0.1:19001;routing=affinity",
    "routing=affinity", "pool=a:1;bogus=1", "pool=a:x", "pool=a:1;spill=z",
    "pool=a:1;routing=hash", "", "pool=a:1;pool"])
def test_spec_equals_jax(spec):
    """The same front door from the same spec, or the same error with
    the same words."""
    out = []
    for fn in (j_from_spec, frontdoor_from_spec):
        try:
            fd = fn(spec)
        except Exception as e:  # noqa: BLE001 - compared below
            out.append((type(e).__name__, str(e)))
            continue
        out.append((fd._routing, fd._spill_factor,
                    [a.client._live_endpoints() for a in fd._arms],
                    fd._ring._points))
        fd.close()
    assert out[1] == out[0]
    if len(out[1]) == 4:                   # parsed: the gateway's spec
        fd = make_keyset("frontdoor:" + spec)
        assert isinstance(fd, FrontDoor)
        fd.close()


# ---------------------------------------------------------------------------
# routed batches over live port workers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stub_workers():
    ws = [VerifyWorker(StubKeySet(), target_batch=64, max_wait_ms=1.0)
          for _ in range(2)]
    yield ws
    for w in ws:
        w.close(5)


def _snapshot(fd):
    """The snapshot less what differs by construction: the taps'
    addresses (breaker keys) and the seconds an open breaker has
    left."""
    snap = fd.snapshot()
    snap["breakers"] = {p: [b["failures"] for b in st.values()]
                        for p, st in snap["breakers"].items()}
    return snap


def test_routed_batches_equal_jax(stub_workers):
    """Sequential batches through the JAX front door and the port's to
    the same two workers: wire-form verdicts, ``counters()``,
    ``snapshot()`` and the request bytes each pool receives are equal."""
    batches = [_stub_tokens(n, f"b{k}", seed=k)
               for k, n in enumerate((40, 1, 17, 64))]
    batches.append(batches[0])             # repeats hit the same owner
    runs, taps = [], []
    for cls in (JFrontDoor, FrontDoor):
        tap = [_Tap(w.address) for w in stub_workers]
        fd = cls([[t.address] for t in tap], client_kw=CLIENT_KW)
        try:
            outs = [fd.verify_batch(b) for b in batches]
            outs.append(fd.verify_batch_digests(
                batches[2], [t_vc.token_digest(t) for t in batches[2]]))
            runs.append(([_norm(o) for o in outs], fd.counters(),
                         _snapshot(fd)))
        finally:
            fd.close()
            for t in tap:
                t.close()
        taps.append([bytes(t.c2s) for t in tap])
    assert runs[1] == runs[0]
    assert taps[1] == taps[0] and all(taps[1])
    for b, o in zip(batches, runs[1][0]):
        _assert_stub(b, [r if isinstance(r, dict) else Exception()
                         for r in o])
    c = runs[1][1]
    assert c["frontdoor.lookups"] == sum(map(len, batches)) + 17
    assert c["frontdoor.lookups"] == \
        c["frontdoor.affinity_hits"] + c["frontdoor.affinity_misses"]
    assert taps[1][0][4] == 7             # the checksummed request frame


# the JAX front door's dispatch thread dies with the error it loses
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_pool_reroutes_then_exhausted_or_fallback(stub_workers):
    """One dead pool: its share re-routes (at dispatch, then at the
    partition once its breaker is open), counted as the JAX front door
    counts it. Every pool dead: without a fallback the port raises
    FleetExhaustedError (the JAX front door returns None verdicts);
    with one, the fallback's verdicts and ``fallback_tokens``."""
    kw = {"attempt_timeout": 1.0, "total_deadline": 3.0, "max_rounds": 1,
          "breaker_threshold": 1, "breaker_reset_s": 60.0}
    toks = _stub_tokens(32, "dead", seed=5)
    live, dead = stub_workers[0].address, _dead_addr()
    runs = []
    for cls in (JFrontDoor, FrontDoor):
        fd = cls([[live], [dead]], client_kw=kw)
        outs = [_norm(fd.verify_batch(toks)) for _ in range(2)]
        runs.append((outs, fd.counters()))
        fd.close()
    assert runs[1] == runs[0]
    c = runs[1][1]
    assert c["frontdoor.reroutes"] == 2 * sum(
        ConsistentHashRing([0, 1]).primary(t_vc.token_digest(t)) == 1
        for t in toks) > 0
    fd = FrontDoor([[live], [dead]], client_kw=kw)
    _assert_stub(toks, fd.verify_batch(toks))
    fd.close()

    both = [[_dead_addr()], [_dead_addr()]]
    j_fd, t_fd = JFrontDoor(both, client_kw=kw), FrontDoor(both,
                                                          client_kw=kw)
    assert len(t_fd._partition(toks, None)[0]) == 2
    assert j_fd.verify_batch(toks) == [None] * len(toks)
    with pytest.raises(FleetExhaustedError):
        t_fd.verify_batch(toks)
    for fd in (j_fd, t_fd):
        fd.close()
    counts = []
    for cls in (JFrontDoor, FrontDoor):
        fd = cls(both, fallback=StubKeySet(), client_kw=kw)
        out = fd.verify_batch(toks)
        _assert_stub(toks, out)
        c = fd.counters()
        counts.append((c["frontdoor.fallback_tokens"],
                       c["frontdoor.lookups"]))
        fd.close()
    assert counts[1] == counts[0] == (len(toks), len(toks))


def test_gate_relays_the_workers_reject_text(stub_workers):
    """A worker's rejection through the port's Python gate
    (``VerifyWorker(FrontDoor)``) reads on the wire as the worker sent
    it; through the JAX gate it gains a "RemoteVerifyError: " head."""
    toks = _stub_tokens(12, "text", seed=9)

    def entries(addr):
        with socket.create_connection(addr, timeout=10.0) as s:
            s.settimeout(10.0)
            P.send_request(s, toks)
            return P.FrameReader(s).recv_frame()[1]

    eps = [[w.address] for w in stub_workers]
    gates = [j_worker.VerifyWorker(JFrontDoor(eps), max_wait_ms=1.0),
             VerifyWorker(FrontDoor(eps), max_wait_ms=1.0)]
    try:
        direct = entries(stub_workers[0].address)
        j_got, t_got = (entries(g.address) for g in gates)
    finally:
        for g in gates:
            g.close(5)
    rejects = [i for i, t in enumerate(toks) if not t.endswith(".ok")]
    assert rejects and t_got == direct
    assert [j_got[i] for i in rejects] == [
        (1, b"RemoteVerifyError: " + direct[i][1]) for i in rejects]
    assert P.error_payload(RemoteVerifyError(direct[rejects[0]][1]
                                             .decode())) == \
        direct[rejects[0]][1]


def test_push_keys_fans_out_to_bare_endpoints(stub_workers):
    """``push_keys`` and the ``swap_keys`` alias reach every worker of
    bare-endpoint pools, acked per endpoint as the JAX front door acks
    them; a dead endpoint acks None."""
    w0, w1 = stub_workers
    dead = _dead_addr()
    key = lambda ep: f"{ep[0]}:{ep[1]}"  # noqa: E731
    acks = []
    for k, cls in enumerate((JFrontDoor, FrontDoor)):
        fd = cls([[w0.address], [w1.address, dead]])
        base = 10 * (k + 1)
        acks.append(fd.push_keys({"keys": []}, epoch=base))
        assert fd.key_epoch == base
        assert w0.key_epoch == base and w1.key_epoch == base
        assert fd.swap_keys({"keys": []}) == base + 1
        assert w1.key_epoch == base + 1
        assert fd.key_epochs() == {} and fd.epoch_skew() == 0
        fd.close()
    assert acks[0] == {0: {key(w0.address): 10},
                       1: {key(w1.address): 10, key(dead): None}}
    assert acks[1] == {0: {key(w0.address): 20},
                       1: {key(w1.address): 20, key(dead): None}}


# ---------------------------------------------------------------------------
# real verdicts: two GPUBatchKeySet(device="cpu") workers
# ---------------------------------------------------------------------------

def test_real_verdicts_equal_jax_and_direct():
    """RS256 and ES256 tokens (some tampered, some malformed) through
    both front doors over two ``GPUBatchKeySet(device="cpu")`` workers:
    the verdicts equal each other and the keyset's own, and each token
    reached its ring owner."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = random.Random(17)
    rs, es = tt.generate_rsa_key(rng), tt.generate_ec_key(rng)
    jwks = t_jwk.parse_jwks({"keys": [
        t_jwk.serialize_public_key(rs.public_key(), kid="rs-0"),
        t_jwk.serialize_public_key(es.public_key(), kid="es-0")]})
    toks = []
    for i in range(6):
        toks.append(tt.sign_jwt(rs, "RS256", tt.default_claims(
            sub=f"r{i}"), kid="rs-0", rng=rng))
        toks.append(tt.sign_jwt(es, "ES256", tt.default_claims(
            sub=f"e{i}"), kid="es-0", rng=rng))
    toks[3] = toks[3][:-4] + ("AAAA" if toks[3][-4:] != "AAAA" else "BBBB")
    toks += ["a.b", "", toks[0]]
    ks = GPUBatchKeySet(jwks, device="cpu")
    workers = []
    try:
        want = _norm([json.loads(v) if isinstance(v, bytes) else v
                      for v in ks.verify_batch_raw(toks)])
        assert sum(isinstance(w, dict) for w in want) == 12
        workers = [VerifyWorker(GPUBatchKeySet(jwks, device="cpu"),
                                target_batch=64, max_wait_ms=1.0)
                   for _ in range(2)]
        ring = ConsistentHashRing([0, 1])
        owner = [ring.primary(t_vc.token_digest(t)) for t in toks]
        assert set(owner) == {0, 1}
        for cls in (JFrontDoor, FrontDoor):
            fd = cls([[w.address] for w in workers], client_kw=CLIENT_KW)
            got = fd.verify_batch(toks)
            assert all(type(r).__name__ == "RemoteVerifyError"
                       for r in got if isinstance(r, Exception))
            assert [r if isinstance(r, dict) else
                    tuple(str(r).split(": ", 1)) for r in got] == want
            snap = fd.snapshot()
            assert [snap["pools"][str(p)]["tokens"] for p in (0, 1)] == [
                owner.count(0), owner.count(1)]
            fd.close()
    finally:
        for w in workers:
            w.close(5)
        torch.set_num_threads(n_threads)
