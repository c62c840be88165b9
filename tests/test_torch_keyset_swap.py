"""GPUBatchKeySet's hot key swap, async and stream entry points, chunk
sizing and GPURemoteKeySet against the JAX package's TPUBatchKeySet and
TPURemoteKeySet, on 2–3 RSA-2048 and 2–3 P-256 keys (device="cpu").

The JAX keysets here route their packed RS/ES runners to their own CPU
fallback (the trial path over the batch's captured tables), so their
verdicts come without an XLA compile for every key-table shape a swap
makes; the device engines are held against each other on the same
families in test_torch_keyset.py. The swaps, epochs, grace windows,
retirements and refetches under test are the keysets' own."""

import random
import threading

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import (  # noqa: E402
    TPUBatchKeySet,
    TPURemoteKeySet,
)

from cap_tpu_torch import telemetry  # noqa: E402
from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import (  # noqa: E402
    GPUBatchKeySet,
    GPURemoteKeySet,
)

WAIT_S = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx():
    rng = random.Random(14)
    rs = [tt.generate_rsa_key(rng) for _ in range(3)]
    es = [tt.generate_ec_key(rng) for _ in range(3)]
    jwk = {f"rs-{i}": t_jwk.serialize_public_key(k.public_key(),
                                                 kid=f"rs-{i}")
           for i, k in enumerate(rs)}
    jwk.update({f"es-{i}": t_jwk.serialize_public_key(k.public_key(),
                                                      kid=f"es-{i}")
                for i, k in enumerate(es)})
    toks = {}
    for i in range(3):
        toks[f"rs-{i}"] = tt.sign_jwt(rs[i], "RS256",
                                      tt.default_claims(sub=f"r{i}"),
                                      kid=f"rs-{i}", rng=rng)
        toks[f"es-{i}"] = tt.sign_jwt(es[i], "ES256",
                                      tt.default_claims(sub=f"e{i}"),
                                      kid=f"es-{i}", rng=rng)
    h, p, s = toks["rs-0"].split(".")
    toks["tampered"] = f"{h}.{p}.{s[:-4]}AAAA"
    toks["no-kid"] = tt.sign_jwt(rs[1], "RS256", tt.default_claims(),
                                 rng=rng)
    toks["unknown-kid"] = tt.sign_jwt(rs[2], "RS256", tt.default_claims(),
                                      kid="zz", rng=rng)
    return dict(jwk=jwk, toks=toks)


def _doc(fx, kids):
    return {"keys": [fx["jwk"][k] for k in kids]}


A = ("rs-0", "rs-1", "es-0", "es-1")
B = ("rs-1", "rs-2", "es-1", "es-2")


def _host_runners(jk):
    """Send the JAX keyset's packed RS/ES tokens to its CPU fallback."""
    def to_slow(idx, pb, parts, meta, pending, slow, *a, **k):
        slow.extend(int(i) for i in idx)

    jk._run_rsa_packed = lambda kind, h, *a, **k: to_slow(*a, **k)
    jk._run_ec_packed = lambda alg, *a, **k: to_slow(*a, **k)
    return jk


def _pair(fx, kids=A):
    doc = _doc(fx, kids)
    return (GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu"),
            _host_runners(TPUBatchKeySet(j_jwk.parse_jwks(doc))))


def _norm(results):
    return [(type(r).__name__, str(r)) if isinstance(r, Exception) else r
            for r in results]


def _retire_event(ks):
    """An event set once the keyset's grace timer has run."""
    ev = threading.Event()
    orig = ks._retire_grace

    def wrapped(*a):
        try:
            orig(*a)
        finally:
            ev.set()

    ks._retire_grace = wrapped
    return ev


def _accepted(fx, results):
    names = list(fx["toks"])
    return sorted(n for n, r in zip(names, results)
                  if not isinstance(r, (Exception, tuple)))


def _check(fx, gk, jk, want_accepted):
    toks = list(fx["toks"].values())
    got = gk.verify_batch(toks)
    assert _norm(got) == _norm(jk.verify_batch(toks))
    assert gk.key_epoch == jk.key_epoch
    assert _accepted(fx, got) == sorted(want_accepted)
    return got


class _HeldTimer:
    """threading.Timer held until the test fires it: the grace window
    closes when the test says, whatever the host's load."""

    made = []

    def __init__(self, interval, function, args=()):
        self.interval, self.function, self.args = interval, function, args
        self.daemon = False
        _HeldTimer.made.append(self)

    def start(self):
        pass

    def fire(self):
        self.function(*self.args)


def test_swap_sequences(fx, monkeypatch):
    gk, jk = _pair(fx)
    _check(fx, gk, jk, ["rs-0", "rs-1", "es-0", "es-1", "no-kid"])
    # a dict JWKS, an explicit epoch, no grace
    assert gk.swap_keys(_doc(fx, B), epoch=5, grace_s=0) == \
        jk.swap_keys(_doc(fx, B), epoch=5, grace_s=0) == 5
    assert not gk.in_grace
    # the swap built the window tables; no batch on the epoch builds them
    assert sorted(gk._ec_tables["P-256"]._rns) == [8]
    _check(fx, gk, jk, ["rs-1", "rs-2", "es-1", "es-2", "no-kid",
                        "unknown-kid"])
    # a JWK list, the default epoch, a grace window: the dropped kids
    # (rs-2, es-2) resolve until the timer retires them
    monkeypatch.setattr(threading, "Timer", _HeldTimer)
    _HeldTimer.made.clear()
    with telemetry.recording() as rec:
        assert gk.swap_keys(t_jwk.parse_jwks(_doc(fx, A)), grace_s=7.5) \
            == jk.swap_keys(j_jwk.parse_jwks(_doc(fx, A)),
                            grace_s=7.5) == 6
        assert [(t.interval, t.args[1]) for t in _HeldTimer.made] == \
            [(7.5, 6), (7.5, 6)]
        _check(fx, gk, jk, ["rs-0", "rs-1", "rs-2", "es-0", "es-1",
                            "es-2", "no-kid", "unknown-kid"])
        assert gk.in_grace
        for t in _HeldTimer.made:
            t.fire()
    assert rec.counters()["keyplane.grace_retired"] == 1
    assert rec.counters()["keyplane.grace_kids"] == 2
    _check(fx, gk, jk, ["rs-0", "rs-1", "es-0", "es-1", "no-kid"])
    assert gk.key_epoch == 6 and not gk.in_grace


def test_grace_timer_never_fires_into_a_newer_epoch(fx):
    gk, jk = _pair(fx)
    events = [_retire_event(gk), _retire_event(jk)]
    with telemetry.recording() as rec:
        for ks in (gk, jk):
            ks.swap_keys(_doc(fx, B), grace_s=0.2)
            ks.swap_keys(_doc(fx, B), epoch=9, grace_s=0)
        assert all(ev.wait(WAIT_S) for ev in events)
    assert "keyplane.grace_retired" not in rec.counters()
    assert gk.key_epoch == jk.key_epoch == 9
    assert sorted(gk._by_kid) == sorted(B)


def test_epoch_capture(fx):
    """A batch dispatched before a swap finishes on its own epoch."""
    gk, jk = _pair(fx)
    toks = list(fx["toks"].values())
    outs = []
    for ks in (gk, jk):
        collect = ks.verify_batch_async(toks)
        ks.swap_keys(_doc(fx, B), grace_s=0)
        outs.append(_norm(collect()))
    assert outs[0] == outs[1]
    assert _accepted(fx, outs[0]) == sorted(["rs-0", "rs-1", "es-0",
                                             "es-1", "no-kid"])
    assert gk.key_epoch == 1


def test_async_and_stream_entry_points(fx):
    gk, jk = _pair(fx)
    toks = list(fx["toks"].values())
    c_dict = gk.verify_batch_async(toks)
    c_raw = gk.verify_batch_async_raw(toks)
    raw = _norm(c_raw())
    assert _norm(c_dict()) == _norm(jk.verify_batch(toks))
    assert raw == _norm(jk.verify_batch_raw(toks))
    assert any(isinstance(r, bytes) for r in raw)
    stream = list(gk.verify_stream([toks[:4], toks[4:], toks[2:7]],
                                   depth=2))
    assert [_norm(r) for r in stream] == [
        _norm(jk.verify_batch(t)) for t in (toks[:4], toks[4:], toks[2:7])]


@pytest.mark.parametrize("max_chunk", [1024, 4096, 32768])
def test_chunk_tokens_grid(fx, max_chunk):
    doc = _doc(fx, A)
    gk = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu",
                        max_chunk=max_chunk, chunk_budget_ms=100)
    jk = TPUBatchKeySet(j_jwk.parse_jwks(doc), max_chunk=max_chunk)
    jk._chunk_budget_s = 0.1
    for bps in (None, 1.0, 6e6, 4e7, 3e8, 5e9):
        gk._wire_bps = jk._wire_bps = bps
        for width in (1, 40, 98, 130, 546, 1058, 3074, 9000, 40000):
            assert gk._chunk_tokens(width) == jk._chunk_tokens(width), \
                (bps, width)


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_observe_wire(fx):
    """The rate is the timed copies' bytes over their device time,
    folded into an EWMA; a CPU keyset copies nothing and keeps the
    static budget."""
    gk, _ = _pair(fx)
    gk.verify_batch(list(fx["toks"].values())[:2])
    assert gk._wire_bps is None
    assert gk._chunk_tokens(98) == 32768 and gk._chunk_tokens(546) == 8192
    for ms, want in ((4.0, 1e9), (1.0, 2.5e9)):
        gk._observe_wire({"stats": {"h2d": 4_000_000, "copies": [
            (3_000_000, _Event(1.0), _Event(1.0 + ms * 0.75)),
            (1_000_000, _Event(9.0), _Event(9.0 + ms * 0.25))]}})
        assert gk._wire_bps == pytest.approx(want)
    gk._observe_wire({"stats": {"h2d": 0, "copies": []}})
    assert gk._wire_bps == pytest.approx(2.5e9)


def test_remote_keyset_rotation(fx):
    state = {"keys": [fx["jwk"][k] for k in ("rs-0", "rs-1")]}
    toks = fx["toks"]
    with tt.jwks_test_server(state) as (url, _):
        outs, fetches = [], []
        for make in (
                lambda: GPURemoteKeySet(url, device="cpu",
                                        min_refresh_interval=30.0),
                lambda: TPURemoteKeySet(url, min_refresh_interval=30.0)):
            state["keys"] = [fx["jwk"][k] for k in ("rs-0", "rs-1")]
            ks = make()
            base = state["fetches"]
            ks._ensure()
            if isinstance(ks, TPURemoteKeySet):
                _host_runners(ks._ks)
            steps = []
            steps.append(_norm(ks.verify_batch([toks["rs-0"],
                                                toks["rs-1"]])))
            steps.append(state["fetches"] - base)
            # a bad signature under a known kid never fetches
            steps.append(_norm(ks.verify_batch([toks["tampered"]])))
            steps.append(state["fetches"] - base)
            # rotation: an unknown kid refetches once and verifies
            state["keys"] = [fx["jwk"][k] for k in ("rs-0", "rs-1",
                                                    "rs-2")]
            steps.append(_norm(ks.verify_batch_raw([toks["rs-2"],
                                                    toks["rs-1"]])))
            steps.append(state["fetches"] - base)
            # inside the cooldown an unknown kid does not fetch
            steps.append(_norm(ks.verify_batch([toks["unknown-kid"]])))
            steps.append(state["fetches"] - base)
            outs.append(steps)
        assert outs[0] == outs[1]
        assert outs[0][1::2] == [1, 1, 2, 2]
        assert isinstance(outs[0][4][0], bytes)

