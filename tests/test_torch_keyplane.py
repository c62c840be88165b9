"""The port's keyplane against the JAX package's, live.

Sources over the port's loopback ``jwks_test_server`` and
``discovery_test_server`` (ETag reuse, error statuses, bad documents,
discovery and its issuer check, ``canonical_digest``); the refresher on
the same scripted source and clock in both packages (epochs, failed
fetches, cooldown, negative-kid TTL, with equal counters), and its
singleflight; and ``KeyPlaneKeySet`` over ``GPUBatchKeySet(device="cpu")``
against the JAX ``KeyPlaneKeySet`` over ``TPUBatchKeySet`` across a
rotation, a grace window and its retirement, with equal verdicts.

The JAX keyset's packed RS/ES runners go to its own CPU fallback (as in
test_torch_keyset_swap.py), so its verdicts come without an XLA compile;
the device engines are held against each other in test_torch_keyset.py.
Grace windows are held timers; every wait has a bound."""

import json
import random
import signal
import threading
import types

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu import keyplane as j_kp  # noqa: E402
from cap_tpu import telemetry as j_tel  # noqa: E402
from cap_tpu.errors import InvalidJWKSError as JInvalidJWKSError  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402
from cap_tpu.keyplane import plane as j_plane  # noqa: E402
from cap_tpu.keyplane import refresher as j_ref  # noqa: E402

from cap_tpu_torch import keyplane as t_kp  # noqa: E402
from cap_tpu_torch import telemetry as t_tel  # noqa: E402
from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.errors import InvalidJWKSError  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.keyplane import plane as t_plane  # noqa: E402
from cap_tpu_torch.keyplane import refresher as t_ref  # noqa: E402

WAIT_S = 10.0
HARD_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _hard_timeout():
    def on_alarm(signum, frame):
        raise TimeoutError(f"keyplane test exceeded {HARD_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jwks(*kids):
    return {"keys": [{"kty": "RSA", "kid": k, "n": "AQAB", "e": "AQAB"}
                     for k in kids]}


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared by class and text
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_canonical_digest_equals_jax(seed):
    rng = np.random.default_rng(seed)
    keys = []
    for i in range(int(rng.integers(1, 6))):
        k = {"kty": ["RSA", "EC", "OKP"][rng.integers(3)], "kid": f"k{i}",
             "x": "".join(rng.choice(list("abcdef0123"), 12))}
        keys.append(dict(sorted(k.items(), key=lambda _: rng.random())))
    doc = {"keys": keys, "extra": [int(v) for v in rng.integers(0, 9, 3)]}
    assert t_kp.canonical_digest(doc) == j_kp.canonical_digest(doc)
    shuffled = json.loads(json.dumps(doc, indent=int(rng.integers(1, 4))))
    assert t_kp.canonical_digest(shuffled) == t_kp.canonical_digest(doc)


def test_source_for_spec_kinds(tmp_path):
    p = tmp_path / "jwks.json"
    p.write_text(json.dumps(_jwks("a")))
    for spec, cls in ((f"jwks:{p}", "StaticFileSource"),
                      ("jwks-url:http://x/jwks", "RemoteJWKSSource"),
                      ("oidc:https://idp.example", "OIDCDiscoverySource")):
        assert type(t_kp.source_for_spec(spec)).__name__ == cls
        assert t_kp.source_for_spec(spec).description == \
            j_kp.source_for_spec(spec).description
    assert _err(lambda: t_kp.source_for_spec("nope:x")) == \
        _err(lambda: j_kp.source_for_spec("nope:x"))


def test_file_source_equals_jax(tmp_path):
    p = tmp_path / "jwks.json"
    p.write_text(json.dumps(_jwks("a")))
    t_src, j_src = t_kp.StaticFileSource(str(p)), j_kp.StaticFileSource(
        str(p))
    doc, dig = t_src.fetch()
    assert (doc, dig) == j_src.fetch()
    p.write_text(json.dumps(_jwks("a"), indent=3))     # not a rotation
    assert t_src.fetch()[1] == dig
    for body in ("garbage", "[1]", '{"x": 1}'):
        p.write_text(body)
        assert _err(t_src.fetch) == _err(j_src.fetch)
        assert _err(t_src.fetch)[0] == "InvalidJWKSError"
    assert _err(lambda: t_kp.StaticFileSource("")) == \
        _err(lambda: j_kp.StaticFileSource(""))


def test_remote_source_etag_reuse_equals_jax():
    from cap_tpu_torch.utils import http as t_http

    state = {"keys": _jwks("a")["keys"], "etags": True}
    with tt.jwks_test_server(state) as (url, _):
        t_src, j_src = t_kp.RemoteJWKSSource(url), j_kp.RemoteJWKSSource(
            url)
        with t_tel.recording() as rec:
            first = t_src.fetch()
            assert first == j_src.fetch()
            assert state["not_modified"] == 0
            # unchanged: a header-only 304, the cached body reused
            assert t_src.fetch() == j_src.fetch() == first
            assert state["not_modified"] == 2
            assert rec.counters()["http.etag_hits"] == 1
            status, body, hdrs = t_http.get(url, conditional=True)
            assert status == 200 and hdrs["x-cap-conditional"] == \
                "revalidated"
            assert "x-cap-conditional" not in t_http.get(url)[2]
            state["keys"] = _jwks("a", "b")["keys"]       # rotate
            doc, dig = t_src.fetch()
            assert (doc, dig) == j_src.fetch()
            assert dig != first[1] and {k["kid"] for k in doc["keys"]} == \
                {"a", "b"}


@pytest.mark.parametrize("status,body", [(404, None), (500, None),
                                         (503, None), (200, b"garbage"),
                                         (200, b"[1, 2]"),
                                         (200, b'{"keys": 3}')])
def test_remote_source_errors_equal_jax(status, body):
    state = {"keys": [], "status": status, "body": body}
    with tt.jwks_test_server(state) as (url, _):
        got = _err(t_kp.RemoteJWKSSource(url).fetch)
        assert got == _err(j_kp.RemoteJWKSSource(url).fetch)
    assert got[0] == "InvalidJWKSError"
    if status != 200:
        assert f"status {status}" in got[1]


def test_oidc_source_equals_jax():
    state = {"keys": _jwks("a", "b")["keys"]}
    with tt.discovery_test_server(state) as (issuer, _):
        t_src = t_kp.OIDCDiscoverySource(issuer)
        doc = t_src.fetch()
        assert doc == j_kp.OIDCDiscoverySource(issuer).fetch()
        assert {k["kid"] for k in doc[0]["keys"]} == {"a", "b"}
        # issuer mismatch, then a document without jwks_uri
        state["discovery"] = {"issuer": issuer + "-evil",
                              "jwks_uri": issuer + "/jwks"}
        got = _err(t_kp.OIDCDiscoverySource(issuer).fetch)
        assert got == _err(j_kp.OIDCDiscoverySource(issuer).fetch)
        assert got[0] == "InvalidIssuerError"
        state["discovery"] = {"issuer": issuer}
        got = _err(t_kp.OIDCDiscoverySource(issuer).fetch)
        assert got == _err(j_kp.OIDCDiscoverySource(issuer).fetch)
        assert got[0] == "InvalidParameterError"


# ---------------------------------------------------------------------------
# the refresher, scripted on both packages
# ---------------------------------------------------------------------------

class _Source:
    """A scripted JWKS source (documents, failures), digesting with the
    given package's ``canonical_digest``."""

    def __init__(self, digest, err):
        self.digest, self.err = digest, err
        self.doc, self.fail, self.fetches = _jwks("a"), False, 0
        self.description = "scripted"

    def fetch(self):
        self.fetches += 1
        if self.fail:
            raise self.err("scripted: down")
        return self.doc, self.digest(self.doc)


def _run_script(mod, kp, tel, err, script, monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock[0], perf_counter=lambda: clock[0]))
    src = _Source(kp.canonical_digest, err)
    applied = []
    r = mod.Refresher(src, apply=lambda s: applied.append(s.epoch),
                      miss_cooldown_s=5.0, negative_ttl_s=12.0)
    out = []
    with tel.recording() as rec:
        for op, arg in script:
            if op == "refresh":
                try:
                    snap = r.refresh()
                    out.append(("ok", snap.epoch, sorted(snap.kids)))
                except Exception as e:  # noqa: BLE001
                    out.append(("raise", type(e).__name__, str(e)))
            elif op == "miss":
                snap = r.on_miss(arg)
                out.append(("miss", arg, None if snap is None
                            else snap.epoch))
            elif op == "advance":
                clock[0] += arg
            elif op == "doc":
                src.doc = _jwks(*arg)
            elif op == "fail":
                src.fail = arg
        counters = {k: v for k, v in rec.counters().items()
                    if k.startswith("keyplane.")}
    return out, applied, src.fetches, r.epoch, counters


def _script(seed):
    rng = random.Random(seed)
    kids = ["a", "b", "c", "ghost"]
    script = [("refresh", None)]
    for _ in range(60):
        op = rng.choice(["refresh", "miss", "miss", "advance", "doc",
                         "fail"])
        if op == "miss":
            script.append(("miss", rng.choice(kids + [None])))
        elif op == "advance":
            script.append(("advance", rng.choice([0.5, 3.0, 6.0, 13.0])))
        elif op == "doc":
            script.append(("doc", tuple(sorted(rng.sample(kids[:3],
                                                          rng.randint(1,
                                                                      3))))))
        elif op == "fail":
            script.append(("fail", rng.random() < 0.3))
        else:
            script.append(("refresh", None))
    return script


@pytest.mark.parametrize("seed", [5, 6, 7, 8, 9])
def test_refresher_script_equals_jax(seed, monkeypatch):
    script = _script(seed)
    want = _run_script(j_ref, j_kp, j_tel, JInvalidJWKSError, script,
                       monkeypatch)
    got = _run_script(t_ref, t_kp, t_tel, InvalidJWKSError, script,
                      monkeypatch)
    assert got == want
    out, applied, _, epoch, counters = got
    # epochs bump only on change, and apply sees each new one once
    assert applied == list(range(1, epoch + 1))
    assert counters.get("keyplane.refreshes") == epoch


def test_refresher_failed_fetch_keeps_snapshot():
    src = _Source(t_kp.canonical_digest, InvalidJWKSError)
    r = t_kp.Refresher(src)
    r.refresh()
    src.fail = True
    with t_tel.recording() as rec:
        with pytest.raises(InvalidJWKSError):
            r.refresh()
        assert r.on_miss("zz") is None
    assert r.epoch == 1 and r.snapshot.kids == {"a"}
    assert rec.counters()["keyplane.refresh_errors"] == 2


def test_refresher_singleflight():
    gate = threading.Event()

    class Slow(_Source):
        def fetch(self):
            gate.wait(WAIT_S)
            return super().fetch()

    src = Slow(t_kp.canonical_digest, InvalidJWKSError)
    r = t_kp.Refresher(src)
    snaps = []
    with t_tel.recording() as rec:
        threads = [threading.Thread(target=lambda: snaps.append(
            r.refresh())) for _ in range(8)]
        for t in threads:
            t.start()
        deadline = threading.Event()
        while rec.counters().get("keyplane.refresh_coalesced", 0) < 7:
            assert not deadline.wait(0.01) and len(snaps) == 0
        gate.set()
        for t in threads:
            t.join(WAIT_S)
    assert src.fetches == 1
    assert [s.epoch for s in snaps] == [1] * 8


def test_refresher_background_polling():
    src = _Source(t_kp.canonical_digest, InvalidJWKSError)
    r = t_kp.Refresher(src, interval_s=0.05, jitter=0.0)
    r.refresh()
    r.start()
    try:
        done = threading.Event()
        for _ in range(int(WAIT_S / 0.02)):
            if src.fetches >= 3 or done.wait(0.02):
                break
        assert src.fetches >= 3 and r.epoch == 1
    finally:
        r.close()


# ---------------------------------------------------------------------------
# KeyPlaneKeySet over GPUBatchKeySet against the JAX one, across rotation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fx():
    rng = random.Random(71)
    rs = [tt.generate_rsa_key(rng) for _ in range(2)]
    es = [tt.generate_ec_key(rng) for _ in range(2)]
    jwk = {f"rs-{i}": t_jwk.serialize_public_key(k.public_key(),
                                                 kid=f"rs-{i}")
           for i, k in enumerate(rs)}
    jwk.update({f"es-{i}": t_jwk.serialize_public_key(k.public_key(),
                                                      kid=f"es-{i}")
                for i, k in enumerate(es)})
    toks = {}
    for i in range(2):
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
    toks["garbage"] = "not-a-token"
    return dict(jwk=jwk, toks=toks)


def _host_runners(jk):
    """Send the JAX keyset's packed RS/ES tokens to its CPU fallback."""
    def to_slow(idx, pb, parts, meta, pending, slow, *a, **k):
        slow.extend(int(i) for i in idx)

    jk._run_rsa_packed = lambda kind, h, *a, **k: to_slow(*a, **k)
    jk._run_ec_packed = lambda alg, *a, **k: to_slow(*a, **k)
    return jk


class _HeldTimer:
    """threading.Timer held until the test fires it."""

    made = []

    def __init__(self, interval, function, args=()):
        self.interval, self.function, self.args = interval, function, args
        self.daemon = False
        _HeldTimer.made.append(self)

    def start(self):
        pass

    def fire(self):
        self.function(*self.args)


def _norm(results):
    return [(type(r).__name__, str(r)) if isinstance(r, Exception) else r
            for r in results]


def _accepted(fx, results):
    return sorted(n for n, r in zip(fx["toks"], results)
                  if not isinstance(r, Exception))


def test_keyplane_keyset_rotation_equals_jax(fx, monkeypatch):
    monkeypatch.setattr(threading, "Timer", _HeldTimer)
    _HeldTimer.made.clear()
    state = {"keys": [fx["jwk"][k] for k in ("rs-0", "es-0")],
             "etags": True}
    toks = list(fx["toks"].values())
    with tt.jwks_test_server(state) as (url, _):
        kw = dict(interval_s=300.0, miss_cooldown_s=0.0,
                  negative_ttl_s=0.0, grace_s=30.0, start=False)
        tk = t_plane.KeyPlaneKeySet(t_kp.RemoteJWKSSource(url),
                                    device="cpu", **kw)
        jk = j_plane.KeyPlaneKeySet(
            j_kp.RemoteJWKSSource(url),
            keyset_factory=lambda jwks, epoch: _host_runners(
                TPUBatchKeySet(jwks, epoch=epoch)), **kw)
        try:
            assert type(tk._ks).__name__ == "GPUBatchKeySet"
            assert tk._ks.device.type == "cpu"

            def check(want, raw):
                got = (tk.verify_batch_raw(toks) if raw
                       else tk.verify_batch(toks))
                ref = (jk.verify_batch_raw(toks) if raw
                       else jk.verify_batch(toks))
                assert _norm(got) == _norm(ref)
                assert _accepted(fx, got) == sorted(want)
                assert tk.key_epoch == jk.key_epoch

            check(["rs-0", "es-0"], raw=True)
            assert tk.key_epoch == 1 and not tk.in_grace
            # rotation at the IdP: rs-1 and es-1 in, rs-0 out. The
            # batch misses on rs-1/es-1, one refresh swaps the tables,
            # the missed tokens alone are retried (so the kid-less token
            # signed by rs-1 keeps its rejection); rs-0 rides the grace.
            state["keys"] = [fx["jwk"][k] for k in ("rs-1", "es-0",
                                                     "es-1")]
            with t_tel.recording() as rec:
                check(["rs-0", "rs-1", "es-0", "es-1"], raw=False)
            # one on-miss refresh a missed kid (no cooldown here), one
            # swap: the second fetch finds the content unchanged
            assert rec.counters()["keyplane.miss_refreshes"] == 2
            assert rec.counters()["keyplane.refresh_unchanged"] == 1
            assert rec.counters()["keyplane.swaps"] == 1
            assert tk.key_epoch == 2 and tk.in_grace
            assert tk.verify_signature(fx["toks"]["es-1"])["sub"] == "e1"
            assert [(t.interval, t.args[1]) for t in _HeldTimer.made] == \
                [(30.0, 2), (30.0, 2)]
            for t in _HeldTimer.made:
                t.fire()
            assert not tk.in_grace
            check(["rs-1", "es-0", "es-1", "no-kid"], raw=True)
            # a KEYS push overrides the table epoch, the refresher's
            # counter stays; the next poll of unchanged content is free
            doc = {"keys": state["keys"]}
            assert tk.swap_keys(doc, epoch=7, grace_s=0) == \
                jk.swap_keys(doc, epoch=7, grace_s=0) == 7
            assert tk.refresher.refresh().epoch == \
                jk.refresher.refresh().epoch == 2
            check(["rs-1", "es-0", "es-1", "no-kid"], raw=True)
            assert tk.key_epoch == 7
        finally:
            tk.close()
            jk.close()


def test_worker_over_keyplane_caches_no_grace_accept(fx, monkeypatch):
    """ROADMAP C.2 on a keyplane worker: a token under a retired kid is
    accepted inside the rotation's grace but never cached, so it is
    rejected once the grace retires (the worker reads the keyplane
    keyset's ``in_grace``)."""
    from cap_tpu_torch.serve.client import VerifyClient
    from cap_tpu_torch.serve.worker import VerifyWorker

    monkeypatch.setattr(threading, "Timer", _HeldTimer)
    _HeldTimer.made.clear()
    state = {"keys": [fx["jwk"]["rs-0"]]}
    old, new = fx["toks"]["rs-0"], fx["toks"]["rs-1"]
    with tt.jwks_test_server(state) as (url, _):
        ks = t_plane.KeyPlaneKeySet(t_kp.RemoteJWKSSource(url),
                                    device="cpu", start=False,
                                    miss_cooldown_s=0.0,
                                    negative_ttl_s=0.0, grace_s=30.0)
        with t_tel.recording() as rec:
            w = VerifyWorker(ks, vcache=True)
            try:
                with VerifyClient(*w.address, timeout=WAIT_S) as c:
                    assert c.verify_batch([old])[0]["sub"] == "r0"
                    state["keys"] = [fx["jwk"]["rs-1"]]     # rs-0 out
                    assert [r["sub"] for r in c.verify_batch(
                        [new, old])] == ["r1", "r0"]
                    assert ks.in_grace and ks.key_epoch == 2
                    assert c.verify_batch([old])[0]["sub"] == "r0"
                    for t in _HeldTimer.made:
                        t.fire()
                    assert not ks.in_grace
                    got = c.verify_batch([old, new])
                    assert type(got[0]).__name__ == "RemoteVerifyError"
                    assert got[1]["sub"] == "r1"
            finally:
                w.close(deadline_s=WAIT_S)
                ks.close()
        # the grace's accepts of rs-0 were verified, not served cached
        assert rec.counters()["keyplane.swaps"] == 1
