"""The serve tier's host pieces against the JAX package's, step by
step on seeded sequences: the verdict cache (lookup, insert, epoch
bumps, export/import, the exp/nbf clamps under an injected ``now``),
DRR dispatch order, admission token buckets under an injected clock,
and AdaptiveBatcher over the stub keyset (flush sizes, dedup fan-out,
the sync and the 2-deep async pipelines)."""

import base64
import json
import threading
import time

import numpy as np
import pytest

from cap_tpu import errors as j_errors
from cap_tpu.fleet import worker_main as j_main
from cap_tpu.obs import decision as j_dec
from cap_tpu.serve import admission as j_adm
from cap_tpu.serve import batcher as j_bat
from cap_tpu.serve import drr as j_drr
from cap_tpu.serve import vcache as j_vc

from cap_tpu_torch import errors as t_errors
from cap_tpu_torch.fleet import worker_main as t_main
from cap_tpu_torch.obs import decision as t_dec
from cap_tpu_torch.serve import admission as t_adm
from cap_tpu_torch.serve import batcher as t_bat
from cap_tpu_torch.serve import drr as t_drr
from cap_tpu_torch.serve import vcache as t_vc

WAIT_S = 10.0


def _b64(obj) -> str:
    return base64.urlsafe_b64encode(json.dumps(obj).encode()).rstrip(
        b"=").decode()


def _token(i: int, iss: str = "https://idp.example/", **claims) -> str:
    return (_b64({"alg": "ES256", "kid": f"k{i % 3}"}) + "."
            + _b64({"iss": iss, "sub": f"u{i}", **claims}) + ".sig" + str(i))


def _verdict(errors, rng, base: float, i: int):
    """(token, verdict) with exp/nbf around ``base``."""
    pick = int(rng.integers(5))
    claims = {"exp": base + float(rng.uniform(-50, 500)),
              "nbf": base + float(rng.uniform(-100, 50))}
    tok = _token(i, **claims)
    if pick == 0:
        return tok, errors.InvalidSignatureError("bad signature")
    if pick == 1:
        return tok, errors.ExpiredTokenError()        # never cached
    if pick == 2:
        return tok, {"sub": f"u{i}", **claims}
    return tok, json.dumps({"sub": f"u{i}", **claims}).encode()


def _norm(v, miss=None):
    if miss is not None and v is miss:
        return "MISS"
    if isinstance(v, BaseException):
        return (type(v).__name__, str(v))
    return v


def _cache_run(vc_mod, errors, seed: int, base: float):
    rng = np.random.default_rng(seed)
    vc = vc_mod.VerdictCache(capacity=64, shards=4, max_ttl_s=300.0)
    vc.set_epoch(1)
    log = []
    toks = []
    for i in range(120):
        tok, verdict = _verdict(errors, rng, base, i)
        toks.append(tok)
        dig = vc_mod.token_digest(tok)
        now = base + float(rng.uniform(-20, 60))
        epoch = 1 if i % 17 else 0
        log.append(("ins", vc.insert(dig, verdict, token=tok, epoch=epoch,
                                     now=now)))
        for j in rng.integers(0, i + 1, 3).tolist():
            probe = base + float(rng.uniform(-120, 600))
            log.append(("get", j, _norm(vc.get(
                vc_mod.token_digest(toks[j]), now=probe), vc_mod.MISS)))
    hits, miss, digs = vc.lookup_batch(toks)
    log.append(("lookup", [_norm(h, vc_mod.MISS) for h in hits], miss,
                [d.hex() for d in digs]))
    entries, epoch = vc.export_entries(max_entries=40)
    log.append(("export", entries, epoch))
    log.append(("size", vc.size()))
    vc.bump_epoch(2)
    log.append(("after bump", _norm(vc.get(digs[0], now=base),
                                    vc_mod.MISS)))
    fresh = vc_mod.VerdictCache(capacity=64, shards=4)
    fresh.set_epoch(1)
    log.append(("import stale", fresh.import_entries(entries, epoch=7)))
    log.append(("import", fresh.import_entries(entries, epoch=epoch)))
    # the import re-clamps each entry to the wall clock's now + TTL:
    # compare what was installed, not the clamp instants
    log.append(("re-export", sorted(
        e[:2] for e in fresh.export_entries(max_entries=64)[0])))
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_verdict_cache_sequences(seed):
    base = time.time()
    assert _cache_run(t_vc, t_errors, seed, base) == \
        _cache_run(j_vc, j_errors, seed, base)
    tok = _token(5)
    assert t_vc.token_digest(tok) == j_vc.token_digest(tok)
    assert t_vc.CACHEABLE_REJECTS == j_vc.CACHEABLE_REJECTS


@pytest.fixture
def fresh_tenants():
    """Tenant slots come from each package's process-global table:
    start both empty, whatever earlier tests in this process admitted."""
    def reset():
        for dec in (t_dec, j_dec):
            dec._HDR_CACHE.clear()
            dec.TENANTS.reset()

    reset()
    yield
    reset()


def _drr_run(mod, seed: int):
    rng = np.random.default_rng(seed)
    s = mod.DRRScheduler(quantum=int(rng.integers(1, 600)))
    for slot in rng.integers(0, mod.SCHED_SLOTS, 6).tolist():
        s.set_weight(slot, int(rng.integers(1, 5)))
    out = []
    for i in range(400):
        if rng.random() < 0.6:
            s.push(int(rng.integers(0, mod.SCHED_SLOTS + 2)), i,
                   int(rng.integers(1, 900)))
        else:
            out.append(s.pop())
    while s.n:
        out.append(s.pop())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drr_dispatch_order(seed, fresh_tenants):
    assert _drr_run(t_drr, seed) == _drr_run(j_drr, seed)
    toks = [_token(i, iss=f"https://t{i % 4}.example/") for i in range(8)]
    assert t_drr.sched_slot_for_tokens(toks) == \
        j_drr.sched_slot_for_tokens(toks)


class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def _admission_run(mod, seed: int):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    ctl = mod.AdmissionController(rate=float(rng.uniform(1, 50)),
                                  burst=float(rng.uniform(1, 20)),
                                  clock=clock)
    labels = ["aaaaaaaaaaaa", "bbbbbbbbbbbb", "none", "other"]
    out = []
    for step in range(60):
        clock.t += float(rng.uniform(0, 0.3))
        if step == 20:
            ctl.set_scale("bbbbbbbbbbbb", 0.25)
        batch = [labels[k] for k in rng.integers(0, 4,
                                                  int(rng.integers(1, 12)))]
        out.append(ctl.check(batch))
    out.append(sorted(ctl.shed.items()))
    out.append([round(ctl.fill(x), 9) for x in labels])
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_admission_token_buckets(seed):
    assert _admission_run(t_adm, seed) == _admission_run(j_adm, seed)
    te, je = t_adm.throttled_error(42), j_adm.throttled_error(42)
    assert (type(te).__name__, str(te)) == (type(je).__name__, str(je))
    cfg = t_adm.AdmissionConfig(rate=3.0, quantum=9, weights={"be": 2})
    assert (cfg.fair, cfg.rate, cfg.burst, cfg.quantum, cfg.weights,
            cfg.admission_on) == (False, 3.0, 6.0, 9, {"be": 2}, True)


class _Logged:
    """A stub keyset that logs each flush it is handed."""

    def __init__(self, inner):
        self.inner = inner
        self.flushes = []
        if hasattr(inner, "verify_batch_async"):
            self.verify_batch_async = self._async

    def verify_batch(self, tokens):
        self.flushes.append(list(tokens))
        return self.inner.verify_batch(tokens)

    def _async(self, tokens):
        self.flushes.append(list(tokens))
        return self.inner.verify_batch_async(tokens)


def _batcher_run(bat_mod, main_mod, pipeline: bool, dedup: bool,
                 fair: bool):
    ks = _Logged(main_mod.StubKeySet(pipeline=float(pipeline)))
    b = bat_mod.AdaptiveBatcher(ks, target_batch=12, max_wait_ms=60000.0,
                                max_batch=12, dedup=dedup, fair=fair)
    subs = []
    try:
        for i in range(10):
            toks = [f"t{(i * 3 + k) % 7}.{'ok' if k % 2 else 'no'}"
                    for k in range(3)]
            subs.append(b.submit_nowait(toks))
    finally:
        b.close(deadline_s=WAIT_S)
    out = []
    for p in subs:
        assert p.event.wait(WAIT_S)
        out.append([_norm(r) for r in p.results])
    stats = b.stats()
    return out, ks.flushes, stats["flush_reasons"]


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
def test_batcher_flushes_and_dedup(pipeline, dedup):
    t_out = _batcher_run(t_bat, t_main, pipeline, dedup, False)
    j_out = _batcher_run(j_bat, j_main, pipeline, dedup, False)
    assert t_out == j_out
    results, flushes, reasons = t_out
    sent = [f"t{(i * 3 + k) % 7}.{'ok' if k % 2 else 'no'}"
            for i in range(10) for k in range(3)]
    groups = [sent[:12], sent[12:24], sent[24:]]
    assert [len(f) for f in flushes] == [
        len(set(g)) if dedup else len(g) for g in groups]
    assert sum(results, []) == [
        ("InvalidSignatureError",
         "no known key successfully validated the token signature")
        if t.endswith(".no") else {"sub": t} for t in sent]
    assert reasons == {"size": 2, "close": 1}


def test_batcher_fair_mode_and_sync_submit(fresh_tenants):
    t_out = _batcher_run(t_bat, t_main, True, True, True)
    assert t_out == _batcher_run(j_bat, j_main, True, True, True)
    ks = t_main.StubKeySet(raw=1.0)
    b = t_bat.AdaptiveBatcher(ks, target_batch=2, max_wait_ms=1.0)
    done = threading.Event()
    out = []

    def run():
        out.append(b.submit(["x.ok", "y.no"]))
        done.set()

    try:
        threading.Thread(target=run, daemon=True).start()
        assert done.wait(WAIT_S)
    finally:
        b.close(deadline_s=WAIT_S)
    assert out[0][0] == b'{"sub":"stub"}'
    assert type(out[0][1]).__name__ == "InvalidSignatureError"


def test_batcher_fans_a_dispatch_error_out():
    class Broken:
        def verify_batch_async(self, tokens):
            raise RuntimeError("kernel failed to launch")

        def verify_batch(self, tokens):
            raise AssertionError("not the async path")

    b = t_bat.AdaptiveBatcher(Broken(), target_batch=4, max_wait_ms=1.0)
    try:
        p = b.submit_nowait(["a", "b"])
        assert p.event.wait(WAIT_S)
    finally:
        b.close(deadline_s=WAIT_S)
    assert [str(r) for r in p.results] == ["kernel failed to launch"] * 2
