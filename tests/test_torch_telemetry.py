"""The port's telemetry, decision records and occupancy plane against
the JAX package's modules of the same names, on seeded inputs:
histogram buckets, quantiles and state round trips, the Recorder's
counters and snapshot, every exception class's reason, tenant and
family attribution, occupancy totals under an injected clock."""

import base64
import json

import numpy as np
import pytest

from cap_tpu import errors as j_errors
from cap_tpu import telemetry as j_tel
from cap_tpu.obs import decision as j_dec
from cap_tpu.obs import occupancy as j_occ

from cap_tpu_torch import errors as t_errors
from cap_tpu_torch import telemetry as t_tel
from cap_tpu_torch.obs import decision as t_dec
from cap_tpu_torch.obs import occupancy as t_occ


def _values(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(1e-8), np.log(1e8), n)).tolist()


def test_bucket_bounds_and_span_names():
    assert t_tel.BUCKET_BOUNDS == j_tel.BUCKET_BOUNDS
    assert t_tel.SPAN_NAMES == j_tel.SPAN_NAMES
    for name in dir(j_tel):
        if name.startswith("SPAN_"):
            assert getattr(t_tel, name) == getattr(j_tel, name), name


@pytest.mark.parametrize("n", [0, 1, 7, 256, 257, 3000])
def test_histogram_quantiles_and_state(n):
    vals = _values(n, n)
    th, jh = t_tel.Histogram(), j_tel.Histogram()
    for v in vals:
        th.add(v)
        jh.add(v)
    th.add_many(0.5, 3)
    jh.add_many(0.5, 3)
    assert th.state() == jh.state()
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert th.quantile(q) == jh.quantile(q), q
    back = t_tel.Histogram.from_state(json.loads(json.dumps(th.state())))
    assert back.state() == th.state()
    assert j_tel.Histogram.from_state(th.state()).state() == jh.state()


def _drive(tel, vals):
    rec = tel.Recorder()
    for i, v in enumerate(vals):
        rec.count("verify_batch.tokens", i % 5)
        rec.observe("serve.request_s", v)
        rec.gauge("keyplane.epoch", i)
    rec.count_many({"admission.checked": 9, "admission.admitted": 8})
    rec.observe_many("batcher.batch_size", 128.0, 4)
    return rec


def test_recorder_counters_and_snapshot():
    vals = _values(3, 300)
    t_rec, j_rec = _drive(t_tel, vals), _drive(j_tel, vals)
    assert t_rec.counters() == j_rec.counters()
    assert t_rec.gauges() == j_rec.gauges()
    assert t_rec.summary() == j_rec.summary()
    snap = t_rec.snapshot()
    assert json.loads(json.dumps(snap)) == json.loads(
        json.dumps(j_rec.snapshot()))
    # snapshots merge across the two packages
    merged_t = t_tel.merge_snapshots([snap, snap])
    merged_j = j_tel.merge_snapshots([j_rec.snapshot(), snap])
    assert merged_t == merged_j
    assert t_tel.summarize_snapshot(merged_t) == \
        j_tel.summarize_snapshot(merged_j)
    with pytest.raises(ValueError):
        t_rec.count("eyJhbGciOiJIUzI1NiJ9")


def test_module_recorder_and_spans():
    with t_tel.recording() as rec:
        t_tel.count("keyplane.swaps")
        with t_tel.span(t_tel.SPAN_KEYPLANE_SWAP):
            pass
        with t_tel.trace() as tid:
            assert t_tel.current_trace() == tid
            with t_tel.span(t_tel.SPAN_BATCHER_DISPATCH):
                pass
        assert t_tel.valid_trace_id(tid)
    assert t_tel.active() is None
    assert rec.counters() == {"keyplane.swaps": 1}
    assert set(rec.summary()) == {t_tel.SPAN_KEYPLANE_SWAP,
                                  t_tel.SPAN_BATCHER_DISPATCH}
    assert [s["name"] for s in rec.trace_spans(tid)] == [
        t_tel.SPAN_BATCHER_DISPATCH]


def _error_classes(mod):
    return {name: cls for name, cls in vars(mod).items()
            if isinstance(cls, type) and issubclass(cls, Exception)
            and cls.__module__ == mod.__name__}


def test_classify_every_error_class():
    t_cls, j_cls = _error_classes(t_errors), _error_classes(j_errors)
    assert set(t_cls) == set(j_cls)
    assert "ThrottledError" in t_cls
    for name in sorted(t_cls):
        t_err, j_err = t_cls[name](), j_cls[name]()
        assert t_dec.classify(t_err) == j_dec.classify(j_err), name
        assert t_dec.reason_index(t_err) == j_dec.reason_index(j_err), name
    for exc in (ValueError("x"), ConnectionError("x"), TimeoutError()):
        assert t_dec.classify(exc) == j_dec.classify(exc)
    assert t_dec.REASON_INDEX == j_dec.REASON_INDEX
    assert t_dec.REASON_FOR_ERROR == j_dec.REASON_FOR_ERROR


def _b64(obj) -> str:
    raw = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


ALGS = ["RS256", "PS384", "ES256", "ES512", "EdDSA", "ML-DSA-44",
        "ML-DSA-87", "SLH-DSA-SHAKE-128s", "SLH-DSA-SHAKE-128f", "HS256",
        "none", "", None]


def _tokens(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        alg = ALGS[int(rng.integers(len(ALGS)))]
        hdr = {"kid": f"k{int(rng.integers(4))}"}
        if alg is not None:
            hdr["alg"] = alg
        iss = [f"https://idp{int(rng.integers(3))}.example/", None, 7,
               ""][int(rng.integers(4))]
        claims = {"sub": f"u{i}"}
        if iss is not None:
            claims["iss"] = iss
        body = [_b64(claims), _b64(b"[1,2]"), "%%%", ""][
            int(rng.integers(4))]
        out.append(f"{_b64(hdr)}.{body}.sig")
    return out + ["", "a.b", "no-dots", 7]


def test_tenant_and_family_attribution():
    toks = _tokens(5, 200)
    for tok in toks:
        assert t_dec.token_tenant(tok) == j_dec.token_tenant(tok)
        assert t_dec.token_family_kid(tok) == j_dec.token_family_kid(tok)
    for alg in ALGS:
        assert t_dec.family_for_alg(alg) == j_dec.family_for_alg(alg)
    assert t_dec.FAMILIES == j_dec.FAMILIES
    t_tab, j_tab = t_dec.TenantTable(cap=3), j_dec.TenantTable(cap=3)
    for tok in toks:
        h = t_dec.token_tenant(tok)
        assert t_tab.admit(h) == j_tab.admit(h)
    assert t_tab.labels() == j_tab.labels()


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _occupancy(mod, tel, steps):
    clock = _Clock()
    acc = mod.OccAccumulator(clock)
    rec = tel.Recorder()
    tel.enable(rec)
    try:
        for fam, t0, t1, disp in steps:
            acc.record(fam, t0, t1, dispatch=disp)
        clock.t = 200.0
        with acc.interval("ec"):
            clock.t = 200.25
        t0 = acc.begin()
        clock.t = 201.0
        acc.end("flight", t0)
        acc.publish(rec)
        return acc.totals(), rec.counters(), rec.gauges()
    finally:
        tel.disable()


def test_occupancy_totals_under_injected_clock():
    rng = np.random.default_rng(9)
    steps, t = [], 100.0
    for _ in range(40):
        t += float(rng.uniform(0.0, 0.5))
        steps.append((["rsa", "ec", None][int(rng.integers(3))], t,
                      t + float(rng.uniform(0.0, 1.0)),
                      bool(rng.integers(2))))
    assert _occupancy(t_occ, t_tel, steps) == \
        _occupancy(j_occ, j_tel, steps)
