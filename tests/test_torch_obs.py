"""The port's observability surface against the JAX package's, live.

The same numpy-seeded telemetry state goes through both packages:
``render_prometheus``, the SLO engine (``parse_rules``, ``evaluate_once``,
``SLOEngine`` windows: counter, ratio with burn, quantile, occupancy
floor, tenant templates), the six read/record helpers of
``obs.decision``, and the postmortem builder, scrubber and renderer
must give equal results. Then the port's ``VerifyWorker(obs_port=0)``
over ``GPUBatchKeySet(device="cpu")`` on both serve chains: its six
endpoints, with the scrape's counters equal to the STATS frame's; a
stalled scraper that times out; and the JAX ``tools/capstat.py``
reading two port workers' ``/snapshot`` into exact sums.
Every socket has a timeout and every test a hard deadline."""

import json
import random
import re
import signal
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from cap_tpu import errors as j_errors
from cap_tpu import telemetry as j_tel
from cap_tpu.obs import decision as j_dec
from cap_tpu.obs import occupancy as j_occ
from cap_tpu.obs import postmortem as j_pm
from cap_tpu.obs import slo as j_slo
from cap_tpu.serve import obs as j_obs

from cap_tpu_torch import errors as t_errors
from cap_tpu_torch import telemetry as t_tel
from cap_tpu_torch import testing as tt
from cap_tpu_torch.fleet import FleetClient, WorkerPool
from cap_tpu_torch.jwt import jwk as t_jwk
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
from cap_tpu_torch.jwt.jose import b64url_encode
from cap_tpu_torch.obs import decision as t_dec
from cap_tpu_torch.obs import occupancy as t_occ
from cap_tpu_torch.obs import postmortem as t_pm
from cap_tpu_torch.obs import slo as t_slo
from cap_tpu_torch.serve import client as t_client
from cap_tpu_torch.serve import obs as t_obs
from cap_tpu_torch.serve import protocol as tp
from cap_tpu_torch.serve.worker import VerifyWorker
from tools import capstat

TIMEOUT_S = 10.0
HARD_TIMEOUT_S = 60
SEEDS = [3, 11, 29, 47]
TENANTS = ["0123456789ab", "fedcba987654", "none", "other"]
REASONS = ["bad_signature", "expired", "malformed", "throttled",
           "unknown_kid"]


@pytest.fixture(autouse=True)
def _hard_timeout():
    def on_alarm(signum, frame):
        raise TimeoutError(f"obs test exceeded {HARD_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_tenant_tables(monkeypatch):
    """Both packages' process-wide tenant tables and header caches,
    empty for the test and restored after it: labels then depend on
    this test's tokens alone, and no other test's table fills up."""
    for dec in (j_dec, t_dec):
        monkeypatch.setattr(dec, "TENANTS", dec.TenantTable())
        monkeypatch.setattr(dec, "_HDR_CACHE", {})


@pytest.fixture(autouse=True)
def _telemetry_off():
    j_tel.disable()
    t_tel.disable()
    yield
    j_tel.disable()
    t_tel.disable()


def _counter_names():
    names = ["worker.requests", "worker.tokens", "worker.protocol_errors",
             "fleet.fallback_tokens", "fleet.hedges",
             "keyplane.push_failures", "keyplane.push_attempts",
             "vcache.stale_accepts", "decision.wrong_verdicts",
             "device.wall_us", "device.busy_us", "device.dispatches",
             "batcher.flushes", "tenant.lookups", "tenant.attributed",
             "tenant.overflow"]
    for surf in ("serve", "router", "gpu"):
        names.append(f"decision.{surf}.accept")
        names += [f"decision.{surf}.reject.{r}" for r in REASONS]
        names += [f"decision.{surf}.family.rs.accept",
                  f"decision.{surf}.family.es.reject"]
        for t in TENANTS:
            names += [f"decision.{surf}.tenant.{t}.tokens",
                      f"decision.{surf}.tenant.{t}.accept",
                      f"decision.{surf}.tenant.{t}.reject",
                      f"decision.{surf}.tenant.{t}.reject.throttled",
                      f"decision.{surf}.tenant.{t}.reject.expired"]
    for t in TENANTS:
        names += [f"decision.tenant.{t}.wrong_verdicts",
                  f"vcache.tenant.{t}.lookups", f"vcache.tenant.{t}.hits"]
    return names


COUNTERS = _counter_names()
SERIES = ["keyplane.propagate_s", "batcher.flush", "batcher.batch_size",
          "tenant.0123456789ab.request_s", "tenant.none.request_s"]


def _drive(recs, rng, n_ops=120, zero_wrong=False):
    """The same seeded operations on every recorder."""
    for _ in range(n_ops):
        kind = rng.integers(3)
        if kind == 0:
            name = COUNTERS[rng.integers(len(COUNTERS))]
            if zero_wrong and "wrong_verdicts" in name:
                continue
            n = int(rng.integers(1, 50))
            for r in recs:
                r.count(name, n)
        elif kind == 1:
            name = ["batcher.queued_tokens", "fleet.breakers_open",
                    "keyplane.epoch"][rng.integers(3)]
            v = float(rng.integers(0, 9))
            for r in recs:
                r.gauge(name, v)
        else:
            name = SERIES[rng.integers(len(SERIES))]
            v = float(rng.lognormal(-5.0, 2.0))
            for r in recs:
                r.observe(name, v)


def _snapshots(seed, **kw):
    rng = np.random.default_rng(seed)
    jr, tr = j_tel.Recorder(), t_tel.Recorder()
    _drive((jr, tr), rng, **kw)
    js, ts = jr.snapshot(), tr.snapshot()
    assert js == ts
    return ts


# ---------------------------------------------------------------------------
# /metrics rendering
# ---------------------------------------------------------------------------

PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{quantile="[0-9.]+"\})? '
    r'[-+]?([0-9.]+([eE][-+]?[0-9]+)?|inf|nan)$')


def _check_prometheus(text):
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            assert line.split()[3] in ("counter", "gauge", "summary")
        else:
            assert PROM_LINE.match(line), line


@pytest.mark.parametrize("seed", SEEDS)
def test_render_prometheus_equals_jax(seed):
    snap = _snapshots(seed)
    extra = {"batcher.queued_tokens": seed, "worker.pid": 1234.0}
    got = t_obs.render_prometheus(snap, extra)
    assert got == j_obs.render_prometheus(snap, extra)
    _check_prometheus(got)
    assert t_obs.render_prometheus({}) == j_obs.render_prometheus({})


# ---------------------------------------------------------------------------
# SLO engine
# ---------------------------------------------------------------------------

RULES_TEXT = """
# one rule of every kind, and two tenant templates
wrong     counter decision.wrong_verdicts max 0
errs      ratio worker.protocol_errors / worker.requests max 0.01
hedges    ratio fleet.hedges / worker.requests max 0.25 burn 2
flush     quantile batcher.flush p99 max 0.5
lag       quantile keyplane.propagate_s p50 max 0.001
occ       occupancy_floor min 0.5
trej      ratio decision.serve.tenant.*.reject / decision.serve.tenant.*.tokens max 0.5 burn 1.5
tq        quantile tenant.*.request_s p95 max 0.05
"""

BAD_RULES = ["x counter", "x counter a min 1", "x ratio a b c max 1",
             "x ratio a / b max 1 burn", "x ratio a / b max 1 hot 2",
             "x quantile s p42 max 1", "x quantile s p99 min 1",
             "x occupancy_floor max 1", "x counter a max zero",
             "x gauge a max 1"]


def _rule_fields(rules):
    return [(r.name, r.kind, r.counter, r.num, r.den, r.series,
             r.quantile, r.max_value, r.burn_threshold) for r in rules]


def test_parse_rules_equal_jax():
    assert _rule_fields(t_slo.parse_rules(RULES_TEXT)) == \
        _rule_fields(j_slo.parse_rules(RULES_TEXT))
    assert _rule_fields(t_slo.default_rules()) == \
        _rule_fields(j_slo.default_rules())


@pytest.mark.parametrize("line", BAD_RULES)
def test_parse_rules_errors_equal_jax(line):
    with pytest.raises(j_slo.SLOError) as je:
        j_slo.parse_rules(f"\n{line}\n")
    with pytest.raises(t_slo.SLOError) as te:
        t_slo.parse_rules(f"\n{line}\n")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_once_equals_jax(seed):
    snap = _snapshots(seed)
    for text in (RULES_TEXT, j_slo.DEFAULT_RULES_TEXT):
        want = j_slo.evaluate_once(snap, j_slo.parse_rules(text))
        got = t_slo.evaluate_once(snap, t_slo.parse_rules(text))
        assert got == want
        assert t_slo.any_breach(got) == j_slo.any_breach(want)
        assert t_slo.format_results(got) == j_slo.format_results(want)
    assert t_slo.evaluate_once(snap) == j_slo.evaluate_once(snap)


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_engine_windows_equal_jax(seed):
    """A scripted history of growing snapshots through both engines'
    burn windows (observe at scripted times, evaluate at each)."""
    rng = np.random.default_rng(seed)
    jr, tr = j_tel.Recorder(), t_tel.Recorder()
    je = j_slo.SLOEngine(j_slo.parse_rules(RULES_TEXT), windows=(30, 120))
    te = t_slo.SLOEngine(t_slo.parse_rules(RULES_TEXT), windows=(30, 120))
    now = 1000.0
    for step in range(24):
        _drive((jr, tr), rng, n_ops=40)
        now += float(rng.integers(1, 20))
        snap = tr.snapshot()
        if step % 3 == 0:
            assert te.evaluate(snap, now=now) == je.evaluate(snap, now=now)
        else:
            je.observe(snap, now=now)
            te.observe(snap, now=now)
    assert te.evaluate(now=now + 5) == je.evaluate(now=now + 5)
    assert t_slo.observed_tenants(snap["counters"], snap["series"]) == \
        j_slo.observed_tenants(snap["counters"], snap["series"])


# ---------------------------------------------------------------------------
# obs.decision: the six restored functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_decision_read_helpers_equal_jax(seed):
    counters = _snapshots(seed)["counters"]
    assert t_dec.decision_counters(counters) == \
        j_dec.decision_counters(counters)
    assert t_dec.surface_totals(counters) == j_dec.surface_totals(counters)
    for surface in (None, "serve", "router", "gpu"):
        assert t_dec.tenant_totals(counters, surface=surface) == \
            j_dec.tenant_totals(counters, surface=surface)
    for surfaces in (["serve"], ["serve", "router", "gpu"], ["nope"]):
        assert t_dec.nonzero_check(counters, surfaces) == \
            j_dec.nonzero_check(counters, surfaces)


def _jws(header, payload, sig="c2ln"):
    return ".".join((b64url_encode(json.dumps(header).encode()),
                     b64url_encode(json.dumps(payload).encode()), sig))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_record_one_and_wrong_verdict_equal_jax(seed, fresh_tenant_tables):
    rng = random.Random(seed)
    issuers = ["https://a.example", "https://b.example", None]
    cases = []
    for i in range(24):
        iss = rng.choice(issuers)
        payload = {"sub": f"s{i}"} if iss is None else {"iss": iss,
                                                         "sub": f"s{i}"}
        tok = _jws({"alg": rng.choice(["RS256", "ES256", "EdDSA"]),
                    "kid": f"k{rng.randrange(3)}"}, payload)
        verdict = rng.choice(["accept", "InvalidSignatureError",
                              "ExpiredTokenError", "MalformedTokenError",
                              "UnknownKeyIDError"])
        cases.append((tok, verdict, rng.random() * 0.01))
    got = []
    for errs, dec, tel in ((j_errors, j_dec, j_tel), (t_errors, t_dec,
                                                      t_tel)):
        with tel.recording() as rec:
            for tok, verdict, lat in cases:
                res = ({"sub": "x"} if verdict == "accept"
                       else getattr(errs, verdict)("m"))
                dec.record_one("serve", res, token=tok, latency_s=lat)
                if verdict == "ExpiredTokenError":
                    dec.record_wrong_verdict(tok)
            dec.record_wrong_verdict(n=2)
            dec.record_wrong_verdict(n=0)
            got.append(rec.counters())
    assert got[1] == got[0]
    assert got[1]["decision.wrong_verdicts"] >= 2


# ---------------------------------------------------------------------------
# postmortems
# ---------------------------------------------------------------------------

def _doc(rng, depth=0):
    words = ["ok", "eyJhbGciOi", "https://idp.example", "x" * 600,
             "worker.tokens", "", "a://b"]
    if depth > 2:
        return rng.choice(words + [1, 2.5, None, True])
    kind = rng.randrange(3)
    if kind == 0:
        return {rng.choice(words): _doc(rng, depth + 1)
                for _ in range(rng.randrange(1, 4))}
    if kind == 1:
        return [_doc(rng, depth + 1) for _ in range(rng.randrange(1, 4))]
    return tuple(_doc(rng, depth + 1) for _ in range(2))


@pytest.mark.parametrize("seed", SEEDS)
def test_scrub_equals_jax(seed):
    doc = _doc(random.Random(seed))
    assert t_pm._scrub(doc) == j_pm._scrub(doc)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_build_and_render_postmortem_equal_jax(seed, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    rng = np.random.default_rng(seed)

    def stats():
        return {"queued_tokens": 3, "inflight_batches": 1,
                "note": "eyJsecret", "snapshot": None}

    docs = []
    with j_tel.recording() as jr, t_tel.recording() as tr:
        _drive((jr, tr), rng)
        for rec in (jr, tr):
            rec.trace_span("ab12cd34ab12cd34", "batcher.fill", 1.0, 0.5)
            rec.flight("ab12cd34ab12cd34", 0.5)
            rec.count("decision.serve.reject.expired", 2)
            rec.decision({"surface": "serve", "family": "rs",
                          "verdict": "reject", "reason": "expired",
                          "lat": "le1ms"})
        for pm in (j_pm, t_pm):
            docs.append((pm.build_postmortem("checkpoint", stats,
                                             t_start=1.7e9 - 5),
                         pm.build_postmortem("startup")))
    assert docs[1] == docs[0]
    doc = docs[1][0]
    assert doc["stats"]["note"] == "[redacted]"
    assert doc["flight"] and doc["decisions"]
    assert t_pm.render_postmortem(doc) == j_pm.render_postmortem(doc)
    assert "decisions[serve]" in t_pm.render_postmortem(doc)


def test_postmortem_writer_atomic_file(tmp_path):
    path = str(tmp_path / "pm.json")
    assert t_pm.read_postmortem(path) is None
    with t_tel.recording() as rec:
        rec.count("worker.requests", 2)
        w = t_pm.PostmortemWriter(path, interval_s=0.05,
                                  stats_fn=lambda: {"queued_tokens": 0})
        assert t_pm.read_postmortem(path)["reason"] == "startup"
        deadline = time.monotonic() + TIMEOUT_S
        while t_pm.read_postmortem(path)["reason"] != "checkpoint":
            assert time.monotonic() < deadline
            time.sleep(0.02)
        w.close("sigterm-drain")
    doc = t_pm.read_postmortem(path)
    assert doc["reason"] == "sigterm-drain"
    assert doc["snapshot"]["counters"]["worker.requests"] == 2
    assert j_pm.read_postmortem(path) == doc
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


# ---------------------------------------------------------------------------
# the obs server: the same recorder state through both packages
# ---------------------------------------------------------------------------

def _get(addr, path):
    host, port = addr
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=TIMEOUT_S) as r:
        return r.read().decode()


def test_obs_servers_equal_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    # each package's occupancy plane is process-wide and every scrape
    # publishes it: start both empty, so that engine work of an earlier
    # test in this process does not reach one side's /metrics only
    for occ in (j_occ, t_occ):
        monkeypatch.setattr(occ, "_acc", occ.OccAccumulator())
    rng = np.random.default_rng(5)
    extra = lambda: {"batcher.queued_tokens": 2.0}  # noqa: E731
    js = j_obs.ObsServer(extra=extra)
    ts = t_obs.ObsServer(extra=extra)
    try:
        with j_tel.recording() as jr, t_tel.recording() as tr:
            _drive((jr, tr), rng)
            for rec in (jr, tr):
                rec.flight("ab12cd34ab12cd34", 0.5)
            for path in ("/metrics", "/snapshot", "/flight", "/decisions",
                         "/tenants", "/healthz"):
                assert _get(ts.address, path) == _get(js.address, path), \
                    path
        with pytest.raises(urllib.error.HTTPError):
            _get(ts.address, "/nope")
    finally:
        js.close()
        ts.close()


def test_stalled_scraper_times_out():
    srv = t_obs.ObsServer(handler_timeout_s=0.5)
    stalled = socket.create_connection(srv.address, timeout=TIMEOUT_S)
    try:
        stalled.send(b"GET /snapshot")      # no CRLF: never a request
        assert json.loads(_get(srv.address, "/healthz"))["ok"]
        t0 = time.monotonic()
        try:
            closed = stalled.recv(4096) == b""
        except OSError:
            closed = True
        assert closed and time.monotonic() - t0 < 5.0
    finally:
        stalled.close()
        srv.close()


# ---------------------------------------------------------------------------
# a port worker's six endpoints, on both chains, against its STATS
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fx():
    rng = random.Random(61)
    rs, es = tt.generate_rsa_key(rng), tt.generate_ec_key(rng)
    doc = {"keys": [t_jwk.serialize_public_key(rs.public_key(), kid="rs"),
                    t_jwk.serialize_public_key(es.public_key(), kid="es")]}
    iss = "https://tenant.example"
    toks = []
    for i in range(4):
        toks.append(tt.sign_jwt(rs, "RS256", tt.default_claims(
            sub=f"r{i}", iss=iss), kid="rs", rng=rng))
        toks.append(tt.sign_jwt(es, "ES256", tt.default_claims(
            sub=f"e{i}", iss=iss), kid="es", rng=rng))
    h, p, s = toks[0].split(".")
    toks += [f"{h}.{p}.{s[:-4]}AAAA", "not-a-token"]
    return dict(doc=doc, toks=toks)


def _stats_frame(addr):
    with socket.create_connection(addr, timeout=TIMEOUT_S) as s:
        tp.send_stats_request(s)
        ftype, entries = tp.FrameReader(s).recv_frame()
    assert ftype == tp.T_STATS_RESP
    return json.loads(entries[0][1])


def _of_interest(counters):
    return {k: v for k, v in counters.items()
            if k.startswith(("worker.", "decision."))}


@pytest.mark.parametrize("chain", ["python", "native"])
def test_worker_endpoints_equal_stats(fx, chain):
    ks = GPUBatchKeySet(t_jwk.parse_jwks(fx["doc"]), device="cpu")
    want = ks.verify_batch_raw(fx["toks"])
    with t_tel.recording():
        w = VerifyWorker(ks, obs_port=0, serve_native=chain == "native",
                         vcache=False)
        try:
            with t_client.VerifyClient(*w.address, timeout=TIMEOUT_S,
                                       raw=True) as c:
                got = c.verify_batch(fx["toks"])
            assert [r if isinstance(r, bytes) else type(r).__name__
                    for r in got] == [
                r if isinstance(r, bytes) else "RemoteVerifyError"
                for r in want]
            stats = _stats_frame(w.address)
            assert stats["obs_port"] == w.obs_address[1]
            assert json.loads(_get(w.obs_address, "/healthz")) == {
                "ok": True}
            snap = json.loads(_get(w.obs_address, "/snapshot"))
            counters = snap["snapshot"]["counters"]
            assert _of_interest(counters) == _of_interest(
                stats["counters"])
            assert counters["worker.tokens"] == len(fx["toks"])
            assert t_dec.surface_totals(counters)["serve"]["accept"] == \
                sum(isinstance(r, bytes) for r in want)
            assert snap["extra"]["serve.native.active"] == (
                1.0 if chain == "native" else 0.0)
            metrics = _get(w.obs_address, "/metrics")
            _check_prometheus(metrics)
            assert f"cap_worker_tokens_total {len(fx['toks'])}" in metrics
            assert "cap_batcher_queued_tokens 0" in metrics
            tenants = json.loads(_get(w.obs_address, "/tenants"))
            assert tenants["lookups"] == tenants["attributed"] + \
                tenants["overflow"]
            assert tenants["tenants"] == t_dec.tenant_totals(counters)
            serve_rows = t_dec.tenant_totals(counters, surface="serve")
            assert sum(r["tokens"] for r in serve_rows.values()) == \
                len(fx["toks"])
            decisions = json.loads(_get(w.obs_address,
                                        "/decisions"))["decisions"]
            assert "serve" in {d["surface"] for d in decisions}
            assert isinstance(json.loads(_get(w.obs_address, "/flight"))[
                "slowest"], list)
            dumps = metrics + json.dumps(snap) + json.dumps(decisions)
            for tok in fx["toks"][:8]:
                assert tok.split(".")[2] not in dumps
        finally:
            w.close(deadline_s=TIMEOUT_S)


# ---------------------------------------------------------------------------
# capstat (the JAX package's tool) reading two port workers
# ---------------------------------------------------------------------------

def test_capstat_merges_two_port_workers_exactly():
    # no supervisor ping in the test's span: each opens a connection,
    # which worker.connections counts
    with WorkerPool(2, "stub", platform="cpu", ping_interval=600.0,
                    spawn_timeout=30.0) as pool:
        assert pool.wait_all_ready(30)
        cl = FleetClient(pool, fallback=None, rr_seed=0)
        for i in range(5):
            res = cl.verify_batch([f"c{i}.ok", f"c{i}.bad", f"d{i}.ok"])
            assert res[0] == {"sub": f"c{i}.ok"}
            assert isinstance(res[1], Exception)
        stats = pool.stats()
        data = {f"{h}:{p}": capstat.scrape(f"{h}:{p}")
                for h, p in pool.obs_endpoints().values()}
        assert len(data) == 2
        merged = capstat.merged_snapshot(data)["counters"]
        want = {}
        for s in stats.values():
            for k, v in _of_interest(s["counters"]).items():
                want[k] = want.get(k, 0) + v
        assert _of_interest(merged) == want
        assert merged["worker.tokens"] == 15
        assert all(s["counters"]["worker.requests"] >= 2
                   for s in stats.values())
        # the pool's own exact aggregate, over the STATS it fetched
        pm = pool.stats_merged()
        want = {}
        for s in pm["workers"].values():
            for k, v in _of_interest(s["counters"]).items():
                want[k] = want.get(k, 0) + v
        assert _of_interest(pm["aggregate"]["counters"]) == want
