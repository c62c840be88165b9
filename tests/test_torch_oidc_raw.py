"""The port's native claims-rule engine and the raw mode of
``verify_id_token_batch`` against the JAX package's, live and crypto-
free (a stub signature seam, as ``tools/claims_parity.py`` has).

- ``claims_validate.cpp`` is a byte-identical copy of the reference's.
- The differential corpus of ``tools/gen_claims_corpus.py`` (1,050
  adversarial payloads under four policies): the port engine's status
  of every payload equals the JAX engine's; the port Provider's dict
  and raw verdicts equal the JAX Provider's (class and message; the raw
  mode's accepted bytes equal), and the port's native-validated and
  fallback counts equal the JAX package's telemetry counters.
- The registered-claims subset, the object check, the policy blob and
  the status errors, each equal to the JAX package's.
- The port has no kill switch: a library that fails to build, or whose
  layout handshake does not match, raises; a policy the blob cannot
  carry (an audience that is not a string) goes to the Python rules,
  counted.
"""

import base64
import filecmp
import json
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from claims_parity import SIG_OK, make_rig, token_for  # noqa: E402
from gen_claims_corpus import (  # noqa: E402
    CLIENT,
    FIXED_NOW,
    ISSUER,
    LEEWAY,
    NONCE,
    POLICIES,
    SEED,
    build_corpus,
)

from cap_tpu import telemetry as j_telemetry  # noqa: E402
from cap_tpu.oidc import claims_native as j_native  # noqa: E402
from cap_tpu.runtime import native_binding as j_nb  # noqa: E402

from cap_tpu_torch import _build  # noqa: E402
from cap_tpu_torch import errors as t_errors  # noqa: E402
from cap_tpu_torch.oidc import Config, Provider, Request  # noqa: E402
from cap_tpu_torch.oidc import claims_native as t_native  # noqa: E402
from cap_tpu_torch.runtime import native_binding as t_nb  # noqa: E402

CORPUS = build_corpus(SEED)


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


class DifferentialStubKeySet:
    """The port's copy of ``tools/claims_parity``'s stub signature
    seam (its name too, which error messages carry): a token whose third
    segment is the ``sigok`` marker verifies, its payload the decoded
    middle segment."""

    def _one(self, token, want_raw):
        parts = token.split(".")
        if len(parts) != 3 or parts[2] != SIG_OK:
            return t_errors.InvalidSignatureError(
                "no known key successfully validated the token signature")
        try:
            payload = base64.urlsafe_b64decode(
                parts[1] + "=" * (-len(parts[1]) % 4))
        except Exception:  # noqa: BLE001
            return t_errors.MalformedTokenError("invalid base64url segment")
        try:
            claims = json.loads(payload)
        except (ValueError, UnicodeDecodeError) as e:
            return t_errors.MalformedTokenError(
                f"payload is not valid JSON: {e}")
        if not isinstance(claims, dict):
            return t_errors.MalformedTokenError("payload is not a JSON object")
        return payload if want_raw else claims

    def verify_batch(self, tokens):
        return [self._one(t, False) for t in tokens]

    def verify_batch_raw(self, tokens):
        return [self._one(t, True) for t in tokens]


def _port_rig(policy, **cfg_over):
    kw = dict(audiences=(policy["audiences"]
                         if policy["name"] != "other-aud" else None),
              now_func=lambda: FIXED_NOW)
    kw.update(cfg_over)
    cfg = Config(issuer=ISSUER, client_id=CLIENT,
                 supported_signing_algs=["ES256"], **kw)
    provider = Provider(cfg, keyset=DifferentialStubKeySet(),
                        discovery_doc={"issuer": ISSUER})
    request = Request(
        3600.0, "http://127.0.0.1:1/cb", nonce=NONCE,
        audiences=(policy["audiences"]
                   if policy["name"] == "other-aud" else None),
        max_age=policy["max_age"], now_func=lambda: FIXED_NOW)
    return provider, request


def _jax_rig(policy):
    """``tools/claims_parity.make_rig``'s JAX Provider, its Request on
    the corpus clock too (max_age's auth_after is taken at creation)."""
    from cap_tpu.oidc import Request as JRequest

    provider, request = make_rig(policy)
    return provider, JRequest(
        3600.0, "http://127.0.0.1:1/cb", nonce=NONCE,
        audiences=request.audiences() or None, max_age=policy["max_age"],
        now_func=lambda: FIXED_NOW)


def _verdict(v):
    if isinstance(v, Exception):
        return (type(v).__name__, str(v))
    return v


def _jax_raw(provider, request, toks):
    """The JAX Provider's raw verdicts with its native engine on, and
    its oidc.native_* counters."""
    rec = j_telemetry.enable()
    rec.reset()
    try:
        out = provider.verify_id_token_batch(toks, request, raw=True)
        counters = {k: v for k, v in rec.counters().items()
                    if k.startswith("oidc.")}
    finally:
        j_telemetry.disable()
    return out, counters


@pytest.fixture()
def jax_native_on(monkeypatch):
    monkeypatch.setenv("CAP_OIDC_NATIVE", "1")
    assert j_native.enabled(), "the JAX package's claims engine is needed"


def test_claims_validate_cpp_is_the_reference_copy():
    ours = REPO / "cap_tpu_torch" / "runtime" / "native" / "claims_validate.cpp"
    theirs = REPO / "cap_tpu" / "runtime" / "native" / "claims_validate.cpp"
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert _build.HOST_TARGETS["claims_rules"] == (
        ("claims_validate.cpp",), ("claims_tape.h",))
    lib = _build.load("claims_rules")
    assert pathlib.Path(lib._name).parent == _build.BUILD_DIR


def test_registry_and_status_errors_as_the_jax_package():
    assert t_native.STATUS_INDEX == j_native.STATUS_INDEX
    assert t_native.STATUS_ERROR_NAMES == j_native.STATUS_ERROR_NAMES
    assert t_native.LAYOUT_VERSION == j_native.LAYOUT_VERSION
    assert (t_native.STATUS_OK, t_native.STATUS_FALLBACK) == \
        (j_native.STATUS_OK, j_native.STATUS_FALLBACK)
    for st in range(len(t_native.STATUS_INDEX)):
        for kw in (dict(alg="ES256", client_id="c", now=1.5),
                   dict(alg=None, client_id="", now=None)):
            assert _outcome(lambda: t_native.status_error(st, **kw)) == \
                _outcome(lambda: j_native.status_error(st, **kw))


def _outcome(fn):
    try:
        return _verdict(fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("auds,leeway,max_age", [
    ([], 60.0, False), (["a", "bb"], 0.0, True),
    (["ü", ""], 12.5, False), ([f"a{i}" for i in range(40)], 60.0, True)])
def test_pack_policy_as_the_jax_package(auds, leeway, max_age):
    args = (ISSUER, CLIENT, "nonce-ü", auds, leeway, max_age)
    assert t_native.pack_policy(*args) == j_native.pack_policy(*args)
    assert t_native.policy_expressible(*args[:4])
    assert not t_native.policy_expressible(ISSUER, CLIENT, NONCE, [7])
    assert not t_native.policy_expressible(ISSUER, CLIENT, None, [])
    assert not t_native.policy_expressible(ISSUER, "\ud800", NONCE, [])
    assert not t_native.policy_expressible(
        ISSUER, CLIENT, NONCE, ["a"] * (t_native.MAX_POLICY_AUDIENCES + 1))


@pytest.mark.parametrize("pol_idx", range(len(POLICIES)))
def test_corpus_statuses_equal_the_jax_engine(pol_idx, jax_native_on):
    """Every corpus payload of one policy through both engines, as one
    batch: statuses equal payload for payload; every status of the
    registry shows up across the policies."""
    policy = POLICIES[pol_idx]
    group = [c for c in CORPUS if c["policy"] == pol_idx]
    payloads = [c["payload"].encode("utf-8") for c in group]
    alg_ok = np.asarray([c["alg"] == "ES256" for c in group], np.uint8)
    blob = t_native.pack_policy(ISSUER, CLIENT, NONCE, policy["audiences"],
                                LEEWAY, policy["max_age"] is not None)
    want = j_native.validate_payloads(payloads, alg_ok, FIXED_NOW, blob)
    got = t_native.validate_payloads(payloads, alg_ok, FIXED_NOW, blob)
    assert want is not None and got.dtype == np.uint8
    assert got.tolist() == want.tolist()
    if pol_idx == 0:
        seen = set()
        for i, pol in enumerate(POLICIES):
            g = [c for c in CORPUS if c["policy"] == i]
            seen |= set(t_native.validate_payloads(
                [c["payload"].encode() for c in g],
                np.asarray([c["alg"] == "ES256" for c in g], np.uint8),
                FIXED_NOW, t_native.pack_policy(
                    ISSUER, CLIENT, NONCE, pol["audiences"], LEEWAY,
                    pol["max_age"] is not None)).tolist())
        assert seen == set(range(len(t_native.STATUS_INDEX)))


@pytest.mark.parametrize("pol_idx", range(len(POLICIES)))
def test_corpus_provider_verdicts_equal_the_jax_provider(pol_idx,
                                                         jax_native_on):
    """The corpus through both Providers in dict and raw modes: equal
    verdicts (class and message), the raw mode's accepted bytes the
    signed payload, and equal native-validated / fallback counts."""
    policy = POLICIES[pol_idx]
    group = [c for c in CORPUS if c["policy"] == pol_idx]
    toks = [token_for(c) for c in group]
    jp, jreq = _jax_rig(policy)
    tp, treq = _port_rig(policy)
    j_dict = jp.verify_id_token_batch(toks, jreq)
    t_dict = tp.verify_id_token_batch(toks, treq)
    j_raw, j_counts = _jax_raw(jp, jreq, toks)
    t_native.reset_counts()
    t_raw = tp.verify_id_token_batch(toks, treq, raw=True)
    bad = []
    for case, jd, td, jr, tr in zip(group, j_dict, t_dict, j_raw, t_raw):
        same_class = (type(td) is type(tr) if isinstance(td, Exception)
                      else isinstance(tr, bytes))
        if not (_verdict(jd) == _verdict(td) and _verdict(jr) == _verdict(tr)
                and same_class):
            bad.append((case["name"], _verdict(jd), _verdict(td),
                        _verdict(jr), _verdict(tr)))
        if isinstance(td, dict):
            assert tr == case["payload"].encode() and json.loads(tr) == td
    assert not bad, bad[:5]
    assert (t_native.native_validated, t_native.native_fallbacks) == (
        j_counts.get("oidc.native_validated", 0),
        j_counts.get("oidc.native_fallbacks", 0))
    n_accepted = sum(isinstance(v, bytes) for v in t_raw)
    if policy["max_age"] is not None:
        # auth_time is the Python rules': no token is accepted natively
        assert t_native.native_fallbacks >= n_accepted
    else:
        assert t_native.native_validated >= n_accepted


def test_thirteen_vectors_and_counters(jax_native_on):
    """The reference's 13-vector suite and its multi-aud non-string
    vectors: dict and raw verdicts equal the JAX Provider's, the
    escaped-key token counted as the one fallback."""
    good = json.dumps({"iss": ISSUER, "sub": "alice", "aud": [CLIENT],
                       "exp": FIXED_NOW + 3600, "iat": FIXED_NOW - 10,
                       "nonce": NONCE}, separators=(",", ":"))

    def claims(**over):
        c = json.loads(good)
        c.update(over)
        return json.dumps(c, separators=(",", ":"))

    hdr = _b64(json.dumps({"alg": "ES256"}).encode())

    def tok(text):
        return f"{hdr}.{_b64(text.encode())}.{SIG_OK}"

    toks = [tok(good), tok(claims(exp=1000)), tok(claims(nbf=2 ** 33)),
            tok(claims(nonce="nope")), tok(claims(aud=["other"])),
            tok(claims(aud=CLIENT)), tok(claims(aud=[CLIENT, "x"],
                                                azp=CLIENT)),
            tok(claims(aud=[CLIENT, "x"], azp="intruder")),
            tok(claims(aud={"weird": 1})),
            tok(good.replace('"iss"', '"i\\u0073s"')),
            tok(claims(iss="https://evil.example/")), tok(good)[:-2] + "xx",
            "garbage", tok(claims(aud=[CLIENT, 42])), tok(claims(aud=[42])),
            tok(claims(aud=[CLIENT, None])), tok(claims(aud=[True]))]
    jp, jreq = _jax_rig(POLICIES[0])
    tp, treq = _port_rig(POLICIES[0])
    assert [_verdict(v) for v in tp.verify_id_token_batch(toks, treq)] == \
        [_verdict(v) for v in jp.verify_id_token_batch(toks, jreq)]
    j_raw, j_counts = _jax_raw(jp, jreq, toks)
    t_native.reset_counts()
    t_raw = tp.verify_id_token_batch(toks, treq, raw=True)
    assert [_verdict(v) for v in t_raw] == [_verdict(v) for v in j_raw]
    assert all(isinstance(v, t_errors.InvalidAudienceError)
               for v in t_raw[-4:])
    assert (t_native.native_validated, t_native.native_fallbacks) == (
        j_counts["oidc.native_validated"], j_counts["oidc.native_fallbacks"])
    assert t_native.native_fallbacks >= 2  # the escaped key, the aud object


@pytest.mark.parametrize("where", ["config", "request"])
def test_non_string_audiences_take_the_python_rules(where, jax_native_on):
    """A policy the blob cannot carry: the Python rules decide the whole
    batch, every token counted as a fallback, verdicts as the JAX
    Provider's (whose engine call raises and degrades)."""
    auds = ["client-1", 7]
    group = [c for c in CORPUS if c["policy"] == 0][:120]
    toks = [token_for(c) for c in group]
    jp, jreq = _jax_rig(POLICIES[0])
    tp, treq = _port_rig(POLICIES[0])
    for p, r in ((jp, jreq), (tp, treq)):
        if where == "config":
            p.config.audiences = list(auds)
        else:
            r._audiences = list(auds)
    j_raw, j_counts = _jax_raw(jp, jreq, toks)
    t_native.reset_counts()
    t_raw = tp.verify_id_token_batch(toks, treq, raw=True)
    assert [_verdict(v) for v in t_raw] == [_verdict(v) for v in j_raw]
    n_acc = sum(not isinstance(v, t_errors.InvalidSignatureError)
                for v in t_raw)
    assert t_native.native_validated == 0
    assert t_native.native_fallbacks == n_acc == \
        j_counts["oidc.native_fallbacks"]


def test_layout_drift_raises(monkeypatch):
    """A library whose layout differs from the binding's raises, in
    the engine and in the Provider's raw mode: no quiet Python rules."""
    monkeypatch.setattr(t_native, "LAYOUT_VERSION", 999)
    monkeypatch.setattr(t_native, "_engine", None)
    with pytest.raises(RuntimeError, match="layout drift"):
        t_native.validate_payloads([b"{}"], np.ones(1, np.uint8), 0.0,
                                   t_native.pack_policy("i", "c", "n", [],
                                                        60.0, False))
    tp, treq = _port_rig(POLICIES[0])
    toks = [token_for(c) for c in CORPUS[:8]]
    assert tp.verify_id_token_batch(toks, treq)  # dict mode needs no engine
    with pytest.raises(RuntimeError, match="layout drift"):
        tp.verify_id_token_batch(toks, treq, raw=True)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A g++ that fails leaves no engine: the raw mode raises the
    build's error."""
    monkeypatch.setattr(t_native, "_engine", None)
    monkeypatch.delitem(_build._LIBS, "claims_rules", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_gxx", lambda: "false")
    tp, treq = _port_rig(POLICIES[0])
    with pytest.raises(RuntimeError, match="the build failed for claims_rules"):
        tp.verify_id_token_batch([token_for(CORPUS[0])], treq, raw=True)


def test_engine_refusal_raises():
    with pytest.raises(RuntimeError, match="refused the batch"):
        t_native.validate_payloads(
            [b"{}"], np.ones(1, np.uint8), 0.0,
            t_native.pack_policy("i", "c", "n", [], 60.0, False)[:-1])


def test_registered_claims_and_object_check_as_the_jax_package():
    """``registered_claims_from_payloads`` and
    ``PreparedBatch.payload_object_ok`` over the corpus payloads and a
    few that are not objects: equal to the JAX package's."""
    payloads = [c["payload"].encode("utf-8") for c in CORPUS[::3]]
    payloads += [b"[1]", b"7", b"\xef\xbb\xbf{}", b"{", b"", b'"s"',
                 b'{"a":1}  ', b'{"exp":1e400}']
    got = t_nb.registered_claims_from_payloads(payloads)
    want = j_nb.registered_claims_from_payloads(payloads)
    assert [_verdict(v) for v in got] == [_verdict(v) for v in want]
    hdr = _b64(b'{"alg":"ES256"}')
    toks = [f"{hdr}.{_b64(p)}.{SIG_OK}" for p in payloads]
    tpb, jpb = t_nb.prepare_batch_arrays(toks), j_nb.prepare_batch_arrays(toks)
    idx = np.nonzero(tpb.status == 0)[0]
    assert idx.tolist() == np.nonzero(jpb.status == 0)[0].tolist()
    assert tpb.payload_object_ok(idx).tolist() == \
        jpb.payload_object_ok(idx).tolist()
    assert set(tpb.payload_object_ok(idx).tolist()) == {True, False}


def test_oidc_raw_keyset_as_the_jax_package(jax_native_on):
    """OIDCRawKeySet and its spec builder: the Provider's batch in both
    modes, the same configuration from the same options, and the key
    rotation passthrough's refusal."""
    from cap_tpu.oidc import serve_keyset as j_serve

    from cap_tpu_torch.oidc import serve_keyset as t_serve

    opts = {"issuer": ISSUER, "client": CLIENT, "nonce": NONCE,
            "algs": "ES256+RS256", "aud": "a+b"}
    import claims_parity

    jk = j_serve.oidc_rp_keyset_from_spec(
        dict(opts), claims_parity.DifferentialStubKeySet())
    tk = t_serve.oidc_rp_keyset_from_spec(dict(opts), DifferentialStubKeySet())
    for k in (jk, tk):
        k.provider.config.now_func = lambda: FIXED_NOW
    assert tk.provider.config.supported_signing_algs == ["ES256", "RS256"]
    assert tk.provider.config.audiences == jk.provider.config.audiences
    assert tk.request.nonce() == jk.request.nonce() == NONCE
    toks = [token_for(c) for c in CORPUS if c["policy"] == 0][:60]
    assert [_verdict(v) for v in tk.verify_batch(toks)] == \
        [_verdict(v) for v in jk.verify_batch(toks)]
    assert [_verdict(v) for v in tk.verify_batch_raw(toks)] == \
        [_verdict(v) for v in jk.verify_batch_raw(toks)]
    assert tk.key_epoch is None and jk.key_epoch is None
    assert _outcome(lambda: tk.swap_keys([])) == \
        _outcome(lambda: jk.swap_keys([]))
    assert isinstance(tk, t_serve.OIDCRawKeySet)
