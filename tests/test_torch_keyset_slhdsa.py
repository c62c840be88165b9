"""SLH-DSA as a whole: GPUBatchKeySet (plain path on the CPU) against the
JAX package's TPUBatchKeySet on one batch of SLH-DSA-SHAKE-128f and
-128s tokens over a JWKS of two keys of each set — the pinned KAT
file's JWKS and tokens (its 128s side needs no host signing) beside a
seeded 128f key and a seeded 128s key — with every rejection class,
kid-less and unknown-kid tokens (the trial path), and a 128f alg over a
128s kid: verdicts bit-equal, claims dicts equal, exception class and
message equal. And the packed path's contract: one chunk a set, 518 +
219 Keccak permutations, a single-key set taking kid-less tokens."""

import base64
import json
import os

import numpy as np
import pytest
import torch

from cap_tpu.jwt import jwk as j_jwk
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import keccak as kk
from cap_tpu_torch.gpu import slhdsa as T
from cap_tpu_torch.jwt import algs
from cap_tpu_torch.jwt import jwk as t_jwk
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet

FAST = algs.SLHDSA128F
SMALL = algs.SLHDSA128S
KAT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "slhdsa_kat.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _sig(token: str) -> bytes:
    return _unb64(token.split(".")[2])


def _with_sig(token: str, sig: bytes) -> str:
    h, p, _ = token.split(".")
    return f"{h}.{p}.{_b64(sig)}"


def _with_header(token: str, header: dict) -> str:
    _, p, s = token.split(".")
    return f"{_b64(json.dumps(header).encode())}.{p}.{s}"


class _Permutes:
    """Counts the Keccak permutations asked for (the wrapper counts
    launches on the card only)."""

    def __init__(self, mp):
        self.n = 0
        permute = kk.permute

        def counted(x):
            self.n += 1
            return permute(x)

        mp.setattr(kk, "permute", counted)


@pytest.fixture(scope="module")
def batch():
    with open(KAT_PATH) as f:
        kat = json.load(f)
    f_priv, _ = T.keygen(FAST, bytes([61]) * 32)
    _, s_pub = T.keygen(SMALL, bytes([62]) * 32)
    doc = {"keys": kat["keys"]["keys"] + [
        t_jwk.serialize_public_key(f_priv.public_key, kid="f-1"),
        t_jwk.serialize_public_key(s_pub, kid="s-1")]}
    claims = tt.default_claims(now=1_700_000_000)

    def sign(sub, kid="f-1", alg=FAST):
        return tt.sign_jwt(f_priv, alg, dict(claims, sub=sub), kid=kid)

    cases = []
    for v in kat["vectors"]:
        label = "kat-" + v["name"].split("-", 4)[-1]
        cases.append((label + ("" if v["testPassed"] else "-reject"),
                      v["token"]))
    good = sign("a0")
    other = sign("a1")
    cases += [("valid", good), ("valid", other)]
    cases += [(label, _with_sig(good, bad))
              for label, bad in tt.slhdsa_bad_signatures(_sig(good), FAST)]
    cases.append(("payload-changed", ".".join(
        [good.split(".")[0], other.split(".")[1], good.split(".")[2]])))
    s_tok = [v["token"] for v in kat["vectors"] if v["alg"] == SMALL
             and v["testPassed"]]
    cases += [(label, _with_sig(s_tok[0], bad))
              for label, bad in tt.slhdsa_bad_signatures(_sig(s_tok[0]),
                                                         SMALL)]
    cases.append(("payload-changed", ".".join(
        [s_tok[0].split(".")[0], good.split(".")[1],
         s_tok[0].split(".")[2]])))
    cases += [
        ("no-kid", sign("trial", kid=None)),
        ("unknown-kid", sign("nobody", kid="nobody")),
        ("alg-over-other-set-kid", sign("cross", kid="s-1")),
        ("small-no-kid-header", _with_header(s_tok[0], {"alg": SMALL})),
        ("small-unknown-kid", _with_header(s_tok[1], {"alg": SMALL,
                                                      "kid": "nobody"})),
        ("segments", "a.b"),
    ]
    labels = [c[0] for c in cases]
    tokens = [c[1] for c in cases]
    ref = TPUBatchKeySet(j_jwk.parse_jwks(doc)).verify_batch(tokens)
    port_ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        count = _Permutes(mp)
        port = port_ks.verify_batch(tokens)
    return labels, tokens, ref, port, count.n, f_priv


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return a == b
    return type(a).__name__ == type(b).__name__ and str(a) == str(b)


def test_verdicts_bit_equal(batch):
    labels, _, ref, port, _, _ = batch
    diff = [(lab, r, p) for lab, r, p in zip(labels, ref, port)
            if not _same(r, p)]
    assert not diff
    assert len(labels) == 40


ACCEPTED = ("kat-accept-1", "kat-accept-2", "valid", "no-kid", "unknown-kid")


def test_accepts_what_it_should(batch):
    labels, _, _, port, _, _ = batch
    for lab, out in zip(labels, port):
        assert isinstance(out, dict) == (lab in ACCEPTED), (lab, out)


@pytest.mark.parametrize("label", [
    "kat-msg-tampered-reject", "kat-r-flip-reject",
    "kat-fors-sk-corrupt-reject", "kat-ht-auth-corrupt-reject",
    "kat-wrong-key-reject", "kat-truncated-reject", "kat-extended-reject",
    "kat-empty-sig-len-reject", "r-bit", "fors-byte", "short", "long",
    "hypertree-byte", "payload-changed", "alg-over-other-set-kid",
    "small-no-kid-header", "small-unknown-kid",
])
def test_rejection_classes(batch, label):
    labels, _, ref, port, _, _ = batch
    outs = [(r, p) for lab, r, p in zip(labels, ref, port) if lab == label]
    assert outs
    for r, p in outs:
        assert type(p).__name__ == "InvalidSignatureError" and _same(r, p)


def test_one_chunk_a_set_on_the_packed_path(batch):
    """Both sets' tokens with a unique key went through one chunk each
    (518 + 219 permutations); the trial path asks for none."""
    *_, n_permutes, _ = batch
    assert n_permutes == T.chunk_launches(T.PARAMS[FAST]) + \
        T.chunk_launches(T.PARAMS[SMALL]) == 518 + 219


def test_single_key_set_takes_kid_less_tokens(batch, monkeypatch):
    """With one key in its set, a kid-less token goes to the packed path
    (row 0), not the trial path; a second-set key beside it does not
    change that."""
    *_, f_priv = batch
    _, s_pub = T.keygen(SMALL, bytes([62]) * 32)
    ks = GPUBatchKeySet([t_jwk.JWK(f_priv.public_key, kid="f-1"),
                         t_jwk.JWK(s_pub, kid="s-1")], device="cpu")
    tok = tt.sign_jwt(f_priv, FAST, {"sub": "only"})
    trial = []
    monkeypatch.setattr(ks, "_verify_one_parsed",
                        lambda p: trial.append(p) or None)
    count = _Permutes(monkeypatch)
    assert ks.verify_batch([tok]) == [{"sub": "only"}]
    assert count.n == 518 and not trial


def test_chunk_rows_and_pad(batch, monkeypatch):
    """A set's chunk pads to a power of two with a 16-row floor (not the
    classical 128), and every row carries its key (the engine itself
    stubbed: this is the routing)."""
    labels, tokens, _, _, _, _ = batch
    seen = []

    def capture(table, sigs, msgs, key_idx, pad=None):
        seen.append((table.parameter_set, len(sigs), pad,
                     np.asarray(key_idx).tolist()))
        return torch.zeros(pad, dtype=torch.bool)

    monkeypatch.setattr(T, "verify_slhdsa_pending", capture)
    pick = [t for lab, t in zip(labels, tokens)
            if lab in ("valid", "short", "kat-accept-1")]
    with open(KAT_PATH) as f:
        kat_keys = json.load(f)["keys"]["keys"]
    ks = GPUBatchKeySet(t_jwk.parse_jwks({"keys": kat_keys + [
        t_jwk.serialize_public_key(batch[5].public_key, kid="f-1")]}),
        device="cpu")
    out = ks.verify_batch(pick)
    assert [type(o).__name__ for o in out] == ["InvalidSignatureError"] * 6
    (pset, m, pad, rows), (pset2, m2, pad2, rows2) = seen
    assert (pset, m, pad) == (FAST, 4, 16) and sorted(rows) == [0, 1, 1, 1]
    assert (pset2, m2, pad2, rows2) == (SMALL, 2, 16, [0, 0])
