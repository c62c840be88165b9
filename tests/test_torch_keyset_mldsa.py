"""ML-DSA as a whole: GPUBatchKeySet (plain path on the CPU) against the
JAX package's TPUBatchKeySet (fused engine) on one batch of ML-DSA-44,
ML-DSA-65 and ML-DSA-87 tokens — accepts, every rejection class, the
trial path, a single-key set taking kid-less tokens — with verdicts
bit-equal: claims dicts equal, exception class and message equal. And
the packed path's contract: no host SHAKE per token."""

import base64
import json

import numpy as np
import pytest
import torch

from cap_tpu.jwt import jwk as j_jwk
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet

from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import mldsa as T
from cap_tpu_torch.jwt import algs
from cap_tpu_torch.jwt import jwk as t_jwk
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet


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


def _sig(token: str) -> bytes:
    s = token.split(".")[2]
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _with_sig(token: str, sig: bytes) -> str:
    h, p, _ = token.split(".")
    return f"{h}.{p}.{_b64(sig)}"


@pytest.fixture(scope="module")
def batch():
    keys = {}
    for pset, tag, n in ((algs.MLDSA44, "pq44", 2), (algs.MLDSA65, "pq65", 2),
                         (algs.MLDSA87, "pq87", 1)):
        for i in range(n):
            keys[f"{tag}-{i}"] = (pset, T.keygen(pset, bytes([len(keys) + 9])
                                                 * 32)[0])
    doc = {"keys": [t_jwk.serialize_public_key(priv.public_key, kid=kid)
                    for kid, (_, priv) in keys.items()]}
    keys["outsider"] = (algs.MLDSA44, T.keygen(algs.MLDSA44, b"\1" * 32)[0])
    claims = tt.default_claims(now=1_700_000_000)

    def sign(kid, sub, header_kid="same"):
        pset, priv = keys[kid]
        hk = kid if header_kid == "same" else header_kid
        return tt.sign_jwt(priv, pset, dict(claims, sub=sub), kid=hk)

    cases = []
    for j in range(4):
        cases.append(("valid", sign(f"pq44-{j % 2}", f"a{j}")))
        cases.append(("valid", sign(f"pq65-{j % 2}", f"b{j}")))
    cases.append(("valid", sign("pq87-0", "c0")))
    for kid in ("pq44-0", "pq65-1"):
        good = sign(kid, "x")
        sig = _sig(good)
        other = sign(kid, "someone-else")
        flipped = bytearray(sig)
        flipped[len(sig) // 2] ^= 0x10
        cases.append(("tampered", _with_sig(good, bytes(flipped))))
        cases.append(("payload-changed", ".".join(
            [good.split(".")[0], other.split(".")[1], good.split(".")[2]])))
        cases += [(label, _with_sig(good, bad)) for label, bad in
                  tt.mldsa_bad_signatures(sig, keys[kid][0])]
    cases += [
        ("alg-over-other-kid", sign("pq65-0", "y", header_kid="pq44-0")),
        ("no-kid", sign("pq44-1", "trial", header_kid=None)),
        ("single-key-no-kid", sign("pq87-0", "single", header_kid=None)),
        ("unknown-kid", sign("pq65-0", "z", header_kid="nobody")),
        ("outsider", sign("outsider", "o", header_kid="nobody")),
        ("segments", "a.b"),
    ]
    labels = [c[0] for c in cases]
    tokens = [c[1] for c in cases]
    ref = TPUBatchKeySet(j_jwk.parse_jwks(doc)).verify_batch(tokens)
    port_ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
    port = port_ks.verify_batch(tokens)
    return labels, tokens, ref, port, port_ks


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return a == b
    return type(a).__name__ == type(b).__name__ and str(a) == str(b)


def test_verdicts_bit_equal(batch):
    labels, _, ref, port, _ = batch
    diff = [(lab, r, p) for lab, r, p in zip(labels, ref, port)
            if not _same(r, p)]
    assert not diff


# an unknown kid takes the trial path over every key of the set
ACCEPTED = ("valid", "no-kid", "single-key-no-kid", "unknown-kid")


def test_accepts_what_it_should(batch):
    labels, _, _, port, ks = batch
    for lab, out in zip(labels, port):
        assert isinstance(out, dict) == (lab in ACCEPTED), (lab, out)
    assert ks.deg_reverified == 0


@pytest.mark.parametrize("label,cls", [
    ("tampered", "InvalidSignatureError"),
    ("c-tilde-bit", "InvalidSignatureError"),
    ("z-bit", "InvalidSignatureError"),
    ("payload-changed", "InvalidSignatureError"),
    ("short", "InvalidSignatureError"),
    ("long", "InvalidSignatureError"),
    ("hint-order", "InvalidSignatureError"),
    ("hint-count", "InvalidSignatureError"),
    ("z-range", "InvalidSignatureError"),
    ("alg-over-other-kid", "InvalidSignatureError"),
    ("outsider", "InvalidSignatureError"),
    ("segments", "MalformedTokenError"),
])
def test_rejection_classes(batch, label, cls):
    labels, _, ref, port, _ = batch
    outs = [(r, p) for lab, r, p in zip(labels, ref, port) if lab == label]
    assert outs
    for r, p in outs:
        assert type(p).__name__ == cls and _same(r, p)


def _alg(token: str) -> str:
    h = token.split(".")[0]
    return json.loads(base64.urlsafe_b64decode(h + "=" * (-len(h) % 4)))[
        "alg"]


def test_crafted_signatures_fail_only_their_own_gate(batch):
    """The crafted rejects are rejected for the reason meant: the hint
    and z-range signatures keep the right length, and only the z-range
    one still decodes."""
    labels, tokens, _, _, _ = batch
    crafted = [(lab, t) for lab, t in zip(labels, tokens)
               if lab in ("hint-order", "hint-count", "z-range")]
    assert len(crafted) == 6
    for lab, tok in crafted:
        p = T.PARAMS[_alg(tok)]
        sig = _sig(tok)
        assert len(sig) == p.sig_size
        assert (T.sig_decode(sig, p) is None) == (lab != "z-range")


def test_packed_path_computes_no_host_shake(batch):
    """A warm batch of tokens with a unique key runs μ, SampleInBall and
    the c̃ compare on the device: the module's host SHAKE counter does
    not move. A kid-less token on the trial path (py_verify) moves
    it."""
    labels, tokens, _, port, ks = batch
    packed = [t for lab, t in zip(labels, tokens)
              if lab in ("valid", "tampered", "c-tilde-bit", "z-range",
                         "single-key-no-kid")]
    ks.verify_batch(packed)
    T.host_shake_calls = 0
    out = ks.verify_batch(packed)
    assert T.host_shake_calls == 0
    assert sum(isinstance(o, dict) for o in out) == 10
    trial = [t for lab, t in zip(labels, tokens) if lab == "no-kid"]
    assert isinstance(ks.verify_batch(trial)[0], dict)
    assert T.host_shake_calls > 0


def test_ragged_chunk_pads_and_matches_one_by_one(batch):
    """130 ML-DSA-44 tokens: one chunk padded to 256 lanes, every
    verdict equal to the token's own."""
    labels, tokens, _, port, ks = batch
    pick = [i for i, (lab, t) in enumerate(zip(labels, tokens))
            if lab in ("valid", "tampered", "short")
            and _alg(t) == algs.MLDSA44]
    idx = np.arange(130) % len(pick)
    out = ks.verify_batch([tokens[pick[i]] for i in idx])
    for k, i in enumerate(idx):
        assert _same(out[k], port[pick[i]])
