"""The PS256 + EdDSA configuration as a whole: GPUBatchKeySet (plain
path on the CPU) against the JAX package's TPUBatchKeySet (RNS engines)
on one batch of PS256 and EdDSA tokens — accepts, every rejection
class, the trial path — with verdicts bit-equal: claims dicts equal,
exception class and message equal."""

import base64
import hashlib
import random

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu import testing as jt  # noqa: E402
from cap_tpu.jwt import algs  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.errors import UnsupportedAlgError  # noqa: E402
from cap_tpu_torch.gpu import ed25519 as ed  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402


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


def _with_sig(token: str, sig: bytes) -> str:
    h, p, _ = token.split(".")
    return f"{h}.{p}.{_b64(sig)}"


def _sig(token: str) -> bytes:
    s = token.split(".")[2]
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _port_rsa(priv):
    """The port's signer over an OpenSSL key's primes (keygen in pure
    Python would cost seconds)."""
    nums = priv.private_numbers()
    return tt.RSAPrivateKey(nums.p, nums.q)


def _forged_for_identity_key(rng) -> str:
    """An EdDSA token for the identity key (a small-order key: −A is the
    identity, so R = [S]B verifies for any S and message). Both the
    device ladder and OpenSSL accept it."""
    si = tt.signing_input(algs.EdDSA, {"sub": "small-order"}, "ed-id")
    s = rng.randrange(1, ed.L_ORDER)
    r = ed.encode_point(ed.scalar_mult(s, ed._B_POINT))
    return si.decode() + "." + _b64(r + s.to_bytes(32, "little"))


BAD_KEY = (2).to_bytes(32, "little")           # y = 2: not on the curve
IDENTITY_KEY = (1).to_bytes(32, "little")      # small order (order 1)


@pytest.fixture(scope="module")
def batch():
    rng = random.Random(41)
    rs = [jt.generate_keys(algs.PS256)[0] for _ in range(2)]
    eds = [jt.generate_keys(algs.EdDSA)[0] for _ in range(2)]
    p_rsa = _port_rsa(rs[0])
    p_ed = tt.generate_ed25519_key(rng)
    doc = {"keys": (
        [j_jwk.serialize_public_key(k.public_key(), kid=f"ps-{i}")
         for i, k in enumerate(rs)]
        + [j_jwk.serialize_public_key(k.public_key(), kid=f"ed-{i}")
           for i, k in enumerate(eds)]
        + [t_jwk.serialize_public_key(p_ed.public_key(), kid="port-ed"),
           t_jwk.serialize_public_key(ed.HostEd25519PublicKey(BAD_KEY),
                                      kid="ed-bad"),
           t_jwk.serialize_public_key(
               ed.HostEd25519PublicKey(IDENTITY_KEY), kid="ed-id")])}

    cases = []

    def add(label, token):
        cases.append((label, token))

    claims = jt.default_claims(now=1_700_000_000)
    for j in range(4):
        c = dict(claims, sub=f"u{j}")
        add("valid-ps", jt.sign_jwt(rs[j % 2], algs.PS256, c,
                                    kid=f"ps-{j % 2}"))
        add("valid-ed", jt.sign_jwt(eds[j % 2], algs.EdDSA, c,
                                    kid=f"ed-{j % 2}"))
    good_ps, good_ed = cases[0][1], cases[1][1]
    for tok in (good_ps, good_ed):
        bad = bytearray(_sig(tok))
        bad[len(bad) // 2] ^= 0x10
        add("tampered", _with_sig(tok, bytes(bad)))
    ed_sig = _sig(good_ed)
    s_int = int.from_bytes(ed_sig[32:], "little")
    add("ed-s-plus-l", _with_sig(
        good_ed, ed_sig[:32] + (s_int + ed.L_ORDER).to_bytes(32, "little")))
    r_big = bytearray((ed.P + 1).to_bytes(32, "little"))
    r_big[31] |= ed_sig[31] & 0x80
    add("ed-r-y-ge-p", _with_sig(good_ed, bytes(r_big) + ed_sig[32:]))
    add("ed-wrong-length", _with_sig(good_ed, ed_sig[:63]))
    add("ed-wrong-length", _with_sig(good_ed, ed_sig + b"\0"))
    add("ed-undecodable-key",
        jt.sign_jwt(eds[0], algs.EdDSA, claims, kid="ed-bad"))
    add("ed-no-kid", jt.sign_jwt(eds[1], algs.EdDSA, claims))
    add("ed-unknown-kid", jt.sign_jwt(eds[0], algs.EdDSA, claims,
                                      kid="nope"))
    add("ed-kid-of-other-family",
        jt.sign_jwt(eds[0], algs.EdDSA, claims, kid="ps-0"))
    add("ed-small-order-key", _forged_for_identity_key(rng))

    si = tt.signing_input(algs.PS256, dict(claims, sub="crafted"), "ps-0")
    digest = hashlib.sha256(si).digest()
    em_bits = p_rsa.n.bit_length() - 1
    em = tt.pss_em(digest, em_bits, "sha256", rng.randbytes(32))
    add("ps-crafted-ok", tt.sign_em(p_rsa, si, em))
    add("ps-bad-trailer", tt.sign_em(p_rsa, si, em[:-1] + b"\xbd"))
    no_sep = tt.pss_em(digest, em_bits, "sha256", rng.randbytes(32))
    # flip the 0x01 separator's bit under the mask: DB's first nonzero
    # byte is then the salt's, or none
    sep_at = 256 - 32 - 1 - 32 - 1
    no_sep = bytearray(no_sep)
    no_sep[sep_at] ^= 0x01
    add("ps-no-separator", tt.sign_em(p_rsa, si, bytes(no_sep)))
    top = bytearray(em)
    top[0] = 0x80 | (top[0] & 0x0F)
    add("ps-top-bits", tt.sign_em(p_rsa, si, bytes(top)))
    add("ps-wrong-length", _with_sig(good_ps, _sig(good_ps)[:-1]))
    for j, salt in enumerate((0, "max")):
        add("port-signed", tt.sign_jwt(p_rsa, algs.PS256,
                                       dict(claims, sub=f"salt{j}"),
                                       kid="ps-0", rng=rng, salt_len=salt))
    for j in range(2):
        add("port-signed", tt.sign_jwt(p_ed, algs.EdDSA,
                                       dict(claims, sub=f"ed{j}"),
                                       kid="port-ed"))
    add("segments", "a.b")

    labels = [c[0] for c in cases]
    tokens = [c[1] for c in cases]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        ref = TPUBatchKeySet(j_jwk.parse_jwks(doc)).verify_batch(tokens)
    port_ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
    port = port_ks.verify_batch(tokens)
    return labels, tokens, ref, port, (p_rsa, p_ed)


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return a == b
    return type(a).__name__ == type(b).__name__ and str(a) == str(b)


def test_verdicts_bit_equal(batch):
    labels, _, ref, port, _ = batch
    diff = [(lab, r, p) for lab, r, p in zip(labels, ref, port)
            if not _same(r, p)]
    assert not diff


ACCEPTED = ("valid-ps", "valid-ed", "ed-no-kid", "ed-unknown-kid",
            "ed-small-order-key", "ps-crafted-ok", "port-signed")


def test_accepts_what_it_should(batch):
    labels, _, _, port, _ = batch
    for lab, out in zip(labels, port):
        assert isinstance(out, dict) == (lab in ACCEPTED), (lab, out)


@pytest.mark.parametrize("label,cls", [
    ("tampered", "InvalidSignatureError"),
    ("ed-s-plus-l", "InvalidSignatureError"),
    ("ed-r-y-ge-p", "InvalidSignatureError"),
    ("ed-wrong-length", "InvalidSignatureError"),
    ("ed-undecodable-key", "InvalidSignatureError"),
    ("ed-kid-of-other-family", "InvalidSignatureError"),
    ("ps-bad-trailer", "InvalidSignatureError"),
    ("ps-no-separator", "InvalidSignatureError"),
    ("ps-top-bits", "InvalidSignatureError"),
    ("ps-wrong-length", "InvalidSignatureError"),
    ("segments", "MalformedTokenError"),
])
def test_rejection_classes(batch, label, cls):
    labels, _, ref, port, _ = batch
    outs = [(r, p) for lab, r, p in zip(labels, ref, port) if lab == label]
    assert outs
    for r, p in outs:
        assert type(p).__name__ == cls and _same(r, p)


def test_port_signed_tokens_verify_under_jax(batch):
    labels, _, ref, _, _ = batch
    got = [r for lab, r in zip(labels, ref) if lab == "port-signed"]
    assert len(got) == 4 and all(isinstance(r, dict) for r in got)
    assert sorted(r["sub"] for r in got) == ["ed0", "ed1", "salt0", "salt1"]


@pytest.mark.parametrize("alg", ["PS384", "PS512"])
def test_ps384_and_ps512_are_refused_per_token(batch, alg):
    """PS384/PS512 run on the packed path with the device SHA-384/512:
    under a JWKS of an OpenSSL key and the port's key, honest tokens
    (salts of the hash's length, 0 and max), a tampered one, crafted
    EMs (bad trailer, no separator, top bits) and a short signature get
    verdicts bit-equal to the JAX keyset's, beside a PS256 token. (The
    name dates from when the keyset refused them; it is kept so the
    test's history stays one.)"""
    _, tokens, _, _, (p_rsa, _) = batch
    rng = random.Random(42)
    hash_name = algs.HASH_FOR_ALG[alg]
    h_len = len(hashlib.new(hash_name).digest())
    j_rsa = jt.generate_keys(alg)[0]
    doc = {"keys": [t_jwk.serialize_public_key(p_rsa.public_key(),
                                               kid="ps-0"),
                    j_jwk.serialize_public_key(j_rsa.public_key(),
                                               kid="jx")]}
    claims = jt.default_claims(now=1_700_000_000)
    toks = [tokens[0]]
    for j, salt in enumerate((None, 0, "max")):
        toks.append(tt.sign_jwt(p_rsa, alg, dict(claims, sub=f"s{j}"),
                                kid="ps-0", rng=rng, salt_len=salt))
    toks.append(jt.sign_jwt(j_rsa, alg, dict(claims, sub="jx"), kid="jx"))
    bad = bytearray(_sig(toks[1]))
    bad[9] ^= 0x02
    toks.append(_with_sig(toks[1], bytes(bad)))
    si = tt.signing_input(alg, dict(claims, sub="crafted"), "ps-0")
    em_bits = p_rsa.n.bit_length() - 1
    em = tt.pss_em(hashlib.new(hash_name, si).digest(), em_bits, hash_name,
                   rng.randbytes(h_len))
    no_sep = bytearray(em)
    no_sep[len(em) - h_len - 1 - h_len - 1] ^= 0x01
    top = bytearray(em)
    top[0] = 0x80 | (top[0] & 0x0F)
    toks += [tt.sign_em(p_rsa, si, em),
             tt.sign_em(p_rsa, si, em[:-1] + b"\xbd"),
             tt.sign_em(p_rsa, si, bytes(no_sep)),
             tt.sign_em(p_rsa, si, bytes(top)),
             _with_sig(toks[1], _sig(toks[1])[:-1])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        ref = TPUBatchKeySet(j_jwk.parse_jwks(doc)).verify_batch(toks)
    out = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu") \
        .verify_batch(toks)
    assert all(_same(r, p) for r, p in zip(ref, out))
    assert [isinstance(o, dict) for o in out] == \
        [True] * 5 + [False] + [True] + [False] * 4
    assert not any(isinstance(o, UnsupportedAlgError) for o in out)


def test_ed_records_equal_the_reference(monkeypatch):
    """The records the keyset packs for an EdDSA chunk (k from one
    native SHA-512 call) equal the JAX package's ``ed_packed_records``
    on the same signatures, messages and key rows: right and wrong
    lengths, an undecodable key, padding rows."""
    import numpy as np
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PublicKey,
    )

    from cap_tpu.tpu import ed25519 as j_ed

    rng = random.Random(43)
    privs = [tt.generate_ed25519_key(rng) for _ in range(2)]
    jwks = [t_jwk.JWK(p.public_key(), kid=f"ed-{i}")
            for i, p in enumerate(privs)]
    jwks.append(t_jwk.JWK(ed.HostEd25519PublicKey(BAD_KEY), kid="ed-bad"))
    tokens, want_rows = [], []
    for j in range(10):
        tok = tt.sign_jwt(privs[j % 2], algs.EdDSA, {"sub": f"u{j}"},
                          kid=f"ed-{j % 2}")
        sig = _sig(tok)
        tokens.append(_with_sig(tok, [sig, sig[:63], sig + b"\0"][j % 3]))
        want_rows.append(j % 2)
    tokens.append(tt.sign_jwt(privs[0], algs.EdDSA, {"sub": "b"},
                              kid="ed-bad"))
    want_rows.append(2)
    ks = GPUBatchKeySet(jwks, device="cpu")
    seen = []
    verify = ed.verify_ed_packed_pending

    def capture(table, rec):
        seen.append((table, rec))
        return verify(table, rec)

    monkeypatch.setattr(ed, "verify_ed_packed_pending", capture)
    out = ks.verify_batch(tokens)
    assert [isinstance(o, dict) for o in out] == \
        [j % 3 == 0 for j in range(10)] + [False]
    (table, rec), = seen
    pad = rec.shape[0]
    assert pad == 128
    fill = pad - len(tokens)
    sigs = [_sig(t) for t in tokens] + [b""] * fill
    msgs = [t.rsplit(".", 1)[0].encode() for t in tokens] + [b""] * fill
    rows = np.asarray(want_rows + [0] * fill, np.int32)
    j_table = j_ed.Ed25519KeyTable(
        [Ed25519PublicKey.from_public_bytes(k) for k in table.key_bytes])
    want = np.asarray(j_ed.ed_packed_records(j_table, sigs, msgs, rows))
    assert rec.dtype == want.dtype and rec.tobytes() == want.tobytes()
