"""An Ed25519 key class of 256 keys, one past the packed record's
one-byte key row: the arrays path (key rows an int64 tensor; the same
edw and redc engine). EdDSA verdicts of GPUBatchKeySet (plain path on
the CPU) bit-equal to the JAX package's TPUBatchKeySet, the path the
batch took counted. The other side of the boundary, 255 keys on the
packed path, is ``test_torch_keyset_arrays_ed255.py`` (this file's
twin but for ``N_KEYS``: the JAX package compiles each side's programs
anew, most of a file's time).

The keys are 7 distinct ones repeated by row (row r holds key r mod 7,
so rows 0, 1 and 255 hold different keys), and each package's per-key
window table is built once per distinct key: the port's table build
keeps one table a distinct key, and the JAX package's table function
is memoized here (results unchanged; its tables are pure-Python point
arithmetic a key)."""

import base64
import random

import pytest
import torch

pytest.importorskip("cryptography")

from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt.tpu_keyset import TPUBatchKeySet  # noqa: E402
from cap_tpu.tpu import ed25519 as j_ed  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.gpu import ed25519 as gpued  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet  # noqa: E402

PATHS = ("verify_ed_packed_pending", "verify_ed25519_batch_pending")
N_KEYS, PATH = 256, "verify_ed25519_batch_pending"
N_DISTINCT = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _memo(mp, owner, name, key):
    real = getattr(owner, name)
    seen = {}

    def memo(*a):
        k = key(*a)
        if k not in seen:
            seen[k] = real(*a)
        return seen[k]

    mp.setattr(owner, name, memo)


@pytest.fixture(autouse=True, scope="module")
def _tables_once_per_key():
    with pytest.MonkeyPatch.context() as mp:
        _memo(mp, j_ed, "_window_triple_rows", lambda pt: pt)
        yield


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _with_sig(token: str, sig: bytes) -> str:
    h, p, _ = token.split(".")
    return f"{h}.{p}.{_b64(sig)}"


def _sig(token: str) -> bytes:
    s = token.split(".")[2]
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return a == b
    return type(a).__name__ == type(b).__name__ and str(a) == str(b)


@pytest.fixture(scope="module")
def keys():
    rng = random.Random(31)
    return [tt.generate_ed25519_key(rng) for _ in range(N_DISTINCT + 1)]


def _batch(keys, n_keys, seed):
    """(labels, reference verdicts, port verdicts, path calls, keyset)
    over a JWKS of ``n_keys`` rows."""
    rng = random.Random(seed)
    doc = {"keys": [t_jwk.serialize_public_key(
        keys[r % N_DISTINCT].public_key(), kid=f"e-{r}")
        for r in range(n_keys)]}

    def sign(row, sub, kid="row", key=None):
        key = keys[row % N_DISTINCT] if key is None else key
        return tt.sign_jwt(key, "EdDSA", {"sub": sub},
                           kid=f"e-{row}" if kid == "row" else kid)

    cases = [("valid", sign(r, f"v-{r}"))
             for r in (0, 1, 6, 7, 200, n_keys - 1)]
    good = cases[-1][1]
    sig = _sig(good)
    s_plus_l = int.from_bytes(sig[32:], "little") + gpued.L_ORDER
    cases += [
        ("tampered", _with_sig(good, sig[:5] + bytes([sig[5] ^ 1])
                               + sig[6:])),
        ("s-ge-l", _with_sig(good, sig[:32]
                             + s_plus_l.to_bytes(32, "little"))),
        ("wrong-length", _with_sig(good, sig[:-1])),
        ("kid-of-other-row", sign(1, "x", kid="e-0")),
        ("no-kid", sign(5, "nk", kid=None)),
        ("unknown-kid-outsider", sign(0, "o", kid="nope",
                                      key=keys[N_DISTINCT])),
    ]
    tokens = [c[1] for c in cases]
    ref = TPUBatchKeySet(j_jwk.parse_jwks(doc)).verify_batch(tokens)
    calls = dict.fromkeys(PATHS, 0)
    with pytest.MonkeyPatch.context() as mp:
        for name in PATHS:
            def count(*a, name=name, real=getattr(gpued, name)):
                calls[name] += 1
                return real(*a)

            mp.setattr(gpued, name, count)
        ks = GPUBatchKeySet(t_jwk.parse_jwks(doc), device="cpu")
        port = ks.verify_batch(tokens)
    return [c[0] for c in cases], ref, port, calls, ks


@pytest.fixture(scope="module")
def batch(keys):
    return _batch(keys, N_KEYS, 32)


def test_verdicts_bit_equal(batch):
    labels, ref, port, _, _ = batch
    diff = [(lab, r, p) for lab, r, p in zip(labels, ref, port)
            if not _same(r, p)]
    assert not diff
    for lab, out in zip(labels, port):
        assert isinstance(out, dict) == (lab in ("valid", "no-kid")), \
            (lab, out)


def test_the_path_the_batch_took(batch):
    """One EdDSA chunk, on the arrays path at 256 keys (the packed path
    at 255)."""
    _, _, _, calls, ks = batch
    assert len(ks._ed_table.keys) == N_KEYS
    assert calls == {p: int(p == PATH) for p in PATHS}
