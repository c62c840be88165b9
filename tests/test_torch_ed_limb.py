"""The limb Ed25519 engine (``gpu.ed25519._ed25519_core``, the entry
points' ``rns=False``) against the JAX package's limb engine, live:
``verify_ed25519_batch`` on both packages over seeded keys and
signatures — valid ones, tampered, S + L, R with y ≥ p, wrong lengths,
a key that does not decode, and the identity-key split of ROADMAP §C
(a forged R = [S]B accepted under the canonical identity key and
rejected under its two non-canonical encodings, which OpenSSL accepts)
— verdicts equal to each other and to the port's oracle; the window
tables byte-equal. The JAX side runs with ``CAP_TPU_RNS=0``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

from cryptography.hazmat.primitives.asymmetric.ed25519 import (  # noqa: E402
    Ed25519PublicKey,
)

from cap_tpu.tpu import ed25519 as jed  # noqa: E402

from cap_tpu_torch.gpu import ed25519 as ed  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [bytes([i + 3]) * 32 for i in range(3)]
BAD_KEY = (2).to_bytes(32, "little")                 # y = 2: not on the curve
IDENTITY = (1).to_bytes(32, "little")                # canonical, order 1
ID_SIGN_SET = (1).to_bytes(31, "little") + b"\x80"   # x = 0 with sign 1
ID_Y_GE_P = (ed.P + 1).to_bytes(32, "little")        # y = p + 1


def _forged(s: int) -> bytes:
    """R = [S]B: verifies under the identity key for any message."""
    return ed.encode_point(ed.scalar_mult(s, ed._B_POINT)) + \
        s.to_bytes(32, "little")


@pytest.fixture(scope="module")
def batch():
    raws = [ed.HostEd25519PublicKey.from_seed(sd).raw for sd in SEEDS] + [
        BAD_KEY, IDENTITY, ID_SIGN_SET, ID_Y_GE_P]
    cases = []                                        # (label, sig, msg, row)
    for j in range(6):
        msg = f"message {j}".encode()
        cases.append(("valid", ed.ed25519_sign(SEEDS[j % 3], msg), msg,
                      j % 3))
    good = cases[0][1]
    flip = bytearray(good)
    flip[40] ^= 0x04
    cases.append(("tampered", bytes(flip), cases[0][2], 0))
    cases.append(("other-message", good, b"not it", 0))
    cases.append(("wrong-key", good, cases[0][2], 1))
    s = int.from_bytes(good[32:], "little")
    cases.append(("s-plus-l", good[:32] + (s + ed.L_ORDER).to_bytes(
        32, "little"), cases[0][2], 0))
    r_big = bytearray((ed.P + 1).to_bytes(32, "little"))
    r_big[31] |= good[31] & 0x80
    cases.append(("r-y-ge-p", bytes(r_big) + good[32:], cases[0][2], 0))
    cases.append(("short", good[:63], cases[0][2], 0))
    cases.append(("long", good + b"\0", cases[0][2], 0))
    cases.append(("undecodable-key", good, cases[0][2], 3))
    for row, label in ((4, "identity-canonical"), (5, "identity-sign-set"),
                       (6, "identity-y-ge-p")):
        cases.append((label, _forged(123456789 + row), b"any", row))
    labels = [c[0] for c in cases]
    sigs = [c[1] for c in cases]
    msgs = [c[2] for c in cases]
    rows = np.asarray([c[3] for c in cases], np.int64)

    jtab = jed.Ed25519KeyTable([Ed25519PublicKey.from_public_bytes(r)
                                for r in raws])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "0")
        ref = jed.verify_ed25519_batch(jtab, sigs, msgs, rows.astype(np.int32))
    table = ed.Ed25519KeyTable([ed.HostEd25519PublicKey(r) for r in raws],
                               device="cpu")
    port = ed.verify_ed25519_batch(table, sigs, msgs, rows, rns=False)
    oracle = [ed.py_ed25519_verify(raws[r], sg, m)
              for sg, m, r in zip(sigs, msgs, rows)]
    return dict(labels=labels, ref=ref, port=port, oracle=oracle,
                jtab=jtab, table=table)


def test_verdicts_equal_the_jax_limb_engine_and_the_oracle(batch):
    port = [bool(v) for v in batch["port"]]
    ref = [bool(v) for v in batch["ref"]]
    assert port == ref == batch["oracle"], [
        (lab, p, r, o) for lab, p, r, o in zip(batch["labels"], port, ref,
                                                batch["oracle"])
        if not p == r == o]


def test_identity_key_split(batch):
    """The forged token verifies under the canonical identity key only:
    both device ladders reject the two encodings OpenSSL decodes."""
    got = dict(zip(batch["labels"], batch["port"]))
    assert got["identity-canonical"]
    assert not got["identity-sign-set"] and not got["identity-y-ge-p"]
    assert sum(batch["port"]) == 7           # 6 valid + the canonical


def test_window_tables_byte_equal(batch):
    for t, ref in zip(batch["table"].tna(), batch["jtab"].tna):
        assert (t.numpy() == np.asarray(ref)).all()
    for t, ref in zip(ed.b_table("cpu"), jed.b_table()):
        assert (t.numpy() == np.asarray(ref)).all()


def test_tna_is_lazy():
    table = ed.Ed25519KeyTable([ed.HostEd25519PublicKey.from_seed(SEEDS[0])],
                               device="cpu")
    assert table._tna is None and table._rns is None
