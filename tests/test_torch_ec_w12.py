"""The 12-bit-window ES ladder (``w_bits=12`` of ``gpu.ec``'s entry
points, the JAX package's ``CAP_TPU_EC_WBITS=12``) against the JAX
package, live: ``ec_rns._digits_of`` at 12 bits (digits that straddle
limbs) equal to the JAX function on seeded limbs; the 12-bit window
tables byte-equal to the JAX package's (P-256 with 2 keys: 22·3·4,095
rows; P-384 with 1 key); ``verify_ecdsa_batch(..., w_bits=12)`` on the
P-256 edge vectors (``testing.ec_edge_vectors``) on the Jacobian ladder
equal to the JAX entry point under ``CAP_TPU_RNS=1`` and
``CAP_TPU_EC_WBITS=12`` and to both oracles, the true degeneracies
flagged; the 12-bit and 8-bit ``ladder_ref`` giving the same points on
the same scalars (CRT, mod p); ``convert.ec_key_table`` carrying a JAX
12-bit table. The affine ladder at 12 bits is
``tests/test_torch_ec_w12_affine.py``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap_tpu.tpu import ec as jec
from cap_tpu.tpu import ec_rns as jrns

from cap_tpu_torch import convert
from cap_tpu_torch import testing as tt
from cap_tpu_torch.gpu import cuda_ladder
from cap_tpu_torch.gpu import ec as gpuec
from cap_tpu_torch.gpu import ec_rns

W12 = {"P-256": 22, "P-384": 32, "P-521": 44}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkey(crv, key):
    nums = key.public_numbers()
    return jec.HostECPublicKey(crv, nums.x, nums.y)


def _privs(crv, n, seed):
    rng = random.Random(seed)
    return [tt.generate_ec_key(rng, crv) for _ in range(n)]


def _keys(crv, n, seed):
    return [k.public_key() for k in _privs(crv, n, seed)]


@pytest.mark.parametrize("crv", sorted(W12))
def test_context_windows_at_12_bits(crv):
    c = ec_rns.ctx_for(crv, 12)
    assert (c.w_bits, c.n_windows) == (12, W12[crv])
    assert (c.n_windows, c.w_bits) == (jrns.ctx_for(crv, 12).n_windows,
                                       jrns.ctx_for(crv, 12).w_bits)
    assert ec_rns.ctx_for(crv) is ec_rns.ctx_for(crv, 8) is not c
    with pytest.raises(ValueError, match="window width"):
        ec_rns.ctx_for(crv, 17)


@pytest.mark.parametrize("crv", sorted(W12))
def test_digits_of_equal_jax_at_12_bits(crv):
    """Seeded 16-bit limbs (the top limb full, so the last window's
    spill into the appended zero limb shows) cut into 12-bit digits,
    two of every three straddling a limb boundary."""
    k = gpuec.curve(crv).k
    rng = np.random.default_rng(12 + k)
    u = rng.integers(0, 1 << 16, (k, 96)).astype(np.int64)
    u[-1, :8] = 0xFFFF
    n_win = W12[crv]
    port = ec_rns._digits_of(torch.from_numpy(u), 12, n_win).numpy()
    ref = np.asarray(jrns._digits_of(jnp.asarray(u.astype(np.uint32)), 12,
                                     n_win))
    assert port.dtype == np.int32 and port.shape == (n_win, 96)
    assert np.array_equal(port, ref)
    assert port.max() == 4095


@pytest.fixture(scope="module")
def p256_tables():
    keys = _keys("P-256", 2, 256)
    ref = jrns.ECRNSKeyTable("P-256", [_jkey("P-256", k) for k in keys],
                             w_bits=12)
    port = ec_rns.ECRNSKeyTable("P-256", keys, w_bits=12)
    return keys, ref, port


def test_p256_table_bytes_equal_jax_at_12_bits(p256_tables):
    _, ref, port = p256_tables
    want = np.asarray(ref.tab)
    assert port.tab.shape == (22 * 3 * 4095, 46) == want.shape
    assert port.tab.dtype == want.dtype == np.int32
    assert port.tab.tobytes() == want.tobytes()
    assert port.ctx is ec_rns.ctx_for("P-256", 12)


def test_p384_table_rows_equal_jax_at_12_bits():
    keys = _keys("P-384", 1, 384)
    ref = np.asarray(jrns.ECRNSKeyTable(
        "P-384", [_jkey("P-384", keys[0])], w_bits=12).tab)
    port = ec_rns.ECRNSKeyTable("P-384", keys, w_bits=12).tab
    assert port.shape == (32 * 2 * 4095, 68) == ref.shape
    assert port.tobytes() == ref.tobytes()


@pytest.fixture(scope="module")
def edge():
    """The P-256 edge vectors through both packages at 12 bits: the
    port's verdicts and raw (ok, deg), the JAX entry point's, both
    oracles'."""
    key, names, sigs, digs = tt.ec_edge_vectors("P-256")
    jtab = jec.ECKeyTable("P-256", [_jkey("P-256", key)])
    rows = np.zeros(len(sigs), np.int64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAP_TPU_RNS", "1")
        mp.setenv("CAP_TPU_EC_WBITS", "12")
        jax_ok = jec.verify_ecdsa_batch(jtab, sigs, digs,
                                        rows.astype(np.int32),
                                        ladder="jacobian")
        assert jtab.rns().ctx.w_bits == 12
    table = gpuec.ECKeyTable("P-256", [key], device="cpu")
    raw = []
    pending = gpuec.verify_ecdsa_arrays_pending

    def record(*a, **k):
        ok, deg = pending(*a, **k)
        raw.append((ok.numpy()[:len(sigs)], deg.numpy()[:len(sigs)]))
        return ok, deg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpuec, "verify_ecdsa_arrays_pending", record)
        port_ok = gpuec.verify_ecdsa_batch(table, sigs, digs, rows,
                                           w_bits=12)
    return dict(names=names, sigs=sigs, digs=digs, table=table,
                jax_ok=[bool(v) for v in jax_ok],
                port_ok=[bool(v) for v in port_ok], raw=raw[0],
                want=[gpuec._py_verify_one(table, 0, s, d)
                      for s, d in zip(sigs, digs)],
                jwant=[jec._py_verify_one(jtab, 0, s, d)
                       for s, d in zip(sigs, digs)])


def test_w12_verdicts_equal_jax_and_both_oracles(edge):
    assert edge["port_ok"] == edge["jax_ok"] == edge["want"] \
        == edge["jwant"], [
            (n, p, j, w) for n, p, j, w in zip(
                edge["names"], edge["port_ok"], edge["jax_ok"],
                edge["want"]) if not p == j == w]
    assert any(edge["want"]) and not all(edge["want"])


def test_w12_true_degeneracies_flagged(edge):
    """The merge's doubling and inverse raise the same-x flag; outside
    the flagged lanes the device accepts what the oracle accepts."""
    ok, deg = edge["raw"]
    assert {"deg-double-merge", "deg-inverse-merge"} <= {
        n for n, f in zip(edge["names"], deg) if f}
    want = np.asarray(edge["want"])
    assert (ok[~deg] == want[~deg]).all()


def test_w12_table_kept_beside_the_8_bit_one(edge):
    table = edge["table"]
    assert sorted(table._rns) == [12]
    ok8 = gpuec.verify_ecdsa_batch(table, edge["sigs"], edge["digs"],
                                   np.zeros(len(edge["sigs"]), np.int64))
    assert [bool(v) for v in ok8] == edge["want"]
    assert sorted(table._rns) == [8, 12]
    assert table.rns(12).ctx.n_windows == 22
    assert table.rns().ctx.n_windows == 32


def _affine(c, X, Y, Z, inf):
    """Host affine points of the ladder's A-domain Jacobian planes: x =
    X̃·A / Z̃², y = Ỹ·A² / Z̃³ mod p (the A factors cancel), None at
    infinity."""
    p = c.cp.p
    a = c.A.prod % p
    out = []
    for j in range(X[0].shape[1]):
        if inf[j]:
            out.append(None)
            continue
        x, y, z = (c.value_of(v[0][:, j].numpy()) % p for v in (X, Y, Z))
        zi = pow(z, -1, p)
        out.append((x * a * zi * zi % p, y * a * a * zi * zi * zi % p))
    return out


def test_ladder_ref_12_bit_points_equal_the_8_bit_ones(p256_tables):
    """On the same scalars (u1 on G's slot, u2 on a key's), the 12-bit
    and the 8-bit plain ladders reach the same affine points, and both
    equal the host scalar multiple."""
    keys, _, port12 = p256_tables
    port8 = ec_rns.ECRNSKeyTable("P-256", keys)
    cp = gpuec.curve("P-256")
    rng = random.Random(812)
    m = 16
    scalars = [rng.randrange(1, cp.n) for _ in range(m)]
    slots = [0] * (m // 2) + [1 + (j % 2) for j in range(m - m // 2)]
    limbs = torch.tensor([[(s >> (16 * i)) & 0xFFFF for s in scalars]
                          for i in range(cp.k)], dtype=torch.int64)
    points = {}
    for rt in (port8, port12):
        c = rt.ctx
        per = (1 << c.w_bits) - 1
        d = ec_rns._digits_of(limbs, c.w_bits, c.n_windows)
        base = torch.tensor([s * per for s in slots], dtype=torch.int32)
        X, Y, Z, inf, deg = cuda_ladder.ladder_ref(
            c, torch.from_numpy(rt.tab), d, base, (rt.nk + 1) * per)
        assert not deg.any()
        points[c.w_bits] = _affine(c, X, Y, Z, inf.numpy())
    pts = [(cp.gx, cp.gy)] + [(k.public_numbers().x, k.public_numbers().y)
                              for k in keys]
    want = [gpuec.scalar_mult(cp, s, pts[sl])
            for s, sl in zip(scalars, slots)]
    assert points[12] == points[8] == want


def test_convert_carries_a_jax_12_bit_table(p256_tables, edge):
    """``convert.ec_key_table`` takes the JAX 12-bit table at its
    context's width (``w_bits`` in the context arrays): the table
    serves ``rns(12)`` byte-equal, and its verdicts at ``w_bits=12``
    are the port's own and the oracle's."""
    keys, ref, port = p256_tables
    arrays = {b: {k: np.asarray(getattr(ref.ctx, b)[k])
                  for k in ("m", "m_f", "inv_f", "inv_Mi")}
              for b in ("dA", "dB")}
    for w in ("W_AB", "W_BA"):
        arrays[w] = tuple(np.asarray(h, np.float32)
                          for h in getattr(ref.ctx, w))
    for n in ("Amod_B", "Bmod_A", "invA_B", "sig_c", "p_B", "cp_A",
              "cp_B"):
        arrays[n] = np.asarray(getattr(ref.ctx, n))
    arrays["w_bits"] = ref.ctx.w_bits
    conv = convert.ec_key_table("P-256", keys, arrays, np.asarray(ref.tab),
                                device="cpu")
    assert sorted(conv._rns) == [12]
    assert conv.rns(12).tab.tobytes() == port.tab.tobytes()
    assert conv.rns(12).ctx.n_windows == 22
    cp = gpuec.curve("P-256")
    rng = random.Random(1212)
    sigs, digs, rows = [], [], []
    for row, priv in enumerate(_privs("P-256", 2, 256)):
        dig = rng.randbytes(32)
        r, s_ = gpuec.host_ecdsa_sign("P-256", priv.d,
                                      int.from_bytes(dig, "big"),
                                      rng.randrange(1, cp.n))
        sig = r.to_bytes(32, "big") + s_.to_bytes(32, "big")
        sigs += [sig, sig[:-1] + bytes([sig[-1] ^ 1])]
        digs += [dig, dig]
        rows += [row, row]
    sigs.append(sigs[0])                      # the other key's row
    digs.append(digs[0])
    rows.append(1)
    own = gpuec.ECKeyTable("P-256", keys, device="cpu")
    got = [gpuec.verify_ecdsa_batch(t, sigs, digs, np.asarray(rows),
                                    w_bits=12).tolist() for t in (conv, own)]
    assert got[0] == got[1] == [True, False, True, False, False]
    with pytest.raises(ValueError, match="tab"):
        convert.ec_key_table("P-256", keys, dict(arrays, w_bits=8),
                             np.asarray(ref.tab), device="cpu")


def test_ladder_wrapper_refuses_a_table_past_the_kernels_row_index():
    """The kernel forms row indices in int: the wrapper admits the
    largest 12-bit table a keyset could build (P-521, G + 300 keys:
    54,234,180 rows) and refuses 2^31 rows (shapes only, on the meta
    device)."""
    c = ec_rns.ctx_for("P-521", 12)
    iap = ec_rns.packed_cols(c)
    per = 4095
    meta = dict(dtype=torch.int32, device="meta")

    def args(rows, stride):
        return (torch.empty((rows, 2 * iap), **meta),
                torch.empty((c.n_windows, 128), **meta),
                torch.empty((128,), **meta), stride)

    rows = c.n_windows * 301 * per
    assert rows == 54_234_180
    cuda_ladder._check_args(c, *args(rows, 301 * per))
    with pytest.raises(ValueError, match="exceeds the kernel"):
        cuda_ladder._check_args(c, *args(1 << 31, 301 * per))
