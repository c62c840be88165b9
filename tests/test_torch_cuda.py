"""The CUDA kernels on the card: ragged lane counts against the plain
versions (keccak also at the SLH-DSA path's [m, 35 | 33 | 14] state
counts), the launch counters, the wrappers' refusals, the device
SHA-384/512 against hashlib, the SLH-DSA engine against its CPU path,
the keyset on the card against the keyset on the CPU (RS256 +
ES256, ES256 + ES384 and ES512 with either ladder, PS256 + EdDSA,
ML-DSA-44 + ML-DSA-65, ML-DSA-87, PS384 + PS512 + SLH-DSA, and classes
of 256 and 300 RSA, P-256 and Ed25519 keys on the arrays paths),
``Validator.validate_batch`` over the card keyset against the CPU, with
an x5c JWKS loaded through discovery, the limb engine's modexps
against the CPU (a 9,216-bit modulus against the host oracle), and
``verify_batch_raw`` and the OIDC ``Provider.verify_id_token_batch``
(dict and raw modes, through discovery at the in-process TLS IdP)
over the card keyset against the CPU, ``KeyPlaneKeySet`` on the card
against the CPU across a rotation, a ``WorkerPool`` of a card
worker and a CPU worker behind ``FleetClient``, and a ``FrontDoor``
over a card worker and a CPU worker behind both gates.

Marked ``cuda``: without a card each test skips. On the card's machine
(no jax there, so without the suite's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cap_tpu_torch.gpu import cuda_edw, cuda_keccak, cuda_ladder, cuda_madd
from cap_tpu_torch.gpu import cuda_ntt, cuda_redc, ec_rns, ed25519_rns
from cap_tpu_torch.gpu import keccak, ntt, rns

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc for the kernels)")
    return torch.device("cuda")


def _residues(c, vals):
    a = np.array([[v % int(m) for m in c.A.m] for v in vals], np.int32)
    b = np.array([[v % int(m) for m in c.B.m] for v in vals], np.int32)
    return np.ascontiguousarray(a.T), np.ascontiguousarray(b.T)


def _rand(rng, bound, n):
    nbytes = (bound.bit_length() + 71) // 8
    return [int.from_bytes(rng.bytes(nbytes), "big") % bound
            for _ in range(n)]


def _crt(base, col):
    return sum(int(r) * int(inv) % int(m) * mi for r, inv, m, mi in
               zip(col, base.inv_Mi, base.m, base.Mi)) % base.prod


def _same_values(c, kernel, plain):
    """Both planes of a (A, B) residue pair equal the plain version's by
    value mod p (CRT over base A and base B), and the kernel's A and B
    planes hold one integer, on every lane that is not bit-equal."""
    (ka, kb), (pa, pb) = [[t.cpu().numpy() for t in pair]
                          for pair in (kernel, plain)]
    p = c.p_int
    diff = np.nonzero((ka != pa).any(axis=0) | (kb != pb).any(axis=0))[0]
    for j in diff:
        va, vb = _crt(c.A, ka[:, j]), _crt(c.B, kb[:, j])
        if va != vb or (va - _crt(c.A, pa[:, j])) % p or \
                (vb - _crt(c.B, pb[:, j])) % p:
            return False
    return True


# lane counts around the RNS kernels' lane groups: a warp holds 32/T
# lanes and a block 128/T (T = 2, 4 or 8 threads a lane)
GROUP_EDGES = [3, 5, 7, 9, 15, 17, 31, 33, 63, 65]


# 70,001 lanes: more 16-lane tiles than the card holds redc blocks, so
# blocks walk over several
@pytest.mark.parametrize("n", [1, 127, 129, 1000, 15, 17, 33, 70001])
def test_redc_kernel_matches_plain(dev, n):
    c = ec_rns.ctx_for("P-256")
    rng = np.random.default_rng(n)
    p = c.p_int
    xa, xb = _residues(c, [u * v for u, v in zip(_rand(rng, 3 * p, n),
                                                   _rand(rng, 3 * p, n))])
    xA, xB = torch.from_numpy(xa).to(dev), torch.from_numpy(xb).to(dev)
    before = cuda_redc.launches
    tA, tB = cuda_redc.redc(c, xA, xB)
    rA, rB = cuda_redc.redc_ref(c, xA, xB)
    torch.cuda.synchronize()
    assert cuda_redc.launches == before + 1
    assert _same_values(c, (tA, tB), (rA, rB))
    # the B residues carry the value of the A residues
    ka = tA.cpu().numpy()
    _, b_of_a = _residues(c, [c.value_of(ka[:, j]) for j in range(n)])
    assert np.array_equal(tB.cpu().numpy(), b_of_a)


@pytest.mark.parametrize("n", [1, 127, 129, 1000] + GROUP_EDGES)
def test_madd_kernel_matches_plain(dev, n):
    c = ec_rns.ctx_for("P-256")
    rng = np.random.default_rng(100 + n)
    p = c.p_int
    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    planes = [tuple(T(a) for a in _residues(c, _rand(rng, b * p, n)))
              for b in (15, 11, 11)]

    def packed():
        a, b = _residues(c, _rand(rng, p, n))
        return T(a | (b << 16))

    x2p, y2p = packed(), packed()
    has = T(rng.integers(0, 2, n).astype(bool))
    inf = T(rng.integers(0, 2, n).astype(bool))
    before = cuda_madd.launches
    out_k = cuda_madd.madd(c, *planes, inf, has, x2p, y2p)
    out_p = cuda_madd.madd_ref(c, *planes, inf, has, x2p, y2p)
    torch.cuda.synchronize()
    assert cuda_madd.launches == before + 1
    for kk, pp in zip(out_k[:3], out_p[:3]):
        assert _same_values(c, kk, pp)
    assert not out_k[3][~has | inf].any()


def _edw_case(c, n, rng, dev, n_rows=97):
    """States X, Y, Z, T < 3p, a packed table of random triples < p
    ([n_rows, 3·iap]) and random rows of it."""
    p = c.p_int
    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    state = [tuple(T(a) for a in _residues(c, _rand(rng, 3 * p, n)))
             for _ in range(4)]
    tab = np.concatenate([(a | (b << 16)).T for a, b in
                          (_residues(c, _rand(rng, p, n_rows))
                           for _ in range(3))], axis=1)
    rows = rng.integers(0, n_rows, n).astype(np.int32)
    return state, T(np.ascontiguousarray(tab)), T(rows)


@pytest.mark.parametrize("n", [1, 127, 129, 1000, 7, 9, 15, 17, 33])
def test_edw_kernel_matches_plain(dev, n):
    c = ed25519_rns.ctx()
    state, tab, rows = _edw_case(c, n, np.random.default_rng(200 + n), dev)
    before = cuda_edw.launches
    out_k = cuda_edw.edw_window(c, *state, tab, rows)
    out_p = cuda_edw.edw_window_ref(c, *state, tab, rows)
    torch.cuda.synchronize()
    assert cuda_edw.launches == before + 1
    for kk, pp in zip(out_k, out_p):
        assert _same_values(c, kk, pp)


def test_edw_wrapper_refuses_what_the_kernel_does_not_take(dev):
    c = ed25519_rns.ctx()
    state, tab, rows = _edw_case(c, 256, np.random.default_rng(1), dev)
    a, b = state[3]
    wide = torch.zeros((tab.shape[0], 2 * tab.shape[1]), dtype=torch.int32,
                       device=dev)
    for args in ((*state[:3], (a.to(torch.int64), b), tab, rows),
                 (*state[:3], (a[:, ::2], b[:, ::2]), tab, rows),
                 (*state[:3], (a[:, :128], b[:, :128]), tab, rows),
                 (*state[:3], (a.cpu(), b.cpu()), tab, rows),
                 (*state, tab.to(torch.int64), rows),
                 (*state, wide[:, :tab.shape[1]], rows),
                 (*state, tab[:, :-1].contiguous(), rows),
                 (*state, tab.cpu(), rows),
                 (*state, tab, rows.cpu()),
                 (*state, tab, rows.to(torch.int64)),
                 (*state, tab, rows[:128])):
        with pytest.raises(ValueError):
            cuda_edw.edw_window(c, *args)
    with pytest.raises(NotImplementedError):
        cuda_edw.edw_window(ec_rns.ctx_for("P-384"), *state, tab, rows)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    c = ec_rns.ctx_for("P-256")
    ia, ib = c.A.count, c.B.count
    good = torch.zeros((ia, 256), dtype=torch.int32, device=dev)
    goodb = torch.zeros((ib, 256), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cuda_redc.redc(c, good.to(torch.int64), goodb)
    with pytest.raises(ValueError):
        cuda_redc.redc(c, good[:, ::2], goodb[:, ::2])
    with pytest.raises(ValueError):
        cuda_redc.redc(c, good[:5], goodb)
    # a context whose channel counts no kernel is instantiated for
    p192 = rns.FieldRNSContext((1 << 192) - (1 << 64) - 1, 12)
    with pytest.raises(NotImplementedError):
        cuda_redc.redc(p192, good, goodb)


@pytest.mark.parametrize("n", [127, 1000, 7, 9, 31, 33])
@pytest.mark.parametrize("crv", ["P-384", "P-521"])
def test_wide_redc_and_madd_kernels_match_plain(dev, crv, n):
    """The REDC and mixed-add kernels at 34+33 and 45+45 channels."""
    c = ec_rns.ctx_for(crv)
    rng = np.random.default_rng(500 + n)
    p = c.p_int
    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xa, xb = _residues(c, [u * v for u, v in zip(_rand(rng, 3 * p, n),
                                                   _rand(rng, 3 * p, n))])
    xA, xB = T(xa), T(xb)
    before = (cuda_redc.launches, cuda_madd.launches)
    got = cuda_redc.redc(c, xA, xB)
    assert _same_values(c, got, cuda_redc.redc_ref(c, xA, xB))
    planes = [tuple(T(a) for a in _residues(c, _rand(rng, b * p, n)))
              for b in (15, 11, 11)]
    iap = max(c.A.count, c.B.count)

    def packed():
        a, b = _residues(c, _rand(rng, p, n))
        w = np.zeros((iap, n), np.int32)
        w[:c.A.count] = a
        w[:c.B.count] |= b << 16
        return T(w)

    x2p, y2p = packed(), packed()
    has = T(rng.integers(0, 2, n).astype(bool))
    inf = T(rng.integers(0, 2, n).astype(bool))
    out_k = cuda_madd.madd(c, *planes, inf, has, x2p, y2p)
    out_p = cuda_madd.madd_ref(c, *planes, inf, has, x2p, y2p)
    torch.cuda.synchronize()
    assert (cuda_redc.launches - before[0],
            cuda_madd.launches - before[1]) == (1, 1)
    for kk, pp in zip(out_k[:3], out_p[:3]):
        assert _same_values(c, kk, pp)
    assert not out_k[3][~has | inf].any()


def _ladder_case(c, n, rng):
    """A whole-ladder input over a random table of G and one key slot,
    digits with 10% zeros, lanes 0..3 at infinity and every 9th lane a
    planted same-x degeneracy (``testing.ladder_inputs``)."""
    from cap_tpu_torch import testing as tt

    return tt.ladder_inputs(c, c.n_windows, n, 1, rng, at_inf=4,
                            plant_every=9, zero_share=0.1)


@pytest.mark.parametrize("n", [1, 127, 129, 4097, 7, 9, 31, 33])
@pytest.mark.parametrize("crv", ["P-256", "P-384", "P-521"])
def test_ladder_kernel_matches_plain(dev, crv, n):
    c = ec_rns.ctx_for(crv)
    rng = np.random.default_rng(600 + n)
    tab, d, base, stride, true_deg = _ladder_case(c, n, rng)
    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    args = (T(tab), T(d), T(base), stride)
    before = cuda_ladder.launches
    out_k = cuda_ladder.ladder(c, *args)
    out_p = cuda_ladder.ladder_ref(c, *args)
    torch.cuda.synchronize()
    assert cuda_ladder.launches == before + 1
    for kk, pp in zip(out_k[:3], out_p[:3]):
        assert _same_values(c, kk, pp)
    assert torch.equal(out_k[3], out_p[3])
    deg = out_k[4].cpu().numpy()
    assert deg[true_deg].all() and out_p[4].cpu().numpy()[true_deg].all()
    assert not out_k[4][out_k[3]].any()


def test_ladder_wrapper_refuses_what_the_kernel_does_not_take(dev):
    c = ec_rns.ctx_for("P-256")
    tab, d, base, stride, _ = _ladder_case(c, 64, np.random.default_rng(1))
    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    tab, d, base = T(tab), T(d), T(base)
    for args in ((tab.to(torch.int64), d, base), (tab, d.cpu(), base),
                 (tab, d[:, ::2], base[::2]), (tab[:, :-1], d, base)):
        with pytest.raises(ValueError):
            cuda_ladder.ladder(c, *args, stride)
    p192 = rns.FieldRNSContext((1 << 192) - (1 << 64) - 1, 12)
    with pytest.raises((NotImplementedError, ValueError)):
        cuda_ladder.ladder(p192, tab, d, base, stride)


def _degenerate_token(kid: str, inverse: bool, rng):
    """An ES256 token whose ladder chains meet at the merge (the key
    is derived from the token: Q = (±e/r)·G), so the same-x flag sends
    it to the oracle: the doubling case verifies, the inverse case
    (sum at infinity) does not."""
    import hashlib
    import json

    from cap_tpu_torch.gpu.ec import HostECPublicKey, curve, scalar_mult
    from cap_tpu_torch.jwt.jose import b64url_encode
    from cap_tpu_torch.jwt.jwk import JWK

    cp = curve("P-256")
    si = (b64url_encode(json.dumps({"alg": "ES256", "kid": kid}).encode())
          + "." + b64url_encode(b'{"sub":"%s"}' % kid.encode()))
    e = int.from_bytes(hashlib.sha256(si.encode()).digest(), "big")
    k = rng.randrange(1, cp.n)
    r = scalar_mult(cp, k, (cp.gx, cp.gy))[0] % cp.n
    d = (-e if inverse else e) * pow(r, -1, cp.n) % cp.n
    s = (rng.randrange(1, cp.n) if inverse
         else pow(k, -1, cp.n) * (e + r * d) % cp.n)
    sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    return (JWK(HostECPublicKey.from_private("P-256", d), kid=kid),
            si + "." + b64url_encode(sig))


def test_keyset_on_the_card_matches_the_plain_path(dev):
    import random

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet

    jwks, tokens, _ = tt.headline_fixtures(48, seed=5)
    rng = random.Random(5)
    bad = [t[:-4] + ("AAAA" if t[-4:] != "AAAA" else "BBBB")
           for t in rng.sample(tokens, 6)]
    dbl_key, dbl = _degenerate_token("deg-dbl", False, rng)
    inv_key, inv = _degenerate_token("deg-inv", True, rng)
    jwks = jwks + [dbl_key, inv_key]
    batch = tokens + bad + ["a.b", dbl, inv]
    card_ks = GPUBatchKeySet(jwks)
    on_card = card_ks.verify_batch(batch)
    on_cpu = GPUBatchKeySet(jwks, device="cpu").verify_batch(batch)
    assert [repr(x) if isinstance(x, Exception) else x for x in on_card] \
        == [repr(x) if isinstance(x, Exception) else x for x in on_cpu]
    assert sum(isinstance(x, dict) for x in on_card) == len(tokens) + 1
    assert on_card[-2] == {"sub": "deg-dbl"}
    assert card_ks.deg_reverified == 2


@pytest.mark.parametrize("whole", [True, False],
                         ids=["whole-ladder", "per-window"])
@pytest.mark.parametrize("family", ["ES256 ES384", "ES512"])
def test_es_keysets_on_the_card_match_the_plain_path(dev, family, whole,
                                                      monkeypatch):
    """ES256 + ES384 (8 P-256 and 8 P-384 keys, one chunk each) and
    ES512 (2 P-521 keys, one chunk), with the keyset's own ladder (one
    whole-ladder launch a chunk, no madd) or with the per-window one
    swapped in (32, 48 or 66 madd launches a chunk); 11 REDC launches a
    chunk either way (the merge and the projective check)."""
    import random

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet

    if family == "ES512":
        jwks, tokens, _ = tt.es512_fixtures(24, seed=8)
        curves = ["P-521"]
    else:
        jwks, tokens, _ = tt.config3_fixtures(32, seed=8)
        curves = ["P-256", "P-384"]
    if not whole:
        monkeypatch.setattr(cuda_ladder, "ladder", ec_rns.ladder_per_window)
    ctxs = [ec_rns.ctx_for(crv) for crv in curves]
    rng = random.Random(8)
    bad = [t[:-4] + ("AAAA" if t[-4:] != "AAAA" else "BBBB")
           for t in rng.sample(tokens, 6)]
    batch = tokens + bad + ["a.b"]
    card_ks = GPUBatchKeySet(jwks)
    before = (cuda_madd.launches, cuda_ladder.launches, cuda_redc.launches)
    on_card = card_ks.verify_batch(batch)
    torch.cuda.synchronize()
    want = (0 if whole else sum(c.n_windows for c in ctxs),
            len(ctxs) if whole else 0, 11 * len(ctxs))
    assert (cuda_madd.launches - before[0],
            cuda_ladder.launches - before[1],
            cuda_redc.launches - before[2]) == want
    on_cpu = GPUBatchKeySet(jwks, device="cpu").verify_batch(batch)
    assert [repr(x) if isinstance(x, Exception) else x for x in on_card] \
        == [repr(x) if isinstance(x, Exception) else x for x in on_cpu]
    assert sum(isinstance(x, dict) for x in on_card) == len(tokens)


def test_config4_keyset_on_the_card_matches_the_plain_path(dev):
    """PS256 + EdDSA: the card (32 edw launches per Ed chunk, 3 REDC
    launches for the merge) against the plain path on the CPU."""
    import random

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu.ed25519 import HostEd25519PublicKey
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.jwt.jwk import JWK

    jwks, tokens, _ = tt.config4_fixtures(48, seed=6)
    jwks = jwks + [JWK(HostEd25519PublicKey((2).to_bytes(32, "little")),
                       kid="ed-bad")]
    rng = random.Random(6)
    bad = [t[:-4] + ("AAAA" if t[-4:] != "AAAA" else "BBBB")
           for t in rng.sample(tokens, 6)]
    batch = tokens + bad + ["a.b"]
    card_ks = GPUBatchKeySet(jwks)
    before = (cuda_edw.launches, cuda_redc.launches)
    on_card = card_ks.verify_batch(batch)
    torch.cuda.synchronize()
    assert (cuda_edw.launches - before[0],
            cuda_redc.launches - before[1]) == (32, 3)
    on_cpu = GPUBatchKeySet(jwks, device="cpu").verify_batch(batch)
    assert [repr(x) if isinstance(x, Exception) else x for x in on_card] \
        == [repr(x) if isinstance(x, Exception) else x for x in on_cpu]
    assert sum(isinstance(x, dict) for x in on_card) == len(tokens)


# state counts around the keccak kernel's warps (one state each) and
# blocks (4 states), and the ML-DSA chunk's 1,024
@pytest.mark.parametrize("n", [1, 127, 129, 1000, 2, 5, 6, 7, 31, 33, 1023,
                               1024, 1025])
def test_keccak_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(300 + n)
    words = rng.integers(0, 2 ** 32, (n, 25, 2), dtype=np.uint64)
    words[0] = 0
    s = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    before = cuda_keccak.launches
    got = cuda_keccak.f1600(s)
    want = keccak.f1600_plain(s)
    torch.cuda.synchronize()
    assert cuda_keccak.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("lead", [(2, 512), (4, 8, 33)],
                         ids=["2x512", "4x8x33"])
def test_keccak_kernel_matches_plain_on_folded_leading_axes(dev, lead):
    """[2, 512, 25, 2] and a ragged [4, 8, 33, 25, 2] batch, all ones
    and all zeros among seeded states."""
    rng = np.random.default_rng(310 + len(lead))
    words = rng.integers(0, 2 ** 32, lead + (25, 2), dtype=np.uint64)
    words.reshape(-1, 25, 2)[0] = 0
    words.reshape(-1, 25, 2)[-1] = 2 ** 32 - 1
    s = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    before = cuda_keccak.launches
    got = cuda_keccak.f1600(s)
    want = keccak.f1600_plain(s)
    torch.cuda.synchronize()
    assert cuda_keccak.launches == before + 1
    assert got.shape == s.shape and torch.equal(got, want)


# rows around the forward kernel's blocks (4 rows, one a warp)
@pytest.mark.parametrize("rows", [1, 3, 5, 1001, 7, 9, 4096])
def test_ntt_kernels_match_plain(dev, rows):
    rng = np.random.default_rng(400 + rows)
    x = rng.integers(0, ntt.Q, (rows, 256), dtype=np.int64)
    x[0, :4] = [0, ntt.Q - 1, 0, ntt.Q - 1]
    t = torch.from_numpy(x.astype(np.int32)).to(dev)
    before = (cuda_ntt.ntt_launches, cuda_ntt.intt_launches)
    fwd, inv = cuda_ntt.ntt(t), cuda_ntt.intt(t)
    torch.cuda.synchronize()
    assert (cuda_ntt.ntt_launches - before[0],
            cuda_ntt.intt_launches - before[1]) == (1, 1)
    assert torch.equal(fwd, ntt.ntt_plain(t))
    assert torch.equal(inv, ntt.intt_plain(t))
    assert torch.equal(cuda_ntt.intt(fwd), t)


def test_ntt_kernel_matches_plain_at_the_path_shape(dev):
    """NTT(z) of a 1,024-token ML-DSA-65 chunk: [1024, 5, 256]."""
    rng = np.random.default_rng(450)
    x = rng.integers(0, ntt.Q, (1024, 5, 256), dtype=np.int64)
    x[0, 0], x[-1, -1] = 0, ntt.Q - 1
    t = torch.from_numpy(x.astype(np.int32)).to(dev)
    before = cuda_ntt.ntt_launches
    got = cuda_ntt.ntt(t)
    torch.cuda.synchronize()
    assert cuda_ntt.ntt_launches == before + 1
    assert got.shape == t.shape and torch.equal(got, ntt.ntt_plain(t))
    assert torch.equal(cuda_ntt.intt(got), t)


# intt's input at the path's shapes: [1024, k, 256] for ML-DSA-44, -65
# and -87
@pytest.mark.parametrize("k", [4, 6, 8])
def test_intt_kernel_matches_plain_at_the_path_shapes(dev, k):
    rng = np.random.default_rng(460 + k)
    x = rng.integers(0, ntt.Q, (1024, k, 256), dtype=np.int64)
    x[0, 0], x[-1, -1], x[1, 0, :3] = 0, ntt.Q - 1, [0, ntt.Q - 1, 1]
    t = torch.from_numpy(x.astype(np.int32)).to(dev)
    before = cuda_ntt.intt_launches
    got = cuda_ntt.intt(t)
    torch.cuda.synchronize()
    assert cuda_ntt.intt_launches == before + 1
    assert got.shape == t.shape and torch.equal(got, ntt.intt_plain(t))
    assert torch.equal(cuda_ntt.ntt(got), t)


def test_intt_refuses_a_misaligned_input(dev):
    """A contiguous [rows, 256] view 4 bytes into its buffer: the
    inverse reads 16-byte words and raises; the forward, which reads 4
    bytes a thread, takes it."""
    rows = 8
    rng = np.random.default_rng(470)
    buf = torch.from_numpy(rng.integers(0, ntt.Q, rows * 256 + 1)
                           .astype(np.int32)).to(dev)
    x = buf[1:].view(rows, 256)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    before = cuda_ntt.intt_launches
    with pytest.raises(ValueError):
        cuda_ntt.intt(x)
    assert cuda_ntt.intt_launches == before
    assert torch.equal(cuda_ntt.ntt(x), ntt.ntt_plain(x))
    assert torch.equal(cuda_ntt.intt(x.clone()), ntt.intt_plain(x))


def test_keccak_and_ntt_wrappers_refuse_what_the_kernels_do_not_take(dev):
    s = torch.zeros((4, 25, 2), dtype=torch.int32, device=dev)
    x = torch.zeros((4, 256), dtype=torch.int32, device=dev)
    for bad in (s.to(torch.int64), s[:, :24], s.transpose(0, 1),
                s.to("meta")):
        with pytest.raises(ValueError):
            cuda_keccak.f1600(bad)
    for fn in (cuda_ntt.ntt, cuda_ntt.intt):
        for bad in (x.to(torch.int64), x[:, :128], x[:, ::2],
                    x.to("meta")):
            with pytest.raises(ValueError):
                fn(bad)


def _mldsa87_fixtures(rng):
    """Two ML-DSA-87 AKP keys (kids mldsa87-i), four tokens each."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.jwk import JWK

    jwks, tokens = [], []
    for i in range(2):
        priv, pub = tt.mldsa_keygen("ML-DSA-87", rng.randbytes(32))
        jwks.append(JWK(pub, kid=f"mldsa87-{i}"))
        tokens += [tt.sign_jwt(priv, "ML-DSA-87",
                               tt.default_claims(sub=f"user-{i}-{j}"),
                               kid=f"mldsa87-{i}") for j in range(4)]
    return jwks, tokens


@pytest.mark.parametrize("sets,launches", [
    ("ML-DSA-44 ML-DSA-65", (28, 4, 2)),
    ("ML-DSA-87", (16, 2, 1)),
])
def test_mldsa_keyset_on_the_card_matches_the_plain_path(dev, sets,
                                                          launches):
    """ML-DSA-44 + ML-DSA-65 (one chunk per set, each 14 keccak, 2 ntt
    and 1 intt launches) and ML-DSA-87 (k = 8, l = 7: one chunk whose
    c̃ recompute absorbs 9 blocks, so 16 keccak launches), with the
    ML-DSA rejection classes under the first token's set, against the
    plain path on the CPU."""
    import random

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.jwt.jose import b64url_decode, b64url_encode

    rng = random.Random(7)
    if sets == "ML-DSA-87":
        jwks, tokens = _mldsa87_fixtures(rng)
    else:
        jwks, tokens, _ = tt.mldsa_fixtures(32, seed=7)
    bad = [t[:-4] + ("AAAA" if t[-4:] != "AAAA" else "BBBB")
           for t in rng.sample(tokens, 6)]
    h, p, s = tokens[0].split(".")
    bad += [f"{h}.{p}.{b64url_encode(b)}" for _, b in
            tt.mldsa_bad_signatures(b64url_decode(s), sets.split()[0])]
    batch = tokens + bad + [f"{h}.{tokens[1].split('.')[1]}.{s}", "a.b"]
    card_ks = GPUBatchKeySet(jwks)
    before = (cuda_keccak.launches, cuda_ntt.ntt_launches,
              cuda_ntt.intt_launches)
    on_card = card_ks.verify_batch(batch)
    torch.cuda.synchronize()
    assert (cuda_keccak.launches - before[0],
            cuda_ntt.ntt_launches - before[1],
            cuda_ntt.intt_launches - before[2]) == launches
    on_cpu = GPUBatchKeySet(jwks, device="cpu").verify_batch(batch)
    assert [repr(x) if isinstance(x, Exception) else x for x in on_card] \
        == [repr(x) if isinstance(x, Exception) else x for x in on_cpu]
    assert sum(isinstance(x, dict) for x in on_card) == len(tokens)


@pytest.mark.parametrize("name", ["sha384", "sha512"])
def test_sha384_sha512_on_the_card_match_hashlib(dev, name):
    """The device SHA-384/512 on CUDA tensors (int64 words whose adds
    wrap modulo 2^64) equal to hashlib at every length 0–300 (``*_var``)
    and 0–111 (``*_fixed``)."""
    import hashlib

    from cap_tpu_torch.gpu import sha512

    fixed = getattr(sha512, f"{name}_fixed")
    var = getattr(sha512, f"{name}_var")
    rng = np.random.default_rng(401)
    lens = np.arange(301)
    buf = np.zeros((301, 300), np.uint8)
    for i, n in enumerate(lens):
        buf[i, :n] = rng.integers(0, 256, n)
    buf[300] = 0xFF
    got = var(torch.from_numpy(buf).to(dev), torch.from_numpy(lens).to(dev),
              300).cpu().numpy()
    assert [g.tobytes() for g in got] == \
        [hashlib.new(name, buf[i, :n].tobytes()).digest()
         for i, n in enumerate(lens)]
    for n in range(112):
        msgs = rng.integers(0, 256, (4, n), dtype=np.uint8)
        got = fixed(torch.from_numpy(msgs).to(dev)).cpu().numpy()
        assert [g.tobytes() for g in got] == \
            [hashlib.new(name, m.tobytes()).digest() for m in msgs], n


# the SLH-DSA path's state counts: 35 chains and 33 (128f) or 14 (128s)
# FORS trees a token, at ragged token counts
@pytest.mark.parametrize("m", [1, 3, 17, 1000])
@pytest.mark.parametrize("width", [35, 33, 14])
def test_keccak_kernel_matches_plain_at_the_slhdsa_shapes(dev, m, width):
    rng = np.random.default_rng(500 + m + width)
    words = rng.integers(0, 2 ** 32, (m, width, 25, 2), dtype=np.uint64)
    words[0, 0] = 0
    words[-1, -1] = 2 ** 32 - 1
    s = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    before = cuda_keccak.launches
    got = cuda_keccak.f1600(s)
    want = keccak.f1600_plain(s)
    torch.cuda.synchronize()
    assert cuda_keccak.launches == before + 1
    assert got.shape == s.shape and torch.equal(got, want)


def _kat_slhdsa(pset):
    """(key, signatures, messages, expected) from the pinned KAT file."""
    import json
    import os

    from cap_tpu_torch.gpu import slhdsa
    from cap_tpu_torch.jwt.jose import b64url_decode

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "slhdsa_kat.json")
    with open(path) as f:
        kat = json.load(f)
    jwk = [k for k in kat["keys"]["keys"] if k["alg"] == pset][0]
    vecs = [v for v in kat["vectors"] if v["alg"] == pset]
    return (slhdsa.SLHDSAPublicKey(pset, b64url_decode(jwk["pub"])),
            [b64url_decode(v["signature_b64"]) for v in vecs],
            [b64url_decode(v["message_b64"]) for v in vecs],
            [v["testPassed"] for v in vecs])


@pytest.mark.parametrize("pset,launches", [("SLH-DSA-SHAKE-128f", 518),
                                           ("SLH-DSA-SHAKE-128s", 219)])
def test_slhdsa_engine_on_the_card_matches_the_cpu_path(dev, pset,
                                                        launches):
    """The KAT signatures (wrong lengths among them) through the engine
    on the card, one chunk of 16 rows, against the plain path on the
    CPU and the KAT verdicts; the chunk's keccak launches."""
    from cap_tpu_torch.gpu import slhdsa

    key, sigs, msgs, want = _kat_slhdsa(pset)
    rows = np.zeros(len(sigs), np.int32)
    before = cuda_keccak.launches
    on_card = slhdsa.verify_slhdsa_batch(
        slhdsa.SLHDSAKeyTable(pset, [key], device=dev), sigs, msgs, rows)
    assert cuda_keccak.launches - before == launches == \
        slhdsa.chunk_launches(slhdsa.PARAMS[pset])
    on_cpu = slhdsa.verify_slhdsa_batch(
        slhdsa.SLHDSAKeyTable(pset, [key], device="cpu"), sigs, msgs, rows)
    assert on_card.tolist() == on_cpu.tolist() == want


def test_ps384_ps512_and_slhdsa_keysets_on_the_card_match_the_plain_path(
        dev):
    """PS384 + PS512 over two RSA-2048 keys (no kernel launch: the PS
    engine is PyTorch) and SLH-DSA-SHAKE-128f over the KAT key and a
    seeded one (one chunk, 518 keccak launches), with tampered tokens,
    against the plain path on the CPU."""
    import random

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu import slhdsa
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.jwt.jwk import JWK

    rng = random.Random(8)
    jwks, tokens, signers = tt.ps512_fixtures(16, seed=8)
    jwks = jwks[:2]
    tokens = [t for t, s in zip(tokens, signers) if s[2] in ("ps-0", "ps-1")]
    key, _, _, _ = _kat_slhdsa("SLH-DSA-SHAKE-128f")
    priv, pub = slhdsa.keygen("SLH-DSA-SHAKE-128f", bytes([9]) * 32)
    jwks += [JWK(key, kid="kat"), JWK(pub, kid="slh-1")]
    tokens += [tt.sign_jwt(priv, "SLH-DSA-SHAKE-128f",
                           tt.default_claims(sub=f"slh-{j}"), kid="slh-1")
               for j in range(2)]
    bad = [t[:-4] + ("AAAA" if t[-4:] != "AAAA" else "BBBB")
           for t in rng.sample(tokens, 4)]
    batch = tokens + bad + ["a.b"]
    card_ks = GPUBatchKeySet(jwks)
    counters = [(m, a) for m, a in ((cuda_keccak, "launches"),
                                    (cuda_ntt, "ntt_launches"),
                                    (cuda_ntt, "intt_launches"),
                                    (cuda_redc, "launches"),
                                    (cuda_madd, "launches"),
                                    (cuda_ladder, "launches"),
                                    (cuda_edw, "launches"))]
    before = [getattr(m, a) for m, a in counters]
    on_card = card_ks.verify_batch(batch)
    torch.cuda.synchronize()
    assert [getattr(m, a) - b for (m, a), b in zip(counters, before)] == \
        [518, 0, 0, 0, 0, 0, 0]
    on_cpu = GPUBatchKeySet(jwks, device="cpu").verify_batch(batch)
    assert [repr(x) if isinstance(x, Exception) else x for x in on_card] \
        == [repr(x) if isinstance(x, Exception) else x for x in on_cpu]
    assert sum(isinstance(x, dict) for x in on_card) == len(tokens)


def _claims_tokens(signers, rng):
    """Tokens of every claims rejection class, signed by ``signers``."""
    from cap_tpu_torch import testing as tt

    now = 1_700_000_000
    changes = [{}, dict(exp=now - 3600), dict(nbf=now + 7200),
               dict(iat=now + 7200, nbf=now - 10),
               dict(iat=None, nbf=None, exp=None),
               dict(iss="https://evil.example/"), dict(aud=["other"]),
               dict(aud=[7]), dict(aud="client-id")]
    out = []
    for change in changes:
        for priv, alg, kid in signers:
            claims = {k: v for k, v in dict(tt.default_claims(now=now),
                                            **change).items()
                      if v is not None}
            out.append(tt.sign_jwt(priv, alg, claims, kid=kid, rng=rng))
    return out


def _verdicts(results):
    return [r if isinstance(r, dict) else (type(r).__name__, str(r))
            for r in results]


def test_validator_over_the_card_keyset_matches_the_plain_path(dev):
    """Validator.validate_batch over GPUBatchKeySet on the card equals the
    same over the plain path, on RS256 + ES256 tokens of every claims
    rejection class, with both alg lists; it launches what verify_batch
    launches."""
    import random

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt import Expected, GPUBatchKeySet, Validator

    jwks, tokens, signers = tt.headline_fixtures(32, seed=7)
    rng = random.Random(7)
    batch = tokens + _claims_tokens(signers[::3], rng) + ["a.b"]
    card_ks = GPUBatchKeySet(jwks)
    cpu_ks = GPUBatchKeySet(jwks, device="cpu")
    for algs in (["RS256", "ES256"], ["RS256"]):
        expected = Expected(issuer="https://example.com/",
                            audiences=["client-id"],
                            signing_algorithms=algs,
                            now=lambda: 1_700_000_060)
        cuda_ladder.launches = cuda_redc.launches = 0
        on_card = Validator(card_ks).validate_batch(batch, expected)
        launched = (cuda_ladder.launches, cuda_redc.launches)
        cuda_ladder.launches = cuda_redc.launches = 0
        card_ks.verify_batch(batch)
        assert launched == (cuda_ladder.launches, cuda_redc.launches) \
            == (1, 11)
        on_cpu = Validator(cpu_ks).validate_batch(batch, expected)
        assert _verdicts(on_card) == _verdicts(on_cpu)
        kinds = {type(r).__name__ for r in on_card}
        assert {"dict", "ExpiredTokenError", "InvalidNotBeforeError",
                "InvalidIssuedAtError", "MissingClaimError",
                "InvalidIssuerError", "InvalidAudienceError",
                "MalformedTokenError"} <= kinds
        assert ("UnsupportedAlgError" in kinds) == (algs == ["RS256"])


def test_x5c_jwks_through_discovery_on_the_card(dev):
    """x5c-only JWKs (and one with parameters and chain) served behind a
    loopback discovery document, loaded by JSONWebKeySet: equal to the
    originals; the card keyset built from them validates as the plain
    path does and as the single-token Validator over the JSONWebKeySet."""
    import random

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt import (
        Expected,
        GPUBatchKeySet,
        Validator,
        new_oidc_discovery_keyset,
    )

    jwks, tokens, signers = tt.headline_fixtures(32, seed=9)
    rng = random.Random(9)
    doc = [tt.x5c_jwk(priv, kid=kid, rng=rng, include_params=kid == "es-0")
           for priv, _, kid in signers]
    batch = tokens + _claims_tokens(signers[1::4], rng)
    expected = Expected(issuer="https://example.com/",
                        audiences=["client-id"],
                        signing_algorithms=["RS256", "ES256"],
                        now=lambda: 1_700_000_060)
    with tt.discovery_test_server({"keys": doc}) as (issuer, _srv):
        remote = new_oidc_discovery_keyset(issuer)
        loaded = remote.keys()
        assert [tt.serialize_public_key(j.key, kid=j.kid) for j in loaded] \
            == [tt.serialize_public_key(j.key, kid=j.kid) for j in jwks]
        on_card = Validator(GPUBatchKeySet(loaded)).validate_batch(
            batch, expected)
        on_cpu = Validator(GPUBatchKeySet(loaded, device="cpu")) \
            .validate_batch(batch, expected)
        single = []
        for tok in batch:
            try:
                single.append(Validator(remote).validate(tok, expected))
            except Exception as e:  # noqa: BLE001 - compared below
                single.append(e)
    assert _verdicts(on_card) == _verdicts(on_cpu) == _verdicts(single)
    assert sum(isinstance(r, dict) for r in on_card) == len(tokens) + 8


@pytest.mark.parametrize("bits,exps", [(2048, (3, 17, 65537, 2 ** 31 - 1)),
                                       (4096, (65537,))],
                         ids=["2048-vare", "4096-65537"])
def test_limb_modexps_on_the_card_match_the_cpu(dev, bits, exps):
    """``modexp_vare`` (31 exponent bits) at 2048 bits and
    ``modexp_65537`` at 4096 on the card, limb for limb equal to the
    same calls on the CPU, s = 0, 1 and n − 1 among random s < n."""
    import random

    from cap_tpu_torch.gpu import limbs as L
    from cap_tpu_torch.gpu import rsa as gpursa

    rng = random.Random(bits)
    nums = [(rng.getrandbits(bits) | (1 << (bits - 1)) | 1,
             exps[i % len(exps)]) for i in range(4)]
    rows = [i % 4 for i in range(256)]
    s = [0, 1, nums[2][0] - 1] + [rng.randrange(nums[r][0])
                                  for r in rows[3:]]
    outs = []
    for d in (dev, torch.device("cpu")):
        table = gpursa.RSAKeyTable(nums, device=d)
        s_l = torch.as_tensor(np.stack(
            [L.int_to_limbs(v, table.k) for v in s], axis=1).astype(
                np.int64), device=d)
        idx = torch.as_tensor(rows, device=d)
        outs.append(gpursa.modexp_for_table(table, s_l, idx).cpu())
    assert torch.equal(outs[0], outs[1])
    assert [L.limbs_to_int(outs[0][:, j].tolist()) for j in range(8)] == \
        [pow(v, nums[r][1], nums[r][0]) for v, r in zip(s[:8], rows)]


@pytest.mark.parametrize("n_keys", [256, 300])
def test_arrays_keysets_on_the_card_match_the_plain_path(dev, n_keys,
                                                         monkeypatch):
    """Classes of ``n_keys`` RSA-2048, P-256 and Ed25519 keys (the arrays
    paths): RS256, PS256, ES256 and EdDSA verdicts on the card equal to
    the plain path's on the CPU, one ES chunk (1 ladder + 11 redc) and
    one EdDSA chunk (32 edw + 3 redc); at 300 keys the ladder and edw
    read key rows above 255. The EC and Ed25519 keys are 7 distinct
    ones repeated by row (the tables are built once a distinct key)."""
    import random

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.jwt.jwk import JWK

    rng = random.Random(n_keys)
    rsa = tt.pool_rsa_keys(tt.prime_pool(25, 1024, rng), n_keys)
    ec = [tt.generate_ec_key(rng) for _ in range(7)]
    ed = [tt.generate_ed25519_key(rng) for _ in range(7)]
    jwks = ([JWK(k.public_key(), kid=f"r-{i}") for i, k in enumerate(rsa)]
            + [JWK(ec[i % 7].public_key(), kid=f"e-{i}")
               for i in range(n_keys)]
            + [JWK(ed[i % 7].public_key(), kid=f"d-{i}")
               for i in range(n_keys)])
    rows = (0, 1, 254, 255, n_keys - 1) + ((256, 280) if n_keys > 256
                                            else ())
    batch = []
    for r in rows:
        batch += [tt.sign_jwt(rsa[r], "RS256", {"sub": f"rs-{r}"},
                              kid=f"r-{r}"),
                  tt.sign_jwt(rsa[r], "PS256", {"sub": f"ps-{r}"},
                              kid=f"r-{r}", rng=rng),
                  tt.sign_jwt(ec[r % 7], "ES256", {"sub": f"es-{r}"},
                              kid=f"e-{r}", rng=rng),
                  tt.sign_jwt(ed[r % 7], "EdDSA", {"sub": f"ed-{r}"},
                              kid=f"d-{r}")]
    bad = [t[:-4] + ("AAAA" if t[-4:] != "AAAA" else "BBBB")
           for t in batch[:8]]
    batch += bad + [tt.sign_jwt(ec[1], "ES256", {"sub": "x"}, kid="e-0",
                                rng=rng)]
    top = {"ladder": -1, "edw": -1}
    ladder, edw = cuda_ladder.ladder, cuda_edw.edw_window

    def ladder_rows(ctx, tab, d_all, base, win_stride):
        top["ladder"] = int(base.max()) // ((1 << ctx.w_bits) - 1) - 1
        return ladder(ctx, tab, d_all, base, win_stride)

    def edw_rows(ctx, X, Y, Z, T, tab, rows):
        slot = ed25519_rns.NW8 * ed25519_rns.PER
        top["edw"] = max(top["edw"], int(rows.max()) // slot - 1)
        return edw(ctx, X, Y, Z, T, tab, rows)

    monkeypatch.setattr(cuda_ladder, "ladder", ladder_rows)
    monkeypatch.setattr(cuda_edw, "edw_window", edw_rows)
    card_ks = GPUBatchKeySet(jwks)
    before = (cuda_ladder.launches, cuda_redc.launches, cuda_edw.launches)
    on_card = card_ks.verify_batch(batch)
    torch.cuda.synchronize()
    assert (cuda_ladder.launches - before[0], cuda_redc.launches - before[1],
            cuda_edw.launches - before[2]) == (1, 14, 32)
    assert top == {"ladder": max(rows), "edw": max(rows)}
    on_cpu = GPUBatchKeySet(jwks, device="cpu").verify_batch(batch)
    assert [repr(x) if isinstance(x, Exception) else x for x in on_card] \
        == [repr(x) if isinstance(x, Exception) else x for x in on_cpu]
    assert sum(isinstance(x, dict) for x in on_card) == 4 * len(rows)


def test_a_modulus_wider_than_the_rns_pool_on_the_card(dev):
    """A modulus of nine 1,024-bit primes (over 9,200 bits): more than
    the RNS prime pool takes (2·(nbits + 8) bits of 13-bit primes), so
    its e = 65537 class runs ``modexp_65537`` on limbs; RS256, PS256 and
    RS512 verdicts equal to the host oracle's (``jwt.verify``)."""
    import random

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.jwt.jose import parse_jws
    from cap_tpu_torch.jwt.jwk import JWK

    rng = random.Random(9216)
    key = tt.MultiPrimeRSAKey(tt.prime_pool(9, 1024, rng))
    ks = GPUBatchKeySet([JWK(key.public_key(), kid="wide")])
    (table,) = ks._rsa_tables
    assert key.n.bit_length() > 9200
    assert table.all_f4 and table.ctx is None
    assert table.k == (key.n.bit_length() + 15) // 16 + 1
    batch = [tt.sign_jwt(key, alg, {"sub": alg}, kid="wide", rng=rng)
             for alg in ("RS256", "PS256", "RS512")]
    batch.append(batch[0][:-4] + ("AAAA" if batch[0][-4:] != "AAAA"
                                  else "BBBB"))
    got = ks.verify_batch(batch)
    want = [ks._verify_one_parsed(parse_jws(t)) for t in batch]
    assert [repr(x) if isinstance(x, Exception) else x for x in got] == \
        [repr(x) if isinstance(x, Exception) else x for x in want]
    assert [isinstance(x, dict) for x in got] == [True, True, True, False]


def _oidc_batch(n_good, rng):
    """An OIDC rig on the port's TLS IdP: (idp, provider config
    arguments, request nonce, tokens) with n_good ES256 ID tokens and
    one of each native status, fallback and signature class."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.oidc.testing import TestProvider

    idp = TestProvider(rng=rng).start()
    priv, _, alg, kid = idp.signing_keys()
    now = 1_700_000_060
    base = dict(iss=idp.issuer(), aud=[idp.client_id], iat=now - 60,
                nbf=now - 60, exp=now + 3600, nonce="n-card")

    def sign(**over):
        claims = {k: v for k, v in dict(base, **over).items()
                  if v is not None}
        return tt.sign_jwt(priv, alg, claims, kid=kid, rng=rng)

    tokens = [sign(sub=f"u{j}") for j in range(n_good)]
    tokens += [sign(exp=None), sign(exp=now - 1), sign(nbf=now + 600),
               sign(iss="https://evil/"), sign(nonce="other"),
               sign(iat=now + 600), sign(aud=[idp.client_id, 4]),
               sign(aud=["x", "y"]), sign(azp="intruder"),
               sign(exp=True), sign(aud={"o": 1}),
               tokens[0][:-4] + ("AAAA" if tokens[0][-4:] != "AAAA"
                                 else "BBBB"), "a.b"]
    return idp, now, tokens


def test_verify_batch_raw_on_the_card_matches_the_plain_path(dev):
    """verify_batch_raw on the card: the plain path's bytes and errors,
    and the launches of verify_batch (one ES chunk: 1 ladder + 11
    redc)."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet

    jwks, tokens, _ = tt.headline_fixtures(256, seed=13)
    batch = tokens + [tokens[1][:-4] + "AAAA", "a.b"]
    card_ks = GPUBatchKeySet(jwks)
    launched = []
    for fn in (card_ks.verify_batch, card_ks.verify_batch_raw):
        cuda_ladder.launches = cuda_redc.launches = 0
        fn(batch)
        launched.append((cuda_ladder.launches, cuda_redc.launches))
    assert launched == [(1, 11), (1, 11)]
    on_card = card_ks.verify_batch_raw(batch)
    on_cpu = GPUBatchKeySet(jwks, device="cpu").verify_batch_raw(batch)
    assert [repr(x) if isinstance(x, Exception) else x for x in on_card] \
        == [repr(x) if isinstance(x, Exception) else x for x in on_cpu]
    assert sum(isinstance(x, bytes) for x in on_card) == len(tokens)


@pytest.mark.parametrize("raw", [False, True], ids=["dict", "raw"])
def test_oidc_batch_on_the_card_matches_the_plain_path(dev, raw):
    """Provider.verify_id_token_batch over the card keyset, built
    through discovery at the port's TLS IdP: every verdict equal to the
    same call over the plain path, and the launches of verify_batch."""
    import random

    from cap_tpu_torch.jwt import GPUBatchKeySet
    from cap_tpu_torch.jwt.jwk import parse_jwks
    from cap_tpu_torch.oidc import Config, Provider, Request, claims_native
    from cap_tpu_torch.utils import http

    idp, now, tokens = _oidc_batch(300, random.Random(17))
    try:
        cfg = Config(issuer=idp.issuer(), client_id=idp.client_id,
                     supported_signing_algs=["ES256"],
                     provider_ca=idp.ca_cert(), now_func=lambda: now)
        doc = http.get_json(Provider(cfg).jwks_uri,
                            http.ssl_context_for_ca(idp.ca_cert()))
        jwks = parse_jwks(doc)
        req = Request(3600, "https://rp/cb", nonce="n-card",
                      now_func=lambda: now)
        card = Provider(cfg, keyset=GPUBatchKeySet(jwks))
        cpu = Provider(cfg, keyset=GPUBatchKeySet(jwks, device="cpu"))
        cuda_ladder.launches = cuda_redc.launches = 0
        claims_native.reset_counts()
        on_card = card.verify_id_token_batch(tokens, req, raw=raw)
        assert (cuda_ladder.launches, cuda_redc.launches) == (1, 11)
        counts = (claims_native.native_validated,
                  claims_native.native_fallbacks)
        on_cpu = cpu.verify_id_token_batch(tokens, req, raw=raw)
    finally:
        idp.stop()
    assert [repr(x) if isinstance(x, Exception) else x for x in on_card] \
        == [repr(x) if isinstance(x, Exception) else x for x in on_cpu]
    kind = bytes if raw else dict
    # the 300 and the container aud (no audiences asked for)
    assert sum(isinstance(x, kind) for x in on_card) == 301
    if raw:
        # bool exp and container aud to the Python rules; the other
        # nine classes rejected natively
        assert counts == (300 + 9, 2)


def test_serve_worker_on_the_card_matches_the_plain_path(dev):
    """VerifyWorker over GPUBatchKeySet on the card, pipelined over two
    connections with the async pipeline and raw claims: every response
    frame equal to a worker's over the keyset on the CPU; the ladder
    launches equal the ES chunks the keyset counted, 11 redc each; a
    KEYS push swaps the card's tables."""
    import socket
    import struct

    from cap_tpu_torch import telemetry
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.jwt.jwk import serialize_public_key
    from cap_tpu_torch.serve import protocol
    from cap_tpu_torch.serve.worker import VerifyWorker

    jwks, tokens, _ = tt.headline_fixtures(128, seed=17)
    batch = tokens + [tokens[3][:-4] + "AAAA", "a.b"]

    class Sink:
        data = b""

        def sendall(self, b):
            self.data += b

    def request(toks, **kw):
        s = Sink()
        protocol.send_request(s, toks, **kw)
        return s.data

    def read_frame(sock):
        buf = b""

        def take(n):
            nonlocal buf
            out = b""
            while len(out) < n:
                got = sock.recv(n - len(out))
                assert got
                out += got
            buf += out
            return out

        _, ftype, count = struct.unpack("<IBI", take(9))
        for _ in range(count):
            take(struct.unpack("<BI", take(5))[1])
        if ftype >= protocol.T_VERIFY_REQ_CRC:
            take(4)
        return buf

    reqs = [[request(batch[i:i + 40], crc=bool(i % 80))
             for i in range(0, len(batch), 40)], [request(batch)]]

    def drive(worker):
        out = []
        for frames in reqs:
            with socket.create_connection(worker.address, timeout=60) as s:
                for f in frames:
                    s.sendall(f)
                out.append([read_frame(s) for _ in frames])
        return out

    card_ks = GPUBatchKeySet(jwks)
    workers = [VerifyWorker(card_ks, vcache=False, max_wait_ms=20.0),
               VerifyWorker(GPUBatchKeySet(jwks, device="cpu"),
                            vcache=False, max_wait_ms=20.0)]
    try:
        with telemetry.recording() as rec:
            cuda_ladder.launches = cuda_redc.launches = 0
            on_card = drive(workers[0])
            torch.cuda.synchronize()
            launches = (cuda_ladder.launches, cuda_redc.launches)
        chunks = int(rec.summary()["device.es.lanes"]["count"])
        assert launches == (chunks, 11 * chunks) and chunks >= 1
        # a batch whose record copies are timed (1 MB and more): the
        # link's rate, not the batch's
        card_ks.verify_batch((tokens * 128)[:16384])
        assert card_ks._wire_bps > 1e8
        assert on_card == drive(workers[1])
        doc = {"keys": [serialize_public_key(j.key, kid=j.kid)
                        for j in jwks]}
        assert workers[0].apply_keys(doc, 7) == 7
        assert card_ks.key_epoch == 7
    finally:
        for w in workers:
            w.close(deadline_s=60)


def test_native_chain_and_shm_on_the_card_match_the_plain_path(dev,
                                                                tmp_path):
    """VerifyWorker(serve_native=True, transport="shm") over
    GPUBatchKeySet on the card: pipelined requests over a socket
    connection and over an shm connection, every verdict equal to a
    Python-chain worker's over the keyset on the CPU; the ladder
    launches equal the ES chunks the keyset counted, 11 redc each."""
    from cap_tpu_torch import telemetry
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.serve.client import VerifyClient
    from cap_tpu_torch.serve.shm_client import ShmVerifyClient
    from cap_tpu_torch.serve.worker import VerifyWorker

    jwks, tokens, _ = tt.headline_fixtures(128, seed=18)
    batch = tokens + [tokens[3][:-4] + "AAAA", "a.b"]
    reqs = [batch[i:i + 40] for i in range(0, len(batch), 40)] + [batch]

    def wire(out):
        return [[str(v) if isinstance(v, Exception) else v for v in r]
                for r in out]

    def drive(worker, shm: bool):
        if shm:
            c = ShmVerifyClient(*worker.address, timeout=60, raw=True,
                                ring_bytes=1 << 20, shm_dir=str(tmp_path))
            assert c.transport == "shm", c.attach_error
        else:
            c = VerifyClient(*worker.address, timeout=60, raw=True)
        with c:
            return wire(c.verify_stream(reqs, depth=4))

    plain = VerifyWorker(GPUBatchKeySet(jwks, device="cpu"), vcache=False,
                         max_wait_ms=20.0)
    try:
        want = drive(plain, False)
    finally:
        plain.close(deadline_s=60)
    with telemetry.recording() as rec:
        card = VerifyWorker(GPUBatchKeySet(jwks), vcache=False,
                            max_wait_ms=20.0, serve_native=True,
                            transport="shm")
        try:
            assert (card.serve_chain, card.transport) == ("native", "shm")
            cuda_ladder.launches = cuda_redc.launches = 0
            got = [drive(card, False), drive(card, True)]
            torch.cuda.synchronize()
            launches = (cuda_ladder.launches, cuda_redc.launches)
            native = card._native.counters()
        finally:
            card.close(deadline_s=60)
    chunks = int(rec.summary()["device.es.lanes"]["count"])
    assert launches == (chunks, 11 * chunks) and chunks >= 2
    assert got == [want, want]
    assert native["serve.native.tokens"] >= 2 * sum(map(len, reqs))
    assert native["serve.shm.attaches"] == 1
    assert not list(tmp_path.iterdir())


def test_keyplane_keyset_on_the_card_matches_the_plain_path(dev):
    """KeyPlaneKeySet over GPUBatchKeySet on the card against the same
    over device="cpu", one loopback JWKS for both, across a rotation at
    the source (rs-0 out, a new RSA-2048 and P-256 key in): equal
    verdicts before, in the grace and after the retirement, and the
    card's ladder launches."""
    import random
    import threading

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.jwk import serialize_public_key
    from cap_tpu_torch.keyplane import RemoteJWKSSource
    from cap_tpu_torch.keyplane.plane import KeyPlaneKeySet

    jwks, tokens, _ = tt.headline_fixtures(64, seed=29)
    # a stream of its own: Random(29) would make headline_fixtures'
    # first key again
    rng = random.Random(1029)
    new = {"rs-new": tt.generate_rsa_key(rng),
           "es-new": tt.generate_ec_key(rng)}
    fresh = [tt.sign_jwt(new["rs-new"], "RS256", tt.default_claims(),
                         kid="rs-new", rng=rng),
             tt.sign_jwt(new["es-new"], "ES256", tt.default_claims(),
                         kid="es-new", rng=rng)]
    batch = tokens + fresh + [tokens[2][:-4] + "AAAA", "a.b"]
    keys = [serialize_public_key(j.key, kid=j.kid) for j in jwks]
    state = {"keys": keys, "etags": True}
    retire = []

    class Held:
        def __init__(self, interval, function, args=()):
            self.function, self.args, self.daemon = function, args, False
            retire.append(self)

        def start(self):
            pass

    def norm(out):
        return [repr(x) if isinstance(x, Exception) else x for x in out]

    with tt.jwks_test_server(state) as (url, _):
        kw = dict(start=False, miss_cooldown_s=0.0, negative_ttl_s=0.0,
                  grace_s=30.0)
        card = KeyPlaneKeySet(RemoteJWKSSource(url), **kw)
        cpu = KeyPlaneKeySet(RemoteJWKSSource(url), device="cpu", **kw)
        timer = threading.Timer
        try:
            assert card._ks.device.type == "cuda"
            cuda_ladder.launches = 0
            before = card.verify_batch_raw(batch)
            assert cuda_ladder.launches >= 1
            assert norm(before) == norm(cpu.verify_batch_raw(batch))
            threading.Timer = Held
            state["keys"] = keys[1:] + [
                serialize_public_key(k.public_key(), kid=kid)
                for kid, k in new.items()]
            during = card.verify_batch_raw(batch)
            assert norm(during) == norm(cpu.verify_batch_raw(batch))
            assert card.in_grace and card.key_epoch == 2
            assert all(isinstance(x, bytes) for x in during[-4:-2])
            for t in retire:
                t.function(*t.args)
            after = card.verify_batch_raw(batch)
            assert norm(after) == norm(cpu.verify_batch_raw(batch))
            assert not card.in_grace
            assert sum(isinstance(x, bytes) for x in after) < \
                sum(isinstance(x, bytes) for x in during)
        finally:
            threading.Timer = timer
            card.close()
            cpu.close()


def test_pool_of_a_card_worker_and_a_cpu_worker(dev, tmp_path):
    """A WorkerPool of two ``worker_main --keyset jwks:<file>`` processes,
    worker 0 owning the card and worker 1 on the CPU, behind
    FleetClient(pool, fallback=None): every verdict equal to
    ``verify_batch_raw`` on the card, both workers serving, the card
    worker's ES chunks in its /snapshot."""
    import json
    import urllib.request

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.fleet import FleetClient, WorkerPool
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.jwt.jwk import serialize_public_key
    from cap_tpu_torch.parallel import WorkerPlacement

    jwks, tokens, _ = tt.headline_fixtures(256, seed=31)
    batch = tokens + [tokens[5][:-4] + "AAAA", "a.b"]
    want = GPUBatchKeySet(jwks).verify_batch_raw(batch)
    path = tmp_path / "jwks.json"
    path.write_text(json.dumps({"keys": [
        serialize_public_key(j.key, kid=j.kid) for j in jwks]}))
    torch.cuda.empty_cache()
    with WorkerPool(2, keyset_spec=f"jwks:{path}", placements=[
            WorkerPlacement(0, (0,), "cuda"),
            WorkerPlacement(1, (1,), "cpu")],
            spawn_timeout=300.0, worker_args=["--torch-threads", "4"]) as p:
        assert p.wait_all_ready(300.0), [p.state(w) for w in (0, 1)]
        cl = FleetClient(p, fallback=None, total_deadline=300.0,
                         attempt_timeout=150.0, rr_seed=0)
        got = []
        for i in range(0, len(batch), 66):
            got += cl.verify_batch(batch[i:i + 66])
        assert [str(x) if isinstance(x, Exception) else x for x in got] == [
            f"{type(x).__name__}: {x}" if isinstance(x, Exception)
            else json.loads(x) for x in want]
        served = {w: s["counters"]["worker.tokens"]
                  for w, s in p.stats().items()}
        assert min(served.values()) > 0, served
        host, port = p.obs_endpoints()[0]
        with urllib.request.urlopen(f"http://{host}:{port}/snapshot",
                                    timeout=60) as r:
            snap = json.load(r)["snapshot"]
        assert snap["series"]["device.es.lanes"]["count"] >= 1
        assert snap["counters"]["device.dispatches"] >= 1


def test_front_door_over_a_card_worker_and_a_cpu_worker(dev):
    """FrontDoor over two hosts, a worker on the card and a worker on
    the CPU, behind both gates (``VerifyWorker(FrontDoor)`` and the
    native relay): every verdict equal to ``verify_batch_raw`` on the
    card, the relay's choices the ring's, its lookups all hits and
    equal to the tokens sent, the card worker's ES chunks launching
    the ladder."""
    import json

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.fleet import ConsistentHashRing, FrontDoor
    from cap_tpu_torch.fleet.frontdoor import NativeFrontDoorServer
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.serve import vcache
    from cap_tpu_torch.serve.client import VerifyClient
    from cap_tpu_torch.serve.worker import VerifyWorker

    jwks, tokens, _ = tt.headline_fixtures(128, seed=37)
    batch = tokens + [tokens[7][:-4] + "AAAA", "a.b"]
    want = [f"{type(x).__name__}: {x}" if isinstance(x, Exception)
            else json.loads(x)
            for x in GPUBatchKeySet(jwks).verify_batch_raw(batch)]
    owners = [ConsistentHashRing([0, 1]).primary(vcache.token_digest(t))
              for t in batch]
    assert set(owners) == {0, 1}
    hosts = [VerifyWorker(GPUBatchKeySet(jwks), max_wait_ms=1.0),
             VerifyWorker(GPUBatchKeySet(jwks, device="cpu"),
                          max_wait_ms=1.0)]
    kw = {"fallback": None, "client_kw": {"attempt_timeout": 150.0,
                                          "total_deadline": 300.0}}
    fd = FrontDoor([[h.address] for h in hosts], **kw)
    gates = [VerifyWorker(fd, vcache=False),
             NativeFrontDoorServer(FrontDoor([[h.address] for h in hosts],
                                             **kw))]
    try:
        for gate in gates:
            ladder0 = cuda_ladder.launches
            with VerifyClient(*gate.address, timeout=300.0) as cl:
                got = []
                for i in range(0, len(batch), 65):
                    got += cl.verify_batch(batch[i:i + 65])
            assert [str(x) if isinstance(x, Exception) else x
                    for x in got] == want
            assert cuda_ladder.launches > ladder0
        nat = gates[1]
        assert nat.probe_route([vcache.token_digest(t)
                                for t in batch]) == owners
        nc = nat.native_counters()
        assert nc["frontdoor.native.lookups"] == nc[
            "frontdoor.native.hits"] == len(batch)
        pools = fd.snapshot()["pools"]
        assert [pools[str(p)]["tokens"] for p in (0, 1)] == [
            owners.count(0), owners.count(1)]
        for f in (fd, nat.frontdoor):
            c = f.counters()
            assert c["frontdoor.lookups"] == c["frontdoor.affinity_hits"] \
                + c["frontdoor.affinity_misses"] == len(batch)
    finally:
        for g in gates:
            g.close(30.0)
        for h in hosts:
            h.close(30.0)
