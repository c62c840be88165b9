#!/usr/bin/env python3
"""Time the ES ladder's CUDA kernels of one checkout on one NVIDIA card.

    python3 ladder_bench.py [--root DIR] [--lanes N] [--build-only]

Imports ``cap_tpu_torch`` from DIR (default: this script's checkout)
and builds its madd kernel, and its whole-ladder kernel where DIR has
one; a build run in this process prints ptxas's register and spill
lines. ``--build-only`` stops there, so several checkouts can build in
parallel before any of them is timed. Then, on inputs made from one
seed the same way for any checkout, it times by CUDA events, at
``--lanes`` lanes (default 65,536: one 32,768-token ES chunk):

- one ``cuda_madd.madd`` launch on each curve whose channel counts the
  checkout builds (random state and table values < p, random has and
  inf masks);
- that curve's ladder over a window table of G and 8 key slots
  (random values < p, random 8-bit digits, half the lanes on G's slot):
  one madd a window, each after an ``index_select`` gather of the
  window's rows (the per-window path of ``ec_rns``), and, where the
  checkout has it, the whole-ladder kernel on the same inputs, with the
  count of lanes whose results differ between the two.

Prints the card's name and power limit, then one JSON line. To compare
two checkouts, build both, then run A, B, B, A in one call on one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 20261017
CURVES = ("P-256", "P-384", "P-521")
N_KEYS = 8


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def residues(ec_rns, c, rng, n: int):
    """(A [I_A, n], B [I_B, n]) int32 residues and [iap, n] packed
    A|B<<16 words of n random values < p."""
    import numpy as np

    nbytes = (c.p_int.bit_length() + 71) // 8
    vals = [int.from_bytes(rng.bytes(nbytes), "big") % c.p_int
            for _ in range(n)]
    res = ec_rns._residue_matrix(c, vals)
    ia = c.A.count
    return (np.ascontiguousarray(res[:, :ia].T),
            np.ascontiguousarray(res[:, ia:].T),
            np.ascontiguousarray(ec_rns._pack_residue_rows(c, res).T))


def per_window(cuda_madd, c, tab_t, d_all, base, stride: int):
    """The ladder one madd launch a window, as ``ec_rns`` runs it."""
    import torch

    ia, ib = c.A.count, c.B.count
    iap = max(ia, ib)
    m = d_all.shape[1]
    dev = d_all.device
    zA = torch.zeros((ia, m), dtype=torch.int32, device=dev)
    zB = torch.zeros((ib, m), dtype=torch.int32, device=dev)
    X, Y, Z = (zA, zB), (zA, zB), (zA, zB)
    inf = torch.ones(m, dtype=torch.bool, device=dev)
    deg = torch.zeros(m, dtype=torch.bool, device=dev)
    base = base.to(torch.int64)
    for i in range(d_all.shape[0]):
        d = d_all[i].to(torch.int64)
        has = d > 0
        idx = i * stride + base + torch.where(has, d - 1,
                                              torch.zeros_like(d))
        g = tab_t.index_select(1, idx)
        X, Y, Z, dd = cuda_madd.madd(c, X, Y, Z, inf, has, g[:iap],
                                     g[iap:])
        inf = inf & ~has
        deg = deg | dd
    return X, Y, Z, inf, deg


def lanes_differ(a, b) -> int:
    diff = (a[3] != b[3]) | (a[4] != b[4])
    for pa, pb in zip(a[:3], b[:3]):
        for x, y in zip(pa, pb):
            diff |= (x != y).any(dim=0)
    return int(diff.sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--lanes", type=int, default=65536)
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ladder_bench: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np

    from cap_tpu_torch import _build
    from cap_tpu_torch.gpu import cuda_madd, cuda_redc, ec_rns

    names = [n for n in ("madd", "ladder") if n in _build.KERNELS]
    t0 = time.perf_counter()
    _build.build_all(names)
    build_s = time.perf_counter() - t0
    for name, info in sorted(_build.BUILD_LOG.items()):
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    if args.build_only:
        print(f"build: {build_s:.1f} s for {', '.join(names)} in {root}")
        return 0
    cuda_ladder = None
    if "ladder" in names:
        from cap_tpu_torch.gpu import cuda_ladder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    n = args.lanes
    out = dict(root=root, card=card, lanes=n, build_s=build_s, madd={},
               ladder={})
    for crv in CURVES:
        c = ec_rns.ctx_for(crv)
        if (c.A.count, c.B.count) not in cuda_redc.KERNEL_SHAPES:
            continue
        rng = np.random.default_rng([SEED, CURVES.index(crv)])
        # one madd launch
        X, Y, Z = (tuple(T(a) for a in residues(ec_rns, c, rng, n)[:2])
                   for _ in range(3))
        x2p = T(residues(ec_rns, c, rng, n)[2])
        y2p = T(residues(ec_rns, c, rng, n)[2])
        has = T(rng.integers(0, 2, n).astype(bool))
        inf = T(rng.integers(0, 2, n).astype(bool))
        ms = cuda_ms(lambda: cuda_madd.madd(c, X, Y, Z, inf, has, x2p,
                                            y2p), 20)
        out["madd"][crv] = ms
        print(f"madd {crv}: {n} lanes, {ms:.4f} ms", flush=True)
        # the ladder both ways
        w = c.n_windows
        per = (1 << c.w_bits) - 1
        stride = (N_KEYS + 1) * per
        rows = w * stride
        _, _, tx = residues(ec_rns, c, rng, rows)
        _, _, ty = residues(ec_rns, c, rng, rows)
        tab = np.ascontiguousarray(np.concatenate([tx.T, ty.T], axis=1))
        d = rng.integers(0, per + 1, (w, n)).astype(np.int32)
        base = np.zeros(n, np.int32)
        base[n // 2:] = (rng.integers(0, N_KEYS, n - n // 2) + 1) * per
        tab_t, d, base = T(np.ascontiguousarray(tab.T)), T(d), T(base)
        rec = dict(windows=w, per_window_ms=cuda_ms(
            lambda: per_window(cuda_madd, c, tab_t, d, base, stride), 5))
        line = (f"ladder {crv}: {w} windows, per-window path "
                f"{rec['per_window_ms']:.4f} ms")
        if cuda_ladder is not None:
            tab = T(tab)
            rec["ladder_ms"] = cuda_ms(
                lambda: cuda_ladder.ladder(c, tab, d, base, stride), 5)
            rec["lanes_differ"] = lanes_differ(
                cuda_ladder.ladder(c, tab, d, base, stride),
                per_window(cuda_madd, c, tab_t, d, base, stride))
            line += (f", whole-ladder kernel {rec['ladder_ms']:.4f} ms "
                     f"(ladder/per-window "
                     f"{rec['ladder_ms'] / rec['per_window_ms']:.3f}), "
                     f"{rec['lanes_differ']} lanes differ")
        out["ladder"][crv] = rec
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
