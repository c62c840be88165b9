#!/usr/bin/env python3
"""Time the ES ladder's CUDA kernels of one checkout on one NVIDIA card.

    python3 ladder_bench.py [--root DIR] [--lanes N] [--build-only]
                            [--sass]

Imports ``cap_tpu_torch`` from DIR (default: this script's checkout)
and builds its madd kernel, and its whole-ladder kernel where DIR has
one; a build run in this process prints ptxas's register and spill
lines. To time another layout, edit it in a second checkout and
pass that with ``--root``. ``--sass`` counts the built kernels'
SASS instructions by class (cuobjdump). ``--build-only`` stops after
the build, so several checkouts can build in parallel before any of
them is timed. Then, on inputs made from one seed the same way for any
checkout, it times by CUDA events, at ``--lanes`` lanes (default
65,536: one 32,768-token ES chunk):

- one ``cuda_madd.madd`` launch on each curve whose channel counts the
  checkout builds (random state and table values < p, random has and
  inf masks);
- that curve's ladder over a window table of G and 8 key slots
  (random values < p, random 8-bit digits, half the lanes on G's slot):
  one madd a window, each after an ``index_select`` gather of the
  window's rows (the per-window path of ``ec_rns``), and, where the
  checkout has it, the whole-ladder kernel on the same inputs, with the
  count of lanes whose results differ between the two.

The JSON carries a SHA-256 digest of each kernel's outputs per curve:
equal digests across checkouts show their kernels equal word for word
on these inputs.

Prints the card's name and power limit, then one JSON line. To compare
two checkouts, build both, then run A, B, B, A in one call on one card.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

from chip_smoke import ptxas_kernels  # this script's checkout's

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


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def flat(out):
    """The tensors of a madd or ladder result: X, Y, Z pairs, then the
    masks."""
    return [t for pair in out[:3] for t in pair] + list(out[3:])


# SASS classes counted by --sass (opcode prefixes): the conversions
# I2F(P), F2I(P) and FRND, the integer multiply-adds (IMAD, not its
# MOV form), shared loads, local-memory loads and stores (spills).
SASS_CLASSES = ("I2F", "F2I", "FRND", "IMAD", "LDS", "LDL", "STL")


def sass_counts(lib: str) -> dict:
    """{kernel: {class: count, "total": n}} of a built library's madd
    and ladder kernels (cuobjdump -sass from the CUDA toolkit or
    Triton's copy)."""
    import re
    import shutil
    from importlib.util import find_spec
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool) and find_spec("triton"):
        tool = str(Path(find_spec("triton").origin).parent / "backends" /
                   "nvidia" / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = next(iter(ptxas_kernels("Compiling entry " + line)), None)
            cur = out.setdefault(name, dict.fromkeys(SASS_CLASSES, 0))
            cur["total"] = 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if cur is None or not m:
            continue
        op = m[1]
        cur["total"] += 1
        for cls in SASS_CLASSES:
            # I2F counts I2FP, F2I F2IP; IMAD.MOV is a move
            if op.startswith(cls) and not op.startswith("IMAD.MOV"):
                cur[cls] += 1
    out.pop(None, None)
    return out


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
    ap.add_argument("--sass", action="store_true")
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
    libs = _build.build_all(names)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, info in sorted(_build.BUILD_LOG.items()):
        ptxas.update(ptxas_kernels(info["ptxas"]))
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    sass = {}
    if args.sass:
        for name in names:
            sass.update(sass_counts(str(libs[name])))
        for kern, counts in sorted(sass.items()):
            print(f"sass {kern}: {json.dumps(counts)}", flush=True)
    if args.build_only:
        print(f"build: {build_s:.1f} s for {', '.join(names)} in {root}")
        print(json.dumps(dict(root=root, build_s=build_s,
                              ptxas=ptxas, sass=sass)), flush=True)
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
    out = dict(root=root, card=card, lanes=n, build_s=build_s,
               ptxas=ptxas, sass=sass, madd={}, ladder={}, digests={})
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
        dig = out["digests"].setdefault(crv, {})
        dig["madd"] = digest(flat(cuda_madd.madd(c, X, Y, Z, inf, has, x2p,
                                                 y2p)))
        print(f"madd {crv}: {n} lanes, {ms:.4f} ms, outputs sha256 "
              f"{dig['madd'][:16]}", flush=True)
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
            whole = cuda_ladder.ladder(c, tab, d, base, stride)
            rec["lanes_differ"] = lanes_differ(
                whole, per_window(cuda_madd, c, tab_t, d, base, stride))
            dig["ladder"] = digest(flat(whole))
            line += (f", whole-ladder kernel {rec['ladder_ms']:.4f} ms "
                     f"(ladder/per-window "
                     f"{rec['ladder_ms'] / rec['per_window_ms']:.3f}), "
                     f"{rec['lanes_differ']} lanes differ, outputs sha256 "
                     f"{dig['ladder'][:16]}")
        out["ladder"][crv] = rec
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
