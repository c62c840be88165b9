#!/usr/bin/env python3
"""Time the CUDA kernels of one checkout on one NVIDIA card.

    python3 ladder_bench.py [--root DIR] [--lanes N] [--build-only]
                            [--sass] [--w-bits 8|12]

Imports ``cap_tpu_torch`` from DIR (default: this script's checkout)
and builds its redc, madd, edw, keccak and ntt kernels, and its
whole-ladder kernel where DIR has one; a build run in this process
prints ptxas's register and spill lines. To time another layout, edit
it in a second checkout and pass that with ``--root``. ``--sass``
counts the built kernels' SASS instructions by class (cuobjdump).
``--build-only`` stops after the build, so several checkouts can build
in parallel before any of them is timed. Then, on inputs made from
one seed the same way for any checkout, it times by CUDA events, at
``--lanes`` lanes (default 65,536: one 32,768-token ES or EdDSA
chunk):

- one ``cuda_redc.redc`` launch on each curve whose channel counts the
  checkout builds (products x < 2^(16·coordinate bytes), as an rmul
  feeds its REDC), by the profiler's device time a launch: at this
  size a call's host work outlasts the kernel;
- one ``cuda_madd.madd`` launch on each of those curves (random state
  and table values < p, random has and inf masks);
- that curve's ladder over a window table of G and 8 key slots
  (random values < p, random w-bit digits, half the lanes on G's slot;
  ``--w-bits 12``: 12-bit windows, 22 / 32 / 44 of 4,095 rows a slot on
  P-256 / P-384 / P-521, the table's values drawn from a pool of 65,536
  random values, which keeps its host build short; a checkout's
  ``ec_rns.ctx_for`` must take the width):
  one madd a window, each after an ``index_select`` gather of the
  window's rows (the per-window path of ``ec_rns``), and, where the
  checkout has it, the whole-ladder kernel on the same inputs, with the
  count of lanes whose results differ between the two;
- the 32-window Ed25519 ladder of one chunk (both chains, a random
  table of the basepoint and 9 key slots, random digits, window rows
  built once): ``cuda_edw.edw_window`` a window where the checkout has
  it, else a gather of the window's planes and ``cuda_edw.edw``; the
  edw kernel's device time a launch also by the profiler.

- the ML-DSA kernels at the shapes of one 1,024-token chunk, and
  keccak also at 65,536 states: ``cuda_keccak.f1600`` on [1024, 25, 2]
  and [65536, 25, 2], ``cuda_ntt.ntt`` on [1024, 4, 256], [1024, 5,
  256] and [1024, 256], ``cuda_ntt.intt`` on [1024, 4, 256] and [1024,
  6, 256] (random words or values < q, edge values among them; the
  inverse, one warp a row, reads its rows as 16-byte words), each by
  the profiler's device time a launch; beside them the launch floor,
  the device time of a one-element ``add_``.

Each time meant as the profiler's says how it was taken, in its
printed line and in the JSON's ``by`` (keyed as printed): "profiler", or
"events" where three profiles in a row recorded no launch of the
kernel and CUDA events timed the calls instead (a call's host time,
not the kernel's device time).

The JSON carries a SHA-256 digest of each kernel's outputs per curve
(and of the Ed ladder's, and of each ML-DSA kernel's per shape): equal
digests across checkouts show their kernels equal word for word on
these inputs.

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

# this script's checkout's
from chip_smoke import kernel_ms, ptxas_kernels, residues_of_bytes

SEED = 20261017
CURVES = ("P-256", "P-384", "P-521")
N_KEYS = 8


W_POOL = 1 << 16        # random values a 12-bit table draws on


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
    """{kernel: {class: count, "total": n}} of a built library's
    kernels (cuobjdump -sass from the CUDA toolkit or Triton's copy)."""
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


def ed_ladder_case(er, rng, n: int):
    """(state, column-major table [3·(I_A + I_B), rows], packed table
    [rows, 3·iap], window rows [NW8, n]) of a 32-window Ed25519 ladder
    on n lanes: random triples < p in the basepoint's slot and 9 key
    slots; the first n/2 lanes (the B chain) on the basepoint's slot,
    the others on a random key's, random digits."""
    import numpy as np

    c = er.ctx()
    ia, ib = c.A.count, c.B.count
    iap = max(ia, ib)
    slot = er.NW8 * er.PER
    n_rows = 10 * slot
    planes, packed = [], []
    for _ in range(3):
        raw = rng.integers(0, 256, (n_rows, 32), dtype=np.uint8)
        raw[:, 0] = np.minimum(raw[:, 0], 0x7E)
        a, b = residues_of_bytes(c, raw)
        planes += [a, b]
        w = np.zeros((n_rows, iap), np.int32)
        w[:, :ia] = a.T
        w[:, :ib] |= b.T << 16
        packed.append(w)
    key = np.concatenate([np.zeros(n // 2, np.int64),
                          rng.integers(1, 10, n - n // 2)])
    d = rng.integers(0, er.PER, (er.NW8, n))
    rows = key[None, :] * slot + np.arange(er.NW8)[:, None] * er.PER + d
    return (np.ascontiguousarray(np.concatenate(planes)),
            np.ascontiguousarray(np.concatenate(packed, axis=1)),
            np.ascontiguousarray(rows.astype(np.int32)))


def ed_ladder(cuda_edw, c, tab_cols, tab, rows):
    """The 32 windows from X = T = 0, Y = Z = 1 (A-domain): one fused
    ``edw_window`` launch a window where the checkout has it, else the
    gather of the window's planes and one ``edw`` launch."""
    import torch

    ia, ib = c.A.count, c.B.count
    w = ia + ib
    n = rows.shape[1]
    dev = rows.device
    one = c.device_consts(dev).one
    zero = (torch.zeros((ia, n), dtype=torch.int32, device=dev),
            torch.zeros((ib, n), dtype=torch.int32, device=dev))
    one_b = (one[0].expand(ia, n).contiguous(),
             one[1].expand(ib, n).contiguous())
    X, Y, Z, T = zero, one_b, one_b, zero
    fused = getattr(cuda_edw, "edw_window", None)
    for i in range(rows.shape[0]):
        if fused is not None:
            X, Y, Z, T = fused(c, X, Y, Z, T, tab, rows[i])
            continue
        g = tab_cols.index_select(1, rows[i].to(torch.int64))
        ym, yp, t2 = [(g[t * w: t * w + ia], g[t * w + ia: (t + 1) * w])
                      for t in range(3)]
        X, Y, Z, T = cuda_edw.edw(c, X, Y, Z, T, ym, yp, t2)
    return X, Y, Z, T


# (kernel, shape) of the ML-DSA kernels' cases: one chunk's shapes,
# and keccak at 65,536 states
MLDSA_CASES = (("keccak", (1024, 25, 2)), ("keccak", (65536, 25, 2)),
               ("ntt", (1024, 4, 256)), ("ntt", (1024, 5, 256)),
               ("ntt", (1024, 256)), ("intt", (1024, 4, 256)),
               ("intt", (1024, 6, 256)))


def mldsa_kernels(root: str, dev, out: dict) -> None:
    """Time and digest each of MLDSA_CASES (inputs from the seed, the
    same for any checkout) into out["mldsa"] and out["digests"]."""
    import numpy as np
    import torch

    from cap_tpu_torch.gpu import cuda_keccak, cuda_ntt, ntt

    src = open(os.path.join(root, "cap_tpu_torch", "gpu", "csrc",
                            "ntt.cu")).read()
    # profiler keys: this tree's kernel names, or those of a checkout
    # whose two NTTs are one template's instantiations
    old = "ntt_kernel<kInverse>" in src
    fns = {"keccak": (cuda_keccak.f1600, "keccak_kernel"),
           "ntt": (cuda_ntt.ntt,
                   "ntt_kernel<false>" if old else "ntt_fwd_kernel"),
           "intt": (cuda_ntt.intt,
                    "ntt_kernel<true>" if old else "intt_kernel")}
    # the launch floor: the device time of a one-element add_
    one = torch.zeros(1, device=dev)
    out["floor_ms"], by = kernel_ms(lambda: one.add_(1), 50,
                                    "elementwise_kernel")
    out["by"]["floor"] = by
    print(f"launch floor (one-element add_): {out['floor_ms']:.4f} ms "
          f"(by {by})", flush=True)
    out["mldsa"] = {}
    dig = out["digests"].setdefault("ML-DSA", {})
    for i, (name, shape) in enumerate(MLDSA_CASES):
        rng = np.random.default_rng([SEED, 10 + i])
        if name == "keccak":
            x = rng.integers(0, 2 ** 32, shape, dtype=np.uint64)
            x.reshape(-1, 50)[0], x.reshape(-1, 50)[1] = 0, 2 ** 32 - 1
            x = x.astype(np.uint32).view(np.int32)
        else:
            x = rng.integers(0, ntt.Q, shape, dtype=np.int64)
            x.reshape(-1, 256)[0], x.reshape(-1, 256)[1] = 0, ntt.Q - 1
            x = x.astype(np.int32)
        x = torch.from_numpy(x).to(dev)
        fn, key = fns[name]
        ms, by = kernel_ms(lambda: fn(x), 50, key)
        label = f"{name} {list(shape)}"
        out["mldsa"][label] = ms
        out["by"][label] = by
        dig[label] = digest([fn(x)])
        print(f"{label}: {ms:.4f} ms a launch ({key}, by {by}), outputs "
              f"sha256 {dig[label][:16]}", flush=True)


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
    ap.add_argument("--w-bits", type=int, default=8, choices=(8, 12))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ladder_bench: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np

    from cap_tpu_torch import _build
    from cap_tpu_torch.gpu import cuda_edw, cuda_madd, cuda_redc, ec_rns
    from cap_tpu_torch.gpu import ed25519_rns as er

    names = [n for n in ("redc", "madd", "ladder", "edw", "keccak", "ntt")
             if n in _build.KERNELS]
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
               ptxas=ptxas, sass=sass, redc={}, madd={}, ladder={},
               digests={}, by={}, w_bits=args.w_bits)
    for crv in CURVES:
        c = ec_rns.ctx_for(crv)
        if (c.A.count, c.B.count) not in cuda_redc.KERNEL_SHAPES:
            continue
        dig = out["digests"].setdefault(crv, {})
        # one redc launch, on its own stream of the seed
        rng = np.random.default_rng([SEED, CURVES.index(crv), 1])
        xA, xB = (T(a) for a in residues_of_bytes(c, rng.integers(
            0, 256, (n, 2 * c.cp.coord_bytes), dtype=np.uint8)))
        ms, by = kernel_ms(lambda: cuda_redc.redc(c, xA, xB), 50,
                           "redc_kernel")
        out["redc"][crv] = ms
        out["by"][f"redc {crv}"] = by
        dig["redc"] = digest(cuda_redc.redc(c, xA, xB))
        print(f"redc {crv}: {n} lanes, {ms:.4f} ms (by {by}), outputs sha256 "
              f"{dig['redc'][:16]}", flush=True)
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
        dig["madd"] = digest(flat(cuda_madd.madd(c, X, Y, Z, inf, has, x2p,
                                                 y2p)))
        print(f"madd {crv}: {n} lanes, {ms:.4f} ms, outputs sha256 "
              f"{dig['madd'][:16]}", flush=True)
        # the ladder both ways, at the width asked for
        if args.w_bits != 8:
            c = ec_rns.ctx_for(crv, args.w_bits)
        w = c.n_windows
        per = (1 << c.w_bits) - 1
        stride = (N_KEYS + 1) * per
        rows = w * stride
        if args.w_bits == 8:
            _, _, tx = residues(ec_rns, c, rng, rows)
            _, _, ty = residues(ec_rns, c, rng, rows)
        else:
            _, _, pool = residues(ec_rns, c, rng, W_POOL)
            tx, ty = (pool[:, rng.integers(0, W_POOL, rows)]
                      for _ in range(2))
        tab = np.ascontiguousarray(np.concatenate([tx.T, ty.T], axis=1))
        d = rng.integers(0, per + 1, (w, n)).astype(np.int32)
        base = np.zeros(n, np.int32)
        base[n // 2:] = (rng.integers(0, N_KEYS, n - n // 2) + 1) * per
        tab_t, d, base = T(np.ascontiguousarray(tab.T)), T(d), T(base)
        rec = dict(windows=w, per_window_ms=cuda_ms(
            lambda: per_window(cuda_madd, c, tab_t, d, base, stride), 5))
        line = (f"ladder {crv}: {w} windows of {c.w_bits} bits over "
                f"{rows} rows, per-window path "
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
    # the Ed25519 ladder of one chunk
    c = er.ctx()
    tab_cols, tab, rows = (T(a) for a in ed_ladder_case(
        er, np.random.default_rng([SEED, len(CURVES)]), n))
    ms = cuda_ms(lambda: ed_ladder(cuda_edw, c, tab_cols, tab, rows), 5)
    edw_ms, by = kernel_ms(
        lambda: ed_ladder(cuda_edw, c, tab_cols, tab, rows), 2, "edw_kernel")
    out["by"]["edw"] = by
    via = "edw_window" if hasattr(cuda_edw, "edw_window") else \
        "gather + edw"
    out["ed_ladder"] = dict(windows=int(rows.shape[0]), ms=ms,
                            edw_ms=edw_ms, via=via)
    dig = out["digests"].setdefault("Ed25519", {})
    dig["ed_ladder"] = digest([t for pair in ed_ladder(
        cuda_edw, c, tab_cols, tab, rows) for t in pair])
    print(f"Ed25519 ladder: {n} lanes, {rows.shape[0]} windows ({via}) "
          f"{ms:.4f} ms, edw kernel {edw_ms:.4f} ms a launch (by {by}), "
          f"outputs sha256 {dig['ed_ladder'][:16]}", flush=True)
    mldsa_kernels(root, dev, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
