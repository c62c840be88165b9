"""Build the package's CUDA kernels at first use and load them.

Each ``gpu/csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface under ``build/cap_tpu_torch/`` (at the
root of the checkout, listed in ``.gitignore``), named by a hash of its
sources and flags so an edit rebuilds it. Libraries load with
``ctypes``: pointers and the stream go as ``c_void_p``, every entry
point returns ``cudaGetLastError()``. Nothing here includes PyTorch's
headers, so a build takes seconds, not minutes.

``build_all()`` starts one ``nvcc`` per source, all together, and
waits for them; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "gpu" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cap_tpu_torch"
KERNELS = ("redc", "madd", "ladder", "edw", "keccak", "ntt")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # The base extensions' α is a float32 sum of products with
    # separate roundings; a fused multiply-add would change it.
    "-fmad=false",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall time of its nvcc, "ptxas": register/spill
# report}, for the builds this process ran
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                       "build the cap_tpu_torch kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Build every named kernel library that is missing, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": out}
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if missing)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
