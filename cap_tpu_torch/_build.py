"""Build the package's native code at first use and load it.

Each ``gpu/csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface under ``build/cap_tpu_torch/`` (at the
root of the checkout, listed in ``.gitignore``), named by a hash of its
sources and flags so an edit rebuilds it. Libraries load with
``ctypes``: pointers and the stream go as ``c_void_p``, every entry
point returns ``cudaGetLastError()``. Nothing here includes PyTorch's
headers, so a build takes seconds, not minutes.

The host side's native code compiles with ``g++`` the same way, into
the same directory: ``jose`` (``runtime/native/jose_native.cpp``: the
batch JOSE parse, SHA-2 and record packer, loaded with ``ctypes``),
``claims`` (``runtime/native/claims_ext.cpp``: the ``_capclaims``
CPython extension, built against the running interpreter's headers and
named with its ABI suffix), ``claims_rules``
(``runtime/native/claims_validate.cpp``: the OIDC claims-rule engine,
loaded with ``ctypes`` by ``oidc.claims_native``), ``serve`` (the
native serve chain of ``serve.native_serve``: ``serve_native.cpp``, the
telemetry plane ``telemetry_native.cpp`` and the shared-memory rings
``shm_ring.cpp``, linked with ``jose_native.cpp`` for the readers'
``sha2::sha256``) and ``client`` (``serve/native/client_native.cpp``,
the C client of ``serve.native_client``). A target's name hashes every
source and header it compiles. No ``-march=native``: the SHA-NI path is
chosen at run time, and the build directory may be shared by hosts.

``build_all()`` starts one compiler per target, all together, and
waits for them; a missing compiler or a failed build raises with the
compiler's output. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Any, Dict, Sequence

CSRC = Path(__file__).resolve().parent / "gpu" / "csrc"
HOST_SRC = Path(__file__).resolve().parent / "runtime" / "native"
CLIENT_SRC = Path(__file__).resolve().parent / "serve" / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cap_tpu_torch"
KERNELS = ("redc", "madd", "ladder", "edw", "keccak", "ntt")
# g++ targets: name -> (the sources compiled into one library, the
# headers they include), in HOST_SRC (``client``'s in CLIENT_SRC)
HOST_TARGETS = {
    "jose": (("jose_native.cpp",), ()),
    "claims": (("claims_ext.cpp",), ("claims_tape.h",)),
    "claims_rules": (("claims_validate.cpp",), ("claims_tape.h",)),
    "serve": (("jose_native.cpp", "serve_native.cpp",
               "telemetry_native.cpp", "shm_ring.cpp"),
              ("cvb1_wire.h", "shm_ring.h", "telemetry_native.h")),
    "client": (("client_native.cpp",), ()),
}
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")
# the claims extension's module name (its PyInit__capclaims)
CLAIMS_MODULE = "_capclaims"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # The base extensions' α is a float32 sum of products with
    # separate roundings; a fused multiply-add would change it.
    "-fmad=false",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, Any] = {}
# name -> {"seconds": wall time of its compiler, "ptxas": its output
# (nvcc's register/spill report)}, for the builds this process ran
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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: a host C++ compiler is required to "
                       "build the cap_tpu_torch batch prep")


def _host_dir(name: str) -> Path:
    return CLIENT_SRC if name == "client" else HOST_SRC


def _host_flags(name: str) -> tuple:
    if name == "claims":
        return HOST_FLAGS + ("-I" + sysconfig.get_paths()["include"],)
    return HOST_FLAGS


def _target(name: str) -> Path:
    if name in HOST_TARGETS:
        srcs, headers = HOST_TARGETS[name]
        flags, files = _host_flags(name), [*srcs, *headers]
        h = hashlib.sha256(" ".join(flags).encode())
        for f in files:
            h.update(f.encode())
            h.update((_host_dir(name) / f).read_bytes())
        if name == "claims":
            suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
            return BUILD_DIR / f"{CLAIMS_MODULE}-{h.hexdigest()[:16]}{suffix}"
        return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    if name in HOST_TARGETS:
        return [_gxx(), *_host_flags(name), "-o", str(out),
                *(str(_host_dir(name) / f) for f in HOST_TARGETS[name][0])]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str] = KERNELS + tuple(HOST_TARGETS)
              ) -> Dict[str, Path]:
    """Build every named library that is missing, in parallel: the
    kernels with nvcc, the host targets with g++."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    # every command first, so a missing compiler raises before any starts
    cmds = {}
    for name, out in targets.items():
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmds[name] = (_command(name, tmp), tmp)
    procs = {}
    for name, (cmd, tmp) in cmds.items():
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": out}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("the build failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing): a kernel
    library, ``jose``, ``claims_rules``, ``serve`` or ``client``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def load_claims():
    """The ``_capclaims`` extension module (built first if missing),
    loaded from its file without entering ``sys.modules``."""
    import importlib.machinery
    import importlib.util

    with _LOCK:
        mod = _LIBS.get("claims")
        if mod is None:
            path = build_all(["claims"])["claims"]
            loader = importlib.machinery.ExtensionFileLoader(
                CLAIMS_MODULE, str(path))
            spec = importlib.util.spec_from_loader(CLAIMS_MODULE, loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _LIBS["claims"] = mod
        return mod
