"""cap_tpu_torch stands alone: no jax, nothing of cap_tpu, the card by
default."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "cap_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).replace(
        ".__init__", "")
    for p in PKG.rglob("*.py"))


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_cap_tpu_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "cap_tpu"}, (path, roots)


def _env_reads(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and node.attr in ("environ", "environb", "getenv",
                                  "getenvb", "putenv")
                and isinstance(node.value, ast.Name)
                and node.value.id == "os"):
            yield node.lineno
        elif (isinstance(node, ast.ImportFrom) and node.module == "os"
              and any(a.name in ("environ", "environb", "getenv",
                                 "getenvb") for a in node.names)):
            yield node.lineno


@pytest.mark.parametrize(
    "path", sorted(p for p in PKG.rglob("*.py") if p.name != "_build.py"),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_environment_reads(path):
    """Knobs are arguments: no module but the build's toolchain lookup
    reads the environment."""
    assert not list(_env_reads(path)), path


def test_serve_modules_are_covered():
    for name in ("cap_tpu_torch.telemetry", "cap_tpu_torch.obs.decision",
                 "cap_tpu_torch.obs.occupancy", "cap_tpu_torch.serve",
                 "cap_tpu_torch.serve.protocol", "cap_tpu_torch.serve.drr",
                 "cap_tpu_torch.serve.admission",
                 "cap_tpu_torch.serve.vcache", "cap_tpu_torch.serve.batcher",
                 "cap_tpu_torch.serve.client", "cap_tpu_torch.serve.worker",
                 "cap_tpu_torch.serve.native_serve",
                 "cap_tpu_torch.serve.native_client",
                 "cap_tpu_torch.serve.shm_ring",
                 "cap_tpu_torch.serve.shm_client",
                 "cap_tpu_torch.fleet.worker_main",
                 "cap_tpu_torch.serve.obs", "cap_tpu_torch.obs.slo",
                 "cap_tpu_torch.obs.postmortem", "cap_tpu_torch.keyplane",
                 "cap_tpu_torch.keyplane.source",
                 "cap_tpu_torch.keyplane.refresher",
                 "cap_tpu_torch.keyplane.plane",
                 "cap_tpu_torch.parallel", "cap_tpu_torch.parallel.place",
                 "cap_tpu_torch.fleet", "cap_tpu_torch.fleet.pool",
                 "cap_tpu_torch.fleet.router", "cap_tpu_torch.fleet.chaos",
                 "cap_tpu_torch.fleet.autoscale",
                 "cap_tpu_torch.fleet.frontdoor"):
        assert name in MODULES, name


def test_utils_exports_equal_the_reference():
    """``cap_tpu_torch.utils`` re-exports the reference's three names
    (ROADMAP C.4)."""
    import cap_tpu.utils as j_utils

    import cap_tpu_torch.utils as t_utils
    from cap_tpu_torch.utils import (  # noqa: F401
        random_base62,
        remove_duplicates_stable,
        str_list_contains,
    )

    assert t_utils.__all__ == j_utils.__all__
    for name in j_utils.__all__:
        assert getattr(t_utils, name).__module__.replace(
            "cap_tpu_torch.", "cap_tpu.") == getattr(j_utils,
                                                     name).__module__


@pytest.mark.parametrize("pkg,left_out", [
    ("obs", set()), ("keyplane", set()),
    ("fleet", set()),
    ("parallel", None)])
def test_package_exports_equal_the_reference(pkg, left_out):
    """The ported packages export the reference's names. ``parallel``:
    the reference's package names (it has no ``__all__``: the mesh
    functions), then the placement names of its ``place`` module."""
    import importlib
    import inspect

    t_mod = importlib.import_module(f"cap_tpu_torch.{pkg}")
    j_mod = importlib.import_module(f"cap_tpu.{pkg}")
    if left_out is None:
        j_place = importlib.import_module(f"cap_tpu.{pkg}.place")
        mesh_names = sorted(n for n in dir(j_mod) if not n.startswith("_")
                            and not inspect.ismodule(getattr(j_mod, n)))
        assert mesh_names == ["make_mesh", "sharded_rs256_verify",
                              "sharded_verify_step"]
        place_names = ["PlacementError", "WorkerPlacement",
                       "assert_single_owner", "single_owner_placement"]
        assert t_mod.__all__ == mesh_names + place_names
        for name in t_mod.__all__:
            ref = getattr(j_mod, name, None) or getattr(j_place, name)
            assert getattr(t_mod, name).__name__ == ref.__name__
        t_place = importlib.import_module(f"cap_tpu_torch.{pkg}.place")
        for name in ("batch_axis", "shard_batch", "replicated"):
            assert callable(getattr(t_place, name))
            assert callable(getattr(j_place, name))
        return
    assert sorted(t_mod.__all__) == sorted(set(j_mod.__all__) - left_out)
    for name in t_mod.__all__:
        assert getattr(t_mod, name) is not None


def test_imports_with_jax_blocked():
    """Every module imports in a fresh interpreter where ``import jax``
    and ``import cap_tpu`` fail."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cap_tpu'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in "
        "sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_keyset_defaults_to_the_card(monkeypatch):
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.jwt.jwk import JWK
    from cap_tpu_torch.gpu.ec import HostECPublicKey, curve

    cp = curve("P-256")
    jwks = [JWK(HostECPublicKey("P-256", cp.gx, cp.gy), kid="g")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPUBatchKeySet(jwks)
    ks = GPUBatchKeySet(jwks, device="cpu")
    assert ks.device.type == "cpu"


def test_wrappers_take_the_plain_path_only_on_cpu_tensors():
    """On CPU tensors the wrappers run their plain versions and count
    no launch; on a non-CPU, non-CUDA device they refuse."""
    from cap_tpu_torch.gpu import (
        cuda_edw,
        cuda_madd,
        cuda_redc,
        ec_rns,
        ed25519_rns,
    )

    c = ec_rns.ctx_for("P-256")
    ia, ib = c.A.count, c.B.count
    xA = torch.zeros((ia, 4), dtype=torch.int32)
    xB = torch.zeros((ib, 4), dtype=torch.int32)
    before = (cuda_redc.launches, cuda_madd.launches, cuda_edw.launches)
    tA, tB = cuda_redc.redc(c, xA, xB)
    rA, rB = cuda_redc.redc_ref(c, xA, xB)
    assert torch.equal(tA, rA) and torch.equal(tB, rB)
    g = torch.zeros((max(ia, ib), 4), dtype=torch.int32)
    m = torch.zeros(4, dtype=torch.bool)
    cuda_madd.madd(c, (xA, xB), (xA, xB), (xA, xB), m, m, g, g)
    ce = ed25519_rns.ctx()
    tab = torch.zeros((4, 3 * ce.A.count), dtype=torch.int32)
    rows = torch.zeros(4, dtype=torch.int32)
    out = cuda_edw.edw_window(ce, *[(xA, xB)] * 4, tab, rows)
    ref = cuda_edw.edw_window_ref(ce, *[(xA, xB)] * 4, tab, rows)
    assert all(torch.equal(a, b) for p, q in zip(out, ref)
               for a, b in zip(p, q))
    assert (cuda_redc.launches, cuda_madd.launches,
            cuda_edw.launches) == before
    with pytest.raises(ValueError):
        cuda_redc.redc(c, xA.to("meta"), xB.to("meta"))
    with pytest.raises(ValueError):
        cuda_edw.edw_window(ce, *[(xA.to("meta"), xB.to("meta"))] * 4,
                            tab, rows)
