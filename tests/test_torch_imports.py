"""The port stands alone: no jax, nothing of the JAX package, and the card
by default.

* Every module of `repro_torch`, and chip_smoke.py, imports in a fresh
  interpreter where ``import jax`` fails.
* A source scan finds no import of jax or of `repro` (the JAX package) in
  src/repro_torch/ or chip_smoke.py.  The pattern matches ``repro.`` and
  ``repro `` only, never the ``repro_torch`` prefix.
* `make_engine()` raises when there is no GPU instead of running on the
  CPU, and the `cuda` backend raises on a CPU tensor; so do the LM serving
  engines, which default to the card.
"""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import ComputeEngine, list_backends, make_engine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|repro)(?:[\s.,]|$)"
    r"|from\s+(?:jax|jaxlib|repro)(?:\.\S*)?\s+import\b)", re.M)

_BLOCKED_IMPORT = """
import importlib, pkgutil, runpy, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None   # any import of them raises ImportError
sys.path.insert(0, {src!r})
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
runpy.run_path({smoke!r}, run_name="chip_smoke_imported")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(mods))
"""


def test_every_port_module_imports_with_jax_blocked():
    code = _BLOCKED_IMPORT.format(src=str(ROOT / "src"),
                                  smoke=str(ROOT / "chip_smoke.py"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 42  # every module was walked


def test_forbidden_import_pattern_spares_the_port_prefix():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from repro.core import make_engine", "import repro",
                "  from repro import core", "import jaxlib"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("from repro_torch.core import make_engine",
               "import repro_torch", "# jax is not imported here",
               "from repro_torch import convert"):
        assert not _FORBIDDEN.search(ok), ok


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import_in_port_sources(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_default_engine_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("eager")
    eng = make_engine("eager", device="cpu")
    assert eng.device == torch.device("cpu") and eng.backend == "eager"
    assert ComputeEngine.backend == "cuda"
    assert set(list_backends()) >= {"ref", "eager", "cuda"}


def test_cuda_backend_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        make_engine("cuda", device="cpu")
    eng = ComputeEngine(backend="cuda", device=torch.device("cpu"))
    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng.matmul(x, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng.conv2d(torch.zeros(1, 4, 4, 2), torch.zeros(18, 3), size=3,
                   pad=1)


def test_lm_serving_engines_default_to_the_card(monkeypatch):
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.scheduler import PagedServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_arch("qwen2-0.5b"))
    for cls in (ServingEngine, PagedServingEngine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(cfg, {})


def test_unknown_backend_and_policy_fail_fast():
    with pytest.raises(ValueError, match="unknown backend"):
        make_engine("pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        make_engine("eager", "int8", device="cpu")


_SHARDED_IMPORT = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
sys.path.insert(0, {src!r})
from repro_torch.core import list_backends
from repro_torch.core import shard_backend
from repro_torch.kernels import sharded
from repro_torch.launch import mesh, mesh_checks
from repro_torch.sharding import hints
assert "sharded_cuda" in list_backends()
print("ok")
"""


def test_the_mesh_modules_import_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _SHARDED_IMPORT.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "ok"
