"""The port's import boundary: ``repro_torch`` loads without ``jax`` and
without anything of ``repro``, checked in a fresh interpreter and by a
scan of its sources, ``chip_smoke.py``, the port's example scripts
(``examples/torch_*.py``) and its chip tools (``tools/*.py``)."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))

CHILD = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""


def test_import_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", CHILD], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    n_modules = len([p for p in PKG.rglob("*.py") if p.name != "__init__.py"])
    assert int(out.stdout.strip()) >= n_modules


def test_sources_import_no_jax_and_no_repro():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES + sorted((ROOT / "tools").glob("*.py"))
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert offenders == []


EXAMPLE_CHILD = """
import runpy, sys
for path in sys.argv[1:]:
    runpy.run_path(path, run_name="example")  # defines main, runs nothing
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(sys.argv) - 1)
"""


def test_examples_load_no_jax_and_no_repro():
    """The four port examples import in a fresh interpreter without jax or
    ``repro``."""
    assert [p.name for p in EXAMPLES] == ["torch_plan_and_serve_rpq.py", "torch_quickstart.py",
                                          "torch_train_gnn.py", "torch_train_lm.py"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", EXAMPLE_CHILD, *map(str, EXAMPLES)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(EXAMPLES)
