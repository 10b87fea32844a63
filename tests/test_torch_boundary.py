"""The port's import boundary: ``repro_torch`` loads without ``jax`` and
without anything of ``repro``, checked in a fresh interpreter and by a
scan of its sources."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

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
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert offenders == []
