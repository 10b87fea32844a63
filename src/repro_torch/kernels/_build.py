"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file with a plain C interface under a
``csrc/`` directory of its package.  :func:`load` compiles it at first
use with ``nvcc`` for ``sm_90a`` into a shared library and opens it with
``ctypes``.  Libraries go to ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and
the flags, so an edited source builds anew and an unchanged one loads
from disk.

Nothing here runs at import: the CPU tests import every module, and a
machine without a GPU may have no ``nvcc``.  :func:`build_all` starts one
``nvcc`` per source at once, so a fresh checkout builds in the time of
the slowest source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG_ROOT = Path(__file__).resolve().parents[1]  # src/repro_torch
BUILD_DIR = _PKG_ROOT.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> source, relative to src/repro_torch
SOURCES = {
    "fused_level": "kernels/frontier/csrc/fused_level.cu",
    "embedbag": "kernels/embedbag/csrc/embedbag.cu",
    "decode_attn": "kernels/decode_attn/csrc/decode_attn.cu",
}

# kernel name -> {"seconds": nvcc wall time or None when loaded from disk,
# "ptxas": the compiler's resource report}
BUILD_LOG: dict[str, dict] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (_PKG_ROOT / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile(name: str, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG_ROOT / SOURCES[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees half a file
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stdout.strip()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if path.exists():
            BUILD_LOG[name] = {"seconds": None, "ptxas": ""}
        else:
            _compile(name, path)
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def build_all() -> None:
    """Load every kernel of :data:`SOURCES`, building the missing ones in
    parallel: one ``nvcc`` process per source, all started together."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        for fut in [pool.submit(load, name) for name in SOURCES]:
            fut.result()
