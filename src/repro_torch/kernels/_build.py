"""Build a kernel source under ``csrc/`` with ``nvcc`` and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, named by a
hash of the source, so an edited source rebuilds and an unchanged one is
loaded as it is.  ``build/`` is listed in ``.gitignore``.  Nothing here runs
at import: the CPU tests import every module of the port, and ``nvcc`` is
needed only when a kernel is first launched on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: building a CUDA kernel needs the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: keyed by a hash of its source and
    the compiler flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns the compiler's output (``-Xptxas -v`` register and spill
    report), empty when nothing was compiled.  Raises with the compiler's
    output when ``nvcc`` fails."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)     # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
