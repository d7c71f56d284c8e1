"""Build and load the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with :mod:`ctypes`. The
library lands in ``build/uccl_tpu_torch/`` at the repository root, named by a
hash of the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source or header rebuilds and an unchanged one loads at once.
``nvcc``'s report (``-Xptxas -v``: registers, shared memory and spills per
kernel) is kept beside the library as ``<lib>.log``.

Nothing here runs at import: the CPU tests import every module of the port
on machines with no ``nvcc``.

JAX counterpart: none. The JAX package compiles its Pallas kernels through
XLA at trace time; its C++ host runtime builds with ``native/Makefile``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "uccl_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``. Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of uccl_tpu_torch are built at first use and need the "
        "CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Writes to a temporary name and renames, so a concurrent or interrupted
    build never leaves a half-written library behind."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    Path(str(out) + ".log").write_text(log)
    os.replace(tmp, out)
    return out


def build_variant(name: str, tag: str, subs) -> Path:
    """Compile a copy of ``csrc/<name>.cu`` with text substitutions into
    ``build/uccl_tpu_torch/variants/<tag>/`` and return the library's path.
    Each ``(old, new)`` pair of ``subs`` must match exactly once. For timing
    a design change or planting a fault on the card without touching the
    source; the package itself never loads a variant."""
    src = (CSRC_DIR / f"{name}.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"variant {tag}: {old!r} occurs {src.count(old)} times in "
                             f"csrc/{name}.cu, not once")
        src = src.replace(old, new)
    out_dir = BUILD_DIR / "variants" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.cu").write_text(src)
    out = out_dir / f"lib{name}.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out),
           str(out_dir / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {tag} of csrc/{name}.cu:\n"
                           f"{proc.stdout + proc.stderr}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's report for the current build of ``csrc/<name>.cu``."""
    p = Path(str(library_path(name)) + ".log")
    return p.read_text() if p.exists() else ""
