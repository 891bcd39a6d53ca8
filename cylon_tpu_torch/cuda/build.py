"""Build and load the package's CUDA kernels.

Each ``*.cu`` source in this directory is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first use,
under ``build/cylon_tpu_torch/`` at the root of the checkout, and loaded
with ``ctypes``.  The library name carries a hash of the source, so an
edited source is rebuilt and an unchanged one is reused.
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
from typing import Callable, Dict, Tuple

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent.parent / "build" / "cylon_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# source name -> (seconds spent building, nvcc's output); empty when the
# library was already built
BUILD_INFO: Dict[str, Tuple[float, str]] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: str) -> Path:
    src = _HERE / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``source`` unless its library already exists; returns the
    library's path.  Writes to a temporary name and renames, so a build
    that is cut off leaves nothing that looks finished."""
    so = library_path(source)
    if so.exists():
        BUILD_INFO.setdefault(source, (0.0, ""))
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(_HERE / source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    BUILD_INFO[source] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return so


def load(source: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed;
    ``declare`` sets its functions' argtypes and restype once, on load."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            declare(lib)
            _libs[source] = lib
        return lib
