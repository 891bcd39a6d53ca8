"""Build the port's host C++ library from the sources in ``src/``.

The counterpart of ``cylon_tpu/native/build.py``: one ``g++`` call, since
the library has no dependencies, at first use.  The library goes into
``build/cylon_tpu_torch/native/`` at the root of the checkout, never into
the package, and its name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one reused.  It compiles to a
temporary name and renames, so concurrent first users (pytest-xdist
workers) never load a half-written library.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "src"
INCLUDE_DIR = _HERE / "include"
BUILD_DIR = _HERE.parent.parent / "build" / "cylon_tpu_torch" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]


def _sources():
    return sorted(SRC_DIR.glob("*.cpp"))


def lib_path() -> Path:
    """The library's path for the sources as they stand now."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in sorted(SRC_DIR.iterdir()) + sorted(INCLUDE_DIR.iterdir()):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libcylon_tpu_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path.  A failed
    build raises with the compiler's error."""
    lib = lib_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
    cxx = os.environ.get("CXX", "g++")  # cylint: disable=CY102 -- the compiler to build with (CXX), the build environment's own variable, not a CYLON_TPU_* knob
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp)] + [str(s) for s in _sources()]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        err = proc.stderr if proc.returncode else None
    except OSError as e:  # no compiler
        err = str(e)
    if err is not None:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{err}")
    os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    print(build())
