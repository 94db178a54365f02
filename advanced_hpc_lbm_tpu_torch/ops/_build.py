"""Build-at-first-use of the CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface under ``build/torch_kernels/`` of the checkout, named by a hash
of the sources and the flags, and the library is loaded with ctypes.  A
second call (or a second process) finds the library by its hash and does
not compile again.  Nothing here runs at import time: a host without nvcc
or a card imports this module freely and fails only when it asks for the
library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblbm_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, bool]:
    """Compile the library unless it is already built.  Returns (path,
    from_cache).  The compiler's report (registers, spills) is kept beside
    the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out, True
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *units],
            capture_output=True, text=True,
        )
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc {res.returncode}):\n{res.stderr[-4000:]}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, False


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, f32, i32 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.lbm_step.argtypes = [ptr, ptr, ptr, ptr, i32, i32, *[f32] * 6, ptr]
    lib.lbm_step.restype = i32
    lib.lbm_step_prepare.argtypes = []
    lib.lbm_step_prepare.restype = i32
    lib.lbm_step_block_shape.argtypes = [ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.lbm_step_block_shape.restype = None
    lib.lbm_error_string.argtypes = [i32]
    lib.lbm_error_string.restype = ctypes.c_char_p
    return lib
