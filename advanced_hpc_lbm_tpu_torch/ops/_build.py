"""Build-at-first-use of the CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all started
together) and links them into one shared library with a plain C interface
under ``build/torch_kernels/`` of the checkout, named by a hash of the
sources and the flags, and the library is loaded with ctypes.  A
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

from advanced_hpc_lbm_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# --split-compile=0: the optimiser runs on as many threads as there are
# cores (the K-step source holds 28 kernel bodies)
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-fmad=false", "--split-compile=0",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = (*ARCH, "-shared")


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblbm_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands side by side; (returncode, stdout + stderr) each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    results = []
    for p in procs:
        out, _ = p.communicate()
        results.append((p.returncode, out))
    return results


def build() -> tuple[Path, bool]:
    """Compile the library unless it is already built.  Returns (path,
    from_cache).  One nvcc per source compiles the objects in parallel, a
    last one links them.  The compiler's report (registers, spills) is kept
    beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out, True
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = sorted(CSRC.glob("*.cu"))
    tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmpdir / f"{u.stem}.o" for u in units]
        results = _run_all([
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(u)]
            for u, o in zip(units, objs)
        ])
        if all(rc == 0 for rc, _ in results):
            results += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmpdir / "lib.so"),
                                  *map(str, objs)]])
        log = "".join(text for _, text in results)
        out.with_suffix(".log").write_text(log)
        if any(rc != 0 for rc, _ in results):
            rc = next(rc for rc, _ in results if rc != 0)
            raise RuntimeError(f"nvcc failed (rc {rc}):\n{log[-4000:]}")
        os.replace(tmpdir / "lib.so", out)  # atomic: a concurrent loader sees all or none
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out, False


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared."""
    with profiling.span("lbm.ops.library") as sp:
        path, cached = build()
        sp.set(built=int(not cached))
        lib = ctypes.CDLL(str(path))
    ptr, f32, i32, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
    consts = [f32] * 6  # StepConsts, field by field
    signatures = {
        # name: (argtypes, restype)
        "lbm_step": ([ptr, ptr, ptr, ptr, i32, i32, *consts, ptr], i32),
        "lbm_step_prepare": ([], i32),
        "lbm_step_block_shape": ([ctypes.POINTER(i32)] * 2, None),
        "lbm_resident_chunk": ([ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, *consts,
                                ptr], i32),
        "lbm_resident_prepare": ([], i32),
        "lbm_resident_coop_limits": ([i32, ctypes.POINTER(i32), ctypes.POINTER(i32)], i32),
        "lbm_resident_coop_k": ([i32, i32], i32),
        "lbm_resident_coop_segments": ([i32, i32, i32], i32),
        "lbm_resident_coop_grid": ([i32, i32, i32], i32),
        "lbm_resident_coop_scratch": ([i32, i32, ctypes.POINTER(i64)], i32),
        "lbm_resident_banded_chunk": ([ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                       *consts, ptr], i32),
        "lbm_resident_banded_limits": ([i32, ctypes.POINTER(i32), ctypes.POINTER(i32)], i32),
        "lbm_resident_banded_fits": ([i32, i32], i32),
        "lbm_resident_banded_depth": ([i32, i32], i32),
        "lbm_resident_banded_smem": ([i32], i64),
        "lbm_resident_banded_scratch": ([i32, i32, ctypes.POINTER(i64)], i32),
        "lbm_kstep": ([ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, *consts, ptr], i32),
        "lbm_kstep_prepare": ([i32], i32),
        "lbm_kstep_tile_shape": ([ctypes.POINTER(i32)] * 2, None),
        "lbm_kstep_blocks_per_sm": ([i32, i32], i32),
        "lbm_kstep_schedule": ([i32, ctypes.POINTER(i32), ctypes.POINTER(i32)], i32),
        "lbm_kstep_bulk_tiles": ([i32, i32, i32], i32),
        "lbm_kstep_walks": ([i32, i32], i32),
        "lbm_kstep_item": ([i32, i32, i32, ctypes.POINTER(i32)], i32),
        "lbm_local_ca": ([ptr, i64, ptr, i64, ptr, ptr, i32, i32, i32, *consts, ptr], i32),
        "lbm_local_step": ([ptr, i64, i32, ptr, i32, ptr, ptr, i64, i32, ptr, i32, i32,
                            i32, *consts, ptr], i32),
        "lbm_local_prepare": ([], i32),
        "lbm_local_block_shape": ([ctypes.POINTER(i32)] * 2, None),
        "lbm_stream": ([ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, *consts, ptr], i32),
        "lbm_stream_snapshot": ([ptr, ptr, ptr, i32, i32, ptr], i32),
        "lbm_stream_prepare": ([], i32),
        "lbm_stream_geometry": ([ctypes.POINTER(i32)] * 3, None),
        "lbm_stream_blocks_per_sm": ([], i32),
        "lbm_error_string": ([i32], ctypes.c_char_p),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib
