"""ctypes bridge to the port's host-side codec (``csrc/fastio.c``).

Formatting a 4096x4096 ``final_state.dat`` is ~16.8M lines of printf's
format, which C does many times faster than Python, and on several threads
faster again; the codec makes the digits itself, not through printf.
The codec is optional: when ``cc`` is missing or the build fails, every
caller (``utils/io.py``) takes its pure-Python path, which writes the same
bytes many times slower, and the process says so once on stderr, with the
reason.

At first use ``cc`` compiles ``csrc/fastio.c``, which ships inside the
package, into ``build/torch_native/`` beside the package, under a name
keyed by a hash of the source and the flags, and renames it into place
atomically, so that concurrent processes see the whole library or none.
Nothing happens at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from advanced_hpc_lbm_tpu_torch.utils import profiling

SRC = Path(__file__).resolve().parents[1] / "csrc" / "fastio.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CFLAGS = ("-O2", "-shared", "-fPIC", "-pthread")


def _cc() -> str | None:
    return shutil.which(os.environ.get("CC", "cc"))


def library_path() -> Path:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libfastio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless it is already built; raises OSError, with
    the reason, when there is no source or no ``cc``, the build directory
    cannot be written, or the compiler fails (its last error line)."""
    if not SRC.exists():
        raise OSError(f"no source {SRC}")
    out = library_path()
    if out.exists():
        return out
    cc = _cc()
    if cc is None:
        raise OSError(f"no C compiler: {os.environ.get('CC', 'cc')} is not on PATH")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    except OSError as e:
        raise OSError(f"cannot write the build directory {BUILD_DIR}: {e}") from None
    try:
        tmp = tmpdir / "lib.so"
        res = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            lines = [ln.strip() for ln in res.stderr.splitlines() if ln.strip()]
            errors = [ln for ln in lines if "error" in ln] or lines or ["no message"]
            raise OSError(f"{cc} failed on {SRC} (exit {res.returncode}): {errors[-1]}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


class FinalStateStats(ctypes.Structure):
    """``lbm_final_state_stats``: what a final_state.dat write did."""

    _fields_ = [(name, ctypes.c_int64) for name in
                ("blocks", "threads", "format_ns", "write_ns", "wait_ns", "bytes",
                 "fallback")]


class AvVelsStats(ctypes.Structure):
    """``lbm_av_vels_stats``: what an av_vels.dat write did."""

    _fields_ = [(name, ctypes.c_int64) for name in ("format_ns", "write_ns", "bytes",
                                                     "fallback")]


def _as_dict(stats: ctypes.Structure) -> dict[str, int]:
    return {name: getattr(stats, name) for name, _ in stats._fields_}


@functools.cache
def _library() -> ctypes.CDLL | None:
    """The loaded codec, or None after one line on stderr that says why it
    cannot be had and that the deck files go through Python instead."""
    try:
        with profiling.span("lbm.io.codec_library") as sp:
            sp.set(built=int(SRC.exists() and not library_path().exists()))
            path = build()
            lib = ctypes.CDLL(str(path))
    except OSError as e:  # no build, or a library the loader refuses
        print(f"advanced_hpc_lbm_tpu_torch: the output codec is not available ({e}); "
              "reading and writing the deck files in Python, the same bytes, "
              "slower", file=sys.stderr, flush=True)
        return None
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.lbm_write_final_state.restype = ctypes.c_int
    lib.lbm_write_final_state.argtypes = [
        ctypes.c_char_p, f32, f32, f32, f32, u8,
        ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.POINTER(FinalStateStats),
    ]
    lib.lbm_write_av_vels.restype = ctypes.c_int
    lib.lbm_write_av_vels.argtypes = [ctypes.c_char_p, f64, ctypes.c_long,
                                      ctypes.POINTER(AvVelsStats)]
    lib.lbm_parse_obstacles.restype = ctypes.c_long
    lib.lbm_parse_obstacles.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, u8, ctypes.POINTER(ctypes.c_long),
    ]
    return lib


def available() -> bool:
    """Whether the codec is built (building it now if it can be)."""
    return _library() is not None


def _require() -> ctypes.CDLL:
    lib = _library()
    if lib is None:
        raise RuntimeError("native codec not built")
    return lib


def default_threads() -> int:
    """The final-state writer's thread count: the cores this process may
    run on."""
    return len(os.sched_getaffinity(0))


def write_final_state(path: str | os.PathLike, planes, obstacles: np.ndarray, *,
                      quirk: bool = True, threads: int | None = None) -> dict[str, int]:
    """Write final_state.dat from the float32 (ny, nx) planes (u_x, u_y,
    ||u||, pressure) of ``io.final_state_planes`` and the (ny, nx) obstacle
    mask, whose transposed read (``quirk``) or own cell fills the last
    column, formatting on ``threads`` threads (default
    :func:`default_threads`).  The bytes do not depend on ``threads``.
    Returns the codec's counts (:class:`FinalStateStats`): blocks of 64 Ki
    lines, threads that formatted one or more, nanoseconds formatting and
    writing (summed over the threads) and waiting for a turn, bytes, and
    the numbers handed to libc's ``snprintf`` (``fallback``: those the
    codec's own ``%.12E`` cannot make exactly; 0 for float32 values in
    about [1e-32, 1e13) and zeros)."""
    lib = _require()
    obst = np.ascontiguousarray(obstacles, dtype=bool)
    ny, nx = obst.shape
    ux, uy, u, p = (np.ascontiguousarray(a, dtype=np.float32) for a in planes)
    if any(a.shape != (ny, nx) for a in (ux, uy, u, p)):
        raise ValueError(f"planes {[a.shape for a in (ux, uy, u, p)]} != mask {(ny, nx)}")
    threads = default_threads() if threads is None else threads
    if threads < 1:
        raise ValueError(f"threads must be at least 1, got {threads}")
    stats = FinalStateStats()
    rc = lib.lbm_write_final_state(str(path).encode(), ux, uy, u, p, obst.view(np.uint8),
                                   nx, ny, int(quirk), threads, ctypes.byref(stats))
    if rc != 0:
        raise OSError(f"lbm_write_final_state failed with rc={rc} ({path})")
    return _as_dict(stats)


def write_av_vels(path: str | os.PathLike, av: np.ndarray) -> dict[str, int]:
    """Write av_vels.dat; returns the codec's counts (:class:`AvVelsStats`):
    nanoseconds formatting and writing, bytes, and the numbers handed to
    ``snprintf`` (as :func:`write_final_state`'s ``fallback``)."""
    lib = _require()
    av = np.ascontiguousarray(av, dtype=np.float64).reshape(-1)
    stats = AvVelsStats()
    rc = lib.lbm_write_av_vels(str(path).encode(), av, av.size, ctypes.byref(stats))
    if rc != 0:
        raise OSError(f"lbm_write_av_vels failed with rc={rc} ({path})")
    return _as_dict(stats)


_PARSE_ERRORS = {
    -2: "expected 3 values per line in obstacle file",
    -3: "obstacle x-coord out of range",
    -4: "obstacle y-coord out of range",
    -5: "obstacle blocked value should be 1",
}


def parse_obstacles(path: str | os.PathLike, nx: int, ny: int) -> np.ndarray:
    """The obstacle deck as a (ny, nx) bool mask; raises OSError when the
    file cannot be opened and ValueError, with the reference's message and
    the line, on a malformed deck."""
    lib = _require()
    mask = np.zeros(ny * nx, dtype=np.uint8)
    err_line = ctypes.c_long(0)
    rc = lib.lbm_parse_obstacles(str(path).encode(), nx, ny, mask, ctypes.byref(err_line))
    if rc == -1:
        raise OSError(f"could not open input obstacles file: {path}")
    if rc < 0:
        msg = _PARSE_ERRORS.get(int(rc), "malformed obstacle file")
        raise ValueError(f"{msg} ({path}:{err_line.value})")
    return mask.reshape(ny, nx).astype(bool)
