"""The one boundary between the kernel wrappers and the kernel library
(:mod:`._build`): loading, error codes, the geometry and constants both
sides share, and the single-device wrappers' checks and state buffers."""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Callable

import torch

from advanced_hpc_lbm_tpu_torch.ops import _build, kernel_common, lattice
from advanced_hpc_lbm_tpu_torch.params import LBMParams

load = _build.load


def check(err: int, what: str) -> None:
    """Raise on an entry point's nonzero return code (a cudaError_t)."""
    if err != 0:
        name = load().lbm_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")


def checked(*agreements: tuple[str, tuple[int, ...], str]) -> Callable[[], ctypes.CDLL]:
    """A wrapper's access to the library: loads it at the first call and
    raises unless each ``(entry, want, what)`` holds, the C query ``entry``
    filling ``len(want)`` ints with the wrapper's ``want``."""
    @functools.cache
    def lib() -> ctypes.CDLL:
        loaded = load()
        for entry, want, what in agreements:
            ints = [ctypes.c_int() for _ in want]
            getattr(loaded, entry)(*map(ctypes.byref, ints))
            got = tuple(i.value for i in ints)
            if got != want:
                raise RuntimeError(f"{what} {got} != wrapper's {want}")
        return loaded
    return lib


def on_device(device: torch.device | str, call: Callable[[], int], what: str) -> None:
    """Nothing off CUDA; on a card, ``call()`` (an entry point, its return
    code checked) in the card's context, which is created first."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    with torch.cuda.device(device):
        torch.zeros(1, device=device)  # create the context first
        check(call(), what)


def consts(params: LBMParams) -> tuple[float, ...]:
    """The launch constants (``StepConsts``, field by field)."""
    c = kernel_common.step_constants(params)
    names = ("w0_omega", "w1_omega", "w2_omega", "one_minus_omega", "accel_w1", "accel_w2")
    return tuple(float(c[n]) for n in names)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def validate(f: torch.Tensor, mask: torch.Tensor, *bufs: torch.Tensor) -> None:
    """``f`` a contiguous (9, ny, nx) float32 state, ``mask`` its contiguous
    uint8 (ny, nx) mask, and ``bufs`` (outputs) on their device, none
    overlapping ``f``."""
    if f.dim() != 3 or f.shape[0] != lattice.NSPEEDS or f.dtype != torch.float32:
        raise ValueError(f"f must be (9, ny, nx) float32, got {tuple(f.shape)} {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("f must be contiguous")
    if mask.shape != f.shape[1:] or mask.dtype != torch.uint8 or not mask.is_contiguous():
        raise ValueError(
            f"mask must be contiguous uint8 {tuple(f.shape[1:])}, "
            f"got {mask.dtype} {tuple(mask.shape)}"
        )
    for t in (mask, *bufs):
        if t.device != f.device:
            raise ValueError(f"tensors on {t.device} and {f.device}")
    for b in bufs:
        if _overlap(b, f):
            raise ValueError("an output buffer aliases f: the step is out of place")


def validate_pass(f: torch.Tensor, mask: torch.Tensor, out: torch.Tensor | None,
                  partials: torch.Tensor, shape: tuple[int, ...]) -> None:
    """:func:`validate` of one pass from ``f`` into ``out`` (None: in
    place), a contiguous tensor shaped like ``f``, with ``partials`` a
    contiguous float32 tensor of ``shape``."""
    validate(f, mask, *(() if out is None else (out,)), partials)
    if out is not None and (out.shape != f.shape or out.dtype != f.dtype
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor shaped like f")
    if partials.shape != shape or partials.dtype != torch.float32 or not partials.is_contiguous():
        raise ValueError(f"partials must be {shape} float32")


def buffers(f0: torch.Tensor, donate: bool = False,
            spare: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The two ping-pong state buffers of a run loop: a copy of ``f0`` and
    a new tensor; with ``donate``, ``f0`` itself (which the run then
    overwrites; it must be contiguous) and ``spare``, or a new tensor.
    Donating keeps a run at two states on the device instead of three."""
    if not donate:
        return (f0.clone(memory_format=torch.contiguous_format),
                torch.empty_like(f0, memory_format=torch.contiguous_format))
    if not f0.is_contiguous():
        raise ValueError("a donated f0 must be contiguous")
    return f0, torch.empty_like(f0) if spare is None else spare
