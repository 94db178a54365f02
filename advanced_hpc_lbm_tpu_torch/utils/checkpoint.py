"""Checkpoint / resume for long runs.

The counterpart of ``advanced_hpc_lbm_tpu.utils.checkpoint``, kept in the
port so that a host without JAX can snapshot and resume a run; both
packages read and write the same files, so a snapshot that either writes
resumes in the other.

The reference has none: its runs restart from the deterministic initial
condition, and final_state.dat is lossy (moments, not distributions).  A
snapshot holds the full distribution array plus the av-velocity history,
so a run resumes exactly.

Format: one ``step_XXXXXXXX.npz`` per snapshot (``step``, fp32 ``f``
(9, ny, nx), the ``av_vels`` prefix and, from a ``--debug`` run, the
``densities`` prefix), written to a temporary file, fsynced and atomically
renamed into place, then the directory fsynced; the oldest snapshots are
pruned beyond ``keep``.
"""

from __future__ import annotations

import os
import re
import tempfile
import warnings

import numpy as np

_PAT = re.compile(r"step_(\d{8})\.npz$")


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3) -> None:
        self.directory = str(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.npz")

    def save(
        self,
        step: int,
        f: np.ndarray,
        av_vels: np.ndarray,
        densities: np.ndarray | None = None,
    ) -> str:
        """Atomic snapshot after ``step`` completed steps.  ``densities``
        (the per-step total densities of a ``--debug`` run) is stored when
        given, so that a ``--debug`` run resumes with its density history
        aligned to ``av_vels``."""
        arrays = dict(
            step=np.int64(step),
            f=np.asarray(f, np.float32),
            av_vels=np.asarray(av_vels, np.float32),
        )
        if densities is not None:
            arrays["densities"] = np.asarray(densities, np.float32)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **arrays)
                # the rename below is atomic only for data on the disk
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self._path(step))
            dirfd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._prune()
        return self._path(step)

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _PAT.search(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(
        self,
    ) -> tuple[int, np.ndarray, np.ndarray, np.ndarray | None] | None:
        """Newest *readable* snapshot as ``(step, f, av_vels, densities)``
        (``densities`` is None for snapshots written without ``--debug``).
        A truncated or corrupt file (the machine died mid-write before the
        rename, or the disk damaged it after) is skipped with a warning and
        the previous snapshot is used."""
        for step in reversed(self.steps()):
            try:
                with np.load(self._path(step)) as z:
                    f = np.asarray(z["f"])
                    av = np.asarray(z["av_vels"])
                    if f.ndim != 3 or f.shape[0] != 9 or av.shape[0] != step:
                        raise ValueError(
                            f"inconsistent snapshot shapes f={f.shape} "
                            f"av={av.shape} step={step}"
                        )
                    dens = None
                    if "densities" in z.files:
                        dens = np.asarray(z["densities"])
                        if dens.shape[0] != step:
                            raise ValueError(
                                f"inconsistent snapshot densities shape "
                                f"{dens.shape} step={step}"
                            )
                    return int(z["step"]), f, av, dens
            except Exception as e:  # zipfile/KeyError/ValueError/OSError
                warnings.warn(
                    f"skipping unreadable checkpoint step_{step:08d}.npz: {e}"
                )
        return None

    def latest_step(self) -> int:
        """Step of the newest *readable* snapshot (0 if none): the same
        walk as :meth:`latest`, for callers that need only the resume
        point (``Simulation.warmup``).  ``steps()[-1]`` would disagree with
        ``latest()`` exactly when the newest file is unreadable."""
        latest = self.latest()
        return 0 if latest is None else latest[0]

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            os.unlink(self._path(s))
