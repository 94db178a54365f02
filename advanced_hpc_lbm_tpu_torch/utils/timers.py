"""Four-phase timers matching the reference CLI contract: Init / Compute /
Collate / Total, printed in the reference's format.  Collate is the
device-to-host transfer.  Each phase is the program span
``lbm.cli.<phase>`` (``utils/profiling.py``), timed on the monotonic
``time.perf_counter``."""

from __future__ import annotations

import time
from contextlib import contextmanager

from advanced_hpc_lbm_tpu_torch.utils import profiling


class PhaseTimers:
    def __init__(self) -> None:
        self.elapsed: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        with profiling.span(f"lbm.cli.{name}"):
            tic = time.perf_counter()
            try:
                yield
            finally:
                self.elapsed[name] = self.elapsed.get(name, 0.0) + time.perf_counter() - tic

    def report_lines(self) -> list[str]:
        """The four ``Elapsed ... time`` lines of the ``==done==`` block:
        Init, Compute, Collate and their sum; any other phase is left out."""
        total = sum(self.elapsed.get(k, 0.0) for k in ("init", "compute", "collate"))
        return [
            f"Elapsed Init time:\t\t\t{self.elapsed.get('init', 0.0):.6f} (s)",
            f"Elapsed Compute time:\t\t\t{self.elapsed.get('compute', 0.0):.6f} (s)",
            f"Elapsed Collate time:\t\t\t{self.elapsed.get('collate', 0.0):.6f} (s)",
            f"Elapsed Total time:\t\t\t{total:.6f} (s)",
        ]
