"""Four-phase wall-clock timers matching the reference CLI contract:
Init / Compute / Collate / Total, printed in the reference's format.
Collate is the device-to-host transfer."""

from __future__ import annotations

import time
from contextlib import contextmanager


class PhaseTimers:
    def __init__(self) -> None:
        self.elapsed: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        tic = time.time()
        try:
            yield
        finally:
            self.elapsed[name] = self.elapsed.get(name, 0.0) + time.time() - tic

    def report_lines(self) -> list[str]:
        """The four ``Elapsed ... time`` lines of the ``==done==`` block."""
        total = sum(self.elapsed.get(k, 0.0) for k in ("init", "compute", "collate"))
        return [
            f"Elapsed Init time:\t\t\t{self.elapsed.get('init', 0.0):.6f} (s)",
            f"Elapsed Compute time:\t\t\t{self.elapsed.get('compute', 0.0):.6f} (s)",
            f"Elapsed Collate time:\t\t\t{self.elapsed.get('collate', 0.0):.6f} (s)",
            f"Elapsed Total time:\t\t\t{total:.6f} (s)",
        ]
