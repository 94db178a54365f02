"""The benchmark of the PyTorch and CUDA port on one card.

    python3 portbench/run.py --workload ref1024.deck --seed 7 --seconds 45 --trace 0

Runs the cell's whole deck runs for ``--seconds`` (``harness.py``), checks
their outputs against the plain reference (``judge.py``) and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error.  Without a CUDA card, with fewer cards than
the cell asks for, or with JAX loaded once the window has closed, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # the start of set-up: before any import

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]  # the checkout: the program

# top-level module names the run must not hold once the window has closed:
# JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "advanced_hpc_lbm_tpu")


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    forbidden, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def card_report() -> str:
    """``nvidia-smi``'s name, clocks and power of the cards, or why not."""
    query = "name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return f"nvidia-smi ({query}): {res.stdout.strip() or res.stderr.strip()}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    spec = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell {args.workload} needs {chips} CUDA card(s); "
            f"this process sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    cell = harness.load_cell(args.workload)
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              traced=bool(args.trace), device="cuda:0",
                              t_process=T_PROCESS, log=log)
    log(card_report())
    loaded = forbidden_modules(sys.modules)
    if loaded:
        log(f"portbench: JAX or the JAX package was loaded: {', '.join(loaded)}")
        return 3
    for name, check in result["checks"].items():
        log(f"check {name}: {check['value']!r} (limit {check['limit']!r})")
        if not math.isfinite(check["value"]):
            check["value"] = None  # JSON has no infinity: a reading that is no number
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
