"""The readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload ref1024.deck --seeds 1,2,3 --control-seeds 4,5,6

For each of ``--seeds``, one solve of the program as the window runs it,
its files then written as the judged ones are, compared with the reference
(``judge.py``): the lower readings.  For each of ``--control-seeds``, the
control, the reference computed with TF32 operands (``reference/lbm.py``)
put in the program's place and compared the same way: the upper readings.
One JSON line per seed, with the harness's verdict under the cell's
limits (``judge.verdict``), then the largest program reading and the
smallest control reading of each number.  Exits 1 where a program seed
reads not correct or a control seed reads correct.  Needs a CUDA card, as
a run does; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def reading(cell, kind: str, seed: int, device) -> dict:
    """The numbers of ``seed``: the program's solve (``kind`` "program"),
    or the control put in its place ("control"), against the reference."""
    import numpy as np

    from portbench import harness, inputs, judge
    from portbench.reference import lbm

    deck = cell.deck
    f0 = inputs.initial_state(deck, seed, device)
    t0 = time.perf_counter()
    f_ref, av_ref = lbm.Reference(deck, device).run(f0)
    expected = judge.Expected(deck, f_ref.cpu().numpy(), av_ref.cpu().numpy())
    t_ref = time.perf_counter() - t0
    if kind == "program":
        with tempfile.TemporaryDirectory(prefix="portbench-cal-") as tmp:
            solver = harness.Solver(cell, f0, device, tmp)
            solve = solver.solve()
            files = solver.write_files(tmp)
            rng = np.random.default_rng(seed % 2**64)
            numbers = judge.worst([expected.file_numbers(*files, solve.reynolds, rng),
                                   expected.state_numbers(solve.f, solve.av, solve.reynolds)])
    else:
        f_c, av_c = lbm.Reference(deck, device, tf32=True).run(f0)
        av_c = av_c.cpu().numpy()
        numbers = expected.state_numbers(f_c.cpu().numpy(), av_c, lbm.reynolds(deck, av_c[-1]))
    return {"kind": kind, "seed": seed, "reference_s": t_ref,
            "correct": judge.verdict(numbers, cell.limits), **numbers}


def calibrate(cell, seeds, control_seeds, device, out=print) -> int:
    """Prints a line per seed, each with the harness's verdict under the
    cell's limits, then the summary; 0 where every program seed reads
    correct and every control seed not, else 1."""
    from portbench import judge

    keys = list(cell.limits)
    lower, upper, wrong = [], [], 0
    for kind, group in (("program", seeds), ("control", control_seeds)):
        for seed in group:
            row = reading(cell, kind, seed, device)
            out(json.dumps(row))
            (lower if kind == "program" else upper).append({k: row[k] for k in keys})
            wrong += row["correct"] != (kind == "program")
    summary = {"workload": cell.name, "limits": cell.limits, "wrong_verdicts": wrong}
    if lower:
        summary["lower"] = judge.worst(lower)
    if upper:
        summary["upper"] = {k: min(r[k] for r in upper) for k in keys}
    out(json.dumps(summary))
    return int(wrong > 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    return calibrate(cell, args.seeds, args.control_seeds, torch.device("cuda:0"),
                     out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    sys.exit(main())
