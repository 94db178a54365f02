#!/usr/bin/env python
"""Run the reference's decks end to end through the PyTorch/CUDA port and
hold each to its goldens and to the reference README's Reynolds number:
the port's counterpart of ``scripts/validate_all.py``, with the same table
and the same exit code (1 on any failure).  It imports nothing of the JAX
package.

Without ``--ref``: the three decks the repository holds,
``decks/reference_256x256`` and ``decks/reference_1024x1024`` against
``goldens/<deck>.final_state.dat.xz`` (final state and Re; the av column
says "no golden"), and ``decks/reference_128x256``, which has no golden,
against Re alone.  With ``--ref DIR``, a checkout of the reference solver
(``input_<deck>.params``, ``obstacles_<deck>.dat``,
``check/<deck>.av_vels.dat``, ``check/<deck>.final_state.dat``): its four
decks, av history and final state, as the JAX script runs them; a
final-state golden that DIR lacks comes from ``goldens/``.

Usage:
  python scripts/torch_validate_all.py                  # on the card
  python scripts/torch_validate_all.py --ref DIR --decks 128x128 256x256
  python scripts/torch_validate_all.py --device cpu     # plain versions; slow
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from advanced_hpc_lbm_tpu_torch import Simulation  # noqa: E402
from advanced_hpc_lbm_tpu_torch.utils import check  # noqa: E402

REF_DECKS = ["128x128", "128x256", "256x256", "1024x1024"]
REPO_DECKS = ["256x256", "1024x1024", "128x256"]
# the reference README's Reynolds numbers (serial base build), as
# scripts/validate_all.py has them
EXPECTED_RE = {
    "128x128": 9.751927,
    "128x256": 37.150040,
    "256x256": 10.051412,
    "1024x1024": 3.375851,
}
TOLERANCE = 1.0  # percent: the reference checker's


def deck_files(deck: str, ref: str | None) -> tuple[Path, Path, Path | None, Path | None]:
    """(params, obstacles, av golden or None, final-state golden or None)
    of a deck."""
    packed = ROOT / "goldens" / f"{deck}.final_state.dat.xz"
    if ref is None:
        base = ROOT / "decks" / f"reference_{deck}"
        return (Path(f"{base}.params"), Path(f"{base}.obstacles.dat"), None,
                packed if packed.exists() else None)
    ref_dir = Path(ref)
    mounted = ref_dir / "check" / f"{deck}.final_state.dat"
    return (ref_dir / f"input_{deck}.params", ref_dir / f"obstacles_{deck}.dat",
            ref_dir / "check" / f"{deck}.av_vels.dat", mounted if mounted.exists() else packed)


def validate(params_f, obst_f, fs_golden, av_golden, expected_re: float, *,
             backend: str = "auto", device: str = "cuda") -> dict:
    """Run one deck and check it: the final state where ``fs_golden`` is
    given and the av history where ``av_golden`` is at 1%, Re within 1% of
    ``expected_re``."""
    sim = Simulation.from_decks(params_f, obst_f, backend=backend, device=device)
    sim.warmup()
    tic = time.perf_counter()
    res = sim.run()
    elapsed = time.perf_counter() - tic
    with tempfile.TemporaryDirectory() as td:
        fs, av = res.write(td)
        fs_stats = check.check_final_state_only(fs_golden, fs) if fs_golden else None
        av_stats = check.check_av_vels_only(str(av_golden), av) if av_golden else None
    re_off = abs(res.reynolds - expected_re) / expected_re
    ok = ((fs_stats is None or fs_stats.passed(TOLERANCE))
          and (av_stats is None or av_stats.passed(TOLERANCE)) and re_off < TOLERANCE / 100)
    return {"backend": sim.backend, "compute_s": elapsed, "reynolds": res.reynolds,
            "re_off_pcnt": 100 * re_off,
            "av_pcnt": None if av_stats is None else abs(av_stats.max_diff_pcnt),
            "fs_pcnt": None if fs_stats is None else abs(fs_stats.max_diff_pcnt), "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", default=None, help="a checkout of the reference solver")
    ap.add_argument("--decks", nargs="*", default=None)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"Error: --device {args.device} asks for CUDA, but no CUDA device is "
              "available to PyTorch here (use --device cpu)", file=sys.stderr)
        return 1
    decks = args.decks or (REF_DECKS if args.ref else REPO_DECKS)

    failures = 0
    print(f"{'deck':>10} {'backend':>9} {'compute_s':>9} {'Re':>14} "
          f"{'av max%':>13} {'fs max%':>9} {'golden':>8} {'verdict':>8}")
    for deck in decks:
        params_f, obst_f, av_golden, fs_golden = deck_files(deck, args.ref)
        row = validate(params_f, obst_f, fs_golden, av_golden, EXPECTED_RE[deck],
                       backend=args.backend, device=args.device)
        failures += not row["ok"]
        av = "av: no golden" if row["av_pcnt"] is None else f"{row['av_pcnt']:.4f}"
        fs = "none" if row["fs_pcnt"] is None else f"{row['fs_pcnt']:.4f}"
        source = ("none" if fs_golden is None else
                  "regen" if fs_golden.suffix == ".xz" else "upstream")
        print(f"{deck:>10} {row['backend']:>9} {row['compute_s']:9.2f} "
              f"{row['reynolds']:14.6E} {av:>13} {fs:>9} {source:>8} "
              f"{'PASS' if row['ok'] else 'FAIL':>8}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
