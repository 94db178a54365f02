"""The resident kernel of two checkouts of the port, timed in turns on one
card.

Run from the root of a checkout on a CUDA card, with another checkout
(for example the parent commit, unpacked by ``git archive`` into a
directory that ``.gitignore`` lists):

    python scripts/torch_resident_turns.py OTHER_CHECKOUT [FORM:GRID ...]

Each checkout runs in a process of its own, which builds its kernel
library into its own build directory, in the order other, this, this,
other.  FORM:GRID pairs (default cooperative:1024x1024
cooperative:2048x2048 cooperative:4096x4096) name a form of the kernel
(``banded``, ``cooperative`` or ``grid``, through the wrapper's
``_chunk_launcher(form=...)``) and a grid; a checkout that has no such
form reports it absent.  For each pair a process hashes the state after
50 steps from a seeded state and times one chunk of 1000 steps (250 above
2048^2) three times after a warm-up (us per step, CUDA events).  Prints
one ``TURN`` line per process, then one line per pair with both
checkouts' times and whether their states are the same bit for bit, and
the card's name and power limit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

DEFAULT = ("cooperative:1024x1024", "cooperative:2048x2048", "cooperative:4096x4096")

WORKER = r'''
import hashlib, json, sys
import numpy as np
import torch
from advanced_hpc_lbm_tpu_torch.ops import _build, reference, resident, step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams

assert str(_build.CSRC).startswith({tree!r}), _build.CSRC
_build.build()
out = {{}}
for pair in {pairs!r}:
    form, grid = pair.split(":")
    ny, nx = map(int, grid.split("x"))
    params = LBMParams(nx=nx, ny=ny, max_iters=50, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)
    rng = np.random.RandomState(ny + nx)
    mask_np = np.zeros((ny, nx), dtype=bool)
    mask_np[0] = mask_np[-1] = True
    mask_np[ny // 2: ny // 2 + 2, nx // 3: nx // 2] = True
    f0 = reference.initial_state(params, "cpu").numpy() * rng.uniform(
        0.8, 1.2, (9, ny, nx)).astype(np.float32)
    f = torch.from_numpy(f0).cuda()
    mask = step_kernel.prepare_obstacles(torch.from_numpy(mask_np).cuda())
    try:
        launch = resident._chunk_launcher(f, mask, params, form=form)
    except ValueError:
        out[pair] = None
        continue
    steps = 1000 if ny * nx <= 2048 * 2048 else 250
    part = torch.empty(steps, step_kernel.num_partials(ny, nx), device="cuda")
    bufs = (f.clone(), torch.empty_like(f))
    launch(bufs, 50, part)
    torch.cuda.synchronize()
    digest = hashlib.sha256(bufs[0].cpu().numpy().tobytes()).hexdigest()[:16]
    bufs = (f.clone(), torch.empty_like(f))
    launch(bufs, steps, part)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        launch(bufs, steps, part)
    end.record()
    end.synchronize()
    out[pair] = [start.elapsed_time(end) / 3 / steps * 1e3, digest]
print("TURN", json.dumps(out), flush=True)
'''


def turn(tree: Path, pairs: list[str]) -> dict:
    code = WORKER.format(tree=str(tree), pairs=pairs)
    r = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(tree)), check=False)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("TURN")]
    if r.returncode != 0 or not lines:
        print(f"FAIL {tree}: rc {r.returncode}: {r.stderr[-3000:]}", flush=True)
        sys.exit(1)
    print(f"{lines[0]} {tree}", flush=True)
    return json.loads(lines[0].split(" ", 1)[1])


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    other, this = Path(sys.argv[1]).resolve(), Path.cwd().resolve()
    pairs = sys.argv[2:] or list(DEFAULT)
    runs = [(other, turn(other, pairs)), (this, turn(this, pairs)), (this, turn(this, pairs)),
            (other, turn(other, pairs))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    for pair in pairs:
        got = {tree: [r[pair] for t, r in runs if t == tree] for tree in (other, this)}
        times = {tree: ("absent" if None in v else
                        f"{sum(x[0] for x in v) / 2:.2f} us ({v[0][0]:.2f}, {v[1][0]:.2f})")
                 for tree, v in got.items()}
        digests = {x[1] for v in got.values() for x in v if x is not None}
        print(f"{pair}: other {times[other]}, this {times[this]}; states "
              f"{'the same bit for bit' if len(digests) == 1 else 'differ'} | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
