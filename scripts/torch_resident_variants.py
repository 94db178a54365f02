"""Variants of the resident kernel's two forms, timed side by side on one
card.

Each variant is a copy of ``advanced_hpc_lbm_tpu_torch/`` under
``build/scratch/var/<name>/`` whose ``csrc/resident_kernel.cu`` has text
edits applied.  Each copy builds its own kernel library and is timed in a
process of its own, one after another: 50 steps against the step kernel
(the number of differing values; the diagnostic variants differ on
purpose) and two timings of one 1000-step launch (us per step) of the
banded form at 64^2, 128^2, 256x128 and 256^2 (ny x nx), or of the
cooperative form at K = 2, 3 and 4 at 512^2 and 1024^2 (``coop_*``).  Run
from the root of a checkout on a CUDA card:

    python scripts/torch_resident_variants.py [name ...]   # default: all

Prints one ``RESULT <name> {size: [differing values, [us, us]]}`` line per
variant (``{size K=k: ...}`` for the cooperative form).  The variants of
the banded form:

  kernel       the kernel as it is
  nowait       ring values used without waiting for their step
               (diagnostic: wrong results; what the exchange's wait costs)
  nocompute    the cell step replaced by a copy (diagnostic: what the cell
               step's latency costs)
  early_gather the ring's loads issued before the tile sums of two rounds
               back, not after (the sums then run while the loads fly)
  serial_poll  values that were not there yet loaded again one at a time
               (the first one still to come), not all at once
  relaxed      outbox words through cuda::atomic_ref relaxed loads and
               stores instead of volatile accesses
  wide         segments of 64 columns wherever the band has them (fewer
               blocks, a smaller ring per cell)
  depth_<d>    every block at exchange depth d (1 .. 6) in place of
               band_depth's 4 for 32 columns and 2 for 64

and of the cooperative form (the diagnostic ones give wrong results):

  coop           the kernel as it is
  coop_nowait    no wait for the neighbours' flags within a round
  coop_nostep    the cell step replaced by a copy
  coop_nostore   the own cells not written back
  coop_nocopy    neither the windows after a round's first copied in nor
                 any written back (the cell steps and the waits alone)
  coop_t768      768 threads per block (at most 85 registers)
  coop_t1024     1024 threads per block (at most 64 registers)
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
PKG = ROOT / "advanced_hpc_lbm_tpu_torch"
OUT = ROOT / "build" / "scratch" / "var"

LOADS = """    Word got[B::kGather];
    unsigned pending = 0;  // bit q: value q is still to come
#pragma unroll
    for (int q = 0; q < B::kGather; ++q) {
      const int src = src_tab[q * kBandThreads + tid];
      if (src >= 0) {
        got[q] = ll_load(in + src);
        pending |= 1u << q;
      }
    }
"""
SUMS = """    if (r >= 2) tile_partials(r - 2);
"""


def replace(s: str, old: str, new: str) -> str:
    assert old in s, old[:80]
    return s.replace(old, new)


def nowait(s: str) -> str:
    return replace(s, "static_cast<unsigned>(got[q] >> 32) == static_cast<unsigned>(t + 1)) {",
                   "true) {")


def serial_poll(s: str) -> str:
    return replace(s, "        if ((pending >> q) & 1u) got[q] = ll_load(in + src_tab[q * "
                      "kBandThreads + tid]);",
                   "        if ((pending >> q) & 1u) {\n"
                   "          got[q] = ll_load(in + src_tab[q * kBandThreads + tid]);\n"
                   "          break;\n"
                   "        }")


def nocompute(s: str) -> str:
    return replace(s, "      const float u_sq = lbm::cell_step(st, r, cc, r - 1, r + 1, cc - 1, "
                      "cc + 1, v[j], obst, c);",
                   "      const float u_sq = 0.0f;\n"
                   "      for (int k = 0; k < kSpeeds; ++k) v[j][k] = st.f(k, r, cc);")


def early_gather(s: str) -> str:
    return replace(s, SUMS + LOADS, LOADS + SUMS)


def relaxed(s: str) -> str:
    s = replace(s, "#include <cstdint>\n", "#include <cstdint>\n#include <cuda/atomic>\n")
    s = replace(s, "  return *reinterpret_cast<volatile Word*>(p);",
                "  return cuda::atomic_ref<Word, cuda::thread_scope_device>(*p).load(\n"
                "      cuda::memory_order_relaxed);")
    return replace(s, "  *reinterpret_cast<volatile Word*>(p) = (static_cast<Word>(tag) << 32) "
                      "| __float_as_uint(v);",
                   "  cuda::atomic_ref<Word, cuda::thread_scope_device>(*p).store(\n"
                   "      (static_cast<Word>(tag) << 32) | __float_as_uint(v), "
                   "cuda::memory_order_relaxed);")


def wide(s: str) -> str:
    return replace(s, "  int target = sms / num_bands(ny);", "  int target = 1;")


def depth(d: int):
    def edit(s: str) -> str:
        return replace(s, "  return seg_w == lbm::kTileX ? 4 : 2;", f"  return {d};")
    return edit


def coop_nowait(s: str) -> str:
    return replace(s, "      if (wait && after && flagger) coop_flag_wait<K>",
                   "      if (false) coop_flag_wait<K>")


def coop_nostep(s: str) -> str:
    return replace(s, "      const float u_sq = lbm::cell_step(win, r, c, r - 1, r + 1, c - 1, c + 1, "
                      "v[j], obst, cc);",
                   "      const float u_sq = 0.0f;\n"
                   "      for (int q = 0; q < kSpeeds; ++q) v[j][q] = win.f(q, r, c);")


def coop_nocopy(s: str) -> str:
    s = replace(s, "      if (more) coop_load<K>(nxt, a, src, wnext, tid);", "")
    return replace(s, "      coop_store<K>(planes, red, a, dst, wn, t, k, tid);", "")


def coop_threads(n: int):
    def edit(s: str) -> str:
        return replace(s, "constexpr int kCoopThreads = 512;", f"constexpr int kCoopThreads = {n};")
    return edit


def coop_nostore(s: str) -> str:
    return replace(s, "for (int s = 0; s < kSpeeds; ++s) dst[s * plane + g] = planes[s * kPl + j];",
                   "(void)g;")


VARIANTS = {"kernel": [], "nowait": [nowait], "nocompute": [nocompute],
            "early_gather": [early_gather], "serial_poll": [serial_poll], "relaxed": [relaxed],
            "wide": [wide], **{f"depth_{d}": [depth(d)] for d in range(1, 7)},
            "coop": [], "coop_nowait": [coop_nowait],
            "coop_nostep": [coop_nostep], "coop_nostore": [coop_nostore],
            "coop_nocopy": [coop_nocopy], "coop_t768": [coop_threads(768)],
            "coop_t1024": [coop_threads(1024)]}

TIMER = r'''
import sys, json
import torch
sys.path.append({root!r})
import chip_smoke as c
from advanced_hpc_lbm_tpu_torch.ops import _build, resident, step_kernel
assert str(_build.CSRC).startswith({pkgdir!r}), _build.CSRC
_build.build()
out = {{}}
for ny, nx in ((64, 64), (128, 128), (256, 128), (256, 256)):
    params, mask, f = c.on_card(ny, nx, 200 + ny + nx)
    tiles = step_kernel.num_partials(ny, nx)
    fs, _ = step_kernel.run(f, mask, params, n_iters=50)
    launch = resident._chunk_launcher(f, mask, params)
    bufs, part = (f.clone(), torch.empty_like(f)), torch.empty(1000, tiles, device="cuda")
    launch(bufs, 50, part)
    diff = int((bufs[0] != fs).sum().item())
    ms = [c.time_ms(lambda: launch(bufs, 1000, part), 3) / 1000 for _ in range(2)]
    out[f"{{ny}}x{{nx}}"] = (diff, [m * 1e3 for m in ms])
print("RESULT", {name!r}, json.dumps(out), flush=True)
'''

COOP_TIMER = r'''
import sys, json
sys.path.append({root!r})
import chip_smoke as c
from advanced_hpc_lbm_tpu_torch.ops import _build, step_kernel
assert str(_build.CSRC).startswith({pkgdir!r}), _build.CSRC
_build.build()
out = {{}}
for n in (512, 1024):
    params, mask, f = c.on_card(n, n, 200 + n)
    fs, _ = step_kernel.run(f, mask, params, n_iters=50)
    for k in (2, 3, 4):
        fr, _ = c.resident_form(f, mask, params, 50, 1000, "cooperative", k)
        diff = int((fr != fs).sum().item())
        ms = [c.time_ms(lambda: c.resident_form(f, mask, params, 1000, 1000, "cooperative", k),
                        3) / 1000 for _ in range(2)]
        out[f"{{n}} K={{k}}"] = (diff, [m * 1e3 for m in ms])
print("RESULT", {name!r}, json.dumps(out), flush=True)
'''


def main() -> int:
    chosen = sys.argv[1:] or list(VARIANTS)
    for name in chosen:
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(PKG, d / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
        src = d / PKG.name / "csrc" / "resident_kernel.cu"
        text = src.read_text()
        for edit in VARIANTS[name]:
            text = edit(text)
        src.write_text(text)
    for name in chosen:  # one at a time: each times on the whole card
        d = OUT / name
        timer = COOP_TIMER if name.startswith("coop") else TIMER
        code = timer.format(root=str(ROOT), pkgdir=str(d), name=name)
        r = subprocess.run([sys.executable, "-c", code], cwd=d, capture_output=True, text=True,
                           env=dict(os.environ, PYTHONPATH=str(d)))
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
        print(lines[0] if lines else f"{name} FAILED rc {r.returncode}: {r.stderr[-1500:]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
