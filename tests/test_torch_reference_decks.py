"""The reference's 256x256 and 1024x1024 decks (``decks/reference_*``)
against the goldens they were read off (``goldens/*.final_state.dat.xz``),
the 128x256 deck, which has no golden, against SURVEY.md's description of
it, and all three against the JAX package, on the CPU.

A golden's last column is the reference writer's transposed read of the
mask: the line of cell (x = ii, y = jj) prints ``obstacles[ii*nx + jj]``,
so on a square grid the column reshaped to (ny, nx) is the mask's
transpose.  The cells whose velocity columns are all 0 are the mask again.
At 128x256 the read is no permutation: its 32 768 lines read indices 0 to
16 511 only, the plain reference's rule (``portbench/reference/lbm.py``).

Tolerances against the JAX package (``fused``, the JAX ``auto`` on the
CPU): f within rtol 1e-5 / atol 1e-7, the kernel tests' tolerance; av
within rtol 1e-4 where both sides reduce ||u|| in the same way: the port's
``fused`` against JAX's ``fused``, and the port's ``auto`` (the K-step
kernel's plain version) against the JAX K-step kernel in interpret mode.
The kernels' ||u|| differs from ``fused``'s by up to 1.2e-3 relative in the
first steps from rest: their x-momentum sum, in another order, leaves a
float32 residual of ~2e-8 in every cell at rest, which ``fused``'s grouping
cancels exactly; the JAX K-step kernel differs from JAX ``fused`` by the
same amount.
"""

import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation as JaxSimulation
from advanced_hpc_lbm_tpu.ops import pallas_k
from advanced_hpc_lbm_tpu.utils import check as jcheck
from advanced_hpc_lbm_tpu_torch import Simulation, cli
from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel
from advanced_hpc_lbm_tpu_torch.utils import check, io
from portbench.reference import lbm

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZES = (256, 1024)  # the square decks, whose final-state goldens goldens/ holds
# SURVEY.md's "Input decks" row: the reference's params for each deck, by
# the deck's name (a square deck's side)
SURVEY = {
    "256": dict(nx=256, ny=256, max_iters=80_000, reynolds_dim=10, density=0.1,
                accel=0.005, omega=1.85),
    "1024": dict(nx=1024, ny=1024, max_iters=20_000, reynolds_dim=10, density=0.1,
                 accel=0.01, omega=1.85),
    "128x256": dict(nx=128, ny=256, max_iters=40_000, reynolds_dim=10, density=0.1,
                    accel=0.005, omega=1.85),
}
F_TOL = dict(rtol=1e-5, atol=1e-7)
AV_RTOL = 1e-4


def deck(name) -> tuple[str, str]:
    """The params and obstacle files of a deck: a square deck's side, or
    "128x256"."""
    p = SURVEY[str(name)]
    base = os.path.join(ROOT, "decks", f"reference_{p['nx']}x{p['ny']}")
    return base + ".params", base + ".obstacles.dat"


def golden_path(n: int) -> str:
    return os.path.join(ROOT, "goldens", f"{n}x{n}.final_state.dat.xz")


@pytest.fixture(scope="module")
def goldens():
    """n -> (sha256 of the decompressed golden, its (N, 7) table), each
    decompressed and split once."""
    import lzma

    cache = {}

    def get(n):
        if n not in cache:
            with lzma.open(golden_path(n), "rb") as fh:
                raw = fh.read()
            table = np.array(raw.split(), dtype=np.float64).reshape(-1, 7)
            cache[n] = hashlib.sha256(raw).hexdigest(), table
        return cache[n]
    return get


def golden_mask(table: np.ndarray, n: int) -> np.ndarray:
    """The (ny, nx) mask that the golden's transposed column encodes."""
    return table[:, 6].astype(np.int64).reshape(n, n).T.astype(bool)


@pytest.mark.parametrize("name", SURVEY)
def test_params_are_the_references(name):
    p = io.load_params(deck(name)[0])
    assert {k: getattr(p, k) for k in SURVEY[name]} == SURVEY[name]


@pytest.mark.parametrize("n", SIZES)
def test_golden_is_the_pinned_file(n, goldens):
    sums = dict(line.split()[::-1] for line in
                open(os.path.join(ROOT, "goldens", "SHA256SUMS")).read().splitlines())
    sha, table = goldens(n)
    assert sha == sums[f"{n}x{n}.final_state.dat"]
    assert table.shape == (n * n, 7)
    # raster order: x inner, y outer
    np.testing.assert_array_equal(table[:, 0], np.tile(np.arange(n), n))
    np.testing.assert_array_equal(table[:, 1], np.repeat(np.arange(n), n))


@pytest.mark.parametrize("n", SIZES)
def test_deck_is_the_mask_the_golden_encodes(n, goldens):
    _, table = goldens(n)
    mask = io.load_obstacles(deck(n)[1], io.load_params(deck(n)[0]))
    np.testing.assert_array_equal(mask, golden_mask(table, n))
    at_rest = (table[:, 2] == 0) & (table[:, 3] == 0) & (table[:, 4] == 0)
    np.testing.assert_array_equal(mask, at_rest.reshape(n, n))


@pytest.mark.parametrize("n", SIZES)
def test_writers_column_of_the_deck_is_the_goldens(n, goldens):
    """The port's transposed column of the deck's mask, line for line."""
    _, table = goldens(n)
    mask = io.load_obstacles(deck(n)[1], io.load_params(deck(n)[0]))
    np.testing.assert_array_equal(io._quirk_obstacle_column(mask), table[:, 6].astype(np.int64))


@pytest.mark.parametrize("name", SURVEY)
def test_deck_geometry(name):
    """256^2: the closed box; 1024^2: the box and a full-height wall at
    x = 341 (bench.py's deck has a half-height one); 128x256 (SURVEY.md's
    "Obstacle decks" row): side columns at full height and a full row at
    y = 127, no top or bottom row, in 640 lines of 638 cells (the corners
    of the row are listed twice, as the upstream file's line count says)."""
    params = io.load_params(deck(name)[0])
    mask = io.load_obstacles(deck(name)[1], params)
    want = np.zeros((params.ny, params.nx), dtype=bool)
    want[:, 0] = want[:, -1] = True
    if name == "128x256":
        want[127] = True
        # rows 0 and ny - 1 hold only the side columns: fluid meets the wrap
        assert np.flatnonzero(mask[0]).tolist() == np.flatnonzero(mask[-1]).tolist() == [0, 127]
        with open(deck(name)[1]) as fh:
            lines = fh.read().splitlines()
        assert len(lines) == 640 and len(set(lines)) == 638
        assert lines == sorted(lines, key=lambda ln: (int(ln.split()[1]), int(ln.split()[0])))
    else:
        want[0] = want[-1] = True
    if name == "1024":
        want[:, 341] = True
    np.testing.assert_array_equal(mask, want)
    assert int(mask.sum()) == {"256": 1020, "1024": 5114, "128x256": 638}[name]


@pytest.mark.parametrize("name", SURVEY)
def test_writers_column_is_the_reference_rule(name, tmp_path):
    """The obstacle column of ``utils/io.py``'s table and of the file the
    codec writes equal the plain reference's rule line for line, and the
    lines whose transposed index is clipped are the closed form's
    (none at 128x256, where the read is no permutation)."""
    params = io.load_params(deck(name)[0])
    mask = io.load_obstacles(deck(name)[1], params)
    want = lbm.obstacle_column(lbm.read_deck(*deck(name)))
    np.testing.assert_array_equal(io._quirk_obstacle_column(mask), want)
    f = np.broadcast_to(lbm.rest_state(lbm.read_deck(*deck(name)))[:, None, None],
                        (9, params.ny, params.nx))
    _, _, column = io.final_state_table(f, mask, params)
    np.testing.assert_array_equal(column, want)
    path = tmp_path / "final_state.dat"
    io.write_final_state(path, f, mask, params)
    np.testing.assert_array_equal(check.read_final_state(path)[:, 6], want)
    ii = np.tile(np.arange(params.nx), params.ny)
    jj = np.repeat(np.arange(params.ny), params.nx)
    clipped = int(np.count_nonzero(ii * params.nx + jj >= mask.size))
    assert clipped == io.quirk_clipped_lines(params.ny, params.nx) == 0
    if name == "128x256":
        assert (ii * params.nx + jj).max() == 16_511
        assert not np.array_equal(want, mask.T.reshape(-1))  # no transpose here


RUNS = [(256, 200), (1024, 14), ("128x256", 300)]


@pytest.fixture(scope="module")
def port_auto():
    """(deck, iters) -> the port's ``auto`` run on the CPU (``pallask``'s
    plain version; at 1024^2 K = 3, so 14 steps are 4 passes and the
    2-step tail that ends the 20 000-step run), each made once."""
    cache = {}

    def get(n, iters):
        if (n, iters) not in cache:
            cache[n, iters] = Simulation.from_decks(*deck(n), device="cpu").run(n_iters=iters)
        return cache[n, iters]
    return get


@pytest.mark.parametrize("n,iters", RUNS)
def test_port_matches_jax_on_the_deck(n, iters, port_auto):
    """The port's ``auto`` against JAX ``fused``, and the port's ``fused``
    against JAX's (at 128x256, 300 steps from rest: the flow crosses the
    periodic y-wrap from the first steps)."""
    ref = JaxSimulation.from_decks(*deck(n), backend="fused").run(n_iters=iters)
    port = port_auto(n, iters)
    p = SURVEY[str(n)]
    assert port.f_final.shape == (9, p["ny"], p["nx"]) and port.av_vels.shape == (iters,)
    np.testing.assert_allclose(port.f_final, ref.f_final, **F_TOL)
    np.testing.assert_allclose(port.reynolds, ref.reynolds, rtol=AV_RTOL)
    fused = Simulation.from_decks(*deck(n), backend="fused", device="cpu").run(n_iters=iters)
    np.testing.assert_allclose(fused.f_final, ref.f_final, **F_TOL)
    np.testing.assert_allclose(fused.av_vels, ref.av_vels, rtol=AV_RTOL)


def test_kstep_tail_matches_the_jax_kernel_on_the_1024_deck(port_auto):
    """``auto``'s av at 1024^2, tail included, against the JAX K-step
    kernel (interpret mode), which reduces ||u|| as the port's does."""
    n, iters = RUNS[1]
    k = kstep_kernel.best_k(n, n)
    assert k == 3 and iters % k == 20_000 % k == 2
    jsim = JaxSimulation.from_decks(*deck(n), backend="fused")
    f, av = pallas_k.run(jnp.asarray(jsim.initial_state()), jnp.asarray(jsim.obstacles),
                         jsim.params, n_iters=iters, k=k, interpret=True)
    port = port_auto(n, iters)
    np.testing.assert_allclose(port.f_final, np.asarray(f), **F_TOL)
    np.testing.assert_allclose(port.av_vels, np.asarray(av), rtol=AV_RTOL)


def test_cli_writes_the_goldens_obstacle_column(tmp_path, goldens, capsys):
    """The committed 256^2 deck through the port's own reader and writer:
    the coordinates and the obstacle column of final_state.dat are the
    golden's."""
    rc = cli.main([*deck(256), "--device", "cpu", "--iters", "100",
                   "--out-dir", str(tmp_path)])
    assert rc == 0, capsys.readouterr().err
    _, table = goldens(256)
    got = check.read_final_state(tmp_path / "final_state.dat")
    np.testing.assert_array_equal(got[:, [0, 1, 6]], table[:, [0, 1, 6]])
    assert check.check_final_state_only(table, got).finite


def test_final_state_reader_and_check_are_check_files(tmp_path):
    """``read_final_state`` reads what ``np.loadtxt`` does, from a file and
    from its .xz; ``check_final_state_only`` is the final-state half of the
    JAX package's ``check_files``."""
    import lzma

    rng = np.random.default_rng(3)
    p = io.load_params(deck(256)[0])
    mask = np.zeros((7, 5), dtype=bool)
    mask[0] = True
    paths = []
    for i in range(2):
        f = (rng.random((9, 7, 5)) * 0.02 + 0.005).astype(np.float32)
        paths.append(tmp_path / f"fs{i}.dat")
        io.write_final_state(paths[-1], f, mask, p)
        io.write_av_vels(tmp_path / f"av{i}.dat", np.ones(3, dtype=np.float32))
    packed = tmp_path / "fs0.dat.xz"
    packed.write_bytes(lzma.compress(paths[0].read_bytes()))
    np.testing.assert_array_equal(check.read_final_state(paths[0]), np.loadtxt(paths[0]))
    np.testing.assert_array_equal(check.read_final_state(packed), np.loadtxt(paths[0]))
    want = jcheck.check_files(str(tmp_path / "av0.dat"), str(paths[0]),
                              str(tmp_path / "av1.dat"), str(paths[1])).final_state
    got = check.check_final_state_only(packed, paths[1])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="coordinates"):
        check.check_final_state_only(paths[0], check.read_final_state(paths[1])[::-1])


# ---- scripts/torch_validate_all.py -------------------------------------------------

def _validate_all():
    import runpy

    return runpy.run_path(os.path.join(ROOT, "scripts", "torch_validate_all.py"),
                          run_name="torch_validate_all")


def test_validate_all_holds_a_deck_to_its_goldens_and_re(tmp_path):
    """The script's check of one deck on the CPU: the mini deck against the
    JAX package's final state and Reynolds number and the deck's av golden
    passes; a Reynolds number 2% off fails."""
    mini = (os.path.join(ROOT, "decks", "mini_64x64.params"),
            os.path.join(ROOT, "decks", "mini_64x64.obstacles.dat"))
    av_golden = os.path.join(ROOT, "decks", "mini_64x64.golden_av_vels.dat")
    ref = JaxSimulation.from_decks(*mini, backend="fused").run()
    fs_golden, _ = ref.write(str(tmp_path))
    validate = _validate_all()["validate"]
    row = validate(*mini, fs_golden, av_golden, ref.reynolds, device="cpu")
    assert row["ok"] and row["backend"] == "pallask", row
    assert row["fs_pcnt"] < 1e-2 and row["av_pcnt"] < 1.0 and row["re_off_pcnt"] < 1e-2
    row = validate(*mini, fs_golden, None, ref.reynolds * 1.02, device="cpu")
    assert not row["ok"] and row["av_pcnt"] is None and row["fs_pcnt"] < 1e-2


def test_validate_all_holds_a_deck_without_golden_to_re():
    """The repository's 128x256 deck has no golden: the script runs it and
    holds it to Re alone (the final-state column says none)."""
    script = _validate_all()
    assert script["REPO_DECKS"] == ["256x256", "1024x1024", "128x256"]
    params_f, obst_f, av_golden, fs_golden = script["deck_files"]("128x256", None)
    assert (av_golden, fs_golden) == (None, None) and params_f.exists() and obst_f.exists()
    assert script["deck_files"]("256x256", None)[3].exists()
    mini = (os.path.join(ROOT, "decks", "mini_64x64.params"),
            os.path.join(ROOT, "decks", "mini_64x64.obstacles.dat"))
    re = Simulation.from_decks(*mini, device="cpu").run().reynolds
    row = script["validate"](*mini, None, None, re, device="cpu")
    assert row["ok"] and row["fs_pcnt"] is None and row["av_pcnt"] is None, row
    assert not script["validate"](*mini, None, None, re * 1.02, device="cpu")["ok"]


def test_validate_all_wants_a_card_and_no_jax():
    """On a host without CUDA the default ``--device cuda`` exits 1 with an
    Error: line and no table; the script loads no JAX."""
    import subprocess
    import sys

    code = ("import runpy, sys; m = runpy.run_path(sys.argv[1], run_name='v'); "
            "rc = m['main']([]); assert 'jax' not in sys.modules; sys.exit(rc)")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-c", code,
                        os.path.join(ROOT, "scripts", "torch_validate_all.py")],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 1, r.stderr
    assert "Error: --device cuda" in r.stderr and "verdict" not in r.stdout
