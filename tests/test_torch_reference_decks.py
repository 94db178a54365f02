"""The reference's 256x256 and 1024x1024 decks (``decks/reference_*``)
against the goldens they were read off (``goldens/*.final_state.dat.xz``)
and against the JAX package, on the CPU.

A golden's last column is the reference writer's transposed read of the
mask: the line of cell (x = ii, y = jj) prints ``obstacles[ii*nx + jj]``,
so on a square grid the column reshaped to (ny, nx) is the mask's
transpose.  The cells whose velocity columns are all 0 are the mask again.

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

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZES = (256, 1024)
# SURVEY.md's "Input decks" row: the reference's params for each deck
SURVEY = {
    256: dict(nx=256, ny=256, max_iters=80_000, reynolds_dim=10, density=0.1,
              accel=0.005, omega=1.85),
    1024: dict(nx=1024, ny=1024, max_iters=20_000, reynolds_dim=10, density=0.1,
               accel=0.01, omega=1.85),
}
F_TOL = dict(rtol=1e-5, atol=1e-7)
AV_RTOL = 1e-4


def deck(n: int) -> tuple[str, str]:
    base = os.path.join(ROOT, "decks", f"reference_{n}x{n}")
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


@pytest.mark.parametrize("n", SIZES)
def test_params_are_the_references(n):
    p = io.load_params(deck(n)[0])
    assert {k: getattr(p, k) for k in SURVEY[n]} == SURVEY[n]


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


@pytest.mark.parametrize("n", SIZES)
def test_deck_geometry(n):
    """256^2: the closed box; 1024^2: the box and a full-height wall at
    x = 341 (bench.py's deck has a half-height one)."""
    mask = io.load_obstacles(deck(n)[1], io.load_params(deck(n)[0]))
    box = np.zeros((n, n), dtype=bool)
    box[0] = box[-1] = box[:, 0] = box[:, -1] = True
    if n == 1024:
        box[:, 341] = True
    np.testing.assert_array_equal(mask, box)
    assert int(mask.sum()) == {256: 1020, 1024: 5114}[n]


RUNS = [(256, 200), (1024, 14)]


@pytest.fixture(scope="module")
def port_auto():
    """(n, iters) -> the port's ``auto`` run on the CPU (``pallask``'s
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
    against JAX's."""
    ref = JaxSimulation.from_decks(*deck(n), backend="fused").run(n_iters=iters)
    port = port_auto(n, iters)
    assert port.f_final.shape == (9, n, n) and port.av_vels.shape == (iters,)
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
