"""The port's host I/O, checker and timers against the JAX package's.

Readers must parse the same decks into the same values and raise the same
``DeckError`` messages; writers must produce byte-identical files from the
same arrays.  The JAX package's pure-Python codec is the reference (its
optional C codec is switched off here); the port has only that path.
"""

import os

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu.utils import check as jcheck
from advanced_hpc_lbm_tpu.utils import io as jio
from advanced_hpc_lbm_tpu.utils import native as jnative
from advanced_hpc_lbm_tpu.utils import timers as jtimers
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import check, io, timers

DECKS = os.path.join(os.path.dirname(__file__), "..", "decks")
MINI_PARAMS = os.path.join(DECKS, "mini_64x64.params")
MINI_OBST = os.path.join(DECKS, "mini_64x64.obstacles.dat")
MINI_GOLDEN = os.path.join(DECKS, "mini_64x64.golden_av_vels.dat")


@pytest.fixture(autouse=True)
def python_codec(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def test_load_params_matches():
    p, jp = io.load_params(MINI_PARAMS), jio.load_params(MINI_PARAMS)
    assert p == LBMParams.from_jax(jp)


def test_load_obstacles_matches():
    p = io.load_params(MINI_PARAMS)
    np.testing.assert_array_equal(
        io.load_obstacles(MINI_OBST, p),
        jio.load_obstacles(MINI_OBST, jio.load_params(MINI_PARAMS)),
    )


@pytest.mark.parametrize("text", [
    "4\n4\n",                                   # too few lines
    "4\n4\n10\n1\nabc\n0.005\n1.85\n",          # a float line that is not one
    "4.5\n4\n10\n1\n0.1\n0.005\n1.85\n",        # an int line that is not one
])
def test_bad_params_raise_the_same_error(tmp_path, text):
    path = tmp_path / "bad.params"
    path.write_text(text)
    with pytest.raises(jio.DeckError) as want:
        jio.load_params(path)
    with pytest.raises(io.DeckError) as got:
        io.load_params(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("line", [
    "1 1", "1 1 1 1", "a 1 1", "9 1 1", "-1 1 1", "1 9 1", "1 1 2",
])
def test_bad_obstacles_raise_the_same_error(tmp_path, line):
    path = tmp_path / "bad.dat"
    path.write_text(f"0 0 1\n\n{line}\n")
    jp = JaxParams(nx=8, ny=8, max_iters=1, reynolds_dim=1,
                   density=0.1, accel=0.005, omega=1.0)
    with pytest.raises(jio.DeckError) as want:
        jio.load_obstacles(path, jp)
    with pytest.raises(io.DeckError) as got:
        io.load_obstacles(path, LBMParams.from_jax(jp))
    assert str(got.value) == str(want.value)


def test_missing_deck_raises_oserror(tmp_path):
    with pytest.raises(OSError):
        io.load_params(tmp_path / "absent.params")


def _state(ny, nx, seed=0):
    rng = np.random.RandomState(seed)
    f = (rng.uniform(0.8, 1.2, (9, ny, nx)) * 0.011).astype(np.float32)
    mask = rng.rand(ny, nx) < 0.2
    jp = JaxParams(nx=nx, ny=ny, max_iters=3, reynolds_dim=10,
                   density=0.1, accel=0.005, omega=1.85)
    return f, mask, jp


@pytest.mark.parametrize("ny,nx", [(8, 8), (12, 5)])
@pytest.mark.parametrize("quirk", [True, False])
def test_final_state_bytes_identical(tmp_path, ny, nx, quirk):
    """Including the transposed obstacle column (nx != ny reads other
    cells) and the plain column."""
    f, mask, jp = _state(ny, nx)
    io.write_final_state(tmp_path / "port.dat", f, mask, LBMParams.from_jax(jp),
                         emulate_obstacle_column_quirk=quirk)
    jio.write_final_state(tmp_path / "jax.dat", f, mask, jp,
                          emulate_obstacle_column_quirk=quirk)
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()


def test_final_state_table_matches():
    f, mask, jp = _state(12, 5, seed=1)
    for a, b in zip(io.final_state_table(f, mask, LBMParams.from_jax(jp)),
                    jio.final_state_table(f, mask, jp)):
        np.testing.assert_array_equal(a, b)


def test_av_vels_bytes_identical_and_read_back(tmp_path):
    av = np.random.RandomState(2).rand(17).astype(np.float32) * 1e-3
    io.write_av_vels(tmp_path / "port.dat", av)
    jio.write_av_vels(tmp_path / "jax.dat", av)
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()
    np.testing.assert_array_equal(io.read_av_vels(tmp_path / "port.dat"),
                                  jio.read_av_vels(tmp_path / "jax.dat"))
    np.testing.assert_array_equal(np.float32(io.read_av_vels(tmp_path / "port.dat")), av)


# ---- checker -----------------------------------------------------------------

def _outputs(tmp_path, name, scale):
    f, mask, jp = _state(6, 7, seed=3)
    av = np.linspace(1e-4, 2e-4, 9).astype(np.float32) * scale
    fs, avp = tmp_path / f"{name}.fs.dat", tmp_path / f"{name}.av.dat"
    jio.write_final_state(fs, f * scale, mask, jp)
    jio.write_av_vels(avp, av)
    return str(avp), str(fs)


@pytest.mark.parametrize("scale", [1.0, 1.005, 1.02])
def test_check_files_matches(tmp_path, scale):
    ref = _outputs(tmp_path, "ref", 1.0)
    sim = _outputs(tmp_path, "sim", scale)
    got = check.check_files(*ref, *sim)
    want = jcheck.check_files(*ref, *sim)
    assert got.passed == want.passed == (scale < 1.01)
    assert vars(got.av_vels) == vars(want.av_vels)
    assert vars(got.final_state) == vars(want.final_state)
    assert vars(check.check_av_vels_only(ref[0], sim[0])) == vars(
        jcheck.check_av_vels_only(ref[0], sim[0]))


@pytest.mark.parametrize("scale", [1.0, 1.02])
def test_checker_cli_matches(tmp_path, capsys, scale):
    ref = _outputs(tmp_path, "ref", 1.0)
    sim = _outputs(tmp_path, "sim", scale)
    argv = [f"--ref-av-vels-file={ref[0]}", f"--ref-final-state-file={ref[1]}",
            f"--av-vels-file={sim[0]}", f"--final-state-file={sim[1]}"]
    rc = check._main(argv)
    out = capsys.readouterr().out
    jrc = jcheck._main(argv)
    assert (rc, out) == (jrc, capsys.readouterr().out)
    assert rc == (0 if scale == 1.0 else 1)


def test_checker_rejects_mismatched_steps(tmp_path):
    ref = _outputs(tmp_path, "ref", 1.0)
    short = tmp_path / "short.av.dat"
    jio.write_av_vels(short, np.ones(3, np.float32))
    with pytest.raises(ValueError, match="Different number of steps"):
        check.check_av_vels_only(ref[0], str(short))


def test_mini_golden_checks_against_itself():
    stats = check.check_av_vels_only(MINI_GOLDEN, MINI_GOLDEN)
    assert stats.passed(1.0) and stats.max_diff_pcnt == 0.0


# ---- timers ------------------------------------------------------------------

def test_report_lines_match():
    t, jt = timers.PhaseTimers(), jtimers.PhaseTimers()
    values = {"init": 0.25, "compute": 1.5, "collate": 0.125}
    t.elapsed.update(values)
    jt.elapsed.update(values)
    assert t.report_lines() == jt.report_lines()
    with t.phase("compute"):
        pass
    assert t.elapsed["compute"] >= 1.5
