"""The port's ``utils/viz.py`` against the JAX package's: the ||u|| field
read from a final_state.dat, and the PGM heatmap (matplotlib made
unavailable) byte for byte the JAX module's on the same file."""

import builtins
import sys

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.utils import viz as jviz
from advanced_hpc_lbm_tpu_torch import Simulation
from advanced_hpc_lbm_tpu_torch.utils import io, viz


@pytest.fixture
def final_state(tmp_path):
    """A final_state.dat of 8 steps of the mini deck, by the port's writer."""
    sim = Simulation.from_decks("decks/mini_64x64.params", "decks/mini_64x64.obstacles.dat",
                                backend="fused", device="cpu")
    sim.run(n_iters=8).write(tmp_path)
    return tmp_path / io.FINAL_STATE_FILE


@pytest.fixture
def no_matplotlib(monkeypatch):
    real_import = builtins.__import__

    def refuse(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(builtins, "__import__", refuse)


def test_velocity_field_matches_jax(final_state):
    grid = viz.velocity_field_from_dat(final_state)
    assert grid.shape == (64, 64)
    np.testing.assert_array_equal(grid, jviz.velocity_field_from_dat(final_state))


def test_velocity_field_roundtrip(tmp_path):
    ny, nx = 4, 8
    vals = np.random.RandomState(0).rand(ny, nx)
    path = tmp_path / "fs.dat"
    path.write_text("".join(f"{ii} {jj} 0.0E+00 0.0E+00 {vals[jj, ii]:.12E} 3.3E-02 0\n"
                            for jj in range(ny) for ii in range(nx)))
    np.testing.assert_allclose(viz.velocity_field_from_dat(path), vals, rtol=1e-12)


def test_pgm_fallback_equals_jax(final_state, tmp_path, no_matplotlib):
    ours = viz.plot_final_state(final_state, tmp_path / "port.png")
    theirs = jviz.plot_final_state(final_state, tmp_path / "jax.png")
    assert ours.endswith("port.pgm") and theirs.endswith("jax.pgm")
    data = open(ours, "rb").read()
    assert data.startswith(b"P5 64 64 255\n") and len(data) == len(b"P5 64 64 255\n") + 64 * 64
    assert data == open(theirs, "rb").read()


def test_main_prints_the_written_path(final_state, tmp_path, capsys, no_matplotlib):
    assert viz.main([str(final_state), "-o", str(tmp_path / "heat.png")]) == 0
    assert capsys.readouterr().out.strip() == str(tmp_path / "heat.pgm")


def test_plot_with_matplotlib_writes_a_png(final_state, tmp_path):
    pytest.importorskip("matplotlib")
    out = viz.plot_final_state(final_state, tmp_path / "heat.png")
    assert out.endswith("heat.png") and (tmp_path / "heat.png").stat().st_size > 0
