"""The port's host I/O, checker and timers against the JAX package's.

Readers must parse the same decks into the same values and raise the same
``DeckError`` messages; writers must produce byte-identical files from the
same arrays.  The JAX package's pure-Python codec is the reference (its
optional C codec is switched off here).  The port's readers and writers go
through its own codec, ``advanced_hpc_lbm_tpu_torch/csrc/fastio.c``, where
``cc`` builds it, and through the same pure-Python path otherwise; both are
held to the reference, the codec at every thread count.
"""

import hashlib
import os
import tomllib
from pathlib import Path

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu.utils import check as jcheck
from advanced_hpc_lbm_tpu.utils import io as jio
from advanced_hpc_lbm_tpu.utils import native as jnative
from advanced_hpc_lbm_tpu.utils import timers as jtimers
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import check, io, timers
from advanced_hpc_lbm_tpu_torch.utils import native

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


# ---- the native codec -----------------------------------------------------------

@pytest.fixture
def port_codec():
    if not native.available():
        pytest.skip("cc cannot build native/fastio.c here")
    return native


def port_python_path(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


BLOCK_LINES = 65536  # the codec's block of lines
WRITER_SHAPES = [(1, 1), (3, 5), (64, 64), (128, 256), (300, 257)]


@pytest.fixture(scope="module")
def jax_final_states(tmp_path_factory):
    """The JAX writer's final_state.dat bytes by (shape, quirk), made once."""
    cache = {}

    def get(ny, nx, quirk):
        if (ny, nx, quirk) not in cache:
            f, mask, jp = _state(ny, nx, seed=4)
            path = tmp_path_factory.mktemp("jax") / "final_state.dat"
            saved, jnative.available = jnative.available, lambda: False
            try:
                jio.write_final_state(path, f, mask, jp, emulate_obstacle_column_quirk=quirk)
            finally:
                jnative.available = saved
            cache[ny, nx, quirk] = path.read_bytes()
        return cache[ny, nx, quirk]
    return get


@pytest.mark.parametrize("threads", [1, 2, 7, 10**6])
@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("ny,nx", WRITER_SHAPES)
def test_native_writers_match_jax_bytes(tmp_path, port_codec, jax_final_states, ny, nx,
                                        quirk, threads):
    """At 10**6 threads there are more threads than lines (and blocks)."""
    f, mask, jp = _state(ny, nx, seed=4)
    planes = io.final_state_planes(f, mask, LBMParams.from_jax(jp))
    port_codec.write_final_state(tmp_path / "port.dat", planes, mask, quirk=quirk,
                                 threads=threads)
    assert (tmp_path / "port.dat").read_bytes() == jax_final_states(ny, nx, quirk)
    av = np.random.RandomState(5).rand(23).astype(np.float32) * 1e-2
    port_codec.write_av_vels(tmp_path / "port_av.dat", av)
    jio.write_av_vels(tmp_path / "jax_av.dat", av)
    assert (tmp_path / "port_av.dat").read_bytes() == (tmp_path / "jax_av.dat").read_bytes()


@pytest.mark.parametrize("ny,nx", [(256, 256), (512, 256), (300, 257)],
                         ids=["one-block", "two-blocks", "ragged"])  # of BLOCK_LINES
def test_native_thread_counts_write_the_same_bytes(tmp_path, port_codec, ny, nx):
    f, mask, jp = _state(ny, nx, seed=7)
    planes = io.final_state_planes(f, mask, LBMParams.from_jax(jp))
    digests = set()
    for threads in (1, 2, 3, 8):
        path = tmp_path / f"t{threads}.dat"
        port_codec.write_final_state(path, planes, mask, threads=threads)
        digests.add(hashlib.sha256(path.read_bytes()).hexdigest())
    assert len(digests) == 1
    assert path.read_bytes().count(b"\n") == ny * nx


def test_long_av_vels_spans_blocks(tmp_path, port_codec):
    av = np.random.RandomState(8).rand(BLOCK_LINES + 3).astype(np.float32)
    port_codec.write_av_vels(tmp_path / "port.dat", av)
    jio.write_av_vels(tmp_path / "jax.dat", av)
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()


@pytest.mark.parametrize("threads", [None, 1, 3])
@pytest.mark.parametrize("quirk", [True, False])
def test_io_uses_the_codec_and_both_paths_agree(tmp_path, port_codec, monkeypatch, quirk,
                                                threads):
    f, mask, jp = _state(9, 7, seed=6)
    p = LBMParams.from_jax(jp)
    calls = []
    real = port_codec.write_final_state
    monkeypatch.setattr(port_codec, "write_final_state",
                        lambda *a, **k: calls.append(k["threads"]) or real(*a, **k))
    io.write_final_state(tmp_path / "c.dat", f, mask, p,
                         emulate_obstacle_column_quirk=quirk, threads=threads)
    assert calls == [threads]
    port_python_path(monkeypatch)
    io.write_final_state(tmp_path / "py.dat", f, mask, p,
                         emulate_obstacle_column_quirk=quirk, threads=threads)
    assert calls == [threads]
    assert (tmp_path / "c.dat").read_bytes() == (tmp_path / "py.dat").read_bytes()


def test_native_writer_rejects_bad_arguments(tmp_path, port_codec):
    f, mask, jp = _state(4, 6)
    planes = io.final_state_planes(f, mask, LBMParams.from_jax(jp))
    with pytest.raises(ValueError, match="threads"):
        port_codec.write_final_state(tmp_path / "x.dat", planes, mask, threads=0)
    with pytest.raises(ValueError, match="planes"):
        port_codec.write_final_state(tmp_path / "x.dat", planes, mask.T)
    with pytest.raises(OSError, match="rc=1"):
        port_codec.write_final_state(tmp_path / "absent" / "x.dat", planes, mask)


@pytest.mark.parametrize("call", ["write_final_state", "write_av_vels", "parse_obstacles"])
def test_native_calls_without_a_library_raise(tmp_path, monkeypatch, call):
    monkeypatch.setattr(native, "_library", lambda: None)
    assert not native.available()
    f, mask, jp = _state(4, 6)
    args = {"write_final_state": (tmp_path / "x.dat",
                                  io.final_state_planes(f, mask, LBMParams.from_jax(jp)), mask),
            "write_av_vels": (tmp_path / "x.dat", np.ones(3)),
            "parse_obstacles": (MINI_OBST, 64, 64)}[call]
    with pytest.raises(RuntimeError, match="native codec not built"):
        getattr(native, call)(*args)


@pytest.mark.parametrize("line", [
    "1 1", "1 1 1 1", "a 1 1", "9 1 1", "-1 1 1", "1 9 1", "1 1 2", "1 1-1", "1,1 1",
    "0x1 1 1", "1 1 1 x",
])
def test_native_parse_errors_keep_message_and_line(tmp_path, port_codec, line):
    """The codec's return codes map to the JAX reader's messages, with the
    line's number."""
    path = tmp_path / "bad.dat"
    path.write_text(f"0 0 1\n\n{line}\n4 4 1\n")
    jp = JaxParams(nx=8, ny=8, max_iters=1, reynolds_dim=1,
                   density=0.1, accel=0.005, omega=1.0)
    with pytest.raises(jio.DeckError) as want:
        jio.load_obstacles(path, jp)
    with pytest.raises(ValueError) as got:
        port_codec.parse_obstacles(path, 8, 8)
    assert str(got.value) == str(want.value) and str(got.value).endswith(":3)")
    with pytest.raises(OSError, match="could not open"):
        port_codec.parse_obstacles(tmp_path / "absent.dat", 8, 8)


def test_native_parse_takes_what_the_python_path_takes(tmp_path, port_codec):
    """White space of every kind around and between the fields, signs, a
    last line without a newline and a line longer than any fixed buffer."""
    path = tmp_path / "odd.dat"
    path.write_text("\t1\t2\t1\r\n  +3   4 1   \n\n   \n5 6 1" + " " * 600 + "\n7 0 1")
    jp = JaxParams(nx=8, ny=8, max_iters=1, reynolds_dim=1,
                   density=0.1, accel=0.005, omega=1.0)
    np.testing.assert_array_equal(port_codec.parse_obstacles(path, 8, 8),
                                  jio.load_obstacles(path, jp))


def test_native_obstacles_match_python_path(port_codec, monkeypatch):
    p = io.load_params(MINI_PARAMS)
    fast = io.load_obstacles(MINI_OBST, p)
    port_python_path(monkeypatch)
    np.testing.assert_array_equal(fast, io.load_obstacles(MINI_OBST, p))


def test_native_build_is_keyed_by_source(port_codec):
    """The codec is the port's own source, inside its package, built into a
    library named by that source's hash."""
    package = Path(io.__file__).resolve().parents[1]
    assert native.SRC == package / "csrc" / "fastio.c" and native.SRC.is_file()
    path = port_codec.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    h = hashlib.sha256(" ".join(native.CFLAGS).encode())
    h.update(native.SRC.read_bytes())
    assert path.name == f"libfastio_{h.hexdigest()[:16]}.so"
    assert "-pthread" in native.CFLAGS


def test_port_names_no_codec_of_the_jax_package():
    """No file of the port, and not chip_smoke.py, names, reads or builds
    the JAX package's codec source or library."""
    root = Path(io.__file__).resolve().parents[2]
    files = [p for p in (root / "advanced_hpc_lbm_tpu_torch").rglob("*")
             if p.suffix in (".py", ".c", ".cu", ".cuh")] + [root / "chip_smoke.py"]
    assert len(files) > 20
    for p in files:
        text = p.read_text()
        assert "native/fastio" not in text and "libfastio.so" not in text, p


def test_pyproject_ships_the_codec_source():
    root = Path(io.__file__).resolve().parents[2]
    data = tomllib.loads((root / "pyproject.toml").read_text())
    assert "csrc/*.c" in data["tool"]["setuptools"]["package-data"]["advanced_hpc_lbm_tpu_torch"]


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
